from .factory import create_model  # noqa: F401
