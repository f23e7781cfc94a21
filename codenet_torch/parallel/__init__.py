"""Data parallelism across cards and processes (the JAX package's
parallel/; reference lib/models/data_parallel.py)."""

from .mesh import (  # noqa: F401
    DataParallel, all_max, backend_for, join_from_env, launch,
    launched_by_torchrun, leave, world_for_batch)
from .multihost import process_batch_slice  # noqa: F401
