"""The PyTorch package stands alone: it imports nothing of JAX or of the
JAX package, does not import cv2 at module scope, and no switch can route
a CUDA tensor away from the deform kernel."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "codenet_torch")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files
                if f.endswith((".py", ".cu", ".cuh"))]
    return out


def test_importing_every_module_loads_no_jax_and_no_cv2():
    script = (
        "import pkgutil, sys, importlib, codenet_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "codenet_torch.__path__, 'codenet_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'codenet_tpu', 'cv2'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_sources_name_no_jax_package_and_import_no_jax():
    imports_jax = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", re.M)
    sources = _sources()
    assert len(sources) >= 20
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert "codenet_tpu" not in text, path
        assert not imports_jax.search(text), path


def test_deform_route_reads_no_environment():
    """No environment variable (and so no switch) decides the route."""
    with open(os.path.join(PKG, "ops", "deform_cuda.py")) as f:
        text = f.read()
    for word in ("environ", "getenv", "putenv"):
        assert word not in text, word
