"""The PyTorch package (and its smoke test and tools) stands alone: it
imports nothing of JAX or of the JAX package, does not import cv2 at
module scope, and no switch can route a CUDA tensor away from the deform
kernel."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "codenet_torch")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for top in (PKG, os.path.join(REPO, "tools_torch")):
        for root, _, files in os.walk(top):
            out += [os.path.join(root, f) for f in files
                    if f.endswith((".py", ".cu", ".cuh"))]
    return out


def test_importing_every_module_loads_no_jax_and_no_cv2():
    script = (
        "import pkgutil, sys, importlib, codenet_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "codenet_torch.__path__, 'codenet_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "own = {'codenet_torch.ops.nms', 'codenet_torch.data.image_aug',\n"
        "       'codenet_torch.data.device_cache',\n"
        "       'codenet_torch.utils.debugger', 'codenet_torch.utils.oracle',\n"
        "       'codenet_torch.engine.train_hooks', 'codenet_torch.cli.demo',\n"
        "       'codenet_torch.parallel.mesh',\n"
        "       'codenet_torch.parallel.multihost',\n"
        "       'codenet_torch.parallel.dryrun'}\n"
        "assert own <= set(names), own - set(names)\n"
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


def test_importing_every_tool_loads_no_jax():
    """Every script of tools_torch/ (the A-E driver, its summary, the int8
    audit, vis_pred and the re-scoring CLIs among them) imports, and
    loads nothing of JAX or of the JAX package."""
    script = (
        "import importlib.util, os, sys\n"
        "tools = sorted(f for f in os.listdir('tools_torch')\n"
        "               if f.endswith('.py'))\n"
        "for f in tools:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        f[:-3], os.path.join('tools_torch', f))\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'codenet_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(tools))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    tools = proc.stdout.split()
    for name in ("run_configs_ae.py", "summarize_results.py",
                 "int8_audit.py", "vis_pred.py", "reval.py", "eval_coco.py",
                 "eval_coco_hp.py"):
        assert name in tools, name
