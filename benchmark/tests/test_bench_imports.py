"""What the benchmark loads: nothing of JAX or the JAX package anywhere,
and in the reference nothing of the program either. Module names are
compared by their whole top-level name (the part before the first dot),
since the program's name begins with the JAX package's. And what its
sources name: ShuffleNetV2's layers and settings only in its own
architecture module."""

import ast
import re
import subprocess
import sys

from benchmark.harness import cell as C

JAX = ("jax", "jaxlib", "flax", "codenet_tpu", "tools_tpu")
PROGRAM = ("codenet_torch", "tools_torch")
ARCH = C.BENCH / "reference" / "arch"
# the architecture modules, the benchmark's and the fixture's
ARCH_MODULES = sorted(p for d in (ARCH, C.BENCH / "tests" / "arch")
                      for p in d.glob("*.py") if p.name != "__init__.py")
# ShuffleNetV2's setting, layers, stages and op, by their names
SHUFFLENET = re.compile(r"\bw2\b|conv_scale|deconv_layers|\blayer[0-4]\b|"
                        r"STAGE_REPEATS|share_act|channel_shuffle|shufflenet",
                        re.IGNORECASE)


def _loaded_after(code):
    script = code + (
        "\nimport sys\nprint(' '.join(sorted({k.split('.')[0] "
        "for k in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=C.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_and_every_reader_load_no_jax():
    code = ("import benchmark.run, benchmark.readings\n"
            "from benchmark.harness import cell, serve, train\n"
            "import json\n"
            "spec = json.load(open('BENCHMARK.json'))\n"
            "for w in spec['workloads']:\n"
            "    c = cell.Cell(w['name'])\n"
            "    [c.reader(m['name']) for m in c.per_layer]\n"
            "from codenet_torch.engine import trainer, detector\n"
            "from codenet_torch.data import loader, datasets\n")
    loaded = _loaded_after(code)
    assert not loaded & set(JAX), loaded & set(JAX)
    assert "codenet_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import benchmark.reference.train, benchmark.reference.serve, "
        "benchmark.counts\nimport importlib.util\n"
        "for i, p in enumerate({!r}):\n"
        "    spec = importlib.util.spec_from_file_location('m%d' % i, p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        .format([str(p) for p in ARCH_MODULES]))
    assert not loaded & set(JAX + PROGRAM), loaded & set(JAX + PROGRAM)


def test_no_source_of_the_benchmark_names_jax_and_the_reference_no_program():
    for path in C.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".")[0])
        assert not names & set(JAX), (path, names & set(JAX))
        if "reference" in path.parts or path in ARCH_MODULES \
                or path.name == "counts.py":
            assert not names & set(PROGRAM), (path, names & set(PROGRAM))


def test_only_shufflenets_module_names_its_layers():
    """The harness, the shared reference and the runners name no layer or
    setting of ShuffleNetV2: a configuration of another architecture runs
    through them by its own module. Each architecture module names its
    own; counts.py and metrics/ hold config d's deform counts."""
    paths = [p for d in ("harness", "reference") for p in
             (C.BENCH / d).rglob("*.py") if p not in ARCH_MODULES]
    paths += [C.BENCH / n for n in ("__init__.py", "run.py", "readings.py",
                                    "program_spans.py")]
    assert len(paths) >= 12
    for path in paths:
        hits = SHUFFLENET.findall(path.read_text())
        assert not hits, (path, hits)
    assert SHUFFLENET.search((ARCH / "shufflenetv2.py").read_text())


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    import shutil
    shutil.copytree(C.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(C.ROOT / "BENCHMARK.json", tmp_path)
    code = ("from benchmark.harness import cell as C, probe\n"
            "C.run(C.Cell('d_serve_flip_b32'), 1, 1.0, False, 'cpu', "
            "probe.Spans())\nprint('{}')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{}" not in out.stdout
    assert "codenet_torch" in out.stderr
