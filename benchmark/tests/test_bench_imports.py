"""What the benchmark loads: nothing of JAX or the JAX package anywhere,
and in the reference nothing of the program either. Module names are
compared by their whole top-level name (the part before the first dot),
since the program's name begins with the JAX package's."""

import ast
import subprocess
import sys

from benchmark.harness import cell as C

JAX = ("jax", "jaxlib", "flax", "codenet_tpu", "tools_tpu")
PROGRAM = ("codenet_torch", "tools_torch")


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
    loaded = _loaded_after("import benchmark.reference.train, "
                           "benchmark.reference.serve, benchmark.counts")
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
        if "reference" in path.parts or path.name == "counts.py":
            assert not names & set(PROGRAM), (path, names & set(PROGRAM))


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
