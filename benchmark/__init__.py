"""The benchmark of codenet_torch on NVIDIA cards: `BENCHMARK.json` at the
root of the repository names its cells; `python3 -m benchmark.run` runs
one (see run.py)."""
