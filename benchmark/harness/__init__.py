"""The harness: cells found by name (cell.py), the traffic generator
(traffic.py), the seeded state (weights.py), the training and serving
runners (train.py, serve.py), spans and the profiler window (probe.py),
and the comparison that decides `correct` (compare.py)."""
