"""The reference's networks, one module per architecture.

A configuration's `arch` names its module as the program's model factory
names its family: the part before the first `_` (`res_18` -> `res`,
`dla_34` -> `dla`; an `arch` without one is its own family), and the
module is the file `benchmark/reference/arch/<family>.py` of the
checkout. So an architecture is added by adding its file; no code lists
them.

Each module gives, for a configuration dict `cfg` (its file's keys):

- `state_shapes(cfg, quant=False)`: {state_dict name: shape} of the
  network as the program names its state, the 4-D tensors in the order
  the seeded draw takes them (`harness/weights.py`);
- `init(cfg, name, shape)`: the seeded init of one tensor: the std of its
  draw for a 4-D weight, else the constant it is filled with (a BN scale
  or shift, a bias, a statistic or a quantizer's range);
- `Net(cfg, quant=None, precision="f32", fault=None)`: the plain network,
  `forward(x, params, buffers, train=False, update=False)` -> {head:
  (N, C, H / down_ratio, W / down_ratio)} of normalised (N, 3, H, W)
  images, its train-mode BN writing `bn_momentum` x the batch's statistics
  into the running ones (`ops.calibrate`); `quant` a W4A8 dict where the
  architecture quantizes (else it refuses one), `precision` "f32" or
  "tf32" (the control), `fault` one of FAULTS or None;
- `FAULTS`: {name: what it breaks}, the faults of the architecture's own
  that the readings plant in the reference's place (`benchmark.readings`);
- `program_args(cfg)`: the program's command-line options that select
  the configuration's variant of the architecture.

A module imports nothing of the program.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def family(arch):
    """The architecture family of an `arch` string (the program's
    factory's split)."""
    return arch.split("_", 1)[0]


def load(arch, root=ROOT):
    """The module of `arch` in the checkout at `root`."""
    name = family(arch)
    path = Path(root) / "benchmark" / "reference" / "arch" / (name + ".py")
    if not path.is_file():
        raise KeyError("no reference architecture {!r}: {} is missing"
                       .format(arch, path))
    spec = importlib.util.spec_from_file_location(
        "benchmark_reference_arch_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
