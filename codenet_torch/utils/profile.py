"""Model cost accounting and profiler traces (the JAX package's
utils/profile.py, the reference's thop.profile at model construction,
shufflenetv2_dcn.py:368-371).

- `count_params(model)`: the parameters, as the JAX package counts its
  'params' collection (running statistics and quantizer ranges are
  buffers here, batch_stats / quant_stats there: neither counts).
- `count_flops(fn, *args)`: the FLOPs of running fn(*args), through
  `torch.utils.flop_counter.FlopCounterMode` (matmuls and convs, forward
  and backward; no elementwise op). The deform ops count by their own
  formula (`counted_op`): the CUDA kernels launch through ctypes, where
  the mode sees nothing, and their plain versions' gathers are no
  matmuls, so an op counts the same on the CPU and on a card. The JAX
  package counts with XLA's cost analysis, which counts only the taps of
  a padded conv that fall inside the image and one FLOP per elementwise
  op: the two agree on unpadded convs and matmuls only.
- `profile_model(model, input_shape)`: prints ``MACs: ... Parameters:
  ...`` (MACs = FLOPs / 2), as the JAX package does.
- `trace(log_dir)`: a `torch.profiler.profile` over a block (``--trace``
  in `cli.main` and `cli.test`), written as ``<worker>.<ns>.pt.trace.json``
  into log_dir for TensorBoard's profiler plugin or Perfetto
  (ui.perfetto.dev opens the file). The profiler holds every event in
  host memory until the block ends: trace short runs.
"""

from __future__ import annotations

import contextlib
import os

import torch

# one [flops] tally per active count_flops
_TALLIES = []


def count_params(model):
    """Total parameter count of an nn.Module."""
    return int(sum(p.numel() for p in model.parameters()))


@contextlib.contextmanager
def counted_op(flops):
    """Inside `count_flops`: the enclosed op adds `flops`, and the aten
    calls it makes count nothing (the flop counter's dispatch mode is off
    within). Outside `count_flops`: nothing."""
    if not _TALLIES:
        yield
        return
    _TALLIES[-1][0] += int(flops)
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        yield


def count_flops(fn, *args):
    """FLOPs of fn(*args) (an int): FlopCounterMode's count plus the
    deform ops' registered formulas."""
    from torch.utils.flop_counter import FlopCounterMode
    tally = [0]
    _TALLIES.append(tally)
    try:
        with FlopCounterMode(display=False) as mode:
            fn(*args)
    finally:
        _TALLIES.pop()
    return int(mode.get_total_flops()) + tally[0]


def profile_model(model, input_shape=(1, 512, 512, 3), device=None):
    """Print and return (MACs, parameters) of `model`'s eval forward on a
    zero NHWC batch of `input_shape` (on the model's device by
    default)."""
    if device is None:
        device = next(model.parameters()).device
    x = torch.zeros(input_shape, dtype=torch.float32, device=device)
    n_params = count_params(model)
    with torch.no_grad():
        flops = count_flops(model, x)
    macs = flops / 2
    print("MACs:", macs, "Parameters:", n_params)
    return macs, n_params


class trace:
    """Profile what runs inside (``with trace(dir, device):``): CPU
    activity, and CUDA activity when `device` is a card (default: a card
    if one is visible). On exit the trace file is written into `log_dir`,
    named after `worker` (``rank<r>`` under data parallelism; by default
    torch's host_pid).

    Unlike the JAX package's trace, which turns a failure into a no-op,
    a profiler that cannot start raises, and so does a trace of a card
    that holds no CUDA event (no CUPTI): a missing trace is an error, not
    a quieter run."""

    def __init__(self, log_dir, device=None, worker=None):
        self.log_dir = log_dir
        self.cuda = torch.device(device).type == "cuda" \
            if device is not None else torch.cuda.is_available()
        self.worker = worker
        self.prof = None

    def __enter__(self):
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        os.makedirs(self.log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts,
                            on_trace_ready=tensorboard_trace_handler(
                                self.log_dir, worker_name=self.worker))
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if self.cuda and exc[0] is None and not any(
                e.device_type == torch.autograd.DeviceType.CUDA
                for e in self.prof.events()):
            raise RuntimeError(
                "the profiler recorded no CUDA activity (is CUPTI "
                "available?); {} holds a trace of the host only"
                .format(self.log_dir))
        return False


def maybe_trace(opt, device, rank=None):
    """``--trace``: a `trace` into <debug_dir>/trace; else a no-op
    context."""
    if not getattr(opt, "trace", False):
        return contextlib.nullcontext()
    return trace(os.path.join(opt.debug_dir, "trace"), device,
                 None if rank is None else "rank{}".format(rank))
