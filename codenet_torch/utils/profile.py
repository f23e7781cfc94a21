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
  (ui.perfetto.dev opens the file). Its window is the steady state: the
  program marks each step (`step()`: a train or val batch, an eval image
  or batch), and the file holds TRACE_STEPS steps after the first
  TRACE_SKIP (set-up, eager warm-ups, a graph's capture); a run of at
  most TRACE_SKIP steps writes all it ran.
- `span(name)`: a host annotation ``codenet.<name>`` in the trace of
  whatever torch profiler is recording (a `trace`, or a caller's own
  `torch.profiler.profile`), on the profiler's clock beside the device's
  events; with no profiler recording, a shared no-op context (no clock
  read, no allocation). No span sits inside a body a CUDA graph
  captures: it would not replay.
"""

from __future__ import annotations

import contextlib
import os
import warnings

import torch

# one [flops] tally per active count_flops
_TALLIES = []
# a `trace`'s window: the first TRACE_SKIP steps are left out, the next
# TRACE_STEPS written
TRACE_SKIP = 5
TRACE_STEPS = 20
# the `trace`s open in this process, innermost last (`step` advances them)
_OPEN = []
_NO_SPAN = contextlib.nullcontext()


def span(name):
    """``with span(name):`` marks the block as ``codenet.<name>`` in the
    trace of a recording torch profiler; otherwise does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("codenet." + name)
    return _NO_SPAN


def step():
    """Marks the start of a step (a batch, an eval image) for the
    program's own open `trace`s; a profiler opened by a caller is not
    advanced."""
    for t in _OPEN:
        t.step()


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

    The file holds steps TRACE_SKIP + 1 to TRACE_SKIP + TRACE_STEPS of
    the block (`step()` starts one; what runs before the first is step
    0), or, where the block ends by step TRACE_SKIP, everything: the
    profiler records from the start, drops that record at step
    TRACE_SKIP + 1, then records the window.

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
        self.closing = False

    @staticmethod
    def schedule(n):
        from torch.profiler import ProfilerAction as A
        if n in (TRACE_SKIP, TRACE_SKIP + TRACE_STEPS):
            return A.RECORD_AND_SAVE
        return A.RECORD if n < TRACE_SKIP + TRACE_STEPS else A.NONE

    def __enter__(self):
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        os.makedirs(self.log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        write = tensorboard_trace_handler(self.log_dir,
                                          worker_name=self.worker)

        def ready(prof):
            # the record of the skipped steps, dropped once the window opens
            if self.closing or prof.step_num != TRACE_SKIP + 1:
                write(prof)
        self.prof = profile(activities=acts, schedule=self.schedule,
                            on_trace_ready=ready)
        self.prof.__enter__()
        _OPEN.append(self)
        return self

    def step(self):
        with warnings.catch_warnings():
            # "the profiler clears events at the end of each cycle": meant
            warnings.simplefilter("ignore")
            self.prof.step()

    def __exit__(self, *exc):
        _OPEN.remove(self)
        if self.cuda:
            torch.cuda.synchronize()
        self.closing = True
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
