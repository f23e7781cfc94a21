"""What the benchmark records of a run: host-clock spans of its own around
its calls into the program, and, in a traced run, a scheduled
`torch.profiler` window whose device events the per-layer metrics read.

Spans are kept in memory as (name, seconds) and read after the window.
In a traced run each span is also a profiler annotation ("bench.<name>"),
so an idle gap of the device can be named by the span that was open on
the host.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

# the profiler's schedule in steps (train steps or serving requests): its
# window opens after WAIT + WARMUP steps of the measured window
WAIT, WARMUP = 4, 2


class Spans:
    def __init__(self, traced=False):
        self.traced = traced
        self.durations = collections.defaultdict(list)
        self.on = False

    @contextlib.contextmanager
    def span(self, name):
        ctx = torch.profiler.record_function("bench." + name) \
            if self.traced else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        if self.on:
            self.durations[name].append(time.perf_counter() - t0)

    def mean_ms(self, name):
        d = self.durations.get(name)
        return 1e3 * sum(d) / len(d) if d else None


class Window:
    """The profiler over `active` steps of a traced run; `step()` is called
    once a step. Untraced, nothing."""

    def __init__(self, traced, active):
        self.traced = traced
        self.prof = None
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(
                activities=acts,
                schedule=torch.profiler.schedule(wait=WAIT, warmup=WARMUP,
                                                 active=active, repeat=1))

    def prepare(self, device):
        """Initialise the profiler's device tracing once, in set-up: its
        first start costs seconds, which must not fall into the window."""
        if self.prof is None:
            return
        acts = self.prof.activities
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device=device).add_(1)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def __enter__(self):
        if self.prof is not None:
            self.prof.__enter__()
        return self

    def step(self):
        if self.prof is not None:
            self.prof.step()

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def events(self):
        """(device intervals [(name, start_ns, end_ns)], host annotations
        [(name, start_ns, end_ns)]) of the traced window, or None."""
        if self.prof is None:
            return None
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            on_device = e.device_type() == torch.autograd.DeviceType.CUDA
            if e.is_user_annotation():
                if not on_device:  # a span's copy on the device's timeline
                    host.append((e.name(), start, start + dur))
            elif on_device:
                dev.append((e.name(), start, start + dur))
        return dev, host


def summarise(events, top=10):
    """The traced window's device reading: window_s (the profiler steps'
    span, or the device events' if longer), busy_s (the union of device
    intervals in it), per-name device seconds and calls, and the longest idle gaps
    named by the bench span open at their middle."""
    dev, host = events
    steps = [(s, e) for n, s, e in host if n.startswith("ProfilerStep")]
    spans = [(n[len("bench."):], s, e) for n, s, e in host
             if n.startswith("bench.")]
    if not steps:
        return None
    lo = min(s for s, _ in steps)
    hi = max(e for _, e in steps)
    kern = sorted((max(s, lo), e, n) for n, s, e in dev if e > lo)
    if kern:
        hi = max(hi, max(e for _, e, _ in kern))
    busy, gaps, cur_s, cur_e = 0, [], None, lo
    for s, e, _ in kern:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    by_name, calls = collections.Counter(), collections.Counter()
    for s, e, n in kern:
        by_name[n] += (e - s) * 1e-9
        calls[n] += 1
    named = collections.Counter()
    for s, e in gaps:
        mid = (s + e) / 2
        open_ = [n for n, a, b in spans if a <= mid <= b]
        named[open_[-1] if open_ else "no bench span"] += (e - s) * 1e-9
    return {"window_s": (hi - lo) * 1e-9, "busy_s": busy * 1e-9,
            "device_s": dict(by_name), "device_calls": dict(calls),
            "device_ops": [[n, v] for n, v in by_name.most_common(top)],
            "idle_gaps": [[n, v] for n, v in named.most_common(top)]}
