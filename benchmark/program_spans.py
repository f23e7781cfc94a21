"""The program's own spans in a traced run: the host annotations
``codenet.<name>`` that `codenet_torch/utils/profile.py::span` leaves in
the profiler's trace, read from a run's record (`record["trace"]`, the
(device, host) events of `harness/probe.py::Window.events`).

A span counts where it starts inside the profiler-step window (the first
``ProfilerStep`` annotation's start to the last one's end); per step is
per ``ProfilerStep`` annotation there: a request of a serving cell, a
batch of a training cell. A program without the span reads None.
"""

from __future__ import annotations

PREFIX = "codenet."


def _window(events):
    """(start_ns, end_ns, steps) of the profiler steps, or None."""
    if not events:
        return None
    steps = [(s, e) for n, s, e in events[1] if n.startswith("ProfilerStep")]
    if not steps:
        return None
    return min(s for s, _ in steps), max(e for _, e in steps), len(steps)


def _spans(events, name, window):
    lo, hi, _ = window
    return [(s, e) for n, s, e in events[1]
            if n == PREFIX + name and lo <= s <= hi]


def count(events, name):
    """The number of `name` spans in the window, or None without a
    window."""
    window = _window(events)
    return None if window is None else len(_spans(events, name, window))


def mean_ms(events, name):
    """The time inside `name` spans in the window over its steps, in ms;
    None without a window or without such a span."""
    window = _window(events)
    if window is None:
        return None
    spans = _spans(events, name, window)
    if not spans:
        return None
    return 1e-6 * sum(e - s for s, e in spans) / window[2]


def share(events, part, parts):
    """`part`'s spans as a share of all of `parts`' spans in the window, in
    %; None where none of them is there."""
    counts = [count(events, p) for p in parts]
    if None in counts or not sum(counts):
        return None
    return 100.0 * counts[parts.index(part)] / sum(counts)
