"""What a ``torch.profiler`` trace of the measured window says: device time
by kernel name, busy time with overlapping kernels merged, and the idle
gaps with what the host was doing in each.

The window is the profiler's ``record_function(WINDOW)`` range, so every
time below is on the profiler's own clock. The trace is read from the
profiler's raw event list, which costs a fraction of building its
``events()`` tree.
"""

from __future__ import annotations

import collections

from . import yardstick

WINDOW = "bm.window"
TOP = 10
NAME_CHARS = 120


def read(prof) -> dict:
    """:func:`reduce` over a finished profiler's events."""
    from torch.autograd import DeviceType

    events = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-3
        events.append((e.name(), e.device_type() == DeviceType.CUDA,
                       e.is_user_annotation(), start,
                       start + e.duration_ns() * 1e-3))
    return reduce(events)


def reduce(events) -> dict:
    """{"window_s", "busy_s", "kernel_s": {name: seconds}, "device_ops",
    "idle_gaps"} of the traced window, from events given as (name, on the
    device, a user annotation, start µs, end µs). Raises unless the host
    holds one WINDOW range and the device ran something in it."""
    window = [e for e in events if e[0] == WINDOW and not e[1]]
    if len(window) != 1:
        raise RuntimeError(f"{len(window)} '{WINDOW}' ranges in the trace")
    w0, w1 = window[0][3], window[0][4]
    device, host = [], []
    for name, on_device, note, a, b in events:
        if b <= w0 or a >= w1 or note or name == WINDOW:
            continue
        if on_device:
            device.append((max(a, w0), min(b, w1), name))
        else:
            host.append((a, b, name))
    if not device:
        raise RuntimeError("no device operation in the traced window")
    spans = [(a, b) for a, b, _ in device]
    kernel_s = collections.Counter()
    for a, b, name in device:
        kernel_s[name] += (b - a) * 1e-6
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(yardstick.idle_gaps(spans, w0, w1),
                  key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": yardstick.merged_busy(spans) * 1e-6,
        "kernel_s": dict(kernel_s),
        "device_ops": [[n[:NAME_CHARS], s] for n, s in top],
        "idle_gaps": [[_host_at(host, (a + b) / 2), (b - a) * 1e-6]
                      for a, b in gaps],
    }


def _host_at(host, t: float) -> str:
    """The innermost host operation running at ``t`` (the one that
    started last), or "host: between operations"."""
    best = None
    for a, b, name in host:
        if a <= t <= b and (best is None or a > best[0]):
            best = (a, name)
    return best[1][:NAME_CHARS] if best else "host: between operations"
