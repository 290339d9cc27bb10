"""Reading a ``torch.profiler`` trace of the measured window: device time by
kernel, the device's busy and idle time, and what the host was doing
while the device idled.

Device activities (kernels, copies, fills) are the trace's CUDA events
other than the GPU side of ``record_function`` ranges; the window is the
host span named :data:`WINDOW`.  Busy time is the union of the device
activities inside the window, so work that overlaps is counted once.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

PREFIX = "portbench."
WINDOW = PREFIX + "window"
TOP = 10


def _ns(ev, what: str) -> int:
    """An event's start or duration in ns, across profiler versions."""
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def function_name(name: str) -> str:
    """A demangled kernel name's function: ``void (anonymous
    namespace)::sort_rows_smem_kernel<32, 12, true, false>(float const*,
    ...)`` -> ``sort_rows_smem_kernel``; a name that is no function (a copy)
    is kept whole."""
    s = name.replace("(anonymous namespace)::", "")
    m = re.match(r"^(?:void\s+)?([\w:~]+)\s*[<(]", s)
    return m.group(1).rsplit("::", 1)[-1] if m else name


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def _is_device(ev) -> bool:
    dt = str(ev.device_type())
    if "CUDA" not in dt:
        return False
    annotation = getattr(ev, "is_user_annotation", None)
    if annotation is not None and annotation():
        return False
    return not ev.name().startswith(PREFIX)


def read(prof) -> dict | None:
    """``{"kernel_s": {function: s}, "busy_s", "window_s", "device_ops":
    [[name, s]], "idle_gaps": [[host activity, s]]}`` for the window, or
    None where the trace holds no window or no device activity."""
    events = list(prof.profiler.kineto_results.events())
    windows = [e for e in events if e.name() == WINDOW and not _is_device(e)]
    if not windows:
        return None
    w0 = _ns(windows[0], "start")
    w1 = w0 + _ns(windows[0], "duration")
    dev, host = [], []
    for e in events:
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if _is_device(e):
            if start < w1 and start + dur > w0:
                dev.append((max(start, w0), min(start + dur, w1), e.name()))
        elif "CPU" in str(e.device_type()) and e is not windows[0] and dur > 0:
            host.append((start, start + dur, e.name()))
    if not dev:
        return None
    by_kernel, by_name = defaultdict(float), defaultdict(float)
    for s, t, name in dev:
        by_kernel[function_name(name)] += (t - s) / 1e9
        by_name[_short(name)] += (t - s) / 1e9
    dev.sort()
    busy, gaps, cur_s, cur_t = 0, [], dev[0][0], dev[0][1]
    if cur_s > w0:
        gaps.append((w0, cur_s))
    for s, t, _ in dev[1:]:
        if s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    if cur_t < w1:
        gaps.append((cur_t, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]
    idle = [[_host_at(host, starts, g0), (g1 - g0) / 1e9] for g0, g1 in gaps[:TOP]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"kernel_s": dict(by_kernel), "busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}


def _host_at(host, starts, t) -> str:
    """What the host was doing at ``t``: the innermost benchmark span, and
    the two innermost other host events that cover it (an operator and
    the runtime call inside it, outer first)."""
    span, span_len, ops = "", None, []
    for s, e, name in host[: bisect.bisect_right(starts, t)]:
        if e < t:
            continue
        if name.startswith(PREFIX):
            if span_len is None or e - s < span_len:
                span, span_len = name[len(PREFIX):], e - s
        else:
            ops.append((e - s, name))
    inner = [name for _, name in sorted(ops, key=lambda o: -o[0])[-2:]]
    return " / ".join([span or "outside a job", *inner])
