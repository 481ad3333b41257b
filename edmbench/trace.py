"""The traced run's record: the benchmark's own spans around each phase
step (``torch.profiler.record_function`` and host clocks), and the
profiler's device activity, matched to the span that launched it by the
CUDA correlation id.

``reduce`` turns one profile of the measured window into the numbers the
per-layer readers (``metrics/<name>.py``) and the result's ``breakdown``
take: the device's busy time as the union of its activity intervals, the
device time launched inside each phase's spans (and the part of it in
NCCL's kernels), the device operations that took most time, and the
longest idle gaps labelled by the span the host was in."""

from __future__ import annotations

import bisect
import re

SPAN = "edmbench."  # prefix of the benchmark's span names
WINDOW = SPAN + "window"
TOP = 10


def kernel_name(name: str) -> str:
    """A device operation's name as the breakdown gives it: the function
    name without its template arguments and parameter list."""
    n = name.replace("(anonymous namespace)::", "")
    n = n.split("(")[0].removeprefix("void ").strip()
    if "::" in n:
        n = n.split("<")[0].split("::")[-1]
    return re.sub(r"<.*", "", n) or name[:60]


def _events(prof):
    return prof.profiler.kineto_results.events()


def reduce(prof) -> dict:
    """{"window_ns", "busy_ns", "span_device_ns": {phase: ns},
    "span_nccl_ns": {phase: ns}, "span_count": {phase: n}, "device_ops":
    [[name, s]], "idle_gaps": [[label, s]], "device_events": n}.  Phases
    are the span names after ``SPAN``; ``span_nccl_ns`` holds the device
    time of the operations whose kernel name starts with ``nccl``."""
    from torch.autograd import DeviceType

    spans, window, runtime, device = [], None, {}, []
    for e in _events(prof):
        if e.device_type() == DeviceType.CUDA:
            # a span's own range on the device's timeline (ours, or one that
            # a library annotates, as NCCL's "nccl:all_gather"), not an
            # operation
            if e.name().startswith(SPAN) or e.is_user_annotation():
                continue
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
                           e.linked_correlation_id(), e.name()))
            continue
        name = e.name()
        if name == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith(SPAN):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name[len(SPAN):]))
        elif e.correlation_id():
            runtime[e.correlation_id()] = e.start_ns()
    if window is None:
        raise RuntimeError("the profile holds no window span")
    w0, w1 = window
    spans.sort()
    starts = [s[0] for s in spans]

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            return spans[i][2]
        return "harness"

    span_dev, span_nccl, span_count, by_name, ivals = {}, {}, {}, {}, []
    for _, _, ph in spans:
        span_count[ph] = span_count.get(ph, 0) + 1
    for s, t, cid, lcid, name in device:
        if t < w0 or s > w1:
            continue
        s, t = max(s, w0), min(t, w1)
        ivals.append((s, t))
        k = kernel_name(name)
        by_name[k] = by_name.get(k, 0) + (t - s)
        launch = runtime.get(cid, runtime.get(lcid))
        ph = span_at(launch) if launch is not None else "unmatched"
        span_dev[ph] = span_dev.get(ph, 0) + (t - s)
        if k.startswith("nccl"):
            span_nccl[ph] = span_nccl.get(ph, 0) + (t - s)
    ivals.sort()
    busy, gaps, end = 0, [], w0
    for s, t in ivals:
        if s > end:
            gaps.append((s - end, (s + end) // 2))
        if t > end:
            busy += t - max(s, end)
            end = t
    if w1 > end:
        gaps.append((w1 - end, (w1 + end) // 2))
    gaps.sort(reverse=True)
    return dict(
        window_ns=w1 - w0, busy_ns=busy, span_device_ns=span_dev, span_nccl_ns=span_nccl,
        span_count=span_count,
        device_events=len(ivals),
        device_ops=[[k, v / 1e9] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[span_at(at), g / 1e9] for g, at in gaps[:TOP]],
    )
