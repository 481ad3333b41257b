"""The traced run's record: the benchmark's own spans around each phase
step (``torch.profiler.record_function`` and host clocks), and the
profiler's device activity, matched to the span that launched it by the
CUDA correlation id.

``reduce`` turns one profile of the measured window into the numbers the
per-layer readers (``metrics/<name>.py``) and the result's ``breakdown``
take: the device's busy time as the union of its activity intervals, the
device time launched inside each phase's spans (and the part of it in
NCCL's kernels), every device operation's time, the ten that took most,
the longest idle gaps labelled by the span the host was in, and, where
the port's own spans are on (``edm_tpu_torch.utils.trace``), the device
time launched inside each innermost one."""

from __future__ import annotations

import bisect
import re

SPAN = "edmbench."  # prefix of the benchmark's span names
WINDOW = SPAN + "window"
PORT = "edm."  # prefix of the port's span names
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


def innermost(spans, times) -> list:
    """For each of ``times``, the index in ``spans`` ((start, end, name),
    nested on one thread) of the innermost span open at it, or -1: one
    sweep over the spans' ends and the times in order."""
    marks = [(s, 0, -t, i) for i, (s, t, _) in enumerate(spans)]  # the outer first
    marks += [(t, 2, -s, i) for i, (s, t, _) in enumerate(spans)]  # the inner first
    marks += [(at, 1, 0, j) for j, at in enumerate(times)]
    marks.sort()
    out, open_ = [-1] * len(times), []
    for _, what, _, i in marks:
        if what == 0:
            open_.append(i)
        elif what == 1:
            out[i] = open_[-1] if open_ else -1
        elif open_ and open_[-1] == i:
            open_.pop()
        else:  # closed out of order
            open_.remove(i)
    return out


def reduce(prof) -> dict:
    """{"window_ns", "busy_ns", "span_device_ns": {phase: ns},
    "span_nccl_ns": {phase: ns}, "span_count": {phase: n}, "device_ops":
    [[name, s]], "device_ns_by_op": {name: ns}, "idle_gaps": [[label, s]],
    "device_events": n, "span_port_ns": {port span: ns}, "span_port_count":
    {port span: n}}.  Phases are the span names after ``SPAN``;
    ``span_nccl_ns`` holds the device time of the operations whose kernel
    name starts with ``nccl``; ``device_ns_by_op`` every operation's time
    in the window, of which ``device_ops`` gives the ten largest.
    ``span_port_ns`` holds the device time launched inside each innermost
    port span (the names start with ``PORT``) and ``span_port_count`` the
    spans of each name that open inside the window: both empty where the
    port's tracing is off.  No span's own range counts as an operation.

    An operation is launched where its CUDA runtime or driver call (a
    host event named ``cu...``, as ``cudaLaunchKernel``) with its
    correlation id began, else where the host op it links to began.  A
    host op (``aten::add``, a span) has a correlation id of another count,
    which may equal a CUDA call's, so the two are kept apart."""
    from torch.autograd import DeviceType

    spans, port, window, api, ops, device = [], [], None, {}, {}, []
    for e in _events(prof):
        if e.device_type() == DeviceType.CUDA:
            # a span's own range on the device's timeline (ours, the port's,
            # or one that a library annotates, as NCCL's "nccl:all_gather"),
            # not an operation
            if e.name().startswith((SPAN, PORT)) or e.is_user_annotation():
                continue
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
                           e.linked_correlation_id(), e.name()))
            continue
        name = e.name()
        if e.correlation_id():
            (api if name.startswith("cu") else ops)[e.correlation_id()] = e.start_ns()
        if name == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith(SPAN):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name[len(SPAN):]))
        elif name.startswith(PORT):
            port.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
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
    launched = []  # (launch time, device ns) of the window's matched operations
    for s, t, cid, lcid, name in device:
        if t < w0 or s > w1:
            continue
        s, t = max(s, w0), min(t, w1)
        ivals.append((s, t))
        k = kernel_name(name)
        by_name[k] = by_name.get(k, 0) + (t - s)
        launch = api.get(cid, ops.get(lcid))
        ph = span_at(launch) if launch is not None else "unmatched"
        span_dev[ph] = span_dev.get(ph, 0) + (t - s)
        if k.startswith("nccl"):
            span_nccl[ph] = span_nccl.get(ph, 0) + (t - s)
        if launch is not None:
            launched.append((launch, t - s))
    port_ns, port_count = {}, {}
    if port:
        for s, _, name in port:
            if w0 <= s <= w1:
                port_count[name] = port_count.get(name, 0) + 1
        for (_, ns), i in zip(launched, innermost(port, [at for at, _ in launched])):
            if i >= 0:
                name = port[i][2]
                port_ns[name] = port_ns.get(name, 0) + ns
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
        device_ns_by_op=by_name,
        idle_gaps=[[span_at(at), g / 1e9] for g, at in gaps[:TOP]],
        span_port_ns=port_ns, span_port_count=port_count,
    )
