"""Spans and counters at the port's layer boundaries: the driver's
segments, the cell host's step and its parts, the hill round shared by
every host, and each value read back to the host.  Off by default.

Off, ``span`` returns one shared object whose enter and exit do nothing,
``count`` and ``count_device`` return at once and ``read`` only reads: the
port launches nothing and reads nothing more than it does without this
module.

On (``enable()``), a span enters a profiler range
(``torch._C._profiler._RecordFunctionFast``, ``record_function``'s cheap
form), so a running ``torch.profiler`` records it on the clock and
timeline of the device activity and matches the kernels launched inside it
by their CUDA correlation ids; no second clock is stamped on the profile.
The module also keeps in memory, per span name and per parent span name,
the count, the host time and the self time (the span's host time less its
child spans'), from ``time.perf_counter_ns``.  Each Python garbage
collection is a span ``edm.gc``.

    from edm_tpu_torch.utils import trace
    trace.enable()
    trace.reset()             # after warm-up
    ...                       # run steps
    rep = trace.report()      # {"spans": ..., "counters": ...}; one device read
    trace.enable(False)

The spans (fixed names, below):

- ``edm.segment``: a ``driver.pattern_segment`` segment call;
- ``edm.step.<phase>``: a cell-host step (``hill``, ``plain``,
  ``rebuild``, ``hill_rebuild``, ``dynamic``), with children
  ``edm.baoab`` (the thermostat's draws, the pre-force stages, the
  velocity finish), ``edm.force`` (``.table``, ``.k1``, ``.tail``),
  ``edm.collect`` (``.pass1``, ``.pass2``), ``edm.round``, ``edm.refit``
  and ``edm.rebuild`` (``.plan``, then ``.rebin`` or ``.full``);
- ``edm.round``: ``bias.add_hills_round`` on every host, with children
  ``edm.round.drain``, ``.heights``, ``.limiter`` and ``.deposit``;
- ``edm.read.<site>``: a value read back to the host (``READ_SITES``).

The counters: on the host ``reads.<site>``, ``rounds`` (hill rounds
called), ``limiter.passes`` (the capping loop's passes), ``rebuild.rebin``
and ``rebuild.full``; on the device, summed over the window without a
host read, ``hills.called`` (candidates that passed acceptance in a round
that was not skipped), ``hills.deposited`` (hills the limiter deposited,
whole or in part), ``hills.deferred`` (hills with a remainder pushed to
the overflow buffer), ``hills.dropped`` (deferred hills past the buffer's
end), ``hills.drained`` (buffer slots a drain processed) and
``rounds.skipped`` (rounds whose new hills were skipped because the buffer
was not drained, edm_bias.cpp:436-439); and, from the row pass's pieces
form (``ops/cellforce.py``, K1, K6 and K7 past k = 64), ``k1.unculled`` (the
r^2 tests a sweep over every occupied candidate would run: rows x
candidates), ``k1.tested`` (the tests its cull left) and ``k1.in_reach``
(the unordered pairs within reach it found): the cull's share is
1 - tested / unculled."""

from __future__ import annotations

import gc
import time

import torch

SEGMENT = "edm.segment"
STEP = {p: "edm.step." + p for p in ("hill", "plain", "rebuild", "hill_rebuild", "dynamic")}
BAOAB = "edm.baoab"
FORCE = "edm.force"
FORCE_TABLE = "edm.force.table"
FORCE_K1 = "edm.force.k1"
FORCE_TAIL = "edm.force.tail"
COLLECT = "edm.collect"
COLLECT_PASS1 = "edm.collect.pass1"
COLLECT_PASS2 = "edm.collect.pass2"
ROUND = "edm.round"
ROUND_DRAIN = "edm.round.drain"
ROUND_HEIGHTS = "edm.round.heights"
ROUND_LIMITER = "edm.round.limiter"
ROUND_DEPOSIT = "edm.round.deposit"
REFIT = "edm.refit"
REBUILD = "edm.rebuild"
REBUILD_PLAN = "edm.rebuild.plan"
REBUILD_REBIN = "edm.rebuild.rebin"
REBUILD_FULL = "edm.rebuild.full"
GC = "edm.gc"
READ_SITES = ("step_phase", "rebin_feasible", "tail_ovf", "limiter", "pass_gate",
              "mcgdp_strips")
_READ_SPAN = {s: "edm.read." + s for s in READ_SITES}
_READ_COUNT = {s: "reads." + s for s in READ_SITES}


def step_span(do_hills, do_energy, do_rebuild) -> str:
    """The ``edm.step.<phase>`` span name of a step's static flags."""
    if None in (do_hills, do_energy, do_rebuild):
        return STEP["dynamic"]
    return STEP[{(True, False): "hill", (False, False): "plain", (False, True): "rebuild",
                 (True, True): "hill_rebuild"}[(bool(do_hills), bool(do_rebuild))]]


class _Null:
    """The span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Tracer:
    """The process's spans and counters."""

    def __init__(self):
        self.on = False
        self.range = None  # the profiler range's type, found at enable()
        self.stack = []  # open spans, innermost last
        self.spans = {}  # (name, parent name or "") -> [count, host_ns, self_ns]
        self.counters = {}
        self.device = {}  # name -> 0-d int64 accumulator on the device
        self.gc_open = []


_T = _Tracer()


class _Span:
    __slots__ = ("name", "rf", "t0", "child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _T.range(self.name)
        self.rf.__enter__()
        self.child = 0
        _T.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        st = _T.stack
        if st and st[-1] is self:
            st.pop()
        elif self in st:  # closed out of order: tracing toggled inside a span
            st.remove(self)
        parent = st[-1] if st else None
        if parent is not None:
            parent.child += dt
        key = (self.name, parent.name if parent is not None else "")
        s = _T.spans.get(key)
        if s is None:
            s = _T.spans[key] = [0, 0, 0]
        s[0] += 1
        s[1] += dt
        s[2] += dt - self.child
        self.rf.__exit__(*exc)
        return False


def _gc_hook(phase, info):
    if phase == "start":
        sp = _Span(GC)
        sp.__enter__()
        _T.gc_open.append(sp)
    elif _T.gc_open:
        _T.gc_open.pop().__exit__(None, None, None)


def enable(on: bool = True) -> None:
    """Turn tracing on or off (it starts off)."""
    on = bool(on)
    if on and not _T.on:
        _T.range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or (
            torch.profiler.record_function)
        gc.callbacks.append(_gc_hook)
    elif not on and _T.on:
        gc.callbacks.remove(_gc_hook)
        while _T.gc_open:
            _T.gc_open.pop().__exit__(None, None, None)
    _T.on = on


def enabled() -> bool:
    return _T.on


def span(name: str):
    """A context manager: the span ``name`` when on, else the shared no-op."""
    return _Span(name) if _T.on else _NULL


def read(owner, site: str, t: torch.Tensor):
    """``t`` on the host (``t.tolist()``: a bool, an int or a list), one
    host read.  Adds one to ``owner.host_syncs`` (unless ``owner`` is None:
    a caller that returns its count of reads); when on, reads inside the
    span ``edm.read.<site>`` and adds one to the counter ``reads.<site>``."""
    if owner is not None:
        owner.host_syncs += 1
    if not _T.on:
        return t.tolist()
    key = _READ_COUNT[site]
    _T.counters[key] = _T.counters.get(key, 0) + 1
    with _Span(_READ_SPAN[site]):
        return t.tolist()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` (when on)."""
    if _T.on:
        _T.counters[name] = _T.counters.get(name, 0) + n


def count_device(name: str, t: torch.Tensor) -> None:
    """Add ``t`` (a 0-d tensor, else the sum of its elements) into the
    device counter ``name``, on ``t``'s device and without a host read
    (when on)."""
    if not _T.on:
        return
    acc = _T.device.get(name)
    if acc is None:
        acc = _T.device[name] = torch.zeros((), dtype=torch.int64, device=t.device)
    acc.add_(t if t.dim() == 0 else t.sum())


def report() -> dict:
    """{"spans": {name: {parent name or "": {"count", "host_ns", "self_ns"}}},
    "counters": {name: n}}, the host and the device counters together (one
    device read for the device counters)."""
    spans = {}
    for (name, parent), (n, host, own) in _T.spans.items():
        spans.setdefault(name, {})[parent] = dict(count=n, host_ns=host, self_ns=own)
    counters = dict(_T.counters)
    if _T.device:
        names = list(_T.device)
        vals = torch.stack([_T.device[k] for k in names]).tolist()
        counters.update(zip(names, vals))
    return dict(spans=spans, counters=counters)


def reset() -> None:
    """Clear the spans and the counters."""
    _T.spans.clear()
    _T.counters.clear()
    _T.device.clear()
