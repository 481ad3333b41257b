"""Each per-layer reader, and the trace reduction, on synthetic records."""

import importlib
import json
import os

import pytest
from torch.autograd import DeviceType

from edmbench import trace as T
from edmbench.kinds.pair_cells import work_count as work
from edmbench.tests.conftest import ROOT

RECORD = dict(
    cycles=100, steps=1000, window_s=10.0, host_syncs=300, tail_fallbacks=2,
    spans={"hill": [0.005] * 100, "plain": [0.002] * 800, "rebuild": [0.004] * 100},
    trace=dict(window_ns=10_000_000_000, busy_ns=2_500_000_000,
               span_device_ns={"hill": 400_000_000, "plain": 1_600_000_000},
               span_nccl_ns={"plain": 800_000_000},
               span_count={"hill": 100, "plain": 800, "rebuild": 100}),
    work=dict(least_s=1e-4),
)
WANT = {"plain_step_host_ms": 2.0, "host_syncs_per_cycle": 3.0, "fallback_period_share": 2.0,
        "hill_step_device_ms": 4.0, "plain_step_roofline": 5.0, "device_idle_pct": 75.0,
        "psum_device_ms": 1.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    mod = importlib.import_module(f"edmbench.metrics.{name}")
    assert mod.read(RECORD) == pytest.approx(WANT[name])


def test_every_metric_has_a_reader():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        assert callable(importlib.import_module(f"edmbench.metrics.{m['name']}").read)


def test_readers_return_none_without_data():
    empty = dict(cycles=10, steps=100, window_s=1.0, host_syncs=30, tail_fallbacks=None,
                 spans={"hill": [], "plain": [], "rebuild": []}, trace=None, work=None)
    for name in ("fallback_period_share", "hill_step_device_ms", "plain_step_roofline",
                 "device_idle_pct", "plain_step_host_ms", "psum_device_ms"):
        assert importlib.import_module(f"edmbench.metrics.{name}").read(empty) is None
    one_card = dict(RECORD, trace=dict(RECORD["trace"], span_nccl_ns={}))
    assert importlib.import_module("edmbench.metrics.psum_device_ms").read(one_card) is None


def test_roofline_over_ranks():
    """On four ranks a plain step's least time is the whole system's over
    four, against rank 0's device time."""
    from edmbench.metrics import plain_step_roofline
    assert plain_step_roofline.read(dict(RECORD, ranks=1)) == pytest.approx(5.0)
    assert plain_step_roofline.read(dict(RECORD, ranks=4)) == pytest.approx(1.25)


class Ev:
    def __init__(self, name, dev, start, dur, cid=0, lcid=0, annotation=False):
        self._n, self._d, self._s, self._u, self._c, self._l = name, dev, start, dur, cid, lcid
        self._a = annotation

    def is_user_annotation(self):
        return self._a

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})()})()


def test_trace_reduce():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    ev = [
        Ev(T.WINDOW, cpu, 0, 1000),
        Ev("edmbench.hill", cpu, 0, 300), Ev("edmbench.plain", cpu, 400, 200),
        Ev("cudaLaunchKernel", cpu, 10, 5, cid=1), Ev("cudaLaunchKernel", cpu, 450, 5, cid=2),
        Ev("void k1_rows<96>(float*)", cuda, 100, 100, cid=1),
        Ev("at::native::elementwise_kernel<x>", cuda, 150, 100, cid=2),  # overlaps: union 150
        Ev("k2_tail", cuda, 900, 50, cid=3),  # launched outside every span
        Ev("edmbench.plain", cuda, 0, 1000),  # a span's range on the device timeline
        Ev("aten::add", cpu, 480, 3, cid=1),  # a host op's id of another count, equal to 1
    ]
    r = T.reduce(Prof(ev))
    assert r["window_ns"] == 1000
    assert r["busy_ns"] == 150 + 50
    assert r["span_device_ns"] == {"hill": 100, "plain": 100, "unmatched": 50}
    assert r["span_count"] == {"hill": 1, "plain": 1}
    assert dict(r["device_ops"]) == {"k1_rows": 1e-7, "elementwise_kernel": 1e-7,
                                     "k2_tail": 5e-8}
    assert r["span_nccl_ns"] == {}
    assert r["device_ns_by_op"] == {"k1_rows": 100, "elementwise_kernel": 100, "k2_tail": 50}
    assert r["span_port_ns"] == {} and r["span_port_count"] == {}
    gaps = r["idle_gaps"]
    assert gaps[0] == ["plain", pytest.approx(650e-9)]  # 250..900: the host in a plain span
    assert [g for _, g in gaps] == sorted([g for _, g in gaps], reverse=True)


def test_trace_reduce_port_spans():
    """With the port's tracing on: twelve operations, each launched inside
    nested ``edm.`` spans; every operation's time is kept and the ten
    largest are ``device_ops``; each launch's time goes to its innermost
    port span, whatever host op shares its correlation id; the port's
    ranges, on the host and on the device's timeline, leave the busy time,
    the phases' device time and the operations as they are without
    them."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    base = [Ev(T.WINDOW, cpu, 0, 10_000), Ev("edmbench.plain", cpu, 0, 9_000)]
    for i in range(12):  # kernel i: launched at 100 + 700 i, runs 10 (i + 1) ns
        base += [Ev("cudaLaunchKernel", cpu, 100 + 700 * i, 5, cid=i + 1),
                 Ev(f"kernel_{i:02d}", cuda, 200 + 700 * i, 10 * (i + 1), cid=i + 1)]
    port = [
        Ev("edm.step.plain", cpu, 50, 8_000),  # every launch
        Ev("edm.force", cpu, 90, 2_000),  # kernels 0-2
        Ev("edm.force.k1", cpu, 90, 800),  # kernels 0-1: same start as its parent
        Ev("edm.force.k1", cpu, 1_500, 10),  # kernel 2 is launched at 1,500
        Ev("edm.baoab", cpu, 3_500, 200),  # kernel 5 (launched at 3,600)
        Ev("edm.force", cuda, 200, 2_000, annotation=True),  # ranges on the device
        Ev("edm.baoab", cuda, 3_700, 200),
        Ev("aten::mul", cpu, 3_550, 2, cid=1),  # host ops whose ids equal the launches'
        Ev("aten::mul", cpu, 9_500, 2, cid=6),
    ]
    plain = T.reduce(Prof(base))
    r = T.reduce(Prof(base + port))
    ns = {f"kernel_{i:02d}": 10 * (i + 1) for i in range(12)}
    assert r["device_ns_by_op"] == ns
    assert dict(r["device_ops"]) == {k: v / 1e9 for k, v in ns.items() if v > 20}
    for k in ("busy_ns", "span_device_ns", "span_count", "device_ops", "device_ns_by_op",
              "device_events", "idle_gaps"):
        assert r[k] == plain[k], k
    assert r["span_port_ns"] == {"edm.force.k1": 10 + 20 + 30, "edm.baoab": 60,
                                 "edm.step.plain": sum(ns.values()) - 120}
    assert r["span_port_count"] == {"edm.step.plain": 1, "edm.force": 1, "edm.force.k1": 2,
                                    "edm.baoab": 1}


def test_trace_reduce_nccl():
    """NCCL's kernels count in their span's device time and, apart, in
    ``span_nccl_ns``; the rest does not, nor NCCL's annotation of the
    collective on the device's timeline."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    ev = [
        Ev(T.WINDOW, cpu, 0, 1000),
        Ev("edmbench.hill", cpu, 0, 300), Ev("edmbench.plain", cpu, 400, 200),
        Ev("cudaLaunchKernel", cpu, 10, 5, cid=1), Ev("cudaLaunchKernelExC", cpu, 20, 5, cid=2),
        Ev("cudaLaunchKernel", cpu, 450, 5, cid=3), Ev("cuLaunchKernelEx", cpu, 460, 5, cid=4),
        Ev("void k1_rows<96>(float*)", cuda, 100, 100, cid=1),
        Ev("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", cuda, 200, 40,
           cid=2),
        Ev("k1_rows_pieces", cuda, 500, 100, cid=3),
        Ev("ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclDevComm*)", cuda, 600, 70, cid=4),
        Ev("nccl:all_gather", cuda, 590, 90, cid=5, annotation=True),  # a range, no operation
    ]
    r = T.reduce(Prof(ev))
    assert r["span_device_ns"] == {"hill": 140, "plain": 170}
    assert r["span_nccl_ns"] == {"hill": 40, "plain": 70}
    assert dict(r["device_ops"])["ncclDevKernel_AllGather_RING_LL"] == 4e-8
    assert "nccl:all_gather" not in dict(r["device_ops"])
    assert r["busy_ns"] == 100 + 40 + 100 + 70


def test_work_counts_pairs_once():
    """Two atoms 1.0 apart in a large box: one pair, inside the CV."""
    import torch
    cfg = {"bias": {"box_high": 3.0, "bias_spacing": 0.02}, "lj": {"rcut": 2.5}}
    x = torch.tensor([[5.0, 5.0, 5.0], [6.0, 5.0, 5.0], [15.0, 15.0, 15.0]], dtype=torch.float64)
    w = work.plain_step(cfg, x, [20.0, 20.0, 20.0])
    assert (w["pairs"], w["cv_pairs"]) == (1, 1)
    assert w["flops"] == work.PAIR_FLOPS + work.HERMITE_FLOPS + 3 * (
        work.BAOAB_FLOPS + 3 * work.NORMAL_FLOPS)
