"""PyTorch port: the McGovern-De Pablo separable deposition and the rounds
that run it, against the JAX package.

The same seeded numpy inputs go through ``edm_tpu`` (x64, as the conftest
sets) and ``edm_tpu_torch`` on the CPU.  Tolerances:

  - float64 tables, grids and round records: 1e-12 relative to
    max(1, max|.|) (both sides run the same IEEE operations; the sums over
    hills and grid rows run in another order);
  - the float32 case: 1e-5 relative to max(1, max|.|);
  - integer and bool leaves (counters, flags, buffer indices, histogram
    counts): exactly;
  - the port's McGDP deposit against its own windowed route: 1e-12 off the
    corners where a hill's square support and its spherical support
    disagree, and within the e^-8 class there (3 and 40 times
    sum(h) e^-8 / (pi sigma'_0 sigma'_1) in 2-D, 5 and 60 times with
    pi^1.5 in 3-D), as ``tests/test_deposit_mcgdp{2d,3d}.py`` hold the JAX
    package's own;
  - the compacted and dense strip passes, and the chunked hill loop,
    against the uncompacted, unchunked pass: 1e-12 and 1e-13 (float64
    regrouping only).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_f64, assert_tree, to_port
from edm_tpu import GaussGrid as JGaussGrid
from edm_tpu import bias as JB
from edm_tpu.ops import deposit as JD
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch import bias as TB
from edm_tpu_torch import gauss as tg
from edm_tpu_torch.ops import deposit as TD

TDT = {jnp.float32: torch.float32, jnp.float64: torch.float64}

CASES_2D = ([False, True], [True, False], [False, False])
CASES_3D = ([False, True, True], [True, False, True], [True, True, False],
            [False, False, True], [False, False, False])
# the JAX tests' grids: (max, spacing, sigma) per dimension count
GEOM = {2: ([4.0, 3.0], [0.05, 0.06], [0.2, 0.15]),
        3: ([4.0, 3.0, 3.5], [0.1, 0.12, 0.1], [0.2, 0.15, 0.18])}


def _grids(periodic, dtype=jnp.float64):
    hi, dx, sig = GEOM[len(periodic)]
    zero = [0.0] * len(periodic)
    return (JGaussGrid.create(zero, hi, dx, periodic, sig, dtype=dtype),
            tg.GaussGrid.create(zero, hi, dx, periodic, sig, dtype=TDT[dtype], device="cpu"))


def _hills(D, seed=0, H=7):
    """The JAX tests' centres (inside the box) and heights."""
    rng = np.random.default_rng(seed)
    hi = GEOM[D][0]
    c = np.stack([rng.uniform(0.1, hi[d] - 0.1, H) for d in range(D)], -1)
    return c, rng.uniform(0.05, 0.3, H)


def _jax_deposit(g, c, h):
    tabs = JD.dense_tables_mcgdp(g, c)
    return tabs._replace(strip_cache=None), JD.deposit_from_mcgdp(g, tabs, h)


def _both(jg, tgg, c, h, dtype=jnp.float64):
    """The tables and the deposit through both packages (the JAX pair
    jitted, traced anew on each call so that a patched module constant
    takes effect)."""
    jt, jo = jax.jit(_jax_deposit)(jg, jnp.asarray(c, dtype), jnp.asarray(h, dtype))
    tt = TD.dense_tables_mcgdp(tgg, torch.tensor(c, dtype=TDT[dtype]))
    to, reads = TD.deposit_from_mcgdp(tgg, tt, torch.tensor(h, dtype=TDT[dtype]))
    return jt, jo, tt, to, reads


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("periodic,dtype", [(p, jnp.float64) for p in CASES_2D + CASES_3D]
                         + [([False, False], jnp.float32)])
def test_tables_and_deposit_match_jax(periodic, dtype):
    """The per-dim tables, the unit integrals s, and the deposited values
    and derivatives, for every periodicity mix of the JAX tests; the
    float32 case puts some centres outside the box (hill_okf = 0) and on
    the strips."""
    D = len(periodic)
    jg, tgg = _grids(periodic, dtype)
    c, h = _hills(D, seed=D)
    if dtype == jnp.float32:
        c[:2, 0] = [-0.05, 4.02]  # outside the box: no deposit
        c[2:4, 1] = [0.03, 2.95]  # on the strips
    jt, jo, tt, to, reads = _both(jg, tgg, c, h, dtype)
    rtol = 1e-12 if dtype == jnp.float64 else 1e-5
    assert reads == 0  # 7 hills: the strip passes take the whole batch
    assert_f64(tt.s, jt.s, "s", rtol=rtol)
    for d in range(D):
        assert_f64(tt.sep_value[d], jt.sep_value[d], f"sep_value {d}", rtol=rtol)
        assert len(tt.sep_grads[d]) == len(jt.sep_grads[d])
        for k, (tterm, jterm) in enumerate(zip(tt.sep_grads[d], jt.sep_grads[d])):
            for e, (a, b) in enumerate(zip(tterm, jterm)):
                assert_f64(a, b, f"sep_grads {d} term {k} factor {e}", rtol=rtol)
    assert_f64(to.grid.values, jo.grid.values, "values", rtol=rtol)
    assert_f64(to.grid.derivs, jo.grid.derivs, "derivs", rtol=rtol)
    assert float(np.abs(np.asarray(jo.grid.values)).max()) > 0.1


def _ambiguous(spec, centers):
    """Grid points inside some hill's square support but outside its
    spherical one (where the McGDP tables and the windows may differ)."""
    D = spec.dim
    axes = [spec.grid.min[d] + spec.grid.dx[d] * np.arange(spec.grid.nbins[d]) for d in range(D)]
    X = np.meshgrid(*axes, indexing="ij")
    amb = np.zeros_like(X[0], bool)
    for c in np.asarray(centers):
        dps = []
        for d in range(D):
            dp = X[d] - c[d]
            if spec.grid.periodic[d]:
                L = spec.grid.max[d] - spec.grid.min[d]
                dp -= np.round(dp / L) * L
            dps.append(dp / spec.sigma[d])
        inside = np.all(np.stack([dp**2 < 8.0 for dp in dps]), axis=0)
        amb |= inside & (sum(dp**2 for dp in dps) >= 8.0)
    return amb


@pytest.mark.parametrize("periodic", CASES_2D + CASES_3D[3:])
def test_mcgdp_matches_windowed(periodic):
    """The port's McGDP deposit against its own windowed route
    (``hill_windows`` + ``deposit_precomputed``, the reference-exact
    route): exact off the corners where the support shapes differ, the e^-8
    class in them; and h s against the windowed route's bias_added."""
    D = len(periodic)
    _, tgg = _grids(periodic)
    c, h = _hills(D)
    ct, ht = torch.tensor(c), torch.tensor(h)
    gw, added = TD.deposit_precomputed(tgg, TD.hill_windows(tgg, ct), ht)
    tabs = TD.dense_tables_mcgdp(tgg, ct)
    gs, _ = TD.deposit_from_mcgdp(tgg, tabs, ht)
    amb = _ambiguous(tgg.spec, c)
    dv = (gw.grid.values - gs.grid.values).abs().numpy()
    dd = (gw.grid.derivs - gs.grid.derivs).abs().numpy().max(-1)
    assert dv[~amb].max() < 1e-12 and dd[~amb].max() < 1e-12
    norm = 1.0 / (math.pi ** (D / 2) * np.prod(tgg.spec.sigma))
    bound = float(h.sum()) * math.exp(-8.0) * norm
    kv, kd = (3.0, 40.0) if D == 2 else (5.0, 60.0)
    assert amb.any() and dv.max() < kv * bound and dd.max() < kd * bound
    vol = float(np.prod(tgg.spec.grid.dx))
    assert abs(float((ht * tabs.s).sum()) - float(added.sum())) < 5.0 * bound * vol * dv.size


# ------------------------------------------------- compaction and chunking


def _compaction_case():
    """The JAX test's batch: 96 hills, a dozen near the walls, every
    eleventh of height zero, on a fine non-periodic 2-D grid."""
    periodic = [False, False]
    jg = JGaussGrid.create([0, 0], [4.0, 3.0], [0.02, 0.024], periodic, [0.05, 0.06],
                           dtype=jnp.float64)
    tgg = tg.GaussGrid.create([0, 0], [4.0, 3.0], [0.02, 0.024], periodic, [0.05, 0.06],
                              dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    H = 96
    c = np.stack([rng.uniform(0.5, 3.5, H), rng.uniform(0.5, 2.5, H)], -1)
    c[:6, 0] = rng.uniform(0.0, 0.2, 6)  # near the x-low wall
    c[6:12, 1] = rng.uniform(2.8, 3.0, 6)  # near the y-high wall
    h = rng.uniform(0.05, 0.3, H)
    h[::11] = 0.0
    return jg, tgg, c, h


def test_strip_compaction_branches(monkeypatch):
    """Both branches of the strip passes' host decision against the
    uncompacted pass (capacity 256 >= H): capacity 24 fits both walls'
    near hills (compacted), capacity 2 does not (dense); each reads the two
    strip counts once.  The uncompacted pass is also the JAX deposit."""
    jg, tgg, c, h = _compaction_case()
    reach = [(2.0 + math.sqrt(8.0)) * s * math.sqrt(2) + dx
             for s, dx in ((0.05, 0.02), (0.06, 0.024))]
    for d, top in enumerate((4.0, 3.0)):
        near = ((np.abs(c[:, d]) < reach[d]) | (np.abs(c[:, d] - top) < reach[d])) & (h != 0)
        assert 2 < near.sum() <= 24

    def run():
        tabs = TD.dense_tables_mcgdp(tgg, torch.tensor(c))
        out, reads = TD.deposit_from_mcgdp(tgg, tabs, torch.tensor(h))
        return out.grid.values, out.grid.derivs, reads

    ref_v, ref_d, reads = run()
    assert reads == 0
    _, jo = jax.jit(_jax_deposit)(jg, jnp.asarray(c), jnp.asarray(h))
    assert_f64(ref_v, jo.grid.values, "values vs JAX")
    assert_f64(ref_d, jo.grid.derivs, "derivs vs JAX")
    for cap in (24, 2):
        monkeypatch.setattr(TD, "_STRIP_COMPACT_CAP", cap)
        v, d, reads = run()
        assert reads == 1, cap
        np.testing.assert_allclose(v.numpy(), ref_v.numpy(), rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(d.numpy(), ref_d.numpy(), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("budget", ["1 << 12", "4 blocks"])
def test_strip_hill_chunking(monkeypatch, budget):
    """A tiny hill-chunk budget changes nothing but the grouping of the
    strip sums (1e-13), and the chunked loop matches the JAX scan under the
    same budget: 4,096 elements (a chunk per hill, the JAX test's budget),
    and four strip blocks (chunks of 4 of the 6 hills, the tail padded with
    zero-height rows)."""
    periodic = [False, True, False]
    jg, tgg = _grids(periodic)
    c, h = _hills(3, seed=3, H=6)
    _, _, tt, to, _ = _both(jg, tgg, c, h)
    per = tt.strip_cache["per"]
    elems = 1 << 12 if budget == "1 << 12" else 4 * int(
        per[2]["strip"].numel() * per[0]["dp2"].shape[1] * per[1]["dp2"].shape[1])
    monkeypatch.setattr(TD, "_STRIP_CHUNK_ELEMS", elems)
    monkeypatch.setattr(JD, "_STRIP_CHUNK_ELEMS", elems)
    ch, Hp = TD._strip_hill_chunks(per, 2, 6)
    assert (ch, Hp) == ((1, 6) if budget == "1 << 12" else (4, 8))
    jt_c, jo_c, tt_c, to_c, _ = _both(jg, tgg, c, h)
    for a, b in ((to_c.grid.values, to.grid.values), (to_c.grid.derivs, to.grid.derivs),
                 (tt_c.s, tt.s)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-13)
    assert_f64(to_c.grid.values, jo_c.grid.values, "chunked values vs JAX")
    assert_f64(to_c.grid.derivs, jo_c.grid.derivs, "chunked derivs vs JAX")
    assert_f64(tt_c.s, jt_c.s, "chunked s vs JAX")


# ---------------------------------------------------------------- rounds


def _round_setup(D, cfg_head, periodic):
    hi, dx, sig = GEOM[D]
    cfg = parse_edm_text(
        cfg_head + f"dimension {D}\nbox_low {' '.join(['0'] * D)}\n"
        f"box_high {' '.join(map(str, hi))}\nbias_spacing {' '.join(map(str, dx))}\n"
        f"bias_sigma {' '.join(map(str, sig))}\n")
    zero = [0.0] * D
    jparams, jbs = JB.subdivide(cfg, 1.0, 1.0, zero, hi, zero, hi, periodic, zero,
                                dtype=jnp.float64)
    return jparams, jbs, to_port(jparams), to_port(jbs)


CAPPED = "tempering 0\nhill_prefactor 0.3\nbias_per_step 0.5\n"
WELL_TEMPERED = ("tempering 1\nbias_factor 10\nglobal_tempering -1\nhill_prefactor 0.6\n"
                 "bias_per_step 0.5\nhill_density 4\n")


_JROUND = jax.jit(JB.add_hills_round, static_argnames=("est_hill_count", "n_passes"))


def _rounds(jparams, jbs, tparams, tbs, rounds, what):
    """Drive both packages through ``rounds`` (a list of (pos, runiform,
    est, kwargs)) and hold every record and state leaf; returns the JAX
    records and the port's host reads.  The JAX round is jitted (one
    compile serves the rounds of one shape)."""
    jrecs, reads = [], []
    for r, (pos, run, est, kw) in enumerate(rounds):
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        jbs, jrec = _JROUND(jparams, jbs, jnp.asarray(pos), jnp.asarray(run),
                            est_hill_count=est, **jkw)
        tbs, trec, n = TB.add_hills_round(tparams, tbs, torch.tensor(pos), torch.tensor(run),
                                          est, **tkw)
        assert_tree(trec, jrec, 1e-12, f"{what} round {r} records")
        assert_tree(tbs, jbs, 1e-12, f"{what} round {r} state")
        jrecs.append(jrec)
        reads.append(n)
    return jrecs, reads


@pytest.mark.parametrize("periodic", [[False, True], [False, False], [False, True, False]])
def test_capped_engine_round(periodic):
    """Two capped rounds on a McGDP grid (the JAX tests' engine round, with
    centres also outside the box and on the walls): the first defers the
    hills past bias_per_step, the second drains them and skips."""
    D = len(periodic)
    jparams, jbs, tparams, tbs = _round_setup(D, CAPPED, periodic)
    rng = np.random.default_rng(1)
    hi = GEOM[D][0]
    pos = np.stack([rng.uniform(-0.2, hi[d] + 0.2, 12) for d in range(D)], -1)
    pos[0, 0], pos[1, -1] = 0.0, hi[-1]
    zeros = np.zeros(12)
    jrecs, _ = _rounds(jparams, jbs, tparams, tbs, [(pos, zeros, 1.0, {})] * 2, str(periodic))
    assert not bool(jrecs[0].skipped) and bool(jrecs[0].hill_straddled.any())
    assert bool(jrecs[1].skipped) and bool(jrecs[1].drain_processed.any())


def test_n_passes():
    """``n_passes`` 2 and H on a well-tempered McGDP grid: each pass's
    heights against the grid holding the earlier passes, the cap carried
    across passes, hills deferred and drained; a pass with no called hill
    is skipped (zeros and False in its records, one host read for its
    gate); H % n_passes raises."""
    H = 4
    rng = np.random.default_rng(7)
    hi = GEOM[2][0]
    rounds = []
    for r in range(3):
        pos = np.stack([rng.uniform(0.0, hi[d], H) for d in range(2)], -1)
        run = rng.uniform(0, 1, H) * 0.5
        active = np.ones(H, bool)
        active[2:] = r != 1  # round 1: the second half calls no hill
        rounds.append((pos, run, 10.0, dict(active=active)))
    for n_passes in (2, H):
        jparams, jbs, tparams, tbs = _round_setup(2, WELL_TEMPERED, [False, False])
        rr = [(p, u, e, dict(kw, n_passes=n_passes)) for p, u, e, kw in rounds]
        jrecs, reads = _rounds(jparams, jbs, tparams, tbs, rr, f"n_passes={n_passes}")
        called = [np.asarray(r.hill_called) for r in jrecs]
        assert called[0][:2].any() and called[0][2:].any() and not called[1][2:].any()
        assert any(np.asarray(r.hill_defer_h).any() for r in jrecs)
        # a skipped pass: its records are zeros
        assert not np.asarray(jrecs[1].hill_h)[2:].any()
        assert min(reads) >= n_passes - 1
    with pytest.raises(ValueError, match="n_passes"):
        TB.add_hills_round(tparams, tbs, torch.zeros(H, 2, dtype=torch.float64),
                           torch.zeros(H, dtype=torch.float64), 10.0, n_passes=3)


def test_override_heights_replay():
    """Replay: the given heights are deposited for the active hills with no
    acceptance draw and no tempering (every record and state leaf, two
    rounds, also with two passes)."""
    H = 10
    rng = np.random.default_rng(11)
    hi = GEOM[2][0]
    rounds = []
    for n_passes in (1, 2):
        pos = np.stack([rng.uniform(0.0, hi[d], H) for d in range(2)], -1)
        active = rng.uniform(size=H) < 0.8
        heights = rng.uniform(0.01, 0.1, H)
        rounds.append((pos, np.ones(H), 10.0,
                       dict(active=active, override_heights=heights, n_passes=n_passes)))
    jparams, jbs, tparams, tbs = _round_setup(2, WELL_TEMPERED, [False, True])
    jrecs, _ = _rounds(jparams, jbs, tparams, tbs, rounds, "replay")
    r0 = jrecs[0]
    np.testing.assert_array_equal(np.asarray(r0.hill_h), rounds[0][3]["override_heights"])
    assert np.asarray(r0.hill_called).sum() == rounds[0][3]["active"].sum()
