"""PyTorch port: the spatial host's brick cases and the dry-run probes that
run it, on gloo ranks on the CPU, held to the port's own serial engine.

  - the two ``slow`` brick cases of ``tests/test_spatial.py`` at their
    sizes, on 8 ranks (one launch for the module): a (2, 4) brick
    decomposition of the periodic and of the non-periodic (McGovern-De
    Pablo) 2-D box, two rounds of frozen atoms, the stitched grid's values
    and derivatives within the JAX tests' 1e-9 of the serial windowed
    deposits of the same hills at the replayed heights
    (``GaussGrid.add_value`` on the port's serial grid), float64;
  - the dry-run probes 2, 3 and 8 (``parallel.dryrun``: the 1-D spatial
    stitch, the overlap-filtered stitch and the brick-spatial (2, 1)
    stitch) on 2 ranks (one launch), within their JAX bounds; the whole
    ``dryrun_multichip`` runs on the card in ``chip_smoke.py``.
"""

import pickle
import threading

import numpy as np
import pytest

import _torch_spatial_ranks as sranks
from edm_tpu_torch import parallel as tpar

EDM2D = ("tempering 0\nhill_prefactor 1.0\nbias_per_step 100\ndimension 2\n"
         "box_low 0 0\nbox_high 10 10\nbias_spacing 0.05 0.05\nbias_sigma 0.2 0.2\n")
SKIN = 1.25
PROBES = ("spatial_probe", "overlap_probe", "brick_spatial_probe")


def _brick_atoms(parts=(2, 4), widths=(5.0, 2.5)):
    xs = []
    for i in range(parts[0]):
        for j in range(parts[1]):
            lo = (i * widths[0], j * widths[1])
            xs.append([lo[0] + 0.4, lo[1] + 0.3, 0.0])
            xs.append([lo[0] + widths[0] - 0.3, lo[1] + widths[1] - 0.2, 0.0])
    return np.asarray(xs)


def _launch(tmp, fn, n, inputs, tag):
    path = tmp / f"{tag}.pkl"
    with open(path, "wb") as fh:
        pickle.dump(inputs, fh)
    return tpar.launch(fn, n, str(path), backend="gloo", device="cpu",
                       init_file=str(tmp / f"{tag}.store"), timeout=300)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 8-rank brick cases and the 2-rank probes, launched together."""
    tmp = tmp_path_factory.mktemp("spatial_probes")
    cases = [(f"brick_{name}", dict(case="brick_serial", cfg=EDM2D, x0=_brick_atoms(), skin=SKIN,
                                    periodic=[periodic] * 2))
             for name, periodic in (("periodic", True), ("nonperiodic", False))]
    jobs = {"bricks": (sranks.spatial_cases, 8, {"cases": cases}),
            "probes": (sranks.probes, 2, {"probes": PROBES})}
    res, errs = {}, []

    def run(name, fn, n, inputs):
        try:
            res[name] = _launch(tmp, fn, n, inputs, name)
        except Exception as e:  # raised again below, in the test's thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(k, *v)) for k, v in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return res


def _brick_checks(res, name):
    for r, p in enumerate(res):
        b = p[name]
        assert b["nbins"] == ((200, 200) if name == "brick_periodic" else (201, 201))
        for got, want, what in zip(b["grid"], b["ref"], ("values", "derivatives")):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9,
                                       err_msg=f"rank {r} {name} {what}")
        assert np.isfinite(b["energy"]) and b["per_rank"] > 0
        assert b["cum_bias"] == res[0][name]["cum_bias"]
        assert abs(b["total_volume"] - 8 * 100.0) < 1e-9
    return res[0][name]


def test_spatial_brick_2d_matches_serial(runs):
    """(2, 4) bricks of a periodic 2-D grid: local coordinates in both dims,
    hills exchanged once and replayed everywhere."""
    _brick_checks(runs["bricks"], "brick_periodic")


def test_spatial_brick_2d_nonperiodic_mcgdp(runs):
    """(2, 4) bricks of a non-periodic 2-D box: McGovern-De Pablo hills at
    the walls and corners through per-dim boundary offsets; the wall
    derivatives exactly zero."""
    b = _brick_checks(runs["bricks"], "brick_nonperiodic")
    assert b["nonper"] == (True, True)
    values, derivs = b["grid"]
    assert values[0, 0] > 0.0
    np.testing.assert_allclose(derivs[0, :, 0], 0.0, atol=1e-12)
    np.testing.assert_allclose(derivs[:, 0, 1], 0.0, atol=1e-12)


@pytest.mark.parametrize("probe", PROBES)
def test_dryrun_probe_on_two_ranks(runs, probe):
    """Each probe's checks on both ranks, within the JAX probe's bounds."""
    for r, res in enumerate(runs["probes"]):
        checks = res[probe]
        assert checks, f"rank {r}: {probe} checked nothing"
        for what, (err, bound) in checks.items():
            assert err < bound, (r, what, err, bound)
