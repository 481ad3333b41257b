"""PyTorch port: the randomized differential-oracle sweep
(``tests/test_oracle_sweep.py``) replayed through ``edm_tpu_torch.EDMBias``.

The ten fixtures of ``tests/oracles/sweep/`` (generated by
``oracle_sweep.cpp`` from the compiled reference) span the .edm config
space: well-tempered, global tempering, targeting, accept-all and
stochastic hill_density, bias_per_step capping with deferral, drain and
skip rounds, periodic and McGDP boundaries with out-of-box rejects, 1-D
and 2-D.  The port's engine (float64, ``exact_deposit=True``) must give
each round's cum_bias and every probe within 1e-9 of the reference, as the
JAX package's does; the ``wtbatch`` fixtures replay one hill a pass
(``hill_passes="live"``), and their batched replay must stay within the
JAX test's divergence bounds.  The fixtures are parsed by the JAX test's
own ``_parse``.
"""

import numpy as np
import pytest
import torch

from edm_tpu_torch import EDMBias
from test_oracle_sweep import FIXTURES, SWEEP, _parse

torch.set_num_threads(1)
TOL = 1e-9


def _replay(fx, tmp_path, hill_passes=1):
    """The fixture's rounds through the port (one pre/add/post cycle per
    ROUND block) -> (cum_bias after each round, the probes' bias values)."""
    edm_text = fx["edm"]
    if "target" in fx:
        tpath = tmp_path / "target.grid"
        tpath.write_text(fx["target"])
        edm_text += f"target_filename {tpath}\n"
    cfg = tmp_path / "sweep.edm"
    cfg.write_text(edm_text)
    b = EDMBias(str(cfg), fx["T"], fx["kB"], dtype=torch.float64, log_hills=False,
                exact_deposit=True, hill_passes=hill_passes, device="cpu")
    b.set_box(fx["lo"], fx["hi"], fx["periodic"])
    dim = fx["dim"]
    cums = []
    for hills, _ in fx["rounds"]:
        b.pre_add_hill(fx["est"])
        for row in hills:
            b.add_hill_r(list(row[:dim]), row[dim])
        b.post_add_hill()
        cums.append(b.cum_bias)
    probes = np.array([b.bias_value(q) for q, _ in fx["probes"]])
    return np.array(cums), probes


def _want(fx):
    return np.array([c for _, c in fx["rounds"]]), np.array([v for _, v in fx["probes"]])


@pytest.mark.parametrize("path", FIXTURES, ids=[p.stem.replace("sweep_", "") for p in FIXTURES])
def test_sweep_config_matches_reference(path, tmp_path):
    fx = _parse(path)
    live = fx["name"].startswith("wtbatch")
    cums, probes = _replay(fx, tmp_path, hill_passes="live" if live else 1)
    want_cums, want = _want(fx)
    np.testing.assert_allclose(cums, want_cums, atol=TOL, rtol=0, err_msg=fx["name"])
    np.testing.assert_allclose(probes, want, atol=TOL, rtol=0, err_msg=fx["name"])


def test_live_passes_chain_the_cap_exactly(tmp_path):
    """captgt1d one hill a pass: the sequential cap chains across the
    sub-batches exactly (heights are static there)."""
    fx = _parse(SWEEP / "sweep_captgt1d.txt")
    cums, probes = _replay(fx, tmp_path, hill_passes="live")
    want_cums, want = _want(fx)
    np.testing.assert_allclose(cums, want_cums, atol=TOL, rtol=0)
    np.testing.assert_allclose(probes, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["wtbatch1d", "wtbatch2d"])
def test_batched_well_tempering_divergence_bounded(name, tmp_path):
    """The batched round-start well-tempering approximation against the
    reference's live hill-by-hill grid: nonzero, and within the JAX test's
    bounds (relative cum_bias 0.048, probes 0.038)."""
    fx = _parse(SWEEP / f"sweep_{name}.txt")
    cums, probes = _replay(fx, tmp_path, hill_passes=1)
    want_cums, want = _want(fx)
    rel_cum = np.max(np.abs(cums - want_cums) / np.abs(want_cums))
    rel_probe = np.max(np.abs(probes - want)) / np.max(np.abs(want))
    assert rel_cum > 1e-12, (name, rel_cum)
    assert rel_cum < 0.048, (name, rel_cum)
    assert rel_probe < 0.038, (name, rel_probe)


def test_sweep_fixtures_exist():
    names = {p.stem.replace("sweep_", "") for p in FIXTURES}
    assert names == {"wt1d", "gt1d", "captgt1d", "mcgdp1d", "wt2d", "mix2d", "tgt2d", "wtcap1d",
                     "wtbatch1d", "wtbatch2d"}
