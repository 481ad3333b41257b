"""PyTorch port: checkpoint and resume of sharded runs (``utils/checkpoint``
with a mesh), on gloo ranks on the CPU.

The counterparts of ``tests/test_checkpoint.py``'s sharded cases: each run
is checkpointed part way into one file (``save_state(state, file, mesh)``,
every rank calling it, rank 0 writing), restored on every rank into a
freshly built template (``load_state(template, file, mesh)``) and continued;
every leaf on every rank must equal the uninterrupted run bitwise.  The
slab host (replicated: each leaf stored once), the spatial host and the
sharded coordinate host (a leading rank axis), each on 2 ranks
(``tests/_torch_ranks.checkpoint_resume``), with deferred hills in the
buffer at the checkpoint.  A file of 2 ranks loaded on one rank, or on a
mesh of another shape, raises ``EDMError``.  The three launches run at
once: ~12 s on one worker.
"""

import pickle
import threading

import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_parity import tree_leaves
from edm_tpu_torch import parallel as tpar
from edm_tpu_torch.utils.checkpoint import load_state
from edm_tpu_torch.utils.errors import EDMError

CASES = {  # host: (steps in all, steps before the checkpoint, stored once)
    "slab": (4, 2, True),
    "spatial": (3, 1, False),
    "coord": (12, 6, False),
}


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Each case's launch of 2 gloo ranks, all three at once."""
    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    out, errs = {}, []

    def run(host):
        n_steps, n_mid, _ = CASES[host]
        path = tmp / f"{host}.pkl"
        with open(path, "wb") as fh:
            pickle.dump(dict(host=host, n_steps=n_steps, n_mid=n_mid,
                             file=str(tmp / f"{host}.npz")), fh)
        try:
            out[host] = tpar.launch(ranks.checkpoint_resume, 2, str(path), backend="gloo",
                                    device="cpu", init_file=str(tmp / f"{host}.store"),
                                    timeout=180)
        except Exception as e:  # raised again in the tests' thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(h,)) for h in CASES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return tmp, out


@pytest.mark.parametrize("host", list(CASES))
def test_sharded_resume_bitwise(resumed, host):
    """Resumed from one file, every leaf on every rank bitwise the
    uninterrupted run; hills were deferred at the checkpoint."""
    _, out = resumed
    for r, res in enumerate(out[host]):
        assert res["deferred"] > 0, f"{host} rank {r}: no deferred hills at the checkpoint"
        full, cont = dict(tree_leaves(res["full"])), dict(tree_leaves(res["cont"]))
        assert full.keys() == cont.keys()
        for name, a in full.items():
            b = cont[name]
            assert (a.shape, a.dtype) == (b.shape, b.dtype), f"{host} rank {r} {name}"
            np.testing.assert_array_equal(b, a, err_msg=f"{host} rank {r} {name}")


@pytest.mark.parametrize("host", list(CASES))
def test_sharded_file_layout(resumed, host):
    """One file: leaves stored once where the ranks' states are bitwise
    alike (the slab host), else with a leading rank axis; the fingerprint
    names 2 ranks and the layout; a mesh of the same ranks in another shape
    is refused."""
    tmp, out = resumed
    _, _, replicated = CASES[host]
    with np.load(tmp / f"{host}.npz") as data:
        fp = bytes(data["__fingerprint__"]).decode()
        leaf = data["leaf_0"]
    assert "|mesh ranks=2 shape=2 layout=" + ("replicated" if replicated else "rows") in fp
    res0 = out[host][0]
    first = next(tree_leaves(res0["full"]))[1]
    assert leaf.shape == (first.shape if replicated else (2,) + first.shape)
    for r in out[host]:
        assert "does not match" in r["other_shape_error"]


def test_two_rank_file_on_one_rank_raises(resumed):
    """A 2-rank file loaded without a mesh, into a one-device template of
    the same host, raises ``EDMError`` (the rank count is in the
    fingerprint); so does a 2-rank rows file."""
    tmp, _ = resumed
    mesh = tpar.make_mesh(device="cpu")  # one rank: no process group
    _, template = ranks._ckpt_slab(mesh)
    with pytest.raises(EDMError, match="ranks=2"):
        load_state(template, str(tmp / "slab.npz"))
    with pytest.raises(EDMError, match="ranks=2"):
        load_state(template, str(tmp / "slab.npz"), mesh)
