"""Fused-path checkpoint/resume exactness (round-2 VERDICT item 5) and the
arrays-only checkpoint codec (item 9).

``optimize_fused(checkpoint_path=..., checkpoint_every=k)`` chops the
device-side ``lax.while_loop`` at k-iteration boundaries — ``upto`` is plain
data to one compiled program — and writes an npz checkpoint at each
boundary; after a crash, ``load()`` + ``optimize_fused(resume=True)`` must
replay the EXACT trajectory of an uninterrupted run (the guarantee the host
loop already had, ``tests/test_resume.py``; the reference's single loop was
covered by its pickle, ``reference: SCFGP/SCFGP.py:296-302``).
"""

import os

import numpy as np
import pytest

from scfgp import SCFGP
from scfgp.data.datasets import synthetic_gp_rff


def _data():
    X, y = synthetic_gp_rff(n=240, d=3, s=4, m=10, noise_std=0.1, seed=0)
    return X[:200], y[:200], X[200:], y[200:]


def _params_equal(a, b):
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))


def test_segmented_equals_oneshot_bitwise(tmp_path):
    """Chopping the fused loop at checkpoint boundaries must not change a
    single bit of the trajectory (same compiled body, upto is data)."""
    Xt, yt, Xv, yv = _data()

    mA = SCFGP(sparsity=4, nfeats=10, seed=3)
    mA.fit_fast(Xt, yt, Xv, yv, max_iter=60)

    mB = SCFGP(sparsity=4, nfeats=10, seed=3)
    path = os.path.join(tmp_path, "fused.ckpt")
    mB.fit_fast(Xt, yt, Xv, yv, max_iter=60, checkpoint_path=path,
                checkpoint_every=17)  # deliberately not a divisor of 60
    assert os.path.exists(path)

    _params_equal(mA.params, mB.params)
    np.testing.assert_array_equal(np.asarray(mA.post.alpha),
                                  np.asarray(mB.post.alpha))
    assert mA.evals["COST"][1] == mB.evals["COST"][1]


def test_crash_resume_replays_exact_trajectory(tmp_path, monkeypatch):
    """Crash right after a mid-training checkpoint write; a FRESH process
    (fresh model, load()) resumes and must land bitwise on the
    uninterrupted run."""
    Xt, yt, Xv, yv = _data()

    mA = SCFGP(sparsity=4, nfeats=10, seed=3)
    mA.fit_fast(Xt, yt, Xv, yv, max_iter=60)

    path = os.path.join(tmp_path, "crash.ckpt")
    orig_save = SCFGP.save
    saves = []

    def crashing_save(self, p):
        orig_save(self, p)
        saves.append(p)
        if len(saves) == 1:  # die right after the first checkpoint
            raise KeyboardInterrupt("simulated crash")

    monkeypatch.setattr(SCFGP, "save", crashing_save)
    mB = SCFGP(sparsity=4, nfeats=10, seed=3)
    with pytest.raises(KeyboardInterrupt):
        mB.fit_fast(Xt, yt, Xv, yv, max_iter=60, checkpoint_path=path,
                    checkpoint_every=20)
    monkeypatch.setattr(SCFGP, "save", orig_save)

    mC = SCFGP(seed=99)  # different seed: everything comes from the ckpt
    mC.load(path)
    assert mC._fused_train_state is not None
    assert not mC._fused_train_state["done"]
    mC.set_data(Xt, yt)  # data is not checkpointed (reference policy)
    mC.optimize_fused(Xv, yv, resume=True)

    _params_equal(mA.params, mC.params)
    assert mA.evals["COST"][1] == mC.evals["COST"][1]
    assert np.allclose(mA.evals["NMSE"][1][-1], mC.evals["NMSE"][1][-1],
                       rtol=1e-12)


def test_fused_resume_requires_state():
    Xt, yt, _, _ = _data()
    m = SCFGP(sparsity=4, nfeats=10, seed=0)
    m.set_data(Xt, yt)
    with pytest.raises(ValueError, match="resume"):
        m.optimize_fused(resume=True)


def test_checkpoint_is_npz_not_pickle(tmp_path):
    """The checkpoint file must be a zip archive loadable with
    allow_pickle=False end to end — no code execution on load."""
    Xt, yt, Xv, yv = _data()
    m = SCFGP(sparsity=4, nfeats=10, seed=1)
    m.fit_fast(Xt, yt, Xv, yv, max_iter=10)
    path = os.path.join(tmp_path, "m.ckpt")
    m.save(path)
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"  # zip magic, not pickle's \x80
    with np.load(path, allow_pickle=False) as z:  # must not raise
        assert "__meta__" in z.files

    m2 = SCFGP(seed=9).load(path)
    _params_equal(m.params, m2.params)
    mu1, s1 = m.predict(Xv)
    mu2, s2 = m2.predict(Xv)
    np.testing.assert_array_equal(mu1, mu2)
    np.testing.assert_array_equal(s1, s2)


def test_legacy_pickle_checkpoint_still_loads(tmp_path):
    """Pre-round-3 pickle checkpoints keep loading (back compat)."""
    import pickle

    import jax

    Xt, yt, Xv, yv = _data()
    m = SCFGP(sparsity=4, nfeats=10, seed=1)
    m.fit_fast(Xt, yt, Xv, yv, max_iter=10)
    # Write the legacy format by hand (what round-2 save() produced).
    state = {
        "ID": m.ID, "S": m.S, "M": m.M, "N": m.N, "D": m.D,
        "X_scaler": m.X_scaler.to_state_dict(),
        "y_scaler": m.y_scaler.to_state_dict(),
        "params": jax.tree.map(np.asarray, m.params),
        "post": jax.tree.map(np.asarray, m.post),
        "evals": m.evals, "min_obj_ind": m.min_obj_ind,
        "thetas": None, "train_state": None, "ensemble": None,
    }
    path = os.path.join(tmp_path, "legacy.pkl")
    with open(path, "wb") as f:
        pickle.dump(state, f, pickle.HIGHEST_PROTOCOL)

    m2 = SCFGP(seed=9).load(path)
    _params_equal(m.params, m2.params)
    mu1, _ = m.predict(Xv)
    mu2, _ = m2.predict(Xv)
    np.testing.assert_array_equal(mu1, mu2)


def test_codec_roundtrip_nested_state():
    """utils/checkpoint codec: nested dict/list/tuple/NamedTuple/array
    round-trip, including numpy RandomState tuples and scalar types."""
    from scfgp.utils.checkpoint import load_state, save_state
    import tempfile

    rng = np.random.RandomState(5)
    state = {
        "a": np.arange(6).reshape(2, 3).astype(np.float32),
        "nested": {"b": [1, 2.5, "s", None, True],
                   "t": (np.float64(3.5), ("x", np.int64(2)))},
        "rng_state": rng.get_state(),
        "empty": [],
    }
    with tempfile.NamedTemporaryFile(suffix=".ckpt") as f:
        save_state(f.name, state)
        got, fmt = load_state(f.name)
    assert fmt == "npz"
    np.testing.assert_array_equal(got["a"], state["a"])
    assert got["nested"]["b"] == [1, 2.5, "s", None, True]
    assert got["nested"]["t"][0] == 3.5
    assert got["nested"]["t"][1] == ("x", 2)
    assert got["empty"] == []
    r2 = np.random.RandomState(0)
    r2.set_state(got["rng_state"])  # must be accepted by numpy
    assert r2.randint(100) == np.random.RandomState(5).randint(100)
