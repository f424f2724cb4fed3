"""Profiling/debug utilities + typed configs + checkpoint-resume."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scfgp.config import (ModelConfig, OptimizerConfig, TrainConfig,
                          MeshConfig, make_model, to_dict)
from scfgp.utils.profiling import (time_fn, debug_numerics,
                                   assert_deterministic)


def test_time_fn():
    f = jax.jit(lambda x: x * 2 + 1)
    x = jnp.ones((64, 64))
    res = time_fn(f, x, iters=5)
    assert res["calls_per_s"] > 0 and res["ms_per_call"] > 0


def test_debug_numerics_catches_nan():
    with pytest.raises(FloatingPointError):
        with debug_numerics():
            jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0)) + 1


def test_assert_deterministic():
    f = jax.jit(lambda x: jnp.sum(x * x))
    x = jnp.arange(100, dtype=jnp.float32)
    assert_deterministic(lambda: f(x), reps=3)


def test_configs_reproduce_reference_defaults():
    t = TrainConfig()
    kw = t.as_optimize_kwargs()
    assert kw["batchsize"] == 150 and kw["cvrg_tol"] == 1e-4
    assert kw["max_cvrg"] == 18 and kw["max_iter"] == 500
    assert kw["algo"]["algo"] == "adam"
    assert kw["algo"]["algo_params"]["learning_rate"] == 0.01
    m = ModelConfig()
    assert m.X_scaling_method == "auto-inv-normal"
    assert to_dict(MeshConfig())["axis_name"] == "data"


def test_make_model_and_config_driven_fit():
    from scfgp.data.datasets import synthetic_gp_rff
    X, y = synthetic_gp_rff(n=150, d=3, s=3, m=8, seed=0)
    cfg = ModelConfig(sparsity=4, nfeats=8, seed=0)
    tcfg = TrainConfig(max_iter=40)
    model = make_model(cfg)
    model.set_data(X, y)
    model.optimize(**tcfg.as_optimize_kwargs())
    assert len(model.evals["COST"][1]) > 1


def test_checkpoint_resume_training():
    """save -> load -> set_data -> optimize continues (reference couldn't
    resume without set_data either, SCFGP.py:296-310 + SURVEY quirk 6)."""
    from scfgp import SCFGP
    from scfgp.data.datasets import synthetic_gp_rff
    X, y = synthetic_gp_rff(n=200, d=3, s=3, m=8, seed=1)
    m1 = SCFGP(sparsity=4, nfeats=8, seed=0)
    m1.fit(X[:160], y[:160], max_iter=30)
    c1 = m1.evals["COST"][1][-1]
    m1.save("/tmp/resume_test.pkl")

    m2 = SCFGP().load("/tmp/resume_test.pkl")
    assert (m2.S, m2.M) == (4, 8)
    m2.set_data(X[:160], y[:160])   # re-fits scalers; params preserved
    m2.optimize(max_iter=30)
    c2 = m2.evals["COST"][1][-1]
    assert np.isfinite(c2) and c2 <= c1 + 0.5  # continued, did not reset


def test_jsonl_logging_and_auto_checkpoint(tmp_path):
    import json as _json
    from scfgp import SCFGP
    from scfgp.data.datasets import synthetic_gp_rff

    X, y = synthetic_gp_rff(n=150, d=3, s=3, m=8, seed=0)
    log = str(tmp_path / "train.jsonl")
    ckpt = str(tmp_path / "ckpt.pkl")
    m = SCFGP(sparsity=4, nfeats=8, seed=0)
    m.fit(X[:120], y[:120], X[120:], y[120:], max_iter=35,
          log_file=log, checkpoint_path=ckpt, checkpoint_every=10)
    lines = [\
        _json.loads(l) for l in open(log)]
    assert len(lines) == 35
    assert {"iter", "t", "COST", "NMSE"} <= set(lines[0])
    m2 = SCFGP().load(ckpt)
    mu, _ = m2.predict(X[120:])
    assert np.isfinite(mu).all()


def test_visualizer_eval_plot_for_multidim_model(tmp_path):
    from scfgp import SCFGP, Visualizer
    from scfgp.data.datasets import synthetic_gp_rff

    X, y = synthetic_gp_rff(n=150, d=3, s=3, m=8, seed=0)
    viz = Visualizer(eval="NMSE")
    m = SCFGP(sparsity=4, nfeats=8, seed=0)
    m.set_data(X[:120], y[:120])
    m.optimize(X[120:], y[120:], visualizer=viz, max_iter=35)
    out = tmp_path / "evals.png"
    viz.save(str(out))
    assert out.stat().st_size > 10_000


def test_predict_before_fit_raises_clearly():
    from scfgp import SCFGP
    m = SCFGP(sparsity=4, nfeats=8)
    m.set_data(np.random.rand(50, 3), np.random.rand(50))
    with pytest.raises(RuntimeError, match="before training"):
        m.predict(np.random.rand(5, 3))


def test_float64_model_end_to_end():
    import jax.numpy as jnp
    from scfgp import SCFGP
    from scfgp.data.datasets import synthetic_gp_rff
    X, y = synthetic_gp_rff(n=150, d=3, s=3, m=8, seed=0)
    m = SCFGP(sparsity=4, nfeats=8, seed=0, dtype=jnp.float64)
    m.fit(X[:120], y[:120], X[120:], y[120:], max_iter=40)
    assert m.params.l_F.dtype == jnp.float64
    assert np.isfinite(m.evals["NMSE"][1][m.min_obj_ind])


def test_scaler_1d_input():
    from scfgp.data.scaler import Scaler
    y = np.random.RandomState(0).gamma(2.0, 1.0, 200)
    sc = Scaler("auto-normal").fit(y)
    ty = np.asarray(sc.forward_transform(y))
    back = np.asarray(sc.backward_transform(ty)).ravel()
    np.testing.assert_allclose(back, y, rtol=1e-5, atol=1e-6)


def test_visualizer_training_gif(tmp_path):
    """record_every frames -> save_animation writes a multi-frame GIF (the
    offline analog of the reference's committed plot_training.gif)."""
    from scfgp import SCFGP, Visualizer
    from scfgp.data.datasets import load_co2

    Xt, yt, Xv, yv, _ = load_co2(seed=0)
    viz = Visualizer(eval="NMSE", record_every=10)
    m = SCFGP(sparsity=8, nfeats=10, seed=0)
    m.set_data(Xt[:120], yt[:120])
    m.optimize(Xv[:40], yv[:40], visualizer=viz, max_iter=30)
    assert len(viz.frames) >= 2
    out = tmp_path / "training.gif"
    viz.save_animation(str(out))
    data = out.read_bytes()
    assert data[:6] in (b"GIF87a", b"GIF89a") and len(data) > 5_000


def test_run_cli_fused_and_config(tmp_path):
    """python -m scfgp equivalent: run.main() with flags and with a
    config file; writes checkpoint + prints metrics."""
    import json
    from scfgp.run import main

    out = tmp_path / "run"
    res = main(["--dataset", "co2", "--sparsity", "6", "--nfeats", "8",
                "--max-iter", "30", "--fused", "--seed", "0",
                "--out", str(out)])
    assert np.isfinite(res["metrics"]["NMSE"])
    assert (out / "model.pkl").exists()

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset": "boston",
        "model": {"sparsity": 6, "nfeats": 8, "seed": 1},
        "train": {"max_iter": 25,
                  "optimizer": {"algo": "adamax", "learning_rate": 0.05}},
    }))
    res2 = main(["--config", str(cfg)])
    assert np.isfinite(res2["metrics"]["RMSE"])


def test_run_cli_bayes_bool_config_and_key_validation(tmp_path):
    """'bayes': true (boolean opt-in) must work; unknown bayes keys must
    fail with a clear SystemExit (round-1 ADVICE item 5)."""
    import json
    import pytest
    from scfgp.run import main

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dataset": "co2",
        "model": {"sparsity": 2, "nfeats": 4, "seed": 0},
        "bayes": True,
    }))
    res = main(["--config", str(cfg), "--chains", "2", "--samples", "10",
                "--warmup", "20"])
    assert res["bayes"]["draws"] > 0

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({
        "dataset": "co2",
        "model": {"sparsity": 2, "nfeats": 4},
        "bayes": {"sampler": "hmc", "not_a_knob": 1},
    }))
    with pytest.raises(SystemExit, match="not_a_knob"):
        main(["--config", str(bad)])


def test_package_forces_honest_f32_matmul_precision():
    """scfgp import must set jax_default_matmul_precision='highest'
    (unless the user already chose): the GPU's DEFAULT lowers f32 dots to
    TF32 tensor-core GEMMs, and reduced-precision GEMMs broke the co2
    composite model (docs/RESULTS.md precision section)."""
    import jax
    import scfgp  # noqa: F401 — import side effect under test
    assert jax.config.jax_default_matmul_precision == "highest"


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the helper sets
    no other directory."""
    from scfgp.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    from scfgp.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        first = compile_cache.enable_compile_cache()
        second = compile_cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == first
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert first == second == os.path.join(repo, ".jax_cache")


def test_compile_cache_path_is_the_same_in_another_process():
    from scfgp.utils import compile_cache
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    out = subprocess.run(
        [sys.executable, "-c", "from scfgp.utils.compile_cache import "
         "enable_compile_cache as e; print(e())"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == compile_cache.DEFAULT_DIR


def test_import_needs_neither_pallas_nor_matplotlib():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, scfgp; print(sorted(m for m in sys.modules if "
         "m.startswith(('matplotlib', 'jax.experimental.pallas'))))"],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
