#!/usr/bin/env python3
"""Smoke test of the SCFGP training path on GPUs, against plain references.

    python chip_smoke.py            # one GPU: phases 0-5
    python chip_smoke.py --gpus 4   # four GPUs: the multi-device paths only

Runs the system's main path through its public API at full width (the
kin8nm-scale model, N=8192, D=8, S=50, M=200, so 2(S+M)=500), compares
each result with the repo's plain reference, and prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Phases (one process owns the card; each prints its wall and compile time):

  0. device check: a GPU or exit non-zero; card name + power limit;
  1. one training step (``loss_and_grad``) in true f32, the default
     auto dispatch and bf16 GEMM inputs, against the float64 NumPy golden
     (cost) and the same function on the host CPU at 'highest' (gradient),
     plus what each precision setting lowered to (GEMM kernel names, and
     a Gram's error against float64 in each arithmetic);
  2. ``SCFGP.fit_fast`` on the kin8nm surrogate, a short host-looped
     ``optimize``, ``predict``: NMSE inside the committed kin8nm band;
  3. the co2 composite (``extra_basis``, true f32) at its Bayes floor;
  4. ``loss_fn_streaming`` at N=65536 against the dense ``loss_fn``;
  5. one fused ``fit_bayes(sampler="hmc")`` run with 8 chains;
  6. (``--gpus N`` only) DP (gspmd, shard_map), DP x TP on a 2 x 2 mesh,
     ``fit_fast(mesh=)`` and chain-sharded HMC against one device.

Any failed check raises, so the script exits non-zero and prints no result
line.  Times are informational, not benchmark numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of every phase (FULL on the card, TINY in CPU tests)."""

    n: int            # phase 1 rows
    d: int            # input width of the synthetic phases
    s: int            # sparsity S
    m: int            # Fourier features M
    fit_iters: int    # phase 2 fit_fast iterations
    host_iters: int   # phase 2 host-looped optimize iterations
    fit_nmse_max: float  # phase 2 band top (the bottom is the Bayes floor)
    co2_iters: int
    co2_floor_ratio: float  # phase 3: NMSE <= ratio x Bayes floor
    stream_n: int
    stream_block: int
    hmc_chains: int
    hmc_warmup: int
    hmc_samples: int
    hmc_steps: int
    multi_n: int      # phase 6 rows
    multi_iters: int  # phase 6 fit_fast iterations


# kin8nm band: the committed kin8nm records span NMSE 0.028-0.067 (the
# round-5 campaign arms, docs/RESULTS.md) up to 0.14-0.24 (the sweep means
# of results/kin8nm{,_s20}/results.json); a fit that broke (non-finite
# fallback, garbage precision) lands near 1.  The bottom is the
# surrogate's closed-form Bayes floor (~0.012).  co2: the committed
# composite sits at 1.003x its floor (experiments/results/co2/
# composite.json); tests pin 1.2x.
FULL = Sizes(n=8192, d=8, s=50, m=200, fit_iters=300, host_iters=20,
             fit_nmse_max=0.15, co2_iters=800, co2_floor_ratio=1.2,
             stream_n=65536, stream_block=4096, hmc_chains=8, hmc_warmup=20,
             hmc_samples=10, hmc_steps=8, multi_n=65536, multi_iters=20)
TINY = Sizes(n=256, d=3, s=4, m=12, fit_iters=60, host_iters=5,
             fit_nmse_max=0.5, co2_iters=200, co2_floor_ratio=3.0,
             stream_n=700, stream_block=128, hmc_chains=4, hmc_warmup=3,
             hmc_samples=3, hmc_steps=3, multi_n=512, multi_iters=20)

# Relative errors allowed in phase 1: (cost vs the f64 golden, gradient
# L2 vs the same step on the host CPU at 'highest'), each about one unit
# of the arithmetic's rounding: f32 2^-23 times the ~10x that the 2K x 2K
# Cholesky's conditioning adds; TF32 (10 mantissa bits) 2^-11 ~ 4.9e-4;
# bf16 (7) 2^-8 ~ 3.9e-3.  Measured on an H100 (400 W): fp32 6.5e-9 /
# 1.4e-8, auto 6.5e-9 / 5.8e-7, bf16 7.3e-6 / 5.9e-5.
TOLERANCES = {"fp32": (1e-6, 1e-5), "auto": (5e-4, 5e-4),
              "bf16": (4e-3, 4e-3)}
# Phase 4: streaming and dense run the same f32 math in another order
# (measured on an H100: cost equal, gradient 8.1e-7).
STREAM_TOL = (1e-6, 1e-5)
# Phase 6: the sharded paths sum rows in another order (psum over NVLink),
# so f32 results differ in the last bits.  4 x H100 measured 1.6e-5
# (gspmd, shard_map), 1.8e-5 (DP x TP) on one step's update, 2.0e-5 on the
# chains' log posteriors and 2.1e-4 on 20 SGD steps of fit_fast(mesh)
# (the cost history grows a 1e-5 first difference over the steps).
MULTI_TOL = 1e-3
MULTI_FIT_TOL = 1e-3


class SmokeFailure(AssertionError):
    """A phase's result fell outside its stated tolerance or band."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _flat(tree) -> np.ndarray:
    import jax
    return np.concatenate([np.asarray(t, np.float64).ravel()
                           for t in jax.tree.leaves(tree)])


def regression_data(n: int, d: int, seed: int):
    """Smooth trig response in d inputs plus noise, as float32 arrays."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    y = (np.sin(6.0 * X[:, 0]) + 0.5 * np.cos(3.0 * X[:, -1])
         + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def step_fn(mm_dtype, mm_precision):
    """Jitted ``(params, X, y) -> (cost, grads)`` of the training objective."""
    import jax
    from scfgp import loss_and_grad

    def f(p, X, y):
        (cost, _), g = loss_and_grad(p, X, y, mm_dtype=mm_dtype,
                                     mm_precision=mm_precision)
        return cost, g
    return jax.jit(f)


def device_kernels(fn, args,
                   keys=("gemm", "xmma", "cutlass", "matmul", "nvjet")):
    """Names of the device kernels of one traced call whose name holds one
    of ``keys`` (empty where the backend records no device plane)."""
    import glob
    import jax
    with tempfile.TemporaryDirectory() as d:
        jax.block_until_ready(fn(*args))
        with jax.profiler.trace(d):
            jax.block_until_ready(fn(*args))
        names = set()
        for path in glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                              recursive=True):
            data = jax.profiler.ProfileData.from_file(path)
            for plane in data.planes:
                if not plane.name.startswith("/device:"):
                    continue
                for line in plane.lines:
                    for ev in line.events:
                        if any(k in ev.name.lower() for k in keys):
                            names.add(ev.name[:100])
    return sorted(names)


# -- phases -----------------------------------------------------------------

def phase_device(n_gpus: int) -> dict:
    """Phase 0: the GPU, its name and power limit, the compile cache."""
    import jax
    from scfgp.utils.compile_cache import enable_compile_cache
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's first device is "
                           f"{devs[0].platform} ({devs[0].device_kind})")
    check(len(devs) >= n_gpus, f"--gpus {n_gpus} but JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return {"kind": devs[0].device_kind, "count": len(devs),
            "nvidia_smi": smi, "compile_cache": enable_compile_cache()}


def phase_step(sz: Sizes) -> dict:
    """Phase 1: one training step in three arithmetics vs the references."""
    import jax
    import jax.numpy as jnp
    from scfgp import init_params, pack_params
    from scfgp.ops.dispatch import resolve_mm_dtype, resolve_mm_precision
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from golden_numpy import golden_cost

    X, y = regression_data(sz.n, sz.d, seed=0)
    p = init_params(jax.random.PRNGKey(0), sz.d, sz.s, sz.m, jnp.float32)
    two_k = 2 * (sz.s + sz.m)
    ref_cost = golden_cost(np.asarray(pack_params(p), np.float64),
                           X.astype(np.float64),
                           y.astype(np.float64)[:, None], sz.d, sz.s, sz.m)
    cpu = jax.devices("cpu")[0]
    _, ref_grad = step_fn(None, None)(*jax.device_put((p, X, y), cpu))
    ref_grad = _flat(ref_grad)

    legs = {"fp32": (None, None),
            "auto": (resolve_mm_dtype("auto", sz.n, two_k),
                     resolve_mm_precision("auto")),
            "bf16": (jnp.bfloat16, None)}
    args = jax.device_put((p, X, y), jax.devices()[0])
    out = {"golden_cost": ref_cost}
    for name, (mm_dtype, mm_precision) in legs.items():
        fn = step_fn(mm_dtype, mm_precision)
        cost, grad = fn(*args)
        cost_err = abs(float(cost) - ref_cost) / abs(ref_cost)
        grad_err = _rel(_flat(grad), ref_grad)
        cost_tol, grad_tol = TOLERANCES[name]
        out[name] = {"mm_dtype": None if mm_dtype is None
                     else jnp.dtype(mm_dtype).name,
                     "mm_precision": mm_precision, "cost": float(cost),
                     "cost_rel_err": cost_err, "grad_rel_err": grad_err,
                     "gemm_kernels": device_kernels(fn, args)}
        check(np.isfinite(float(cost)) and np.isfinite(grad_err),
              f"phase 1 {name}: non-finite cost or gradient")
        check(cost_err <= cost_tol, f"phase 1 {name}: cost rel err "
              f"{cost_err:.3g} > {cost_tol:g}")
        check(grad_err <= grad_tol, f"phase 1 {name}: grad rel err "
              f"{grad_err:.3g} > {grad_tol:g}")
    out["gemm_kernels_high"] = device_kernels(step_fn(None, "high"), args)
    out["gram_rel_err"] = gram_precision(X)
    return out


def gram_precision(X) -> dict:
    """Relative error of an (N x 500) Gram X'X-like product in each
    arithmetic against float64 — the precision each setting delivers."""
    import jax
    import jax.numpy as jnp
    A = np.cos(X.astype(np.float64) @ np.random.RandomState(5).randn(
        X.shape[1], 500))
    ref = A.T @ A
    A32 = jax.device_put(A.astype(np.float32), jax.devices()[0])
    out = {}
    for name, dtype, prec in (("highest", jnp.float32, "highest"),
                              ("high", jnp.float32, "high"),
                              ("default", jnp.float32, "default"),
                              ("bf16", jnp.bfloat16, None)):
        a = A32.astype(dtype)
        got = jax.jit(lambda a: jnp.dot(
            a.T, a, precision=prec,
            preferred_element_type=jnp.float32))(a)
        out[name] = _rel(got, ref)
    return out


def phase_fit(sz: Sizes) -> dict:
    """Phase 2: fit_fast + host-looped optimize + predict on kin8nm."""
    from scfgp import SCFGP
    from scfgp.data.datasets import load_kin8nm, surrogate_floor

    Xt, yt, Xv, yv, meta = load_kin8nm(seed=0)
    floor = surrogate_floor("kin8nm", Xv, yv)["NMSE"]
    m = SCFGP(sparsity=sz.s, nfeats=sz.m, seed=0)
    m.fit_fast(Xt, yt, Xv, yv, max_iter=sz.fit_iters)
    nmse = float(m.evals["NMSE"][1][m.min_obj_ind])
    iters = len(m.evals["COST"][1])
    m.optimize(Xv, yv, max_iter=sz.host_iters)
    nmse_host = float(m.evals["NMSE"][1][m.min_obj_ind])
    mu, std = m.predict(Xv)
    check(mu.shape == std.shape and mu.size == len(yv),
          f"predict shapes {mu.shape}, {std.shape} for {len(yv)} rows")
    check(bool(np.isfinite(mu).all() and np.isfinite(std).all()
               and (std > 0).all()), "predict: non-finite mean or std")
    check(floor <= nmse <= sz.fit_nmse_max, f"kin8nm NMSE {nmse:.4g} "
          f"outside [{floor:.4g}, {sz.fit_nmse_max}]")
    check(floor <= nmse_host <= sz.fit_nmse_max,
          f"kin8nm NMSE after optimize {nmse_host:.4g} out of band")
    return {"source": meta["source"], "nmse": nmse, "iters": iters,
            "nmse_after_optimize": nmse_host, "floor_nmse": floor,
            "mm_precision": m.mm_precision}


def phase_composite(sz: Sizes) -> dict:
    """Phase 3: the co2 composite model (true f32) at its Bayes floor."""
    import jax.numpy as jnp
    from scfgp import SCFGP
    from scfgp.data.datasets import load_co2, surrogate_floor

    Xt, yt, Xv, yv, meta = load_co2(seed=0)
    floor = surrogate_floor("co2", Xv, yv)["NMSE"]
    omega = 2 * np.pi * (Xt.shape[0] + Xv.shape[0] - 1) / 12.0

    def seasonal_trend(Xs):
        t = Xs[:, :1]
        return jnp.concatenate(
            [jnp.ones_like(t), t, t * t,
             jnp.sin(omega * t), jnp.cos(omega * t),
             jnp.sin(2 * omega * t), jnp.cos(2 * omega * t)], axis=1)

    m = SCFGP(sparsity=10, nfeats=20, seed=0, X_scaling_method="min-max",
              y_scaling_method="normal", extra_basis=seasonal_trend,
              dtype=jnp.float32)
    m.fit_fast(Xt, yt, Xv, yv, obj="cost", max_iter=sz.co2_iters,
               algo={"algo": "adamax",
                     "algo_params": {"learning_rate": 0.05, "beta1": 0.8,
                                     "beta2": 0.999, "epsilon": 1e-8}},
               max_cvrg=40)
    nmse = float(m.evals["NMSE"][1][m.min_obj_ind])
    check(m.mm_precision == "highest",
          f"composite resolved to {m.mm_precision}, not true f32")
    check(np.isfinite(nmse) and nmse <= sz.co2_floor_ratio * floor,
          f"co2 composite NMSE {nmse:.4g} > {sz.co2_floor_ratio} x floor "
          f"{floor:.4g}")
    return {"nmse": nmse, "floor_nmse": floor, "ratio": nmse / floor}


def phase_streaming(sz: Sizes) -> dict:
    """Phase 4: blockwise streaming objective vs the dense objective."""
    import jax
    import jax.numpy as jnp
    from scfgp import init_params, loss_fn
    from scfgp.ops.streaming import loss_fn_streaming

    X, y = regression_data(sz.stream_n, sz.d, seed=1)
    p = init_params(jax.random.PRNGKey(1), sz.d, sz.s, sz.m, jnp.float32)
    dense = jax.jit(jax.value_and_grad(lambda q, X, y: loss_fn(q, X, y)[0]))
    stream = jax.jit(jax.value_and_grad(lambda q, X, y: loss_fn_streaming(
        q, X, y, block_size=sz.stream_block)[0]))
    args = jax.device_put((p, X, y), jax.devices()[0])
    c_d, g_d = dense(*args)
    c_s, g_s = stream(*args)
    cost_err = abs(float(c_s) - float(c_d)) / abs(float(c_d))
    grad_err = _rel(_flat(g_s), _flat(g_d))
    check(np.isfinite(float(c_s)), "streaming cost non-finite")
    check(cost_err <= STREAM_TOL[0], f"streaming cost rel err "
          f"{cost_err:.3g} > {STREAM_TOL[0]:g}")
    check(grad_err <= STREAM_TOL[1], f"streaming grad rel err "
          f"{grad_err:.3g} > {STREAM_TOL[1]:g}")
    return {"n": sz.stream_n, "block": sz.stream_block,
            "blocks": -(-sz.stream_n // sz.stream_block),
            "cost": float(c_s), "cost_rel_err": cost_err,
            "grad_rel_err": grad_err}


def phase_hmc(sz: Sizes) -> dict:
    """Phase 5: one fused chain-parallel HMC run through fit_bayes."""
    from scfgp import SCFGP
    from scfgp.data.datasets import load_kin8nm

    Xt, yt, Xv, yv, _ = load_kin8nm(seed=0)
    m = SCFGP(sparsity=sz.s, nfeats=sz.m, seed=0)
    m.fit_bayes(Xt, yt, sampler="hmc", chains=sz.hmc_chains,
                num_warmup=sz.hmc_warmup, num_samples=sz.hmc_samples,
                num_integration_steps=sz.hmc_steps)
    draws = np.asarray(m.bayes_result.samples)
    check(draws.shape[:2] == (sz.hmc_samples, sz.hmc_chains),
          f"draws shape {draws.shape}")
    check(bool(np.isfinite(draws).all()), "non-finite HMC draws")
    return {"draws_shape": list(draws.shape),
            "accept_rate": float(m.bayes_result.accept_rate),
            "divergences": int(m.bayes_result.divergences),
            "step_size": float(np.mean(m.bayes_result.step_size))}


def _check_spread(arr, devices, what: str) -> None:
    """Each device holds its own row shard of ``arr``."""
    shards = arr.addressable_shards
    held = {s.device for s in shards}
    check(held == set(devices), f"{what}: shards on {sorted(map(str, held))}")
    rows = {s.index[0] for s in shards}
    check(len(rows) == len(devices), f"{what}: {len(rows)} distinct row "
          f"blocks over {len(devices)} devices")


def phase_multi(sz: Sizes, n_dev: int) -> dict:
    """Phase 6: the multi-device paths against one device, same data."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from scfgp import SCFGP, init_params, loss_fn, pack_params
    from scfgp.bayes import hmc_sample, make_logposterior
    from scfgp.bayes.predictive import reduced_dim
    from scfgp.opt.optimizers import make_optimizer, tree_add
    from scfgp.parallel import (make_dp_train_step, make_mesh, make_mesh2d,
                                make_tp_train_step, shard_rows,
                                shard_rows_2d)

    devices = jax.devices()[:n_dev]
    check(len(devices) == n_dev, f"need {n_dev} devices")
    one = devices[0]
    mesh = make_mesh(devices)
    X, y = regression_data(sz.multi_n, sz.d, seed=2)
    p = init_params(jax.random.PRNGKey(2), sz.d, sz.s, sz.m, jnp.float32)
    # SGD: the step's update is linear in the gradient, so comparing
    # updates compares gradients (adam's first step is ~lr*sign(g), which
    # flips on gradient entries that are zero up to rounding).  lr=1 keeps
    # the update large next to the f32 rounding of params - p0.
    tx = make_optimizer("sgd", {"learning_rate": 1.0})
    st = tx.init(p)
    p0 = _flat(p)
    out = {"devices": n_dev, "n": sz.multi_n}
    problems = []  # every comparison runs; the phase fails at the end

    def expect(ok, what):
        if not ok:
            problems.append(what)

    vg = jax.value_and_grad(lambda q, X, y: loss_fn(q, X, y)[0])

    @jax.jit
    def single_step(q, s, X, y):
        cost, g = vg(q, X, y)
        delta, s = tx.update(g, s, q)
        return tree_add(q, delta), cost

    p1, c1 = single_step(*jax.device_put((p, st, X, y), one))
    d1 = _flat(p1) - p0

    Xs, ys, ws = shard_rows(mesh, X, y)
    _check_spread(Xs, devices, "dp rows")
    for mode in ("gspmd", "shard_map"):
        p2, _, c2, _ = make_dp_train_step(tx, mesh, mode=mode)(
            p, st, Xs, ys, ws)
        err = max(abs(float(c2) - float(c1)) / abs(float(c1)),
                  _rel(_flat(p2) - p0, d1))
        out[f"dp_{mode}_rel_err"] = err
        expect(err <= MULTI_TOL, f"dp {mode} vs one device: {err:.3g}")

    mesh2 = make_mesh2d(n_dev // 2, 2, devices)
    X2, y2, w2 = shard_rows_2d(mesh2, X, y)
    check({s.device for s in X2.addressable_shards} == set(devices),
          "dp x tp: rows not on every device")
    p3, _, c3 = make_tp_train_step(tx, mesh2)(p, st, X2, y2, w2)
    err = max(abs(float(c3) - float(c1)) / abs(float(c1)),
              _rel(_flat(p3) - p0, d1))
    out["dp_x_tp_rel_err"] = err
    expect(err <= MULTI_TOL, f"dp x tp vs one device: {err:.3g}")

    # True f32 and plain SGD here.  TF32 rounds each shard's partial Gram
    # on its own: under the auto dispatch the first costs differ by ~6e-4
    # and 20 adam steps carry that to 3.6%; at true f32 adam still grows
    # a 1e-5 first-cost difference to 1.5e-3 in 5 steps (~lr * sign(g)
    # flips, measured on 4 x H100).  SGD's update is linear in g.
    costs = {}
    sgd = {"algo": "sgd", "algo_params": {"learning_rate": 0.01}}
    for label, kw in (("one", {}), ("mesh", {"mesh": mesh})):
        m = SCFGP(sparsity=sz.s, nfeats=sz.m, seed=0, mm_precision=None)
        m.fit_fast(X, y, max_iter=sz.multi_iters, algo=sgd, **kw)
        costs[label] = np.asarray(m.evals["COST"][1], np.float64)
    check(costs["one"].shape == costs["mesh"].shape,
          "fit_fast(mesh) ran another number of iterations")
    # Relative to the history's scale: the cost crosses zero as it trains.
    err = float(np.max(np.abs(costs["mesh"] - costs["one"]))
                / np.max(np.abs(costs["one"])))
    out["fit_fast_mesh_cost_rel_err"] = err
    out["fit_fast_cost_first_last"] = [costs["one"][0], costs["one"][-1],
                                       costs["mesh"][0], costs["mesh"][-1]]
    expect(err <= MULTI_FIT_TOL, f"fit_fast(mesh) cost history: {err:.3g}")

    chains = 2 * n_dev
    dim = reduced_dim(sz.d, sz.s, sz.m)
    keys = jax.random.split(jax.random.PRNGKey(3), chains)
    q0 = jnp.stack([pack_params(init_params(k, sz.d, sz.s, sz.m,
                                            jnp.float32))[:dim]
                    for k in keys])

    # The chains' log posteriors and gradients, sharded vs one device.
    # (The draws themselves are not compared: an N-scaled log density
    # carries f32 rounding of ~1e-2 nats at N=65536, enough to flip an
    # accept decision and send the two chains apart.)
    @jax.jit
    def chain_grads(q, X, y):
        return jax.vmap(jax.value_and_grad(
            make_logposterior(X, y, sz.d, sz.s, sz.m)))(q)

    @jax.jit
    def sample(q, X, y):
        return hmc_sample(make_logposterior(X, y, sz.d, sz.s, sz.m), q,
                          jax.random.PRNGKey(4), num_warmup=sz.hmc_warmup,
                          num_samples=sz.hmc_samples,
                          num_integration_steps=sz.hmc_steps,
                          init_step_size=0.003)

    lp1, g1 = chain_grads(*jax.device_put((q0, X, y), one))
    q_sh = jax.device_put(q0, NamedSharding(mesh, P("data", None)))
    _check_spread(q_sh, devices, "hmc chains")
    rep = NamedSharding(mesh, P())
    X_rep, y_rep = jax.device_put(X, rep), jax.device_put(y, rep)
    lp4, g4 = chain_grads(q_sh, X_rep, y_rep)
    err = max(_rel(lp4, lp1), _rel(g4, g1))
    out["hmc_chain_logpost_grad_rel_err"] = err
    expect(err <= MULTI_TOL, f"chain-sharded log posterior: {err:.3g}")
    res = sample(q_sh, X_rep, y_rep)
    out["hmc_final_positions_on"] = len(
        {s.device for s in res.final_positions.addressable_shards})
    out["hmc_accept_rate"] = float(res.accept_rate)
    out["hmc_accept_rate_one_device"] = float(
        sample(*jax.device_put((q0, X, y), one)).accept_rate)
    expect(bool(np.isfinite(np.asarray(res.samples)).all()),
           "non-finite sharded HMC draws")
    check(not problems, "; ".join(problems) + " | "
          + json.dumps(out, default=float))
    return out


# -- main -------------------------------------------------------------------

class _CompileClock:
    """Seconds JAX spent tracing, lowering and compiling since reset()."""

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **_):
        if name.startswith("/jax/core/compile/"):
            self.total += secs

    def reset(self):
        self.total = 0.0


def _run_phase(clock, label, fn, *args) -> dict:
    clock.reset()
    t0 = time.perf_counter()
    res = fn(*args)
    wall = time.perf_counter() - t0
    print(f"[{label}] wall {wall:.1f} s, compile {clock.total:.1f} s: "
          + json.dumps(res, default=str), flush=True)
    return res


def result_line(kind: str, count: int) -> str:
    """The last line of the output: the contract's keys and nothing else."""
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", type=int, default=1,
                    help="1 (default): the single-card phases; N > 1: the "
                         "multi-device paths on N cards, and nothing else")
    args = ap.parse_args(argv)
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found "
              f"{jax.devices()[0].platform}; nothing was measured",
              file=sys.stderr)
        return 1
    clock = _CompileClock()
    dev = _run_phase(clock, "phase 0 device", phase_device, args.gpus)
    print("card: " + "; ".join(dev["nvidia_smi"]), flush=True)
    if args.gpus > 1:
        _run_phase(clock, f"phase 6 multi-device x{args.gpus}", phase_multi,
                   FULL, args.gpus)
    else:
        _run_phase(clock, "phase 1 step", phase_step, FULL)
        _run_phase(clock, "phase 2 fit", phase_fit, FULL)
        _run_phase(clock, "phase 3 composite", phase_composite, FULL)
        _run_phase(clock, "phase 4 streaming", phase_streaming, FULL)
        _run_phase(clock, "phase 5 hmc", phase_hmc, FULL)
    print("card: " + "; ".join(dev["nvidia_smi"]), flush=True)
    print(result_line(dev["kind"], args.gpus), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
