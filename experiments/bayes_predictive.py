"""Posterior-predictive validation of the Bayes layer on the benchmarks.

SURVEY.md §7.2's own validation plan for the new sampling capability is
"predictive parity + MC error bars" — this experiment is that measurement
(VERDICT r3 item 1).  On each benchmark (experiment configs, >=3 split
seeds) it measures held-out NMSE and MNLP for five inference arms at the
SAME model capacity (same S, m — so the comparison isolates the inference
strategy, not capacity):

  map       fit_fast — the reference's inference (a point estimate;
            predictive: ``reference: SCFGP/SCFGP.py:278-294``)
  ensemble  fit_ensemble(k, mix_best) — point-estimate basin mixing, the
            measured floor-closer (docs/RESULTS.md)
  hmc       fit_bayes(sampler="hmc", chain_init="map") — within-basin
            posterior mixing
  tempered  fit_bayes(sampler="tempered") — replica-exchange, cross-basin
  sgld      fit_bayes(sampler="sgld", chain_init="map") — Langevin
  fleet     fit_bayes(sampler="hmc", chains=32, shared_adaptation=False)
            — the PRODUCTION random-init fleet recipe (round-4 probe
            result promoted into the multi-seed campaign, VERDICT r4
            item 4)
  ens_init  fit_bayes(chain_init="ensemble") — chains warm-started at
            distinct fit_ensemble basins (+jitter): the direct test of
            whether sampling adds mass on top of the tournament's basins
            (boston question, VERDICT r4 item 5; boston + kin8nm only)

Every Bayes arm reports BOTH the reference-faithful predictive and the
``predict_bayes(recalibrate=True)`` per-draw-recalibrated one
(``*_recal`` columns) — the shipped flag that closes the co2 dispersion
inflation documents its effect in the headline table instead of only in a
pin test (VERDICT r4 item 4).  Fits run under the round-5 shipped
arithmetic (quality-gated mm_precision dispatch); SAMPLERS run true f32
(the r05b finding: auto 1-pass in the log-posterior collapsed every
kin8nm Bayes arm — MH ratios exponentiate N-scaled cost differences —
so fit_bayes keeps auto-reduced precision out of the sampling path).

MC error bars for the Bayes arms come from CHAIN bootstrap: per-chain
predictive moments (mu_c, var_c) are exact sub-mixtures, so a bootstrap
over chains re-mixes in closed form (law of total variance) without
re-solving — see ``_chain_bootstrap``.  Across seeds, mean +/- std.

Wall-clock per arm is recorded (device-seconds matching is reported, not
enforced: the table carries a seconds column so nats/s can be read off).

Usage: python experiments/bayes_predictive.py [--cpu] [--quick]
           [--datasets boston,abalone,kin8nm,co2] [--seeds 3]
Writes experiments/results/bayes_predictive/results.json.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _co2_basis_factory(n_total):
    import jax.numpy as jnp
    import numpy as np
    omega = 2 * np.pi * (n_total - 1) / 12.0

    def seasonal_trend(Xs):
        t = Xs[:, :1]
        return jnp.concatenate(
            [jnp.ones_like(t), t, t * t,
             jnp.sin(omega * t), jnp.cos(omega * t),
             jnp.sin(2 * omega * t), jnp.cos(2 * omega * t)], axis=1)

    return seasonal_trend


# Arm budget philosophy: MAP/ensemble use each experiment's committed
# optimizer recipe; Bayes budgets are FIXED per dataset (not tuned per
# seed) and sized so each fused sampler program stays short.
DATASETS = {
    "boston": dict(S=20, M=50, ens=dict(k=16, mix_best=8),
                   opt=dict(max_iter=500, cvrg_tol=1e-5, max_cvrg=18)),
    "abalone": dict(S=20, M=64, ens=dict(k=8, mix_best=4),
                    skip_arms=("ens_init",),
                    opt=dict(max_iter=500, cvrg_tol=1e-5, max_cvrg=18)),
    "kin8nm": dict(S=20, M=50, ens=dict(k=8, mix_best=4),
                   opt=dict(max_iter=500, cvrg_tol=1e-5, max_cvrg=18)),
    "co2": dict(S=10, M=20, ens=dict(k=8, mix_best=4), co2=True,
                skip_arms=("ens_init",),
                opt=dict(max_iter=1000, cvrg_tol=1e-5, max_cvrg=60,
                         obj="cost",
                         algo={"algo": "adamax",
                               "algo_params": {"learning_rate": 0.05,
                                               "beta1": 0.8, "beta2": 0.999,
                                               "epsilon": 1e-8}})),
}

BAYES = {
    "hmc": dict(sampler="hmc", chains=8, num_warmup=300, num_samples=300,
                num_integration_steps=16, init_step_size=0.003,
                chain_init="map", map_iters=300),
    "tempered": dict(sampler="tempered", chains=8, num_warmup=100,
                     num_samples=200, num_integration_steps=16,
                     init_step_size=0.003, max_rungs=12, segment=50),
    "sgld": dict(sampler="sgld", chains=8, num_warmup=2000,
                 num_samples=500, thin=4, init_step_size=1e-5,
                 chain_init="map", map_iters=300),
    # The production fleet recipe (kin8nm_probe.json, promoted to the
    # multi-seed campaign): many random inits, per-chain adaptation.
    "fleet": dict(sampler="hmc", chains=32, num_warmup=300,
                  num_samples=300, num_integration_steps=16,
                  init_step_size=0.003, shared_adaptation=False),
    # Ensemble-basin warm starts (+ per-chain jitter): sampling on top of
    # the tournament's own basins (boston + kin8nm; VERDICT r4 item 5).
    "ens_init": dict(sampler="hmc", chains=16, num_warmup=300,
                     num_samples=300, num_integration_steps=16,
                     init_step_size=0.003, chain_init="ensemble",
                     map_iters=300, shared_adaptation=False),
}


# Bump to invalidate crash-resume state from earlier rounds' campaigns.
CAMPAIGN = "r05b"


def _loader(name):
    from scfgp.data import datasets as ds
    return {"boston": ds.load_boston, "abalone": ds.load_abalone,
            "kin8nm": ds.load_kin8nm, "co2": ds.load_co2}[name]


def _metrics(mu, std, ys):
    from scfgp.utils.metrics import regression_metrics
    m = regression_metrics(mu, std, ys)
    return {"NMSE": m["NMSE"], "MNLP": m["MNLP"], "RMSE": m["RMSE"]}


def _chain_bootstrap(model, Xv, yv, n_boot=200, seed=0):
    """Chain-bootstrap MC error bars for the predictive metrics.

    Per-chain predictive moments are exact sub-mixtures: with equal draws
    per chain, A_c = E_c[mu], B_c = Var_c = E_c[var] + E_c[mu^2] - A_c^2,
    so any chain subset R re-mixes in closed form:
        mu_R  = mean_{c in R} A_c
        var_R = mean_{c in R} (B_c + A_c^2) - mu_R^2.
    Bootstrap over chains (the independent sampling units) and push each
    re-mix through the model's un-scaling to get metric error bars.
    """
    import jax.numpy as jnp
    import numpy as np
    from scfgp.bayes.predictive import predictive_mixture

    samples = np.asarray(model.bayes_result.samples)     # (Ns, C, P)
    ns, C, P = samples.shape
    Xs_t = jnp.asarray(model.X_scaler.forward_transform(Xv), model.dtype)
    A, B = [], []
    for c in range(C):
        mu_c, std_c = predictive_mixture(
            jnp.asarray(samples[:, c, :], model.dtype), model.X, model.y,
            Xs_t, model.D, model.S, model.M, basis_fn=model.extra_basis,
            streaming_block=getattr(model, "_bayes_streaming_block", 0))
        A.append(np.asarray(mu_c))
        B.append(np.asarray(std_c) ** 2)
    A, B = np.stack(A), np.stack(B)                      # (C, nv)
    ys = np.asarray(yv).reshape(-1, 1)
    rng = np.random.RandomState(seed)
    boots = []
    for _ in range(int(n_boot)):
        idx = rng.randint(0, C, C)
        mu = A[idx].mean(axis=0)
        var = (B[idx] + A[idx] ** 2).mean(axis=0) - mu * mu
        mu_y, std_y = model._unscale_moments(
            jnp.asarray(mu, model.dtype),
            jnp.asarray(np.sqrt(np.maximum(var, 1e-12)), model.dtype))
        boots.append(_metrics(mu_y, std_y, ys))
    return {k: {"mc_std": float(np.std([b[k] for b in boots])),
                "mc_mean": float(np.mean([b[k] for b in boots]))}
            for k in boots[0]}


def run_dataset(name, seeds, quick=False, verbose=True):
    import numpy as np
    from scfgp import SCFGP

    cfg = DATASETS[name]
    rows = []
    for seed in seeds:
        Xt, yt, Xv, yv, meta = _loader(name)(seed=seed)
        ys = np.asarray(yv).reshape(-1, 1)
        model_kw = dict(sparsity=cfg["S"], nfeats=cfg["M"], seed=seed)
        opt = dict(cfg["opt"])
        ens = dict(cfg["ens"])
        if cfg.get("co2"):
            model_kw.update(
                X_scaling_method="min-max", y_scaling_method="normal",
                extra_basis=_co2_basis_factory(Xt.shape[0] + Xv.shape[0]))
        if quick:
            opt["max_iter"] = min(opt["max_iter"], 60)
            ens = dict(k=4, mix_best=2)
        if quick == "tiny":              # CPU smoke: path coverage only
            opt["max_iter"] = 30
            ens = dict(k=2, mix_best=2)

        arms = {}

        def record(arm, mets, wall, extra=None):
            r = dict(mets, wall_s=round(wall, 2))
            if extra:
                r.update(extra)
            arms[arm] = r
            if verbose:
                print(f"  [{name} seed={seed}] {arm:9s} "
                      f"NMSE={mets['NMSE']:.4f} MNLP={mets['MNLP']:+.3f} "
                      f"({wall:.1f}s)", flush=True)

        # -- map ----------------------------------------------------------
        m = SCFGP(**model_kw)
        t0 = time.time()
        m.fit_fast(Xt, yt, **opt)
        if cfg.get("co2"):
            m.recalibrate_dispersion()  # committed co2 recipe
        mu, std = m.predict(Xv)
        record("map", _metrics(mu, std, ys), time.time() - t0)

        # -- ensemble -----------------------------------------------------
        m = SCFGP(**model_kw)
        t0 = time.time()
        m.fit_ensemble(Xt, yt, k=ens["k"], mix_best=ens["mix_best"], **opt)
        if cfg.get("co2"):
            m.recalibrate_dispersion()
        mu, std = m.predict(Xv)
        record("ensemble", _metrics(mu, std, ys), time.time() - t0,
               {"k": ens["k"], "mix_best": ens["mix_best"]})

        # -- bayes arms ---------------------------------------------------
        for arm, bkw in BAYES.items():
            if arm in cfg.get("skip_arms", ()):
                continue
            bkw = dict(bkw)
            if quick:
                bkw.update(num_warmup=min(bkw["num_warmup"], 60),
                           num_samples=min(bkw["num_samples"], 60))
                if "map_iters" in bkw:
                    bkw["map_iters"] = 60
            if quick == "tiny":
                bkw.update(num_warmup=16, num_samples=16, chains=4)
                if bkw["sampler"] == "tempered":
                    bkw.update(max_rungs=4, segment=8)
                if bkw["sampler"] == "sgld":
                    bkw.update(thin=1)
                if "map_iters" in bkw:
                    bkw["map_iters"] = 30
            m = SCFGP(**model_kw)
            t0 = time.time()
            import warnings
            with warnings.catch_warnings(record=True) as wlist:
                warnings.simplefilter("always")
                m.fit_bayes(Xt, yt, **bkw)
            wall = time.time() - t0
            mu, std = m.predict_bayes(Xv)
            mets = _metrics(mu, std, ys)
            # The shipped dispersion cure, in the headline table: per-draw
            # recalibrated predictive alongside the reference-faithful one
            # (VERDICT r4 item 4 — point predictions are identical, only
            # the predictive variance changes).
            mu_r, std_r = m.predict_bayes(Xv, recalibrate=True)
            mets_r = _metrics(mu_r, std_r, ys)
            d = m.bayes_diagnostics
            boot = _chain_bootstrap(m, Xv, yv,
                                    n_boot=10 if quick else 200, seed=seed)
            record(arm, mets, wall, {
                "NMSE_recal": mets_r["NMSE"],
                "MNLP_recal": mets_r["MNLP"],
                "mc_std_NMSE": boot["NMSE"]["mc_std"],
                "mc_std_MNLP": boot["MNLP"]["mc_std"],
                "max_rhat": float(d.max_rhat),
                "rhat_logdensity": float(d.rhat_logdensity),
                "min_ess_bulk": float(d.min_ess_bulk),
                "divergences": int(d.divergences or 0),
                "accept": float(getattr(m.bayes_result, "accept_rate",
                                        float("nan")))})
        rows.append({"seed": seed, "source": meta["source"], "arms": arms})
    return rows


def summarize(rows):
    """Across-seed mean +/- std per arm/metric."""
    import numpy as np
    arms = rows[0]["arms"].keys()
    out = {}
    for a in arms:
        out[a] = {}
        for k in ("NMSE", "MNLP", "RMSE", "wall_s", "NMSE_recal",
                  "MNLP_recal"):
            if k not in rows[0]["arms"][a]:
                continue
            vals = [r["arms"][a][k] for r in rows]
            out[a][k] = {"mean": float(np.mean(vals)),
                         "std": float(np.std(vals))}
        for k in ("mc_std_NMSE", "mc_std_MNLP", "max_rhat",
                  "min_ess_bulk"):
            if k in rows[0]["arms"][a]:
                out[a][k] = float(np.mean(
                    [r["arms"][a][k] for r in rows]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU smoke: minimal budgets, path coverage only")
    ap.add_argument("--datasets", default="boston,abalone,kin8nm,co2")
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    names = [s.strip() for s in args.datasets.split(",") if s.strip()]
    seeds = list(range(args.seeds))
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", "bayes_predictive")
    os.makedirs(out, exist_ok=True)
    # tiny smoke runs must never clobber the committed campaign artifact
    outpath = os.path.join(out, "results_tiny.json" if args.tiny
                           else "results.json")
    results = {}
    # Crash-resume: a fault mid-campaign keeps finished datasets.
    if os.path.exists(outpath) and not args.tiny:
        try:
            with open(outpath) as f:
                prev = json.load(f)
            if (prev.get("quick") == args.quick
                    and prev.get("campaign") == CAMPAIGN):
                results = prev.get("results", {})
                if results:
                    print("resuming; have:", sorted(results), flush=True)
        except Exception:
            pass
    for name in names:
        if name in results:
            continue
        print(f"== {name} ==", flush=True)
        rows = run_dataset(name, seeds,
                           quick="tiny" if args.tiny else args.quick)
        results[name] = {"rows": rows, "summary": summarize(rows)}
        for a, s in results[name]["summary"].items():
            print(f"  {name:10s} {a:9s} NMSE {s['NMSE']['mean']:.4f}"
                  f"±{s['NMSE']['std']:.4f}  MNLP {s['MNLP']['mean']:+.3f}"
                  f"±{s['MNLP']['std']:.3f}  wall {s['wall_s']['mean']:.1f}s",
                  flush=True)
        import jax
        payload = {"backend": jax.default_backend(), "quick": args.quick,
                   "campaign": CAMPAIGN,
                   "arithmetic": ("quality-gated mm_precision dispatch"
                                  " ('default' GEMMs for non-composite"
                                  " fits, true f32 for the co2 composite;"
                                  " ops/dispatch.py)"),
                   "bayes_budgets": BAYES,
                   "dataset_configs": {k: {kk: vv for kk, vv in v.items()
                                           if kk != "co2"}
                                       for k, v in DATASETS.items()},
                   "results": results}
        with open(outpath, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        print("wrote", outpath, flush=True)


if __name__ == "__main__":
    main()
