"""bf16-GEMM accuracy sweep across the four benchmark experiments.

docs/TODO.md open item 5: ``mm_dtype=jnp.bfloat16`` buys step throughput
(ops/dispatch.py table) by feeding the two O(N K^2) GEMMs
(Gram, latent variance — ``models/objective.py::_gemm``) bf16 inputs with
f32 accumulation.  Before making it a default we need to know what it does
to the *converged metrics* on the reference's four benchmarks
(reference: experiments/{boston_housing,abalone,kin8nm,co2}).

Protocol: for each dataset, one representative config (sparsity=20,
mid-sweep nfeats), ``--trials`` seeds, fit twice per seed — f32 GEMMs vs
bf16 GEMMs — on the SAME split and SAME init seed, so the per-seed metric
delta isolates the GEMM precision.  Decision rule: bf16 is
accuracy-neutral on a dataset if |mean delta| < across-seed std of the f32
metric for RMSE, NMSE and MNLP.

Runs on CPU by default (numerics question, not a speed question; XLA CPU
implements bf16 dots with the accelerator semantics: bf16-rounded inputs,
f32 accumulation).

Usage: python experiments/bf16_accuracy_sweep.py [--trials N] [--quick]
Writes experiments/results/bf16_sweep.json and prints a per-dataset table.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

METRICS = ("RMSE", "NMSE", "MNLP", "SCORE")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--gpu", action="store_true",
                    help="run on the default backend (GPU) instead of CPU")
    args = ap.parse_args()
    if not args.gpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from scfgp import SCFGP
    from scfgp.data.datasets import (load_abalone, load_boston,
                                     load_co2, load_kin8nm)

    max_iter = 60 if args.quick else 200
    trials = 2 if args.quick else args.trials
    # mid-sweep configs from the reference experiment scripts
    datasets = [
        ("boston", load_boston, 30),   # boston_housing.py:23 m in {10..50}
        ("abalone", load_abalone, 57), # abalone.py:36 sqrt(N)(i+1)/3, i=2
        ("kin8nm", load_kin8nm, 80),   # kin8nm.py:31, i=2
        ("co2", load_co2, 50),         # CO2_1d_regression.py:18
    ]
    opt = {"algo": {"algo": "adam", "algo_params": {"learning_rate": 0.01}},
           "max_iter": max_iter, "cvrg_tol": 1e-5, "max_cvrg": 8}

    report = {}
    for name, loader, nfeats in datasets:
        rows = {"f32": {m: [] for m in METRICS},
                "bf16": {m: [] for m in METRICS}}
        for t in range(trials):
            Xtr, ytr, Xte, yte, _info = loader(seed=t)
            for tag, mm in (("f32", None), ("bf16", jnp.bfloat16)):
                model = SCFGP(sparsity=20, nfeats=nfeats, seed=1000 + t,
                              mm_dtype=mm)
                model.fit_fast(Xtr, ytr, **opt)
                model.predict(Xte, yte)
                for m in METRICS:
                    rows[tag][m].append(float(model.evals[m][1][-1]))
        stats = {}
        for m in METRICS:
            a = np.asarray(rows["f32"][m])
            b = np.asarray(rows["bf16"][m])
            d = b - a
            stats[m] = {
                "f32_mean": float(a.mean()), "f32_std": float(a.std()),
                "bf16_mean": float(b.mean()),
                "delta_mean": float(d.mean()), "delta_std": float(d.std()),
                "neutral": bool(abs(d.mean()) < max(a.std(), 1e-12)),
            }
        report[name] = stats
        neutral = all(stats[m]["neutral"] for m in ("RMSE", "NMSE", "MNLP"))
        print(f"{name:8s} neutral={neutral} " + " ".join(
            f"{m}: {s['f32_mean']:+.4f}->{s['bf16_mean']:+.4f} "
            f"(d={s['delta_mean']:+.2e}, seed-std={s['f32_std']:.2e})"
            for m, s in stats.items() if m in ("RMSE", "MNLP")), flush=True)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "bf16_sweep.json"), "w") as f:
        json.dump({"trials": trials, "max_iter": max_iter,
                   "datasets": report}, f, indent=2)
    all_neutral = all(
        all(report[n][m]["neutral"] for m in ("RMSE", "NMSE", "MNLP"))
        for n in report)
    print(json.dumps({"all_neutral": all_neutral}))


if __name__ == "__main__":
    main()
