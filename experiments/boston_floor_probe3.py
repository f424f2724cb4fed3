"""Probe 3: ensemble size / feature count / patience on the boston floor.

Uses fit_fast_batch so each ensemble trains as ONE vmapped program.
Candidates (all with the linear extra basis from probe 1/2):

  ens5_m20   — 5 members, m=20, 500 iters (probe-2 winner: ~1.14)
  ens8_m20   — 8 members
  ens8_m50   — 8 members, m=50
  ens8_long  — 8 members, 1500 iters, max_cvrg 40
  ens8_ynorm — 8 members, y_scaling='normal' (no Box-Cox on target)

Usage: python experiments/boston_floor_probe3.py [--seeds K]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")

from scfgp import SCFGP, fit_fast_batch
from scfgp.data.datasets import load_boston, surrogate_floor

ALGO = {"algo": "adam",
        "algo_params": {"learning_rate": 0.01, "beta1": 0.9,
                        "beta2": 0.999, "epsilon": 1e-8}}


def linear_basis(X):
    import jax.numpy as jnp
    return jnp.asarray(X)


def ens_nmse(Xt, yt, Xv, yv, seed, k=5, nfeats=20, max_iter=500,
             max_cvrg=18, y_scaling="auto-normal"):
    models = [SCFGP(sparsity=20, nfeats=nfeats, seed=100 * seed + j,
                    extra_basis=linear_basis, y_scaling_method=y_scaling)
              for j in range(k)]
    fit_fast_batch(models, [(Xt, yt, Xv, yv)] * k, obj="SCORE", algo=ALGO,
                   max_iter=max_iter, cvrg_tol=1e-5, max_cvrg=max_cvrg)
    mus = [np.asarray(m.predict(Xv)[0]).reshape(-1) for m in models]
    mu = np.mean(mus, axis=0)
    return float(np.mean((mu - yv) ** 2) / np.var(yv))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()

    out = {}
    for seed in range(args.seeds):
        Xt, yt, Xv, yv, _ = load_boston(seed=seed)
        floor = surrogate_floor("boston_housing", Xv, yv)["NMSE"]

        def rec(name, **kw):
            r = ens_nmse(Xt, yt, Xv, yv, seed, **kw) / floor
            out.setdefault(name, []).append(r)
            print(f"  seed {seed} {name:11s} ratio {r:.3f}", flush=True)

        rec("ens5_m20", k=5)
        rec("ens8_m20", k=8)
        rec("ens8_m50", k=8, nfeats=50)
        rec("ens8_long", k=8, max_iter=1500, max_cvrg=40)
        rec("ens8_ynorm", k=8, y_scaling="normal")

    print(json.dumps({k: {"mean_ratio": float(np.mean(v)),
                          "ratios": [round(r, 3) for r in v]}
                      for k, v in out.items()}, indent=1))


if __name__ == "__main__":
    main()
