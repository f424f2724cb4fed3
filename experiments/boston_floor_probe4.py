"""Probe 4: combine probe-3 winners on the boston floor.

  ens8_long_ynorm — 8 members, 1500 iters, y='normal'
  ens16_top8     — 16 members, mix only the best 8 by validation NMSE
  ens8_lr005     — 8 members, adam lr 0.005, 2000 iters

Usage: python experiments/boston_floor_probe4.py [--seeds K]
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


def algo(lr):
    return {"algo": "adam", "algo_params": {"learning_rate": lr,
            "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}}


def linear_basis(X):
    import jax.numpy as jnp
    return jnp.asarray(X)


def ens(Xt, yt, Xv, yv, seed, k=8, top=None, nfeats=20, max_iter=1500,
        max_cvrg=40, y_scaling="auto-normal", lr=0.01):
    models = [SCFGP(sparsity=20, nfeats=nfeats, seed=100 * seed + j,
                    extra_basis=linear_basis, y_scaling_method=y_scaling)
              for j in range(k)]
    fit_fast_batch(models, [(Xt, yt, Xv, yv)] * k, obj="SCORE",
                   algo=algo(lr), max_iter=max_iter, cvrg_tol=1e-5,
                   max_cvrg=max_cvrg)
    mus = [np.asarray(m.predict(Xv)[0]).reshape(-1) for m in models]
    if top:
        nm = [float(np.mean((mu - yv) ** 2)) for mu in mus]
        keep = np.argsort(nm)[:top]
        mus = [mus[i] for i in keep]
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
            r = ens(Xt, yt, Xv, yv, seed, **kw) / floor
            out.setdefault(name, []).append(r)
            print(f"  seed {seed} {name:16s} ratio {r:.3f}", flush=True)

        rec("ens8_long_ynorm", y_scaling="normal")
        rec("ens16_top8", k=16, top=8)
        rec("ens8_lr005", lr=0.005, max_iter=2000)

    print(json.dumps({k: {"mean_ratio": float(np.mean(v)),
                          "ratios": [round(r, 3) for r in v]}
                      for k, v in out.items()}, indent=1))


if __name__ == "__main__":
    main()
