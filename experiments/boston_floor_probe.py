"""Probe: which training/model variants close the boston surrogate gap?

Round-1 VERDICT item 1 + round-2 TODO item 4: SCFGP plateaus at ~1.3x the
measured Bayes floor on the boston surrogate while an exact ARD-RBF GP
reaches ~1.0x.  This script A/B-tests candidate fixes on the same splits:

  base       — the shipped experiment config (S=20, m=20, adam, 500 iters)
  long       — more patience (2000 iters, max_cvrg 60)
  restarts   — best-of-5 random restarts by validation SCORE
  linear     — extra_basis appending the scaled inputs as fixed linear
               columns (composite model, same machinery as CO2's trend basis)
  linear+rs  — linear basis + restarts

Usage: python experiments/boston_floor_probe.py [--seeds K]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")

from scfgp import SCFGP
from scfgp.data.datasets import load_boston, surrogate_floor

ALGO = {"algo": "adam",
        "algo_params": {"learning_rate": 0.01, "beta1": 0.9,
                        "beta2": 0.999, "epsilon": 1e-8}}


def linear_basis(X):
    import jax.numpy as jnp
    return jnp.asarray(X)


def fit_one(Xt, yt, Xv, yv, seed, max_iter=500, max_cvrg=18, basis=None,
            nfeats=20):
    m = SCFGP(sparsity=20, nfeats=nfeats, seed=seed, extra_basis=basis)
    m.fit_fast(Xt, yt, Xv, yv, obj="SCORE", algo=ALGO, max_iter=max_iter,
               cvrg_tol=1e-5, max_cvrg=max_cvrg)
    nmse = float(m.evals["NMSE"][1][m.min_obj_ind])
    score = float(m.evals["SCORE"][1][m.min_obj_ind])
    return nmse, score


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()

    variants = {}
    for seed in range(args.seeds):
        Xt, yt, Xv, yv, meta = load_boston(seed=seed)
        floor = surrogate_floor("boston_housing", Xv, yv)["NMSE"]

        def rec(name, nmse):
            variants.setdefault(name, []).append(nmse / floor)
            print(f"  seed {seed} {name:10s} NMSE {nmse:.4f} "
                  f"ratio {nmse / floor:.3f}", flush=True)

        rec("base", fit_one(Xt, yt, Xv, yv, seed)[0])
        rec("long", fit_one(Xt, yt, Xv, yv, seed, max_iter=2000,
                            max_cvrg=60)[0])
        best = min(fit_one(Xt, yt, Xv, yv, 100 * seed + k)
                   for k in range(5))
        rec("restarts", best[0])
        rec("linear", fit_one(Xt, yt, Xv, yv, seed, basis=linear_basis)[0])
        bestl = min(fit_one(Xt, yt, Xv, yv, 100 * seed + k,
                            basis=linear_basis) for k in range(5))
        rec("linear+rs", bestl[0])

    print(json.dumps({k: {"mean_ratio": float(np.mean(v)),
                          "ratios": [round(r, 3) for r in v]}
                      for k, v in variants.items()}, indent=1))


if __name__ == "__main__":
    main()
