"""Boston housing benchmark: sweep of Fourier feature counts.

Mirrors the reference experiment (``reference:
experiments/boston_housing/boston_housing.py``): nfeats in {10..50}, S=20,
adam lr 0.01, <=200 iters with tight convergence (lines 16,23,33-40), best
model kept by SCORE tournament, per-metric errorbar plots.

Usage: python experiments/boston_housing.py [--quick] [--trials N] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="2 trials x 2 sizes (smoke run)")
    ap.add_argument("--trials", type=int, default=None,
                    help="trials per feature size (reference: 50)")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--at-floor", action="store_true",
                    help="floor-closing protocol: fit_ensemble(k=16, "
                         "mix_best=8) with a linear extra basis per trial "
                         "(measured ~1.1x the Bayes floor, the exact-GP "
                         "level — docs/RESULTS.md); writes results/"
                         "boston_floor/")
    ap.add_argument("--batched", action="store_true",
                    help="train all trials of a feature size as one vmapped "
                         "program (fit_fast_batch)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from scfgp.data.datasets import load_boston
    from scfgp.utils.experiment import run_sweep

    trials = args.trials or (2 if args.quick else 50)
    nfeats = [10, 30] if args.quick else [10, 20, 30, 40, 50]
    opt_params = {
        # Reference optimizer (boston_housing.py:24-40) with patience
        # extended (max_iter 200->500, max_cvrg 8->18): measured mean
        # NMSE/floor improves 1.5x -> 1.3x on the surrogate (docs/RESULTS.md
        # floor table); iterations are ~free on the fused device loop.
        "algo": {"algo": "adam",
                 "algo_params": {"learning_rate": 0.01, "beta1": 0.9,
                                 "beta2": 0.999, "epsilon": 1e-8}},
        "max_iter": 500,
        "cvrg_tol": 1e-5,
        "max_cvrg": 18,
        "obj": "SCORE",
    }
    kw = {}
    name = "boston_housing"
    if args.at_floor:
        import jax.numpy as jnp

        def linear_basis(X):
            return jnp.asarray(X)

        name = "boston_floor"
        opt_params.update(max_iter=1500, max_cvrg=40)
        kw = dict(ensemble=16, mix_best=8, extra_basis=linear_basis)
    elif args.batched:
        kw = dict(batched=True)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", name)
    summary = run_sweep(name, load_boston, nfeats, sparsity=20,
                        trials=trials, opt_params=opt_params, out_dir=out,
                        **kw)
    print("NMSE means:", summary["metrics"]["NMSE"]["mean"])
    print("MNLP means:", summary["metrics"]["MNLP"]["mean"])
    print("data source:", summary["data_source"])


if __name__ == "__main__":
    main()
