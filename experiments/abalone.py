"""Abalone benchmark: feature-size sweep m = sqrt(N)*(i+1)/3.

Mirrors ``reference: experiments/abalone/abalone.py``: 30 trials, 10 feature
sizes scaling with sqrt(N) (lines 34-36), one-hot sex encoding (handled in
the loader), RMSE/MNLP tracking.

Usage: python experiments/abalone.py [--quick] [--trials N] [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--trials", type=int, default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from scfgp.data.datasets import load_abalone
    from scfgp.utils.experiment import run_sweep

    n_train = int(0.8 * 4177)
    # Reference sweep: feature_size = sqrt(N)*(i+1)/3, i=0..9 (abalone.py:36)
    all_sizes = [int(np.sqrt(n_train) * (i + 1) / 3) for i in range(10)]
    nfeats = all_sizes[:2] if args.quick else all_sizes
    trials = args.trials or (2 if args.quick else 30)
    opt_params = {
        "algo": {"algo": "adam",
                 "algo_params": {"learning_rate": 0.01, "beta1": 0.9,
                                 "beta2": 0.999, "epsilon": 1e-8}},
        "max_iter": 200,
        "cvrg_tol": 1e-5,
        "max_cvrg": 8,
        "obj": "SCORE",
    }
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", "abalone")
    # sparsity=-1 (full rank) matches the reference's legacy-API protocol
    # SCFGP(-1, feature_size) (abalone.py:58).
    summary = run_sweep("abalone", load_abalone, nfeats, sparsity=-1,
                        trials=trials, opt_params=opt_params, out_dir=out)
    print("RMSE means:", summary["metrics"]["RMSE"]["mean"])
    print("MNLP means:", summary["metrics"]["MNLP"]["mean"])


if __name__ == "__main__":
    main()
