"""kin8nm benchmark: robot-arm forward kinematics regression.

Mirrors ``reference: experiments/kin8nm/kin8nm.py``: 50 trials, 10 feature
sizes scaling with sqrt(N) (lines 29-31).

Usage: python experiments/kin8nm.py [--quick] [--trials N] [--cpu]
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
    ap.add_argument("--sparsity", type=int, default=-1,
                    help="-1 = reference full-rank protocol (kin8nm.py:53);"
                         " 20 measured stronger on the surrogate"
                         " (docs/RESULTS.md); writes results/kin8nm_s<S>")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from scfgp.data.datasets import load_kin8nm
    from scfgp.utils.experiment import run_sweep

    n_train = int(0.8 * 8192)
    all_sizes = [int(np.sqrt(n_train) * (i + 1) / 3) for i in range(10)]
    nfeats = all_sizes[:2] if args.quick else all_sizes
    trials = args.trials or (2 if args.quick else 50)
    opt_params = {
        "algo": {"algo": "adam",
                 "algo_params": {"learning_rate": 0.01, "beta1": 0.9,
                                 "beta2": 0.999, "epsilon": 1e-8}},
        "max_iter": 200,
        "cvrg_tol": 1e-5,
        "max_cvrg": 8,
        "obj": "SCORE",
    }
    sub = "kin8nm" if args.sparsity == -1 else f"kin8nm_s{args.sparsity}"
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", sub)
    # sparsity=-1 (full rank) matches the reference's legacy-API protocol
    # SCFGP(-1, feature_size) (kin8nm.py:53).
    summary = run_sweep("kin8nm", load_kin8nm, nfeats,
                        sparsity=args.sparsity,
                        trials=trials, opt_params=opt_params, out_dir=out)
    print("RMSE means:", summary["metrics"]["RMSE"]["mean"])
    print("MNLP means:", summary["metrics"]["MNLP"]["mean"])


if __name__ == "__main__":
    main()
