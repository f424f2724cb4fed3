"""CO2 1-D regression demo with posterior-band visualization.

Mirrors ``reference: experiments/co2/CO2_1d_regression.py``: S=100, m=50,
adamax lr 0.05 beta1 0.8, obj='cost', max_iter 1000 (lines 14-35), with the
live matplotlib animation replaced by offline posterior-band rendering.

Usage: python experiments/co2.py [--quick] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from scfgp import SCFGP, Visualizer
    from scfgp.data.datasets import load_co2

    Xt, yt, Xv, yv, meta = load_co2(seed=0)
    sparsity, nfeats = (20, 20) if args.quick else (100, 50)
    max_iter = 150 if args.quick else 1000
    model = SCFGP(sparsity=sparsity, nfeats=nfeats, seed=0, verbose=True)
    # record_every frames -> training GIF, the reference's committed
    # experiments/plot_training.gif artifact (live loop Visualizer.py:27-49)
    viz = Visualizer(record_every=max(1, max_iter // 40))
    model.set_data(Xt, yt)
    model.optimize(Xv, yv, visualizer=viz,
                   obj="cost",
                   algo={"algo": "adamax",
                         "algo_params": {"learning_rate": 0.05, "beta1": 0.8,
                                         "beta2": 0.999, "epsilon": 1e-8}},
                   nbatches=1, cvrg_tol=1e-5, max_cvrg=8, max_iter=max_iter)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", "co2")
    os.makedirs(out, exist_ok=True)
    viz.model = model
    viz.save(os.path.join(out, "posterior_bands.png"))
    if viz.frames:
        viz.save_animation(os.path.join(out, "plot_training.gif"))
    model.save(os.path.join(out, "co2_model.pkl"))
    print("NMSE:", model.evals["NMSE"][1][model.min_obj_ind])
    print("MNLP:", model.evals["MNLP"][1][model.min_obj_ind])
    print("plot:", os.path.join(out, "posterior_bands.png"))

    # Composite config: known-annual-period seasonal + quadratic-trend
    # columns (extra_basis) with linear y scaling — measured AT the
    # surrogate Bayes floor (NMSE/floor = 1.00, docs/RESULTS.md).  Plain
    # RFF training plateaus 65x above it: the seasonal frequency (~44
    # cycles over the domain) is a spectral mode gradient descent cannot
    # reach from scratch, the textbook case for composite features
    # (BASELINE config 4).
    import json
    import jax.numpy as jnp
    import numpy as np
    from scfgp.data.datasets import surrogate_floor

    omega = 2 * np.pi * (Xt.shape[0] + Xv.shape[0] - 1) / 12.0

    def seasonal_trend(Xs):
        t = Xs[:, :1]
        return jnp.concatenate(
            [jnp.ones_like(t), t, t * t,
             jnp.sin(omega * t), jnp.cos(omega * t),
             jnp.sin(2 * omega * t), jnp.cos(2 * omega * t)], axis=1)

    comp = SCFGP(sparsity=10, nfeats=20, seed=0,
                 X_scaling_method="min-max", y_scaling_method="normal",
                 extra_basis=seasonal_trend)
    comp.fit_fast(Xt, yt, Xv, yv, obj="cost", max_iter=max_iter,
                  algo={"algo": "adamax",
                        "algo_params": {"learning_rate": 0.05, "beta1": 0.8,
                                        "beta2": 0.999, "epsilon": 1e-8}},
                  max_cvrg=60)
    nmse_c = comp.evals["NMSE"][1][comp.min_obj_ind]
    rec = {"composite_nmse": float(nmse_c)}
    if meta["source"] == "synthetic-surrogate":
        fl = surrogate_floor("co2", Xv, yv)
        rec["floor_nmse"] = fl["NMSE"]
        rec["nmse_over_floor"] = float(nmse_c / fl["NMSE"])
    with open(os.path.join(out, "composite.json"), "w") as f:
        json.dump(rec, f, indent=2)
    print("composite:", rec)


if __name__ == "__main__":
    main()
