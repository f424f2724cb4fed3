"""kin8nm Bayes flagship extension: more chains (the measured currency).

The round-4 predictive campaign measured tempered fit_bayes (8 chains)
at NMSE 0.0280 +/- 0.0018 — the best committed kin8nm result at any
budget — and the deep-ladder campaign established that chains are the
cross-basin ESS currency.  This probe asks the natural follow-ups on the
seed-0 split:

  tempered16   the campaign's tempered arm with 16 chains (2x basins);
  hmc-fleet32  32 RANDOM-init chains with per-chain adaptation
               (shared_adaptation=False — the fleet mode built from the
               deep-ladder failure), no tempering: is brute basin
               coverage + per-chain health enough?

Usage: python experiments/kin8nm_bayes_probe.py [--cpu] [--quick]
           [--dataset kin8nm|boston] [--skip-tempered]
Writes experiments/results/bayes_predictive/<dataset>_probe.json.
``--dataset boston`` asks the fleet question on the campaign's negative
(ensemble 0.372 beat every Bayes arm there): does brute basin coverage
with per-chain health change the verdict?
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--dataset", default="kin8nm",
                    choices=["kin8nm", "boston"])
    ap.add_argument("--skip-tempered", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from scfgp import SCFGP
    from scfgp.data.datasets import (load_boston, load_kin8nm,
                                     surrogate_floor)
    from scfgp.utils.metrics import regression_metrics

    loader = {"kin8nm": load_kin8nm, "boston": load_boston}[args.dataset]
    Xt, yt, Xv, yv, meta = loader(seed=0)
    ys = np.asarray(yv).reshape(-1, 1)
    floor = (surrogate_floor(meta["name"], Xv, yv)["NMSE"]
             if meta["source"] == "synthetic-surrogate" else None)
    S, M = 20, 50
    w, n = (30, 30) if args.quick else (100, 200)
    wh, nh = (30, 30) if args.quick else (300, 300)

    out = {"seed": 0, "source": meta["source"], "floor_nmse": floor,
           "campaign_ref": {"tempered8_nmse": 0.0259,
                            "tempered8_mnlp": -1.623,
                            "note": "seed-0 row of results.json"},
           "arms": {}}
    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "results", "bayes_predictive")
    os.makedirs(outdir, exist_ok=True)
    outpath = os.path.join(outdir, f"{args.dataset}_probe.json")

    def run(tag, **kw):
        import warnings
        m = SCFGP(sparsity=S, nfeats=M, seed=0)
        t0 = time.time()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m.fit_bayes(Xt, yt, **kw)
        wall = time.time() - t0
        mu, std = m.predict_bayes(Xv)
        r = regression_metrics(mu, std, ys)
        d = m.bayes_diagnostics
        rec = {"NMSE": r["NMSE"], "MNLP": r["MNLP"],
               "nmse_over_floor": (r["NMSE"] / floor if floor else None),
               "wall_s": round(wall, 1), "max_rhat": float(d.max_rhat),
               "rhat_logdensity": float(d.rhat_logdensity),
               "min_ess_bulk": float(d.min_ess_bulk),
               "divergences": int(d.divergences or 0),
               "accept": float(getattr(m.bayes_result, "accept_rate",
                                       float("nan"))),
               "config": {k: (v if isinstance(v, (int, float, str, bool))
                              else str(v)) for k, v in kw.items()}}
        out["arms"][tag] = rec
        with open(outpath, "w") as f:
            json.dump(out, f, indent=2)
        print(json.dumps({tag: rec}), flush=True)

    # segment=25: at 12 rungs x 16 chains (192-wide) under honest f32 a
    # step costs ~1.3 s — 50-step chunks sat at the ~100 s worker-kill
    # edge and a fused warmup+segment program crossed it (worker crash,
    # round 4); 25-step chunks + chunked warmup stay well under.
    if not args.skip_tempered:
        run("tempered16", sampler="tempered", chains=16, num_warmup=w,
            num_samples=n, num_integration_steps=16, init_step_size=0.003,
            max_rungs=12, segment=25)
    run("hmc_fleet32", sampler="hmc", chains=32, num_warmup=wh,
        num_samples=nh, num_integration_steps=16, init_step_size=0.003,
        shared_adaptation=False)
    print("wrote", outpath)


if __name__ == "__main__":
    main()
