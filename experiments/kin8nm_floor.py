"""kin8nm floor-closing: the round-3 recipe that halves the committed gap.

Round 2 closed boston to exact-GP level but left kin8nm at ~9.7x its
surrogate floor under the reference protocol (m <= 212, 200-iter budget),
documented as "capacity-bound".  Round 3 re-measured that claim against an
exact ARD-RBF GP on the same split and found real headroom:

    exact GP (ntr=1000)            NMSE 0.1007   8.44x floor
    exact GP (ntr=2500)            NMSE 0.0598   5.01x floor
    SCFGP S=20 m=212 (500 it)      NMSE 0.0504   4.22x floor
    SCFGP S=20 m=512 (500 it)      NMSE 0.0415   3.48x floor
    SCFGP ensemble k=8 m=512       NMSE 0.0347   2.91x floor  (MNLP -1.35)

(CPU f32, seed 0; exact GP is O(ntr^3) so it is data-limited here — SCFGP
uses all 6553 rows.)  The committed sweep's 9.7x was a TRAINING-BUDGET
artifact, not RFF capacity: the same m=212 model at 500 iterations with
SCORE early-stopping already reaches 4.2x, m=512 beats the exact GP, and
the boston ensemble recipe (k restarts as one vmapped program, best-half
mixture) lands at 2.91x with MNLP -1.35 — beyond the reference's best
real-data kin8nm MNLP (-1.01).  The residual ~3x is shared with the exact
GP's trend and consistent with data-limited smoothing of the 8-D arm
surface at N=6553.

Writes results/kin8nm_floor/kin8nm_floor.json.
Usage: python experiments/kin8nm_floor.py [--cpu] [--skip-exact-gp]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-exact-gp", action="store_true")
    ap.add_argument("--nfeats", type=int, default=512)
    ap.add_argument("--k", type=int, default=8,
                    help="ensemble restarts (mix_best = k // 2)")
    ap.add_argument("--max-iter", type=int, default=800)
    ap.add_argument("--out", default="kin8nm_floor.json")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from scfgp import SCFGP
    from scfgp.data.datasets import load_kin8nm, surrogate_floor

    Xt, yt, Xv, yv, meta = load_kin8nm(seed=args.seed)
    fl = surrogate_floor("kin8nm", Xv, yv)
    rows = {"seed": args.seed, "source": meta["source"],
            "floor_nmse": round(fl["NMSE"], 4),
            "floor_mnlp": round(fl["MNLP"], 4)}

    def record(name, nmse, mnlp, secs):
        rows[name] = {"nmse": round(nmse, 4),
                      "over_floor": round(nmse / fl["NMSE"], 3),
                      "mnlp": round(mnlp, 4), "seconds": round(secs, 1)}
        print(json.dumps({name: rows[name]}), flush=True)

    if not args.skip_exact_gp:
        from scfgp.baselines import ExactGP
        for ntr in (1000, 2500):
            t0 = time.time()
            gp = ExactGP(steps=150).fit(Xt[:ntr], yt[:ntr])
            mu, std = gp.predict(Xv)
            nmse = float(np.mean((mu - yv) ** 2) / np.var(yv))
            mnlp = float(np.mean(0.5 * ((yv - mu) / std) ** 2
                                 + 0.5 * np.log(2 * np.pi * std ** 2)))
            record(f"exact_gp_ntr{ntr}", nmse, mnlp, time.time() - t0)

    mfeat = args.nfeats
    t0 = time.time()
    m1 = SCFGP(sparsity=20, nfeats=mfeat, seed=args.seed, dtype=jnp.float32)
    m1.fit_fast(Xt, yt, Xv, yv, obj="SCORE", max_iter=500, cvrg_tol=1e-5,
                max_cvrg=30)
    record(f"scfgp_m{mfeat}", m1.evals["NMSE"][1][m1.min_obj_ind],
           m1.evals["MNLP"][1][m1.min_obj_ind], time.time() - t0)

    t0 = time.time()
    m2 = SCFGP(sparsity=20, nfeats=mfeat, seed=args.seed, dtype=jnp.float32)
    m2.fit_ensemble(Xt, yt, Xv, yv, k=args.k, mix_best=args.k // 2,
                    obj="SCORE", max_iter=args.max_iter, cvrg_tol=1e-5,
                    max_cvrg=40)
    record(f"scfgp_ensemble_k{args.k}_m{mfeat}",
           m2.evals["NMSE"][1][m2.min_obj_ind],
           m2.evals["MNLP"][1][m2.min_obj_ind], time.time() - t0)

    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "results", "kin8nm_floor")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, args.out), "w") as f:
        json.dump(rows, f, indent=2)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
