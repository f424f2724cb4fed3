"""Cross-basin ESS campaign: deep tempering ladder vs many-chains HMC.

The open item segmented execution was built for (docs/TODO.md "still
open" #2; VERDICT r3 item 2): on the dim-1163 trig-multimodal SCFGP
posterior, no committed configuration achieves min-ESS >> #chains —
every 100-400-draw leg measures min-ESS-bulk ~ #chains (8), i.e. within-
basin draws are so autocorrelated across basins that each chain
contributes ~1 effective draw of cross-basin information.  This campaign
runs the prescribed experiment:

  tempered  rungs >= 24 (energy-matched to beta_min <= 0.3), draws >=
            2000, segment <= 50 (bounded executions), 8 chains;
  plain     many-chains HMC baseline (64 chains = 8x the basins) at
            EQUAL total device-seconds, draws sized from a measured
            calibration segment.

Verdict criterion: either some configuration posts min-ESS-bulk >>
#chains, or the negative is quantified ("replica exchange cannot beat
chain-mixing at any budget <= X device-seconds") and folded into
fit_bayes guidance.

Usage: python experiments/deep_ladder.py [--cpu] [--samples 2000]
       [--rungs 24] [--beta-min 0.3] [--segment 50] [--plain-chains 64]
Writes experiments/results/hmc/deep_ladder_campaign.json incrementally.
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
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--plain-chains", type=int, default=64)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--sparsity", type=int, default=20)
    ap.add_argument("--nfeats", type=int, default=50)
    ap.add_argument("--rungs", type=int, default=24)
    ap.add_argument("--beta-min", type=float, default=0.3)
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--segment", type=int, default=50)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scfgp.bayes import hmc_sample, make_logposterior
    from scfgp.bayes.diagnostics import diagnose
    from scfgp.bayes.predictive import reduced_dim
    from scfgp.bayes.tempering import (energy_matched_ladder,
                                       tempered_hmc_sample_segmented)
    from scfgp.data.datasets import synthetic_gp_rff
    from scfgp.models.params import init_params, pack_params

    D, S, M = 8, args.sparsity, args.nfeats
    X, y = synthetic_gp_rff(n=args.n, d=D, s=S, m=M, noise_std=0.1, seed=0,
                            dtype=np.float32)
    Xt, yt = jnp.asarray(X), jnp.asarray(y)
    logpost = make_logposterior(Xt, yt, D, S, M)
    P = reduced_dim(D, S, M)

    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "results", "hmc")
    os.makedirs(outdir, exist_ok=True)
    outpath = os.path.join(outdir, "deep_ladder_campaign.json")
    results = {"config": vars(args) | {"dim": P,
                                       "backend": jax.default_backend()},
               "legs": {}}
    if os.path.exists(outpath):
        try:
            with open(outpath) as f:
                prev = json.load(f)
            if prev.get("config", {}).get("dim") == P:
                results["legs"] = prev.get("legs", {})
                print(json.dumps({"resumed": list(results["legs"])}),
                      flush=True)
        except Exception:
            pass

    def save():
        with open(outpath, "w") as f:
            json.dump(results, f, indent=2)

    def score(draws, lds, ndiv, wall, extra):
        d = diagnose(draws, ndiv, logdensities=lds)
        leg = {"max_rhat": round(d.max_rhat, 4),
               "rhat_logdensity": round(d.rhat_logdensity, 4),
               "min_ess_bulk": round(d.min_ess_bulk, 1),
               "min_ess_tail": round(d.min_ess_tail, 1),
               "ess_logdensity": round(d.ess_bulk_logdensity, 1)
               if np.isfinite(d.ess_bulk_logdensity) else None,
               "min_ess_bulk_per_s": round(d.min_ess_bulk / wall, 3),
               "divergences": d.divergences, "wall_s": round(wall, 1),
               "chains": int(draws.shape[1]),
               "draws_per_chain": int(draws.shape[0])}
        leg.update(extra)
        return leg

    # -- shared warm positions (round-3 cache) ------------------------------
    warm_path = os.path.join(outdir, f"tempering_warm_{args.n}_{P}.npz")
    if os.path.exists(warm_path):
        warm_draws = np.load(warm_path)["warm_draws"]
        print(json.dumps({"pre_warmup": "cached"}), flush=True)
    else:
        keys = jax.random.split(jax.random.PRNGKey(0), args.chains)
        init8 = jnp.stack([pack_params(
            init_params(k, D, S, M, jnp.float32))[:P] for k in keys])
        pre = jax.jit(lambda q, k: hmc_sample(
            logpost, q, k, num_warmup=100, num_samples=16,
            num_integration_steps=16, init_step_size=0.003))
        r = pre(init8, jax.random.PRNGKey(1))
        warm_draws = np.asarray(r.samples)
        np.savez_compressed(warm_path, warm_draws=warm_draws)
    warm8 = jnp.asarray(warm_draws[-1][:args.chains])
    ladder_pos = jnp.asarray(warm_draws.reshape(-1, P))

    # -- leg 1: deep tempered ladder, segmented -----------------------------
    tag_t = f"tempered-{args.rungs}r-b{args.beta_min}-{args.samples}"
    if tag_t not in results["legs"]:
        betas = energy_matched_ladder(
            logpost, ladder_pos, beta_min=args.beta_min, target_gap=0.75,
            max_rungs=args.rungs)
        print(json.dumps({"rungs_planned": int(betas.shape[0]),
                          "betas_head": [round(float(b), 3)
                                         for b in betas[:4]]}), flush=True)
        t0 = time.time()
        r = tempered_hmc_sample_segmented(
            logpost, warm8, jax.random.PRNGKey(11), betas,
            num_warmup=args.warmup, num_samples=args.samples,
            segment=args.segment, num_integration_steps=16,
            init_step_size=0.003)
        wall = time.time() - t0  # segments end in device->host copies
        leg = score(np.asarray(r.samples), np.asarray(r.logdensities),
                    int(r.divergences), wall,
                    {"kind": "tempered", "rungs": int(betas.shape[0]),
                     "swap_rate": round(float(r.swap_rate), 4),
                     "accept_rate": round(float(r.accept_rate), 3),
                     "segment": args.segment,
                     "wall_incl_warmup_compile_s": round(wall, 1)})
        results["legs"][tag_t] = leg
        save()
        print(json.dumps({tag_t: leg}), flush=True)
        tempered_wall = wall
    else:
        tempered_wall = results["legs"][tag_t]["wall_s"]

    # -- leg 2: many-chains plain HMC at equal device-seconds ---------------
    # 64 random inits (8x the basin coverage), own warmup, then sampling
    # continuation chunks until the tempered leg's wall budget is spent.
    # Run twice: shared adaptation (the round-4 first pass, which
    # collapsed to 0.008 acceptance) and per-chain fleet adaptation
    # (shared_adaptation=False — the fix built from that failure).
    def plain_leg(tag_p, shared):
        keys = jax.random.split(jax.random.PRNGKey(5), args.plain_chains)
        init_many = jnp.stack([pack_params(
            init_params(k, D, S, M, jnp.float32))[:P] for k in keys])
        budget = tempered_wall
        t_start = time.time()
        warm_prog = jax.jit(lambda q, k: hmc_sample(
            logpost, q, k, num_warmup=args.warmup, num_samples=1,
            num_integration_steps=16, init_step_size=0.003,
            shared_adaptation=shared))
        r0 = warm_prog(init_many, jax.random.PRNGKey(12))
        np.asarray(r0.samples)
        q = r0.final_positions
        eps, im = r0.step_size, r0.inv_mass
        seg_draws = 200
        cont = jax.jit(lambda q_, k_, e_, im_: hmc_sample(
            logpost, q_, k_, num_warmup=0, num_samples=seg_draws,
            num_integration_steps=16, adapted=(e_, im_)))
        # calibration chunk (also counts toward the budget)
        t0 = time.time()
        r = cont(q, jax.random.PRNGKey(13), eps, im)
        chunks = [np.asarray(r.samples)]
        lds = [np.asarray(r.logdensities)]
        ndiv = int(r.divergences)
        q = r.final_positions
        rate_wall = time.time() - t0
        i = 14
        while time.time() - t_start + rate_wall * 0.9 < budget:
            r = cont(q, jax.random.PRNGKey(i), eps, im)
            chunks.append(np.asarray(r.samples))
            lds.append(np.asarray(r.logdensities))
            ndiv += int(r.divergences)
            q = r.final_positions
            i += 1
        wall = time.time() - t_start
        draws = np.concatenate(chunks)
        leg = score(draws, np.concatenate(lds), ndiv, wall,
                    {"kind": "plain-many-chains",
                     "shared_adaptation": shared,
                     "accept_rate": round(float(r.accept_rate), 3),
                     "budget_from": tag_t,
                     "budget_s": round(budget, 1)})
        results["legs"][tag_p] = leg
        save()
        print(json.dumps({tag_p: leg}), flush=True)

    tag_p = f"plain-{args.plain_chains}c-equal-time"
    if tag_p not in results["legs"]:
        plain_leg(tag_p, True)
    tag_f = f"plain-{args.plain_chains}c-fleet-equal-time"
    if tag_f not in results["legs"]:
        plain_leg(tag_f, False)

    # -- verdict line --------------------------------------------------------
    lt = results["legs"][tag_t]
    lp = results["legs"].get(tag_f, results["legs"][tag_p])
    verdict = {
        "criterion": "min_ess_bulk >> chains (8) for tempered",
        "tempered_min_ess_bulk": lt["min_ess_bulk"],
        "tempered_ess_ld": lt.get("ess_logdensity"),
        "plain_many_min_ess_bulk": lp["min_ess_bulk"],
        "plain_many_ess_ld": lp.get("ess_logdensity"),
        "winner_min_ess_per_s": (
            "tempered" if lt["min_ess_bulk_per_s"]
            > lp["min_ess_bulk_per_s"] else "plain-many-chains"),
    }
    results["verdict"] = verdict
    save()
    print(json.dumps({"verdict": verdict}), flush=True)


if __name__ == "__main__":
    main()
