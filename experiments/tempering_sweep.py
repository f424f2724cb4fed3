"""ESS/s-optimal tempered-HMC configuration sweep (TODO round-3 item 2).

Round 2 established that the energy-matched pooled-std ladder MIXES
(swap_rate 0.575-0.755) on the trig-multimodal SCFGP posterior where
plain HMC's chains sit in separate basins (R-hat ~ 6.8 at 100 draws,
docs/RESULTS.md sampling table).  What it did not establish is the
ESS/s-optimal configuration: rungs cost linearly per draw, so a coarser
ladder (larger target_gap -> fewer rungs) may buy more min-ESS per
second even at a lower swap rate, and a larger draw budget amortizes
warmup.  This sweep scores each config by min-bulk-ESS/s of the COLD
chain (rank-normalized split-R-hat + Geyer ESS, bayes/diagnostics.py)
against plain HMC at the same draw budgets.

Sweep (one process, compile-count bounded):
  tempered: (target_gap, samples) in {(0.75, 100), (1.5, 100)} then the
            ESS/s winner re-run at samples=400;
  plain:    samples in {100, 400}.

Writes experiments/results/hmc/tempering_sweep.json incrementally
(one JSON line per leg on stdout; final dict at the end).

Usage: python experiments/tempering_sweep.py [--cpu] [--chains 8]
       [--n 2048] [--sparsity 20] [--nfeats 50]
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
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--sparsity", type=int, default=20)
    ap.add_argument("--nfeats", type=int, default=50)
    ap.add_argument("--beta-min", type=float, default=0.6)
    ap.add_argument("--max-rungs", type=int, default=12,
                    help="ladder cap: the fused replica-exchange "
                         "program batches rungs x chains posterior "
                         "gradients per leapfrog step")
    ap.add_argument("--no-reuse-warm", action="store_true",
                    help="ignore any cached pre-warmup positions")
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--base-samples", type=int, default=100)
    ap.add_argument("--big-samples", type=int, default=400)
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
                                       tempered_hmc_sample)
    from scfgp.data.datasets import synthetic_gp_rff
    from scfgp.models.params import init_params, pack_params

    D, S, M = 8, args.sparsity, args.nfeats
    X, y = synthetic_gp_rff(n=args.n, d=D, s=S, m=M, noise_std=0.1, seed=0,
                            dtype=np.float32)
    Xt, yt = jnp.asarray(X), jnp.asarray(y)
    logpost = make_logposterior(Xt, yt, D, S, M)
    P = reduced_dim(D, S, M)
    keys = jax.random.split(jax.random.PRNGKey(0), args.chains)
    init = jnp.stack([pack_params(
        init_params(k, D, S, M, jnp.float32))[:P] for k in keys])
    print(json.dumps({"config": {"n": args.n, "dim": P,
                                 "chains": args.chains,
                                 "backend": jax.default_backend()}}),
          flush=True)

    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "results", "hmc")
    os.makedirs(outdir, exist_ok=True)
    outpath = os.path.join(outdir, "tempering_sweep.json")
    results = {"config": {"n": args.n, "dim": P, "chains": args.chains,
                          "warmup": args.warmup, "beta_min": args.beta_min,
                          "backend": jax.default_backend()},
               "legs": []}
    # Crash-resume: keep legs a previous (crashed) run already measured.
    if os.path.exists(outpath):
        try:
            with open(outpath) as f:
                prev = json.load(f)
            if prev.get("config", {}).get("dim") == P:
                results["legs"] = prev.get("legs", [])
                print(json.dumps({"resumed_legs":
                                  [l["leg"] for l in results["legs"]]}),
                      flush=True)
        except Exception:
            pass
    done_tags = {l["leg"] for l in results["legs"]}

    def save():
        with open(outpath, "w") as f:
            json.dump(results, f, indent=2)

    # Shared pre-warmup: reach the typical set once; ladder positions from
    # the pooled (cross-basin) energy scale, per the round-2 measurement.
    # Cached to disk: a crash mid-sweep would otherwise cost the warmup
    # again.
    warm_path = os.path.join(outdir, f"tempering_warm_{args.n}_{P}.npz")
    if os.path.exists(warm_path) and not args.no_reuse_warm:
        warm_draws = np.load(warm_path)["warm_draws"]
        print(json.dumps({"pre_warmup": "cached", "path": warm_path}),
              flush=True)
    else:
        pre = jax.jit(lambda q, k: hmc_sample(
            logpost, q, k, num_warmup=100, num_samples=16,
            num_integration_steps=16, init_step_size=0.003))
        t0 = time.time()
        res = pre(init, jax.random.PRNGKey(1))
        warm_draws = np.asarray(res.samples)        # (16, C, P)
        np.savez_compressed(warm_path, warm_draws=warm_draws)
        print(json.dumps({"pre_warmup_s": round(time.time() - t0, 1),
                          "accept": round(float(res.accept_rate), 3)}),
              flush=True)
    warm = jnp.asarray(warm_draws[-1])
    ladder_pos = jnp.asarray(warm_draws.reshape(-1, P))

    def run_tempered(gap, samples, tag):
        if tag in done_tags:
            leg = next(l for l in results["legs"] if l["leg"] == tag)
            print(json.dumps({"skipped_cached": tag}), flush=True)
            return leg
        betas = energy_matched_ladder(
            logpost, ladder_pos, beta_min=args.beta_min,
            target_gap=gap, max_rungs=args.max_rungs)
        print(json.dumps({"leg": tag, "rungs_planned": int(betas.shape[0]),
                          "beta_last": round(float(betas[-1]), 4)}),
              flush=True)
        # Segmented beyond 100 draws: bounded executions
        # (tempering.tempered_hmc_sample_segmented).
        from scfgp.bayes.tempering import tempered_hmc_sample_segmented
        if samples > 100:
            def run(q, k):
                return tempered_hmc_sample_segmented(
                    logpost, q, k, betas, num_warmup=args.warmup,
                    num_samples=samples, segment=100,
                    num_integration_steps=16, init_step_size=0.003)
        else:
            run = jax.jit(lambda q, k: tempered_hmc_sample(
                logpost, q, k, betas=betas, num_warmup=args.warmup,
                num_samples=samples, num_integration_steps=16,
                init_step_size=0.003))
        t0 = time.time()
        r = run(warm, jax.random.PRNGKey(2))
        float(r.swap_rate)                          # compile+run
        first = time.time() - t0
        t0 = time.time()
        r = run(warm, jax.random.PRNGKey(3))
        swap = float(r.swap_rate)
        dt = time.time() - t0
        d = diagnose(np.asarray(r.samples),
                     int(getattr(r, "divergences", -1)),
                     logdensities=np.asarray(r.logdensities))
        leg = {"leg": tag, "kind": "tempered", "target_gap": gap,
               "rhat_logdensity": round(d.rhat_logdensity, 4),
               "rungs": int(betas.shape[0]), "samples": samples,
               "swap_rate": round(swap, 4),
               "accept_rate": round(float(r.accept_rate), 3),
               "cold_draws_per_s": round(samples * args.chains / dt, 2),
               "max_rhat": round(d.max_rhat, 4),
               "min_ess_bulk": round(d.min_ess_bulk, 1),
               "min_ess_tail": round(d.min_ess_tail, 1),
               "min_ess_bulk_per_s": round(d.min_ess_bulk / dt, 3),
               "divergences": d.divergences,
               "steady_run_s": round(dt, 1),
               "first_call_s": round(first, 1)}
        print(json.dumps(leg), flush=True)
        results["legs"].append(leg)
        save()
        return leg

    def run_plain(samples, tag):
        if tag in done_tags:
            leg = next(l for l in results["legs"] if l["leg"] == tag)
            print(json.dumps({"skipped_cached": tag}), flush=True)
            return leg
        run = jax.jit(lambda q, k: hmc_sample(
            logpost, q, k, num_warmup=args.warmup, num_samples=samples,
            num_integration_steps=16, init_step_size=0.003))
        t0 = time.time()
        r = run(warm, jax.random.PRNGKey(2))
        float(r.accept_rate)
        first = time.time() - t0
        t0 = time.time()
        r = run(warm, jax.random.PRNGKey(3))
        acc = float(r.accept_rate)
        dt = time.time() - t0
        d = diagnose(np.asarray(r.samples),
                     int(getattr(r, "divergences", -1)),
                     logdensities=np.asarray(r.logdensities))
        leg = {"leg": tag, "kind": "plain", "samples": samples,
               "rhat_logdensity": round(d.rhat_logdensity, 4),
               "draws_per_s": round(samples * args.chains / dt, 2),
               "accept_rate": round(acc, 3),
               "max_rhat": round(d.max_rhat, 4),
               "min_ess_bulk": round(d.min_ess_bulk, 1),
               "min_ess_tail": round(d.min_ess_tail, 1),
               "min_ess_bulk_per_s": round(d.min_ess_bulk / dt, 3),
               "divergences": d.divergences,
               "steady_run_s": round(dt, 1),
               "first_call_s": round(first, 1)}
        print(json.dumps(leg), flush=True)
        results["legs"].append(leg)
        save()
        return leg

    ns = args.base_samples
    run_plain(ns, f"plain-{ns}")
    a = run_tempered(0.75, ns, f"tempered-g0.75-{ns}")
    b = run_tempered(1.5, ns, f"tempered-g1.5-{ns}")
    winner_gap = 0.75 if a["min_ess_bulk_per_s"] >= b["min_ess_bulk_per_s"] \
        else 1.5
    run_plain(args.big_samples, f"plain-{args.big_samples}")
    run_tempered(winner_gap, args.big_samples,
                 f"tempered-g{winner_gap}-{args.big_samples}")
    results["winner_gap_at_100"] = winner_gap
    save()
    print(json.dumps({"done": True, "out": outpath}), flush=True)


if __name__ == "__main__":
    main()


