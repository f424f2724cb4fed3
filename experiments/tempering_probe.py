"""Tempered HMC on one accelerator with an energy-matched ladder.

docs/TODO.md open item 4: the coarse 4-rung geometric ladder measured
swap_rate = 0 at N=2048 (std(E) ~ 45 makes adjacent-rung energy gaps of
O(10+) units — e^-10 swaps never fire).  ``energy_matched_ladder``
(bayes/tempering.py) spaces rungs by the MEASURED std of the untempered
log posterior so the expected swap exponent is ~target_gap.

Protocol:
  1. short plain fused HMC (warmup only) to reach the typical set;
  2. ladder from std(E) over the post-warmup chain positions;
  3. fused replica-exchange run: report rungs, swap_rate, accept_rate,
     cold-rung draws/s.

Usage: python experiments/tempering_probe.py [--cpu] [--chains 8]
       [--n 2048] [--samples 100] [--warmup 100] [--target-gap 1.5]
Writes experiments/results/hmc/tempering_probe.json.
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
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--pre-warmup", type=int, default=100,
                    help="plain-HMC warmup used only to measure std(E)")
    ap.add_argument("--target-gap", type=float, default=1.5)
    ap.add_argument("--beta-min", type=float, default=0.2)
    ap.add_argument("--max-rungs", type=int, default=48)
    ap.add_argument("--sparsity", type=int, default=20,
                    help="S (smaller -> cheaper posterior for CPU runs)")
    ap.add_argument("--nfeats", type=int, default=50)
    ap.add_argument("--ladder-source", choices=["within", "pooled"],
                    default="pooled",
                    help="energy scale for rung spacing: within-chain std "
                         "(unimodal fluctuation) or pooled std (includes "
                         "the cross-basin offsets that dominate swap "
                         "exponents on this trig-multimodal posterior)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scfgp.bayes import hmc_sample, make_logposterior
    from scfgp.bayes.tempering import (energy_matched_ladder,
                                       tempered_hmc_sample)
    from scfgp.bayes.predictive import reduced_dim
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

    # 1. plain-HMC warmup to the typical set (same fused program family as
    #    bench_hmc — known to compile on the remote service)
    pre = jax.jit(lambda q, k: hmc_sample(
        logpost, q, k, num_warmup=args.pre_warmup, num_samples=16,
        num_integration_steps=16, init_step_size=0.003))
    t0 = time.time()
    res = pre(init, jax.random.PRNGKey(1))
    warm_draws = np.asarray(res.samples)    # (16, C, P)
    warm = warm_draws[-1]                   # (C, P) tempered-run inits
    print(json.dumps({"pre_warmup_s": round(time.time() - t0, 1),
                      "accept": round(float(res.accept_rate), 3)}),
          flush=True)

    # 2. ladder from the measured WITHIN-CHAIN energy scale (the pooled
    # std is inflated by O(100) cross-basin energy offsets and forces
    # uselessly many rungs — see energy_matched_ladder docstring)
    ladder_pos = (jnp.asarray(warm_draws) if args.ladder_source == "within"
                  else jnp.asarray(warm_draws.reshape(-1, warm.shape[-1])))
    betas = energy_matched_ladder(
        logpost, ladder_pos, beta_min=args.beta_min,
        target_gap=args.target_gap, max_rungs=args.max_rungs)
    lds = np.asarray(jax.vmap(logpost)(
        jnp.asarray(warm_draws.reshape(-1, P))), np.float64).reshape(16, -1)
    print(json.dumps({"std_E_within": round(float(
                          np.median(np.std(lds, axis=0))), 2),
                      "std_E_pooled": round(float(np.std(lds)), 2),
                      "rungs": int(betas.shape[0]),
                      "dbeta": round(float(betas[0] - betas[1]), 5)}),
          flush=True)

    # 3. fused tempered run
    run = jax.jit(lambda q, k: tempered_hmc_sample(
        logpost, q, k, betas=betas, num_warmup=args.warmup,
        num_samples=args.samples, num_integration_steps=16,
        init_step_size=0.003))
    t0 = time.time()
    res = run(jnp.asarray(warm), jax.random.PRNGKey(2))
    first = time.time() - t0
    swap = float(res.swap_rate)  # reading it back ends the clock
    t_compile_and_run = time.time() - t0
    t0 = time.time()
    res = run(jnp.asarray(warm), jax.random.PRNGKey(3))
    swap = float(res.swap_rate)
    accept = float(res.accept_rate)
    dt = time.time() - t0
    out = {
        "rungs": int(betas.shape[0]),
        "chains": args.chains,
        "dim": P,
        "n": args.n,
        "std_E_within": round(float(np.median(np.std(lds, axis=0))), 2),
        "std_E_pooled": round(float(np.std(lds)), 2),
        "target_gap": args.target_gap,
        "swap_rate": round(swap, 4),
        "accept_rate": round(accept, 3),
        "cold_draws_per_s": round(args.samples * args.chains / dt, 2),
        "steady_run_s": round(dt, 1),
        "first_call_s": round(t_compile_and_run, 1),
        "backend": jax.default_backend(),
    }
    # Convergence scoring (round 3): does replica exchange buy ESS/R-hat
    # on the trig-multimodal posterior, per second, vs plain HMC at the
    # same draw budget?  (bench_hmc measured plain-HMC R-hat ~ 6.8 at 100
    # draws — chains stuck in separate basins.)
    from scfgp.bayes.diagnostics import diagnose
    d_t = diagnose(np.asarray(res.samples),
                   int(getattr(res, "divergences", -1)))
    out.update(max_rhat=round(d_t.max_rhat, 4),
               min_ess_bulk=round(d_t.min_ess_bulk, 1),
               min_ess_bulk_per_s=round(d_t.min_ess_bulk / dt, 3),
               divergences=d_t.divergences)
    print(json.dumps({"tempered": out}), flush=True)

    plain = jax.jit(lambda q, k: hmc_sample(
        logpost, q, k, num_warmup=args.warmup, num_samples=args.samples,
        num_integration_steps=16, init_step_size=0.003))
    r0 = plain(jnp.asarray(warm), jax.random.PRNGKey(2))
    float(r0.accept_rate)  # compile + run
    t0 = time.time()
    r0 = plain(jnp.asarray(warm), jax.random.PRNGKey(3))
    d_p = diagnose(np.asarray(r0.samples),
                   int(getattr(r0, "divergences", -1)))
    dt_p = time.time() - t0
    plain_out = {
        "draws_per_s": round(args.samples * args.chains / dt_p, 2),
        "max_rhat": round(d_p.max_rhat, 4),
        "min_ess_bulk": round(d_p.min_ess_bulk, 1),
        "min_ess_bulk_per_s": round(d_p.min_ess_bulk / dt_p, 3),
        "divergences": d_p.divergences,
        "accept_rate": round(float(r0.accept_rate), 3),
    }
    print(json.dumps({"plain_hmc_same_budget": plain_out}), flush=True)
    out["plain_hmc_same_budget"] = plain_out

    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "results", "hmc")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "tempering_probe.json"), "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
