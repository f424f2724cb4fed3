"""HMC/NUTS throughput benchmark: samples/s with vmapped chains.

BASELINE.md asks for HMC samples/s (new capability, no reference value).
Measures chain-parallel HMC and NUTS over the SCFGP posterior on the
kin8nm-scale config, whole sampler inside one jit.

Usage: python experiments/bench_hmc.py [--cpu] [--chains 8]
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
    ap.add_argument("--mode", choices=["fused", "host"], default=None,
                    help="fused = whole sampler in one jit (default); "
                         "host = jit one transition, adaptation on host")
    ap.add_argument("--skip-nuts", action="store_true")
    ap.add_argument("--mm-precision", default="global",
                    choices=["default", "highest", "global"],
                    help="posterior GEMM pass count. 'global' (the "
                         "default) leaves dots on the import-time global "
                         "(true f32) — the SHIPPED sampler arithmetic: "
                         "fit_bayes strips auto-reduced precision from "
                         "the sampling path because MH ratios "
                         "exponentiate N-scaled cost differences "
                         "(ops/dispatch.py).  'default' (1-pass) measures "
                         "the explicit-opt-in speed lever's throughput; "
                         "its quality cost is documented in "
                         "results/bayes_predictive (r05b note)")
    ap.add_argument("--legs", default=None,
                    help="comma-separated subset of legs to (re-)measure "
                         "(hmc,nuts,nuts_static,sgld_b256); results MERGE "
                         "into the existing bench_hmc.json so one leg can "
                         "be re-run after a code change (e.g. the dynamic "
                         "NUTS gradient-caching re-measure, VERDICT r3 "
                         "item 3)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scfgp.bayes import (hmc_sample, hmc_sample_host_looped,
                             nuts_sample, nuts_sample_host_looped,
                             nuts_sample_static, make_logposterior)
    from scfgp.bayes.predictive import reduced_dim
    from scfgp.data.datasets import synthetic_gp_rff
    from scfgp.models.params import init_params, pack_params

    D, S, M = 8, 20, 50
    X, y = synthetic_gp_rff(n=args.n, d=D, s=S, m=M, noise_std=0.1, seed=0,
                            dtype=np.float32)
    Xt, yt = jnp.asarray(X), jnp.asarray(y)
    mp = None if args.mm_precision == "global" else args.mm_precision
    logpost = make_logposterior(Xt, yt, D, S, M, mm_precision=mp)
    P = reduced_dim(D, S, M)
    keys = jax.random.split(jax.random.PRNGKey(0), args.chains)
    init = jnp.stack([pack_params(
        init_params(k, D, S, M, jnp.float32))[:P] for k in keys])

    # Fused is the default mode; --mode host jits one transition only (a
    # small program where compiling the fused sampler is too slow).
    mode = args.mode or "fused"
    benches = []
    if mode == "host":
        benches.append(("hmc", lambda q, k: hmc_sample_host_looped(
            logpost, q, k, num_warmup=args.warmup, num_samples=args.samples,
            num_integration_steps=16, init_step_size=0.003)))
    else:
        benches.append(("hmc", jax.jit(lambda q, k: hmc_sample(
            logpost, q, k, num_warmup=args.warmup, num_samples=args.samples,
            num_integration_steps=16, init_step_size=0.003))))
    if not args.skip_nuts and mode == "fused":
        # Dynamic-trajectory NUTS (doubly-nested while_loop) only fused.
        benches.append(("nuts", jax.jit(lambda q, k: nuts_sample(
            logpost, q, k, num_warmup=args.warmup, num_samples=args.samples,
            max_depth=6, init_step_size=0.003))))
    if not args.skip_nuts:
        # Fixed-budget NUTS modes (docs/TODO.md round-1 item 3): the
        # static fixed-budget multinomial sampler is one fused scan program
        # (same shape as fused HMC); the host-looped variant jits only one
        # transition.
        benches.append(("nuts_static", jax.jit(lambda q, k:
            nuts_sample_static(
                logpost, q, k, num_warmup=args.warmup,
                num_samples=args.samples, depth=5, init_step_size=0.003))))
        if mode == "host":
            benches.append(("nuts_host", lambda q, k:
                nuts_sample_host_looped(
                    logpost, q, k, num_warmup=args.warmup,
                    num_samples=args.samples, max_depth=6,
                    init_step_size=0.003)))

    # SGLD (bayes/sgld.py): the large-N O(batch)-per-step sampler, scored
    # by the same ESS/s yardstick.  10x the draws of HMC at ~1/8 the
    # per-step cost (B=256 of N=2048) — roughly the HMC wall budget.
    from scfgp.bayes import make_minibatch_value_and_grad, sgld_sample
    benches.append(("sgld_b256", jax.jit(lambda q, k: sgld_sample(
        make_minibatch_value_and_grad(Xt, yt, D, S, M, 256,
                                      mm_precision=mp), q, k,
        num_warmup=args.warmup * 10, num_samples=args.samples * 10,
        step_size=1e-5))))

    from scfgp.bayes.diagnostics import diagnose

    results = {}
    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "results", "hmc")
    outpath = os.path.join(outdir, "bench_hmc.json")
    if args.legs:
        wanted = {s.strip() for s in args.legs.split(",")}
        benches = [(n, r) for n, r in benches if n in wanted]
        if os.path.exists(outpath):
            with open(outpath) as f:
                results = json.load(f)
    for name, run in benches:
        t0 = time.time()
        res = run(init, jax.random.PRNGKey(1))
        # Reading a scalar back waits for the run.  SGLD has no MH accept.
        accept = float(getattr(res, "accept_rate", res.step_size))
        compile_and_run = time.time() - t0
        t0 = time.time()
        res = run(init, jax.random.PRNGKey(2))
        accept = float(getattr(res, "accept_rate", float("nan")))
        draws_np = np.asarray(res.samples)  # device->host copy ends the clock
        dt = time.time() - t0
        total_draws = draws_np.shape[0] * args.chains
        # ESS is the headline: raw draws/s rewards a non-mixing sampler
        # (VERDICT r2 item 2) — a stuck chain posts the same throughput.
        ndiv = getattr(res, "divergences", None)
        diag = diagnose(draws_np, None if ndiv is None else int(ndiv),
                        logdensities=np.asarray(res.logdensities))
        results[name] = {
            "rhat_logdensity": round(diag.rhat_logdensity, 4),
            "mode": mode,
            "samples_per_s": round(total_draws / dt, 2),
            "min_ess_bulk_per_s": round(diag.min_ess_bulk / dt, 2),
            "min_ess_bulk": round(diag.min_ess_bulk, 1),
            "min_ess_tail": round(diag.min_ess_tail, 1),
            "max_rhat": round(diag.max_rhat, 4),
            "divergences": diag.divergences,
            "accept_rate": (round(accept, 3) if np.isfinite(accept)
                            else None),
            "chains": args.chains,
            "dim": P,
            "mm_precision": args.mm_precision,
            "first_call_s": round(compile_and_run, 1),
        }
        print(json.dumps({name: results[name]}), flush=True)

    os.makedirs(outdir, exist_ok=True)
    with open(outpath, "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
