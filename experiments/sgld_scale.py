"""SGLD at BASELINE synthetic scale: large-N Bayes throughput on one chip.

The HMC/NUTS/tempered samplers evaluate the FULL-data gradient per leapfrog
step — exact, but O(N) per draw.  SGLD (bayes/sgld.py) is the large-N
member of the family: O(batch) per step.  This probe measures, on one GPU
at the BASELINE.md synthetic scale (N=1e6, D=256, 2(S+M)=512):

  * minibatch pSGLD draws/s at B in {4096, 16384} (per-step cost is one
    B-row gather + one B-row objective gradient);
  * full-batch streaming ULA draws/s (per-step cost = one streaming
    loss+grad step) as the unbiased anchor.

Writes experiments/results/hmc/sgld_scale.json.

Usage: python experiments/sgld_scale.py [--cpu] [--n 1000000]
       [--d 256] [--chains 4] [--samples 50]
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
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--sparsity", type=int, default=128)
    ap.add_argument("--nfeats", type=int, default=128)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--streaming-block", type=int, default=16384)
    ap.add_argument("--step-size", type=float, default=1e-6)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scfgp.bayes import make_minibatch_value_and_grad, sgld_sample
    from scfgp.bayes.predictive import reduced_dim
    from scfgp.models.params import init_params, pack_params

    D, S, M = args.d, args.sparsity, args.nfeats
    n, C = args.n, args.chains
    P = reduced_dim(D, S, M)
    # Synthetic rows generated on device (a 1 GB host->device transfer of
    # random data would dominate; the objective cost is data-independent).
    kx, ky = jax.random.split(jax.random.PRNGKey(0))
    X = jax.random.uniform(kx, (n, D), jnp.float32)
    y = jax.random.normal(ky, (n,), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), C)
    init = jnp.stack([pack_params(
        init_params(k, D, S, M, jnp.float32))[:P] for k in keys])
    out = {"n": n, "d": D, "dim": P, "chains": C,
           "samples": args.samples, "warmup": args.warmup,
           "backend": jax.default_backend(), "legs": []}
    print(json.dumps({"config": out}), flush=True)
    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "results", "hmc")
    os.makedirs(outdir, exist_ok=True)

    def leg(tag, batch_size, streaming_block):
        run = jax.jit(lambda q, k, X_, y_: sgld_sample(
            make_minibatch_value_and_grad(
                X_, y_, D, S, M, batch_size,
                streaming_block=streaming_block),
            q, k, num_warmup=args.warmup, num_samples=args.samples,
            step_size=args.step_size))
        t0 = time.time()
        r = run(init, jax.random.PRNGKey(2), X, y)
        bad = int(r.nonfinite)  # reading it back waits for compile+run
        first = time.time() - t0
        t0 = time.time()
        r = run(init, jax.random.PRNGKey(3), X, y)
        bad = int(r.nonfinite)
        dt = time.time() - t0
        ld = np.asarray(r.logdensities)
        row = {"leg": tag, "batch_size": batch_size,
               "streaming_block": streaming_block,
               "draws_per_s": round(args.samples * C / dt, 2),
               "steps_per_s": round((args.samples + args.warmup) / dt, 2),
               "nonfinite": bad,
               "logdensity_finite": bool(np.isfinite(ld).all()),
               "steady_run_s": round(dt, 1),
               "first_call_s": round(first, 1)}
        print(json.dumps(row), flush=True)
        out["legs"].append(row)
        with open(os.path.join(outdir, "sgld_scale.json"), "w") as f:
            json.dump(out, f, indent=2)

    leg("psgld-b4096", 4096, 0)
    leg("psgld-b16384", 16384, 0)
    leg("ula-streaming", 0, args.streaming_block)
    print(json.dumps({"done": True}), flush=True)


if __name__ == "__main__":
    main()
