"""Weak-scaling benchmark: NLML-grad evals/s vs device count on sharded data.

The BASELINE.json multi-host config (N=1e6, D=256) scaled down as needed:
rows of X are sharded over a 1-D `data` mesh, sufficient statistics are
all-reduced, and we measure fused train-step throughput at 1, 2, 4, ... all
devices, reporting weak-scaling efficiency (constant rows PER device).

On several GPUs (one process owning a host's four, or several processes
after ``scfgp.parallel.init_distributed``) this script runs unchanged (the
mesh picks up all global devices); on the virtual CPU mesh
(``--cpu-devices 8``) it demonstrates the collective path only.

Usage:
  python experiments/synthetic_scaling.py --cpu-devices 8 --rows-per-device 8192
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="simulate N CPU devices (0 = use default backend)")
    ap.add_argument("--rows-per-device", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--sparsity", type=int, default=50)
    ap.add_argument("--nfeats", type=int, default=200)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()

    if args.cpu_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_devices}"
        ).strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scfgp.models.params import init_params
    from scfgp.opt.optimizers import make_optimizer
    from scfgp.parallel.mesh import make_mesh, shard_rows
    from scfgp.parallel.dp import make_dp_train_step

    all_devices = jax.devices()
    D, S, M = args.dim, args.sparsity, args.nfeats
    tx = make_optimizer("adam", {"learning_rate": 0.01})
    report = {"config": vars(args), "points": []}
    base_rate = None

    n_dev_list = []
    nd = 1
    while nd <= len(all_devices):
        n_dev_list.append(nd)
        nd *= 2

    for n_dev in n_dev_list:
        mesh = make_mesh(all_devices[:n_dev])
        N = args.rows_per_device * n_dev  # weak scaling: rows/device const
        rng = np.random.RandomState(0)
        X = rng.rand(N, D).astype(np.float32)
        y = rng.randn(N).astype(np.float32)
        params = init_params(jax.random.PRNGKey(0), D, S, M, jnp.float32)
        opt_state = tx.init(params)
        Xs, ys, ws = shard_rows(mesh, X, y)
        step = make_dp_train_step(tx, mesh, mode="gspmd")
        # warmup/compile
        p, st, cost, post = step(params, opt_state, Xs, ys, ws)
        jax.block_until_ready(cost)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            p, st, cost, post = step(p, st, Xs, ys, ws)
        jax.block_until_ready(cost)
        dt = time.perf_counter() - t0
        rate = args.steps / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / base_rate
        point = {"devices": n_dev, "rows_total": N,
                 "steps_per_s": round(rate, 3),
                 "weak_scaling_efficiency": round(eff, 3)}
        report["points"].append(point)
        print(json.dumps(point), flush=True)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", "scaling")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "weak_scaling.json"), "w") as f:
        json.dump(report, f, indent=2)
    print("wrote", os.path.join(out, "weak_scaling.json"))


if __name__ == "__main__":
    main()
