"""Per-benchmark matmul-PRECISION quality matrix + co2 composite root-cause.

Certification for the quality-gated precision dispatch: the shipped
default runs the objective's two O(N K^2) GEMMs at 'default' precision
(TF32 on an H100) for non-composite fits.  This script measures the
claim that 'default' is quality-neutral on the benchmarks CONTROLLED —
same seeds, same splits, only the precision leg
differs — and attacks the composite failure's root cause:

  1. quality matrix: boston / abalone / kin8nm fits under
     mm_precision in {'highest' (r04 shipped), 'default' (r05 shipped)},
     T trials each, NMSE/MNLP deltas;
  2. co2 composite: {highest, default} x {raw basis, orthonormalized
     basis} — the round-4 hypothesis is that the near-collinear
     [1, t, t^2, sin, cos, sin2, cos2] block (experiments/co2.py) breaks
     the Gram conditioning under reduced-precision rounding, and
     QR-orthonormalizing
     the block on the train split fixes it;
  3. speed: bench-cell evals/s under per-dot dispatch vs global contexts —
     verifies the per-dot 'default' recovers the global-default rate.

Writes experiments/results/precision_quality.json.

Usage: python experiments/precision_quality.py [--cpu] [--trials N]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_speed_legs():
    """Bench-cell (N=8192, 2K=500) step rate: per-dot dispatch vs global."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scfgp.models.objective import loss_fn
    from scfgp.models.params import init_params
    from scfgp.opt.optimizers import make_optimizer, tree_add

    N, D, S, M, STEPS = 8192, 8, 50, 200, 50
    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.rand(N, D), jnp.float32)
    y = jnp.asarray(np.sin(rng.rand(N) * 6) + 0.1 * rng.randn(N),
                    jnp.float32)
    params = init_params(jax.random.PRNGKey(0), D, S, M, jnp.float32)
    tx = make_optimizer("adam", {"learning_rate": 0.01})
    st0 = tx.init(params)

    def make_run(mm_precision):
        vg = jax.value_and_grad(
            lambda p, X_, y_: loss_fn(p, X_, y_,
                                      mm_precision=mm_precision)[0])

        def one(carry, _):
            p, st = carry
            c, g = vg(p, X, y)
            d, st = tx.update(g, st, p)
            return (tree_add(p, d), st), c

        @jax.jit
        def run(p, st):
            (p, st), cs = jax.lax.scan(one, (p, st), None, length=STEPS)
            return p, st, cs[-1]
        return run

    def rate(run):
        p, st, c = run(params, st0)
        jax.block_until_ready(c)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            p, st, c = run(p, st)
            float(c)
            rates.append(STEPS / (time.perf_counter() - t0))
        rates.sort()
        return rates[1]

    out = {}
    out["perdot_default"] = rate(make_run("default"))
    out["perdot_highest"] = rate(make_run("highest"))
    try:
        import jax as _j
        _j.config.update("jax_default_matmul_precision", "default")
        out["global_default"] = rate(make_run(None))
    finally:
        _j.config.update("jax_default_matmul_precision", "highest")
    out["global_highest"] = rate(make_run(None))
    return out


def quality_matrix(trials):
    """boston/abalone/kin8nm fits under highest vs default precision."""
    import numpy as np
    from scfgp import SCFGP
    from scfgp.data.datasets import load_abalone, load_boston, load_kin8nm

    benches = {
        # headline configs from the committed sweeps (results/*/results.json)
        "boston": (load_boston, dict(sparsity=20, nfeats=50),
                   dict(max_iter=500, obj="SCORE")),
        "abalone": (load_abalone, dict(sparsity=20, nfeats=56),
                    dict(max_iter=200, obj="SCORE")),
        "kin8nm": (load_kin8nm, dict(sparsity=-1, nfeats=212),
                   dict(max_iter=200, obj="SCORE")),
    }
    out = {}
    for name, (loader, mk, opt) in benches.items():
        legs = {"highest": {"NMSE": [], "MNLP": []},
                "default": {"NMSE": [], "MNLP": []}}
        for rep in range(trials):
            Xt, yt, Xv, yv, meta = loader(seed=rep)
            for leg in legs:
                m = SCFGP(seed=rep, mm_precision=(None if leg == "highest"
                                                  else "default"), **mk)
                m.fit_fast(Xt, yt, Xv, yv, **opt)
                legs[leg]["NMSE"].append(
                    float(m.evals["NMSE"][1][m.min_obj_ind]))
                legs[leg]["MNLP"].append(
                    float(m.evals["MNLP"][1][m.min_obj_ind]))
        rec = {}
        for leg, vals in legs.items():
            rec[leg] = {k: {"mean": float(np.mean(v)),
                            "std": float(np.std(v))}
                        for k, v in vals.items()}
        rec["delta_nmse"] = (rec["default"]["NMSE"]["mean"]
                             - rec["highest"]["NMSE"]["mean"])
        rec["delta_mnlp"] = (rec["default"]["MNLP"]["mean"]
                             - rec["highest"]["MNLP"]["mean"])
        out[name] = rec
        print(name, json.dumps(rec), flush=True)
    return out


def co2_composite_matrix():
    """{highest, default} x {raw, orthonormalized} composite basis."""
    import jax.numpy as jnp
    import numpy as np
    from scfgp import SCFGP, Scaler
    from scfgp.data.datasets import load_co2, surrogate_floor

    Xt, yt, Xv, yv, meta = load_co2(seed=0)
    n_total = Xt.shape[0] + Xv.shape[0]
    omega = 2 * np.pi * (n_total - 1) / 12.0

    def raw_basis(Xs):
        t = Xs[:, :1]
        return jnp.concatenate(
            [jnp.ones_like(t), t, t * t,
             jnp.sin(omega * t), jnp.cos(omega * t),
             jnp.sin(2 * omega * t), jnp.cos(2 * omega * t)], axis=1)

    # Orthonormalized variant: QR of the train-split basis block in the
    # model's own scaled-X space (min-max here), columns scaled to unit
    # RMS — same span, conditioned Gram block.
    sc = Scaler("min-max")
    sc.fit(Xt)
    B = np.asarray(raw_basis(jnp.asarray(sc.forward_transform(Xt))))
    Q, R = np.linalg.qr(B)
    Rinv = jnp.asarray(np.linalg.inv(R) * np.sqrt(B.shape[0]),
                       jnp.float32)

    def ortho_basis(Xs):
        return raw_basis(Xs) @ Rinv.astype(Xs.dtype)

    opt = dict(obj="cost", max_iter=1000, max_cvrg=60,
               algo={"algo": "adamax",
                     "algo_params": {"learning_rate": 0.05, "beta1": 0.8,
                                     "beta2": 0.999, "epsilon": 1e-8}})
    out = {}
    for basis_name, basis in (("raw", raw_basis), ("ortho", ortho_basis)):
        for prec in ("highest", "default"):
            m = SCFGP(sparsity=10, nfeats=20, seed=0,
                      X_scaling_method="min-max", y_scaling_method="normal",
                      extra_basis=basis,
                      mm_precision=(None if prec == "highest" else prec))
            try:
                m.fit_fast(Xt, yt, Xv, yv, **opt)
                nmse = float(m.evals["NMSE"][1][m.min_obj_ind])
                mnlp = float(m.evals["MNLP"][1][m.min_obj_ind])
            except Exception as e:  # NaN cholesky etc.
                nmse, mnlp = float("nan"), float("nan")
                print(f"co2 {basis_name}/{prec} failed: {e}", flush=True)
            rec = {"NMSE": nmse, "MNLP": mnlp}
            if meta["source"] == "synthetic-surrogate":
                fl = surrogate_floor("co2", Xv, yv)
                rec["floor_nmse"] = fl["NMSE"]
                rec["nmse_over_floor"] = (nmse / fl["NMSE"]
                                          if np.isfinite(nmse) else None)
            out[f"{basis_name}_{prec}"] = rec
            print("co2", basis_name, prec, json.dumps(rec), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--skip-speed", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    rec = {"backend": jax.default_backend(), "trials": args.trials}
    if not args.skip_speed:
        rec["speed_bench_cell"] = bench_speed_legs()
        print("speed:", json.dumps(rec["speed_bench_cell"]), flush=True)
    rec["quality"] = quality_matrix(args.trials)
    rec["co2_composite"] = co2_composite_matrix()

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", "precision_quality.json")
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    print("wrote", out)


if __name__ == "__main__":
    main()
