"""Headline benchmark: NLML-grad evaluations per second on one GPU.

Measures the full SCFGP training step (feature map -> Gram -> Cholesky
posterior -> closed-form expected NLL -> gradient -> adam+nesterov update)
on the kin8nm-scale config (N=8192, D=8, S=50, M=200 => 2(S+M)=500
features).  Steps are chained inside one jit via ``lax.scan`` so dispatch
latency is excluded; each timed run ends on ``jax.block_until_ready`` and
a leg's rate is the median of three runs.

Legs: "auto" (the headline: the dispatch a default ``SCFGP()`` resolves —
'default' matmul precision on the two O(N K^2) GEMMs, TF32 on an H100;
ops/dispatch.py), "fp32" (``mm_precision=None``: true f32 everywhere) and
"bf16" (bf16 GEMM inputs, f32 accumulation).

The measurement runs in a child process (``python bench.py --worker``),
the only JAX process on the card; the parent stays off JAX and reads the
card's name and power limit from ``nvidia-smi``.  Without a GPU the child
fails and the benchmark exits non-zero with no result line.

Baseline: the reference's kin8nm training at m~212 took ~395 s for a <=500
iteration run (BASELINE.md) => ~1.27 NLML-grad evals/s on the author's
CPU/Theano setup; ``vs_baseline`` is the ratio to that.
"""

import json
import os
import subprocess
import sys
import time

BASELINE_EVALS_PER_S = 500.0 / 395.0  # reference kin8nm: ~1.27 evals/s
N, D, S, M = 8192, 8, 50, 200
STEPS = 50


def make_run(n, d, s, m, mm_dtype=None, mm_precision=None, steps=STEPS):
    """Jitted ``run(params, opt_state) -> (params, opt_state, last_cost)``
    chaining ``steps`` training steps on fixed synthetic (n, d) data, plus
    the initial ``(params, opt_state)``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scfgp.models.objective import loss_fn
    from scfgp.models.params import init_params
    from scfgp.opt.optimizers import make_optimizer, tree_add

    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.rand(n, d), jnp.float32)
    y = jnp.asarray(np.sin(rng.rand(n) * 6) + 0.1 * rng.randn(n),
                    jnp.float32)
    params = init_params(jax.random.PRNGKey(0), d, s, m, jnp.float32)
    tx = make_optimizer("adam", {"learning_rate": 0.01})
    vg = jax.value_and_grad(
        lambda p, X_, y_: loss_fn(p, X_, y_, mm_dtype=mm_dtype,
                                  mm_precision=mm_precision)[0])

    def one(carry, _):
        p, st = carry
        cost, g = vg(p, X, y)
        delta, st = tx.update(g, st, p)
        return (tree_add(p, delta), st), cost

    @jax.jit
    def run(p, st):
        (p, st), costs = jax.lax.scan(one, (p, st), None, length=steps)
        return p, st, costs[-1]
    return run, (params, tx.init(params))


def measure(run, state, steps=STEPS, repeats=3) -> float:
    """Median steps/s over ``repeats`` timed runs (the first call, which
    compiles, is not timed)."""
    import jax
    p, st, c = run(*state)
    jax.block_until_ready(c)
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        p, st, c = run(p, st)
        jax.block_until_ready(c)
        rates.append(steps / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2]


def worker() -> int:
    import jax
    import jax.numpy as jnp
    from scfgp.ops.dispatch import resolve_mm_dtype, resolve_mm_precision
    from scfgp.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    auto = (resolve_mm_dtype("auto", N, 2 * (S + M)),
            resolve_mm_precision("auto"))
    legs = {"auto": auto, "fp32": (None, None), "bf16": (jnp.bfloat16, None)}
    rates = {name: measure(*make_run(N, D, S, M, *cfg))
             for name, cfg in legs.items()}
    print(json.dumps({"legs": rates, "auto_mm_precision": auto[1],
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}}))
    return 0


def main() -> int:
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--worker"], capture_output=True, text=True,
                         timeout=1800)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        sys.stderr.write(out.stderr[-4000:])
        print("bench: the measurement failed; no result", file=sys.stderr)
        return 1
    res = json.loads(lines[-1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    legs = res["legs"]
    v = legs["auto"]
    print(json.dumps({
        "metric": "nlml_grad_evals_per_s",
        "value": v,
        "unit": (f"evals/s (N={N}, 2(S+M)={2 * (S + M)}, auto dispatch -> "
                 f"mm_precision={res['auto_mm_precision']}, median of 3 "
                 f"runs of {STEPS} scanned steps)"),
        "vs_baseline": v / BASELINE_EVALS_PER_S,
        "ms_per_step": 1000.0 / v,
        "legs_evals_per_s": legs,
        "device": res["device"],
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(worker() if sys.argv[1:] == ["--worker"] else main())
