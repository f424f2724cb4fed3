"""BASELINE synthetic-scale config on ONE chip: N=1e6 rows via streaming.

BASELINE.md's weak-scaling target uses a synthetic N=1e6, D=256 workload.
This is its single-device leg: the streaming objective (`ops/streaming.py`) never
materializes Phi (1e6 x 2K f32 = 2 GB at 2K=512), scanning row blocks with
rematerialized backward — O(block) memory regardless of N.

Prints one JSON line per config: full loss+grad+adam step time.
argv: [N D S M BLOCK STEPS]; ``cpu`` forces CPU (use a small N).
Run alone: one JAX process per GPU.
"""

import json
import sys
import time

import jax

if "cpu" in sys.argv:
    sys.argv.remove("cpu")
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")
from scfgp.models.params import init_params
from scfgp.ops.streaming import loss_fn_streaming
from scfgp.opt.optimizers import make_optimizer, tree_add

N, D, S, M, BLOCK, STEPS = (int(a) for a in sys.argv[1:7]) \
    if len(sys.argv) > 6 else (1_000_000, 256, 56, 200, 16384, 5)

rng = np.random.RandomState(0)
# generate on host in blocks to keep host RAM sane; device gets one array
X = rng.rand(N, D).astype(np.float32)
y = (np.sin(X[:, :3].sum(axis=1) * 4.0)
     + 0.1 * rng.randn(N)).astype(np.float32)
X = jnp.asarray(X)
y = jnp.asarray(y)
params = init_params(jax.random.PRNGKey(0), D, S, M, jnp.float32)
tx = make_optimizer("adam", {"learning_rate": 0.01})
opt_state = tx.init(params)

# X, y must be jit ARGUMENTS: closed-over arrays become jaxpr constants and
# a 1 GB constant in the program payload breaks the remote compile service
# ("Broken pipe") — and would be re-uploaded per executable anyway.
vg = jax.value_and_grad(
    lambda p, Xa, ya: loss_fn_streaming(p, Xa, ya, block_size=BLOCK)[0])


@jax.jit
def step(p, st, Xa, ya):
    cost, g = vg(p, Xa, ya)
    delta, st = tx.update(g, st, p)
    return tree_add(p, delta), st, cost


print("backend:", jax.default_backend(),
      "config:", {"N": N, "D": D, "S": S, "M": M, "block": BLOCK},
      flush=True)
t0 = time.perf_counter()
p, st, c = step(params, opt_state, X, y)
print("first cost:", float(c), flush=True)
compile_s = time.perf_counter() - t0
t0 = time.perf_counter()
for _ in range(STEPS):
    p, st, c = step(p, st, X, y)
jax.block_until_ready(c)
final = float(c)
dt = time.perf_counter() - t0
rows_per_s = N * STEPS / dt
print(json.dumps({
    "ms_per_step": round(1e3 * dt / STEPS, 1),
    "rows_per_s": round(rows_per_s / 1e6, 2),
    "unit": "Mrows/s through full loss+grad+adam",
    "final_cost": final, "compile_s": round(compile_s, 1),
}), flush=True)
