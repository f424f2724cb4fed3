"""Worker for the 2-process jax.distributed smoke test (spawned by
tests/test_multihost.py).  Forces the CPU backend FIRST, so the test never
claims an accelerator.

Each process joins the group via scfgp.parallel.multihost.init_distributed,
contributes a local shard to a global mesh-sharded array, and checks a jitted
cross-process reduction (the same XLA-collective path DP training uses over
DCN) against the closed form.
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # f64 -> tight exactness bound

import jax.numpy as jnp  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from scfgp.parallel.multihost import init_distributed, is_coordinator


def main():
    pid = int(sys.argv[1])
    port = sys.argv[2]
    info = init_distributed(coordinator_address=f"127.0.0.1:{port}",
                            num_processes=2, process_id=pid)
    assert info["process_count"] == 2, info
    assert info["global_devices"] == 2, info
    assert is_coordinator() == (pid == 0)

    # NB: jax.make_mesh in jax 0.9 defaults to explicit-sharding axis types,
    # which rejects psum-style contractions; the framework's mesh (plain
    # jax.sharding.Mesh, auto mode) is the supported path.
    from scfgp.parallel.mesh import make_mesh
    mesh = make_mesh()
    local = jnp.full((2, 3), float(pid + 1))  # process p holds rows of p+1
    garr = multihost_utils.host_local_array_to_global_array(
        local, mesh, P("data"))

    total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(garr)
    got = float(total)  # replicated output: addressable on every process
    want = 6.0 * 1 + 6.0 * 2  # 2x3 of ones + 2x3 of twos
    assert got == want, (got, want)
    print(f"worker {pid} psum-over-DCN ok: {got}", flush=True)

    # A REAL data-parallel SCFGP training step across the process boundary:
    # rows process-sharded, sufficient statistics psum-ed by XLA, replicated
    # cost must equal the single-process full batch exactly (the same
    # invariant tests/test_parallel.py proves on the virtual mesh).
    import numpy as np
    from scfgp.models.objective import loss_fn
    from scfgp.models.params import init_params
    from scfgp.opt.optimizers import make_optimizer
    from scfgp.parallel.dp import make_dp_train_step

    rng = np.random.RandomState(0)  # deterministic: both processes agree
    N, D, S, M = 64, 3, 2, 5
    X = jnp.asarray(rng.rand(N, D))
    y = jnp.asarray(np.sin(rng.rand(N) * 6))
    w = jnp.ones((N,))
    params = init_params(jax.random.PRNGKey(0), D, S, M, jnp.float64)
    tx = make_optimizer("adam", {"learning_rate": 0.01})

    half = N // 2
    sl = slice(pid * half, (pid + 1) * half)
    to_global = lambda a: multihost_utils.host_local_array_to_global_array(
        a[sl], mesh, P("data") if a.ndim == 1 else P("data", None))
    step = make_dp_train_step(tx, mesh, mode="gspmd")
    _, _, cost, _ = step(params, tx.init(params),
                         to_global(X), to_global(y), to_global(w))
    ref_cost, _ = loss_fn(params, X, y)
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-12)
    print(f"worker {pid} dp-step-over-DCN exact: {float(cost):.12f}",
          flush=True)


if __name__ == "__main__":
    main()
