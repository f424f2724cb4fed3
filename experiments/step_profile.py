"""Where the training step's device time goes, and the GEMM-arithmetic table.

    python experiments/step_profile.py [--out DIR]

On one GPU (fails without one):

1. traces 10 default training steps (loss + grad + adam update under the
   auto dispatch) at N=8192, D=8, 2(S+M)=500, and one streaming
   value-and-grad at N=65536 with 4096-row blocks, and writes per-HLO-op
   device time joined with the op's metadata (op name, source line,
   result shape) to ``DIR/<name>_ops.json``; prints the top ops and the
   shares of a few op classes;
2. times the training step (bench.py's scanned step) in true f32, TF32
   ('default' precision) and bf16 GEMM inputs at N x 2K in
   {8192, 65536} x {500, 1024}: steps/s, median of 3 runs.

XLA's CUDA-graph command buffers are turned off in this process, so that
each kernel is attributed to its own HLO op in the trace.  The card's name
and power limit are printed beside the numbers.
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_gpu_enable_command_buffer=").strip()

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\S+)\s+([\w\-]+)\(")
_META = re.compile(r'op_name="([^"]*)"(?:.*?source_file="([^"]*)")?'
                   r'(?:.*?source_line=(\d+))?')
_TARGET = re.compile(r'custom_call_target="([^"]+)"')


def hlo_index(hlo_text: str) -> dict:
    """HLO instruction name -> (opcode, result shape, op_name, source)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        name, shape, opcode = m.groups()
        meta = _META.search(line)
        target = _TARGET.search(line)
        src = ""
        if meta and meta.group(2):
            src = f"{os.path.basename(meta.group(2))}:{meta.group(3)}"
        out[name] = {"opcode": target.group(1) if target else opcode,
                     "shape": shape.split("{")[0],
                     "op_name": meta.group(1) if meta else "",
                     "source": src}
    return out


def device_ops(trace_dir: str) -> dict:
    """hlo_op -> {total_ns, count, kernels} over the GPU planes' streams."""
    ops: dict = {}
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True):
        import jax
        data = jax.profiler.ProfileData.from_file(path)
        for plane in data.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if not line.name.lower().startswith("stream"):
                    continue
                for ev in line.events:
                    stats = dict(ev.stats)
                    key = stats.get("hlo_op", ev.name)
                    rec = ops.setdefault(key, {"total_ns": 0.0, "count": 0,
                                               "kernels": set()})
                    rec["total_ns"] += ev.duration_ns
                    rec["count"] += 1
                    rec["kernels"].add(ev.name[:80])
    return ops


def classify(rec: dict) -> str:
    text = " ".join([rec["opcode"], rec["op_name"],
                     " ".join(rec["kernels"])]).lower()
    if "potrf" in text or "cholesky" in text:
        return "cholesky"
    if "trsm" in text or "triangular" in text:
        return "triangular_solve"
    if any(k in text for k in ("gemm", "dot", "xmma", "cutlass",
                               "matmul", "nvjet")):
        return "gemm"
    return "other"


def profile(name, fn, args, steps, out_dir):
    import jax
    compiled = jax.jit(fn).lower(*args).compile()
    hlo = compiled.as_text()
    with open(os.path.join(out_dir, f"{name}.hlo.txt"), "w") as f:
        f.write(hlo)
    index = hlo_index(hlo)
    jax.block_until_ready(compiled(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(steps):
                res = compiled(*args)
            jax.block_until_ready(res)
        ops = device_ops(d)
    rows = []
    for op, rec in ops.items():
        meta = index.get(op, {"opcode": "?", "shape": "?", "op_name": "",
                              "source": ""})
        row = {"hlo_op": op, "us_per_call": rec["total_ns"] / steps / 1e3,
               "launches_per_call": rec["count"] / steps,
               "kernels": sorted(rec["kernels"]), **meta}
        row["class"] = classify(row)
        rows.append(row)
    rows.sort(key=lambda r: -r["us_per_call"])
    total = sum(r["us_per_call"] for r in rows)
    shares: dict = {}
    for r in rows:
        shares[r["class"]] = shares.get(r["class"], 0.0) + r["us_per_call"]
    with open(os.path.join(out_dir, f"{name}_ops.json"), "w") as f:
        json.dump({"device_us_per_call": total, "rows": rows}, f, indent=1)
    print(f"== {name}: device time {total:.1f} us per call "
          f"({len(rows)} ops); class shares: "
          + ", ".join(f"{k} {v / total:.1%}" for k, v in
                      sorted(shares.items(), key=lambda kv: -kv[1])))
    for r in rows[:25]:
        print(f"  {r['us_per_call']:9.1f} us {r['us_per_call'] / total:6.1%} "
              f"{r['class']:16s} {r['hlo_op'][:28]:28s} {r['shape'][:22]:22s}"
              f" {r['source']:18s} {r['op_name'][-60:]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "step_profile_out"))
    ap.add_argument("--skip-table", action="store_true")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bench import make_run, measure
    from scfgp.models.objective import loss_fn
    from scfgp.models.params import init_params
    from scfgp.ops.dispatch import resolve_mm_precision
    from scfgp.ops.streaming import loss_fn_streaming
    from scfgp.opt.optimizers import make_optimizer, tree_add
    from scfgp.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"step_profile: needs a GPU, JAX found {dev.platform}")
    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"device {dev.device_kind}; card {card}", flush=True)
    os.makedirs(args.out, exist_ok=True)

    D, S, M = 8, 50, 200
    rng = np.random.RandomState(0)
    p = init_params(jax.random.PRNGKey(0), D, S, M, jnp.float32)
    tx = make_optimizer("adam", {"learning_rate": 0.01})
    st = tx.init(p)
    prec = resolve_mm_precision("auto")

    def step(p, st, X, y):
        cost, g = jax.value_and_grad(
            lambda q: loss_fn(q, X, y, mm_precision=prec)[0])(p)
        delta, st = tx.update(g, st, p)
        return tree_add(p, delta), st, cost

    X = jnp.asarray(rng.rand(8192, D), jnp.float32)
    y = jnp.asarray(rng.randn(8192), jnp.float32)
    profile("train_step_8192x500", step, (p, st, X, y), 10, args.out)

    Xs = jnp.asarray(rng.rand(65536, D), jnp.float32)
    ys = jnp.asarray(rng.randn(65536), jnp.float32)
    stream = jax.value_and_grad(lambda q, X, y: loss_fn_streaming(
        q, X, y, block_size=4096, mm_precision=prec)[0])
    profile("streaming_65536x500_block4096", stream, (p, Xs, ys), 3,
            args.out)

    if args.skip_table:
        return
    table = {}
    legs = {"fp32": (None, None), "tf32": (None, "default"),
            "bf16": (jnp.bfloat16, None)}
    for n in (8192, 65536):
        for two_k in (500, 1024):
            s = 50 if two_k == 500 else 112
            m = two_k // 2 - s
            for leg, (mm_dtype, mp) in legs.items():
                steps = 50 if n == 8192 else 20
                rate = measure(*make_run(n, D, s, m, mm_dtype, mp, steps),
                               steps=steps)
                table[f"{n}x{two_k} {leg}"] = rate
                print(f"  table {n:6d} x {two_k:5d} {leg:5s} "
                      f"{rate:10.2f} steps/s", flush=True)
    with open(os.path.join(args.out, "arithmetic_table.json"), "w") as f:
        json.dump({"card": card, "device_kind": dev.device_kind,
                   "steps_per_s": table}, f, indent=1)
    print(f"card {card}")


if __name__ == "__main__":
    main()
