"""Tracing, step timing, and numerics-debug modes.

The reference's only observability was wall-clock per iteration appended to
``evals['TIME(s)']`` (``reference: SCFGP/SCFGP.py:223,239,267``).  Here
(SURVEY.md §5 *Tracing/profiling* and *Race detection/sanitizers*):

  * ``trace(dir)`` — capture a ``jax.profiler`` trace viewable in
    TensorBoard/XProf/Perfetto (kernel timeline, device memory),
  * ``time_fn`` — compile-then-time a jitted callable to
    ``block_until_ready``, returning calls/s,
  * ``debug_numerics()`` — context manager enabling NaN/Inf checking
    (``jax_debug_nans``) and optionally disabling jit so Python-level
    breakpoints and prints work — the single-device sanitizer story,
  * ``assert_deterministic`` — run a function twice and require bitwise
    identical outputs (deterministic-reduction test mode for cross-host
    sums).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: ``with trace('/tmp/trace'): step(...)``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn: Callable, *args, iters: int = 50, warmup: int = 2,
            **kwargs) -> dict:
    """Time a (jitted) callable; returns {'calls_per_s', 'ms_per_call'}.

    The warmup calls compile; the timed region ends on
    ``jax.block_until_ready`` of the last output.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return {"calls_per_s": iters / dt, "ms_per_call": dt / iters * 1e3}


@contextlib.contextmanager
def debug_numerics(nan_check: bool = True, disable_jit: bool = False):
    """NaN/Inf-checking (and optionally eager) execution for debugging."""
    ctx = contextlib.ExitStack()
    with ctx:
        if nan_check:
            ctx.enter_context(jax.debug_nans(True))
        if disable_jit:
            ctx.enter_context(jax.disable_jit())
        yield


def assert_deterministic(fn: Callable, *args, reps: int = 2) -> Any:
    """Run ``fn`` ``reps`` times; raise if any output bit differs.

    Used to validate that sharded reductions keep a fixed tree order
    (SURVEY.md §7.2 'exactness of distributed training').
    """
    ref = jax.tree.map(np.asarray, fn(*args))
    for _ in range(reps - 1):
        again = jax.tree.map(np.asarray, fn(*args))
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(again)):
            if not np.array_equal(a, b, equal_nan=True):
                raise AssertionError(
                    "non-deterministic output: max abs diff "
                    f"{np.max(np.abs(a - b))}")
    return ref
