"""Per-fit arithmetic of the objective's two O(N K^2) GEMMs.

Two knobs choose the arithmetic of the Gram and latent-variance GEMMs
(objective._gemm): ``mm_dtype`` (input width: None = f32, or bf16 with f32
accumulation) and ``mm_precision`` (for f32 inputs).  What they lower to
on an H100 with this JAX/XLA version (chip_smoke.py phase 1 prints the
cuBLAS kernels of each setting):

  * ``mm_precision='highest'`` (and the package's global default):
    true f32, FFMA GEMMs outside the tensor cores;
  * ``'default'`` and ``'high'``: TF32 tensor-core GEMMs (10 mantissa
    bits) — 'high' is not a bf16x3 sum here;
  * ``mm_dtype=jnp.bfloat16``: bf16 tensor-core GEMMs, f32 accumulation.

Training-step rate (steps/s, bench.py's scanned step, median of 3 runs;
experiments/step_profile.py) on an NVIDIA H100 80GB HBM3 at a 400 W power
limit:

  cell (N x 2K)   true f32    TF32      bf16
  8192 x  500      799.07   1127.20   1226.05
  8192 x 1024      272.37    532.78    618.04
  65536 x  500     152.27    331.41    428.44
  65536 x 1024      41.58    145.17    206.00

bf16 inputs are the fastest arithmetic in every cell and TF32 the next,
so speed sets no crossover: the rules below are QUALITY gates.  Their
evidence is older than this card: ``results/bf16_sweep.json`` (CPU-exact
bf16 semantics) measured bf16 GEMM inputs non-neutral on kin8nm (NMSE
+0.013, ~+14% relative) and neutral on boston/abalone/plain-co2, and
``results/precision_quality.json`` certified a reduced-precision f32 GEMM
with 7-8 mantissa bits quality-neutral on boston/abalone/kin8nm (TF32
keeps more) while the co2 COMPOSITE model needs true f32 to fit at all.
So:

  * ``mm_dtype="auto"`` keeps f32 inputs below ``BF16_GEMM_WORK_THRESHOLD``
    (where bf16 costs measured quality for a 9-29% step gain) and flips to
    bf16 only at the huge-GEMM-work regime (streaming/synthetic scale),
    never for composite models;
  * ``mm_precision="auto"`` gives ordinary models 'default' (TF32) and
    composite models true f32.

chip_smoke.py phases 2 and 3 check the two ends of the gate on the card
(kin8nm under TF32 in its NMSE band, the composite at its floor); the full
H100 quality matrix is future work (ROADMAP).
"""

from __future__ import annotations

# auto->bf16 threshold on N * (2K)^2 (the quality boundary above; on the
# H100 bf16 is faster than TF32 at every measured cell, so the value is
# kept as the quality gate's, not as a speed crossover).
BF16_GEMM_WORK_THRESHOLD = 6.8e10


def auto_mm_dtype(n_rows: int, two_k: int, has_extra_basis: bool = False):
    """GEMM input dtype: bf16 iff the O(N K^2) GEMM work is above the
    quality gate's threshold (see module doc).

    Composite models (``extra_basis``) NEVER auto-flip to bf16: the co2
    composite fit breaks outright under reduced-precision GEMMs — its
    near-collinear fixed basis block makes the Gram conditioning
    precision-critical."""
    import jax.numpy as jnp
    if has_extra_basis:
        return None
    work = float(n_rows) * float(two_k) ** 2
    return jnp.bfloat16 if work >= BF16_GEMM_WORK_THRESHOLD else None


def resolve_mm_dtype(mm_dtype, n_rows: int, two_k: int,
                     has_extra_basis: bool = False):
    """Resolve a user mm_dtype setting ("auto" | None | a dtype)."""
    if isinstance(mm_dtype, str):
        if mm_dtype != "auto":
            raise ValueError(f"mm_dtype={mm_dtype!r}: use 'auto', None, or "
                             "a dtype")
        return auto_mm_dtype(n_rows, two_k, has_extra_basis)
    return mm_dtype


# -- per-fit matmul PRECISION dispatch ---------------------------------------
#
# Two runtime guards complete the gate:
#   * non-finite fallback — configs whose trained-noise-scale Gram
#     conditioning defeats reduced-precision rounding (measured on the
#     reference's plain 1-D co2 config) are refit ONCE at true f32 with a
#     warning (model._precision_fallback_needed);
#   * SAMPLERS ALWAYS RUN TRUE F32 under auto — MH accept ratios
#     exponentiate N-scaled log-posterior differences, so GEMM rounding
#     that is quality-neutral for the optimizer collapsed every kin8nm
#     fit_bayes arm (tempered NMSE 0.064 vs 0.026, fleet 0.093 vs 0.026).
#     Only an EXPLICIT mm_precision / mm_dtype reaches the sampling path
#     (model.fit_bayes).

_VALID_PRECISIONS = ("default", "high", "highest")


def resolve_mm_precision(mm_precision, has_extra_basis: bool = False):
    """Resolve a user mm_precision setting.

    "auto" -> "highest" for composite (extra_basis) models, "default"
    (TF32 on an H100) otherwise; None -> None (inherit the global matmul
    precision — 'highest' since the package import); explicit
    "default" | "high" | "highest" pass through.  Idempotent."""
    if mm_precision is None:
        return None
    if mm_precision == "auto":
        return "highest" if has_extra_basis else "default"
    if mm_precision not in _VALID_PRECISIONS:
        raise ValueError(
            f"mm_precision={mm_precision!r}: use 'auto', None, or one of "
            f"{_VALID_PRECISIONS}")
    return mm_precision
