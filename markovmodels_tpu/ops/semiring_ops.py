"""Device-side semiring linear algebra (JAX/XLA).

Replacement for the reference's CUDA SpMV/SpMM kernels
(reference src/linalg.jl:159-280).  The per-frame recursion update
``y = T̂ᵀ ⊗ x`` (semiring matvec over the batched state vector, state axis
first: x is (S, B)) comes in three interchangeable strategies:

* ``segment`` — exact edge-parallel gather + segment-logsumexp over a COO
  edge list sorted by destination.  Works for any sparsity, exact
  per-output logsumexp (matches the reference's semantics most closely).
* ``ell`` — padded incoming-arc lists (ELL format), dense gathers +
  a logsumexp over the in-degree axis.  Great for low/uniform in-degree
  graphs (linear numerator lattices).
* ``dense`` — masked dense operator as a matrix product: the log-semiring matmul
  is computed as ``log(exp(W - rowmax) @ exp(x - colmax)) + rowmax + colmax``
  (blockwise max-rescaling trick; ``exp(W - rowmax)`` is precomputed once at
  compile time so the per-frame cost is one real matmul plus cheap elementwise work).

All ops use log-domain f32 and treat ``-inf`` as semiring zero, with masking
so empty rows/columns yield exactly ``-inf`` (the reference kernel's
empty-row behavior, src/linalg.jl:220-225).

The tropical (max-plus) counterparts used by Viterbi reuse the segment/ELL
forms with max in place of logsumexp.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -jnp.inf


def _safe(m):
    """Replace -inf (empty-group max) by 0 so subtraction stays finite."""
    return jnp.where(jnp.isfinite(m), m, 0.0)


def masked_logsumexp(x, axis):
    """logsumexp that returns exactly -inf for all--inf slices (no NaNs)."""
    m = jnp.max(x, axis=axis, keepdims=True)
    ms = _safe(m)
    s = jnp.sum(jnp.exp(x - ms), axis=axis)
    ms = jnp.squeeze(ms, axis=axis)
    return jnp.where(s > 0, jnp.log(s) + ms, NEG_INF)


# ---------------------------------------------------------------------------
# segment strategy
# ---------------------------------------------------------------------------

def segment_logsumexp(data, segment_ids, num_segments, indices_are_sorted=False):
    """Per-segment logsumexp along the leading axis of ``data``."""
    m = jax.ops.segment_max(
        data, segment_ids, num_segments, indices_are_sorted=indices_are_sorted
    )
    ms = _safe(m)
    e = jnp.exp(data - ms[segment_ids])
    s = jax.ops.segment_sum(
        e, segment_ids, num_segments, indices_are_sorted=indices_are_sorted
    )
    return jnp.where(s > 0, jnp.log(s) + ms, NEG_INF)


def segment_matvec(src, dst, w, x, num_states, *, op="logsumexp"):
    """y[j, b] = ⊕_{e: dst[e]=j} w[e] + x[src[e], b].

    ``x``: (S, B); edges sorted by ``dst``; padding edges carry w = -inf.
    ``op``: 'logsumexp' (log semiring) or 'max' (tropical).
    Returns (S, B), or ((S, B), argmax-source (S, B) int32) for op='max'.
    """
    contrib = x[src, :] + w[:, None]  # (E, B)
    if op == "max":
        y = jax.ops.segment_max(contrib, dst, num_states, indices_are_sorted=True)
        # backpointer: source index achieving the max (ties -> largest src)
        hit = jnp.where(contrib == y[dst, :], src[:, None], -1)
        bp = jax.ops.segment_max(hit, dst, num_states, indices_are_sorted=True)
        return y, bp.astype(jnp.int32)
    return segment_logsumexp(contrib, dst, num_states, indices_are_sorted=True)


# ---------------------------------------------------------------------------
# ELL strategy
# ---------------------------------------------------------------------------

def ell_matvec(ell_src, ell_w, x, *, op="logsumexp"):
    """y[j, b] = ⊕_d ell_w[j, d] + x[ell_src[j, d], b].

    ``ell_src``/``ell_w``: (S, D) padded incoming-arc lists (w = -inf pads).
    """
    contrib = x[ell_src, :] + ell_w[:, :, None]  # (S, D, B)
    if op == "max":
        y = jnp.max(contrib, axis=1)
        hit = jnp.where(contrib == y[:, None, :], ell_src[:, :, None], -1)
        bp = jnp.max(hit, axis=1)
        return y, bp.astype(jnp.int32)
    return masked_logsumexp(contrib, axis=1)


# ---------------------------------------------------------------------------
# dense (matmul) strategy
# ---------------------------------------------------------------------------

def make_dense_operator(dense_w):
    """Precompute the exp-shifted operator for the dense log-matvec.

    ``dense_w``: (S, S) log weights with -inf for absent arcs, laid out so
    that y = W ⊗ x contracts over axis 1 (W[j, i] = weight of arc i→j for the
    forward direction).  Returns (exp_w, row_max).
    """
    row_max = jnp.max(dense_w, axis=1)
    exp_w = jnp.where(
        jnp.isfinite(dense_w), jnp.exp(dense_w - _safe(row_max)[:, None]), 0.0
    )
    return exp_w, row_max


_PRECISIONS = {
    # bf16 operands, f32 accumulation (one tensor-core pass)
    "bf16": jax.lax.DotAlgorithmPreset.BF16_BF16_F32,
    # three bf16 passes with f32 accumulation: about f32-accurate
    "high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    # true fp32: no TF32 rounding on the GPU
    "f32": jax.lax.Precision.HIGHEST,
}


def dot_precision(mode: str, dtype):
    """``precision`` argument for a product of ``dtype`` operands under the
    precision mode ``mode`` ('bf16' | 'high' | 'f32').

    The modes below fp32 are dot algorithms over f32 operands that XLA's
    GPU backend implements.  Everywhere else every mode is true fp32: the
    CPU backend runs those algorithms at f32 anyway and rejects them for
    some small shapes, and f64 operands (the f64 compile) are never
    demoted."""
    if jnp.dtype(dtype) != jnp.float32 or jax.default_backend() != "gpu":
        return jax.lax.Precision.HIGHEST
    return _PRECISIONS[mode]


def dense_log_matvec(exp_w, row_max, x, precision: str = "high"):
    """y[j, b] = logsumexp_i(W[j, i] + x[i, b]) as one matrix product.

    Exactness note: the max-rescaling bound is per-(row, column) rather than
    per-element, so contributions > ~88 nats below (row_max + col_max) can
    underflow; with per-frame rescaled scans and renormalized graphs this is
    far below f32 round-off of the result.
    """
    col_max = jnp.max(x, axis=0)  # (B,)
    ex = jnp.exp(x - _safe(col_max)[None, :])
    p = jnp.dot(
        exp_w,
        ex,
        preferred_element_type=jnp.float32,
        precision=dot_precision(precision, exp_w.dtype),
    )
    return jnp.where(
        p > 0, jnp.log(p) + row_max[:, None] + _safe(col_max)[None, :], NEG_INF
    )
