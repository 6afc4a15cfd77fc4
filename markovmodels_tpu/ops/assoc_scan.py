"""Temporal parallelization of the forward recursion (associative scan).

The reference's recursion is strictly sequential over frames
(reference src/inference.jl:69-73) — N small matvecs in sequence.
But the per-frame update is linear: with probability-domain operators

    M_t = diag(e_t) · A        (A[j,i] = exp T̂[i,j], e_t = frame-t emission)

the forward state is v_t = M_t ⊗ M_{t-1} ⊗ … ⊗ M_1 v_0, and matrix product is
associative, so the time axis parallelizes (the HMM analog of
ring-attention/context-parallel; paper: *Temporal Parallelization of Inference
in Hidden Markov Models*, PAPERS.md).  The trade is FLOPs for depth: matmuls
(S³) replace matvecs (S²), so this pays off when S is small and N is long —
per-utterance *numerator* alignment graphs, not the big denominator — or when
the time axis is sharded across devices (``parallel/timeshard.py``, which
reuses this operator convention: each device folds only its local chunk and
exchanges boundary operators with one all_gather).

Scheme (work-efficient two-level):
  1. chunk-fold: reshape N operators to (K, C) chunks; a ``lax.scan`` of C
     steps, each a *batched* (K, S, S) matmul, folds every chunk to one
     operator — parallel across K, sequential over C;
  2. ``lax.associative_scan`` over the K chunk operators (log2 K rounds of
     batched matmuls) gives all chunk-boundary prefix products;
  3. logZ reads the final product applied to v₀.

Per-operator max-normalization keeps everything in f32 range; the factored
log-shifts accumulate exactly like the sequential scan's (inference._fb_prob).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from . import semiring_ops as sops

__all__ = ["assoc_forward", "dense_prob_operator"]

NEG_INF = float("-inf")


def dense_prob_operator(cf):
    """(Sp, Sp) probability-domain forward operator A with A @ x == T̂ᵀ ⊗ x
    (prob domain), from the compiled dense exp-shifted factors."""
    if cf.dense_fwd_exp is None:
        raise ValueError("assoc_forward requires a 'dense'-strategy CompiledFSM")
    scale = jnp.where(
        jnp.isfinite(cf.dense_fwd_max), jnp.exp(cf.dense_fwd_max), 0.0
    )
    return cf.dense_fwd_exp * scale[:, None]


def _emissions(cf, lhs, lengths):
    """Per-frame emission probabilities for t = 0..N (inclusive; frame N is
    the phony-absorb step) plus the factored log-shifts — identical semantics
    to the sequential scan's ``eprob`` (inference._fb_prob)."""
    N, P = lhs.shape
    Sp = cf.padded_states
    ts = jnp.arange(N + 1, dtype=jnp.int32)
    active = ts < lengths  # (N+1,)
    lhs_p = jnp.concatenate([lhs, jnp.zeros((1, P), lhs.dtype)], axis=0)
    m_l = jnp.max(lhs_p, axis=1)  # (N+1,)
    el = jnp.exp(lhs_p - m_l[:, None])  # (N+1, P)
    ext = jnp.concatenate([el, jnp.zeros((N + 1, 1), lhs.dtype)], axis=1)
    e = ext[:, cf.state_pdf]  # (N+1, Sp)
    is_ph = jnp.arange(Sp) == cf.final_state
    e = jnp.where(active[:, None], e, jnp.where(is_ph[None, :], 1.0, 0.0))
    return e, jnp.where(active, m_l, 0.0)


def assoc_forward(cf, lhs, lengths=None, *, chunk: int = 16,
                  unroll: int = 1):
    """Log-marginal logZ (B,) via temporally-parallel forward.

    ``lhs``: (B, N, P) log-likelihoods; ``chunk``: frames folded sequentially
    per chunk (K = ceil(N/chunk) operators enter the associative scan; memory
    is O(K·Sp²) per utterance).  Matches ``inference.forward`` to f32
    round-off.
    """
    lhs = jnp.asarray(lhs)
    B, N, P = lhs.shape
    if P != cf.num_pdfs:
        raise ValueError(f"lhs has {P} pdfs, graph expects {cf.num_pdfs}")
    if lengths is None:
        lengths = jnp.full((B,), N)
    lengths = jnp.minimum(jnp.asarray(lengths, dtype=jnp.int32), N)
    A = dense_prob_operator(cf)
    Sp = cf.padded_states
    prec = sops.dot_precision(cf.precision, cf.alpha_hat.dtype)

    def one(lhs_b, len_b):
        e, m_l = _emissions(cf, lhs_b, len_b)  # (N+1, Sp), (N+1,)
        v0 = jnp.exp(cf.alpha_hat) * e[0]
        # operators for t = 1..N, padded to a multiple of `chunk` with I
        K = -(-N // chunk)
        pad = K * chunk - N
        Ms = e[1:, :, None] * A[None, :, :]  # (N, Sp, Sp): diag(e_t) @ A
        norm = jnp.max(Ms, axis=(1, 2))
        ns = jnp.where(norm > 0, norm, 1.0)
        Ms = Ms / ns[:, None, None]
        shifts = jnp.where(norm > 0, jnp.log(ns), 0.0) + m_l[1:]
        eye = jnp.broadcast_to(jnp.eye(Sp, dtype=lhs.dtype), (pad, Sp, Sp))
        Ms = jnp.concatenate([Ms, eye], axis=0).reshape(K, chunk, Sp, Sp)

        # 1) fold each chunk sequentially (batched matmuls over K)
        def fold(carry, M_c):
            y = jnp.einsum("kij,kjl->kil", M_c, carry,
                           preferred_element_type=jnp.float32, precision=prec)
            m = jnp.max(y, axis=(1, 2))
            ms = jnp.where(m > 0, m, 1.0)
            return y / ms[:, None, None], jnp.where(m > 0, jnp.log(ms), 0.0)

        init = jnp.broadcast_to(jnp.eye(Sp, dtype=lhs.dtype), (K, Sp, Sp))
        chunk_ops, fold_shifts = lax.scan(
            fold, init, jnp.moveaxis(Ms, 1, 0), unroll=unroll
        )

        # 2) parallel prefix over the K chunk operators
        def combine(a, b):
            Ma, sa = a
            Mb, sb = b
            M = jnp.einsum("kij,kjl->kil", Mb, Ma,
                           preferred_element_type=jnp.float32, precision=prec)
            m = jnp.max(M, axis=(1, 2))
            ms = jnp.where(m > 0, m, 1.0)
            return M / ms[:, None, None], sa + sb + jnp.where(
                m > 0, jnp.log(ms), 0.0
            )

        prefixes, pshifts = lax.associative_scan(
            combine, (chunk_ops, jnp.sum(fold_shifts, axis=0))
        )

        # 3) logZ from the total product
        vN = prefixes[-1] @ v0
        val = vN[cf.final_state]
        # shifts covers frames 1..N; v0 was built from e[0] which factored
        # out m_l[0], so the frame-0 shift must be restored here (m_l is
        # already zero-masked past the sequence length).
        total_shift = pshifts[-1] + jnp.sum(shifts) + m_l[0]
        return jnp.where(
            val > 0, jnp.log(jnp.maximum(val, 1e-38)), NEG_INF
        ) + total_shift

    return jax.vmap(one)(lhs, lengths)
