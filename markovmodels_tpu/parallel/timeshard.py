"""Time-axis sharding of the forward recursion (temporal parallelism).

The reference's recursion is strictly sequential over frames
(reference src/inference.jl:69-73; SURVEY §5.7).  ``ops/assoc_scan`` breaks
that dependency on ONE device via ``lax.associative_scan``; this module is
the multi-device form — the HMM analog of ring-attention/context
parallelism: the frame sequence is sharded over a mesh axis, every device
**folds its local chunk** of per-frame operators into a single (S, S)
boundary operator in parallel, the D chunk operators are exchanged with one
all_gather, and the (cheap, D-step) cross-device product yields the
final state.  Wall-clock depth drops from O(N) matvecs to
O(N/D) matmuls + O(D).

Like the single-device associative scan this trades FLOPs for depth
(matmuls S³ replace matvecs S²), so it targets long sequences over *small*
graphs — per-utterance numerator/alignment lattices — not the 2M-arc
denominator (which scales by state sharding instead, parallel/sharded.py).

Operator convention (ops/assoc_scan.py): M_t = diag(e_t)·A for t ≥ 1 and
M_0 = diag(e_0), so v_final = (Π_t M_t) · exp(α̂) and every device can build
its operators locally — no boundary *state* is needed, only the folded
boundary *operators* cross devices.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..inference import CompiledFSM, _combine_shift
from ..ops.assoc_scan import dense_prob_operator
from ..ops import semiring_ops as sops

__all__ = ["timesharded_forward", "timesharded_pdfposteriors"]

NEG_INF = float("-inf")


def _expand_rows(cf: CompiledFSM, ext, prec):
    """Per-state emission rows (B, Sp) from extended pdf rows ``ext``
    (B, P1).  One-pdf-per-state graphs gather through ``state_pdf``; a
    general Ĉ (``cf.multi_pdf``) sums each state's pdf set via the binary
    ``pdf_onehot`` matmul (the Ĉ·V̂ expansion, inference._make_eprob) —
    ``state_pdf`` is only a representative pdf there and reading it would
    silently return wrong emissions."""
    if cf.multi_pdf:
        return jnp.einsum(
            "bp,ps->bs", ext, cf.pdf_onehot,
            preferred_element_type=jnp.float32, precision=prec,
        )
    P1 = cf.num_pdfs + 1
    return ext[:, cf.state_pdf.clip(0, P1 - 1)]


def timesharded_forward(
    cf: CompiledFSM,
    lhs,
    lengths=None,
    *,
    mesh: Mesh,
    time_axis: str = "time",
):
    """Log-marginal logZ (B,) with the frame axis sharded over
    ``time_axis``.  Requires a 'dense'-strategy CompiledFSM (the fold is a
    dense operator product).  Matches ``inference.forward`` to f32
    round-off; exact for ragged ``lengths`` (frames past a sequence's end
    contribute identity/phony-absorb operators).
    """
    lhs = jnp.asarray(lhs)
    B, N, Pn = lhs.shape
    if Pn != cf.num_pdfs:
        raise ValueError(f"lhs has {Pn} pdfs, graph expects {cf.num_pdfs}")
    if lengths is None:
        lengths = jnp.full((B,), N)
    lengths = jnp.minimum(jnp.asarray(lengths, dtype=jnp.int32), N)

    D = mesh.shape[time_axis]
    Sp = cf.padded_states
    A = dense_prob_operator(cf)
    prec = sops.dot_precision(cf.precision, cf.alpha_hat.dtype)
    Nf = N + 1
    L = -(-Nf // D)
    Npad = L * D

    # (Npad, B, P): frames beyond Nf are inactive (phony absorb)
    lhs_tm = jnp.pad(jnp.moveaxis(lhs, 1, 0), ((0, Npad - N), (0, 0), (0, 0)))
    is_ph = (jnp.arange(Sp) == cf.final_state).astype(lhs.dtype)
    P1 = cf.num_pdfs + 1

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(time_axis), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def fold_local(lhs_l, lengths_l, alpha_hat):
        """Fold this device's frames; returns the global product applied
        lazily: (total operator (B, Sp, Sp) replicated result pieces)."""
        d = lax.axis_index(time_axis)
        Ll = lhs_l.shape[0]
        ts = d * Ll + jnp.arange(Ll, dtype=jnp.int32)  # global frame ids

        def emissions(lhs_t, t):
            active = t < lengths_l  # (B,)
            m_l = jnp.max(lhs_t, axis=1)
            el = jnp.exp(lhs_t - m_l[:, None])  # (B, P)
            ext = jnp.concatenate(
                [el * active[:, None], jnp.zeros((B, 1), lhs_t.dtype)], axis=1
            )  # (B, P1)
            e = _expand_rows(cf, ext, prec)  # (B, Sp)
            e = jnp.where(
                active[:, None], e, is_ph[None, :]
            )
            return e, jnp.where(active, m_l, 0.0)

        def fold_step(carry, inp):
            M, shift = carry  # (B, Sp, Sp), (B,)
            lhs_t, t = inp
            e, m_l = emissions(lhs_t, t)
            # M_t = diag(e_t) · (A if t > 0 else I); fold M <- M_t @ M
            MA = jnp.einsum(
                "ij,bjl->bil", A, M,
                preferred_element_type=jnp.float32, precision=prec,
            )
            MA = jnp.where(t == 0, M, MA)
            Mn = e[:, :, None] * MA
            m = jnp.max(Mn, axis=(1, 2))
            ms = jnp.where(m > 0, m, 1.0)
            return (Mn / ms[:, None, None],
                    shift + jnp.where(m > 0, jnp.log(ms), 0.0) + m_l), None

        M0 = jnp.broadcast_to(jnp.eye(Sp, dtype=lhs_l.dtype), (B, Sp, Sp))
        (Mc, shiftc), _ = lax.scan(
            fold_step, (M0, jnp.zeros(B, lhs_l.dtype)), (lhs_l, ts)
        )

        # exchange boundary operators: one all_gather
        Ms = lax.all_gather(Mc, time_axis)  # (D, B, Sp, Sp)
        shifts = lax.all_gather(shiftc, time_axis)  # (D, B)

        def cross(carry, Md):
            v = jnp.einsum(
                "bij,bj->bi", Md, carry,
                preferred_element_type=jnp.float32, precision=prec,
            )
            m = jnp.max(v, axis=1)
            ms = jnp.where(m > 0, m, 1.0)
            return v / ms[:, None], jnp.where(m > 0, jnp.log(ms), 0.0)

        v = jnp.broadcast_to(jnp.exp(alpha_hat)[None, :], (B, Sp))
        total = jnp.zeros(B, lhs_l.dtype)
        for dd in range(D):
            v, sh = cross(v, Ms[dd])
            total = total + sh
        val = v[:, cf.final_state]
        logZ = jnp.where(
            val > 0, jnp.log(jnp.maximum(val, 1e-38)), NEG_INF
        ) + total + jnp.sum(shifts, axis=0)
        return logZ, val

    logZ, _ = fold_local(lhs_tm, lengths, cf.alpha_hat)
    return logZ


def timesharded_pdfposteriors(
    cf: CompiledFSM,
    lhs,
    lengths=None,
    *,
    mesh: Mesh,
    time_axis: str = "time",
):
    """Posteriors + logZ with the frame axis sharded over ``time_axis`` —
    the full parallel forward-backward (three phases):

    1. every device folds its local chunk of per-frame operators into one
       boundary operator (parallel, O(N/D) matmuls);
    2. chunk operators are all_gathered once; every device runs
       the cheap O(D) cross-chunk recursion to obtain its chunk's entry
       alpha and exit beta (replicated work, D·Sp² per sequence);
    3. every device runs a LOCAL forward-backward inside its chunk from
       those boundaries, emitting per-frame pdf posteriors (per-frame
       normalization makes the global rescaling shifts cancel).

    Returns (posts (B, N, P), logZ (B,)), matching inference.pdfposteriors
    to f32 round-off.  Same regime note as timesharded_forward: dense
    operators, small graphs, long sequences.
    """
    lhs = jnp.asarray(lhs)
    B, N, Pn = lhs.shape
    if Pn != cf.num_pdfs:
        raise ValueError(f"lhs has {Pn} pdfs, graph expects {cf.num_pdfs}")
    if lengths is None:
        lengths = jnp.full((B,), N)
    lengths = jnp.minimum(jnp.asarray(lengths, dtype=jnp.int32), N)

    D = mesh.shape[time_axis]
    Sp = cf.padded_states
    A = dense_prob_operator(cf)
    prec = sops.dot_precision(cf.precision, cf.alpha_hat.dtype)
    Nf = N + 1
    L = -(-Nf // D)
    Npad = L * D
    lhs_tm = jnp.pad(jnp.moveaxis(lhs, 1, 0), ((0, Npad - N), (0, 0), (0, 0)))
    is_ph = (jnp.arange(Sp) == cf.final_state).astype(lhs.dtype)
    P1 = cf.num_pdfs + 1
    fin = cf.final_state

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(time_axis), P(), P()),
        out_specs=(P(time_axis), P()),
        check_vma=False,
    )
    def run(lhs_l, lengths_l, alpha_hat):
        d = lax.axis_index(time_axis)
        Ll = lhs_l.shape[0]
        ts = d * Ll + jnp.arange(Ll, dtype=jnp.int32)

        def emissions(lhs_t, t):
            active = t < lengths_l
            m_l = jnp.max(lhs_t, axis=1)
            el = jnp.exp(lhs_t - m_l[:, None])
            ext = jnp.concatenate(
                [el * active[:, None], jnp.zeros((B, 1), lhs_t.dtype)],
                axis=1,
            )
            e = _expand_rows(cf, ext, prec)
            return jnp.where(active[:, None], e, is_ph[None, :])

        # phase 1: fold the local chunk operator
        def fold_step(carry, inp):
            M, shift = carry
            lhs_t, t = inp
            e = emissions(lhs_t, t)
            MA = jnp.einsum(
                "ij,bjl->bil", A, M,
                preferred_element_type=jnp.float32, precision=prec,
            )
            MA = jnp.where(t == 0, M, MA)
            Mn = e[:, :, None] * MA
            m = jnp.max(Mn, axis=(1, 2))
            ms = jnp.where(m > 0, m, 1.0)
            return (Mn / ms[:, None, None],
                    shift + jnp.where(m > 0, jnp.log(ms), 0.0)), None

        M0 = jnp.broadcast_to(jnp.eye(Sp, dtype=lhs_l.dtype), (B, Sp, Sp))
        (Mc, shiftc), _ = lax.scan(
            fold_step, (M0, jnp.zeros(B, lhs_l.dtype)), (lhs_l, ts)
        )
        Ms = lax.all_gather(Mc, time_axis)  # (D, B, Sp, Sp)

        # phase 2: cross-chunk boundaries (replicated, O(D) matvecs)
        def norm(v):
            m = jnp.max(v, axis=1)
            return v / jnp.where(m > 0, m, 1.0)[:, None]

        v = jnp.broadcast_to(jnp.exp(alpha_hat)[None, :], (B, Sp))
        v_in = v
        total = jnp.zeros(B, lhs_l.dtype)
        for dd in range(D):
            v_in = jnp.where(dd == d, v, v_in)
            v = jnp.einsum(
                "bij,bj->bi", Ms[dd], v,
                preferred_element_type=jnp.float32, precision=prec,
            )
            m = jnp.max(v, axis=1)
            ms = jnp.where(m > 0, m, 1.0)
            v = v / ms[:, None]
            total = total + jnp.where(m > 0, jnp.log(ms), 0.0)
        b = jnp.broadcast_to(is_ph[None, :], (B, Sp))
        b_out = b
        for dd in range(D - 1, -1, -1):
            b_out = jnp.where(dd == d, b, b_out)
            b = norm(jnp.einsum(
                "bij,bi->bj", Ms[dd], b,
                preferred_element_type=jnp.float32, precision=prec,
            ))
        # logZ = final product + cross norms + psum of fold shifts and the
        # factored emission max-shifts (normalized posteriors below need
        # none of these — all shifts cancel per frame)
        val = v[:, fin]
        m_l = jnp.where(
            ts[:, None] < lengths_l[None, :],
            jnp.max(lhs_l, axis=2), 0.0,
        ).sum(axis=0)
        logZ = (
            jnp.where(val > 0, jnp.log(jnp.maximum(val, 1e-38)), NEG_INF)
            + total + lax.psum(shiftc + m_l, time_axis)
        )

        # phase 3: local forward-backward from the boundaries
        def fstep(carry, inp):
            vv = carry
            lhs_t, t = inp
            e = emissions(lhs_t, t)
            y = jnp.einsum(
                "ij,bj->bi", A, vv,
                preferred_element_type=jnp.float32, precision=prec,
            )
            y = jnp.where(t == 0, vv, y) * e
            return norm(y), norm(y)

        _, alphas = lax.scan(fstep, v_in, (lhs_l, ts))  # (Ll, B, Sp)

        def bstep(carry, inp):
            bb = carry
            lhs_t, t, a_t = inp
            g = a_t * bb  # (B, Sp)
            # β_{t-1} = Aᵀ (e_t ⊙ β_t)  (for t > 0)
            eb = emissions(lhs_t, t) * bb
            nb = jnp.einsum(
                "ij,bi->bj", A, eb,
                preferred_element_type=jnp.float32, precision=prec,
            )
            return norm(nb), g

        _, gammas = lax.scan(
            bstep, b_out, (lhs_l, ts, alphas), reverse=True
        )  # (Ll, B, Sp)

        # pdf reduction + per-frame normalization (shift-free)
        oh = cf.pdf_onehot  # (P1, Sp)
        if oh is None:
            oh = jax.nn.one_hot(
                cf.state_pdf, P1, dtype=lhs_l.dtype, axis=0
            )
        g = jnp.einsum(
            "ps,lbs->lbp", oh, gammas,
            preferred_element_type=jnp.float32, precision=prec,
        )
        tot = jnp.sum(g, axis=2, keepdims=True)
        posts = g[:, :, : cf.num_pdfs] / jnp.where(tot > 0, tot, 1.0)
        active = (ts[:, None] < lengths_l[None, :])[:, :, None]
        return jnp.where(active, posts, 0.0), logZ

    posts_tm, logZ = run(lhs_tm, lengths, cf.alpha_hat)
    posts = jnp.moveaxis(posts_tm, 0, 1)[:, :N, :]  # (B, N, P)
    return posts, logZ
