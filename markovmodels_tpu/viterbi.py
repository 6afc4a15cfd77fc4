"""Viterbi decoding — tropical-semiring recursion with backtrace.

The reference disabled its Viterbi exports in v0.10
(``maxstateposteriors``/``bestpath`` commented out, reference
src/MarkovModels.jl:56-57; historical tests test/test_algorithms.jl:262-284);
here it is first-class, with two regimes:

* small/medium graphs ('segment'/'ell' strategies): the same scan skeleton
  as inference.py run in the log-domain tropical semiring, recording int32
  backpointers per frame, then a reverse scan gathers the best sequence.
* at scale ('dense'/'block' strategies, e.g. the 2M-arc denominator), two
  designs, picked by graph shape and memory:
  - **compressed backpointers** (single-affine-tier block graphs,
    including capped/overflow layouts — a backoff LM's overflow families
    get per-group candidate spaces decoded through host-built tables):
    the in-degree of every state is tier width + band count (+ overflow
    families) < 255, so the winning *candidate id* fits a uint8 — one
    tropical forward sweep records (Npad, Sp, B) uint8 ids (~4.4 GB at
    the benchmark shape) via a single-pass variadic (max, argmax) reduce,
    and the backtrace is a trivial gather walk.  The tropical max-product
    has no tensor-core form (no max-times matrix unit), so halving the
    sweeps is the lever.
  - **backpointer-free chunk recompute** (fallback; full int32 backpointers
    would cost as much device memory as the alphas): forward saves only chunk
    boundaries; the path is recovered chunk-by-chunk in reverse by
    recomputing alphas from the boundary, then walking s_t = argmax over
    the ≤D_in incoming arcs of s_{t+1}.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .inference import (
    CompiledFSM,
    _colmax_safe,
    _combine_shift,
    _kahan_add,
    _make_elhs,
    _make_eprob,
)
from .ops import semiring_ops as sops

__all__ = ["viterbi", "best_path", "maxstateposteriors"]

NEG_INF = -jnp.inf


def _trop_matvec(cf: CompiledFSM, direction: str):
    Sp = cf.padded_states
    if cf.ell_fwd_src is not None:
        s = cf.ell_fwd_src if direction == "fwd" else cf.ell_bwd_src
        w = cf.ell_fwd_w if direction == "fwd" else cf.ell_bwd_w
        return lambda x: sops.ell_matvec(s, w, x, op="max")
    if direction == "fwd":
        s, d, w = cf.fwd_src, cf.fwd_dst, cf.fwd_w
    else:
        s, d, w = cf.bwd_src, cf.bwd_dst, cf.bwd_w
    return lambda x: sops.segment_matvec(s, d, w, x, Sp, op="max")


def _viterbi_single(cf: CompiledFSM, lhs, lengths):
    """lhs: (B, N, P).  Returns (states (B, N) int32, score (B,))."""
    B, N, P = lhs.shape
    Sp = cf.padded_states
    Nf = N + 1
    need = 4 * Nf * Sp * B  # full int32 backpointers (Nf, Sp, B)
    if need > _BP_MEM_BYTES:
        raise ValueError(
            f"viterbi int32 backpointer stream ~{need / 1e9:.1f} GB "
            f"(Nf={Nf} x Sp={Sp} x B={B}) exceeds the "
            f"{_BP_MEM_BYTES / 1e9:.0f} GB budget for the "
            f"{cf.strategy!r} strategy; compile the graph with "
            "strategy='block' (or 'dense') to use the at-scale "
            "chunk-recompute decoder instead"
        )
    lhs_tm = jnp.moveaxis(lhs, 1, 0)
    lhs_tm = jnp.pad(lhs_tm, ((0, Nf - N), (0, 0), (0, 0)))
    ts = jnp.arange(Nf, dtype=jnp.int32)

    mv = _trop_matvec(cf, "fwd")
    elhs = _make_elhs(cf, lengths, trop=True)
    x0 = jnp.broadcast_to(cf.alpha_hat[:, None], (Sp, B))

    def fstep(carry, inp):
        x, shift = carry
        lhs_t, t = inp
        y_mv, bp = mv(x)
        y = jnp.where(t == 0, x, y_mv)
        bp = jnp.where(t == 0, jnp.broadcast_to(jnp.arange(Sp)[:, None], bp.shape), bp)
        y = y + elhs(lhs_t, t)
        m = _colmax_safe(y)
        y = y - m[None, :]
        return (y, shift + m), bp  # bp: (Sp, B) int32

    (xF, shiftF), bps = lax.scan(fstep, (x0, jnp.zeros(B, lhs.dtype)), (lhs_tm, ts))
    score = jnp.take(xF, cf.final_state, axis=0) + shiftF  # (B,)

    # backtrace: state at frame Nf-1 is the phony final state; walk bps back.
    bcol = jnp.arange(B)

    def btrace(state, bp_t):
        prev = bp_t[state, bcol]
        return prev, prev

    s_last = jnp.broadcast_to(cf.final_state, (B,)).astype(jnp.int32)
    _, states = lax.scan(btrace, s_last, bps[1:], reverse=True)
    # states[t] = argmax state at frame t for t = 0..Nf-2; frame Nf-1 is phony.
    states = jnp.moveaxis(states, 1, 0)  # (B, Nf-1) == (B, N)
    if cf.orig_state is not None:
        # report host state ids when the graph was compiled with a
        # reordered internal layout (inference.compile_fsm reorder='pdf')
        states = jnp.take(cf.orig_state, states, axis=0)
    return states, score


def _trop_prob_matvec(cf: CompiledFSM):
    """Forward tropical matvec in the probability domain:
    y[j, b] = max_i exp(T̂[i, j]) · x[i, b] — reuses the compiled dense/block
    operators with max in place of the sum reduction."""
    if cf.strategy == "dense":
        Wp = jnp.exp(cf.dense_fwd_max)[:, None] * cf.dense_fwd_exp

        def mv(a):
            # broadcast-multiply + max-reduce fuses in XLA (no (Sp, Sp, B)
            # intermediate in device memory)
            return jnp.max(Wp[:, :, None] * a[None, :, :], axis=1)

        return mv
    if cf.strategy == "block":
        from .ops.blocked import block_matvec

        def mv(a):
            y = block_matvec(
                cf.block_fwd, cf.block_fwd_offsets, a, None, op_kind="max"
            )
            if cf.omega_prob is not None:
                # rank-1 ω handling (inference._make_prob_matvecs)
                yfin = jnp.max(cf.omega_prob[:, None] * a, axis=0)
                y = y.at[cf.final_state].set(yfin)
            return y

        return mv
    raise ValueError(f"no tropical prob matvec for strategy {cf.strategy!r}")


# device-memory budgets: saved alphas of the recompute decoder, and the
# backpointer stream (uint8 here, int32 in _viterbi_single)
_FULL_MEM_BYTES = 4 << 30
_BP_MEM_BYTES = 6 << 30


def _bp_vit_reject_reason(cf: CompiledFSM, lhs):
    """None when the compressed-backpointer decode (_viterbi_scale_bp) can
    run, else the first rejected predicate: block strategy, rank-1 ω
    split, single affine tier (candidate ids fit uint8), and the
    (Npad, Sp, B) uint8 bp stream fitting its memory budget."""
    import os

    if os.environ.get("MMTPU_NO_VITBP"):
        return "MMTPU_NO_VITBP is set"
    if cf.strategy != "block":
        return f"strategy {cf.strategy!r} != 'block'"
    if cf.omega_prob is None:
        return "no rank-1 omega split"
    from .ops.blocked import block_max_arg_supported

    ov_lo = cmaxv = None
    if getattr(cf, "ov_layout", ()) and cf.block_fwd.ov_w:
        cmaxv = cf.ov_layout[0]
        ov_lo = cf.num_pdfs * cmaxv
    if not block_max_arg_supported(
        cf.block_fwd, cf.block_fwd_offsets, ov_lo=ov_lo, cmax=cmaxv
    ):
        return ("operator not a single affine tier (+ supported overflow "
                "families) with uint8-range candidate ids")
    B, N, _ = lhs.shape
    need = (N + 1) * cf.padded_states * B
    if need > _BP_MEM_BYTES:
        return (f"uint8 backpointer stream ~{need / 1e9:.1f} GB exceeds "
                f"the {_BP_MEM_BYTES / 1e9:.0f} GB budget (chunk-recompute "
                "decode used instead)")
    return None


def _bp_vit_ok(cf: CompiledFSM, lhs) -> bool:
    return _bp_vit_reject_reason(cf, lhs) is None


def _viterbi_scale_bp(cf: CompiledFSM, lhs, lengths):
    """Backpointer-based Viterbi for 'block' graphs with a single affine
    tier: ONE tropical forward sweep that records, per frame and state, the
    winning *candidate id* (tier source position or band offset index —
    uint8, in-degree < 255), plus the rank-1 ω argmax per frame.  The
    backtrace is then a trivial (B,) gather walk — no chunk recompute
    sweep, unlike _viterbi_scale (the tropical max-product runs on the
    vector units, so halving the sweeps is the lever; the uint8 stream
    costs Npad·Sp·B bytes of device memory, ~4.4 GB at the 2M-arc
    benchmark shape).

    Reference hot-kernel analog src/linalg.jl:159-233 (tropical SpMV); the
    reference's (disabled) bestpath stored full per-state backpointers.
    """
    import numpy as np

    from .ops.blocked import block_matvec_max_arg, tier_dst_inverse, _maxarg

    B, N, P = lhs.shape
    Sp = cf.padded_states
    Nf = N + 1
    fin_idx = int(cf.final_state)
    omega_p = cf.omega_prob
    sidx = cf.block_fwd.tiers[0][0]
    K, Sm = sidx.shape
    nO = len(cf.block_fwd_offsets[0])

    # overflow-family candidate support (canonicalized backoff LM graphs):
    # the sweep tracks per-group in-family/band ids (_ov_cand_layout) and
    # the walk decodes them through small host-built tables — a full
    # (nOv*cmax, 256) candidate->source map for overflow states plus a
    # (Sp,) ov_out source map for core states fed by overflow lanes
    ov_span = None
    ovout_tab = None
    ov_dec = None
    ov_lo = Sp
    # only when overflow FAMILIES exist: a graph whose overflow in-arcs
    # were all captured by the shared-offset bands (ov_w empty) keeps the
    # GLOBAL tier/band candidate encoding on its overflow slots, and the
    # core decode below handles them — building the per-group table for
    # it would mistranslate band ids (review finding, round 5)
    if getattr(cf, "ov_layout", ()) and cf.block_fwd.ov_w:
        from .ops.blocked import _ov_cand_layout

        cmaxv, nOvg = cf.ov_layout
        ov_lo = cf.num_pdfs * cmaxv
        ov_span = (ov_lo, nOvg, cmaxv)
        meta = cf.block_fwd_offsets
        fam, csize = _ov_cand_layout(meta, ov_lo, cmaxv)
        band_np = np.asarray(meta[0], dtype=np.int64)
        lanes = np.arange(cmaxv)
        dec = np.full((nOvg * cmaxv, 256), -1, dtype=np.int64)
        for gi in range(nOvg):
            g0 = ov_lo + gi * cmaxv
            C_g = csize.get(g0, 0)
            rows = gi * cmaxv + lanes
            for oi, off in enumerate(band_np):
                srcs = (g0 + lanes) - off
                ok = (srcs >= 0) & (srcs < Sp)
                dec[rows, C_g + oi] = np.where(ok, srcs, -1)
            for desc, cum in fam.get(g0, []):
                _, _, form, base, stride, D = desc
                if form == "win":
                    dec[rows[:, None], cum + lanes[None, :]] = (
                        base + lanes[:, None] * stride + lanes[None, :]
                    )
                else:
                    dec[rows[:, None], cum + np.arange(D)[None, :]] = (
                        base + np.arange(D)[None, :] * stride
                        + lanes[:, None]
                    )
        ov_dec = jnp.asarray(dec.astype(np.int32))
        oo = np.full(Sp, -1, dtype=np.int64)
        for desc in (meta[3] if len(meta) > 3 else ()):
            kind, g0, form, base, stride, D = desc
            if kind != "out":
                continue
            if form == "col":
                d_grid = (base + np.arange(D)[:, None] * stride
                          + lanes[None, :])
                s_grid = g0 + np.broadcast_to(lanes[None, :], d_grid.shape)
            else:
                d_grid = (base + lanes[:, None] * stride
                          + lanes[None, :])
                s_grid = g0 + np.broadcast_to(lanes[:, None], d_grid.shape)
            oo[d_grid.reshape(-1)] = s_grid.reshape(-1)
        ovout_tab = jnp.asarray(oo.astype(np.int32))

    lhs_tm = jnp.pad(
        jnp.moveaxis(lhs, 1, 0), ((0, Nf - N), (0, 0), (0, 0))
    )
    ts_sc = jnp.arange(Nf, dtype=jnp.int32)
    eprob = _make_eprob(cf, lengths, op="max")
    a0 = jnp.broadcast_to(
        jnp.exp(cf.alpha_hat)[:, None], (Sp, B)
    ).astype(lhs.dtype)
    zero = jnp.zeros(B, lhs.dtype)
    bidx = jax.lax.broadcasted_iota(jnp.int32, (Sp, B), 0)

    def fstep(carry, inp):
        a, ksum, shift, comp = carry
        lhs_t, t = inp
        # rank-1 ω transition into phony: value + argmax source
        fin_v, fin_a = _maxarg(omega_p[:, None] * a, bidx, 0)
        y, cand = block_matvec_max_arg(
            cf.block_fwd, cf.block_fwd_offsets, a, ov_span=ov_span
        )
        y = y.at[fin_idx].set(fin_v)
        p = jnp.where(t == 0, a, y)
        e, m_l = eprob(lhs_t, t)
        y = p * e
        m = jnp.max(y, axis=0)
        k = jnp.where(m > 0, jnp.floor(jnp.log2(m)), 0.0)
        y = y * jnp.exp2(-k)[None, :]
        shift, comp = _kahan_add(shift, comp, m_l)
        return (y, ksum + k, shift, comp), (
            cand.astype(jnp.uint8),
            fin_a.astype(jnp.int32),
        )

    (aF, kF, sF, _), (bps, fins) = lax.scan(
        fstep, (a0, zero, zero, zero), (lhs_tm, ts_sc)
    )
    v = jnp.take(aF, fin_idx, axis=0)
    score = _combine_shift(
        jnp.where(v > 0, jnp.log(jnp.maximum(v, 1e-38)), NEG_INF), kF, sF
    )

    # backtrace: decode candidate ids to source states
    k_of = jnp.asarray(tier_dst_inverse(cf.block_fwd, Sp))
    sidx_flat = sidx.reshape(-1)
    offs = jnp.asarray(
        np.asarray(cf.block_fwd_offsets[0], dtype=np.int32).reshape(-1)
        if nO
        else np.zeros(1, np.int32)
    )
    fin_b = jnp.broadcast_to(fin_idx, (B,)).astype(jnp.int32)
    bcol = jnp.arange(B)
    ts = jnp.arange(Nf, dtype=jnp.int32)

    def wstep(s, inp):
        cand_t, fin_t, t = inp
        c = cand_t[s, bcol].astype(jnp.int32)
        tier_src = sidx_flat[
            jnp.clip(k_of[s], 0, K - 1) * Sm + jnp.clip(c, 0, Sm - 1)
        ]
        band_src = s - offs[jnp.clip(c - Sm, 0, offs.shape[0] - 1)]
        src = jnp.where(c < Sm, tier_src, band_src)
        if ovout_tab is not None:
            osrc = ovout_tab[s]
            src = jnp.where((c == Sm + nO) & (osrc >= 0), osrc, src)
        if ov_dec is not None:
            u = jnp.clip(s - ov_lo, 0, ov_dec.shape[0] - 1)
            od = ov_dec[u, jnp.clip(c, 0, 255)]
            src = jnp.where(
                s >= ov_lo, jnp.where(od < 0, fin_b, od), src
            )
        src = jnp.where(c == 255, fin_b, src)
        s_prev = jnp.where(t == lengths, fin_t, src)
        s_prev = jnp.where(t > lengths, fin_b, s_prev)
        return s_prev, s_prev

    _, states = lax.scan(
        wstep, fin_b, (bps[1:], fins[1:], ts[1:]), reverse=True
    )
    states = states[:N].T  # (B, N)
    if cf.orig_state is not None:
        states = jnp.take(cf.orig_state, states, axis=0)
    return states, score


def _viterbi_scale(cf: CompiledFSM, lhs, lengths, chunk_size=None):
    """Backpointer-free Viterbi for 'dense'/'block' graphs (module
    docstring): chunk-checkpointed forward + per-chunk recompute walk.
    Returns (states (B, N) int32 in compiled numbering, score (B,))."""
    reason = _bp_vit_reject_reason(cf, lhs)
    if reason is None:
        return _viterbi_scale_bp(cf, lhs, lengths)
    if cf.strategy == "block":
        # name the cliff once, at trace time (the chunk-recompute decode
        # is ~2x slower than the single-sweep bp design)
        import logging

        logging.getLogger("markovmodels_tpu").warning(
            "block-strategy Viterbi fell back to chunk-recompute: %s",
            reason,
        )
    B, N, P = lhs.shape
    Sp = cf.padded_states
    Nf = N + 1
    if chunk_size is None:
        est = Nf * Sp * B * 4
        chunk_size = Nf if est <= _FULL_MEM_BYTES else 64
    K = min(chunk_size, Nf)
    C = -(-Nf // K)
    Npad = C * K

    lhs_tm = jnp.pad(jnp.moveaxis(lhs, 1, 0), ((0, Npad - N), (0, 0), (0, 0)))
    ts = jnp.arange(Npad, dtype=jnp.int32)
    lhs_cm = lhs_tm.reshape(C, K, B, P)
    ts_cm = ts.reshape(C, K)

    eprob = _make_eprob(cf, lengths, op="max")
    mv = _trop_prob_matvec(cf)

    # incoming-arc CSR pointers over the dst-sorted fwd edge arrays (host
    # side; cf must be concrete — close over the graph when jitting).
    # The phony final state is EXCLUDED from the gather width: its in-degree
    # is O(S) (every state's ω arc) and a parked decoder sits on it for all
    # padded frames, so gathering its arc list per frame would dominate the
    # whole decode at the 2M scale; the
    # ω transition at t = L-1 is resolved analytically from the rank-1 ω
    # vector instead.
    fin_idx = int(cf.final_state)
    dst_np = np.asarray(cf.fwd_dst)
    Ep = len(dst_np)
    rowptr_np = np.searchsorted(dst_np, np.arange(Sp + 1)).astype(np.int32)
    indeg = np.diff(rowptr_np)
    indeg[fin_idx] = 0
    indeg[Sp - 1] = 0  # padding edges park on the last slot
    Dmax = max(int(indeg.max()), 1)
    rowptr = jnp.asarray(rowptr_np)

    # ω probabilities: exp(T̂[:, fin]) (fin's own slot is harmless — its
    # alpha is zero on active frames)
    if cf.strategy == "block" and cf.omega_prob is not None:
        omega_p = cf.omega_prob
    else:
        omega_p = jnp.exp(cf.dense_fwd_max[fin_idx]) * cf.dense_fwd_exp[
            fin_idx
        ]

    a0 = jnp.broadcast_to(jnp.exp(cf.alpha_hat)[:, None], (Sp, B)).astype(
        lhs.dtype
    )

    zero = jnp.zeros(B, lhs.dtype)

    def fstep(carry, inp):
        a, ksum, shift, comp = carry
        lhs_t, t = inp
        p = jnp.where(t == 0, a, mv(a))
        e, m_l = eprob(lhs_t, t)
        y = p * e
        m = jnp.max(y, axis=0)
        k = jnp.where(m > 0, jnp.floor(jnp.log2(m)), 0.0)
        y = y * jnp.exp2(-k)[None, :]
        shift, comp = _kahan_add(shift, comp, m_l)
        return (y, ksum + k, shift, comp), None

    def fstep_save(carry, inp):
        new_carry, _ = fstep(carry, inp)
        return new_carry, new_carry[0]

    def chunk_fwd(carry, inp):
        boundary = carry[0]
        new_carry, _ = lax.scan(fstep, carry, inp)
        return new_carry, boundary

    (aF, kF, sF, _), boundaries = lax.scan(
        chunk_fwd, (a0, zero, zero, zero), (lhs_cm, ts_cm)
    )
    v = jnp.take(aF, cf.final_state, axis=0)
    score = _combine_shift(
        jnp.where(v > 0, jnp.log(jnp.maximum(v, 1e-38)), NEG_INF), kF, sF
    )

    offs = jnp.arange(Dmax, dtype=jnp.int32)

    fin_b = jnp.broadcast_to(cf.final_state, (B,)).astype(jnp.int32)

    def bstep(s, inp):
        a_t, t = inp
        # s = s_{t+1}; recover s_t from the incoming arcs of s
        rp = rowptr[s]  # (B,)
        cnt = jnp.where(s == fin_idx, 0, rowptr[s + 1] - rp)
        eidx = jnp.minimum(rp[:, None] + offs[None, :], Ep - 1)  # (B, D)
        src = cf.fwd_src[eidx]
        wlog = cf.fwd_w[eidx]
        av = jnp.take_along_axis(a_t.T, src, axis=1)  # (B, D)
        valid = offs[None, :] < cnt[:, None]
        cand = jnp.where(valid & (av > 0), jnp.log(av) + wlog, NEG_INF)
        # ties -> largest source index (the segment/ELL kernels' convention)
        best = (Dmax - 1) - jnp.argmax(cand[:, ::-1], axis=1)
        s_t = jnp.take_along_axis(src, best[:, None], axis=1)[:, 0]
        # every incoming candidate underflowed (state ~88 nats below the
        # frame max): argmax is arbitrary and could emit a transition that
        # does not exist in the graph — park on the phony final state
        # instead, which unambiguously FLAGS the breakdown in the decoded
        # sequence (a real mid-utterance frame can never be phony)
        s_t = jnp.where(jnp.max(cand, axis=1) == NEG_INF, fin_b, s_t)

        # t = L-1: transition into phony via the ω arcs (rank-1, full-width
        # argmax) — lax.cond skips the (Sp, B) work on every other frame
        is_last = t == lengths - 1

        def with_omega(sg):
            oc = a_t * omega_p[:, None]  # (Sp, B)
            ob = (Sp - 1) - jnp.argmax(oc[::-1, :], axis=0)
            return jnp.where(is_last, ob.astype(jnp.int32), sg)

        s_t = lax.cond(jnp.any(is_last), with_omega, lambda sg: sg, s_t)
        # t >= L: decoder is parked on the phony final state
        s_t = jnp.where(t >= lengths, fin_b, s_t)
        return s_t, s_t

    def btrace_chunk(s, inp):
        bound, lhs_k, ts_k = inp
        _, A_k = lax.scan(
            fstep_save, (bound, zero, zero, zero), (lhs_k, ts_k)
        )
        return lax.scan(bstep, s, (A_k, ts_k), reverse=True)

    s0 = jnp.broadcast_to(cf.final_state, (B,)).astype(jnp.int32)
    _, states_cm = lax.scan(
        btrace_chunk, s0, (boundaries, lhs_cm, ts_cm), reverse=True
    )
    states = states_cm.reshape(Npad, B)[:N].T  # (B, N)
    if cf.orig_state is not None:
        states = jnp.take(cf.orig_state, states, axis=0)
    return states, score


def viterbi(cf: CompiledFSM, lhs, lengths=None, *, chunk_size=None):
    """Best-path decode.  Returns (state sequence (B, N) int32, score (B,)).

    For frames past each utterance's length the recursion sits on the phony
    final state, so returned entries there equal the phony state id; mask
    with ``lengths`` when consuming.
    """
    lhs = jnp.asarray(lhs)
    if lengths is None:
        lengths = jnp.full((lhs.shape[0],), lhs.shape[-2])
    lengths = jnp.minimum(jnp.asarray(lengths, dtype=jnp.int32), lhs.shape[-2])
    if cf.batched:
        def one(cf_b, lhs_b, len_b):
            return _viterbi_single(cf_b, lhs_b[None], len_b[None])

        states, score = jax.vmap(one)(cf, lhs, lengths)
        return states[:, 0], score[:, 0]
    if cf.strategy in ("dense", "block"):
        return _viterbi_scale(cf, lhs, lengths, chunk_size)
    return _viterbi_single(cf, lhs, lengths)


best_path = viterbi


def maxstateposteriors(cf: CompiledFSM, lhs, lengths=None):
    """Per-state max-posterior scores (tropical α⊙β), (B, N, S) log-domain,
    normalized by the Viterbi score (best path states score 0).

    Mirrors the reference's historical ``maxstateposteriors``
    (test/test_algorithms.jl:262-284).  Materializes (B, N, S); intended for
    moderate graphs."""
    lhs = jnp.asarray(lhs)
    if lengths is None:
        lengths = jnp.full((lhs.shape[0],), lhs.shape[-2])
    lengths = jnp.minimum(jnp.asarray(lengths, dtype=jnp.int32), lhs.shape[-2])

    def single(cf, lhs, lengths):
        B, N, P = lhs.shape
        Sp = cf.padded_states
        Nf = N + 1
        lhs_tm = jnp.pad(jnp.moveaxis(lhs, 1, 0), ((0, Nf - N), (0, 0), (0, 0)))
        ts = jnp.arange(Nf, dtype=jnp.int32)
        fmv = _trop_matvec(cf, "fwd")
        bmv = _trop_matvec(cf, "bwd")
        elhs = _make_elhs(cf, lengths, trop=True)
        x0 = jnp.broadcast_to(cf.alpha_hat[:, None], (Sp, B))

        def fstep(carry, inp):
            x, shift = carry
            lhs_t, t = inp
            y, _ = fmv(x)
            y = jnp.where(t == 0, x, y)
            y = y + elhs(lhs_t, t)
            m = _colmax_safe(y)
            y = y - m[None, :]
            return (y, shift + m), (y, shift + m)

        (xF, shiftF), (A, ashift) = lax.scan(
            fstep, (x0, jnp.zeros(B, lhs.dtype)), (lhs_tm, ts)
        )
        score = jnp.take(xF, cf.final_state, axis=0) + shiftF

        def bstep(carry, inp):
            bb = carry
            a_t, as_t, lhs_t, t = inp
            y, _ = bmv(bb)
            y = jnp.where(t == Nf - 1, jnp.zeros_like(bb), y)
            gamma = a_t + as_t[None, :] + y - score[None, :]
            bb_new = y + elhs(lhs_t, t)
            return bb_new, gamma

        _, gammas = lax.scan(
            bstep,
            jnp.zeros((Sp, B), lhs.dtype),
            (A, ashift, lhs_tm, ts),
            reverse=True,
        )
        return jnp.moveaxis(gammas, 2, 0)[:, :N, :], score  # (B, N, Sp)

    if cf.batched:
        g, s = jax.vmap(lambda c, l, n: single(c, l[None], n[None]))(cf, lhs, lengths)
        return g[:, 0], s[:, 0]
    return single(cf, lhs, lengths)
