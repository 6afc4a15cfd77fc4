"""State-sharded forward-backward over a device mesh.

For LF-MMI denominator graphs too large to replicate (the 2M-arc regime),
states are range-partitioned across the 'model' mesh axis.  Per frame each
shard all-gathers the (small) state vector, applies its local slice
of T̂ᵀ (edges partitioned by destination state), and per-frame normalizers /
posterior reductions ride psum/pmax.  This replaces nothing in the reference
— the reference is single-GPU (SURVEY §5.8) — it is the scale-out
of the same recursion, composed with data parallelism over the 'data' axis.

Communication per frame: one all_gather of (S_total, B_local) f32
plus two scalar-sized pmax/psum for rescaling; the matvec itself is local.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import hostsparse as hs
from ..fsm import FSM
from ..inference import _Kernels, _fb_run
from ..ops import semiring_ops as sops

__all__ = [
    "ShardedFSM",
    "shard_compiled",
    "sharded_pdfposteriors",
    "sharded_logmarginal",
    "sharded_viterbi",
    "ShardedProbFSM",
    "shard_compiled_prob",
    "sharded_pdfposteriors_prob",
    "sharded_logmarginal_prob",
    "halo_report",
]

NEG_INF = -jnp.inf


def _round_up(x, m):
    return -(-x // m) * m


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "alpha",
        "state_pdf",
        "is_final",
        "fwd_gather",
        "fwd_seg",
        "fwd_w",
        "bwd_gather",
        "bwd_seg",
        "bwd_w",
    ],
    meta_fields=["num_shards", "local_states", "num_pdfs"],
)
@dataclasses.dataclass
class ShardedFSM:
    """Range-partitioned compiled FSM.  All array fields carry a leading
    shard axis (num_shards, ...); inside shard_map that axis is stripped."""

    alpha: jnp.ndarray  # (G, Sl) local α̂ slices, -inf padded
    state_pdf: jnp.ndarray  # (G, Sl) int32, padding -> num_pdfs
    is_final: jnp.ndarray  # (G, Sl) bool, True only at the phony final state
    # edges partitioned by destination (forward y = T̂ᵀ x):
    fwd_gather: jnp.ndarray  # (G, E) GLOBAL source state index
    fwd_seg: jnp.ndarray  # (G, E) LOCAL destination index (sorted)
    fwd_w: jnp.ndarray  # (G, E)
    # edges partitioned by source (backward y = T̂ x):
    bwd_gather: jnp.ndarray  # (G, E) GLOBAL destination index
    bwd_seg: jnp.ndarray  # (G, E) LOCAL source index (sorted)
    bwd_w: jnp.ndarray
    num_shards: int
    local_states: int
    num_pdfs: int

    @property
    def total_states(self) -> int:
        return self.num_shards * self.local_states


def shard_compiled(fsm: FSM, state_pdf, num_pdfs: int, num_shards: int,
                   *, dtype=jnp.float32) -> ShardedFSM:
    """Partition a host FSM's extended graph into ``num_shards`` contiguous
    state ranges."""
    state_pdf = np.asarray(state_pdf, dtype=np.int32)
    S1 = len(fsm.alpha_hat)
    Sl = _round_up(-(-S1 // num_shards), 8)
    St = Sl * num_shards

    alpha = np.full(St, -np.inf)
    alpha[:S1] = fsm.alpha_hat
    spdf = np.full(St, num_pdfs, dtype=np.int32)
    spdf[:S1] = state_pdf
    isf = np.zeros(St, dtype=bool)
    isf[S1 - 1] = True

    rows, cols, data = hs.findnz(fsm.T_hat)
    E = len(rows)

    def partition(gather_g, seg_g, w):
        """Partition edges by seg shard; returns (G, Emax) arrays."""
        shard_of = seg_g // Sl
        locals_ = seg_g % Sl
        per = [np.flatnonzero(shard_of == g) for g in range(num_shards)]
        Emax = max(_round_up(max((len(p) for p in per), default=0), 8), 8)
        G = np.zeros((num_shards, Emax), dtype=np.int32)
        Sg = np.full((num_shards, Emax), Sl - 1, dtype=np.int32)
        W = np.full((num_shards, Emax), -np.inf)
        for g, idx in enumerate(per):
            order = np.argsort(locals_[idx], kind="stable")
            idx = idx[order]
            G[g, : len(idx)] = gather_g[idx]
            Sg[g, : len(idx)] = locals_[idx]
            W[g, : len(idx)] = w[idx]
        return G, Sg, W

    fg, fs, fw = partition(rows.astype(np.int64), cols.astype(np.int64), data)
    bg, bs, bw = partition(cols.astype(np.int64), rows.astype(np.int64), data)

    return ShardedFSM(
        alpha=jnp.asarray(alpha.reshape(num_shards, Sl), dtype=dtype),
        state_pdf=jnp.asarray(spdf.reshape(num_shards, Sl)),
        is_final=jnp.asarray(isf.reshape(num_shards, Sl)),
        fwd_gather=jnp.asarray(fg),
        fwd_seg=jnp.asarray(fs),
        fwd_w=jnp.asarray(fw, dtype=dtype),
        bwd_gather=jnp.asarray(bg),
        bwd_seg=jnp.asarray(bs),
        bwd_w=jnp.asarray(bw, dtype=dtype),
        num_shards=num_shards,
        local_states=Sl,
        num_pdfs=int(num_pdfs),
    )


def _local_kernels(sf_local, lengths, axis: str) -> _Kernels:
    """Kernel bundle for one shard (arrays without the shard axis), with the
    cross-shard collectives baked in."""
    Sl = sf_local.alpha.shape[0]
    is_ph = sf_local.is_final[:, None]
    P1 = sf_local.num_pdfs + 1

    def gathered_mv(gather, seg, w):
        def mv(x_loc):
            x_full = lax.all_gather(x_loc, axis, axis=0, tiled=True)
            return sops.segment_matvec(gather, seg, w, x_full, Sl)

        return mv

    def elhs(lhs_t, t):
        lhs_ext = jnp.concatenate(
            [lhs_t.T, jnp.full((1, lhs_t.shape[0]), NEG_INF, lhs_t.dtype)],
            axis=0,
        )
        x = lhs_ext[sf_local.state_pdf, :]
        active = (t < lengths)[None, :]
        return jnp.where(active, x, jnp.where(is_ph, 0.0, NEG_INF))

    def colmax(y):
        m = lax.pmax(jnp.max(y, axis=0), axis)
        return jnp.where(jnp.isfinite(m), m, 0.0)

    def pdf_posts(gamma):
        g_loc = sops.segment_logsumexp(gamma, sf_local.state_pdf, P1)
        m = lax.pmax(g_loc, axis)
        ms = jnp.where(jnp.isfinite(m), m, 0.0)
        s = lax.psum(jnp.exp(g_loc - ms), axis)
        gpdf = jnp.where(s > 0, jnp.log(s) + ms, NEG_INF)
        norm = sops.masked_logsumexp(gpdf, axis=0)
        return jnp.exp(gpdf - jnp.where(jnp.isfinite(norm), norm, 0.0)[None, :])

    def final_val(x, shift):
        v = jnp.max(jnp.where(is_ph, x, NEG_INF), axis=0)
        return lax.pmax(v, axis) + shift

    return _Kernels(
        alpha0=sf_local.alpha,
        fwd_mv=gathered_mv(sf_local.fwd_gather, sf_local.fwd_seg, sf_local.fwd_w),
        bwd_mv=gathered_mv(sf_local.bwd_gather, sf_local.bwd_seg, sf_local.bwd_w),
        elhs=elhs,
        colmax=colmax,
        pdf_posts=pdf_posts,
        final_val=final_val,
    )


def sharded_pdfposteriors(
    sf: ShardedFSM,
    lhs,
    lengths=None,
    *,
    mesh: Mesh,
    model_axis: str = "model",
    data_axis: str | None = "data",
    chunk_size: int = 64,
):
    """Forward-backward posteriors with the graph state-sharded over
    ``model_axis`` and the batch optionally sharded over ``data_axis``.

    Returns (posteriors (B, N, P), logZ (B,)) with batch sharded over the
    data axis.
    """
    lhs = jnp.asarray(lhs)
    if lengths is None:
        lengths = jnp.full((lhs.shape[0],), lhs.shape[-2])
    lengths = jnp.minimum(jnp.asarray(lengths, dtype=jnp.int32), lhs.shape[-2])

    dspec = P(data_axis) if data_axis else P()

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            jax.tree.map(lambda _: P(model_axis), sf),
            dspec,
            dspec,
        ),
        out_specs=(dspec, dspec),
        check_vma=False,
    )
    def run(sf_local, lhs_l, len_l):
        sf_local = jax.tree.map(
            lambda x: x[0] if hasattr(x, "ndim") else x, sf_local
        )
        kern = _local_kernels(sf_local, len_l, model_axis)
        posts, logZ = _fb_run(
            kern, lhs_l, len_l, chunk_size, True, sf.num_pdfs
        )
        return posts, logZ

    return run(sf, lhs, lengths)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "alpha",
        "state_pdf",
        "is_final",
        "fwd_send",
        "fwd_gpos",
        "fwd_seg",
        "fwd_w",
        "bwd_send",
        "bwd_gpos",
        "bwd_seg",
        "bwd_w",
    ],
    meta_fields=["num_shards", "local_states", "num_pdfs", "fwd_halo",
                 "bwd_halo", "fwd_halo_counts", "bwd_halo_counts"],
)
@dataclasses.dataclass
class ShardedProbFSM:
    """Probability-domain range-partitioned FSM with a **static halo-exchange
    plan** (the fast sharded path).

    Per frame the log-domain path (``ShardedFSM``) all-gathers the full
    (S_total, B) state matrix; here each shard instead sends only the state
    rows its peers actually reference (the union of remote sources of their
    edges — computed at compile time) via one ``all_to_all``, cutting per-
    frame exchange traffic from S_total·B to 2·G·halo·B.  The matvec itself is a
    probability-domain multiply + segment-sum (no per-edge logsumexp), and
    the scan skeleton (chunked checkpointing, exact power-of-two rescaling)
    is shared with the single-device fast path (inference._fbp_run)."""

    alpha: jnp.ndarray  # (G, Sl) local exp(α̂), 0 padded
    state_pdf: jnp.ndarray  # (G, Sl) int32, padding -> num_pdfs
    is_final: jnp.ndarray  # (G, Sl) bool
    # forward (edges partitioned by destination shard):
    fwd_send: jnp.ndarray  # (G, G, M) LOCAL rows this shard sends to peer g
    fwd_gpos: jnp.ndarray  # (G, E) gather position into the (G·M) recv buf
    fwd_seg: jnp.ndarray  # (G, E) LOCAL destination (sorted)
    fwd_w: jnp.ndarray  # (G, E) probabilities
    # backward (edges partitioned by source shard):
    bwd_send: jnp.ndarray
    bwd_gpos: jnp.ndarray
    bwd_seg: jnp.ndarray
    bwd_w: jnp.ndarray
    num_shards: int
    local_states: int
    num_pdfs: int
    fwd_halo: int
    bwd_halo: int
    # achieved (unpadded) halo sizes: entry [h][g] = rows shard h actually
    # sends to shard g (the all_to_all pads every pair to fwd_halo/bwd_halo)
    fwd_halo_counts: tuple = ()
    bwd_halo_counts: tuple = ()


def lm_hmm_assignment(V: int, hmm_states: int, num_shards: int) -> np.ndarray:
    """Graph-aware shard assignment for LM ∘ HMM graphs in the plane-major
    layout of workloads.make_lm_hmm_graph (state(h, k) = k·H + h, phony
    final last): shard of state (h, k) = h // ceil(H/G).

    All HMM-internal band arcs (self-loops, chain (h,k)→(h,k+1)) connect
    states of the SAME history h, so they become shard-local; only the
    cross-HMM n-gram arcs exchange halos — and each destination shard's
    predecessor exits are strided evenly across the peers, so the per-pair
    halo shrinks to ~H/G² instead of the contiguous partition's full Sl
    (where the chain band made some peer export its entire range, and the
    all_to_all's uniform padding then matched all_gather traffic).

    Returns shard_of (S1,) for S1 = hmm_states·V² + 1.
    """
    H = V * V
    K = hmm_states
    Hg = -(-H // num_shards)
    h = np.tile(np.arange(H), K)
    shard_of = np.empty(K * H + 1, dtype=np.int64)
    shard_of[: K * H] = h // Hg
    shard_of[K * H] = num_shards - 1  # phony final
    return shard_of


def shard_compiled_prob(fsm: FSM, state_pdf, num_pdfs: int, num_shards: int,
                        *, shard_of=None, dtype=jnp.float32) -> ShardedProbFSM:
    """Partition a host FSM into ``num_shards`` state sets with per-direction
    halo-exchange plans.

    ``shard_of``: optional (S1,) state→shard assignment (e.g.
    lm_hmm_assignment — band arcs shard-local, minimal halos).  Defaults to
    contiguous ranges.  The assignment is purely internal: posteriors/logZ
    are in pdf space and unaffected.
    """
    state_pdf = np.asarray(state_pdf, dtype=np.int32)
    S1 = len(fsm.alpha_hat)
    G = num_shards
    if shard_of is None:
        Sl0 = -(-S1 // G)
        shard_of = np.minimum(np.arange(S1) // Sl0, G - 1)
    else:
        shard_of = np.asarray(shard_of, dtype=np.int64)
        assert len(shard_of) == S1 and shard_of.max() < G
    # local index: rank within the shard (stable order by global id)
    counts_per = np.bincount(shard_of, minlength=G)
    Sl = _round_up(int(counts_per.max()), 8)
    local_of = np.empty(S1, dtype=np.int64)
    for g in range(G):
        m = shard_of == g
        local_of[m] = np.arange(m.sum())

    rows, cols, data = hs.findnz(fsm.T_hat)
    w = np.exp(np.asarray(data, dtype=np.float64))

    def plan(gather_g, seg_g, wv):
        """Partition edges by the shard owning ``seg``; build the halo.

        Shard-local sources (owner of src == owner of dst) are gathered
        straight from the local state slice — they never enter the
        all_to_all, so the uniform halo pad M is set by the largest
        OFF-diagonal exchange only (a graph-aware ``shard_of`` makes the
        dominant band arcs local, shrinking M from ~Sl to the true
        cross-shard neighborhood)."""
        sseg, lseg = shard_of[seg_g], local_of[seg_g]
        sgat, lgat = shard_of[gather_g], local_of[gather_g]
        per = [np.flatnonzero(sseg == g) for g in range(G)]
        # halo: rows_hg = local source rows shard g needs from shard h≠g
        rows_hg = [[None] * G for _ in range(G)]
        M = 1
        for g, idx in enumerate(per):
            for h in range(G):
                if h == g:
                    rows_hg[h][g] = np.array([], dtype=np.int64)
                    continue
                sel = np.unique(lgat[idx][sgat[idx] == h])
                rows_hg[h][g] = sel
                M = max(M, len(sel))
        M = _round_up(M, 8)
        send = np.zeros((G, G, M), dtype=np.int32)
        for h in range(G):
            for g in range(G):
                send[h, g, : len(rows_hg[h][g])] = rows_hg[h][g]
        Emax = max(_round_up(max((len(p) for p in per), default=0), 8), 8)
        gpos = np.zeros((G, Emax), dtype=np.int32)
        seg = np.full((G, Emax), Sl - 1, dtype=np.int32)
        ww = np.zeros((G, Emax))
        for g, idx in enumerate(per):
            order = np.argsort(lseg[idx], kind="stable")
            idx = idx[order]
            h, gl = sgat[idx], lgat[idx]
            # gather buffer = concat(x_loc (Sl rows), recv (G·M rows)):
            # local edges index [0, Sl); remote Sl + h·M + rank in rows_hg
            pos = np.empty(len(idx), dtype=np.int64)
            for hh in range(G):
                m = h == hh
                if hh == g:
                    pos[m] = gl[m]
                else:
                    pos[m] = Sl + hh * M + np.searchsorted(
                        rows_hg[hh][g], gl[m]
                    )
            gpos[g, : len(idx)] = pos
            seg[g, : len(idx)] = lseg[idx]
            ww[g, : len(idx)] = wv[idx]
        counts = tuple(
            tuple(len(rows_hg[h][g]) for g in range(G)) for h in range(G)
        )
        return send, gpos, seg, ww, M, counts

    r64, c64 = rows.astype(np.int64), cols.astype(np.int64)
    fs, fg, fseg, fw, Mf, fcnt = plan(r64, c64, w)
    bs, bg, bseg, bw, Mb, bcnt = plan(c64, r64, w)

    alpha = np.zeros((G, Sl))
    alpha[shard_of, local_of] = np.exp(
        np.asarray(fsm.alpha_hat, dtype=np.float64)
    )
    spdf = np.full((G, Sl), num_pdfs, dtype=np.int32)
    spdf[shard_of, local_of] = state_pdf
    isf = np.zeros((G, Sl), dtype=bool)
    isf[shard_of[S1 - 1], local_of[S1 - 1]] = True

    return ShardedProbFSM(
        alpha=jnp.asarray(alpha, dtype=dtype),
        state_pdf=jnp.asarray(spdf),
        is_final=jnp.asarray(isf),
        fwd_send=jnp.asarray(fs),
        fwd_gpos=jnp.asarray(fg),
        fwd_seg=jnp.asarray(fseg),
        fwd_w=jnp.asarray(fw, dtype=dtype),
        bwd_send=jnp.asarray(bs),
        bwd_gpos=jnp.asarray(bg),
        bwd_seg=jnp.asarray(bseg),
        bwd_w=jnp.asarray(bw, dtype=dtype),
        num_shards=G,
        local_states=Sl,
        num_pdfs=int(num_pdfs),
        fwd_halo=Mf,
        bwd_halo=Mb,
        fwd_halo_counts=fcnt,
        bwd_halo_counts=bcnt,
    )


def halo_report(sf: ShardedProbFSM) -> dict:
    """Per-frame exchange traffic of the static halo plan vs the log path's
    all_gather, in f32 rows per device (multiply by 4·B for bytes).

    ``sent`` counts the padded all_to_all payload a device actually puts on
    the wire ((G-1)·halo rows per direction — self-slots never leave the
    chip); ``useful`` the achieved (unpadded) halo rows; ``allgather`` the
    rows the log-domain path receives per device ((G-1)·Sl per direction).
    ``ratio`` = sent / allgather (< 1 means the halo plan wins even with
    max-padding)."""
    G, Sl = sf.num_shards, sf.local_states
    sent = (G - 1) * (sf.fwd_halo + sf.bwd_halo)
    useful = sum(
        cnt[h][g]
        for cnt in (sf.fwd_halo_counts, sf.bwd_halo_counts)
        for h in range(G)
        for g in range(G)
        if h != g
    ) // max(G, 1)
    allgather = 2 * (G - 1) * Sl
    return dict(
        num_shards=G,
        fwd_halo=sf.fwd_halo,
        bwd_halo=sf.bwd_halo,
        sent_rows=sent,
        useful_rows_avg=useful,
        allgather_rows=allgather,
        ratio=sent / allgather if allgather else 0.0,
    )


def sharded_pdfposteriors_prob(
    sf: ShardedProbFSM,
    lhs,
    lengths=None,
    *,
    mesh: Mesh,
    model_axis: str = "model",
    data_axis: str | None = "data",
    chunk_size: int = 64,
):
    """Probability-domain state-sharded forward-backward with halo exchange
    (the fast sharded path; exchange traffic 2·G·halo·B per frame instead of the
    log path's S_total·B all_gather).  Returns (posts (B, N, P), logZ (B,))."""
    from ..inference import _ProbKernels, _combine_shift, _fbp_run

    lhs = jnp.asarray(lhs)
    if lengths is None:
        lengths = jnp.full((lhs.shape[0],), lhs.shape[-2])
    lengths = jnp.minimum(jnp.asarray(lengths, dtype=jnp.int32), lhs.shape[-2])
    dspec = P(data_axis) if data_axis else P()
    P1 = sf.num_pdfs + 1

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(model_axis), sf), dspec, dspec),
        out_specs=(dspec, dspec),
        check_vma=False,
    )
    def run(sf_l, lhs_l, len_l):
        sf_l = jax.tree.map(lambda x: x[0] if hasattr(x, "ndim") else x, sf_l)
        Sl = sf_l.alpha.shape[0]
        Bl = lhs_l.shape[0]
        is_ph = sf_l.is_final[:, None]

        def halo_mv(send, gpos, seg, w, halo):
            def mv(x_loc):
                buf = x_loc[send.reshape(-1)].reshape(
                    sf.num_shards, halo, Bl
                )
                recv = lax.all_to_all(
                    buf, model_axis, split_axis=0, concat_axis=0, tiled=False
                )
                # gather buffer = [local rows | received halo rows]: shard-
                # local edges read x_loc directly (gpos < Sl), so the halo
                # pad is set by the largest off-diagonal exchange only
                xg = jnp.concatenate(
                    [x_loc, recv.reshape(sf.num_shards * halo, Bl)], axis=0
                )
                contrib = w[:, None] * xg[gpos]
                return jax.ops.segment_sum(
                    contrib, seg, Sl, indices_are_sorted=True
                )

            return mv

        def eprob(lhs_t, t):
            active = t < len_l
            m_l = jnp.max(lhs_t, axis=1)
            el = jnp.exp(lhs_t - m_l[:, None])
            ext = jnp.concatenate(
                [el.T * active[None, :],
                 jnp.where(active, 0.0, 1.0)[None, :]], axis=0
            )
            x = ext[sf_l.state_pdf, :]
            x = jnp.where(active[None, :], x, jnp.where(is_ph, 1.0, 0.0))
            return x, jnp.where(active, m_l, 0.0)

        def pdf_reduce(gamma):
            s = lax.psum(
                jax.ops.segment_sum(gamma, sf_l.state_pdf, P1), model_axis
            )
            return s, jnp.sum(s, axis=0)

        def final_val(a, ksum, shift):
            v = lax.psum(
                jnp.sum(jnp.where(is_ph, a, 0.0), axis=0), model_axis
            )
            return _combine_shift(
                jnp.where(v > 0, jnp.log(jnp.maximum(v, 1e-38)), NEG_INF),
                ksum,
                shift,
            )

        kern = _ProbKernels(
            alpha0=sf_l.alpha,
            fwd_pmv=halo_mv(sf_l.fwd_send, sf_l.fwd_gpos, sf_l.fwd_seg,
                            sf_l.fwd_w, sf.fwd_halo),
            bwd_pmv=halo_mv(sf_l.bwd_send, sf_l.bwd_gpos, sf_l.bwd_seg,
                            sf_l.bwd_w, sf.bwd_halo),
            eprob=eprob,
            colmax=lambda y: lax.pmax(jnp.max(y, axis=0), model_axis),
            pdf_reduce=pdf_reduce,
            final_val=final_val,
        )
        return _fbp_run(kern, lhs_l, len_l, chunk_size, True, sf.num_pdfs)

    return run(sf, lhs, lengths)


def sharded_viterbi(
    sf: ShardedFSM,
    lhs,
    lengths=None,
    *,
    mesh: Mesh,
    model_axis: str = "model",
    data_axis: str | None = "data",
):
    """State-sharded Viterbi decode (BASELINE config 5; the reference's
    Viterbi is single-device and disabled, src/MarkovModels.jl:56-57).

    Forward: tropical recursion inside ``shard_map`` — per frame one
    all_gather of the state vector, then each shard max-reduces its
    local destination rows (edges are partitioned by destination, so the
    shard owning a state resolves that state's **exact global argmax** and
    records the global source id as its backpointer; no cross-shard argmax
    merge is needed).  Backtrace: the current state id is replicated; the
    owning shard looks up its local backpointer and the result is exchanged
    with a ``pmax`` over the model axis (non-owners contribute -1).

    Returns (states (B, N) int32 global state ids, score (B,)).
    """
    lhs = jnp.asarray(lhs)
    B, N, _ = lhs.shape
    if lengths is None:
        lengths = jnp.full((B,), N)
    lengths = jnp.minimum(jnp.asarray(lengths, dtype=jnp.int32), N)
    dspec = P(data_axis) if data_axis else P()

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(model_axis), sf), dspec, dspec),
        out_specs=(dspec, dspec),
        check_vma=False,
    )
    def run(sf_local, lhs_l, len_l):
        sf_local = jax.tree.map(
            lambda x: x[0] if hasattr(x, "ndim") else x, sf_local
        )
        Sl = sf_local.alpha.shape[0]
        Bl = lhs_l.shape[0]
        Nf = N + 1
        is_ph = sf_local.is_final[:, None]
        my = lax.axis_index(model_axis)
        offset = my * Sl

        lhs_tm = jnp.pad(
            jnp.moveaxis(lhs_l, 1, 0), ((0, Nf - N), (0, 0), (0, 0))
        )
        ts = jnp.arange(Nf, dtype=jnp.int32)

        def elhs(lhs_t, t):
            lhs_ext = jnp.concatenate(
                [lhs_t.T, jnp.full((1, Bl), NEG_INF, lhs_t.dtype)], axis=0
            )
            x = lhs_ext[sf_local.state_pdf, :]
            active = (t < len_l)[None, :]
            return jnp.where(active, x, jnp.where(is_ph, 0.0, NEG_INF))

        own_ids = (offset + jnp.arange(Sl, dtype=jnp.int32))[:, None]

        def fstep(carry, inp):
            x, shift = carry
            lhs_t, t = inp
            x_full = lax.all_gather(x, model_axis, axis=0, tiled=True)
            y, bp = sops.segment_matvec(
                sf_local.fwd_gather, sf_local.fwd_seg, sf_local.fwd_w,
                x_full, Sl, op="max",
            )
            y = jnp.where(t == 0, x, y)
            bp = jnp.where(t == 0, jnp.broadcast_to(own_ids, bp.shape), bp)
            y = y + elhs(lhs_t, t)
            m = lax.pmax(jnp.max(y, axis=0), model_axis)
            m = jnp.where(jnp.isfinite(m), m, 0.0)
            return (y - m[None, :], shift + m), bp

        x0 = jnp.broadcast_to(sf_local.alpha[:, None], (Sl, Bl)).astype(
            lhs_l.dtype
        )
        (xF, shiftF), bps = lax.scan(
            fstep, (x0, jnp.zeros(Bl, lhs_l.dtype)), (lhs_tm, ts)
        )
        v = jnp.max(jnp.where(is_ph, xF, NEG_INF), axis=0)
        score = lax.pmax(v, model_axis) + shiftF

        # global phony-final id: the only True entry of is_final
        fin_loc = jnp.argmax(
            jnp.max(sf_local.is_final[:, None], axis=1)
        ).astype(jnp.int32)
        has_fin = jnp.any(sf_local.is_final)
        fin_global = lax.pmax(
            jnp.where(has_fin, offset + fin_loc, -1), model_axis
        )

        bcol = jnp.arange(Bl)

        def btrace(s, bp_t):
            loc = s - offset
            inb = (loc >= 0) & (loc < Sl)
            cand = jnp.where(
                inb, bp_t[jnp.clip(loc, 0, Sl - 1), bcol], -1
            )
            s_new = lax.pmax(cand, model_axis)
            return s_new, s_new

        s_last = jnp.broadcast_to(fin_global, (Bl,)).astype(jnp.int32)
        _, states = lax.scan(btrace, s_last, bps[1:], reverse=True)
        return jnp.moveaxis(states, 1, 0), score  # (Bl, N)

    return run(sf, lhs, lengths)


def sharded_logmarginal(
    sf: ShardedFSM,
    lhs,
    lengths=None,
    *,
    mesh: Mesh,
    model_axis: str = "model",
    data_axis: str | None = "data",
    chunk_size: int = 64,
):
    """Differentiable sharded total log-marginal (gradient = posteriors),
    same surrogate construction as inference.logmarginal."""
    from ..inference import _stop_gradient_floats

    lhs = jnp.asarray(lhs)
    lhs_sg = lax.stop_gradient(lhs)
    posts, logZ = sharded_pdfposteriors(
        _stop_gradient_floats(sf),
        lhs_sg,
        lengths,
        mesh=mesh,
        model_axis=model_axis,
        data_axis=data_axis,
        chunk_size=chunk_size,
    )
    surr = jnp.einsum("bnp,bnp->b", posts, lhs - lhs_sg)
    return logZ + surr


def sharded_logmarginal_prob(
    sf: ShardedProbFSM,
    lhs,
    lengths=None,
    *,
    mesh: Mesh,
    model_axis: str = "model",
    data_axis: str | None = "data",
    chunk_size: int = 64,
):
    """Differentiable total log-marginal over the **fast** sharded path
    (probability domain + static halo exchange, sharded_pdfposteriors_prob):
    gradient w.r.t. ``lhs`` = pdf posteriors, via the same first-order
    surrogate as inference.logmarginal (the posterior-form gradient is exact
    for the log-marginal of a linear emission model)."""
    from ..inference import _stop_gradient_floats

    lhs = jnp.asarray(lhs)
    lhs_sg = lax.stop_gradient(lhs)
    posts, logZ = sharded_pdfposteriors_prob(
        _stop_gradient_floats(sf),
        lhs_sg,
        lengths,
        mesh=mesh,
        model_axis=model_axis,
        data_axis=data_axis,
        chunk_size=chunk_size,
    )
    surr = jnp.einsum("bnp,bnp->b", posts, lhs - lhs_sg)
    return logZ + surr
