"""Device-side inference: compiled FSMs, forward-backward, LF-MMI scoring.

A re-design of the reference's inference runtime
(reference src/inference.jl):

* ``compile`` lowers a host ``FSM`` to jit-stable padded arrays — the analog
  of ``CompiledFSM``/``adapt(CuArray, ...)`` (src/inference.jl:3-26) but as a
  JAX pytree: COO edge lists sorted by destination/source (both directions
  stored, like the reference caching T̂ and T̂ᵀ, CHANGELOG 0.10), optional ELL
  incoming-arc lists, and an optional dense matmul operator.
* the time recursion is a ``lax.scan`` whose body is a semiring matvec
  (ops/semiring_ops.py), replacing the reference's per-frame CUDA SpMV loop
  (src/inference.jl:62-110); ragged batches use the same phony-final-state
  ``expand`` trick (src/inference.jl:38-60) expressed as per-frame masking,
  so every shape is static.
* the backward pass is fused with posterior accumulation (the reference's
  ``βrecursion_mulα!`` memory optimization, src/inference.jl:131-143) and the
  forward pass is chunk-checkpointed: only chunk-boundary α states are kept
  and interior frames are recomputed during the β sweep, bounding memory at
  O(S·B·(chunk + N/chunk)) instead of O(S·B·N).
* batching: a *shared* graph (LF-MMI denominator) keeps one compiled graph
  and a (S, B) state matrix — the batch-axis form of the reference's
  blockdiag-of-identical-graphs batching (misc/benchmark/benchmark.jl:20);
  heterogeneous per-utterance graphs are stacked/padded and vmapped
  (``stack``), the padded-stack form of ``rawunion``/``batch``
  (src/fsmops.jl:28-36, src/inference.jl:28-36).

Scans rescale per frame (running-max subtraction) so bf16/f32 stay in range
for arbitrarily long sequences; the reference relies on log-domain
self-normalization instead (no rescaling), which f32 tolerates only for
moderate N.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from . import hostsparse as hs
from .fsm import FSM
from .ops import semiring_ops as sops

__all__ = [
    "CompiledFSM",
    "compile_fsm",
    "compile",
    "stack",
    "batch",
    "statemap_to_indices",
    "expand",
    "alpha_recursion",
    "beta_recursion",
    "pdfposteriors",
    "forward",
    "logmarginal",
    "lfmmi_loss",
    "fast_path_report",
]

NEG_INF = -jnp.inf


def _round_up(x, m):
    return -(-x // m) * m


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "alpha_hat",
        "final_state",
        "state_pdf",
        "fwd_src",
        "fwd_dst",
        "fwd_w",
        "bwd_src",
        "bwd_dst",
        "bwd_w",
        "ell_fwd_src",
        "ell_fwd_w",
        "ell_bwd_src",
        "ell_bwd_w",
        "dense_fwd_exp",
        "dense_fwd_max",
        "dense_bwd_exp",
        "dense_bwd_max",
        "pdf_onehot",
        "block_fwd",
        "block_bwd",
        "omega_prob",
        "orig_state",
        "banded_fwd",
        "banded_bwd",
    ],
    meta_fields=[
        "num_states",
        "num_pdfs",
        "strategy",
        "batched",
        "precision",
        "domain",
        "block_fwd_offsets",
        "block_bwd_offsets",
        "pdf_group",
        "multi_pdf",
        "ov_layout",
        "banded_offsets",
    ],
)
@dataclasses.dataclass
class CompiledFSM:
    """Device representation of one FSM (or a stacked batch of FSMs).

    Shapes below are for a single graph (``batched=False``); a stacked batch
    adds a leading graph axis to every array field.  ``Sp``/``Ep`` are the
    padded state/edge counts; real states/edges come first, padding edges
    carry weight -inf and point at the last padded state.
    """

    # (Sp,) log-domain initial weights of the extended graph [α; zero]
    alpha_hat: jnp.ndarray
    # scalar int32 — index of the phony final state (= num_states - 1)
    final_state: jnp.ndarray
    # (Sp,) int32 — pdf index per state; phony & padding -> num_pdfs
    state_pdf: jnp.ndarray
    # COO edges of T̂ sorted by destination (for y = T̂ᵀ x)
    fwd_src: jnp.ndarray
    fwd_dst: jnp.ndarray
    fwd_w: jnp.ndarray
    # COO edges of T̂ sorted by source (for y = T̂ x); gather=dst, segment=src
    bwd_src: jnp.ndarray
    bwd_dst: jnp.ndarray
    bwd_w: jnp.ndarray
    # optional ELL incoming/outgoing arc lists (S, D)
    ell_fwd_src: Optional[jnp.ndarray]
    ell_fwd_w: Optional[jnp.ndarray]
    ell_bwd_src: Optional[jnp.ndarray]
    ell_bwd_w: Optional[jnp.ndarray]
    # optional dense matmul operators (exp-shifted) (Sp, Sp) + row maxima (Sp,)
    dense_fwd_exp: Optional[jnp.ndarray]
    dense_fwd_max: Optional[jnp.ndarray]
    dense_bwd_exp: Optional[jnp.ndarray]
    dense_bwd_max: Optional[jnp.ndarray]
    # optional one-hot Ĉᵀ (P+1, Sp) for the matmul pdf-posterior reduction
    pdf_onehot: Optional[jnp.ndarray]
    # optional blocked gather-matmul-scatter operators (ops/blocked.py)
    block_fwd: Optional[object]
    block_bwd: Optional[object]
    # rank-1 split of the extended final column (block strategy): (Sp,)
    # probabilities exp(T̂[:, fin]) with omega_prob[fin] = 1.  The block
    # operators then cover only the S×S core — the reference's ω is the
    # extended matrix's last column (src/fsm.jl:19-28); handling it
    # analytically keeps every block op scatter-free.
    omega_prob: Optional[jnp.ndarray] = None
    # (Sp,) int32 original state id per (possibly reordered) slot; -1 padding
    orig_state: Optional[jnp.ndarray] = None
    # 'banded' strategy (linear/low-bandwidth graphs, e.g. LF-MMI numerator
    # lattices — 2-band self+chain matrices, reference LinearFSM
    # examples/prepare-lfmmi-graphs.jl:25-65): per-offset arc probabilities,
    # (nO, Sp) dst-indexed (fwd) / src-indexed (bwd); the per-frame matvec
    # is nO shifted elementwise multiply-adds — no matmul at all, so a
    # STACKED batch of numerators costs O(G·nO·Sp) per frame instead of
    # the vmapped dense path's O(G·Sp²)
    banded_fwd: Optional[jnp.ndarray] = None
    banded_bwd: Optional[jnp.ndarray] = None
    # static metadata
    num_states: int = 0  # actual S+1 (incl. phony, excl. padding)
    num_pdfs: int = 0  # number of real pdfs P (phony pdf id = P)
    strategy: str = "segment"  # 'dense' | 'ell' | 'segment' | 'block'
    batched: bool = False
    precision: str = "high"  # dense-matmul precision: 'bf16' | 'high' | 'f32'
    # dense-scan value domain: 'prob' (rescaled probabilities, fastest) or
    # 'log' (logsumexp per frame, marginally tighter at precision='f32')
    domain: str = "prob"
    block_fwd_offsets: tuple = ()
    block_bwd_offsets: tuple = ()
    # pdf-grouped uniform state layout: (cmax, lim) when every pdf p owns
    # slot range [p*cmax, (p+1)*cmax) and lim = (P+1)*cmax; emission
    # expansion is then a broadcast and the pdf-posterior reduction a
    # reshape-sum (no state→pdf gather/one-hot matmul on the hot path)
    pdf_group: tuple = ()
    # general Ĉ mode: states may emit several pdfs (Ĉ an arbitrary binary
    # sparse matrix, reference src/inference.jl:7-8); emission expansion and
    # posterior reduction both run through the binary pdf_onehot matmuls
    multi_pdf: bool = False
    # capped pdf-grouped layout with an overflow region: (cap, nOv) when
    # real pdf p owns slots [p*cap, (p+1)*cap) and the states beyond each
    # pdf's first ``cap`` (e.g. a backoff LM's backoff states, which share
    # their pdfs with V history states) sit in nOv extra cap-wide
    # lane-groups at [P*cap, P*cap + nOv*cap), host-order, with per-LANE
    # pdfs (state_pdf holds them); the phony final state follows at
    # P*cap + nOv*cap.  pdf_group is () in this mode — the scans use the
    # general state_pdf gather/scatter.
    ov_layout: tuple = ()
    # arc offsets (dst - src) of the 'banded' strategy, sorted
    banded_offsets: tuple = ()

    @property
    def padded_states(self) -> int:
        return self.alpha_hat.shape[-1]


def statemap_to_indices(C: hs.SpMat) -> np.ndarray:
    """Convert a binary state→pdf matrix Ĉ (one nz per row, reference
    examples/prepare-lfmmi-graphs.jl:15-23) to an int index vector.

    For Ĉ with several pdfs per state pass the matrix straight to
    :func:`compile_fsm`, which compiles it in general-Ĉ mode."""
    counts = np.diff(C.indptr)
    if not (counts == 1).all():
        raise ValueError(
            "Ĉ has states with multiple pdfs — pass the matrix directly to "
            "compile_fsm (general-Ĉ mode) instead of converting to indices"
        )
    return C.indices.astype(np.int32)


def compile_fsm(
    fsm: FSM,
    state_pdf,
    num_pdfs: int,
    *,
    strategy: str = "auto",
    dtype=jnp.float32,
    precision: str = "high",
    domain: str = "prob",
    reorder: str = "auto",
    ov_cap: int | None = None,
) -> CompiledFSM:
    """Lower a host FSM to the device representation.

    ``state_pdf``: int array of length ``num_states + 1`` mapping each state
    (including the phony final state) to a pdf id in [0, num_pdfs]; the phony
    state must map to ``num_pdfs`` (the phony pdf row of the reference's
    expanded likelihoods, src/inference.jl:54-60).  A binary ``hostsparse``
    Ĉ matrix is also accepted.

    ``reorder``: 'pdf' renumbers states into a uniform pdf-grouped layout
    (pdf p owns slots [p*cmax, (p+1)*cmax)); 'auto' does so for the 'block'
    strategy when the padding inflation is acceptable; 'none' keeps the host
    order.  Reordering changes only the internal state numbering — pdf
    posteriors/logZ are unaffected; state-indexed outputs (Viterbi paths,
    alpha/beta messages) are reported in the compiled numbering, with
    ``orig_state`` mapping slots back to host state ids.

    ``ov_cap``: cap on the per-pdf slot count of the reordered layout.
    When some pdf owns more states than the cap (e.g. a *separate-state*
    backoff LM ∘ HMM graph, where pdf (b, k) is shared by the V histories
    (·, b) AND the backoff state B(b) — the reference pipeline's own graph
    shape, reference examples/prepare-lfmmi-graphs.jl:218-223), the states
    beyond the first ``cap`` per pdf move to an *overflow* region of extra
    cap-wide lane-groups (host order, per-lane pdfs) instead of inflating
    cmax to a lane-misaligned V+1.  Their arcs compile into structured
    overflow families (ops/blocked.py) applied as slab ops, keeping the
    whole operator affine.  Default
    (None) auto-caps at the largest multiple of 128 below cmax whenever
    cmax > 128 and is not lane-aligned; pass an explicit cap to force the
    layout (tests use small caps).
    """
    S1 = len(fsm.alpha_hat)
    C_multi = None
    if isinstance(state_pdf, hs.SpMat):
        counts = np.diff(state_pdf.indptr)
        # index fast path only for exactly-one-pdf-per-state maps; a Ĉ with
        # an empty row (state emitting no pdf) goes through general-Ĉ mode
        # (statemap_to_indices would reject it with a misleading error
        # telling the caller to pass the matrix — which they just did)
        if (counts == 1).all():
            state_pdf = statemap_to_indices(state_pdf)
        else:
            # general-Ĉ mode (reference src/inference.jl:7-8): emission
            # expansion Ĉ·V̂ and the posterior reduction Ĉᵀ·(A⊙B) run
            # through the binary pdf_onehot matmuls instead of gathers
            C_multi = state_pdf
            if C_multi.shape != (S1, num_pdfs + 1):
                raise ValueError(
                    f"general Ĉ must have shape ({S1}, {num_pdfs + 1})"
                )
            # representative pdf per state for metadata; hot paths never
            # read it in multi mode (empty rows -> phony pdf)
            rep = np.full(S1, num_pdfs, dtype=np.int32)
            nz = counts > 0
            rep[nz] = C_multi.indices[C_multi.indptr[:-1][nz]]
            state_pdf = rep
    state_pdf = np.asarray(state_pdf, dtype=np.int32)
    if state_pdf.shape != (S1,):
        raise ValueError(f"state_pdf must have shape ({S1},)")

    rows, cols, data = hs.findnz(fsm.T_hat)
    E = len(rows)
    alpha_in = np.asarray(fsm.alpha_hat, dtype=np.float64)

    if strategy == "auto":
        # dense matmul operator while the S^2 matrix is cheap; blocked
        # gather-matmul-scatter beyond (ops/blocked.py); 'ell'/'segment'
        # remain for low-degree graphs and exact log-domain needs.
        strategy = "dense" if S1 <= 4096 else "block"
    if C_multi is not None:
        if strategy not in ("dense", "block"):
            raise ValueError(
                "general Ĉ requires the 'dense' or 'block' strategy"
            )
        if domain != "prob":
            raise ValueError("general Ĉ requires domain='prob'")
        reorder = "none"  # pdf-grouped layout assumes one pdf per state

    # --- optional uniform pdf-grouped relabeling --------------------------
    pdf_group = ()
    ov_layout = ()
    ov_region = None
    orig = None
    if reorder not in ("auto", "pdf", "none"):
        raise ValueError(f"unknown reorder mode {reorder!r}")
    if reorder != "none" and strategy == "block":
        P1 = num_pdfs + 1
        counts = np.bincount(state_pdf[: S1 - 1], minlength=P1)
        cmax = max(int(counts.max()), 1)
        cap = ov_cap
        if cap is None and cmax > 128 and cmax % 128:
            # cap at 128, the blocked operator's block width, so every
            # overflow group is exactly one block
            cap = 128
        if cap is not None and cap < cmax:
            # capped layout with overflow region (see the ov_cap docstring)
            order = np.argsort(state_pdf[: S1 - 1], kind="stable")
            grp = state_pdf[: S1 - 1][order].astype(np.int64)
            pos = np.arange(S1 - 1) - np.searchsorted(grp, grp)
            uni = (pos < cap) & (grp < num_pdfs)
            n_over = int((~uni).sum())
            nOv = -(-n_over // cap)
            lim_u = num_pdfs * cap
            fin_ov = lim_u + nOv * cap
            ov_ok = fin_ov + 1 <= max(
                int(1.5 * _round_up(S1, 128)), _round_up(S1, 128) + 128
            )
            if ov_ok and nOv > 0:
                perm = np.empty(S1, dtype=np.int64)
                perm[order[uni]] = grp[uni] * cap + pos[uni]
                # overflow states keep HOST order (it preserves the graph's
                # structural families, e.g. plane-major backoff states)
                ov_ids = np.sort(order[~uni])
                perm[ov_ids] = lim_u + np.arange(n_over)
                perm[S1 - 1] = fin_ov
                rows, cols = perm[rows], perm[cols]
                alpha_full = np.full(fin_ov + 1, -np.inf)
                alpha_full[perm] = alpha_in
                alpha_in = alpha_full
                spdf_full = np.full(fin_ov + 1, num_pdfs, dtype=np.int32)
                spdf_full[perm] = state_pdf
                state_pdf = spdf_full
                orig = np.full(fin_ov + 1, -1, dtype=np.int32)
                orig[perm] = np.arange(S1, dtype=np.int32)
                final_idx = fin_ov
                S_eff = fin_ov + 1
                ov_layout = (cap, nOv)
                ov_region = (lim_u, fin_ov, cap)
        lim = P1 * cmax
        inflation_ok = lim + 1 <= max(
            int(1.5 * _round_up(S1, 128)), _round_up(S1, 128) + 128
        )
        if not ov_layout and (reorder == "pdf" or inflation_ok):
            order = np.argsort(state_pdf[: S1 - 1], kind="stable")
            grp = state_pdf[: S1 - 1][order].astype(np.int64)
            pos = np.arange(S1 - 1) - np.searchsorted(grp, grp)
            perm = np.empty(S1, dtype=np.int64)
            perm[order] = grp * cmax + pos
            perm[S1 - 1] = num_pdfs * cmax  # phony leads its own group
            rows, cols = perm[rows], perm[cols]
            alpha_full = np.full(lim, -np.inf)
            alpha_full[perm] = alpha_in
            alpha_in = alpha_full
            spdf_full = np.repeat(
                np.arange(P1, dtype=np.int32), cmax
            )
            state_pdf = spdf_full
            orig = np.full(lim, -1, dtype=np.int32)
            orig[perm] = np.arange(S1, dtype=np.int32)
            final_idx = num_pdfs * cmax
            S_eff = lim
            pdf_group = (cmax, lim)
    if not pdf_group and not ov_layout:
        final_idx = S1 - 1
        S_eff = S1

    Sp = _round_up(S_eff, 128 if strategy in ("dense", "block") else 8)
    Ep = max(_round_up(E, 8), 8)

    alpha_hat = np.full(Sp, -np.inf, dtype=np.float64)
    alpha_hat[:S_eff] = alpha_in
    spdf = np.full(Sp, num_pdfs, dtype=np.int32)
    spdf[:S_eff] = state_pdf
    if orig is None:
        orig = np.full(Sp, -1, dtype=np.int32)
        orig[:S1] = np.arange(S1, dtype=np.int32)
    else:
        orig = np.concatenate(
            [orig, np.full(Sp - S_eff, -1, dtype=np.int32)]
        )

    def edge_arrays(gather, seg, w):
        order = np.lexsort((gather, seg))
        g = np.full(Ep, Sp - 1, dtype=np.int32)
        s = np.full(Ep, Sp - 1, dtype=np.int32)
        ww = np.full(Ep, -np.inf, dtype=np.float64)
        g[:E] = gather[order]
        s[:E] = seg[order]
        ww[:E] = w[order]
        return g, s, ww

    fwd_src, fwd_dst, fwd_w = edge_arrays(rows, cols, data)
    bwd_src, bwd_dst, bwd_w = edge_arrays(cols, rows, data)

    kw = dict(
        ell_fwd_src=None,
        ell_fwd_w=None,
        ell_bwd_src=None,
        ell_bwd_w=None,
        dense_fwd_exp=None,
        dense_fwd_max=None,
        dense_bwd_exp=None,
        dense_bwd_max=None,
        pdf_onehot=None,
        block_fwd=None,
        block_bwd=None,
        omega_prob=None,
        banded_fwd=None,
        banded_bwd=None,
    )
    meta = dict(
        block_fwd_offsets=(), block_bwd_offsets=(), pdf_group=pdf_group,
        ov_layout=ov_layout, banded_offsets=(),
    )

    # one-hot Ĉᵀ: lets the per-frame pdf-posterior reduction run as a small
    # matmul instead of segment scatters (worth ~1MB for typical P·S).
    # With a uniform pdf-grouped layout the reduction is a reshape-sum and
    # the one-hot is never touched on the hot path.  In general-Ĉ mode this
    # binary matrix IS the Ĉᵀ of the reference (multiple ones per column).
    if not pdf_group and Sp * (num_pdfs + 1) <= 64 * 1024 * 1024:
        oh = np.zeros((num_pdfs + 1, Sp), dtype=np.float32)
        oh[spdf, np.arange(Sp)] = 1.0
        if C_multi is not None:
            fin_cols = C_multi.indices[
                C_multi.indptr[S1 - 1] : C_multi.indptr[S1]
            ]
            if len(fin_cols) != 1 or fin_cols[0] != num_pdfs:
                raise ValueError("Ĉ phony row must map to the phony pdf")
            oh[:, :S1] = 0.0
            scol = np.repeat(np.arange(S1), np.diff(C_multi.indptr))
            oh[C_multi.indices, scol] = 1.0
        kw["pdf_onehot"] = jnp.asarray(oh)
    elif C_multi is not None:
        raise ValueError(
            "general Ĉ needs the one-hot reduction matrix; "
            f"(P+1)·Sp = {(num_pdfs + 1) * Sp} exceeds the size limit"
        )

    if strategy == "block":
        from .ops.blocked import build_block_operator

        # rank-1 split: arcs into the phony final state (the ω column of the
        # extended matrix, reference src/fsm.jl:19-28) are handled
        # analytically — y_fwd[fin] = ω·x, y_bwd += ω * x[fin] — so the
        # block operators stay scatter-free on the S×S core.
        to_fin = cols == final_idx
        om = np.zeros(Sp, dtype=np.float64)
        np.add.at(om, rows[to_fin], np.exp(data[to_fin]))
        # findnz of a sparse matrix yields each (src, fin) pair at most
        # once, so every omega_prob entry is a SINGLE arc's probability —
        # the tropical Viterbi paths reuse this vector with a max
        # reduction, which is only equivalent to the sum here because of
        # that single-arc invariant (input-dependent, so a real error, not
        # an assert: `python -O` must not disable it)
        if len(np.unique(rows[to_fin])) != int(to_fin.sum()):
            raise ValueError(
                "parallel arcs into the final state would break the "
                "tropical reuse of omega_prob"
            )
        kw["omega_prob"] = jnp.asarray(om, dtype=dtype)
        crows, ccols, cdata = rows[~to_fin], cols[~to_fin], data[~to_fin]

        np_dtype = np.dtype(jnp.dtype(dtype).name)
        op, offs = build_block_operator(crows, ccols, cdata, Sp,
                                        dtype=np_dtype, ov_region=ov_region)
        kw["block_fwd"] = op
        meta["block_fwd_offsets"] = offs
        op, offs = build_block_operator(ccols, crows, cdata, Sp,
                                        dtype=np_dtype, ov_region=ov_region)
        kw["block_bwd"] = op
        meta["block_bwd_offsets"] = offs

    if strategy == "banded":
        # rank-1 ω split exactly as 'block': arcs into the phony final
        # state are handled analytically; every remaining arc must sit on
        # one of ≤ 8 shared (dst - src) offsets — the LF-MMI numerator
        # lattice shape (self + chain bands, reference LinearFSM
        # examples/prepare-lfmmi-graphs.jl:25-65)
        to_fin = cols == final_idx
        om = np.zeros(Sp, dtype=np.float64)
        np.add.at(om, rows[to_fin], np.exp(data[to_fin]))
        kw["omega_prob"] = jnp.asarray(om, dtype=dtype)
        crows, ccols, cdata = rows[~to_fin], cols[~to_fin], data[~to_fin]
        offs = np.unique(ccols - crows) if len(crows) else np.zeros(0, int)
        if len(offs) > 8:
            raise ValueError(
                f"'banded' strategy: {len(offs)} distinct arc offsets "
                "(> 8) — this graph is not a low-bandwidth lattice; use "
                "'dense' or 'block'"
            )
        nO = max(len(offs), 1)
        bf = np.zeros((nO, Sp), dtype=np.float64)
        bb = np.zeros((nO, Sp), dtype=np.float64)
        for oi, off in enumerate(offs):
            sel = (ccols - crows) == off
            bf[oi, ccols[sel]] = np.exp(cdata[sel])
            bb[oi, crows[sel]] = np.exp(cdata[sel])
        kw["banded_fwd"] = jnp.asarray(bf, dtype=dtype)
        kw["banded_bwd"] = jnp.asarray(bb, dtype=dtype)
        meta["banded_offsets"] = tuple(int(o) for o in offs)

    if strategy == "ell":

        def ell(gather, seg, w):
            """Vectorized padded incoming-arc list build: sort edges by
            segment, then each edge's slot is its rank within the segment."""
            D = max(int(np.bincount(seg, minlength=S1).max()) if E else 0, 1)
            es = np.zeros((Sp, D), dtype=np.int32)
            ew = np.full((Sp, D), -np.inf, dtype=np.float64)
            if E:
                order = np.argsort(seg, kind="stable")
                segs = seg[order]
                slot = np.arange(E) - np.searchsorted(segs, segs)
                es[segs, slot] = gather[order]
                ew[segs, slot] = w[order]
            return es, ew

        es, ew = ell(rows, cols, data)
        kw["ell_fwd_src"] = jnp.asarray(es)
        kw["ell_fwd_w"] = jnp.asarray(ew, dtype=dtype)
        es, ew = ell(cols, rows, data)
        kw["ell_bwd_src"] = jnp.asarray(es)
        kw["ell_bwd_w"] = jnp.asarray(ew, dtype=dtype)
    elif strategy == "dense":
        W = np.full((Sp, Sp), -np.inf, dtype=np.float64)
        W[cols, rows] = data  # W_fwd[j, i] = T̂[i, j]
        exp_w, row_max = sops.make_dense_operator(jnp.asarray(W, dtype=dtype))
        kw["dense_fwd_exp"], kw["dense_fwd_max"] = exp_w, row_max
        Wb = np.full((Sp, Sp), -np.inf, dtype=np.float64)
        Wb[rows, cols] = data
        exp_w, row_max = sops.make_dense_operator(jnp.asarray(Wb, dtype=dtype))
        kw["dense_bwd_exp"], kw["dense_bwd_max"] = exp_w, row_max

    return CompiledFSM(
        alpha_hat=jnp.asarray(alpha_hat, dtype=dtype),
        final_state=jnp.asarray(final_idx, dtype=jnp.int32),
        state_pdf=jnp.asarray(spdf),
        orig_state=jnp.asarray(orig),
        fwd_src=jnp.asarray(fwd_src),
        fwd_dst=jnp.asarray(fwd_dst),
        fwd_w=jnp.asarray(fwd_w, dtype=dtype),
        bwd_src=jnp.asarray(bwd_src),
        bwd_dst=jnp.asarray(bwd_dst),
        bwd_w=jnp.asarray(bwd_w, dtype=dtype),
        num_states=S1,
        num_pdfs=int(num_pdfs),
        strategy=strategy,
        batched=False,
        precision=precision,
        domain=domain,
        multi_pdf=C_multi is not None,
        **meta,
        **kw,
    )


def stack(cfsms) -> CompiledFSM:
    """Stack compiled FSMs into one batched structure (padding to common
    shapes) — this engine's ``batch`` (reference src/inference.jl:28-36):
    instead of blockdiag-ing sparse storage, graphs get a leading batch axis
    and the recursions vmap over it.

    Route note: stacked LINEAR lattices (the LF-MMI numerator shape)
    should compile with strategy='banded' — the stacked batch (one
    sequence per graph) then runs as ONE log-domain scan over all graphs,
    the Triton kernel of ops/pallas_banded.py on the GPU.  'dense' stacks
    run the vmapped prob-domain scan (batched matmuls) and remain the
    fallback for non-banded heterogeneous graphs.  The 'block' strategy
    targets one LARGE graph shared across the batch (the LF-MMI
    denominator); stacking block operators is rejected because that
    workload shape (many distinct 2M-arc graphs in one batch) does not
    occur — the shared-graph batch axis already covers it."""
    cfsms = list(cfsms)
    if any(c.batched for c in cfsms):
        raise ValueError("can only stack unbatched CompiledFSMs")
    strategy = cfsms[0].strategy
    num_pdfs = cfsms[0].num_pdfs
    if any(c.strategy != strategy or c.num_pdfs != num_pdfs for c in cfsms):
        raise ValueError("stack requires matching strategy and num_pdfs")
    if strategy == "block":
        raise ValueError("stack does not support the 'block' strategy")

    Sp = max(c.padded_states for c in cfsms)
    Ep = max(c.fwd_src.shape[-1] for c in cfsms)
    Df = max((c.ell_fwd_src.shape[-1] for c in cfsms), default=0) if strategy == "ell" else 0
    Db = max((c.ell_bwd_src.shape[-1] for c in cfsms), default=0) if strategy == "ell" else 0

    def pad_to(x, size, fill, axis=-1):
        pad = size - x.shape[axis]
        if pad == 0:
            return x
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return jnp.pad(x, widths, constant_values=fill)

    # Padding edges keep pointing inside each graph's own (padded) state range
    # and carry weight -inf, so they contribute semiring zero regardless of
    # which padding slot they target — no index remapping is needed.
    def fstack(name, size, fill, axis=-1):
        return jnp.stack([pad_to(getattr(c, name), size, fill, axis) for c in cfsms])

    kw = dict(
        alpha_hat=fstack("alpha_hat", Sp, -jnp.inf),
        state_pdf=fstack("state_pdf", Sp, num_pdfs),
        fwd_src=fstack("fwd_src", Ep, 0),
        fwd_dst=fstack("fwd_dst", Ep, Sp - 1),
        fwd_w=fstack("fwd_w", Ep, -jnp.inf),
        bwd_src=fstack("bwd_src", Ep, 0),
        bwd_dst=fstack("bwd_dst", Ep, Sp - 1),
        bwd_w=fstack("bwd_w", Ep, -jnp.inf),
        ell_fwd_src=None,
        ell_fwd_w=None,
        ell_bwd_src=None,
        ell_bwd_w=None,
        dense_fwd_exp=None,
        dense_fwd_max=None,
        dense_bwd_exp=None,
        dense_bwd_max=None,
        pdf_onehot=(
            jnp.stack([pad_to(c.pdf_onehot, Sp, 0.0) for c in cfsms])
            if all(c.pdf_onehot is not None for c in cfsms)
            else None
        ),
        block_fwd=None,
        block_bwd=None,
        omega_prob=None,
        banded_fwd=None,
        banded_bwd=None,
        orig_state=fstack("orig_state", Sp, -1),
    )
    banded_offsets = ()
    if strategy == "banded":
        # union of the graphs' offset sets; absent offsets get zero bands
        banded_offsets = tuple(
            sorted({o for c in cfsms for o in c.banded_offsets})
        )
        if len(banded_offsets) > 8:
            raise ValueError(
                f"stack: union of banded offsets has {len(banded_offsets)} "
                "entries (> 8)"
            )
        nO = max(len(banded_offsets), 1)

        def expand_bands(c, name):
            src = getattr(c, name)
            out = jnp.zeros((nO, Sp), src.dtype)
            for i, o in enumerate(banded_offsets):
                if o in c.banded_offsets:
                    j = c.banded_offsets.index(o)
                    out = out.at[i, : src.shape[1]].set(src[j])
            return out

        kw["banded_fwd"] = jnp.stack(
            [expand_bands(c, "banded_fwd") for c in cfsms]
        )
        kw["banded_bwd"] = jnp.stack(
            [expand_bands(c, "banded_bwd") for c in cfsms]
        )
        kw["omega_prob"] = fstack("omega_prob", Sp, 0.0)
    if strategy == "ell":
        kw["ell_fwd_src"] = jnp.stack(
            [pad_to(pad_to(c.ell_fwd_src, Df, 0), Sp, 0, 0) for c in cfsms]
        )
        kw["ell_fwd_w"] = jnp.stack(
            [pad_to(pad_to(c.ell_fwd_w, Df, -jnp.inf), Sp, -jnp.inf, 0) for c in cfsms]
        )
        kw["ell_bwd_src"] = jnp.stack(
            [pad_to(pad_to(c.ell_bwd_src, Db, 0), Sp, 0, 0) for c in cfsms]
        )
        kw["ell_bwd_w"] = jnp.stack(
            [pad_to(pad_to(c.ell_bwd_w, Db, -jnp.inf), Sp, -jnp.inf, 0) for c in cfsms]
        )
    if strategy == "dense":
        for prefix in ("dense_fwd", "dense_bwd"):
            kw[prefix + "_exp"] = jnp.stack(
                [
                    pad_to(pad_to(getattr(c, prefix + "_exp"), Sp, 0.0, 0), Sp, 0.0, 1)
                    for c in cfsms
                ]
            )
            kw[prefix + "_max"] = jnp.stack(
                [pad_to(getattr(c, prefix + "_max"), Sp, -jnp.inf) for c in cfsms]
            )

    return CompiledFSM(
        final_state=jnp.stack([c.final_state for c in cfsms]),
        num_states=Sp,
        num_pdfs=num_pdfs,
        strategy=strategy,
        batched=True,
        precision=cfsms[0].precision,
        domain=cfsms[0].domain,
        banded_offsets=banded_offsets,
        **kw,
    )


# ---------------------------------------------------------------------------
# recursions
# ---------------------------------------------------------------------------

def _make_matvec(cf: CompiledFSM, direction: str):
    Sp = cf.padded_states
    if cf.strategy == "dense":
        e = cf.dense_fwd_exp if direction == "fwd" else cf.dense_bwd_exp
        m = cf.dense_fwd_max if direction == "fwd" else cf.dense_bwd_max
        return lambda x: sops.dense_log_matvec(e, m, x, precision=cf.precision)
    if cf.strategy == "ell":
        s = cf.ell_fwd_src if direction == "fwd" else cf.ell_bwd_src
        w = cf.ell_fwd_w if direction == "fwd" else cf.ell_bwd_w
        return lambda x: sops.ell_matvec(s, w, x)
    if direction == "fwd":
        s, d, w = cf.fwd_src, cf.fwd_dst, cf.fwd_w
    else:
        s, d, w = cf.bwd_src, cf.bwd_dst, cf.bwd_w
    return lambda x: sops.segment_matvec(s, d, w, x, Sp)


def _make_elhs(cf: CompiledFSM, lengths, trop: bool = False):
    """``trop=True`` is the tropical lift: a general Ĉ's per-state emission
    is the ⊕ over its pdf set, which under (max, +) is a max — the Viterbi
    recursions use it (ref Ĉ generality src/inference.jl:7-8).  The
    log-domain *sum* recursions reject general Ĉ (a per-frame logsumexp per
    state would be needed; the prob-domain path handles it instead)."""
    if cf.multi_pdf and not trop:
        raise NotImplementedError(
            "log-domain recursions do not support general Ĉ; use the "
            "prob-domain pdfposteriors path"
        )
    Sp = cf.padded_states
    is_phony = (jnp.arange(Sp) == cf.final_state)[:, None]

    def elhs(lhs_t, t):
        """Expanded per-frame likelihood column (reference ``expand``,
        src/inference.jl:38-60): (B, P) -> (Sp, B)."""
        lhs_ext = jnp.concatenate(
            [lhs_t.T, jnp.full((1, lhs_t.shape[0]), NEG_INF, lhs_t.dtype)], axis=0
        )  # (P+1, B); phony pdf row = zero(K)
        if cf.multi_pdf:
            x = jnp.max(
                jnp.where(
                    cf.pdf_onehot[:, :, None] > 0,
                    lhs_ext[:, None, :],
                    NEG_INF,
                ),
                axis=0,
            )  # (Sp, B): max over each state's pdf set
        else:
            x = lhs_ext[cf.state_pdf, :]
        active = (t < lengths)[None, :]
        return jnp.where(active, x, jnp.where(is_phony, 0.0, NEG_INF))

    return elhs


def _colmax_safe(y):
    m = jnp.max(y, axis=0)
    return jnp.where(jnp.isfinite(m), m, 0.0)


def _pdf_reduce(cf: CompiledFSM, gamma):
    """Ĉᵀ(α⊙β): per-pdf reduction over states + per-frame normalization
    (reference src/inference.jl:155-156).

    With a one-hot Ĉᵀ the whole reduction is one small matmul in the
    probability domain: gamma is already per-frame rescaled by the scan, so
    exp(gamma - colmax) cannot overflow and normalization cancels colmax."""
    if cf.pdf_onehot is not None:
        m = _colmax_safe(gamma)
        g = jnp.exp(gamma - m[None, :])  # (Sp, B); -inf -> 0
        s = jnp.dot(
            cf.pdf_onehot,
            g,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        tot = jnp.sum(g, axis=0)  # every state maps to exactly one pdf
        return s / jnp.where(tot > 0, tot, 1.0)[None, :]
    P1 = cf.num_pdfs + 1
    gpdf = sops.segment_logsumexp(gamma, cf.state_pdf, P1)
    norm = sops.masked_logsumexp(gpdf, axis=0)
    return jnp.exp(gpdf - jnp.where(jnp.isfinite(norm), norm, 0.0)[None, :])


@dataclasses.dataclass
class _Kernels:
    """The pluggable pieces of the forward-backward scan.  Single-device
    inference builds them from a CompiledFSM; the state-sharded path
    (parallel/sharded.py) builds versions that insert mesh collectives while
    reusing the identical scan skeleton below."""

    alpha0: jnp.ndarray  # (S_loc,) initial extended weights
    fwd_mv: callable  # (S_loc, B) -> (S_loc, B): y = T̂ᵀ ⊗ x
    bwd_mv: callable  # (S_loc, B) -> (S_loc, B): y = T̂ ⊗ x
    elhs: callable  # (lhs_t (B, P), t) -> (S_loc, B) expanded likelihoods
    colmax: callable  # (S_loc, B) -> (B,) finite-safe per-column max
    pdf_posts: callable  # gamma (S_loc, B) -> (P+1, B) normalized posteriors
    final_val: callable  # (x (S_loc, B), shift (B,)) -> (B,) logZ extraction


def _fb_run(kern: _Kernels, lhs, lengths, chunk_size, want_posts, num_pdfs):
    """Chunk-checkpointed forward(-backward) scan.  lhs: (B, N, P); returns
    (posts (B, N, P) or None, logZ (B,))."""
    B, N, P = lhs.shape
    if P != num_pdfs:
        raise ValueError(f"lhs has {P} pdfs, graph expects {num_pdfs}")
    Sl = kern.alpha0.shape[0]
    Nf = N + 1
    K = min(chunk_size, Nf)
    C = -(-Nf // K)
    Npad = C * K

    lhs_tm = jnp.moveaxis(lhs, 1, 0)  # (N, B, P)
    lhs_tm = jnp.pad(lhs_tm, ((0, Npad - N), (0, 0), (0, 0)))
    ts = jnp.arange(Npad, dtype=jnp.int32)
    lhs_cm = lhs_tm.reshape(C, K, B, P)
    ts_cm = ts.reshape(C, K)

    x0 = (
        kern.alpha0.astype(lhs.dtype)
        if kern.alpha0.ndim == 2  # per-column initial state (stacked graphs)
        else jnp.broadcast_to(kern.alpha0[:, None], (Sl, B)).astype(lhs.dtype)
    )
    shift0 = jnp.zeros(B, lhs.dtype)
    comp0 = jnp.zeros(B, lhs.dtype)

    def fstep(carry, inp):
        x, shift, comp = carry
        lhs_t, t = inp
        y = jnp.where(t == 0, x, kern.fwd_mv(x))
        y = y + kern.elhs(lhs_t, t)
        m = kern.colmax(y)
        y = y - m[None, :]
        shift, comp = _kahan_add(shift, comp, m)
        return (y, shift, comp), None

    def fstep_save(carry, inp):
        new_carry, _ = fstep(carry, inp)
        return new_carry, new_carry[0]

    def chunk_fwd(carry, inp):
        boundary = carry
        new_carry, _ = lax.scan(fstep, carry, inp)
        return new_carry, boundary

    def bstep(bb, i):
        a_t, lhs_t, t = i
        y = jnp.where(t == Npad - 1, jnp.zeros_like(bb), kern.bwd_mv(bb))
        m = kern.colmax(y)
        y = y - m[None, :]
        gamma = a_t + y
        posts_t = kern.pdf_posts(gamma)  # (P+1, B)
        bb_new = y + kern.elhs(lhs_t, t)
        return bb_new, posts_t

    binit = jnp.zeros((Sl, B), lhs.dtype)

    if C == 1:
        # full-memory mode: save every α frame in the forward scan, skip the
        # recompute pass (2 matvecs/frame instead of 3)
        (xF, shiftF, _), A = lax.scan(fstep_save, (x0, shift0, comp0), (lhs_tm, ts))
        logZ = kern.final_val(xF, shiftF)
        if not want_posts:
            return None, logZ
        _, posts = lax.scan(bstep, binit, (A, lhs_tm, ts), reverse=True)
    else:
        (xF, shiftF, _), boundaries = lax.scan(
            chunk_fwd, (x0, shift0, comp0), (lhs_cm, ts_cm)
        )
        logZ = kern.final_val(xF, shiftF)
        if not want_posts:
            return None, logZ

        def chunk_bwd(carry, inp):
            bound, lhs_k, ts_k = inp
            _, A_k = lax.scan(fstep_save, bound, (lhs_k, ts_k))
            return lax.scan(bstep, carry, (A_k, lhs_k, ts_k), reverse=True)

        _, posts = lax.scan(
            chunk_bwd, binit, (boundaries, lhs_cm, ts_cm), reverse=True
        )
    posts = posts.reshape(Npad, num_pdfs + 1, B)
    posts = jnp.moveaxis(posts, 2, 0)[:, :N, :num_pdfs]  # (B, N, P)
    return posts, logZ


def _make_eprob(cf: CompiledFSM, lengths, op: str = "sum"):
    """Per-frame emission probabilities for the prob-domain scans:
    (lhs_t (B, P), t) -> (e (Sp, B) in [0, 1], m_l (B,) factored log-shift).
    Shared by the fwd-bwd scan (_fb_prob) and the tropical Viterbi scan.

    ``op``: reduction over a general Ĉ's pdf set per state — 'sum' for the
    forward-backward lift, 'max' for the tropical (Viterbi) lift.  With a
    one-pdf-per-state Ĉ the two coincide."""
    Sp = cf.padded_states
    is_ph = (jnp.arange(Sp) == cf.final_state)[:, None]
    P1 = cf.num_pdfs + 1

    def eprob(lhs_t, t):
        active = t < lengths  # (B,)
        m_l = jnp.max(lhs_t, axis=1)  # (B,)
        el = jnp.exp(lhs_t - m_l[:, None])  # (B, P) in (0, 1]
        ph = jnp.where(active, 0.0, 1.0)[None, :]  # phony-pdf row
        ext = jnp.concatenate([el.T * active[None, :], ph], axis=0)  # (P1, B)
        if cf.multi_pdf and op == "max":
            # tropical lift of Ĉ·V̂: ⊕ over the state's pdf set = max
            x = jnp.max(
                jnp.where(
                    cf.pdf_onehot[:, :, None] > 0, ext[:, None, :], 0.0
                ),
                axis=0,
            )
        elif cf.multi_pdf:
            # general Ĉ: emission of state s sums its pdf set (the
            # reference's Ĉ·V̂ expansion, src/inference.jl:151) — one binary
            # matmul; padding/phony columns carry the phony-pdf one
            x = jnp.dot(
                cf.pdf_onehot.T, ext,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        elif cf.pdf_group:
            # uniform layout: pdf p owns slots [p*cmax, (p+1)*cmax) — the
            # state→pdf gather is a broadcast + reshape
            cmax, lim = cf.pdf_group
            x = jnp.broadcast_to(ext[:, None, :], (P1, cmax, lhs_t.shape[0]))
            x = x.reshape(lim, lhs_t.shape[0])
            x = jnp.pad(x, ((0, Sp - lim), (0, 0)))
        else:
            x = ext[cf.state_pdf, :]
            x = jnp.where(active[None, :], x, jnp.where(is_ph, 1.0, 0.0))
        return x, jnp.where(active, m_l, 0.0)

    return eprob


def _fb_prob(cf: CompiledFSM, lhs, lengths, chunk_size, want_posts,
             fwd_pmv, bwd_pmv):
    """Probability-domain scan (fast path for the 'dense' and 'block'
    strategies).

    Instead of logsumexp per frame, the state vector is carried as
    max-normalized probabilities with an accumulated log-shift
    (pychain-style rescaling; cf. reference README's pychain comparison,
    misc/benchmark/benchmark.py).  Per frame this is one matvec
    (``fwd_pmv``/``bwd_pmv``: dense operator or blocked gather-matmul-
    scatter) plus cheap multiplies — no exp/log over the (S, B) state matrix.

    Weight magnitudes: probabilities below f32 range (~e-87 relative)
    underflow and vanish — far below the engine's f32 resolution anyway.
    """
    B, N, P = lhs.shape
    if P != cf.num_pdfs:
        raise ValueError(f"lhs has {P} pdfs, graph expects {cf.num_pdfs}")
    prec = sops.dot_precision(cf.precision, cf.alpha_hat.dtype)
    onehot = cf.pdf_onehot  # (P+1, Sp) or None
    P1 = cf.num_pdfs + 1

    def pdf_reduce(gamma):
        """Σ_states-of-pdf gamma -> (P1, B) plus the per-frame total."""
        if cf.pdf_group:
            cmax, lim = cf.pdf_group
            s = jnp.sum(gamma[:lim].reshape(P1, cmax, B), axis=1)
            tot = jnp.sum(s, axis=0)
        elif onehot is not None:
            s = jnp.dot(
                onehot, gamma, preferred_element_type=jnp.float32,
                precision=prec,
            )
            # multi-pdf states contribute to several pdfs, so the per-frame
            # normalizer is the pdf-space sum, not the state-space sum
            tot = jnp.sum(s, axis=0) if cf.multi_pdf else jnp.sum(gamma, axis=0)
        else:
            s = jnp.zeros((P1, B), gamma.dtype)
            s = s.at[cf.state_pdf].add(gamma)
            tot = jnp.sum(gamma, axis=0)
        return s, tot

    def final_val(a, ksum, shift):
        v = jnp.take(a, cf.final_state, axis=0)
        return _combine_shift(
            jnp.where(v > 0, jnp.log(jnp.maximum(v, 1e-38)), NEG_INF),
            ksum,
            shift,
        )

    kern = _ProbKernels(
        alpha0=jnp.exp(cf.alpha_hat),
        fwd_pmv=fwd_pmv,
        bwd_pmv=bwd_pmv,
        eprob=_make_eprob(cf, lengths),
        colmax=lambda y: jnp.max(y, axis=0),
        pdf_reduce=pdf_reduce,
        final_val=final_val,
    )
    return _fbp_run(kern, lhs, lengths, chunk_size, want_posts, cf.num_pdfs)


def _fb_banded_stacked(cf: CompiledFSM, lhs, lengths, chunk_size,
                       want_posts):
    """Stacked 'banded' graphs (e.g. 128 LF-MMI numerator lattices, one
    sequence each) run as ONE log-domain scan with the graph axis as the
    batch axis: state (Sp, G) instead of the vmapped per-graph (Sp, 1).

    Log domain, not the rescaled probabilities of the other routes: a
    numerator's forward filter can put its mass far ahead of the alignment
    the rest of the utterance forces (a 0.5 self-loop drifts ~t/2 states in
    t frames, while a 78-state lattice over 700 frames advances ~t/9), so
    the states that carry the posterior sit more than f32's ~87 nats below
    the frame maximum and a rescaled f32 scan flushes them to zero.

    On the GPU the Triton kernel (ops/pallas_banded.py) runs the same
    recursion; elsewhere this XLA scan does."""
    B, N, P = lhs.shape
    if P != cf.num_pdfs:
        raise ValueError(f"lhs has {P} pdfs, graph expects {cf.num_pdfs}")
    G = cf.alpha_hat.shape[0]
    if B != G:
        raise ValueError(
            f"stacked banded scan expects one sequence per graph "
            f"(B = {B}, graphs = {G})"
        )
    if _banded_kernel_reason(cf, B) is None:
        from .ops import pallas_banded as pband

        return pband.banded_fb(cf, lhs, lengths, want_posts)
    Sp = cf.padded_states
    P1 = P + 1
    offs = cf.banded_offsets
    # graph-minor parameter layouts: (Sp, G), bands (nO, Sp, G)
    lbf = jnp.log(jnp.transpose(cf.banded_fwd, (1, 2, 0)))
    lbb = jnp.log(jnp.transpose(cf.banded_bwd, (1, 2, 0)))
    lom = jnp.log(jnp.transpose(cf.omega_prob))
    spdfT = jnp.transpose(cf.state_pdf)  # (Sp, G) int32
    is_fin = jnp.arange(Sp)[:, None] == cf.final_state[None, :]  # (Sp, G)
    # per-graph one-hot state→pdf for the posterior reduction (G, P1, Sp)
    oh = (
        spdfT.T[:, None, :] == jnp.arange(P1)[None, :, None]
    ).astype(lhs.dtype)

    def lse(terms):
        return sops.masked_logsumexp(jnp.stack(terms), axis=0)

    def fwd_mv(x):
        y = lse([lbf[oi] + (x if off == 0 else jnp.roll(x, off, axis=0))
                 for oi, off in enumerate(offs)])
        yfin = sops.masked_logsumexp(lom + x, axis=0)  # (G,)
        return jnp.where(is_fin, yfin[None, :], y)

    def bwd_mv(x):
        xfin = jnp.max(jnp.where(is_fin, x, NEG_INF), axis=0)  # (G,)
        return lse([lbb[oi] + (x if off == 0 else jnp.roll(x, -off, axis=0))
                    for oi, off in enumerate(offs)] + [lom + xfin[None, :]])

    def elhs(lhs_t, t):
        ext = jnp.concatenate(
            [lhs_t.T, jnp.full((1, G), NEG_INF, lhs_t.dtype)], axis=0
        )  # (P1, G); phony pdf row = zero(K)
        x = jnp.take_along_axis(ext, spdfT, axis=0)  # (Sp, G)
        active = (t < lengths)[None, :]
        return jnp.where(active, x, jnp.where(is_fin, 0.0, NEG_INF))

    def pdf_posts(gamma):
        g = jnp.exp(gamma - _colmax_safe(gamma)[None, :])  # (Sp, G)
        s = jnp.einsum("gps,sg->pg", oh, g, preferred_element_type=jnp.float32,
                       precision=lax.Precision.HIGHEST)
        tot = jnp.sum(g, axis=0)
        return s / jnp.where(tot > 0, tot, 1.0)[None, :]

    kern = _Kernels(
        alpha0=jnp.transpose(cf.alpha_hat),
        fwd_mv=fwd_mv,
        bwd_mv=bwd_mv,
        elhs=elhs,
        colmax=_colmax_safe,
        pdf_posts=pdf_posts,
        final_val=lambda x, shift: jnp.max(
            jnp.where(is_fin, x, NEG_INF), axis=0) + shift,
    )
    return _fb_run(kern, lhs, lengths, chunk_size, want_posts, P)


@dataclasses.dataclass
class _ProbKernels:
    """Pluggable pieces of the probability-domain forward-backward scan —
    the prob-domain twin of ``_Kernels``.  Single-device inference builds
    them from a CompiledFSM (``_fb_prob``); the state-sharded fast path
    (parallel/sharded.py) builds versions with mesh collectives baked in,
    reusing the identical chunk-checkpointed skeleton (``_fbp_run``)."""

    alpha0: jnp.ndarray  # (S_loc,) initial probabilities exp(α̂)
    fwd_pmv: callable  # (S_loc, B) -> (S_loc, B) probability matvec T̂ᵀ
    bwd_pmv: callable  # (S_loc, B) -> (S_loc, B) probability matvec T̂
    eprob: callable  # (lhs_t (B, P), t) -> (e (S_loc, B), m_l (B,))
    colmax: callable  # (S_loc, B) -> (B,) global per-column max
    pdf_reduce: callable  # gamma (S_loc, B) -> (s (P+1, B), tot (B,))
    final_val: callable  # (a, ksum, shift) -> (B,) logZ


def _fbp_run(kern: _ProbKernels, lhs, lengths, chunk_size, want_posts,
             num_pdfs):
    """Chunk-checkpointed probability-domain scan over a kernel bundle.
    lhs: (B, N, P); returns (posts (B, N, P) or None, logZ (B,))."""
    B, N, P = lhs.shape
    Sl = kern.alpha0.shape[0]
    Nf = N + 1
    K = min(chunk_size, Nf)
    C = -(-Nf // K)
    Npad = C * K
    P1 = num_pdfs + 1

    lhs_tm = jnp.pad(jnp.moveaxis(lhs, 1, 0), ((0, Npad - N), (0, 0), (0, 0)))
    ts = jnp.arange(Npad, dtype=jnp.int32)
    lhs_cm = lhs_tm.reshape(C, K, B, P)
    ts_cm = ts.reshape(C, K)

    a0 = jnp.broadcast_to(kern.alpha0[:, None], (Sl, B)).astype(lhs.dtype)
    shift0 = jnp.zeros(B, lhs.dtype)
    comp0 = jnp.zeros(B, lhs.dtype)
    k0 = jnp.zeros(B, lhs.dtype)

    def fstep(carry, inp):
        a, ksum, shift, comp = carry
        lhs_t, t = inp
        p = jnp.where(t == 0, a, kern.fwd_pmv(a))
        e, m_l = kern.eprob(lhs_t, t)
        y = p * e
        m = kern.colmax(y)  # (B,)
        # exact power-of-two rescale: the division is round-off free and the
        # shift is an exactly-accumulated integer exponent (the emission
        # max m_l still goes through the Kahan-compensated real shift)
        k = jnp.where(m > 0, jnp.floor(jnp.log2(m)), 0.0)
        y = y * jnp.exp2(-k)[None, :]
        ksum = ksum + k
        shift, comp = _kahan_add(shift, comp, m_l)
        return (y, ksum, shift, comp), None

    def fstep_save(carry, inp):
        new_carry, _ = fstep(carry, inp)
        return new_carry, new_carry[0]

    def bstep(c, i):
        bb = c
        a_t, lhs_t, t = i
        y = jnp.where(t == Npad - 1, jnp.ones_like(bb), kern.bwd_pmv(bb))
        m = kern.colmax(y)
        y = y * jnp.exp2(-jnp.where(m > 0, jnp.floor(jnp.log2(m)), 0.0))[None, :]
        gamma = a_t * y  # (Sl, B) probs, arbitrary per-frame scale
        s, tot = kern.pdf_reduce(gamma)
        posts_t = s / jnp.where(tot > 0, tot, 1.0)[None, :]
        e, _ = kern.eprob(lhs_t, t)
        return y * e, posts_t

    binit = jnp.ones((Sl, B), lhs.dtype)

    if C == 1:
        (aF, kF, shiftF, _), A = lax.scan(
            fstep_save, (a0, k0, shift0, comp0), (lhs_tm, ts)
        )
        logZ = kern.final_val(aF, kF, shiftF)
        if not want_posts:
            return None, logZ
        _, posts = lax.scan(bstep, binit, (A, lhs_tm, ts), reverse=True)
    else:
        def chunk_fwd(carry, inp):
            boundary = carry
            new_carry, _ = lax.scan(fstep, carry, inp)
            return new_carry, boundary

        (aF, kF, shiftF, _), boundaries = lax.scan(
            chunk_fwd, (a0, k0, shift0, comp0), (lhs_cm, ts_cm)
        )
        logZ = kern.final_val(aF, kF, shiftF)
        if not want_posts:
            return None, logZ

        def chunk_bwd(carry, inp):
            bound, lhs_k, ts_k = inp
            _, A_k = lax.scan(fstep_save, bound, (lhs_k, ts_k))
            return lax.scan(bstep, carry, (A_k, lhs_k, ts_k), reverse=True)

        _, posts = lax.scan(
            chunk_bwd, binit, (boundaries, lhs_cm, ts_cm), reverse=True
        )
    posts = posts.reshape(Npad, P1, B)
    posts = jnp.moveaxis(posts, 2, 0)[:, :N, :num_pdfs]
    return posts, logZ


def _make_kernels(cf: CompiledFSM, lengths) -> _Kernels:
    return _Kernels(
        alpha0=cf.alpha_hat,
        fwd_mv=_make_matvec(cf, "fwd"),
        bwd_mv=_make_matvec(cf, "bwd"),
        elhs=_make_elhs(cf, lengths),
        colmax=_colmax_safe,
        pdf_posts=lambda gamma: _pdf_reduce(cf, gamma),
        final_val=lambda x, shift: jnp.take(x, cf.final_state, axis=0) + shift,
    )


def _make_prob_matvecs(cf: CompiledFSM):
    """Probability-domain matvec closures for the prob-domain scan."""
    prec = sops.dot_precision(cf.precision, cf.alpha_hat.dtype)
    if cf.strategy == "dense":
        scale_f = jnp.exp(cf.dense_fwd_max)  # (Sp,); -inf rows -> 0
        scale_b = jnp.exp(cf.dense_bwd_max)

        def mv(expw, scale, a):
            return scale[:, None] * jnp.dot(
                expw, a, preferred_element_type=jnp.float32, precision=prec
            )

        return (
            lambda a: mv(cf.dense_fwd_exp, scale_f, a),
            lambda a: mv(cf.dense_bwd_exp, scale_b, a),
        )
    if cf.strategy == "banded":
        offs = cf.banded_offsets

        def fwd(a):
            y = jnp.zeros_like(a)
            for oi, off in enumerate(offs):
                xs = a if off == 0 else jnp.roll(a, off, axis=0)
                y = y + cf.banded_fwd[oi][:, None] * xs
            # rank-1 ω: y[fin] = ω·a (ω[fin] = 1 covers the phony loop)
            yfin = jnp.einsum("s,sb->b", cf.omega_prob, a)
            return y.at[cf.final_state].set(yfin)

        def bwd(a):
            y = jnp.zeros_like(a)
            for oi, off in enumerate(offs):
                xs = a if off == 0 else jnp.roll(a, -off, axis=0)
                y = y + cf.banded_bwd[oi][:, None] * xs
            afin = jnp.take(a, cf.final_state, axis=0)
            return y + cf.omega_prob[:, None] * afin[None, :]

        return fwd, bwd
    if cf.strategy == "block":
        from .ops.blocked import block_matvec

        def fwd(a):
            y = block_matvec(cf.block_fwd, cf.block_fwd_offsets, a, prec)
            if cf.omega_prob is not None:
                # rank-1 ω handling: y[fin] = ω·a (ω[fin] = 1 covers the
                # phony self-loop); the core operator never writes row fin
                yfin = jnp.einsum("s,sb->b", cf.omega_prob, a)
                y = y.at[cf.final_state].set(yfin)
            return y

        def bwd(a):
            y = block_matvec(cf.block_bwd, cf.block_bwd_offsets, a, prec)
            if cf.omega_prob is not None:
                afin = jnp.take(a, cf.final_state, axis=0)  # (B,)
                y = y + cf.omega_prob[:, None] * afin[None, :]
            return y

        return fwd, bwd
    raise ValueError(f"no prob-domain matvec for strategy {cf.strategy!r}")


def _banded_kernel_reason(cf: CompiledFSM, batch_size: int):
    """None when a stacked 'banded' graph takes the compiled Triton kernel
    (ops/pallas_banded.py), else why it takes the lane-stacked XLA scan.
    The kernel compiles only for the GPU; on any other backend the XLA scan
    runs.  On the GPU a supported graph always takes the kernel."""
    from .ops import pallas_banded as pband

    if jax.default_backend() != "gpu":
        return (f"backend {jax.default_backend()!r} (the Triton kernel "
                "compiles only for the GPU)")
    return pband.banded_kernel_reject_reason(cf, batch_size)


def fast_path_report(cf: CompiledFSM, batch_size: int = 128) -> str:
    """One-line name of the route ``pdfposteriors`` takes for this graph at
    ``batch_size`` (the runtime ``lhs.shape[0]``), with the operator's
    layout where that decides the cost: the blocked operator's tier
    access patterns (affine views or index gathers/scatters) and residue."""
    if cf.batched:
        G = cf.alpha_hat.shape[0]
        if cf.strategy != "banded" or batch_size != G:
            return (f"xla vmapped per-graph scan ({cf.strategy!r} strategy, "
                    f"batch {batch_size}, {G} graphs)")
        reason = _banded_kernel_reason(cf, batch_size)
        if reason is None:
            return "pallas-triton banded kernel (stacked graphs, log domain)"
        return ("xla stacked banded scan (log domain) - kernel not used: "
                f"{reason}")
    if cf.domain != "prob" or cf.strategy in ("ell", "segment") or (
        cf.strategy == "dense" and cf.pdf_onehot is None
    ):
        return f"xla log-domain scan ({cf.strategy!r} strategy)"
    if cf.strategy == "block":
        descs = cf.block_fwd_offsets[1] + cf.block_bwd_offsets[1]
        forms = sorted({d[0] for pair in descs for d in pair})
        n_res = sum(
            0 if op.res_src is None else int(op.res_src.shape[0])
            for op in (cf.block_fwd, cf.block_bwd)
        )
        layout = "affine" if all(
            f not in ("gather", "scatter") for f in forms
        ) and n_res == 0 else "irregular"
        return (f"xla block scan ({layout} operator: tier access "
                f"{'/'.join(forms) or 'none'}, {n_res} residue arcs)")
    return f"xla prob-domain scan ({cf.strategy!r} strategy)"


def _fb_single(cf: CompiledFSM, lhs, lengths, chunk_size, want_posts):
    if cf.domain == "prob" and (
        (cf.strategy == "dense" and cf.pdf_onehot is not None)
        or cf.strategy in ("block", "banded")
    ):
        fwd_pmv, bwd_pmv = _make_prob_matvecs(cf)
        return _fb_prob(
            cf, lhs, lengths, chunk_size, want_posts, fwd_pmv, bwd_pmv
        )
    kern = _make_kernels(cf, lengths)
    return _fb_run(kern, lhs, lengths, chunk_size, want_posts, cf.num_pdfs)


# Cody-Waite split of ln 2: LN2_HI has only 9 mantissa bits, so k·LN2_HI is
# exact in f32 for integer |k| < 2^15 (the accumulated power-of-two exponent
# over any realistic sequence); the residual k·LN2_LO is O(|k|·2e-4) and
# carries the remaining precision.
_LN2_HI = np.float32(0.693359375)
_LN2_LO = np.float32(np.log(2.0) - 0.693359375)


def _combine_shift(logv, ksum, shift):
    """logZ = logv + ksum·ln2 + shift with the ksum·ln2 product split so the
    dominant term is exact (ksum is an exactly-accumulated f32 integer)."""
    return ((logv + ksum * _LN2_LO) + shift) + ksum * _LN2_HI


def _kahan_add(s, c, x):
    """Compensated accumulation: returns updated (sum, compensation).

    The per-frame rescaling shift is a running sum whose total reaches
    O(N·|log-lik|); naive f32 accumulation alone costs ~1e-3 absolute on the
    final log-marginal at N=700, dwarfing every other error source.  Kahan
    summation removes it for two (B,)-sized flops per frame."""
    y = x - c
    t = s + y
    return t, (t - s) - y


_FULL_MEM_BYTES = 4 << 30  # device-memory budget for the saved alphas


def _auto_chunk(cf: CompiledFSM, lhs):
    """Pick full-memory mode (save all alphas, 2 matvec passes/frame) when
    the alpha tensor fits, else chunk-checkpoint (3 passes, O(sqrt-ish) mem)."""
    Nf = lhs.shape[-2] + 1
    batch = lhs.shape[0] if not cf.batched else 1
    est = Nf * cf.padded_states * batch * lhs.dtype.itemsize
    return Nf if est <= _FULL_MEM_BYTES else 64


def _dispatch(cf: CompiledFSM, lhs, lengths, chunk_size, want_posts):
    lhs = jnp.asarray(lhs)
    if chunk_size is None:
        chunk_size = _auto_chunk(cf, lhs)
    if lengths is None:
        lengths = jnp.full((lhs.shape[0],), lhs.shape[-2])
    # clamp: a length beyond the frame count would keep the recursion off the
    # phony final state forever (logZ = -inf); reference expand() semantics
    # likewise cap seqlength at N (src/inference.jl:54-60).
    lengths = jnp.minimum(jnp.asarray(lengths, dtype=jnp.int32), lhs.shape[-2])
    if cf.batched:
        if lhs.ndim != 3:
            raise ValueError("batched graphs expect lhs of shape (B, N, P)")
        if (
            cf.strategy == "banded"
            and lhs.shape[0] == cf.alpha_hat.shape[0]
        ):
            # one-sequence-per-graph stacked numerators: run as a single
            # scan with the graph axis as the batch axis (the vmapped
            # per-graph route leaves every op with a trailing dim of 1)
            return _fb_banded_stacked(
                cf, lhs, lengths, chunk_size, want_posts
            )

        def one(cf_b, lhs_b, len_b):
            return _fb_single(
                cf_b, lhs_b[None], len_b[None], chunk_size, want_posts
            )

        posts, logZ = jax.vmap(one)(cf, lhs, lengths)
        if posts is not None:
            posts = posts[:, 0]
        return posts, logZ[:, 0]
    return _fb_single(cf, lhs, lengths, chunk_size, want_posts)


def pdfposteriors(cf: CompiledFSM, lhs, lengths=None, *, chunk_size: int | None = None):
    """Batched LF-MMI posterior computation (reference ``pdfposteriors``,
    src/inference.jl:145-205).

    ``lhs``: (B, N, P) log-likelihoods; ``lengths``: (B,) frame counts.
    Returns (posteriors (B, N, P) real probabilities, logZ (B,) total
    log-marginals).  Posteriors are exactly zero past each sequence length.
    Not differentiable — use :func:`logmarginal` / :func:`lfmmi_loss` for
    gradients (the gradient of logZ *is* the posterior matrix).
    """
    return _dispatch(cf, lhs, lengths, chunk_size, True)


def forward(cf: CompiledFSM, lhs, lengths=None, *, chunk_size: int | None = None):
    """Forward pass only: log-marginals logZ (B,)."""
    _, logZ = _dispatch(cf, lhs, lengths, chunk_size, False)
    return logZ


def _stop_gradient_floats(tree):
    """stop_gradient on inexact leaves only: integer fields (final_state,
    index arrays) stay CONCRETE under jit so static uses such as
    ``int(cf.final_state)`` keep working — a blanket
    tree_map(stop_gradient) would turn them into tracers."""
    return jax.tree.map(
        lambda x: lax.stop_gradient(x)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.inexact)
        else x,
        tree,
    )


def logmarginal(cf: CompiledFSM, lhs, lengths=None, *, chunk_size: int | None = None):
    """Differentiable total log-marginal log p(X | graph), (B,).

    d logZ / d lhs = pdf posteriors (standard LF-MMI identity); implemented
    as an exact first-order surrogate so the scan itself is never
    differentiated (the backward recursion already computes the gradient,
    reference SURVEY §3.1 note)."""
    lhs = jnp.asarray(lhs)
    lhs_sg = lax.stop_gradient(lhs)
    posts, logZ = pdfposteriors(
        _stop_gradient_floats(cf), lhs_sg, lengths, chunk_size=chunk_size
    )
    surr = jnp.einsum("bnp,bnp->b", posts, lhs - lhs_sg)
    return logZ + surr


def lfmmi_loss(
    num_cf: CompiledFSM,
    den_cf: CompiledFSM,
    lhs,
    lengths=None,
    *,
    chunk_size: int | None = None,
):
    """LF-MMI objective per utterance: -(log p_num - log p_den), (B,).

    ``num_cf`` is typically a stacked batch of per-utterance numerator
    graphs; ``den_cf`` the shared denominator graph.  Differentiable w.r.t.
    ``lhs`` with gradient γ_den - γ_num."""
    num = logmarginal(num_cf, lhs, lengths, chunk_size=chunk_size)
    den = logmarginal(den_cf, lhs, lengths, chunk_size=chunk_size)
    return den - num


# ---------------------------------------------------------------------------
# reference-parity conveniences
# ---------------------------------------------------------------------------

# naming parity with the reference API (src/inference.jl exports
# ``compile``/``batch``; ``stack`` is the padded-stack batch).
compile = compile_fsm
batch = stack


def expand(V, seqlength=None):
    """Likelihood expansion (reference ``expand``, src/inference.jl:38-60):
    (P, N) -> (P+1, N+1) with the phony-pdf row zero(K) inside the sequence
    and one(K) past it, real rows zeroed past ``seqlength``.

    The scan pipeline applies this masking per frame internally
    (``_make_elhs``); this standalone form exists for API parity and
    host-side oracles."""
    V = jnp.asarray(V)
    P, N = V.shape
    if seqlength is None:
        seqlength = N
    out = jnp.full((P + 1, N + 1), NEG_INF, V.dtype)
    out = out.at[:P, :N].set(V)
    t = jnp.arange(N + 1)
    active = t < seqlength
    out = jnp.where(active[None, :], out, NEG_INF)
    out = out.at[P, :].set(jnp.where(active, NEG_INF, 0.0))
    return out


def _full_recursion(cf: CompiledFSM, lhs, lengths, direction: str):
    lhs = jnp.asarray(lhs)
    B, N, P = lhs.shape
    if lengths is None:
        lengths = jnp.full((B,), N)
    lengths = jnp.minimum(jnp.asarray(lengths, dtype=jnp.int32), N)
    Sp = cf.padded_states
    Nf = N + 1
    lhs_tm = jnp.pad(jnp.moveaxis(lhs, 1, 0), ((0, Nf - N), (0, 0), (0, 0)))
    ts = jnp.arange(Nf, dtype=jnp.int32)
    kern = _make_kernels(cf, lengths)

    if direction == "alpha":
        x0 = jnp.broadcast_to(cf.alpha_hat[:, None], (Sp, B)).astype(lhs.dtype)

        def step(carry, inp):
            lhs_t, t = inp
            y = jnp.where(t == 0, x0, kern.fwd_mv(carry))
            y = y + kern.elhs(lhs_t, t)
            return y, y

        _, ys = lax.scan(step, x0, (lhs_tm, ts))
    else:

        def step(carry, inp):
            lhs_t, t = inp
            y = jnp.where(t == Nf - 1, jnp.zeros((Sp, B), lhs.dtype),
                          kern.bwd_mv(carry))
            bb = y + kern.elhs(lhs_t, t)
            return bb, y

        _, ys = lax.scan(
            step, jnp.zeros((Sp, B), lhs.dtype), (lhs_tm, ts), reverse=True
        )
    return jnp.moveaxis(ys, 2, 0)  # (B, Nf, Sp)


def alpha_recursion(cf: CompiledFSM, lhs, lengths=None):
    """Full forward messages α (B, N+1, S) — the reference's ``αrecursion``
    (src/inference.jl:62-74).  Unrescaled; intended for moderate N/S (the
    production path ``pdfposteriors`` never materializes this)."""
    return _full_recursion(cf, lhs, lengths, "alpha")


def beta_recursion(cf: CompiledFSM, lhs, lengths=None):
    """Full backward messages β (B, N+1, S) — the reference's ``βrecursion``
    (src/inference.jl:99-110)."""
    return _full_recursion(cf, lhs, lengths, "beta")
