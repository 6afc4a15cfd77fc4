"""Blocked gather-matmul-scatter (GMS) operator for large sparse graphs.

The answer to the reference's warp-per-row CUDA SpMV
(reference src/linalg.jl:213-233) at the 2M-arc scale, in the probability
domain: compile-time, the edge set of T̂ is split into

* a **band** part — edge offsets (dst - src) shared by a large fraction of
  states (HMM self-loops and chain arcs after the compiler's plane-major
  state layout) — applied as shifted elementwise multiply-adds;
* a **blocked** part — destination states tiled into contiguous blocks of
  128; each block's union-of-sources becomes a gathered (Smax, B) panel and
  the block's weights a dense (Smax, 128) matrix, so the update is a batched
  matmul (for n-gram LM ∘ HMM graphs the source sets are the shared
  predecessor-histories, giving ~1:1 densification);
* a **residue** — edges of blocks with pathologically many distinct sources,
  applied as a plain scatter-add.

Everything is static-shaped; padding gathers point at state 0 with weight 0.
Weights are stored as probabilities (exp of log weights): arcs below f32
range (~ -87 nats) vanish, far below engine resolution.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "BlockOperator",
    "build_block_operator",
    "block_matvec",
    "block_matvec_max_arg",
    "block_max_arg_supported",
    "tier_dst_inverse",
]


class BlockOperator(NamedTuple):
    """Pytree of the edge-set parts (arrays only; static metadata — band
    offsets, per-tier access descriptors and overflow-family descriptors —
    lives on the CompiledFSM so jit sees it as compile-time constants)."""

    band_w: Optional[jnp.ndarray]  # (nOffsets, Sp) probabilities
    tiers: tuple  # of (src_idx (K, Sm), dst_idx (K, 128), W (K, Sm, 128))
    res_src: Optional[jnp.ndarray]  # (R,)
    res_dst: Optional[jnp.ndarray]
    res_w: Optional[jnp.ndarray]
    # overflow-family weights (one array per meta ov_desc; see
    # _fit_in_family/_fit_out_family for the descriptor grammar)
    ov_w: tuple = ()


def _affine_params(idx: np.ndarray):
    """Return (base, dk, dm) if idx[k, m] == base + k*dk + m*dm, else None."""
    K, M = idx.shape
    base = int(idx[0, 0])
    dk = int(idx[1, 0] - idx[0, 0]) if K > 1 else 1
    dm = int(idx[0, 1] - idx[0, 0]) if M > 1 else 1
    expect = base + np.arange(K)[:, None] * dk + np.arange(M)[None, :] * dm
    return (base, dk, dm) if np.array_equal(idx, expect) else None


def _window(base, rows, stride, width, limit):
    """Fit the strided view x[base' : base' + rows*stride].reshape(rows,
    stride)[:, col0:col0+width] inside [0, limit): returns (base', col0) or
    None.  col0 shifts the window left when the naive view would overrun."""
    col0 = max(0, base + rows * stride - limit)
    base2 = base - col0
    if base2 >= 0 and col0 + width <= stride and base2 + rows * stride <= limit:
        return base2, col0
    return None


def _gather_desc(idx: np.ndarray, limit: int):
    """Classify a (K, Sm) gather index pattern.

    Affine patterns are emitted as slice+reshape(+transpose) views instead
    of a random row gather.  Returns one of:
      ('affine_k_major', base, dk, col0)  view (K, dk)[:, col0:col0+Sm]
      ('affine_s_major', base, ds, col0)  view (Sm, ds)[:, col0:col0+K] swap
      ('diag', base, dm)                  K == 1, arbitrary stride: strided
                                          single-row gather (e.g. a backoff
                                          LM's diagonal context states)
      ('gather',)
    """
    p = _affine_params(idx)
    if p is not None:
        base, dk, dm = p
        K, Sm = idx.shape
        if dm == 1 and dk >= Sm and base >= 0:
            w = _window(base, K, dk, Sm, limit)
            if w is not None:
                return ("affine_k_major", w[0], dk, w[1])
        if dk == 1 and dm >= K and base >= 0:
            w = _window(base, Sm, dm, K, limit)
            if w is not None:
                return ("affine_s_major", w[0], dm, w[1])
        if K == 1 and dm > 1 and base >= 0 and base + (Sm - 1) * dm < limit:
            return ("diag", base, dm)
    return ("gather",)


def _scatter_desc(idx: np.ndarray, limit: int):
    """Classify a (K, D) scatter index pattern.

      ('contig', base)                  idx = base + k*D + d -> contig write
      ('affine_d', base)                idx = base + k + d*K -> transp contig
      ('affine_k_pad', base, dk, col0)  idx affine w/ dk > D -> strided
                                        row-chunks: view (K, dk)[:, col0:+D]
      ('affine_d_pad', base, dd, col0)  idx affine w/ dd > K -> transposed
                                        strided row-chunks: view (D, dd)[:, col0:+K]
      ('diag', base, dd)                K == 1, arbitrary stride: strided
                                        single-row scatter
      ('scatter',)
    """
    p = _affine_params(idx)
    if p is not None:
        base, dk, dd = p
        K, D = idx.shape
        if dk == D and dd == 1 and 0 <= base and base + K * D <= limit:
            return ("contig", base)
        if dk == 1 and dd == K and 0 <= base and base + D * K <= limit:
            return ("affine_d", base)
        if dd == 1 and dk > D and base >= 0:
            w = _window(base, K, dk, D, limit)
            if w is not None:
                return ("affine_k_pad", w[0], dk, w[1])
        if dk == 1 and dd > K and base >= 0:
            w = _window(base, D, dd, K, limit)
            if w is not None:
                return ("affine_d_pad", w[0], dd, w[1])
        if K == 1 and dd > 1 and base >= 0 and base + (D - 1) * dd < limit:
            return ("diag", base, dd)
    return ("scatter",)


def _fit_in_family(srcs, lanes, w, block, Sp, dtype, max_col=512):
    """Fit the in-edges of one overflow lane-group (dst lane ``l`` receives
    from ``srcs``) into a structured family:

      ('col', base, stride, D): src = base + r·stride + l, r ∈ [0, D)
          — a lane-aligned column of D source rows (e.g. reversed bigram
          rows B(b) ← (b, c), or an ov→ov constant offset at D = 1);
          W (D, block) with W[r, l] = weight.
      ('win', base, stride, block): src ∈ [base + l·stride, +block)
          — one contiguous source window per lane (e.g. backoff arcs
          B(b) ← exits of history row b); W (block, block) = W[l, pos].

    Returns (desc, W) or None (→ the edges go through the generic tier
    grouping instead)."""
    vals = srcs - lanes
    u = np.unique(vals)
    if len(u) <= max_col:
        d = np.diff(u)
        if len(u) == 1 or (d > 0).all() and (d == d[0]).all():
            stride = int(d[0]) if len(u) > 1 else 0
            base = int(u[0])
            if base >= 0 and base + (len(u) - 1) * stride + block <= Sp:
                r = np.searchsorted(u, vals)
                W = np.zeros((len(u), block), dtype=dtype)
                W[r, lanes] = w
                return ("col", base, stride, len(u)), W
    ul = np.unique(lanes)
    if len(ul) >= 2:
        order = np.lexsort((srcs, lanes))
        first = np.searchsorted(lanes[order], ul)
        mins = srcs[order][first]  # min src per present lane
        dl = int(ul[1] - ul[0])
        if (int(mins[1]) - int(mins[0])) % dl == 0:
            stride = (int(mins[1]) - int(mins[0])) // dl
            base = int(mins[0]) - int(ul[0]) * stride
            pos = srcs - (base + lanes * stride)
            if (
                stride > 0
                and base >= 0
                and (pos >= 0).all()
                and (pos < block).all()
                and base + (block - 1) * stride + block <= Sp
            ):
                W = np.zeros((block, block), dtype=dtype)
                W[lanes, pos] = w
                return ("win", base, stride, block), W
    return None


def _fit_out_family(dsts, lanes, w, block, Sp, dtype, max_col=512):
    """Mirror of :func:`_fit_in_family` for out-edges of an overflow
    lane-group (src lane ``l`` feeds ``dsts``): 'col' = lane-aligned column
    of destination rows (e.g. bigram rows B(b) → (b, c)); 'win' = one
    contiguous destination window per lane (e.g. reversed backoff arcs)."""
    return _fit_in_family(dsts, lanes, w, block, Sp, dtype, max_col)


def _fit_families(other, lanes, w, block, Sp, dtype):
    """Fit one ov lane-group's edges into 1-2 families (list of (desc, W),
    leftover_mask).  A group can mix structurally distinct families (e.g.
    backoff-arc windows + an ov→ov constant-offset column); when a single
    fit fails, split by (other - lane) value multiplicity — column families
    repeat one value across most lanes, window families scatter them."""
    fam = _fit_in_family(other, lanes, w, block, Sp, dtype)
    if fam is not None:
        return [fam], np.zeros(len(other), dtype=bool)
    vals = other - lanes
    u, inv, cnt = np.unique(vals, return_inverse=True, return_counts=True)
    nlanes = max(len(np.unique(lanes)), 2)
    colish = cnt[inv] >= max(2, nlanes // 2)
    fams = []
    left = np.zeros(len(other), dtype=bool)
    for mask in (colish, ~colish):
        if not mask.any():
            continue
        f = _fit_in_family(other[mask], lanes[mask], w[mask], block, Sp,
                           dtype)
        if f is not None:
            fams.append(f)
        else:
            left |= mask
    return fams, left


def _ov_families(src, dst, w, ov_lo, ov_hi, block, Sp, dtype):
    """Classify edges touching the overflow region [ov_lo, ov_hi) into
    per-group structured families.  Returns (descs, weights, leftover_mask,
    touching_mask) where each desc is ('in'|'out', group_base, form, base,
    stride, D) and leftover edges must go through the generic tier
    grouping."""
    descs, weights = [], []
    leftover = np.zeros(len(src), dtype=bool)
    is_in = (dst >= ov_lo) & (dst < ov_hi)
    is_out = (src >= ov_lo) & (src < ov_hi) & ~is_in
    for kind, mask, key, oth in (
        ("in", is_in, dst, src),
        ("out", is_out, src, dst),
    ):
        if not mask.any():
            continue
        for g in np.unique(key[mask] // block):
            g0 = int(g) * block
            sel = mask & (key >= g0) & (key < g0 + block)
            fams, left = _fit_families(
                oth[sel], key[sel] - g0, w[sel], block, Sp, dtype
            )
            for desc, W in fams:
                descs.append((kind, g0) + desc)
                weights.append(W)
            if left.any():
                idx = np.flatnonzero(sel)
                leftover[idx[left]] = True
    touching = is_in | is_out
    return descs, weights, leftover, touching


def build_block_operator(
    src,
    dst,
    w_log,
    num_states: int,
    *,
    block: int = 128,
    tier_sizes=(128, 256, 512),
    band_max: int = 8,
    dtype=np.float32,
    ov_region=None,
):
    """Build (BlockOperator, band_offsets) from a COO edge list of T̂.

    ``w_log``: log-domain weights; stored as exp().  ``num_states``: padded
    state count Sp (multiple of ``block``).

    ``ov_region``: optional (ov_lo, ov_hi, lane_w) — slot range of the
    *overflow* states plus the layout's lane-group width (= the pdf-group
    cap).  compile_fsm's capped pdf-grouped layout parks the states that
    exceed the uniform per-pdf slot count there (e.g. a backoff LM's
    backoff states).  Arcs touching the region are lifted into structured
    families (lane-aligned windows/columns, see _fit_in_family) applied
    as single slab ops; arcs that fit no family fall
    back to the generic tier grouping.  Band arcs (shared offsets) cover
    the region like any other states.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.exp(np.asarray(w_log, dtype=np.float64)).astype(dtype)
    Sp = num_states
    assert Sp % block == 0

    # --- band extraction ------------------------------------------------
    offs = dst - src
    uniq, counts = np.unique(offs, return_counts=True)
    thresh = max(Sp // 8, 64)
    cand = uniq[counts >= thresh]
    if len(cand) > band_max:
        cand = cand[np.argsort(-counts[np.isin(uniq, cand)])][:band_max]
    band_offsets = tuple(int(o) for o in sorted(cand))
    in_band = np.isin(offs, cand) if band_offsets else np.zeros(len(offs), bool)

    band_w = None
    if band_offsets:
        band_w = np.zeros((len(band_offsets), Sp), dtype=dtype)
        omap = {o: i for i, o in enumerate(band_offsets)}
        bo = offs[in_band]
        bd = dst[in_band]
        bw = w[in_band]
        oi = np.array([omap[int(o)] for o in bo], dtype=np.int64)
        band_w[oi, bd] = bw

    src, dst, w = src[~in_band], dst[~in_band], w[~in_band]

    # --- overflow families ----------------------------------------------
    ov_descs, ov_weights = (), ()
    if ov_region is not None and len(src):
        ov_lo, ov_hi, lane_w = ov_region
        assert ov_lo % lane_w == 0
        ds, ws, leftover, touching = _ov_families(
            src, dst, w, ov_lo, ov_hi, lane_w, Sp, dtype
        )
        ov_descs, ov_weights = tuple(ds), tuple(ws)
        keep = ~touching | leftover
        src, dst, w = src[keep], dst[keep], w[keep]

    # --- blocked part ---------------------------------------------------
    def pad_unique(u, size):
        """Pad a sorted unique index list to ``size`` entries.  When the
        list is affine, the padding continues the stride (weights stay zero,
        so the extra slots are no-ops) — this keeps near-affine blocks on
        the affine fast path (e.g. pruned LM rows whose surviving successor
        sets are subsets of a strided grid).  Falls back to zero padding
        (which demotes the tier to the generic gather/scatter path)."""
        out = np.zeros(size, dtype=np.int64)
        out[: len(u)] = u
        pad = size - len(u)
        if pad and len(u) >= 2:
            d = np.diff(u)
            if (d == d[0]).all() and d[0] > 0:
                ext = u[-1] + d[0] * np.arange(1, pad + 1)
                if ext[-1] < Sp:
                    out[len(u):] = ext
        return out

    def group(src, dst, w, by):
        """Tile edges into 128-wide blocks along ``by`` ('dst' grouped:
        dense (tier_srcs x block) panels; 'src' grouped: (block x tier_dsts)).
        Returns ({tier: [(sidx, didx, W)]}, overflow edges)."""
        key = dst if by == "dst" else src
        other = src if by == "dst" else dst
        order = np.lexsort((other, key))
        s, d, ww, kk, oo = (
            src[order], dst[order], w[order], key[order] // block,
            other[order],
        )
        acc = {}
        over = []
        starts = np.searchsorted(kk, np.arange(Sp // block))
        ends = np.searchsorted(kk, np.arange(Sp // block) + 1)
        for b in range(Sp // block):
            lo, hi = starts[b], ends[b]
            if lo == hi:
                continue
            uoth = np.unique(oo[lo:hi])
            # affine gap-fill: when the index set has holes but lies on one
            # affine grid (e.g. a pruned LM row whose surviving successors
            # miss some slots), lift it onto the minimal grid ANCHORED at
            # its residue class (start = u[0] mod stride) — zero-weight
            # fill slots keep the panel affine, and the common anchor lets
            # blocks whose first surviving slot differs still stack into
            # ONE cross-block affine pattern instead of degrading the tier
            # to a gather/scatter
            if len(uoth) >= 2:
                du = np.diff(uoth)
                g = int(np.gcd.reduce(du))
                tier0 = next(
                    (t for t in tier_sizes if len(uoth) <= t), None
                )
                if g > 0 and tier0 is not None:
                    start = int(uoth[0]) % g
                    span = (int(uoth[-1]) - start) // g + 1
                    # only fill when it stays within the tier size the raw
                    # set would use — growing the size class would inflate
                    # panels (and the Viterbi uint8 candidate range) for
                    # sets that are not really grid-structured
                    if span > len(uoth) and span <= tier0:
                        uoth = start + g * np.arange(span, dtype=np.int64)
            tier = next((t for t in tier_sizes if len(uoth) <= t), None)
            if tier is None:
                over.append((s[lo:hi], d[lo:hi], ww[lo:hi]))
                continue
            pos = np.searchsorted(uoth, oo[lo:hi])
            inblk = (key[order][lo:hi] - b * block).astype(np.int64)
            pad = tier - len(uoth)
            if pad and len(uoth) >= 2:
                du = np.diff(uoth)
                affine = (du == du[0]).all() and du[0] > 0
                if affine and uoth[-1] + du[0] * pad >= Sp:
                    # affine index set whose stride continuation would
                    # overrun the state range: keep the EXACT length as its
                    # own tier size (an affine descriptor with an odd width
                    # beats a zero-padded one that degrades to a gather)
                    tier = len(uoth)
            upad = pad_unique(uoth, tier)
            acc.setdefault(tier, [])
            if by == "dst":
                W = np.zeros((tier, block), dtype=dtype)
                W[pos, inblk] = ww[lo:hi]
                sidx = upad.astype(np.int32)
                didx = (b * block + np.arange(block)).astype(np.int32)
            else:
                W = np.zeros((block, tier), dtype=dtype)
                W[inblk, pos] = ww[lo:hi]
                sidx = (b * block + np.arange(block)).astype(np.int32)
                didx = upad.astype(np.int32)
            acc[tier].append((sidx, didx, W))
        return acc, over

    def stack_tiers(accs):
        out = []
        for acc in accs:
            for t, items in acc.items():
                if not items:
                    continue
                out.append(
                    (
                        np.stack([x[0] for x in items]),
                        np.stack([x[1] for x in items]),
                        np.stack([x[2] for x in items]),
                    )
                )
        return out

    def all_affine(ts):
        return all(
            _gather_desc(sidx, Sp)[0] != "gather"
            and _scatter_desc(didx, Sp)[0] != "scatter"
            for sidx, didx, _ in ts
        )

    def majority_lane_split(esrc, edst, ew):
        """Split edges into (majority, rest): per source block, edges whose
        destination lane (dst % block) is the block's modal lane.  Mixed
        structural families (e.g. a backoff LM's context arcs riding lane b
        of every successor group, plus its backoff-to-backoff diagonal)
        destroy each other's affine patterns when grouped together; the
        modal lane class isolates the dominant family."""
        blk = esrc // block
        lane = edst % block
        pair = blk * block + lane
        up, cnt = np.unique(pair, return_counts=True)
        ub = up // block
        # modal lane per block
        order = np.lexsort((-cnt, ub))
        first = np.searchsorted(ub[order], np.unique(ub))
        modal = {int(ub[order][f]): int(up[order][f] % block) for f in first}
        maj = np.array([lane[i] == modal[int(blk[i])] for i in range(len(esrc))])
        return maj

    def dense_pool(esrc, edst, ew, max_side=512):
        """Collapse a small leftover edge family into one dense
        (1, Su, Du) tier (gather all unique sources once, one matmul, one
        scatter).  Returns the tier or None."""
        us = np.unique(esrc)
        ud = np.unique(edst)
        if len(us) > max_side or len(ud) > max_side:
            return None
        ps = np.searchsorted(us, esrc)
        pd = np.searchsorted(ud, edst)
        W = np.zeros((1, len(us), len(ud)), dtype=dtype)
        W[0, ps, pd] = ew
        return (
            us[None, :].astype(np.int32),
            ud[None, :].astype(np.int32),
            W,
        )

    tiers_np = []
    res = []
    if len(src):
        acc_d, over = group(src, dst, w, "dst")
        tiers_np = stack_tiers([acc_d])
        if over:
            osrc = np.concatenate([o[0] for o in over])
            odst = np.concatenate([o[1] for o in over])
            ow = np.concatenate([o[2] for o in over])
            acc_s, over2 = group(osrc, odst, ow, "src")
            src_tiers = stack_tiers([acc_s])
            if not (all_affine(src_tiers) and not over2):
                # retry with the modal-lane family split
                maj = majority_lane_split(osrc, odst, ow)
                if maj.any() and not maj.all():
                    acc_m, over_m = group(osrc[maj], odst[maj], ow[maj],
                                          "src")
                    maj_tiers = stack_tiers([acc_m])
                    rest = (osrc[~maj], odst[~maj], ow[~maj])
                    pool = dense_pool(*rest)
                    if all_affine(maj_tiers) and not over_m and pool is not None:
                        src_tiers = maj_tiers + [pool]
                        over2 = []
            tiers_np.extend(src_tiers)
            res = over2

    tiers = [
        (jnp.asarray(s_), jnp.asarray(d_), jnp.asarray(W_))
        for s_, d_, W_ in tiers_np
    ]

    res_src = res_dst = res_w = None
    if res:
        res_src = jnp.asarray(np.concatenate([r[0] for r in res]).astype(np.int32))
        res_dst = jnp.asarray(np.concatenate([r[1] for r in res]).astype(np.int32))
        res_w = jnp.asarray(np.concatenate([r[2] for r in res]))

    tier_descs = tuple(
        (
            _gather_desc(np.asarray(sidx), Sp),
            _scatter_desc(np.asarray(didx), Sp),
        )
        for sidx, didx, _ in tiers
    )

    # highest state row with any nonzero band weight + 1 (static metadata:
    # lets plan-time checks run without touching device arrays under trace)
    band_nz_hi = 0
    if band_w is not None:
        nz = np.flatnonzero(band_w.any(axis=0))
        band_nz_hi = int(nz[-1]) + 1 if len(nz) else 0

    op = BlockOperator(
        band_w=jnp.asarray(band_w) if band_w is not None else None,
        tiers=tuple(tiers),
        res_src=res_src,
        res_dst=res_dst,
        res_w=res_w,
        ov_w=tuple(jnp.asarray(W_) for W_ in ov_weights),
    )
    return op, (band_offsets, tier_descs, band_nz_hi, ov_descs)


def block_matvec(op: BlockOperator, meta, x, precision, *, op_kind="sum"):
    """Probability-domain y = T̂ᵀ ⊗ x (or T̂ ⊗ x for the reversed operator):
    y[j, b] = ⊕_e w[e] · x[src[e], b] over the op's edges.  x: (Sp, B).

    ``meta``: (band_offsets, tier_descs[, band_nz_hi]) — static, from
    build_block_operator.
    ``op_kind``: 'sum' (probability semiring, einsum) or 'max' (tropical
    semiring in the probability domain — max of products, which the per-frame
    rescaled Viterbi scan uses; the broadcast-multiply + max-reduce fuses in
    XLA so the (K, Sm, D, B) intermediate never hits HBM).
    """
    band_offsets, tier_descs = meta[0], meta[1]
    Sp, B = x.shape
    combine = jnp.maximum if op_kind == "max" else (lambda a, b: a + b)
    y = jnp.zeros_like(x)
    if op.band_w is not None:
        for oi, off in enumerate(band_offsets):
            # band edge src = dst - off; wrapped rolls hit zero weights
            xs = x if off == 0 else jnp.roll(x, off, axis=0)
            y = combine(y, op.band_w[oi][:, None] * xs)
    for (sidx, didx, W), (gdesc, ddesc) in zip(op.tiers, tier_descs):
        K, Sm = sidx.shape
        D = didx.shape[1]
        if gdesc[0] == "affine_s_major":
            _, base, ds, c0 = gdesc
            view = jax.lax.slice(x, (base, 0), (base + Sm * ds, B))
            Xg = view.reshape(Sm, ds, B)[:, c0 : c0 + K].swapaxes(0, 1)
        elif gdesc[0] == "affine_k_major":
            _, base, dk, c0 = gdesc
            view = jax.lax.slice(x, (base, 0), (base + K * dk, B))
            Xg = view.reshape(K, dk, B)[:, c0 : c0 + Sm]
        else:
            Xg = x[sidx.reshape(-1)].reshape(K, Sm, B)
        if op_kind == "max":
            Y = jnp.max(W[:, :, :, None] * Xg[:, :, None, :], axis=1)
        else:
            Y = jnp.einsum(
                "ksd,ksb->kdb",
                W,
                Xg,
                # at least f32 accumulation always (bf16 state must NOT
                # demote the Sm-wide contraction); an f64-compiled
                # operator (the bench's precision-floor probe) promotes
                preferred_element_type=jnp.promote_types(x.dtype, jnp.float32),
                precision=precision,
            )
        if ddesc[0] == "contig":
            base = ddesc[1]
            flat = Y.reshape(-1, B)
        elif ddesc[0] == "affine_d":
            base = ddesc[1]
            flat = Y.swapaxes(0, 1).reshape(-1, B)
        elif ddesc[0] in ("affine_k_pad", "affine_d_pad"):
            # strided row-chunks: update a column window of a
            # (rows, stride, B) view of y — XLA lowers slice/update-slice,
            # not scatter
            _, base, stride, c0 = ddesc
            if ddesc[0] == "affine_k_pad":
                rows, width, Yv = K, D, Y
            else:
                rows, width, Yv = D, K, Y.swapaxes(0, 1)
            seg = jax.lax.slice(y, (base, 0), (base + rows * stride, B))
            seg = seg.reshape(rows, stride, B)
            win = seg[:, c0 : c0 + width]
            seg = seg.at[:, c0 : c0 + width].set(combine(win, Yv))
            y = jax.lax.dynamic_update_slice(
                y, seg.reshape(rows * stride, B), (base, 0)
            )
            continue
        else:
            if op_kind == "max":
                y = y.at[didx.reshape(-1)].max(Y.reshape(-1, B))
            else:
                y = y.at[didx.reshape(-1)].add(Y.reshape(-1, B))
            continue
        sl = y[base : base + K * D, :]
        y = y.at[base : base + K * D, :].set(combine(sl, flat))
    if op.res_src is not None:
        contrib = op.res_w[:, None] * x[op.res_src]
        if op_kind == "max":
            y = y.at[op.res_dst].max(contrib)
        else:
            y = y.at[op.res_dst].add(contrib)
    # overflow families (generic gather/scatter forms)
    ov_descs = meta[3] if len(meta) > 3 else ()
    for desc, W in zip(ov_descs, op.ov_w):
        kind, g0, form, base, stride, D = desc
        block = W.shape[-1]
        lanes = np.arange(block)
        if form == "col":
            grid = base + np.arange(D)[:, None] * stride + lanes[None, :]
        else:  # 'win': D == block rows, one window per lane
            grid = (base + lanes[:, None] * stride) + np.arange(block)[None, :]
        grid = jnp.asarray(grid)
        if kind == "in":
            rows = D if form == "col" else block
            Xg = _strided_rows(x, base, rows, stride, block, Sp)
            if Xg is None:
                Xg = x[grid.reshape(-1)].reshape(grid.shape + (B,))
            if form == "col":
                # y[g0 + l] ⊕= Σ_r W[r, l] · x[base + r·stride + l]
                prod = W[:, :, None] * Xg
            else:
                # y[g0 + l] ⊕= Σ_j W[l, j] · x[base + l·stride + j]
                prod = W[:, :, None] * Xg
            seg = (jnp.max(prod, axis=0) if form == "col" else
                   jnp.max(prod, axis=1)) if op_kind == "max" else (
                jnp.sum(prod, axis=0) if form == "col" else
                jnp.sum(prod, axis=1))
            sl = y[g0 : g0 + block]
            y = y.at[g0 : g0 + block].set(combine(sl, seg))
        else:
            xg = x[g0 : g0 + block]  # (block, B)
            if form == "col":
                # y[base + r·stride + l] ⊕= W[r, l] · x[g0 + l]
                contrib = W[:, :, None] * xg[None, :, :]
            else:
                # y[base + l·stride + j] ⊕= W[l, j] · x[g0 + l]
                contrib = W[:, :, None] * xg[:, None, :]
            flat = contrib.reshape(-1, B)
            if op_kind == "max":
                y = y.at[grid.reshape(-1)].max(flat)
            else:
                y = y.at[grid.reshape(-1)].add(flat)
    return y


# ---------------------------------------------------------------------------
# tropical matvec with in-pass argmax (compressed backpointers)
# ---------------------------------------------------------------------------

def _ov_cand_layout(meta, ov_lo, cmax):
    """Per-ov-group candidate-id layout for the uint8 bp encoding.

    Overflow DESTINATIONS never receive tier or ov_out candidates, so
    their id space restarts at 0: each group's 'in' families get
    consecutive ranges [cum, cum + size) in desc order, with the band
    offsets after them at [C_g, C_g + nO).  Returns {group_base: [(desc,
    id_base), ...]} plus {group_base: C_g}."""
    fam, csize = {}, {}
    for desc in (meta[3] if len(meta) > 3 else ()):
        kind, g0, form, base, stride, D = desc
        if kind != "in":
            continue
        cum = csize.get(g0, 0)
        fam.setdefault(g0, []).append((desc, cum))
        csize[g0] = cum + (cmax if form == "win" else D)
    return fam, csize


def block_max_arg_supported(op: BlockOperator, meta, ov_lo=None,
                            cmax=None) -> bool:
    """True when block_matvec_max_arg can run: one tier, no residue,
    affine gather/scatter descriptors, and every candidate id fitting a
    uint8 (the Viterbi-at-scale bp stream).

    With overflow families (``ov_lo``/``cmax`` from the compile's
    ov_layout): core destinations encode tier [0, Sm) + bands [Sm, Sm+nO)
    + one ov_out id (each overflow out-family contributes at most ONE
    candidate per destination); overflow destinations encode their in-
    families from 0 with bands after (see _ov_cand_layout) — both spaces
    must stay under 255, the tier must not write into the overflow
    region, and no two out-families may share a destination."""
    if op.res_src is not None or len(op.tiers) != 1:
        return False
    (gdesc, ddesc) = meta[1][0]
    # any gather form works (generic index gather fallback); the scatter
    # must be window-expressible to track the winning candidate
    if ddesc[0] not in ("contig", "affine_d", "affine_k_pad", "affine_d_pad"):
        return False
    Sm = op.tiers[0][0].shape[1]
    nO = len(meta[0])
    if op.ov_w:
        if ov_lo is None or cmax is None:
            return False
        if Sm + nO + 1 >= 255:
            return False
        if int(np.asarray(op.tiers[0][1]).max()) >= ov_lo:
            return False  # tier ids would collide with ov in-family ids
        _, csize = _ov_cand_layout(meta, ov_lo, cmax)
        if any(C + nO >= 255 for C in csize.values()):
            return False
        # each dst must receive at most one out-family candidate — both
        # ACROSS families and WITHIN one (a stride < lane width would fold
        # two (r, l) grid cells onto one destination: the scatter would be
        # order-dependent and the single-source ov_out decode table wrong)
        seen = set()
        for desc in meta[3]:
            kind, g0, form, base, stride, D = desc
            if kind != "out":
                continue
            if form == "col":
                dsts = (base + np.arange(D)[:, None] * stride
                        + np.arange(cmax)[None, :]).ravel()
            else:
                dsts = (base + np.arange(cmax)[:, None] * stride
                        + np.arange(cmax)[None, :]).ravel()
            ds = set(int(d) for d in dsts)
            if len(ds) != len(dsts) or (seen & ds):
                return False
            seen |= ds
        return True
    return Sm + nO < 255


def tier_dst_inverse(op: BlockOperator, num_states: int) -> np.ndarray:
    """Host-side inverse of the single tier's destination map: k_of[d] = the
    tier block writing state d (-1 if none).  Used by the backpointer decode
    (src = sidx[k_of[d], cand])."""
    didx = np.asarray(op.tiers[0][1])
    k_of = np.full(num_states, -1, dtype=np.int32)
    K, D = didx.shape
    k_of[didx.reshape(-1)] = np.repeat(np.arange(K, dtype=np.int32), D)
    return k_of


def _maxarg_packed(prod, axis, nbits=8):
    """(max, argmax) via TWO plain max-reductions instead of one variadic
    tuple-reduce: the value comes from an exact f32 ``jnp.max``; the argmax
    from an int32 max over ``(value_bits & ~mask) | idx`` — nonnegative f32
    bit patterns are order-isomorphic to their int32 bits, so dropping the
    low ``nbits`` mantissa bits and packing the candidate id there keeps
    the comparison keyed on the value (ties within 2^-16 relative resolve
    toward the LARGER id; any near-maximizer yields a path within f32
    round-off of optimal, and the id is only a backpointer — the carried
    Viterbi VALUE stays the exact f32 max).

    The hypothesis: two plain max-reductions beat the variadic (max,
    argmax) comparator (2 selects/element).  It did not hold where it was
    measured, so it is opt-in (MMTPU_VIT_PACKED=1), parity-tested against
    the variadic path, and not measured on the GPU.

    Requires prod >= 0 (probability domain) and idx range < 2^nbits.
    """
    ids = jax.lax.broadcasted_iota(jnp.int32, prod.shape, axis)
    bits = jax.lax.bitcast_convert_type(prod, jnp.int32)
    packed = jnp.bitwise_or(
        jnp.bitwise_and(bits, jnp.int32(-(1 << nbits))), ids
    )
    best = jnp.max(packed, axis=axis)
    return jnp.max(prod, axis=axis), jnp.bitwise_and(
        best, jnp.int32((1 << nbits) - 1)
    )


def _strided_rows(x, base, rows, stride, width, Sp):
    """(rows, width, B) view of ``x[base + r*stride : +width]`` via
    slice+reshape (no index gather) or None when it cannot be
    window-shifted into range — callers fall back to a gather."""
    if stride <= 0 or width > stride or base < 0:
        return None
    c0 = max(0, base + rows * stride - Sp)
    b2 = base - c0
    if b2 < 0 or c0 + width > stride:
        return None
    B = x.shape[1]
    view = jax.lax.slice(x, (b2, 0), (b2 + rows * stride, B))
    return view.reshape(rows, stride, B)[:, c0 : c0 + width]


def _maxarg(prod, idx, axis):
    """(max, argmax) over ``axis`` in ONE variadic lax.reduce pass (XLA
    fuses the broadcast-multiply producer, so the (K, Sm, D, B) product is
    never materialized and the reduction costs one comparison chain instead
    of separate max + argmax sweeps).

    Ties return *some* maximizing index (reduction-tree-order dependent,
    deterministic per compilation): the comparator is a strict > so each
    element costs 2 selects, not 4 — any maximizer yields an optimal
    Viterbi path, which is all the decoder needs."""
    neg = jnp.asarray(-jnp.inf, prod.dtype)

    def comp(a, b):
        av, ai = a
        bv, bi = b
        take_b = bv > av
        return jnp.where(take_b, bv, av), jnp.where(take_b, bi, ai)

    return jax.lax.reduce(
        (prod, idx), (neg, jnp.asarray(0, idx.dtype)), comp, (axis,)
    )


def block_matvec_max_arg(op: BlockOperator, meta, x, ov_span=None):
    """Tropical y = T̂ᵀ ⊗max x with per-destination winning-candidate ids.

    Returns (y (Sp, B), cand (Sp, B) int32): cand < Sm is a tier source
    position (src = sidx[k_of[dst], cand]); Sm <= cand < Sm + nO is a band
    offset index (src = dst - band_offsets[cand - Sm]); 255 = no incoming
    candidate (zero column).  Requires block_max_arg_supported.  The rank-1
    ω column (phony final state) is NOT applied here — the at-scale decoder
    resolves it separately (viterbi._viterbi_scale_bp).

    ``ov_span`` = (ov_lo, nOv, cmax) activates overflow-family candidates
    (see block_max_arg_supported): core destinations additionally get the
    single ov_out id Sm + nO; overflow destinations use the per-group
    in-family/band layout of _ov_cand_layout (their ids are tracked above
    255 during the sweep, then remapped into each group's own uint8 space).
    """
    band_offsets, tier_descs = meta[0], meta[1]
    if op.ov_w and ov_span is None:
        raise ValueError(
            "operator has overflow families; pass ov_span=(ov_lo, nOv, "
            "cmax) or their contributions would be silently dropped"
        )
    Sp, B = x.shape
    sidx, didx, W = op.tiers[0]
    (gdesc, ddesc) = tier_descs[0]
    K, Sm = sidx.shape
    D = didx.shape[1]
    nO = len(band_offsets)

    y = jnp.zeros_like(x)
    cand = jnp.full((Sp, B), 255, dtype=jnp.int32)
    if op.band_w is not None:
        for oi, off in enumerate(band_offsets):
            xs = x if off == 0 else jnp.roll(x, off, axis=0)
            prod = op.band_w[oi][:, None] * xs
            upd = prod > y
            y = jnp.where(upd, prod, y)
            cand = jnp.where(upd, Sm + oi, cand)

    # tier gather (affine views when available, as block_matvec)
    if gdesc[0] == "affine_s_major":
        _, base, ds, c0 = gdesc
        view = jax.lax.slice(x, (base, 0), (base + Sm * ds, B))
        Xg = view.reshape(Sm, ds, B)[:, c0 : c0 + K].swapaxes(0, 1)
    elif gdesc[0] == "affine_k_major":
        _, base, dk, c0 = gdesc
        view = jax.lax.slice(x, (base, 0), (base + K * dk, B))
        Xg = view.reshape(K, dk, B)[:, c0 : c0 + Sm]
    else:
        Xg = x[sidx.reshape(-1)].reshape(K, Sm, B)
    import os

    if os.environ.get("MMTPU_VIT_PACKED"):
        Y, A = _maxarg_packed(W[:, :, :, None] * Xg[:, :, None, :], 1)
    else:
        s_ids = jax.lax.broadcasted_iota(jnp.int32, (K, Sm, D, B), 1)
        Y, A = _maxarg(W[:, :, :, None] * Xg[:, :, None, :], s_ids, 1)

    # tier scatter of (value, cand) through the affine window
    if ddesc[0] in ("contig", "affine_d"):
        base = ddesc[1]
        if ddesc[0] == "affine_d":
            Y, A = Y.swapaxes(0, 1), A.swapaxes(0, 1)
        flat_v = Y.reshape(-1, B)
        flat_c = A.reshape(-1, B)
        seg_v = y[base : base + K * D]
        seg_c = cand[base : base + K * D]
        upd = flat_v > seg_v
        y = y.at[base : base + K * D].set(jnp.where(upd, flat_v, seg_v))
        cand = cand.at[base : base + K * D].set(
            jnp.where(upd, flat_c, seg_c)
        )
    else:  # affine_k_pad / affine_d_pad: strided row-chunk window
        _, base, stride, c0 = ddesc
        if ddesc[0] == "affine_k_pad":
            rows, width, Yv, Av = K, D, Y, A
        else:
            rows, width, Yv, Av = D, K, Y.swapaxes(0, 1), A.swapaxes(0, 1)

        def upd_window(buf, val, fill):
            seg = jax.lax.slice(buf, (base, 0), (base + rows * stride, B))
            seg = seg.reshape(rows, stride, B)
            win = seg[:, c0 : c0 + width]
            seg = seg.at[:, c0 : c0 + width].set(
                jnp.where(fill, val, win)
            )
            return jax.lax.dynamic_update_slice(
                buf, seg.reshape(rows * stride, B), (base, 0)
            )

        segy = jax.lax.slice(y, (base, 0), (base + rows * stride, B))
        winy = segy.reshape(rows, stride, B)[:, c0 : c0 + width]
        sel = Yv > winy
        y = upd_window(y, Yv, sel)
        cand = upd_window(cand, Av, sel)

    if ov_span is not None and op.ov_w:
        ov_lo, nOvg, cmaxv = ov_span
        OVIN = 256  # in-family ids tracked above the uint8 range, then
        # remapped per group (the 255 'none' marker must survive the sweep)
        fam, csize = _ov_cand_layout(meta, ov_lo, cmaxv)
        lanes = np.arange(cmaxv)
        for desc, Wv in zip(meta[3], op.ov_w):
            kind, g0, form, base, stride, D = desc
            if kind == "in":
                id_base = OVIN + next(
                    c for d, c in fam[g0] if d == desc
                )
                rows = cmaxv if form == "win" else D
                Xg = _strided_rows(x, base, rows, stride, cmaxv, Sp)
                if Xg is None:  # lane-unaligned layout: index gather
                    grid = (base + np.arange(rows)[:, None] * stride
                            + lanes[None, :])
                    Xg = x[jnp.asarray(grid.reshape(-1))].reshape(
                        rows, cmaxv, B
                    )
                if form == "win":
                    prod = Wv[:, :, None] * Xg  # (l, j, B)
                    ids = jax.lax.broadcasted_iota(
                        jnp.int32, prod.shape, 1
                    )
                    val, arg = _maxarg(prod, ids, 1)  # (l, B)
                else:
                    prod = Wv[:, :, None] * Xg  # (r, l, B)
                    ids = jax.lax.broadcasted_iota(
                        jnp.int32, prod.shape, 0
                    )
                    val, arg = _maxarg(prod, ids, 0)  # (l, B)
                cur = y[g0 : g0 + cmaxv]
                curc = cand[g0 : g0 + cmaxv]
                sel = val > cur
                y = y.at[g0 : g0 + cmaxv].set(jnp.where(sel, val, cur))
                cand = cand.at[g0 : g0 + cmaxv].set(
                    jnp.where(sel, id_base + arg, curc)
                )
            else:
                xg = x[g0 : g0 + cmaxv]  # (l, B)
                if form == "col":
                    contrib = Wv[:, :, None] * xg[None, :, :]  # (r, l, B)
                    rows = D
                else:
                    contrib = Wv[:, :, None] * xg[:, None, :]  # (l, j, B)
                    rows = cmaxv
                c0w = max(0, base + rows * stride - Sp)
                b2w = base - c0w
                if (stride > 0 and cmaxv <= stride and b2w >= 0
                        and c0w + cmaxv <= stride):
                    # strided row-chunk window RMW (slice + update-slice,
                    # no index scatter)
                    def updw(buf, val, fill):
                        seg = jax.lax.slice(
                            buf, (b2w, 0), (b2w + rows * stride, B)
                        ).reshape(rows, stride, B)
                        win = seg[:, c0w : c0w + cmaxv]
                        seg = seg.at[:, c0w : c0w + cmaxv].set(
                            jnp.where(fill, val, win)
                        )
                        return jax.lax.dynamic_update_slice(
                            buf, seg.reshape(rows * stride, B), (b2w, 0)
                        )

                    winy = jax.lax.slice(
                        y, (b2w, 0), (b2w + rows * stride, B)
                    ).reshape(rows, stride, B)[:, c0w : c0w + cmaxv]
                    sel = contrib > winy
                    y = updw(y, contrib, sel)
                    cand = updw(
                        cand,
                        jnp.full_like(cand[:1, :1], Sm + nO), sel,
                    )
                else:
                    flat_i = jnp.asarray(
                        (base + np.arange(rows)[:, None] * stride
                         + lanes[None, :]).reshape(-1)
                    )
                    flat_v = contrib.reshape(-1, B)
                    cur = y[flat_i]
                    curc = cand[flat_i]
                    sel = flat_v > cur
                    y = y.at[flat_i].set(jnp.where(sel, flat_v, cur))
                    cand = cand.at[flat_i].set(
                        jnp.where(sel, Sm + nO, curc)
                    )
        # remap every overflow group's ids into its own uint8 space:
        # in-families first [0, C_g), bands after [C_g, C_g + nO)
        for gi in range(nOvg):
            g0 = ov_lo + gi * cmaxv
            C_g = csize.get(g0, 0)
            seg = cand[g0 : g0 + cmaxv]
            seg = jnp.where(
                seg >= OVIN,
                seg - OVIN,
                jnp.where(
                    (seg >= Sm) & (seg < Sm + nO),
                    C_g + (seg - Sm),
                    seg,
                ),
            )
            cand = cand.at[g0 : g0 + cmaxv].set(seg)
    return y, cand
