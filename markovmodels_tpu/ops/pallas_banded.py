"""Stacked-banded forward-backward as one Pallas kernel on the Triton route.

The LF-MMI training step scores one numerator lattice per utterance besides
the shared denominator.  A numerator is a 2-band (self + chain) matrix
(reference LinearFSM, examples/prepare-lfmmi-graphs.jl:25-65), so one frame
of its recursion is a few elementwise operations and one max-reduce per
graph.  Under ``lax.scan`` each of those becomes a small fusion, i.e. a
kernel launch, on every one of the 2·(N+1) iterations of the two sweeps.

Here each program owns a tile of graphs and runs the whole frame loop
itself: bands, ω, the state→pdf map and the carried state stay in
registers, and only the per-frame emission row and the α/γ streams touch
device memory.  Design points for Hopper:

* one graph per program at the benchmark's 128 graphs — the grid, not a
  wide tile, fills the 132 SMs (:func:`graph_tile`);
* states are padded to a power of two (at least 128), Triton's block rule;
* a program reads its graph's emissions through the state→pdf index
  (a masked gather load) instead of a pre-gathered (N, S, G) stream;
* Triton cannot roll a register tile, so the band shift goes through memory:
  the forward stores α_t to the stream it returns anyway, and frame t+1
  loads it back at each band offset; the backward does the same through a
  two-row ring.  A CTA barrier orders the store before the loads; it is
  emitted only when compiling (the interpreter has no rule for it, and
  runs one program at a time anyway).

The recursion runs in the log domain, as the XLA route for stacked
numerators does (inference._fb_banded_stacked says why).  The per-graph
pdf reduction of γ stays outside the kernel: one batched one-hot
contraction over all frames at full f32 precision.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["graph_tile", "banded_kernel_reject_reason", "banded_fb"]

# padded states per graph the kernel keeps in registers; larger lattices
# take the stacked XLA scan
_MAX_STATES = 2048
# about one program per SM of an H100 (132 SMs)
_TARGET_PROGRAMS = 128


def _state_block(Sp: int) -> int:
    return max(128, 1 << (Sp - 1).bit_length())


def graph_tile(G: int) -> int:
    """Graphs per program: the largest power of two (at most 8) that still
    leaves at least ``_TARGET_PROGRAMS`` programs — 1 below 255 graphs."""
    tg = 1
    while tg < 8 and -(-G // (2 * tg)) >= _TARGET_PROGRAMS:
        tg *= 2
    return tg


def banded_kernel_reject_reason(cf, B: int):
    """None when the kernel accepts this stacked graph at batch ``B``, else
    the first rejected predicate."""
    if not cf.batched or cf.strategy != "banded":
        return "not a stacked 'banded' CompiledFSM"
    if cf.alpha_hat.dtype != jnp.float32:
        return f"operator dtype {cf.alpha_hat.dtype} (the kernel is f32)"
    G = cf.alpha_hat.shape[0]
    if B != G:
        return f"batch {B} != graph count {G} (one sequence per graph)"
    S = _state_block(cf.padded_states)
    if S > _MAX_STATES:
        return f"{S} padded states per graph exceed {_MAX_STATES}"
    return None


def _log_emission(lhs_ref, g, t, pdf, active, is_fin, N, P):
    """lhs[g, t, pdf] on active frames (-inf for the phony pdf P, which
    padding states carry too); past the end only the phony final state
    emits, with log 1."""
    real = pdf < P
    lv = plgpu.load(
        lhs_ref.at[g, jnp.minimum(t, N - 1), jnp.minimum(pdf, P - 1)],
        mask=active & real,
        other=-jnp.inf,
    )
    return jnp.where(active, lv, jnp.where(is_fin, 0.0, -jnp.inf))


def _shifted(ref, g, row, s, off, S):
    """x[g, row, s - off], -inf outside [0, S) — the band shift."""
    src = s - off
    ok = jnp.broadcast_to((src >= 0) & (src < S), (g.shape[0], S))
    return plgpu.load(ref.at[g, row, jnp.clip(src, 0, S - 1)], mask=ok,
                      other=-jnp.inf)


def _safe(m):
    return jnp.where(m == -jnp.inf, 0.0, m)


def _lse(terms):
    """Elementwise log-sum-exp of a list of equal-shape tiles."""
    m = terms[0]
    for x in terms[1:]:
        m = jnp.maximum(m, x)
    ms = _safe(m)
    tot = jnp.exp(terms[0] - ms)
    for x in terms[1:]:
        tot = tot + jnp.exp(x - ms)
    return jnp.where(tot > 0, jnp.log(tot) + ms, -jnp.inf)


def _lse_rows(x):
    """Per-graph log-sum-exp over states: (TG, S) -> (TG, 1)."""
    ms = _safe(jnp.max(x, axis=1, keepdims=True))
    tot = jnp.sum(jnp.exp(x - ms), axis=1, keepdims=True)
    return jnp.where(tot > 0, jnp.log(tot) + ms, -jnp.inf)


def _normalize(y):
    """Subtract the per-graph max (finite-safe); returns (y, max)."""
    m = _safe(jnp.max(y, axis=1, keepdims=True))
    return y - m, m


def _fwd_kernel(offs, TG, S, Nf, N, P, interpret,
                bf_ref, om_ref, a0_ref, fin_ref, spdf_ref, lhs_ref, len_ref,
                alph_ref, logz_ref):
    g = pl.program_id(0) * TG + jnp.arange(TG, dtype=jnp.int32)[:, None]
    s = jnp.arange(S, dtype=jnp.int32)[None, :]
    bands = [bf_ref[g, oi, s] for oi in range(len(offs))]
    om = om_ref[g, s]
    is_fin = s == fin_ref[g]
    pdf = spdf_ref[g, s]
    lens = len_ref[g]

    def frame(t, p, shift, comp):
        e = _log_emission(lhs_ref, g, t, pdf, t < lens, is_fin, N, P)
        y, m = _normalize(p + e)
        alph_ref[g, t, s] = y
        if not interpret:
            plgpu.debug_barrier()
        # Kahan-compensated accumulation of the per-frame shift
        xc = m - comp
        tot = shift + xc
        return y, tot, (tot - shift) - xc

    def body(t, carry):
        a, shift, comp = carry
        p = _lse([
            bands[oi] + (a if off == 0
                         else _shifted(alph_ref, g, t - 1, s, off, S))
            for oi, off in enumerate(offs)
        ])
        p = jnp.where(is_fin, _lse_rows(om + a), p)
        return frame(t, p, shift, comp)

    zero = jnp.zeros((TG, 1), jnp.float32)
    carry = frame(0, a0_ref[g, s], zero, zero)
    a, shift, _ = lax.fori_loop(1, Nf, body, carry)
    logz_ref[g] = jnp.max(jnp.where(is_fin, a, -jnp.inf), axis=1,
                          keepdims=True) + shift


def _bwd_kernel(offs, TG, S, Nf, N, P, interpret,
                bb_ref, om_ref, fin_ref, spdf_ref, lhs_ref, len_ref,
                alph_ref, gam_ref, ring_ref):
    g = pl.program_id(0) * TG + jnp.arange(TG, dtype=jnp.int32)[:, None]
    s = jnp.arange(S, dtype=jnp.int32)[None, :]
    bands = [bb_ref[g, oi, s] for oi in range(len(offs))]
    om = om_ref[g, s]
    is_fin = s == fin_ref[g]
    pdf = spdf_ref[g, s]
    lens = len_ref[g]

    def frame(t, y):
        y, _ = _normalize(y)
        gam_ref[g, t, s] = alph_ref[g, t, s] + y
        b = y + _log_emission(lhs_ref, g, t, pdf, t < lens, is_fin, N, P)
        ring_ref[g, lax.rem(t, 2), s] = b
        if not interpret:
            plgpu.debug_barrier()
        return b

    def body(j, b):
        t = Nf - 1 - j
        # backward band: y[s] ⊕= w[s] ⊗ b[s + off]; ω: y[s] ⊕= ω[s] ⊗ b[fin]
        bfin = jnp.max(jnp.where(is_fin, b, -jnp.inf), axis=1, keepdims=True)
        return frame(t, _lse([
            bands[oi] + (b if off == 0
                         else _shifted(ring_ref, g, lax.rem(t + 1, 2), s,
                                       -off, S))
            for oi, off in enumerate(offs)
        ] + [om + bfin]))

    b = frame(Nf - 1, jnp.zeros((TG, S), jnp.float32))
    lax.fori_loop(1, Nf, body, b)


@functools.partial(
    jax.jit, static_argnames=("offs", "TG", "want_posts", "interpret")
)
def _run(bf, bb, om, a0, fin, spdf, lhs, lens, *, offs, TG, want_posts,
         interpret):
    Gp, N, P = lhs.shape
    S = bf.shape[-1]
    Nf = N + 1
    f32 = jnp.float32
    grid = (Gp // TG,)
    params = plgpu.CompilerParams(num_warps=max(1, min(8, TG * S // 128)),
                                  num_stages=1)
    alph, logz = pl.pallas_call(
        functools.partial(_fwd_kernel, offs, TG, S, Nf, N, P, interpret),
        grid=grid,
        out_shape=[
            jax.ShapeDtypeStruct((Gp, Nf, S), f32),
            jax.ShapeDtypeStruct((Gp,), f32),
        ],
        backend="triton",
        compiler_params=params,
        interpret=interpret,
        name="banded_fwd",
    )(bf, om, a0, fin, spdf, lhs, lens)
    if not want_posts:
        return None, logz
    gam, _ = pl.pallas_call(
        functools.partial(_bwd_kernel, offs, TG, S, Nf, N, P, interpret),
        grid=grid,
        out_shape=[
            jax.ShapeDtypeStruct((Gp, Nf, S), f32),
            jax.ShapeDtypeStruct((Gp, 2, S), f32),
        ],
        backend="triton",
        compiler_params=params,
        interpret=interpret,
        name="banded_bwd",
    )(bb, om, fin, spdf, lhs, lens, alph)
    return gam, logz


def banded_fb(cf, lhs, lengths, want_posts, *, interpret=False):
    """Stacked-banded forward(-backward) through the kernel.

    ``lhs``: (G, N, P), one sequence per graph; ``lengths``: (G,) int32.
    Returns (posts (G, N, P) or None, logZ (G,)).  ``interpret=True`` runs
    the kernel bodies in the Pallas interpreter (tests on the CPU); the
    default compiles for the GPU.
    """
    G, N, P = lhs.shape
    Sp = cf.padded_states
    S = _state_block(Sp)
    TG = graph_tile(G)
    Gp = -(-G // TG) * TG

    def pad(x, fill=-jnp.inf):
        """Pad the graph axis to Gp and the state axis to S."""
        widths = [(0, Gp - G)] + [(0, 0)] * (x.ndim - 1)
        if x.ndim > 1:
            widths[-1] = (0, S - Sp)
        return jnp.pad(x, widths, constant_values=fill)

    f32 = jnp.float32
    spdf = pad(cf.state_pdf, P)
    gam, logz = _run(
        pad(jnp.log(cf.banded_fwd.astype(f32))),
        pad(jnp.log(cf.banded_bwd.astype(f32))),
        pad(jnp.log(cf.omega_prob.astype(f32))),
        pad(cf.alpha_hat.astype(f32)),
        pad(cf.final_state, 0),
        spdf,
        jnp.pad(lhs.astype(f32), ((0, Gp - G), (0, 0), (0, 0))),
        jnp.pad(jnp.asarray(lengths, jnp.int32), (0, Gp - G)),
        offs=tuple(cf.banded_offsets),
        TG=TG,
        want_posts=want_posts,
        interpret=interpret,
    )
    logz = logz[:G]
    if not want_posts:
        return None, logz
    # per-graph pdf reduction of γ over all frames: a batched one-hot
    # contraction at full f32 precision, after a per-frame max shift
    gam = gam[:G]
    m = jnp.max(gam, axis=2, keepdims=True)
    w = jnp.exp(gam - jnp.where(m == -jnp.inf, 0.0, m))
    oh = (spdf[:G, :, None] == jnp.arange(P + 1)[None, None, :]).astype(f32)
    sums = jnp.einsum("gns,gsp->gnp", w, oh, precision=lax.Precision.HIGHEST,
                      preferred_element_type=f32)
    tot = jnp.sum(w, axis=2, keepdims=True)
    posts = sums / jnp.where(tot > 0, tot, 1.0)
    return posts[:, :N, :P], logz
