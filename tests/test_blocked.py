"""Blocked gather-matmul-scatter strategy on LM∘HMM-structured graphs.

Downscaled instances of the 2M-arc BASELINE workload (workloads.py): checks
that the compiler produces the expected scatter-free structure (bands + one
affine tier per direction + rank-1 ω split) and that logZ/posteriors match an
exact float64 scipy oracle — the test design the reference uses for its GPU
kernels (CPU result as oracle, reference test/test_linalg.jl)."""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from markovmodels_tpu import hostsparse as hs
from markovmodels_tpu import inference as inf
from markovmodels_tpu.workloads import make_lm_hmm_graph


def oracle_fb(fsm, spdf, lhs, lens):
    """Exact f64 prob-domain forward-backward (scipy sparse), independent of
    the device code: returns (logZ (B,), posts (B, N, P))."""
    rows, cols, data = hs.findnz(fsm.T_hat)
    S1 = len(fsm.alpha_hat)
    P = lhs.shape[2]
    w = np.exp(data.astype(np.float64))
    Tt = sp.csr_matrix((w, (cols, rows)), shape=(S1, S1))
    T = sp.csr_matrix((w, (rows, cols)), shape=(S1, S1))
    a0 = np.exp(fsm.alpha_hat.astype(np.float64))
    logZ, posts = [], []
    for b in range(lhs.shape[0]):
        L = int(lens[b])
        Nf = lhs.shape[1] + 1
        E = np.zeros((Nf, S1))
        for t in range(Nf):
            if t < L:
                E[t, : S1 - 1] = np.exp(lhs[b, t].astype(np.float64))[
                    spdf[: S1 - 1]
                ]
            else:
                E[t, S1 - 1] = 1.0
        A = np.zeros((Nf, S1))
        A[0] = a0 * E[0]
        for t in range(1, Nf):
            A[t] = (Tt @ A[t - 1]) * E[t]
        Bm = np.zeros((Nf, S1))
        Bm[Nf - 1] = 1.0
        for t in range(Nf - 2, -1, -1):
            Bm[t] = T @ (Bm[t + 1] * E[t + 1])
        Z = A[Nf - 1, S1 - 1]
        logZ.append(np.log(Z) if Z > 0 else -np.inf)
        G = A * Bm
        pp = np.zeros((Nf, P + 1))
        np.add.at(pp, (slice(None), spdf[: S1 - 1]), G[:, : S1 - 1])
        pp[:, P] += G[:, S1 - 1]
        tot = pp.sum(1, keepdims=True)
        tot[tot == 0] = 1
        posts.append((pp / tot)[: lhs.shape[1], :P])
    return np.array(logZ), np.array(posts)


def test_block_operator_structure_is_scatter_free():
    """The BASELINE-shape graph must lower to bands + one affine tier per
    direction with no residue and no 'gather'/'scatter' descriptors — this is
    the property that makes the 2M-arc scan run at HBM bandwidth.  The affine
    tiling needs the natural trigram period (hmm_states · V) to align with
    the 128-wide destination blocks, so this runs at the real V=128 scale
    (host-side compile only — no device compute)."""
    fsm, spdf, P, _ = make_lm_hmm_graph(V=128)
    cf = inf.compile_fsm(fsm, spdf, P, strategy="block")
    assert cf.pdf_group  # uniform pdf-grouped layout engaged
    assert cf.omega_prob is not None
    for op, (band_offsets, descs, _hi, _ov) in [
        (cf.block_fwd, cf.block_fwd_offsets),
        (cf.block_bwd, cf.block_bwd_offsets),
    ]:
        assert band_offsets  # self-loop / chain bands extracted
        assert op.res_src is None  # rank-1 ω split leaves no residue
        for gdesc, ddesc in descs:
            assert gdesc[0] != "gather", descs
            assert ddesc[0] != "scatter", descs


@pytest.mark.parametrize("reorder", ["auto", "none"])
def test_block_matches_f64_oracle(reorder):
    fsm, spdf, P, info = make_lm_hmm_graph(V=12, keep=0.8, seed=3)
    rng = np.random.default_rng(1)
    B, N = 4, 37
    lhs = rng.normal(size=(B, N, P)).astype(np.float32) * 0.7
    lens = np.array([N, 30, 1, 0], dtype=np.int32)
    oZ, oP = oracle_fb(fsm, spdf, lhs, lens)

    cf = inf.compile_fsm(fsm, spdf, P, strategy="block", reorder=reorder)
    assert bool(cf.pdf_group) == (reorder == "auto")
    posts, logZ = inf.pdfposteriors(cf, jnp.asarray(lhs), jnp.asarray(lens))
    posts, logZ = np.asarray(posts), np.asarray(logZ)

    # zero-length utterance: no path reaches the final state
    assert not np.isfinite(oZ[3]) and not np.isfinite(logZ[3])
    fin = np.isfinite(oZ)
    np.testing.assert_allclose(logZ[fin], oZ[fin], atol=1e-4, rtol=0)
    np.testing.assert_allclose(posts, oP, atol=1e-5)
    # posteriors exactly zero past each length (reference
    # test/test_algorithms.jl:248 semantics)
    for b in range(B):
        assert np.all(posts[b, lens[b]:] == 0.0)


def test_block_agrees_with_segment_strategy():
    """Same compiled graph through the prob-domain blocked path and the exact
    log-domain segment path."""
    fsm, spdf, P, _ = make_lm_hmm_graph(V=8, keep=0.6, seed=11)
    rng = np.random.default_rng(2)
    B, N = 3, 25
    lhs = rng.normal(size=(B, N, P)).astype(np.float32)
    lens = np.array([N, 12, 20], dtype=np.int32)

    cf_b = inf.compile_fsm(fsm, spdf, P, strategy="block")
    cf_s = inf.compile_fsm(fsm, spdf, P, strategy="segment")
    pb, zb = inf.pdfposteriors(cf_b, jnp.asarray(lhs), jnp.asarray(lens))
    ps, zs = inf.pdfposteriors(cf_s, jnp.asarray(lhs), jnp.asarray(lens))
    np.testing.assert_allclose(np.asarray(zb), np.asarray(zs), atol=2e-4)
    np.testing.assert_allclose(np.asarray(pb), np.asarray(ps), atol=2e-4)


def test_descriptor_classifiers_all_branches():
    """_gather_desc/_scatter_desc classify every affine family; _dir_plan
    lowers the mirror (contig / affine_d) scatter forms too."""
    from markovmodels_tpu.ops import blocked as bl

    lim = 4096
    K, Sm, D = 4, 8, 8
    k, m = np.arange(K)[:, None], np.arange(Sm)[None, :]
    # gather forms
    assert bl._gather_desc(7 + k * 64 + m, lim)[0] == "affine_k_major"
    assert bl._gather_desc(7 + k + m * 64, lim)[0] == "affine_s_major"
    # a K=1 strided row is subsumed by the windowed s-major form (the
    # 'diag' fallback would also be valid but the window is preferred)
    assert bl._gather_desc(
        np.arange(Sm)[None, :] * 5 + 3, lim
    )[0] == "affine_s_major"
    rng = np.random.default_rng(0)
    assert bl._gather_desc(
        rng.integers(0, lim, size=(K, Sm)), lim
    )[0] == "gather"
    d = np.arange(D)[None, :]
    # scatter forms
    assert bl._scatter_desc(64 + k * D + d, lim)[0] == "contig"
    assert bl._scatter_desc(64 + k + d * K, lim)[0] == "affine_d"
    assert bl._scatter_desc(64 + k * 32 + d, lim)[0] == "affine_k_pad"
    assert bl._scatter_desc(64 + k + d * 32, lim)[0] == "affine_d_pad"
    assert bl._scatter_desc(
        np.arange(D)[None, :] * 7 + 2, lim
    )[0] == "affine_d_pad"  # K=1 strided row: windowed form subsumes diag
    assert bl._scatter_desc(
        rng.integers(0, lim, size=(K, D)), lim
    )[0] == "scatter"
    # right-edge window shift: affine pattern overrunning `limit` comes
    # back with col0 > 0 instead of falling off the fast path
    desc = bl._gather_desc((lim - K * 64) + k * 64 + (64 - Sm) + m, lim)
    assert desc[0] == "affine_k_major" and desc[3] > 0
