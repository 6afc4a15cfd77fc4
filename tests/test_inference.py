"""Forward-backward / LF-MMI scoring vs an independent dense NumPy oracle.

Mirrors the reference's (disabled but correct) test design: a plain-float
log-space forward-backward with logsumexp is the parity oracle
(reference test/test_algorithms.jl:28-63), including the ragged-batch
"posteriors are exactly zero past seqlength" property (:248)."""
import numpy as np
import pytest
from scipy.special import logsumexp

import markovmodels_tpu as mm
from markovmodels_tpu import hostsparse as hs
from markovmodels_tpu import inference as inf
from markovmodels_tpu.labels import Label

import jax
import jax.numpy as jnp


def make_hmm(rng, S, P, *, lr=True):
    """Random log-domain HMM as (FSM, state_pdf). lr=True: left-to-right."""
    T = np.full((S, S), -np.inf)
    for i in range(S):
        if lr:
            js = [j for j in (i, i + 1) if j < S]
        else:
            js = list(rng.choice(S, size=min(S, 3), replace=False))
        w = rng.uniform(0.1, 1.0, size=len(js))
        w /= w.sum() * rng.uniform(1.0, 1.5)
        T[i, js] = np.log(w)
    alpha = np.full(S, -np.inf)
    alpha[0] = 0.0
    omega = np.full(S, -np.inf)
    omega[S - 1] = np.log(0.3)
    labels = [Label(i % P) for i in range(S)]
    fsm = mm.FSM.from_parts(alpha, hs.spmat_from_dense(T, mm.LOG), omega, labels, mm.LOG)
    state_pdf = np.array([i % P for i in range(S)] + [P], dtype=np.int32)
    return fsm, state_pdf, (alpha, T, omega)


def oracle_fb(alpha, T, omega, state_pdf, loglik):
    """Dense log-space forward-backward; returns (pdf posts (N, P), logZ)."""
    N, P = loglik.shape
    S = len(alpha)
    lhs = loglik[:, state_pdf[:S]]  # (N, S)
    logA = np.full((N, S), -np.inf)
    logA[0] = alpha + lhs[0]
    for t in range(1, N):
        logA[t] = logsumexp(logA[t - 1][:, None] + T, axis=0) + lhs[t]
    logB = np.full((N, S), -np.inf)
    logB[N - 1] = omega
    for t in range(N - 2, -1, -1):
        logB[t] = logsumexp(T + (lhs[t + 1] + logB[t + 1])[None, :], axis=1)
    logZ = logsumexp(logA[N - 1] + omega)
    gamma = logA + logB - logZ  # (N, S)
    posts = np.zeros((N, P))
    for p in range(P):
        sel = state_pdf[:S] == p
        if sel.any():
            posts[:, p] = np.exp(logsumexp(gamma[:, sel], axis=1))
    return posts, logZ


STRATEGIES = ["segment", "ell", "dense", "block"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_single_hmm_parity(strategy):
    """BASELINE config 1: 5-state left-to-right HMM, T=100 frames."""
    rng = np.random.default_rng(5)
    S, P, N = 5, 3, 100
    fsm, state_pdf, (alpha, T, omega) = make_hmm(rng, S, P)
    loglik = rng.normal(size=(1, N, P)).astype(np.float32)

    cf = inf.compile_fsm(fsm, state_pdf, P, strategy=strategy)
    posts, logZ = inf.pdfposteriors(cf, jnp.asarray(loglik), chunk_size=16)

    ref_posts, ref_logZ = oracle_fb(alpha, T, omega, state_pdf, loglik[0].astype(np.float64))
    np.testing.assert_allclose(float(logZ[0]), ref_logZ, atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(posts[0]), ref_posts, atol=2e-4)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ragged_batch_shared_graph(strategy):
    """BASELINE config 2-style: shared graph, ragged lengths."""
    rng = np.random.default_rng(6)
    S, P, N, B = 7, 4, 40, 5
    fsm, state_pdf, parts = make_hmm(rng, S, P, lr=False)
    # ensure reachability of final state for short utterances: add direct arcs
    alpha, T, omega = parts
    T = T.copy()
    T[:, S - 1] = np.maximum(T[:, S - 1], np.log(0.05))
    fsm = mm.FSM.from_parts(alpha, hs.spmat_from_dense(T, mm.LOG), omega,
                            fsm.labels, mm.LOG)
    lengths = np.array([40, 17, 23, 40, 9], dtype=np.int32)
    loglik = rng.normal(size=(B, N, P)).astype(np.float32)

    cf = inf.compile_fsm(fsm, state_pdf, P, strategy=strategy)
    posts, logZ = inf.pdfposteriors(cf, jnp.asarray(loglik), jnp.asarray(lengths),
                                    chunk_size=16)
    posts, logZ = np.asarray(posts), np.asarray(logZ)

    for b in range(B):
        L = lengths[b]
        ref_posts, ref_logZ = oracle_fb(alpha, T, omega, state_pdf,
                                        loglik[b, :L].astype(np.float64))
        np.testing.assert_allclose(logZ[b], ref_logZ, atol=2e-4, rtol=1e-5)
        np.testing.assert_allclose(posts[b, :L], ref_posts, atol=2e-4)
        # posteriors exactly zero past seqlength (reference test :248)
        assert np.all(posts[b, L:] == 0.0)


@pytest.mark.parametrize("strategy", ["segment", "ell", "dense"])
def test_stacked_per_utterance_graphs(strategy):
    """Heterogeneous per-utterance graphs, stacked + vmapped."""
    rng = np.random.default_rng(7)
    P, N = 4, 25
    sizes = [4, 6, 5]
    fsms, spdfs, denses = [], [], []
    for S in sizes:
        f, sp, d = make_hmm(rng, S, P)
        fsms.append(f)
        spdfs.append(sp)
        denses.append(d)
    cfs = [inf.compile_fsm(f, sp, P, strategy=strategy)
           for f, sp in zip(fsms, spdfs)]
    batch = inf.stack(cfs)
    lengths = np.array([25, 12, 19], dtype=np.int32)
    loglik = rng.normal(size=(3, N, P)).astype(np.float32)

    posts, logZ = inf.pdfposteriors(batch, jnp.asarray(loglik),
                                    jnp.asarray(lengths), chunk_size=8)
    posts, logZ = np.asarray(posts), np.asarray(logZ)
    for b, (f, sp, (alpha, T, omega)) in enumerate(zip(fsms, spdfs, denses)):
        L = lengths[b]
        ref_posts, ref_logZ = oracle_fb(alpha, T, omega, sp,
                                        loglik[b, :L].astype(np.float64))
        np.testing.assert_allclose(logZ[b], ref_logZ, atol=2e-4, rtol=1e-5)
        np.testing.assert_allclose(posts[b, :L], ref_posts, atol=2e-4)
        assert np.all(posts[b, L:] == 0.0)


def test_gradient_is_posterior():
    rng = np.random.default_rng(8)
    S, P, N = 5, 3, 12
    fsm, state_pdf, _ = make_hmm(rng, S, P)
    cf = inf.compile_fsm(fsm, state_pdf, P, strategy="segment")
    loglik = jnp.asarray(rng.normal(size=(2, N, P)).astype(np.float32))
    lengths = jnp.asarray([12, 7], dtype=jnp.int32)

    grad = jax.grad(lambda x: inf.logmarginal(cf, x, lengths).sum())(loglik)
    posts, _ = inf.pdfposteriors(cf, loglik, lengths)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(posts), atol=1e-6)

    # finite-difference validation of d logZ / d lhs on a few coordinates
    f = lambda x: float(inf.forward(cf, x, lengths)[0])
    eps = 1e-3
    for (t, p) in [(0, 0), (5, 2), (11, 1)]:
        lp = loglik.at[0, t, p].add(eps)
        lm = loglik.at[0, t, p].add(-eps)
        fd = (f(lp) - f(lm)) / (2 * eps)
        np.testing.assert_allclose(float(grad[0, t, p]), fd, atol=5e-3)


def test_lfmmi_loss_runs_and_grads():
    rng = np.random.default_rng(9)
    P, N, B = 4, 20, 3
    den_fsm, den_spdf, _ = make_hmm(rng, 8, P, lr=False)
    den = inf.compile_fsm(den_fsm, den_spdf, P, strategy="segment")
    nums = []
    for _ in range(B):
        f, sp, _ = make_hmm(rng, 5, P)
        nums.append(inf.compile_fsm(f, sp, P, strategy="segment"))
    num = inf.stack(nums)
    loglik = jnp.asarray(rng.normal(size=(B, N, P)).astype(np.float32))
    lengths = jnp.asarray([20, 13, 17], dtype=jnp.int32)

    loss, grad = jax.value_and_grad(
        lambda x: inf.lfmmi_loss(num, den, x, lengths).mean()
    )(loglik)
    assert np.isfinite(float(loss))
    gnum, _ = inf.pdfposteriors(num, loglik, lengths)
    gden, _ = inf.pdfposteriors(den, loglik, lengths)
    np.testing.assert_allclose(
        np.asarray(grad), np.asarray(gden - gnum) / B, atol=1e-6
    )


@pytest.mark.parametrize("strategy", ["dense", "block"])
def test_general_statemap_multi_pdf(strategy):
    """General Ĉ (a state emitting several pdfs — reference
    src/inference.jl:7-8) matches a dense f64 oracle."""
    rng = np.random.default_rng(31)
    S, P, N, B = 6, 4, 18, 2
    fsm, _, (alpha, T, omega) = make_hmm(rng, S, P, lr=False)
    # binary Ĉ of shape (S+1, P+1): state 1 emits pdfs {0, 2}, state 3
    # emits {1, 2, 3}, the rest one pdf each, phony -> P
    pdf_sets = [[2], [0, 2], [3], [1, 2, 3], [0], [1], [P]]
    rows = np.repeat(np.arange(S + 1), [len(s) for s in pdf_sets])
    cols = np.concatenate([np.array(s) for s in pdf_sets])
    C = hs.spmat_from_coo(
        rows, cols, np.zeros(len(rows)), (S + 1, P + 1), mm.LOG
    )
    loglik = rng.normal(size=(B, N, P)).astype(np.float32)
    lengths = np.array([18, 9], dtype=np.int32)

    cf = inf.compile_fsm(fsm, C, P, strategy=strategy)
    assert cf.multi_pdf
    posts, logZ = inf.pdfposteriors(
        cf, jnp.asarray(loglik), jnp.asarray(lengths), chunk_size=8
    )
    posts, logZ = np.asarray(posts), np.asarray(logZ)

    # dense oracle: emission of state s = logsumexp over its pdf set;
    # posterior of pdf p sums gamma over every state whose set contains p,
    # normalized by the pdf-space per-frame total
    for b in range(B):
        L = int(lengths[b])
        ll = loglik[b, :L].astype(np.float64)
        lhs_state = np.array(
            [logsumexp(ll[:, ps], axis=1) for ps in pdf_sets[:S]]
        ).T  # (L, S)
        logA = np.full((L, S), -np.inf)
        logA[0] = alpha + lhs_state[0]
        for t in range(1, L):
            logA[t] = logsumexp(logA[t - 1][:, None] + T, axis=0) + lhs_state[t]
        logB = np.full((L, S), -np.inf)
        logB[L - 1] = omega
        for t in range(L - 2, -1, -1):
            logB[t] = logsumexp(
                T + (lhs_state[t + 1] + logB[t + 1])[None, :], axis=1
            )
        ref_logZ = logsumexp(logA[L - 1] + omega)
        gamma = np.exp(logA + logB - ref_logZ)  # (L, S)
        gp = np.zeros((L, P + 1))
        for s_, ps in enumerate(pdf_sets[:S]):
            for p in ps:
                gp[:, p] += gamma[:, s_]
        ref_posts = gp[:, :P] / gp.sum(axis=1, keepdims=True)
        np.testing.assert_allclose(logZ[b], ref_logZ, atol=2e-4, rtol=1e-5)
        np.testing.assert_allclose(posts[b, :L], ref_posts, atol=2e-4)
        assert np.all(posts[b, L:] == 0.0)


def test_expand_matches_reference_semantics():
    """expand (P,N)->(P+1,N+1) per reference src/inference.jl:38-60."""
    V = jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3))
    out = np.asarray(inf.expand(V, 2))
    assert out.shape == (3, 4)
    np.testing.assert_allclose(out[:2, :2], np.asarray(V)[:, :2])
    assert np.all(out[:2, 2:] == -np.inf)      # real rows zero(K) past length
    assert np.all(out[2, :2] == -np.inf)       # phony row zero(K) inside
    assert np.all(out[2, 2:] == 0.0)           # phony row one(K) past length


def test_alpha_beta_recursions_give_posteriors():
    rng = np.random.default_rng(14)
    S, P, N = 5, 3, 10
    fsm, state_pdf, (alpha, T, omega) = make_hmm(rng, S, P)
    cf = inf.compile_fsm(fsm, state_pdf, P, strategy="segment")
    loglik = jnp.asarray(rng.normal(size=(1, N, P)).astype(np.float32))

    A = np.asarray(inf.alpha_recursion(cf, loglik))[0]  # (N+1, Sp)
    Bm = np.asarray(inf.beta_recursion(cf, loglik))[0]
    # logZ from either end matches the production path
    logZ = float(inf.forward(cf, loglik)[0])
    np.testing.assert_allclose(A[N, cf.num_states - 1], logZ, atol=1e-4)
    from scipy.special import logsumexp as lse
    np.testing.assert_allclose(
        lse(A[0] + Bm[0]), logZ, atol=1e-4
    )
    # gamma = alpha ⊙ beta normalized per frame equals pdfposteriors
    posts_ref, _ = inf.pdfposteriors(cf, loglik)
    g = A + Bm  # (N+1, Sp)
    for t in range(N):
        pp = np.full(P + 1, -np.inf)
        for p in range(P + 1):
            sel = np.asarray(cf.state_pdf) == p
            if sel.any():
                pp[p] = lse(g[t][sel])
        pp = np.exp(pp - lse(pp))
        np.testing.assert_allclose(pp[:P], np.asarray(posts_ref[0, t]), atol=1e-4)


def test_banded_strategy_matches_dense_stacked():
    """'banded' numerator lattices (self+chain 2-band matrices, the
    reference LinearFSM shape): stacked banded scan must match the stacked
    dense path exactly and the oracle — including an infeasible length
    (logZ = -inf) and ragged lengths."""
    import markovmodels_tpu as mm
    from markovmodels_tpu.fsm import FSM as _FSM
    from markovmodels_tpu.labels import Label as _Label

    rng = np.random.default_rng(3)
    P, B, N = 24, 6, 30
    cfs_b, cfs_d = [], []
    for b in range(B):
        Lp = 10 + b
        seq = rng.integers(0, P, size=Lp)
        arcs = [((i, i), np.log(0.5)) for i in range(Lp)] + [
            ((i, i + 1), np.log(0.5)) for i in range(Lp - 1)
        ]
        f = _FSM.from_pairs(
            [(0, 0.0)], arcs, [(Lp - 1, np.log(0.5))],
            [_Label(int(s)) for s in seq], mm.LOG,
        )
        spdf = np.append(seq, P).astype(np.int32)
        cfs_b.append(inf.compile_fsm(f, spdf, P, strategy="banded"))
        cfs_d.append(inf.compile_fsm(f, spdf, P, strategy="dense"))
    assert cfs_b[0].banded_offsets == (0, 1)
    num_b, num_d = inf.stack(cfs_b), inf.stack(cfs_d)
    lhs = rng.normal(size=(B, N, P)).astype(np.float32)
    lens = np.array([N, 25, 30, 9, 30, 20], dtype=np.int32)  # 9 infeasible
    pb_, zb = inf.pdfposteriors(num_b, jnp.asarray(lhs), jnp.asarray(lens))
    pd_, zd = inf.pdfposteriors(num_d, jnp.asarray(lhs), jnp.asarray(lens))
    zb, zd = np.asarray(zb), np.asarray(zd)
    assert (np.isfinite(zb) == np.isfinite(zd)).all()
    assert not np.isfinite(zb[3])  # 15-state chain cannot finish in 9
    fin = np.isfinite(zb)
    np.testing.assert_allclose(zb[fin], zd[fin], atol=1e-5)
    np.testing.assert_allclose(np.asarray(pb_), np.asarray(pd_), atol=1e-5)


def test_banded_fused_pallas_matches_xla():
    """The stacked-banded Triton kernel, run in the Pallas interpreter,
    must match the XLA stacked scan at its target graph count (G = 128
    graphs, one sequence each, ragged lengths incl. an infeasible one)."""
    import markovmodels_tpu as mm
    from markovmodels_tpu.fsm import FSM as _FSM
    from markovmodels_tpu.labels import Label as _Label
    from markovmodels_tpu.ops import pallas_banded as pband

    rng = np.random.default_rng(3)
    P, G, N = 24, 128, 10
    cfs = []
    for g in range(G):
        Lp = 4 + (g % 5)
        seq = rng.integers(0, P, size=Lp)
        arcs = [((i, i), np.log(0.5)) for i in range(Lp)] + [
            ((i, i + 1), np.log(0.5)) for i in range(Lp - 1)
        ]
        f = _FSM.from_pairs(
            [(0, 0.0)], arcs, [(Lp - 1, np.log(0.5))],
            [_Label(int(s)) for s in seq], mm.LOG,
        )
        cfs.append(inf.compile_fsm(f, np.append(seq, P).astype(np.int32),
                                   P, strategy="banded"))
    nb = inf.stack(cfs)
    assert pband.banded_kernel_reject_reason(nb, G) is None
    lhs = jnp.asarray(rng.normal(size=(G, N, P)).astype(np.float32))
    lens = jnp.asarray(
        np.clip(3 + rng.integers(0, 8, size=G), 0, N).astype(np.int32)
    )
    p1, z1 = pband.banded_fb(nb, lhs, lens, True, interpret=True)
    p0, z0 = inf.pdfposteriors(nb, lhs, lens)  # XLA route on the CPU
    z0, z1 = np.asarray(z0), np.asarray(z1)
    assert (np.isfinite(z1) == np.isfinite(z0)).all()
    assert not np.isfinite(z0).all()  # some lattice cannot finish in time
    fin = np.isfinite(z0)
    np.testing.assert_allclose(z1[fin], z0[fin], atol=1e-5)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p0), atol=1e-5)
