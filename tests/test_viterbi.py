"""Viterbi vs a dense max-plus DP oracle (the reference's historical
bestpath/maxstateposteriors semantics, test/test_algorithms.jl:262-284)."""
import numpy as np
import pytest

import jax.numpy as jnp

import markovmodels_tpu as mm
from markovmodels_tpu import inference as inf
from markovmodels_tpu import viterbi as vit
from tests.test_inference import make_hmm


def oracle_viterbi(alpha, T, omega, state_pdf, loglik):
    """Dense tropical DP; returns (best state path (N,), score)."""
    N, P = loglik.shape
    S = len(alpha)
    lhs = loglik[:, state_pdf[:S]]
    delta = np.full((N, S), -np.inf)
    psi = np.zeros((N, S), dtype=np.int64)
    delta[0] = alpha + lhs[0]
    for t in range(1, N):
        scores = delta[t - 1][:, None] + T  # (S, S)
        # ties -> largest predecessor index (matches device kernels)
        psi[t] = S - 1 - np.argmax(scores[::-1], axis=0)
        delta[t] = scores[psi[t], np.arange(S)] + lhs[t]
    end = delta[N - 1] + omega
    last = int(np.argmax(end))
    score = end[last]
    path = [last]
    for t in range(N - 1, 0, -1):
        path.append(int(psi[t, path[-1]]))
    return np.array(path[::-1]), score


@pytest.mark.parametrize("strategy", ["segment", "ell"])
def test_viterbi_single(strategy):
    rng = np.random.default_rng(11)
    S, P, N = 6, 3, 30
    fsm, state_pdf, (alpha, T, omega) = make_hmm(rng, S, P, lr=False)
    T = T.copy()
    T[:, S - 1] = np.maximum(T[:, S - 1], np.log(0.05))
    from markovmodels_tpu import hostsparse as hs
    fsm = mm.FSM.from_parts(alpha, hs.spmat_from_dense(T, mm.LOG), omega,
                            fsm.labels, mm.LOG)
    loglik = rng.normal(size=(1, N, P)).astype(np.float32)

    cf = inf.compile_fsm(fsm, state_pdf, P, strategy=strategy)
    states, score = vit.viterbi(cf, jnp.asarray(loglik))
    ref_path, ref_score = oracle_viterbi(alpha, T, omega, state_pdf,
                                         loglik[0].astype(np.float64))
    np.testing.assert_allclose(float(score[0]), ref_score, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(states[0]), ref_path)


def test_viterbi_ragged_batch():
    rng = np.random.default_rng(12)
    S, P, N, B = 5, 3, 25, 4
    fsm, state_pdf, (alpha, T, omega) = make_hmm(rng, S, P)
    loglik = rng.normal(size=(B, N, P)).astype(np.float32)
    lengths = np.array([25, 11, 18, 25], dtype=np.int32)

    cf = inf.compile_fsm(fsm, state_pdf, P, strategy="segment")
    states, score = vit.viterbi(cf, jnp.asarray(loglik), jnp.asarray(lengths))
    states, score = np.asarray(states), np.asarray(score)
    for b in range(B):
        L = lengths[b]
        ref_path, ref_score = oracle_viterbi(alpha, T, omega, state_pdf,
                                             loglik[b, :L].astype(np.float64))
        np.testing.assert_allclose(score[b], ref_score, atol=1e-4)
        np.testing.assert_array_equal(states[b, :L], ref_path)
        # past the sequence end the decoder sits on the phony final state
        assert np.all(states[b, L:] == cf.num_states - 1)


@pytest.mark.parametrize("strategy", ["dense", "block"])
@pytest.mark.parametrize("chunk", [None, 7])
def test_viterbi_scale_exact(strategy, chunk):
    """The backpointer-free at-scale path ('dense'/'block' strategies,
    chunk-checkpointed recompute) returns exactly the oracle path."""
    rng = np.random.default_rng(15)
    S, P, N, B = 9, 4, 30, 3
    fsm, state_pdf, (alpha, T, omega) = make_hmm(rng, S, P, lr=False)
    T = T.copy()
    T[:, S - 1] = np.maximum(T[:, S - 1], np.log(0.05))
    from markovmodels_tpu import hostsparse as hs
    fsm = mm.FSM.from_parts(alpha, hs.spmat_from_dense(T, mm.LOG), omega,
                            fsm.labels, mm.LOG)
    loglik = rng.normal(size=(B, N, P)).astype(np.float32)
    lengths = np.array([30, 13, 21], dtype=np.int32)

    cf = inf.compile_fsm(fsm, state_pdf, P, strategy=strategy)
    states, score = vit.viterbi(cf, jnp.asarray(loglik), jnp.asarray(lengths),
                                chunk_size=chunk)
    states, score = np.asarray(states), np.asarray(score)
    for b in range(B):
        L = lengths[b]
        ref_path, ref_score = oracle_viterbi(alpha, T, omega, state_pdf,
                                             loglik[b, :L].astype(np.float64))
        np.testing.assert_allclose(score[b], ref_score, atol=1e-4)
        np.testing.assert_array_equal(states[b, :L], ref_path)
        assert np.all(states[b, L:] == cf.num_states - 1)


def test_viterbi_scale_matches_segment_on_reordered_block():
    """'block' + pdf-grouped relabeling must report host state ids."""
    rng = np.random.default_rng(16)
    S, P, N = 12, 5, 18
    fsm, state_pdf, (alpha, T, omega) = make_hmm(rng, S, P, lr=False)
    loglik = rng.normal(size=(1, N, P)).astype(np.float32)
    cs = inf.compile_fsm(fsm, state_pdf, P, strategy="segment")
    cb = inf.compile_fsm(fsm, state_pdf, P, strategy="block", reorder="pdf")
    s_ref, z_ref = vit.viterbi(cs, jnp.asarray(loglik))
    s_blk, z_blk = vit.viterbi(cb, jnp.asarray(loglik))
    np.testing.assert_allclose(np.asarray(z_blk), np.asarray(z_ref), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(s_blk), np.asarray(s_ref))


@pytest.mark.parametrize("strategy", ["dense", "block"])
def test_viterbi_general_statemap_multi_pdf(strategy):
    """Viterbi over a general Ĉ (states emitting several pdfs, reference
    src/inference.jl:7-8): the tropical emission is the max over the pdf
    set; checked against a dense max-plus DP oracle."""
    from markovmodels_tpu import hostsparse as hs

    rng = np.random.default_rng(19)
    S, P, N, B = 6, 4, 20, 2
    fsm, _, (alpha, T, omega) = make_hmm(rng, S, P, lr=False)
    T = T.copy()
    T[:, S - 1] = np.maximum(T[:, S - 1], np.log(0.05))
    fsm = mm.FSM.from_parts(alpha, hs.spmat_from_dense(T, mm.LOG), omega,
                            fsm.labels, mm.LOG)
    pdf_sets = [[2], [0, 2], [3], [1, 2, 3], [0], [1], [P]]
    rows = np.repeat(np.arange(S + 1), [len(s) for s in pdf_sets])
    cols = np.concatenate([np.array(s) for s in pdf_sets])
    C = hs.spmat_from_coo(
        rows, cols, np.zeros(len(rows)), (S + 1, P + 1), mm.LOG
    )
    loglik = rng.normal(size=(B, N, P)).astype(np.float32)
    lengths = np.array([20, 11], dtype=np.int32)

    cf = inf.compile_fsm(fsm, C, P, strategy=strategy)
    assert cf.multi_pdf
    states, score = vit.viterbi(cf, jnp.asarray(loglik), jnp.asarray(lengths))
    states, score = np.asarray(states), np.asarray(score)

    # dense tropical oracle: emission of state s = max over its pdf set
    for b in range(B):
        L = int(lengths[b])
        ll = loglik[b, :L].astype(np.float64)
        emis = np.stack(
            [np.max(ll[:, pdf_sets[s]], axis=1) for s in range(S)], axis=1
        )  # (L, S)
        delta = np.full((L, S), -np.inf)
        psi = np.zeros((L, S), dtype=np.int64)
        delta[0] = alpha + emis[0]
        for t in range(1, L):
            sc = delta[t - 1][:, None] + T
            psi[t] = S - 1 - np.argmax(sc[::-1], axis=0)
            delta[t] = sc[psi[t], np.arange(S)] + emis[t]
        end = delta[L - 1] + omega
        ref_score = np.max(end)
        np.testing.assert_allclose(score[b], ref_score, atol=1e-4)
        # decoded path must achieve the optimal score under max-emission
        path = states[b, :L]
        w = alpha[path[0]] + emis[0, path[0]]
        for t in range(1, L):
            w += T[path[t - 1], path[t]] + emis[t, path[t]]
        w += omega[path[L - 1]]
        np.testing.assert_allclose(w, ref_score, atol=1e-4)


def test_viterbi_bp_lm_hmm():
    """Compressed-backpointer decode (single tropical sweep + uint8
    candidate ids) on the LM ∘ HMM workload family: engages, matches the
    segment-strategy score, and the decoded path's exact f64 weight equals
    the optimum."""
    import scipy.sparse as sp

    from markovmodels_tpu import hostsparse as hs
    from markovmodels_tpu.workloads import make_lm_hmm_graph

    rng = np.random.default_rng(17)
    fsm, spdf, P, info = make_lm_hmm_graph(V=8, seed=2)
    B, N = 3, 25
    lhs = rng.normal(size=(B, N, P)).astype(np.float32)
    lengths = np.array([25, 11, 18], dtype=np.int32)

    cb = inf.compile_fsm(fsm, spdf, P, strategy="block", precision="high")
    assert vit._bp_vit_ok(cb, jnp.asarray(lhs)), "bp path must engage"
    states, score = vit.viterbi(cb, jnp.asarray(lhs), jnp.asarray(lengths))
    states, score = np.asarray(states), np.asarray(score)

    cs = inf.compile_fsm(fsm, spdf, P, strategy="segment")
    _, ref_score = vit.viterbi(cs, jnp.asarray(lhs), jnp.asarray(lengths))
    np.testing.assert_allclose(score, np.asarray(ref_score), atol=1e-3)

    # exact f64 weight of the decoded path must equal the tropical optimum
    rows, cols, data = hs.findnz(fsm.T_hat)
    S1 = len(fsm.alpha_hat)
    T = sp.csr_matrix(
        (np.asarray(data, dtype=np.float64), (rows, cols)), shape=(S1, S1)
    )
    T.sort_indices()

    def arc_w(i, j):
        lo, hi = T.indptr[i], T.indptr[i + 1]
        k = lo + np.searchsorted(T.indices[lo:hi], j)
        return T.data[k] if k < hi and T.indices[k] == j else -np.inf

    a0 = np.asarray(fsm.alpha_hat, dtype=np.float64)
    for b in range(B):
        L = int(lengths[b])
        path = states[b, :L]
        w = a0[path[0]] + float(
            lhs[b, np.arange(L), spdf[path]].astype(np.float64).sum()
        )
        for t in range(L - 1):
            w += arc_w(path[t], path[t + 1])
        w += arc_w(path[L - 1], S1 - 1)
        np.testing.assert_allclose(w, float(ref_score[b]), atol=1e-3)
        assert np.all(states[b, L:] == cb.num_states - 1)


def test_maxstateposteriors_best_path_zero():
    rng = np.random.default_rng(13)
    S, P, N = 5, 3, 15
    fsm, state_pdf, (alpha, T, omega) = make_hmm(rng, S, P)
    loglik = rng.normal(size=(1, N, P)).astype(np.float32)
    cf = inf.compile_fsm(fsm, state_pdf, P, strategy="segment")
    gam, score = vit.maxstateposteriors(cf, jnp.asarray(loglik))
    states, vscore = vit.viterbi(cf, jnp.asarray(loglik))
    np.testing.assert_allclose(float(score[0]), float(vscore[0]), atol=1e-5)
    # along the best path, the max-posterior is exactly the best score => 0
    g = np.asarray(gam[0])
    s = np.asarray(states[0])
    np.testing.assert_allclose(g[np.arange(N), s], 0.0, atol=1e-4)
    # no state beats the best path
    assert np.max(g) <= 1e-4


def test_viterbi_single_bp_memory_guard(monkeypatch):
    """A 'segment'-strategy graph whose full int32 backpointer stream would
    exceed the budget must raise a named-predicate error instead of OOMing
    (the at-scale strategies reroute to chunk-recompute; segment/ell have
    no such fallback)."""
    rng = np.random.default_rng(13)
    S, P, N = 6, 3, 30
    fsm, state_pdf, _ = make_hmm(rng, S, P)
    cf = inf.compile_fsm(fsm, state_pdf, P, strategy="segment")
    loglik = rng.normal(size=(1, N, P)).astype(np.float32)
    monkeypatch.setattr(vit, "_BP_MEM_BYTES", 100)  # force the cliff
    with pytest.raises(ValueError, match="backpointer stream"):
        vit.viterbi(cf, jnp.asarray(loglik))


def test_viterbi_packed_argmax_matches(monkeypatch):
    """MMTPU_VIT_PACKED (two plain max-reduces with value-bit/id packing)
    must decode the same paths and scores as the variadic (max, argmax)
    reduce on the LM∘HMM block graph."""
    rng = np.random.default_rng(17)
    from markovmodels_tpu.workloads import make_lm_hmm_graph

    fsm, spdf, P, _ = make_lm_hmm_graph(V=8, seed=2)
    cf = inf.compile_fsm(fsm, spdf, P, strategy="block")
    B, N = 3, 25
    lhs = jnp.asarray(rng.normal(size=(B, N, P)).astype(np.float32))
    lens = jnp.asarray([25, 11, 18], dtype=jnp.int32)
    st0, sc0 = vit.viterbi(cf, lhs, lens)
    monkeypatch.setenv("MMTPU_VIT_PACKED", "1")
    st1, sc1 = vit.viterbi(cf, lhs, lens)
    np.testing.assert_allclose(np.asarray(sc1), np.asarray(sc0), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(st1), np.asarray(st0))


def test_ov_layout_band_only_overflow_bp_decode(monkeypatch):
    """Review-finding regression (round 5): an ov-layout graph whose
    overflow states are fed ONLY by shared-offset band arcs compiles with
    EMPTY overflow families — the bp sweep then keeps the GLOBAL tier/band
    candidate encoding on overflow slots, and the walk must decode them
    through the core path (building the per-group table would mistranslate
    band ids into garbage backpointers).  The bp decode must match the
    chunk-recompute decoder path-for-path."""
    import markovmodels_tpu as mm
    from markovmodels_tpu import hostsparse as hs

    P, cap = 16, 8
    S = P * 8 + P  # 8 uniform states per pdf + 1 overflow each
    rows = list(range(S)) + list(range(S - 1))
    cols = list(range(S)) + list(range(1, S))
    data = [np.log(0.4)] * S + [np.log(0.5)] * (S - 1)
    # a small non-band family so the operator has exactly one tier
    for i in range(8):
        rows.append(i)
        cols.append(64 + i)
        data.append(np.log(0.3))
    alpha = np.full(S, -np.inf)
    alpha[0] = 0.0
    omega = np.full(S, -np.inf)
    omega[S - 1] = np.log(0.3)  # an OVERFLOW state carries final mass
    omega[71] = np.log(0.2)
    spdf = np.array(
        [i // 8 for i in range(P * 8)] + list(range(P)) + [P],
        dtype=np.int32,
    )
    labels = [mm.labels.Label(int(p)) for p in spdf[:S]]
    T = hs.spmat_from_coo(
        np.array(rows), np.array(cols), np.array(data), (S, S), mm.LOG
    )
    fsm = mm.FSM.from_parts(alpha, T, omega, labels, mm.LOG)
    cf = inf.compile_fsm(fsm, spdf, P, strategy="block", ov_cap=cap)
    assert cf.ov_layout == (cap, 2)
    assert not cf.block_fwd.ov_w  # band arcs captured everything
    rng = np.random.default_rng(23)
    B, N = 3, 160  # long enough to walk through the overflow chain tail
    lhs = jnp.asarray(rng.normal(size=(B, N, P)).astype(np.float32))
    lens = jnp.asarray([160, 150, 144], dtype=jnp.int32)
    assert vit._bp_vit_reject_reason(cf, lhs) is None
    st1, sc1 = vit.viterbi(cf, lhs, lens)
    monkeypatch.setenv("MMTPU_NO_VITBP", "1")
    st0, sc0 = vit.viterbi(cf, lhs, lens)
    np.testing.assert_allclose(np.asarray(sc1), np.asarray(sc0), atol=1e-5)
    # same-pdf self/chain orderings tie exactly, so the two decoders may
    # legally return different optimal paths — require instead that BOTH
    # paths are VALID and carry the device score (f64 arc-by-arc walk;
    # the pre-fix bug emitted invalid final-state-parked garbage here)
    from tests.test_inference import make_hmm  # noqa: F401  (import path)
    import importlib.util as _ilu
    import os as _os

    _spec = _ilu.spec_from_file_location(
        "benchmod_v", _os.path.join(_os.path.dirname(__file__), "..",
                                    "bench.py")
    )
    _bench = _ilu.module_from_spec(_spec)
    _spec.loader.exec_module(_bench)
    for st, sc in ((st1, sc1), (st0, sc0)):
        gap = _bench._validate_paths_full(
            fsm, spdf, np.asarray(lhs), np.asarray(lens),
            np.asarray(st), np.asarray(sc),
        )
        assert gap < 1e-3


@pytest.fixture(scope="module")
def lm_graph_v128():
    """The benchmark's 2M-arc LM∘HMM graph (host FSM, block compile)."""
    from markovmodels_tpu.workloads import make_lm_hmm_graph

    raw = make_lm_hmm_graph(V=128)
    fsm, spdf, P, _ = raw
    return raw, inf.compile_fsm(fsm, spdf, P, strategy="block")


def test_bp_viterbi_matches_recompute_path(lm_graph_v128, monkeypatch):
    """Compressed-backpointer decode vs the chunk-recompute fallback on the
    V=128 affine-tier graph: matching scores and optimal paths, ragged."""
    raw_graph, cf = lm_graph_v128
    P = raw_graph[2]
    B, N = 8, 4
    rng = np.random.default_rng(13)
    lhs = jnp.asarray(rng.normal(size=(B, N, P)).astype(np.float32) * 0.5)
    lens = jnp.asarray([4, 3, 4, 2, 3, 4, 4, 3], dtype=jnp.int32)

    assert vit._bp_vit_ok(cf, lhs)
    s1, z1 = vit.viterbi(cf, lhs, lens)
    monkeypatch.setenv("MMTPU_NO_VITBP", "1")
    s0, z0 = vit.viterbi(cf, lhs, lens, chunk_size=2)

    np.testing.assert_allclose(np.asarray(z1), np.asarray(z0), atol=1e-5)
    # both decoders may break exact ties differently; each path must be
    # valid and achieve the optimal score in exact f64 arithmetic
    import scipy.sparse as sp

    from markovmodels_tpu import hostsparse as hs

    fsm, spdf = raw_graph[0], raw_graph[1]
    rows, cols, data = hs.findnz(fsm.T_hat)
    S1 = len(fsm.alpha_hat)
    T = sp.csr_matrix(
        (np.asarray(data, dtype=np.float64), (rows, cols)), shape=(S1, S1)
    )
    T.sort_indices()

    def arc_w(i, j):
        lo, hi = T.indptr[i], T.indptr[i + 1]
        k = lo + np.searchsorted(T.indices[lo:hi], j)
        return T.data[k] if k < hi and T.indices[k] == j else -np.inf

    a0 = np.asarray(fsm.alpha_hat, dtype=np.float64)
    lhs_np = np.asarray(lhs)
    for states, score in ((np.asarray(s1), np.asarray(z1)),
                          (np.asarray(s0), np.asarray(z0))):
        for b in range(B):
            L = int(lens[b])
            if not np.isfinite(score[b]):
                continue  # infeasible (L < HMM length): path undefined
            path = states[b, :L]
            w = a0[path[0]] + float(
                lhs_np[b, np.arange(L), spdf[path]].astype(np.float64).sum()
            )
            for t in range(L - 1):
                w += arc_w(path[t], path[t + 1])
            w += arc_w(path[L - 1], S1 - 1)
            np.testing.assert_allclose(w, float(score[b]), atol=1e-4)
