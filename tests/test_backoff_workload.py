"""Backoff pruned-LM workload (workloads.make_backoff_lm_hmm_graph) —
the reference's actual WSJ denominator shape (pruned n-gram + backoff,
reference misc/benchmark/README.md:5-6).

Gates: (1) both layouts score correctly against the exact f64 host
oracle; (2) at the benchmark scale both layouts compile to an all-affine
blocked operator, while the separate-state layout without compile_fsm's
canonicalizing reorder does not, and the route report says so."""
import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp

from markovmodels_tpu import inference as inf
from markovmodels_tpu.workloads import make_backoff_lm_hmm_graph

_spec = importlib.util.spec_from_file_location(
    "benchmod", os.path.join(os.path.dirname(__file__), "..", "bench.py")
)
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)


@pytest.mark.parametrize("layout", ["embedded", "separate"])
def test_backoff_parity_vs_oracle(layout):
    rng = np.random.default_rng(7)
    fsm, spdf, P, info = make_backoff_lm_hmm_graph(
        V=6, keep=0.25, layout=layout
    )
    assert info["real_arcs"] < 6 * 6 * 6 * 3  # actually pruned
    cf = inf.compile_fsm(fsm, spdf, P, strategy="block")
    n = 20
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, 13], dtype=np.int32)
    ref_z, ref_p = bench.host_oracle(
        fsm, spdf, P, lhs.astype(np.float64), lens
    )
    got_p, got_z = inf.pdfposteriors(cf, jnp.asarray(lhs), jnp.asarray(lens))
    assert np.max(np.abs(np.asarray(got_z) - ref_z)) < 1e-4
    assert np.max(np.abs(np.asarray(got_p) - ref_p)) < 1e-4
    # posteriors exactly zero past each length
    assert np.all(np.asarray(got_p)[1, 13:] == 0.0)


@pytest.mark.parametrize("layout", ["embedded", "separate"])
def test_backoff_viterbi_scores(layout):
    """Tropical decode on the backoff graphs: device best-path score must
    match the exact f64 max-plus forward (embedded additionally exercises
    the compressed-backpointer path once compiled at scale)."""
    from markovmodels_tpu import viterbi as vit

    rng = np.random.default_rng(11)
    fsm, spdf, P, _ = make_backoff_lm_hmm_graph(V=6, keep=0.25, layout=layout)
    cf = inf.compile_fsm(fsm, spdf, P, strategy="block")
    n = 12
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, 8], dtype=np.int32)
    ref = bench.host_viterbi_score(fsm, spdf, P, lhs.astype(np.float64), lens)
    states, score = vit.viterbi(cf, jnp.asarray(lhs), jnp.asarray(lens))
    np.testing.assert_allclose(np.asarray(score), ref, atol=1e-4)


def test_backoff_layouts_at_scale():
    """V=128: the embedded-diagonal layout and the *separate-state* layout
    (the reference pipeline's own graph shape, canonicalized by
    compile_fsm's capped/overflow layout) both compile to an all-affine
    blocked operator on the XLA block route; with the canonicalizing
    reorder disabled the operator falls back to index gathers, scatters
    and residue arcs, and the report names them."""
    fsm, spdf, P, info = make_backoff_lm_hmm_graph(V=128, keep=0.1)
    assert info["real_arcs"] < 0.2 * info["panel_slots"]
    cf = inf.compile_fsm(fsm, spdf, P, strategy="block")
    assert inf.fast_path_report(cf, 128).startswith(
        "xla block scan (affine operator")

    fsm_s, spdf_s, P_s, _ = make_backoff_lm_hmm_graph(
        V=128, keep=0.1, layout="separate"
    )
    cf_s = inf.compile_fsm(fsm_s, spdf_s, P_s, strategy="block")
    assert cf_s.ov_layout == (128, 3)
    assert cf_s.block_fwd.res_src is None and cf_s.block_bwd.res_src is None
    assert inf.fast_path_report(cf_s, 128).startswith(
        "xla block scan (affine operator")

    cf_raw = inf.compile_fsm(fsm_s, spdf_s, P_s, strategy="block",
                             reorder="none")
    report = inf.fast_path_report(cf_raw, 128)
    assert report.startswith("xla block scan (irregular operator"), report
    assert "scatter" in report and " 0 residue" not in report


def test_fast_path_report_matches_dispatch(monkeypatch):
    """The report must name the scan the dispatcher actually runs, for
    every strategy/domain variant and for stacked numerators at a matching
    and a mismatched batch."""
    from markovmodels_tpu.workloads import make_lm_hmm_graph

    ran = []
    for name in ("_fb_prob", "_fb_run", "_fb_banded_stacked"):
        fn = getattr(inf, name)

        def spy(*a, _fn=fn, _name=name, **k):
            ran.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(inf, name, spy)
    expect = {
        "xla block scan": "_fb_prob",
        "xla prob-domain scan": "_fb_prob",
        "xla log-domain scan": "_fb_run",
        "xla stacked banded scan": "_fb_banded_stacked",
    }

    def check(cf, B):
        report = inf.fast_path_report(cf, B)
        ran.clear()
        inf.pdfposteriors(cf, jnp.zeros((B, 2, cf.num_pdfs), jnp.float32))
        if report.startswith("xla vmapped per-graph scan"):
            assert ran and "_fb_banded_stacked" not in ran, (report, ran)
            return
        route = next(v for k, v in expect.items() if report.startswith(k))
        assert ran[0] == route, (report, ran)

    fsm_s, spdf_s, P_s, _ = make_lm_hmm_graph(V=4)
    fsm_l, spdf_l, P_l, _ = make_lm_hmm_graph(V=128)
    for cf in [
        inf.compile_fsm(fsm_s, spdf_s, P_s, strategy="dense"),
        inf.compile_fsm(fsm_s, spdf_s, P_s, strategy="dense", domain="log"),
        inf.compile_fsm(fsm_s, spdf_s, P_s, strategy="ell"),
        inf.compile_fsm(fsm_s, spdf_s, P_s, strategy="segment"),
        inf.compile_fsm(fsm_l, spdf_l, P_l, strategy="block"),
        inf.compile_fsm(fsm_l, spdf_l, P_l, strategy="block",
                        reorder="none"),
    ]:
        check(cf, 4)

    # stacked numerators: 'banded' ones take the stacked scan, 'dense' ones
    # the vmapped per-graph scan
    import markovmodels_tpu as mm2
    from markovmodels_tpu.fsm import FSM as _F
    from markovmodels_tpu.labels import Label as _L

    rng2 = np.random.default_rng(1)
    cfs, cfd = [], []
    for g in range(8):
        seq = rng2.integers(0, 6, size=4)
        arcs = [((i, i), np.log(0.5)) for i in range(4)] + [
            ((i, i + 1), np.log(0.5)) for i in range(3)
        ]
        f = _F.from_pairs(
            [(0, 0.0)], arcs, [(3, np.log(0.5))],
            [_L(int(s)) for s in seq], mm2.LOG,
        )
        spdf = np.append(seq, 6).astype(np.int32)
        cfs.append(inf.compile_fsm(f, spdf, 6, strategy="banded"))
        cfd.append(inf.compile_fsm(f, spdf, 6, strategy="dense"))
    check(inf.stack(cfs), 8)
    check(inf.stack(cfd), 8)
    # a batch that is not one sequence per graph is named in the report
    assert "batch 1, 8 graphs" in inf.fast_path_report(inf.stack(cfs), 1)


@pytest.mark.parametrize("V,cap", [(8, 8), (16, 16)])
def test_ov_layout_small_graph_parity(V, cap):
    """Forced capped/overflow canonicalization (ov_cap) on small separate
    backoff graphs: the XLA block path with overflow families must match
    the exact f64 host oracle, and the chunk-recompute Viterbi must match
    the f64 max-plus optimum."""
    from markovmodels_tpu import viterbi as vit

    rng = np.random.default_rng(5)
    fsm, spdf, P, info = make_backoff_lm_hmm_graph(
        V=V, hmm_states=3, keep=0.3, layout="separate"
    )
    cf = inf.compile_fsm(fsm, spdf, P, strategy="block", ov_cap=cap)
    assert cf.ov_layout == (cap, 3)
    assert not cf.pdf_group
    # every direction's backoff/bigram/diag arc families were lifted
    assert cf.block_fwd.ov_w and cf.block_bwd.ov_w
    n = 20
    lhs = rng.normal(size=(3, n, P)).astype(np.float32)
    lens = np.array([n, 13, 7], dtype=np.int32)
    ref_z, ref_p = bench.host_oracle(
        fsm, spdf, P, lhs.astype(np.float64), lens
    )
    got_p, got_z = inf.pdfposteriors(cf, jnp.asarray(lhs), jnp.asarray(lens))
    assert np.max(np.abs(np.asarray(got_z) - ref_z)) < 1e-4
    assert np.max(np.abs(np.asarray(got_p) - ref_p)) < 1e-4
    assert np.all(np.asarray(got_p)[2, 7:] == 0.0)
    ref_s = bench.host_viterbi_score(
        fsm, spdf, P, lhs.astype(np.float64), lens
    )
    _, score = vit.viterbi(cf, jnp.asarray(lhs), jnp.asarray(lens))
    np.testing.assert_allclose(np.asarray(score), ref_s, atol=1e-4)


def test_ov_bp_viterbi_matches_recompute_at_scale(monkeypatch):
    """The uint8-bp decode now covers overflow-family graphs: on the
    canonicalized V=128 separate-state backoff graph it must engage (no
    reject) and agree with the chunk-recompute decoder on scores AND
    paths."""
    from markovmodels_tpu import viterbi as vit

    fsm, spdf, P, _ = make_backoff_lm_hmm_graph(
        V=128, keep=0.1, layout="separate"
    )
    cf = inf.compile_fsm(fsm, spdf, P, strategy="block")
    rng = np.random.default_rng(5)
    lhs = jnp.asarray(rng.normal(size=(2, 25, P)).astype(np.float32))
    lens = jnp.asarray([25, 16], dtype=jnp.int32)
    assert vit._bp_vit_reject_reason(cf, lhs) is None
    st1, sc1 = vit.viterbi(cf, lhs, lens)
    monkeypatch.setenv("MMTPU_NO_VITBP", "1")
    st0, sc0 = vit.viterbi(cf, lhs, lens)
    np.testing.assert_allclose(np.asarray(sc1), np.asarray(sc0), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(st1), np.asarray(st0))


@pytest.mark.parametrize(
    "V,K,keep,cap",
    [(8, 5, 0.2, 8), (8, 3, 0.3, 4)],  # deep HMMs; cap BELOW V (30 groups)
)
def test_ov_layout_shape_fuzz(V, K, keep, cap):
    """Canonicalization robustness across graph shapes: deeper HMM chains
    and caps smaller than V (many overflow groups, multi-family splits)
    must stay residue-free and exact vs the f64 oracle on both the sum
    and tropical paths."""
    from markovmodels_tpu import viterbi as vit

    rng = np.random.default_rng(9)
    fsm, spdf, P, _ = make_backoff_lm_hmm_graph(
        V=V, hmm_states=K, keep=keep, layout="separate", seed=3
    )
    cf = inf.compile_fsm(fsm, spdf, P, strategy="block", ov_cap=cap)
    assert cf.ov_layout[0] == cap
    assert cf.block_fwd.res_src is None and cf.block_bwd.res_src is None
    n = 18
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, 11], dtype=np.int32)
    ref_z, ref_p = bench.host_oracle(
        fsm, spdf, P, lhs.astype(np.float64), lens
    )
    got_p, got_z = inf.pdfposteriors(cf, jnp.asarray(lhs), jnp.asarray(lens))
    assert np.max(np.abs(np.asarray(got_z) - ref_z)) < 1e-4
    assert np.max(np.abs(np.asarray(got_p) - ref_p)) < 1e-4
    ref_s = bench.host_viterbi_score(
        fsm, spdf, P, lhs.astype(np.float64), lens
    )
    _, sc = vit.viterbi(cf, jnp.asarray(lhs), jnp.asarray(lens))
    np.testing.assert_allclose(np.asarray(sc), ref_s, atol=1e-4)
