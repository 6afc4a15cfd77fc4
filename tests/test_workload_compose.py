"""The benchmark's pre-laid-out 2M-arc graph equals an LM ∘ HMM built
through the graph compiler (``compose``) — proving the pipeline route
(reference examples/prepare-lfmmi-graphs.jl:218-223) produces the same
denominator, and that the vectorized compose bridge handles LM-scale arc
counts.  Equality is checked EXACTLY under the known state permutation
(compose lays sub-FSMs out h-major, the workload plane-major) — the
``fsmequal`` label-sum oracle is infeasible here because label-path sets
grow exponentially on cyclic LM graphs.

``test_composed_graph_reaches_fused_path`` is the canonicalization gate:
compiling the compose-built graph must land on the SAME device layout as
the generator's (the pdf-grouped relabeling inside ``compile_fsm`` is the
canonicalization pass — it maps both host state orders onto one canonical
device order), an all-affine blocked operator."""
import time

import numpy as np

import markovmodels_tpu as mm
from markovmodels_tpu import hostsparse as hs
from markovmodels_tpu.workloads import (
    make_lm_hmm_graph,
    make_lm_hmm_graph_via_compose,
)


def test_composed_equals_direct_workload():
    V, K = 6, 3
    H = V * V
    direct, spdf, P, info = make_lm_hmm_graph(V=V)
    composed, spdf_c, P_c, info_c = make_lm_hmm_graph_via_compose(V=V)
    S = K * H
    assert P_c == P
    assert composed.num_states == direct.num_states == S
    assert composed.T_hat.nnz == direct.T_hat.nnz

    # composed state (h, k) sits at h*K + k; direct at k*H + h
    h = np.arange(S) // K
    k = np.arange(S) % K
    perm = np.concatenate([k * H + h, [S]])  # composed id -> direct id

    np.testing.assert_allclose(
        composed.alpha_hat, direct.alpha_hat[perm], atol=1e-12
    )
    np.testing.assert_array_equal(spdf_c, spdf[perm])
    rc, cc, dc = hs.findnz(composed.T_hat)
    rd, cd, dd = hs.findnz(direct.T_hat)
    oc = np.lexsort((perm[cc], perm[rc]))
    od = np.lexsort((cd, rd))
    np.testing.assert_array_equal(perm[rc][oc], rd[od])
    np.testing.assert_array_equal(perm[cc][oc], cd[od])
    np.testing.assert_allclose(dc[oc], dd[od], atol=1e-12)


def test_compose_scales_to_lm_arc_counts():
    """The vectorized bridge handles a ~0.5M-arc composition in seconds
    (a per-arc Python loop here takes minutes — the timing guard is
    deliberately loose to stay CI-safe)."""
    V = 48  # 48³ = 110k trigram bridge arcs
    t0 = time.time()
    composed, _, _, _ = make_lm_hmm_graph_via_compose(V=V)
    dt = time.time() - t0
    assert composed.T_hat.nnz > 120_000
    assert dt < 60, f"compose took {dt:.1f}s"


def test_composed_graph_reaches_fused_path():
    """Canonicalization gate: the graph the engine's own pipeline route
    produces (compose, h-major state order) must compile to an all-affine
    blocked operator with descriptors IDENTICAL to the plane-major
    generator's — the pdf-grouped relabeling in compile_fsm canonicalizes
    both host orders to one device layout (gate at the headline V=128)."""
    from markovmodels_tpu import inference as inf

    composed, spdf_c, P, _ = make_lm_hmm_graph_via_compose(V=128)
    cf_c = inf.compile_fsm(composed, spdf_c, P, strategy="block")
    assert inf.fast_path_report(cf_c, 128).startswith(
        "xla block scan (affine operator")

    direct, spdf, P2, _ = make_lm_hmm_graph(V=128)
    cf_d = inf.compile_fsm(direct, spdf, P2, strategy="block")
    # identical canonical device layout: same static metadata...
    assert cf_c.block_fwd_offsets == cf_d.block_fwd_offsets
    assert cf_c.block_bwd_offsets == cf_d.block_bwd_offsets
    assert cf_c.pdf_group == cf_d.pdf_group
    # ...and the SAME canonical arrays (both host orders collapse to one
    # device graph, so their numerics are literally shared)
    np.testing.assert_allclose(
        np.asarray(cf_c.alpha_hat), np.asarray(cf_d.alpha_hat), atol=1e-6
    )
    for t_c, t_d in zip(cf_c.block_fwd.tiers, cf_d.block_fwd.tiers):
        np.testing.assert_array_equal(np.asarray(t_c[0]), np.asarray(t_d[0]))
        np.testing.assert_array_equal(np.asarray(t_c[1]), np.asarray(t_d[1]))
        np.testing.assert_allclose(
            np.asarray(t_c[2]), np.asarray(t_d[2]), atol=1e-7
        )
    np.testing.assert_allclose(
        np.asarray(cf_c.block_fwd.band_w),
        np.asarray(cf_d.block_fwd.band_w),
        atol=1e-7,
    )

    # without the canonicalization (reorder='none') the report names the
    # irregular access patterns the operator falls back to
    cf_raw = inf.compile_fsm(
        composed, spdf_c, P, strategy="block", reorder="none"
    )
    report = inf.fast_path_report(cf_raw, 128)
    assert report.startswith("xla block scan (irregular operator"), report
    assert "gather" in report, report
