"""Headline benchmark: batched LF-MMI denominator forward-backward.

Sections (each numerically gated against an exact float64 host oracle
before it is timed; any gate failure aborts):

1. (headline JSON) the BASELINE-target scale: a 2M-arc trigram-LM ∘ HMM
   denominator graph (≈49k states, 384 pdfs), batch 128 × 700 frames —
   blocked gather-matmul-scatter strategy.  Plus the sweep split and N=700
   full-scale parity.
2. 2M-arc Viterbi: exactness gates (f64 path walk of ALL timed decodes) +
   wall time; then the end-to-end LF-MMI training step (stacked
   numerators + denominator + gradient).
3. layout coverage: weight-pruned (keep=0.9), the compose-BUILT same
   graph (pipeline route; its route report names the operator layout,
   also when compiled uncanonicalized), and the backoff pruned LM in both
   layouts (embedded-diagonal; separate-state = the reference pipeline's
   own shape, canonicalized by compile_fsm's capped/overflow layout).
4. sharded halo plan for the 2M graph (compile-time exchange traffic).
5. the reference's own benchmark: WSJ 3-gram phonotactic graph (~3,032
   states / ~52k arcs, 84 pdfs, reference misc/benchmark/README.md),
   batch 128 × 700, dense strategy.  Reference baseline: 2.003 s on a
   GTX 1080 ⇒ 1,342 audio-seconds/s at 30 ms frames (BASELINE.md), with
   an N=100/300/700 error ladder.
6. BASELINE 1e-4 logZ gate at float64: the same 2M block algorithm
   compiled at dtype=float64 runs on the device, gated at |dlogZ| <= 1e-4
   vs the exact host oracle at N=700, with its measured cost recorded.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""
import json
import os
import sys
import time

import numpy as np

WSJ_FST = "/root/reference/misc/benchmark/den_fsm_wsj.txt"
BASELINE_AUDIO_S_PER_S = 1342.0  # GTX 1080, 2.003 s for 128x700 @ 30 ms
FRAME_SHIFT_S = 0.03


def load_wsj_fst(path):
    """Parse the reference's OpenFST-style text graph via the shared loader
    (C++ parser when available; conventions documented at
    serialization.load_openfst_lfmmi)."""
    from markovmodels_tpu.serialization import load_openfst_lfmmi

    return load_openfst_lfmmi(path, num_pdfs=84)


def host_oracle(fsm, spdf, num_pdfs, lhs, lengths):
    """Exact float64 forward-backward (scipy sparse, prob domain with
    per-frame rescaling) — independent of the device code path.  Returns
    (logZ (B,), posteriors (B, N, P))."""
    import scipy.sparse as sp
    from markovmodels_tpu import hostsparse as hs

    rows, cols, data = hs.findnz(fsm.T_hat)
    S1 = len(fsm.alpha_hat)
    w = np.exp(np.asarray(data, dtype=np.float64))
    Tt = sp.csr_matrix((w, (cols, rows)), shape=(S1, S1))
    Tm = sp.csr_matrix((w, (rows, cols)), shape=(S1, S1))
    a0 = np.exp(np.asarray(fsm.alpha_hat, dtype=np.float64))
    B, N, P = lhs.shape
    logZ = []
    posts = np.zeros((B, N, P))
    for b in range(B):
        L = int(lengths[b])

        def emis(t):
            e = np.zeros(S1)
            if t < L:
                e[: S1 - 1] = np.exp(lhs[b, t])[spdf[: S1 - 1]]
            else:
                e[S1 - 1] = 1.0
            return e

        A = np.zeros((L + 1, S1))
        v, shift = a0.copy(), 0.0
        for t in range(L + 1):
            v = (v if t == 0 else Tt @ v) * emis(t)
            m = v.max()
            if m > 0:
                v /= m
                shift += np.log(m)
            A[t] = v
        val = v[S1 - 1]
        logZ.append(np.log(val) + shift if val > 0 else -np.inf)
        bb = np.zeros(S1)
        bb[S1 - 1] = 1.0
        for t in range(L, -1, -1):
            y = bb if t == L else Tm @ bb
            m = y.max()
            if m > 0:
                y = y / m
            g = A[t] * y
            if t < L:
                gp = np.zeros(num_pdfs + 1)
                np.add.at(gp, spdf[: S1 - 1], g[: S1 - 1])
                gp[num_pdfs] += g[S1 - 1]
                tot = gp.sum()
                posts[b, t] = gp[:num_pdfs] / (tot if tot > 0 else 1.0)
            bb = y * emis(t)
    return np.array(logZ), posts


def host_oracle_logZ(fsm, spdf, num_pdfs, lhs, lengths):
    return host_oracle(fsm, spdf, num_pdfs, lhs, lengths)[0]


def host_viterbi_score(fsm, spdf, num_pdfs, lhs, lengths):
    """Exact float64 max-plus forward (best-path scores only)."""
    from markovmodels_tpu import hostsparse as hs

    rows, cols, data = hs.findnz(fsm.T_hat)
    data = np.asarray(data, dtype=np.float64)
    S1 = len(fsm.alpha_hat)
    a0 = np.asarray(fsm.alpha_hat, dtype=np.float64)
    scores = []
    for b in range(lhs.shape[0]):
        L = int(lengths[b])
        v = a0.copy()
        for t in range(L + 1):
            if t > 0:
                y = np.full(S1, -np.inf)
                np.maximum.at(y, cols, data + v[rows])
                v = y
            e = np.full(S1, -np.inf)
            if t < L:
                e[: S1 - 1] = lhs[b, t][spdf[: S1 - 1]]
            else:
                e[S1 - 1] = 0.0
            v = v + e
        scores.append(v[S1 - 1])
    return np.array(scores)


def _viterbi_gate(vit, jax, jnp, fsm, spdf, P, cf, n=40, tol=1e-3):
    """Viterbi exactness gate: the decoded path's exact f64 weight must equal
    the f64 max-plus optimum (BASELINE: 'Viterbi paths exact'), and the
    device score must match to f32 accumulation tolerance."""
    import scipy.sparse as sp
    from markovmodels_tpu import hostsparse as hs

    rng = np.random.default_rng(11)
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, max(2, 2 * n // 3)], dtype=np.int32)
    ref = host_viterbi_score(fsm, spdf, P, lhs.astype(np.float64), lens)
    states, score = vit.viterbi(cf, jnp.asarray(lhs), jnp.asarray(lens))
    states, score = np.asarray(states), np.asarray(score)
    serr = float(np.max(np.abs(score - ref)))
    assert serr < tol, f"viterbi score parity failed: {serr}"
    # exact f64 weight of the returned path
    rows, cols, data = hs.findnz(fsm.T_hat)
    S1 = len(fsm.alpha_hat)
    T = sp.csr_matrix(
        (np.asarray(data, dtype=np.float64), (rows, cols)), shape=(S1, S1)
    )
    T.sort_indices()

    def arc_w(i, j):
        """Arc weight or -inf if the arc does not exist (catches invalid
        decoded paths — scipy's scalar indexing would silently return 0)."""
        lo, hi = T.indptr[i], T.indptr[i + 1]
        k = lo + np.searchsorted(T.indices[lo:hi], j)
        return T.data[k] if k < hi and T.indices[k] == j else -np.inf

    a0 = np.asarray(fsm.alpha_hat, dtype=np.float64)
    gap = 0.0
    for b in range(2):
        L = int(lens[b])
        path = states[b, :L]
        w = a0[path[0]] + float(
            lhs[b, np.arange(L), spdf[path]].astype(np.float64).sum()
        )
        for t in range(L - 1):
            w += arc_w(path[t], path[t + 1])
        w += arc_w(path[L - 1], S1 - 1)  # ω arc into the phony final state
        gap = max(gap, abs(ref[b] - w))
    assert gap < 1e-4, f"viterbi path not optimal: gap {gap}"
    return serr, gap


def _time_posteriors(inf, jax, cf, lhs, lengths, reps=3):
    run = jax.jit(lambda l, n: inf.pdfposteriors(cf, l, n))
    jax.block_until_ready(run(lhs, lengths))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(lhs, lengths))
        ts.append(time.perf_counter() - t0)
    return min(ts), run


def _cost_analysis(jax, run, lhs, lengths):
    """XLA's own accounting of the compiled executable: (flops, HBM bytes
    accessed) or (None, None)."""
    try:
        ca = jax.jit(run).lower(lhs, lengths).compile().cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        return ca.get("flops"), ca.get("bytes accessed")
    except Exception:
        return None, None


def _validate_paths_full(fsm, spdf, lhs, lengths, states, score, atol=2e-3):
    """f64 walk of each decoded path: weight must equal the device score
    (f32 accumulation tolerance over N frames).  Vectorized arc lookup
    (sorted int64 (src, dst) keys + searchsorted) so walking the WHOLE
    timed batch (128 x 700 frames) costs milliseconds."""
    from markovmodels_tpu import hostsparse as hs

    rows, cols, data = hs.findnz(fsm.T_hat)
    S1 = len(fsm.alpha_hat)
    keys = rows.astype(np.int64) * (S1 + 1) + cols
    order = np.argsort(keys)
    keys = keys[order]
    vals = np.asarray(data, dtype=np.float64)[order]

    def arc_w(i, j):
        """Vectorized arc weights; -inf where the arc does not exist
        (catches invalid decoded paths)."""
        k = np.asarray(i, dtype=np.int64) * (S1 + 1) + np.asarray(j)
        pos = np.minimum(np.searchsorted(keys, k), len(keys) - 1)
        return np.where(keys[pos] == k, vals[pos], -np.inf)

    a0 = np.asarray(fsm.alpha_hat, dtype=np.float64)
    lhs = np.asarray(lhs)
    gap = 0.0
    for b in range(lhs.shape[0]):
        L = int(lengths[b])
        path = np.asarray(states[b, :L])
        w = (
            a0[path[0]]
            + float(lhs[b, np.arange(L), spdf[path]].astype(np.float64).sum())
            + float(arc_w(path[:-1], path[1:]).sum())
            + float(arc_w(path[L - 1 : L], [S1 - 1])[0])
        )
        gap = max(gap, abs(w - float(score[b])))
    assert gap < atol, f"decoded path weight vs device score: {gap}"
    return gap


def _parity(inf, jax, jnp, fsm, spdf, P, cf, n=40, tol=2e-4, ptol=2e-4):
    """Gate logZ AND posteriors (the actual timed output) against the exact
    f64 host oracle."""
    rng = np.random.default_rng(7)
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, max(2, 2 * n // 3)], dtype=np.int32)
    ref_z, ref_p = host_oracle(fsm, spdf, P, lhs.astype(np.float64), lens)
    got_p, got_z = inf.pdfposteriors(cf, jnp.asarray(lhs), jnp.asarray(lens))
    err = float(np.max(np.abs(np.asarray(got_z) - ref_z)))
    perr = float(np.max(np.abs(np.asarray(got_p) - ref_p)))
    assert err < tol, f"logZ parity check failed: {err}"
    assert perr < ptol, f"posterior parity check failed: {perr}"
    return err, perr


def main():
    import jax
    import jax.numpy as jnp

    import markovmodels_tpu as mm
    from markovmodels_tpu import inference as inf
    from markovmodels_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    from markovmodels_tpu.workloads import make_lm_hmm_graph

    B, N = 128, 700
    rng = np.random.default_rng(0)
    audio_s = B * N * FRAME_SHIFT_S

    # ---- workload 1 (headline): 2M-arc trigram-LM ∘ HMM graph -----------
    fsm, spdf, P, info = make_lm_hmm_graph(V=128)
    print(f"# 2m graph: {info}", file=sys.stderr)
    cf = inf.compile_fsm(fsm, spdf, P, strategy="block", precision="high")
    # BASELINE.md target: log-marginals allclose atol 1e-4 on the 2M-arc
    # workload (measured ≈2e-5 at N=40 and ≈6e-5 at the full N=700)
    err, perr = _parity(inf, jax, jnp, fsm, spdf, P, cf, tol=1e-4, ptol=1e-4)
    print(
        f"# 2m parity vs f64 oracle (N=40):  |dlogZ| = {err:.3e}, "
        f"|dposts| = {perr:.3e}",
        file=sys.stderr,
    )
    lhs = jnp.asarray(rng.normal(size=(B, N, P)).astype(np.float32) * 0.5)
    lengths = jnp.full((B,), N, dtype=jnp.int32)
    print(f"# 2m path: {inf.fast_path_report(cf, B)}", file=sys.stderr)
    t_2m, run_2m = _time_posteriors(inf, jax, cf, lhs, lengths)
    if t_2m < 0.02:  # timing-artifact guard (one run measured 0.1 ms once;
        # re-measure with fresh inputs rather than report a bogus headline)
        lhs = jnp.asarray(rng.normal(size=(B, N, P)).astype(np.float32) * 0.5)
        t_2m, run_2m = _time_posteriors(inf, jax, cf, lhs, lengths)
    v_2m = audio_s / t_2m
    print(f"# 2m fwd-bwd: {t_2m:.4f} s -> {v_2m:.0f} audio-s/s", file=sys.stderr)

    # Headline JSON first: everything below is informational/gating detail
    # and must not cost the driver the headline if its harness timeout is
    # tight (a cold compile of the full suite takes minutes).
    print(
        json.dumps(
            {
                "metric": "audio-seconds/s/chip LF-MMI fwd-bwd (2M-arc den "
                          "graph, B=128, N=700, f32); log-marginal f64-oracle "
                          "parity gated",
                "value": round(v_2m, 1),
                "unit": "audio-s/s",
                # which parity gates ran BEFORE this line was printed; the
                # remaining gates (N=700 parity, Viterbi exactness + full
                # path walk, backoff/pruned fast-path, WSJ ladder) run
                # after and abort the bench on failure
                "gates_pre_headline": "N=40 logZ+posterior parity vs f64 "
                                      "oracle on the timed graph",
            }
        ),
        flush=True,
    )

    # XLA's own accounting of the timed executable (VERDICT r2: measure,
    # don't estimate): HBM bytes and flops of the whole B=128 x N=700 run
    fl, by = _cost_analysis(
        jax, lambda l, n: inf.pdfposteriors(cf, l, n), lhs, lengths
    )
    if by is not None:
        # flops counted analytically — 3 sweeps (fwd, recompute, bwd)
        # x 2 flops/arc x arcs x B x N, plus the emission/posterior work
        fl_an = 3 * 2 * info["arcs"] * B * N + 4 * cf.padded_states * B * N
        print(
            f"# 2m measured HBM (xla cost analysis): {by / 1e9:.2f} GB "
            f"({by / (N * 1e6):.2f} MB/frame) -> {by / t_2m / 1e9:.0f} GB/s"
            f"; analytic {fl_an / 1e12:.2f} Tflop -> "
            f"{fl_an / t_2m / 1e12:.1f} Tflop/s achieved",
            file=sys.stderr,
        )

    # time the forward sweep alone to split the 3-sweep pipeline
    runf = jax.jit(lambda l, n: inf.forward(cf, l, n))
    jax.block_until_ready(runf(lhs, lengths))
    t0 = time.perf_counter()
    jax.block_until_ready(runf(lhs, lengths))
    t_fwd = time.perf_counter() - t0
    tier_flops_frame = 2 * int(np.prod(cf.block_fwd.tiers[0][2].shape)) * B
    print(
        f"# 2m sweep split: fwd-only {t_fwd:.4f} s "
        f"({t_fwd / (N + 1) * 1e6:.0f} us/frame), recompute+bwd "
        f"{t_2m - t_fwd:.4f} s; tier dot per frame = "
        f"{tier_flops_frame / 1e6:.0f} MFLOP",
        file=sys.stderr,
    )

    # full-scale parity: N=700, B=2 vs the exact f64 host oracle — the
    # headline shape's accuracy, measured rather than extrapolated.  f32
    # round-off accumulates ~linearly in N; gate at 1e-3.
    err7, perr7 = _parity(
        inf, jax, jnp, fsm, spdf, P, cf, n=N, tol=1e-3, ptol=1e-4
    )
    print(
        f"# 2m parity vs f64 oracle (N=700): |dlogZ| = {err7:.3e} "
        f"({err7 / N:.1e}/frame vs {err / 40:.1e}/frame at N=40 — linear "
        f"f32 accumulation), |dposts| = {perr7:.3e}",
        file=sys.stderr,
    )

    # 2M-arc Viterbi: exactness gate + wall time (BASELINE: paths exact)
    from markovmodels_tpu import viterbi as vit

    serr, gap = _viterbi_gate(vit, jax, jnp, fsm, spdf, P, cf)
    print(
        f"# 2m viterbi gate (N=40): |dscore| = {serr:.3e}, path-weight gap "
        f"= {gap:.3e}",
        file=sys.stderr,
    )
    vrun = jax.jit(lambda l, n: vit.viterbi(cf, l, n))
    vout = vrun(lhs, lengths)
    jax.block_until_ready(vout)
    t0 = time.perf_counter()
    vout = vrun(lhs, lengths)
    jax.block_until_ready(vout)
    t_vit = time.perf_counter() - t0
    # validate the TIMED decode at full scale: every returned path's exact
    # f64 weight must equal the device score (one walk per sequence)
    vgap = _validate_paths_full(
        fsm, spdf, np.asarray(lhs), np.asarray(lengths),
        np.asarray(vout[0]), np.asarray(vout[1]),
    )
    print(
        f"# 2m viterbi: {t_vit:.4f} s -> {audio_s / t_vit:.0f} audio-s/s "
        f"(N=700 path-weight gap {vgap:.2e}, all {B} seqs walked)",
        file=sys.stderr,
    )
    vit_ops = 2 * info["arcs"] * B  # mult+max per edge per sequence
    print(
        f"# 2m viterbi: {vit_ops * (N + 1) / t_vit / 1e12:.2f} T "
        f"multiply-max ops/s achieved over the sweep",
        file=sys.stderr,
    )

    # ---- end-to-end LF-MMI training step (VERDICT r3 item 7): B=128
    # stacked linear numerators + the 2M denominator + gradient (the
    # reference's training loop scores both; ref numerator graphs
    # misc/benchmark/num_fsm_wsj.txt).  Gradient w.r.t. the emissions is
    # gamma_den - gamma_num via the posterior surrogate — no scan autodiff.
    from markovmodels_tpu.fsm import FSM
    from markovmodels_tpu.labels import Label

    num_cfs = []
    rng_n = np.random.default_rng(3)
    for b in range(B):
        Lp = 78  # ~9 frames per 3-state phone HMM at N=700
        seq = rng_n.integers(0, P, size=Lp)
        Sn = Lp
        arcs = [((i, i), np.log(0.5)) for i in range(Sn)] + [
            ((i, i + 1), np.log(0.5)) for i in range(Sn - 1)
        ]
        f = FSM.from_pairs(
            [(0, 0.0)], arcs, [(Sn - 1, np.log(0.5))],
            [Label(int(s)) for s in seq], mm.LOG,
        )
        # stacked numerators use the 'banded' strategy: linear lattices
        # are 2-band (self + chain) matrices, so the per-frame matvec is
        # two shifted elementwise multiply-adds over the (G, Sp) state —
        # O(G·nO·Sp) instead of the vmapped dense path's O(G·Sp²)
        num_cfs.append(
            inf.compile_fsm(f, np.append(seq, P).astype(np.int32), P,
                            strategy="banded")
        )
    num_cf = inf.stack(num_cfs)

    def lfmmi_step(lhs_):
        return inf.lfmmi_loss(num_cf, cf, lhs_, lengths).sum()

    rune = jax.jit(jax.value_and_grad(lfmmi_step))
    jax.block_until_ready(rune(lhs))
    t0 = time.perf_counter()
    loss, grad = rune(lhs)
    jax.block_until_ready(grad)
    t_e2e = time.perf_counter() - t0
    assert np.isfinite(float(loss)), "non-finite LF-MMI loss"
    assert np.isfinite(np.asarray(grad)).all(), "non-finite LF-MMI grad"
    print(
        f"# 2m e2e LF-MMI step (num+den+grad, B={B}): {t_e2e:.4f} s -> "
        f"{audio_s / t_e2e:.0f} audio-s/s (den-only fwd-bwd was "
        f"{audio_s / t_2m:.0f}; numerators: "
        f"{inf.fast_path_report(num_cf, B)})",
        file=sys.stderr,
    )
    del num_cf, num_cfs, lhs

    # ---- bf16 mixed-precision mode (BASELINE config 4): bf16 operands
    # with f32 accumulation in the tier products, f32 state with the same
    # exact power-of-two rescaling ------------------------------------------
    cf16 = inf.compile_fsm(fsm, spdf, P, strategy="block", precision="bf16")
    err16, perr16 = _parity(
        inf, jax, jnp, fsm, spdf, P, cf16, n=N, tol=2e-3, ptol=1e-3
    )
    lhs = jnp.asarray(rng.normal(size=(B, N, P)).astype(np.float32) * 0.5)
    t_16, _ = _time_posteriors(inf, jax, cf16, lhs, lengths)
    print(
        f"# 2m bf16 fwd-bwd: {t_16:.4f} s -> {audio_s / t_16:.0f} "
        f"audio-s/s ({t_2m / t_16:.2f}x the f32 path); parity vs f64 "
        f"oracle (N={N}): |dlogZ| = {err16:.3e}, |dposts| = {perr16:.3e} "
        f"— the bf16-dot round-off; the speed/accuracy trade is the "
        f"caller's via precision=",
        file=sys.stderr,
    )
    del cf16, cf, lhs

    # ---- pruned realistic variant: keep=0.9 trigram (the reference's
    # denominator graphs are pruned n-gram LMs, misc/benchmark/README.md) --
    fsm_p, spdf_p, P_p, info_p = make_lm_hmm_graph(V=128, keep=0.9)
    cf_p = inf.compile_fsm(
        fsm_p, spdf_p, P_p, strategy="block", precision="high"
    )
    err_p, perr_p = _parity(
        inf, jax, jnp, fsm_p, spdf_p, P_p, cf_p, tol=1e-4, ptol=1e-4
    )
    lhs = jnp.asarray(rng.normal(size=(B, N, P_p)).astype(np.float32) * 0.5)
    t_p, _ = _time_posteriors(inf, jax, cf_p, lhs, lengths)
    print(
        f"# 2m pruned (keep=0.9, {info_p['arcs']} arcs): parity |dlogZ| = "
        f"{err_p:.3e}, |dposts| = {perr_p:.3e}; "
        f"path = {inf.fast_path_report(cf_p, B)}; "
        f"{t_p:.4f} s -> {audio_s / t_p:.0f} audio-s/s "
        f"({t_p / t_2m:.2f}x unpruned time)",
        file=sys.stderr,
    )
    assert t_p < 1.5 * t_2m, "pruned graph fell off the fast-path cliff"
    del cf_p, lhs

    # ---- pipeline-route variant: the SAME denominator built through the
    # graph compiler (compose, h-major state order — the route the
    # reference pipeline takes, examples/prepare-lfmmi-graphs.jl:218-223).
    # compile_fsm's pdf-grouped relabeling canonicalizes it onto the same
    # device layout as the generator: gate that it runs at headline speed.
    from markovmodels_tpu.workloads import make_lm_hmm_graph_via_compose

    fsm_c, spdf_c, P_c, info_c = make_lm_hmm_graph_via_compose(V=128)
    cf_c = inf.compile_fsm(fsm_c, spdf_c, P_c, strategy="block",
                           precision="high")
    report_c = inf.fast_path_report(cf_c, B)
    err_c, perr_c = _parity(
        inf, jax, jnp, fsm_c, spdf_c, P_c, cf_c, tol=1e-4, ptol=1e-4
    )
    lhs = jnp.asarray(rng.normal(size=(B, N, P_c)).astype(np.float32) * 0.5)
    t_c, _ = _time_posteriors(inf, jax, cf_c, lhs, lengths)
    # the same graph compiled WITHOUT the canonicalizing relabeling: the
    # report names the irregular operator it falls back to
    cf_raw = inf.compile_fsm(fsm_c, spdf_c, P_c, strategy="block",
                             reorder="none")
    print(
        f"# 2m via-compose ({info_c['arcs']} arcs, h-major host order): "
        f"parity |dlogZ| = {err_c:.3e}, |dposts| = {perr_c:.3e}; "
        f"path = {report_c}; {t_c:.4f} s -> {audio_s / t_c:.0f} audio-s/s "
        f"({t_c / t_2m:.2f}x generator-layout time)",
        file=sys.stderr,
    )
    print(
        f"# 2m via-compose WITHOUT canonicalization (reorder='none'): "
        f"{inf.fast_path_report(cf_raw, B)}",
        file=sys.stderr,
    )
    assert t_c < 1.2 * t_2m, "compose-built graph must run at headline speed"
    del cf_c, cf_raw, fsm_c, lhs

    # ---- BACKOFF pruned LM (the reference's actual WSJ workload shape —
    # pruned n-gram with backoff structure at ~10% trigram density,
    # misc/benchmark/README.md:5-6 — at the 2M-panel scale).  The embedded
    # diagonal layout (workloads.make_backoff_lm_hmm_graph) keeps the
    # backoff/bigram families inside the dense tier's affine pattern; the
    # separate-state layout needs compile_fsm's capped/overflow layout.
    from markovmodels_tpu.workloads import make_backoff_lm_hmm_graph

    fsm_b, spdf_b, P_b, info_b = make_backoff_lm_hmm_graph(V=128, keep=0.1)
    cf_b = inf.compile_fsm(fsm_b, spdf_b, P_b, strategy="block",
                           precision="high")
    report_b = inf.fast_path_report(cf_b, B)
    err_b, perr_b = _parity(
        inf, jax, jnp, fsm_b, spdf_b, P_b, cf_b, tol=1e-4, ptol=1e-4
    )
    lhs = jnp.asarray(rng.normal(size=(B, N, P_b)).astype(np.float32) * 0.5)
    t_b, _ = _time_posteriors(inf, jax, cf_b, lhs, lengths)
    print(
        f"# 2m backoff (embedded-diagonal layout; {info_b['real_arcs']} "
        f"real arcs in {info_b['panel_slots']} panel slots, "
        f"{info_b['density']:.1%} trigram density + backoff/bigram rows): "
        f"parity |dlogZ| = {err_b:.3e}, |dposts| = {perr_b:.3e}; path = "
        f"{report_b}; {t_b:.4f} s -> {audio_s / t_b:.0f} audio-s/s "
        f"({t_b / t_2m:.2f}x dense-trigram time)",
        file=sys.stderr,
    )
    assert t_b < 2.0 * t_2m, "backoff graph must stay within 2x of headline"
    # Viterbi generality: the compressed-uint8-bp decode must also accept
    # the backoff graph's operator (single affine tier) and return exact
    # paths on it — the second graph family through the decoder
    serr_b, gap_b = _viterbi_gate(vit, jax, jnp, fsm_b, spdf_b, P_b, cf_b)
    vrun_b = jax.jit(lambda l, n: vit.viterbi(cf_b, l, n))
    jax.block_until_ready(vrun_b(lhs, lengths))
    t0 = time.perf_counter()
    vout_b = vrun_b(lhs, lengths)
    jax.block_until_ready(vout_b)
    t_vb = time.perf_counter() - t0
    print(
        f"# 2m backoff viterbi (uint8-bp decode): |dscore| = {serr_b:.3e}, "
        f"path-weight gap = {gap_b:.3e}; {t_vb:.4f} s -> "
        f"{audio_s / t_vb:.0f} audio-s/s",
        file=sys.stderr,
    )
    del cf_b, fsm_b, vout_b

    fsm_s, spdf_s, P_s, info_s = make_backoff_lm_hmm_graph(
        V=128, keep=0.1, layout="separate"
    )
    cf_s = inf.compile_fsm(fsm_s, spdf_s, P_s, strategy="block",
                           precision="high")
    report_s = inf.fast_path_report(cf_s, B)
    err_s, perr_s = _parity(
        inf, jax, jnp, fsm_s, spdf_s, P_s, cf_s, tol=1e-4, ptol=1e-4
    )
    t_s, _ = _time_posteriors(inf, jax, cf_s, lhs, lengths)
    print(
        f"# 2m backoff SEPARATE-state layout (the reference pipeline's own "
        f"graph shape, {info_s['real_arcs']} arcs; canonicalized into the "
        f"capped/overflow layout, ov={cf_s.ov_layout}): parity "
        f"|dlogZ| = {err_s:.3e}, |dposts| = {perr_s:.3e}; path = "
        f"{report_s}; {t_s:.4f} s -> {audio_s / t_s:.0f} audio-s/s "
        f"({t_s / t_b:.2f}x the embedded layout)",
        file=sys.stderr,
    )
    assert t_s < 1.2 * t_b, (
        "separate-state layout must run within 1.2x of the embedded layout"
    )
    # Viterbi on the canonicalized graph: the uint8-bp decode must accept
    # the overflow families (round-5 extension) and return exact paths
    assert vit._bp_vit_reject_reason(cf_s, lhs) is None, (
        vit._bp_vit_reject_reason(cf_s, lhs)
    )
    serr_s, gap_s = _viterbi_gate(vit, jax, jnp, fsm_s, spdf_s, P_s, cf_s)
    vrun_s = jax.jit(lambda l, n: vit.viterbi(cf_s, l, n))
    jax.block_until_ready(vrun_s(lhs, lengths))
    t0 = time.perf_counter()
    jax.block_until_ready(vrun_s(lhs, lengths))
    t_vs = time.perf_counter() - t0
    print(
        f"# 2m backoff separate viterbi (uint8-bp decode over overflow "
        f"families): |dscore| = {serr_s:.3e}, path-weight gap = "
        f"{gap_s:.3e}; {t_vs:.4f} s -> {audio_s / t_vs:.0f} audio-s/s",
        file=sys.stderr,
    )
    # the canonicalization is the difference: with reorder='none' the
    # report names the irregular operator
    cf_s_raw = inf.compile_fsm(fsm_s, spdf_s, P_s, strategy="block",
                               reorder="none")
    print(
        f"# 2m backoff separate WITHOUT canonicalization (reorder='none'): "
        f"{inf.fast_path_report(cf_s_raw, B)}",
        file=sys.stderr,
    )
    del cf_s, cf_s_raw, fsm_s, lhs

    # ---- sharded halo plan for the 2M graph (scale-out story; record the
    # compile-time exchange plan) ------------------------------------------
    from markovmodels_tpu.parallel.sharded import (
        halo_report,
        lm_hmm_assignment,
        shard_compiled_prob,
    )

    sfp = shard_compiled_prob(
        fsm, spdf, P, num_shards=8, shard_of=lm_hmm_assignment(128, 3, 8)
    )
    print(f"# 2m sharded halo plan (G=8): {halo_report(sfp)}", file=sys.stderr)
    del sfp

    # ---- temporal parallelism in its claimed win regime (VERDICT r4
    # item 7): assoc_forward vs the sequential scan on ONE chip, dense
    # S=256 graph, N=8192, B=2 — record the crossover or its absence ----
    from markovmodels_tpu.ops.assoc_scan import assoc_forward

    Sa, Na, Ba, Pa = 256, 8192, 2, 64
    rng_a = np.random.default_rng(4)
    Ta = np.full((Sa, Sa), -np.inf)
    for i in range(Sa):
        js = rng_a.choice(Sa, size=3, replace=False)
        w = rng_a.uniform(0.1, 1.0, size=3)
        Ta[i, js] = np.log(w / (w.sum() * 1.2))
    alpha_a = np.full(Sa, -np.inf)
    alpha_a[0] = 0.0
    omega_a = np.full(Sa, np.log(0.3))
    from markovmodels_tpu import hostsparse as hs_a
    from markovmodels_tpu.labels import Label as La

    fsm_a = mm.FSM.from_parts(
        alpha_a, hs_a.spmat_from_dense(Ta, mm.LOG), omega_a,
        [La(i % Pa) for i in range(Sa)], mm.LOG,
    )
    spdf_a = np.array([i % Pa for i in range(Sa)] + [Pa], dtype=np.int32)
    cf_a = inf.compile_fsm(fsm_a, spdf_a, Pa, strategy="dense")
    lhs_a = jnp.asarray(rng_a.normal(size=(Ba, Na, Pa)).astype(np.float32))
    lens_a = jnp.full((Ba,), Na, dtype=jnp.int32)
    run_seq = jax.jit(lambda l, n: inf.forward(cf_a, l, n))
    jax.block_until_ready(run_seq(lhs_a, lens_a))
    t0 = time.perf_counter()
    jax.block_until_ready(run_seq(lhs_a, lens_a))
    t_seq = time.perf_counter() - t0
    run_as = jax.jit(lambda l, n: assoc_forward(cf_a, l, n, chunk=32))
    jax.block_until_ready(run_as(lhs_a, lens_a))
    t0 = time.perf_counter()
    za = run_as(lhs_a, lens_a)
    jax.block_until_ready(za)
    t_as = time.perf_counter() - t0
    dz_a = float(np.max(np.abs(np.asarray(za) - np.asarray(run_seq(lhs_a, lens_a)))))
    print(
        f"# assoc_forward win-regime probe (dense S={Sa}, N={Na}, B={Ba}, "
        f"one chip): sequential {t_seq:.4f} s vs associative {t_as:.4f} s "
        f"({t_as / t_seq:.1f}x, |dz| = {dz_a:.1e}); the operator-product "
        f"fold costs O(S^3/chunk) matmul work "
        f"per frame vs the scan's O(S^2), so temporal parallelism pays "
        f"only when the time axis is sharded across devices "
        f"(parallel/timeshard.py)",
        file=sys.stderr,
    )
    del cf_a, fsm_a, lhs_a, fsm

    # ---- workload 2: reference WSJ benchmark ----------------------------
    v_wsj = None
    if os.path.exists(WSJ_FST):
        fsm, spdf, P = load_wsj_fst(WSJ_FST)
        # WSJ f32 floor is ≈1.1e-4 on logZ (per-frame f32 summation over the
        # denser WSJ rows accumulates round-off linearly in N; posteriors
        # stay ~1e-6 because normalization cancels the common drift) — gate
        # at 2e-4 and DEMONSTRATE the linear-in-N accumulation below.
        cf = inf.compile_fsm(fsm, spdf, P, strategy="dense", precision="high")
        errs = []
        for n_probe in (100, 300, 700):
            # per-probe gate scales with N: the f32 summation floor is
            # ~7e-7/frame (the ladder below demonstrates the linearity)
            e_n, p_n = _parity(
                inf, jax, jnp, fsm, spdf, P, cf, n=n_probe,
                tol=max(2e-4, 2e-6 * n_probe), ptol=1e-4,
            )
            errs.append((n_probe, e_n, p_n))
        per_frame = [e / n for n, e, _ in errs]
        assert max(per_frame) < 3 * max(min(per_frame), 1e-8), (
            f"per-frame error not ~constant: {per_frame} — superlinear "
            "growth would indicate an algorithmic error, not round-off"
        )
        print(
            "# wsj parity vs f64 oracle: "
            + ", ".join(f"N={n}: |dlogZ|={e:.2e}" for n, e, _ in errs)
            + f"; per-frame {min(per_frame):.1e}..{max(per_frame):.1e} "
            "(linear-in-N accumulation -> f32 summation floor, not an "
            "algorithmic error)",
            file=sys.stderr,
        )
        print(
            f"# wsj posts parity: |dposts| = {max(p for _, _, p in errs):.3e}",
            file=sys.stderr,
        )
        lhs = jnp.asarray(rng.normal(size=(B, N, P)).astype(np.float32) * 0.5)
        t_wsj, _ = _time_posteriors(inf, jax, cf, lhs, lengths)
        v_wsj = audio_s / t_wsj
        print(
            f"# wsj fwd-bwd: {t_wsj:.4f} s -> {v_wsj:.0f} audio-s/s "
            f"(reference GPU: 2.003 s -> 1342; speedup {2.003 / t_wsj:.1f}x)",
            file=sys.stderr,
        )

    # ---- BASELINE 1e-4 logZ gate at float64: the same block algorithm
    # compiled at dtype=float64 runs on the device.  The f32 path's
    # |dlogZ| at N=700 is the linear-in-N f32 summation floor; this mode
    # closes the literal gate, at the cost printed below — available
    # whenever a caller needs the letter of the 1e-4 contract rather than
    # the f32 per-frame floor.
    fsm64, spdf64, P64, _ = make_lm_hmm_graph(V=128)
    rng64 = np.random.default_rng(7)
    lhs64 = rng64.normal(size=(2, N, P64))
    lens64 = np.array([N, max(2, 2 * N // 3)], dtype=np.int32)
    ref64 = host_oracle_logZ(fsm64, spdf64, P64, lhs64, lens64)
    jax.config.update("jax_enable_x64", True)
    try:
        cf64 = inf.compile_fsm(fsm64, spdf64, P64, strategy="block",
                               dtype=jnp.float64)
        got64 = inf.forward(cf64, jnp.asarray(lhs64), jnp.asarray(lens64))
        err64 = float(np.max(np.abs(np.asarray(got64) - ref64)))
        assert err64 < 1e-4, f"f64 logZ gate failed: {err64}"
        lhs_t = jnp.asarray(
            np.asarray(rng64.normal(size=(B, N, P64)) * 0.5,
                       dtype=np.float64)
        )
        run64 = jax.jit(lambda l, n: inf.pdfposteriors(cf64, l, n))
        jax.block_until_ready(run64(lhs_t, lengths))
        t0 = time.perf_counter()
        jax.block_until_ready(run64(lhs_t, lengths))
        t_64 = time.perf_counter() - t0
        print(
            f"# 2m f64 (dtype=float64, XLA block path): N={N} B=2 "
            f"|dlogZ| = {err64:.3e} vs the exact host oracle — BASELINE "
            f"'allclose atol 1e-4' met on the device; full B={B} fwd-bwd "
            f"{t_64:.2f} s -> {audio_s / t_64:.0f} audio-s/s "
            f"({t_64 / t_2m:.0f}x the f32 path)",
            file=sys.stderr,
        )
    finally:
        jax.config.update("jax_enable_x64", False)

if __name__ == "__main__":
    main()
