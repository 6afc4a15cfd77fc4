"""The XLA block route (blocked gather-matmul-scatter scan) on the 2M-arc
LM∘HMM graph against the exact float64 host oracle (bench.host_oracle).

This is the route every denominator takes on the GPU.  Frame counts stay
tiny so the oracle's per-frame scipy matvecs over 2M arcs stay cheap."""
import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from markovmodels_tpu import inference as inf
from markovmodels_tpu.ops import semiring_ops as sops
from markovmodels_tpu.workloads import make_lm_hmm_graph

_spec = importlib.util.spec_from_file_location(
    "benchmod", os.path.join(os.path.dirname(__file__), "..", "bench.py")
)
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)


@pytest.fixture(scope="module")
def graph():
    fsm, spdf, P, _ = make_lm_hmm_graph(V=128)
    return fsm, spdf, P, inf.compile_fsm(fsm, spdf, P, strategy="block")


def _check(graph, cf, lhs, lens, chunk_size=None, atol=1e-4):
    fsm, spdf, P, _ = graph
    ref_z, ref_p = bench.host_oracle(
        fsm, spdf, P, np.asarray(lhs, np.float64), np.asarray(lens)
    )
    p, z = inf.pdfposteriors(cf, jnp.asarray(lhs), jnp.asarray(lens),
                             chunk_size=chunk_size)
    z, p = np.asarray(z), np.asarray(p)
    fin = np.isfinite(ref_z)
    assert (np.isfinite(z) == fin).all()
    np.testing.assert_allclose(z[fin], ref_z[fin], atol=atol)
    np.testing.assert_allclose(p, ref_p, atol=atol)
    for b, L in enumerate(np.asarray(lens)):
        assert np.all(p[b, int(L):] == 0.0)


def test_block_partial_batch(graph):
    """An odd batch with ragged lengths, including an infeasible L=1
    (logZ = -inf: the 3-state HMMs need more frames)."""
    P = graph[2]
    rng = np.random.default_rng(3)
    lhs = (rng.normal(size=(5, 3, P)) * 0.5).astype(np.float32)
    _check(graph, graph[3], lhs, np.array([3, 2, 3, 1, 2], np.int32))


def test_block_tail_pad_frames(graph):
    """Chunk-checkpointed path with Npad != N+1: the last chunk is mostly
    pad frames, and lengths end inside the pad region."""
    P = graph[2]
    rng = np.random.default_rng(21)
    lhs = (rng.normal(size=(4, 5, P)) * 0.5).astype(np.float32)
    _check(graph, graph[3], lhs, np.array([5, 4, 2, 3], np.int32),
           chunk_size=4)


def test_block_forward_only(graph):
    fsm, spdf, P, cf = graph
    rng = np.random.default_rng(9)
    lhs = (rng.normal(size=(3, 4, P)) * 0.5).astype(np.float32)
    lens = np.array([4, 3, 4], np.int32)
    ref_z = bench.host_oracle_logZ(fsm, spdf, P, lhs.astype(np.float64),
                                   lens)
    z = inf.forward(cf, jnp.asarray(lhs), jnp.asarray(lens), chunk_size=2)
    np.testing.assert_allclose(np.asarray(z), ref_z, atol=1e-4)


def test_rescale_guard_survives_emission_cliffs(graph):
    """+60-nat spikes on pdfs of states unreachable for two frames: the
    per-frame power-of-two rescale must keep the carried f32 state from
    underflowing to zero (logZ = -inf)."""
    P = graph[2]
    lhs = np.zeros((2, 6, P), dtype=np.float32)
    k2 = np.arange(P).reshape(-1, 3)[:, 2]  # pdfs of HMM state 2
    lhs[:, :2, k2] = 60.0
    _check(graph, graph[3], lhs, np.array([6, 5], np.int32), chunk_size=4)


def test_lfmmi_grad_jits_through_block(graph):
    """jit(value_and_grad(lfmmi_loss)) with a block denominator: the
    gradient is gamma_den - gamma_num, and logmarginal's stop_gradient keeps
    the integer fields concrete under tracing."""
    from markovmodels_tpu.fsm import FSM
    from markovmodels_tpu.labels import Label
    from markovmodels_tpu.semiring import LOG

    _, _, P, cf = graph
    B = 2
    rng = np.random.default_rng(5)
    lhs = jnp.asarray(rng.normal(size=(B, 3, P)).astype(np.float32) * 0.5)
    lens = jnp.asarray([3, 3], dtype=jnp.int32)
    num_cfs = []
    for _ in range(B):
        seq = rng.integers(0, P, size=2)
        arcs = [((0, 0), np.log(0.5)), ((1, 1), np.log(0.5)),
                ((0, 1), np.log(0.5))]
        f = FSM.from_pairs([(0, 0.0)], arcs, [(1, np.log(0.5))],
                           [Label(int(s)) for s in seq], LOG)
        num_cfs.append(inf.compile_fsm(
            f, np.append(seq, P).astype(np.int32), P, strategy="dense"))
    num_cf = inf.stack(num_cfs)
    run = jax.jit(jax.value_and_grad(
        lambda l: inf.lfmmi_loss(num_cf, cf, l, lens).sum()
    ))
    loss, grad = run(lhs)
    assert np.isfinite(float(loss))
    pd, _ = inf.pdfposteriors(cf, lhs, lens)
    pn, _ = inf.pdfposteriors(num_cf, lhs, lens)
    np.testing.assert_allclose(
        np.asarray(grad), np.asarray(pd) - np.asarray(pn), atol=1e-5
    )


@pytest.mark.parametrize("mode,atol", [
    ("f32", 1e-4),
    ("high", 1e-4),
    # bf16 operands keep ~3 significant digits per product on a GPU (the
    # 2M graph measured 4e-4 at N=40 on an H100); the CPU runs every mode
    # at f32, so here the bound only documents the mode's contract
    ("bf16", 2e-2),
])
def test_precision_modes(graph, mode, atol):
    import dataclasses

    P = graph[2]
    cfm = dataclasses.replace(graph[3], precision=mode)
    rng = np.random.default_rng(7)
    lhs = rng.normal(size=(2, 4, P)).astype(np.float32)
    _check(graph, cfm, lhs, np.array([4, 3], np.int32), atol=atol)


def test_dot_precision_table():
    """On the GPU 'f32' is true fp32 (no TF32) and the two faster modes are
    dot algorithms over f32 operands; on the CPU backend, and for f64
    operands anywhere, every mode is full precision."""
    hi = jax.lax.Precision.HIGHEST
    assert sops._PRECISIONS == {
        "bf16": jax.lax.DotAlgorithmPreset.BF16_BF16_F32,
        "high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
        "f32": hi,
    }
    assert jax.default_backend() == "cpu"
    for mode in ("f32", "high", "bf16"):
        assert sops.dot_precision(mode, jnp.float32) == hi
        assert sops.dot_precision(mode, jnp.float64) == hi
