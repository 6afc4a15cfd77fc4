"""The stacked-banded numerator kernel (ops/pallas_banded.py).

On the CPU the kernel runs in the Pallas interpreter, which a test asks for
explicitly (``interpret=True``); the dispatcher itself takes the XLA
stacked scan here.  The compiled kernel is checked by the ``gpu`` test."""
import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp

import markovmodels_tpu as mm
from markovmodels_tpu import inference as inf
from markovmodels_tpu.fsm import FSM
from markovmodels_tpu.labels import Label
from markovmodels_tpu.ops import pallas_banded as pband

_spec = importlib.util.spec_from_file_location(
    "benchmod", os.path.join(os.path.dirname(__file__), "..", "bench.py")
)
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)


def numerators(rng, G, P, sizes):
    """G linear lattices (self-loop + chain arcs, 0.5 each) whose state
    counts cycle through ``sizes``.  Returns (stack, host FSMs, maps)."""
    cfs, fsms, spdfs = [], [], []
    for g in range(G):
        Lp = sizes[g % len(sizes)]
        seq = rng.integers(0, P, size=Lp)
        arcs = [((i, i), np.log(0.5)) for i in range(Lp)] + [
            ((i, i + 1), np.log(0.5)) for i in range(Lp - 1)
        ]
        f = FSM.from_pairs([(0, 0.0)], arcs, [(Lp - 1, np.log(0.5))],
                           [Label(int(s)) for s in seq], mm.LOG)
        spdf = np.append(seq, P).astype(np.int32)
        cfs.append(inf.compile_fsm(f, spdf, P, strategy="banded"))
        fsms.append(f)
        spdfs.append(spdf)
    return inf.stack(cfs), fsms, spdfs


def oracle(fsms, spdfs, P, lhs, lens):
    zs, ps = [], []
    for g, (f, spdf) in enumerate(zip(fsms, spdfs)):
        z, p = bench.host_oracle(f, spdf, P, np.asarray(lhs, np.float64)[g:g + 1],
                                 np.asarray(lens)[g:g + 1])
        zs.append(z[0])
        ps.append(p[0])
    return np.array(zs), np.stack(ps)


def test_kernel_matches_f64_oracle_ragged():
    """Ragged lengths, including a lattice too long to finish in its
    frames (logZ = -inf, posteriors all zero)."""
    rng = np.random.default_rng(5)
    P, N = 12, 14
    nb, fsms, spdfs = numerators(rng, 6, P, (4, 7, 9))
    lhs = rng.normal(size=(6, N, P)).astype(np.float32)
    lens = np.array([14, 9, 6, 12, 14, 11], np.int32)  # 6 < 9 states
    p, z = pband.banded_fb(nb, jnp.asarray(lhs), jnp.asarray(lens), True,
                           interpret=True)
    ref_z, ref_p = oracle(fsms, spdfs, P, lhs, lens)
    z, p = np.asarray(z), np.asarray(p)
    fin = np.isfinite(ref_z)
    assert not fin[2] and (np.isfinite(z) == fin).all()
    np.testing.assert_allclose(z[fin], ref_z[fin], atol=1e-4)
    np.testing.assert_allclose(p, ref_p, atol=1e-5)
    for g, L in enumerate(lens):
        assert np.all(p[g, L:] == 0.0)


@pytest.mark.parametrize("route", ["kernel", "xla"])
def test_long_lattice_keeps_the_aligned_mass(route):
    """A 40-state lattice over 300 frames: the forward filter's prior runs
    ~t/2 states ahead of the ~t/7.5 the lattice must keep, so the states
    that carry the posterior fall more than f32's ~87 nats below the frame
    maximum.  Both routes run in the log domain and must keep them."""
    rng = np.random.default_rng(2)
    P, N = 16, 300
    nb, fsms, spdfs = numerators(rng, 2, P, (40,))
    lhs = (rng.normal(size=(2, N, P)) * 0.5).astype(np.float32)
    lens = np.array([N, N - 20], np.int32)
    if route == "kernel":
        p, z = pband.banded_fb(nb, jnp.asarray(lhs), jnp.asarray(lens), True,
                               interpret=True)
    else:
        p, z = inf.pdfposteriors(nb, jnp.asarray(lhs), jnp.asarray(lens))
    ref_z, ref_p = oracle(fsms, spdfs, P, lhs, lens)
    np.testing.assert_allclose(np.asarray(z), ref_z, atol=1e-3)
    np.testing.assert_allclose(np.asarray(p), ref_p, atol=1e-4)


def test_graph_count_not_a_multiple_of_the_tile(monkeypatch):
    """Five graphs at four per program: the wrapper pads the graph axis
    to 8 and trims every output."""
    monkeypatch.setattr(pband, "graph_tile", lambda G: 4)
    rng = np.random.default_rng(8)
    P, N = 10, 9
    nb, _, _ = numerators(rng, 5, P, (3, 5))
    lhs = jnp.asarray(rng.normal(size=(5, N, P)).astype(np.float32))
    lens = jnp.asarray([9, 7, 9, 8, 6], jnp.int32)
    p1, z1 = pband.banded_fb(nb, lhs, lens, True, interpret=True)
    p0, z0 = inf.pdfposteriors(nb, lhs, lens)
    assert p1.shape == (5, N, P) and z1.shape == (5,)
    np.testing.assert_allclose(np.asarray(z1), np.asarray(z0), atol=1e-5)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p0), atol=1e-5)


def test_kernel_forward_only():
    rng = np.random.default_rng(4)
    P, N = 10, 11
    nb, _, _ = numerators(rng, 3, P, (4, 6))
    lhs = jnp.asarray(rng.normal(size=(3, N, P)).astype(np.float32))
    lens = jnp.asarray([11, 8, 10], jnp.int32)
    posts, z1 = pband.banded_fb(nb, lhs, lens, False, interpret=True)
    assert posts is None
    np.testing.assert_allclose(np.asarray(z1),
                               np.asarray(inf.forward(nb, lhs, lens)),
                               atol=1e-5)


@pytest.mark.parametrize("G,tile", [
    (1, 1), (128, 1), (254, 1), (256, 2), (1024, 8), (100_000, 8),
])
def test_graph_tile(G, tile):
    """One graph per program until the grid holds 128 programs or more."""
    assert pband.graph_tile(G) == tile


def test_route_choice():
    """On the CPU the dispatcher takes the XLA stacked scan and says why;
    the kernel's own predicates name what it cannot take."""
    rng = np.random.default_rng(1)
    nb, _, _ = numerators(rng, 4, 6, (3,))
    assert pband.banded_kernel_reject_reason(nb, 4) is None
    assert "backend 'cpu'" in inf._banded_kernel_reason(nb, 4)
    assert inf.fast_path_report(nb, 4).startswith("xla stacked banded scan")
    # a batch that is not one sequence per graph takes the vmapped scan
    assert "batch 3 != graph count 4" in pband.banded_kernel_reject_reason(
        nb, 3)
    assert inf.fast_path_report(nb, 3).startswith("xla vmapped per-graph")
    big, _, _ = numerators(rng, 2, 6, (2100,))
    assert "exceed" in pband.banded_kernel_reject_reason(big, 2)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu):
    """The compiled kernel against the XLA stacked scan on the card."""
    rng = np.random.default_rng(3)
    P, N = 24, 200
    nb, _, _ = numerators(rng, 128, P, (20, 35, 50))
    lhs = jnp.asarray(rng.normal(size=(128, N, P)).astype(np.float32))
    lens = jnp.asarray(rng.integers(150, N + 1, size=128).astype(np.int32))
    p1, z1 = pband.banded_fb(nb, lhs, lens, True)
    inf_reason = inf._banded_kernel_reason
    try:
        inf._banded_kernel_reason = lambda cf, b: "XLA route for comparison"
        p0, z0 = inf.pdfposteriors(nb, lhs, lens)
    finally:
        inf._banded_kernel_reason = inf_reason
    np.testing.assert_allclose(np.asarray(z1), np.asarray(z0), atol=1e-3)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p0), atol=1e-4)
