"""Smoke run of the LF-MMI engine on an NVIDIA GPU, at the headline widths.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the multi-card phases only

One card, through the public entry points (``compile_fsm`` →
``pdfposteriors`` / ``lfmmi_loss`` / ``viterbi``), emissions 0.5·N(0,1)
from fixed seeds:

1. device check: JAX must find a GPU, else the script exits non-zero;
2. the 2M-arc LM∘HMM denominator (49,153 states, 384 pdfs), block strategy:
   parity of every precision mode against the float64 host oracle at
   N=40, B=2 (the default must hold |ΔlogZ| and |Δposts| < 1e-4), and its
   B=128, N=700 forward-backward time;
3. the WSJ-sized dense graph (3,073 states, 96 pdfs): the same gate and time;
4. the LF-MMI training step (128 stacked banded numerators + the 2M
   denominator, value and gradient): finite loss and gradient, numerator
   logZ against the host oracle, the Triton numerator kernel against the
   XLA stacked scan, and the step time through each numerator route;
5. Viterbi on the 2M graph at B=128, N=700 (uint8 backpointers), with two
   decoded paths walked in float64 against the device score.

Four cards: the training step data-parallel over the cards (4 × B=128,
denominator replicated) against the same step on one card for one shard,
and the state-sharded 2M denominator against the one-card logZ.

Every result line carries the card's name and power limit.  The last line
is one JSON object: {"ok": true, "device": {...}}.  Any failed check raises.
"""
import argparse
import dataclasses
from contextlib import nullcontext
import json
import subprocess
import sys
import time

import numpy as np

B, N = 128, 700
FRAME_S = 0.03  # 30 ms frames
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Report:
    def __init__(self, card):
        self.card = card

    def __call__(self, msg):
        print(f"[{self.card}] {msg}", flush=True)


def timed(fn, *args, reps=3):
    """Warm wall times of ``fn(*args)`` (already compiled), each ending in
    block_until_ready.  Returns (times, last output)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return ts, out


def fmt_times(ts, batch=None, frames=None):
    batch, frames = batch or B, frames or N
    med = float(np.median(ts))
    return (f"{med:.4f} s median of {', '.join(f'{t:.4f}' for t in ts)} "
            f"-> {batch * frames * FRAME_S / med:.0f} audio-s/s")


def compiled_step(fn, *args):
    """(compiled executable, compile seconds, memory analysis line)."""
    import jax

    t0 = time.perf_counter()
    comp = jax.jit(fn).lower(*args).compile()
    dt = time.perf_counter() - t0
    ma = comp.memory_analysis()
    mem = "memory_analysis n/a"
    if ma is not None:
        mem = (f"args {ma.argument_size_in_bytes / 2**30:.2f} GiB, "
               f"out {ma.output_size_in_bytes / 2**30:.2f} GiB, "
               f"temp {ma.temp_size_in_bytes / 2**30:.2f} GiB")
    return comp, dt, mem


def peak_line(dev):
    stats = dev.memory_stats() or {}
    return f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB"


def emissions(rng, batch, frames, P):
    import jax.numpy as jnp

    return jnp.asarray(
        (rng.normal(size=(batch, frames, P)) * 0.5).astype(np.float32)
    )


def parity(inf, bench, fsm, spdf, P, cf, n=40):
    """(|ΔlogZ|, |Δposts|) against the float64 host oracle, B=2 with one
    ragged length."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, 2 * n // 3], dtype=np.int32)
    ref_z, ref_p = bench.host_oracle(fsm, spdf, P, lhs.astype(np.float64),
                                     lens)
    got_p, got_z = inf.pdfposteriors(cf, jnp.asarray(lhs), jnp.asarray(lens))
    return (float(np.max(np.abs(np.asarray(got_z) - ref_z))),
            float(np.max(np.abs(np.asarray(got_p) - ref_p))))


def numerators(inf, rng, count, P):
    """``count`` linear numerator lattices (78 states, self + chain arcs,
    ~9 frames per 3-state phone at N=700), stacked for the banded kernel.
    Returns (stacked CompiledFSM, host FSMs, state->pdf maps)."""
    import markovmodels_tpu as mm
    from markovmodels_tpu.fsm import FSM
    from markovmodels_tpu.labels import Label

    Lp = 78
    arcs = [((i, i), np.log(0.5)) for i in range(Lp)] + [
        ((i, i + 1), np.log(0.5)) for i in range(Lp - 1)
    ]
    cfs, fsms, spdfs = [], [], []
    for _ in range(count):
        seq = rng.integers(0, P, size=Lp)
        f = FSM.from_pairs([(0, 0.0)], arcs, [(Lp - 1, np.log(0.5))],
                           [Label(int(s)) for s in seq], mm.LOG)
        spdf = np.append(seq, P).astype(np.int32)
        cfs.append(inf.compile_fsm(f, spdf, P, strategy="banded"))
        fsms.append(f)
        spdfs.append(spdf)
    return inf.stack(cfs), fsms, spdfs


class xla_numerators:
    """Route stacked numerators through the XLA stacked scan instead of
    the Triton kernel, to time the same step both ways."""

    def __init__(self, inf):
        self.inf = inf

    def __enter__(self):
        self.saved = self.inf._banded_kernel_reason
        self.inf._banded_kernel_reason = lambda cf, b: "XLA route for comparison"

    def __exit__(self, *exc):
        self.inf._banded_kernel_reason = self.saved


def denominator_phase(say, dev, inf, bench, fsm, spdf, P, info, strategy,
                      modes, rng):
    import jax.numpy as jnp

    t0 = time.perf_counter()
    cf = inf.compile_fsm(fsm, spdf, P, strategy=strategy)
    say(f"{info['states']} states, {info['arcs']} arcs, {P} pdfs: "
        f"compile_fsm({strategy!r}) {time.perf_counter() - t0:.2f} s; "
        f"route: {inf.fast_path_report(cf, B)}")
    lhs = emissions(rng, B, N, P)
    lengths = jnp.full((B,), N, dtype=jnp.int32)
    for mode in modes:
        cfm = dataclasses.replace(cf, precision=mode)
        err, perr = parity(inf, bench, fsm, spdf, P, cfm)
        comp, t_comp, mem = compiled_step(
            lambda l, n, c=cfm: inf.pdfposteriors(c, l, n), lhs, lengths
        )
        ts, (posts, logz) = timed(comp, lhs, lengths)
        if not (np.isfinite(np.asarray(logz)).all()
                and np.isfinite(np.asarray(posts)).all()):
            raise AssertionError(f"non-finite output in mode {mode!r}")
        say(f"precision={mode!r}: parity N=40 B=2 |dlogZ| = {err:.3e}, "
            f"|dposts| = {perr:.3e}; B={B} N={N} fwd-bwd {fmt_times(ts)}; "
            f"compile {t_comp:.1f} s; {mem}; {peak_line(dev)}")
        if mode == cf.precision and not (err < 1e-4 and perr < 1e-4):
            raise AssertionError(
                f"default precision {mode!r} failed the 1e-4 gate: "
                f"{err:.3e} / {perr:.3e}")
    return cf, lhs, lengths


def e2e_phase(say, dev, inf, bench, den_cf, lhs, lengths, P, rng):
    import jax

    num_cf, fsms, spdfs = numerators(inf, rng, B, P)
    say(f"numerators: {B} stacked banded graphs, route: "
        f"{inf.fast_path_report(num_cf, B)}")
    if inf._banded_kernel_reason(num_cf, B) is not None:
        raise AssertionError("stacked numerators did not take the kernel")

    # numerator pass alone: Triton kernel vs the XLA stacked scan
    run_k = jax.jit(lambda l, n: inf.pdfposteriors(num_cf, l, n))
    ts_k, (p_k, z_k) = timed(run_k, lhs, lengths)
    with xla_numerators(inf):
        run_x = jax.jit(lambda l, n: inf.pdfposteriors(num_cf, l, n))
        ts_x, (p_x, z_x) = timed(run_x, lhs, lengths)
    z_k, z_x = np.asarray(z_k), np.asarray(z_x)
    fin = np.isfinite(z_x)
    if not (np.isfinite(z_k) == fin).all():
        raise AssertionError("kernel and XLA disagree on feasible graphs")
    dz = float(np.max(np.abs(z_k - z_x)[fin], initial=0.0))
    dp = float(np.max(np.abs(np.asarray(p_k) - np.asarray(p_x))))
    say(f"numerator pass G={B} N={N} (f32 log domain, both routes): "
        f"kernel {fmt_times(ts_k)}; XLA {fmt_times(ts_x)}; "
        f"kernel vs XLA |dlogZ| = {dz:.3e} (tol 1e-3), "
        f"|dposts| = {dp:.3e} (tol 1e-4)")
    if not (dz < 1e-3 and dp < 1e-4):
        raise AssertionError("banded kernel disagrees with the XLA scan")
    lhs_np = np.asarray(lhs, dtype=np.float64)
    for g in range(3):
        ref, _ = bench.host_oracle(fsms[g], spdfs[g], P, lhs_np[g:g + 1],
                                   np.array([N]))
        d = abs(float(z_k[g]) - float(ref[0]))
        say(f"numerator {g}: logZ {float(z_k[g]):.4f} vs f64 oracle "
            f"{float(ref[0]):.4f}, |d| = {d:.3e} (tol 2e-3)")
        # f32 log-domain accumulation over 700 frames: ~1e-6 of |logZ|
        if not d < 2e-3:
            raise AssertionError("numerator logZ off the host oracle")

    def step(l):
        return inf.lfmmi_loss(num_cf, den_cf, l, lengths).sum()

    results = {}
    for route in ("kernel", "xla"):
        ctx = xla_numerators(inf) if route == "xla" else nullcontext()
        with ctx:
            comp, t_comp, mem = compiled_step(jax.value_and_grad(step), lhs)
            ts, (loss, grad) = timed(comp, lhs)
        loss, grad = float(loss), np.asarray(grad)
        if not (np.isfinite(loss) and np.isfinite(grad).all()):
            raise AssertionError(f"non-finite LF-MMI loss/grad ({route})")
        results[route] = (loss, grad)
        say(f"e2e LF-MMI step (num {route} + 2M den, value+grad, B={B} "
            f"N={N}): loss {loss:.3f}; {fmt_times(ts)}; compile "
            f"{t_comp:.1f} s; {mem}; {peak_line(dev)}")
    gdiff = float(np.max(np.abs(results["kernel"][1] - results["xla"][1])))
    say(f"e2e gradient, kernel vs XLA numerator route: max |d| = {gdiff:.3e}")
    if not gdiff < 1e-4:
        raise AssertionError("e2e gradient differs between numerator routes")


def viterbi_phase(say, dev, vit, bench, fsm, spdf, cf, lhs, lengths):
    reason = vit._bp_vit_reject_reason(cf, lhs)
    if reason is not None:
        raise AssertionError(f"uint8-backpointer decode rejected: {reason}")
    comp, t_comp, mem = compiled_step(
        lambda l, n: vit.viterbi(cf, l, n), lhs, lengths
    )
    ts, (states, score) = timed(comp, lhs, lengths)
    states, score = np.asarray(states), np.asarray(score)
    gap = bench._validate_paths_full(
        fsm, spdf, np.asarray(lhs)[:2], np.asarray(lengths)[:2],
        states[:2], score[:2],
    )
    say(f"viterbi 2M B={B} N={N} (uint8 backpointers): {fmt_times(ts)}; "
        f"2 paths walked in f64, max |path weight - device score| = "
        f"{gap:.3e} (tol 2e-3); compile {t_comp:.1f} s; {mem}; "
        f"{peak_line(dev)}")


def one_card(say, dev):
    import bench
    from markovmodels_tpu import inference as inf
    from markovmodels_tpu import viterbi as vit
    from markovmodels_tpu.workloads import make_lm_hmm_graph

    rng = np.random.default_rng(SEED)
    fsm, spdf, P, info = make_lm_hmm_graph(V=128)
    cf, lhs, lengths = denominator_phase(
        say, dev, inf, bench, fsm, spdf, P, info, "block",
        ("high", "f32", "bf16"), rng,
    )
    fsm_d, spdf_d, P_d, info_d = make_lm_hmm_graph(V=32)
    denominator_phase(say, dev, inf, bench, fsm_d, spdf_d, P_d, info_d,
                      "dense", ("high",), rng)
    e2e_phase(say, dev, inf, bench, cf, lhs, lengths, P, rng)
    viterbi_phase(say, dev, vit, bench, fsm, spdf, cf, lhs, lengths)


def four_cards(say, devs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as Ps

    from markovmodels_tpu import inference as inf
    from markovmodels_tpu.parallel.sharded import (
        lm_hmm_assignment,
        shard_compiled_prob,
        sharded_logmarginal_prob,
    )
    from markovmodels_tpu.workloads import make_lm_hmm_graph

    nd = len(devs)
    if nd != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {nd}")
    rng = np.random.default_rng(SEED)
    fsm, spdf, P, info = make_lm_hmm_graph(V=128)
    den_cf = inf.compile_fsm(fsm, spdf, P, strategy="block")
    num_cf, _, _ = numerators(inf, rng, nd * B, P)
    lhs = emissions(rng, nd * B, N, P)
    lengths = jnp.full((nd * B,), N, dtype=jnp.int32)

    def local_step(num_l, lhs_l, len_l):
        loss, grad = jax.value_and_grad(
            lambda l: inf.lfmmi_loss(num_l, den_cf, l, len_l).sum()
        )(lhs_l)
        return loss[None], grad

    # data parallel: utterances and their numerators split over the cards,
    # the denominator replicated
    mesh = Mesh(np.array(devs), ("data",))
    num_spec = jax.tree.map(lambda _: Ps("data"), num_cf)
    dp_step = jax.jit(jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(num_spec, Ps("data"), Ps("data")),
        out_specs=(Ps("data"), Ps("data")),
        check_vma=False,  # the Triton kernel's outputs carry no vma
    ))
    t0 = time.perf_counter()
    jax.block_until_ready(dp_step(num_cf, lhs, lengths))
    say(f"data-parallel step compiled + first run in "
        f"{time.perf_counter() - t0:.1f} s")
    ts_dp, (loss_dp, grad_dp) = timed(dp_step, num_cf, lhs, lengths)

    shard0 = jax.tree.map(lambda x: x[:B], num_cf)
    one = jax.jit(local_step)
    ts_1, (loss_1, grad_1) = timed(one, shard0, lhs[:B], lengths[:B])
    dl = abs(float(loss_dp[0]) - float(loss_1[0]))
    dg = float(np.max(np.abs(np.asarray(grad_dp[:B]) - np.asarray(grad_1))))
    say(f"e2e LF-MMI step data-parallel over {nd} cards ({nd} x B={B}, "
        f"N={N}): {fmt_times(ts_dp, batch=nd * B)}; one card, one shard "
        f"(B={B}): {fmt_times(ts_1)}; shard 0 |dloss| = {dl:.3e}, "
        f"max |dgrad| = {dg:.3e}")
    if not (np.isfinite(np.asarray(loss_dp)).all() and dl < 1e-2
            and dg < 1e-4):
        raise AssertionError("data-parallel step disagrees with one card")

    # state-sharded 2M denominator over the same cards
    Bs, Ns = 8, N
    sf = shard_compiled_prob(fsm, spdf, P, num_shards=nd,
                             shard_of=lm_hmm_assignment(128, 3, nd))
    mesh_m = Mesh(np.array(devs), ("model",))
    lhs_s = lhs[:Bs, :Ns]
    len_s = lengths[:Bs]
    run_sh = jax.jit(lambda l, n: sharded_logmarginal_prob(
        sf, l, n, mesh=mesh_m, data_axis=None))
    ts_sh, z_sh = timed(run_sh, lhs_s, len_s)
    run_1 = jax.jit(lambda l, n: inf.forward(den_cf, l, n))
    ts_z1, z_1 = timed(run_1, lhs_s, len_s)
    dz = float(np.max(np.abs(np.asarray(z_sh) - np.asarray(z_1))))
    say(f"state-sharded 2M denominator over {nd} cards (B={Bs}, N={Ns}): "
        f"logZ {fmt_times(ts_sh, batch=Bs, frames=Ns)} vs one card "
        f"{fmt_times(ts_z1, batch=Bs, frames=Ns)}; max |dlogZ| = {dz:.3e}")
    if not dz < 1e-3:
        raise AssertionError("state-sharded logZ disagrees with one card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phases")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1

    from markovmodels_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    print(f"card: {card}", flush=True)
    say = Report(card)
    say(f"JAX {jax.__version__}, {len(devs)} x {dev.device_kind}")
    if args.four_cards:
        four_cards(say, devs)
    else:
        one_card(say, dev)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
