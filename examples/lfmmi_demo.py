"""End-to-end LF-MMI scoring demo (the reference's examples/test_cuda.jl
usage): build a tiny denominator LM ∘ HMM graph and per-utterance
numerator graphs on the host, compile them for the device, then score a
ragged batch — posteriors, differentiable LF-MMI loss, Viterbi decode — and
run the same denominator state-sharded over a device mesh.

Runs on any backend (CPU included):  python examples/lfmmi_demo.py
"""
import numpy as np

import jax
import jax.numpy as jnp

import markovmodels_tpu as mm
from markovmodels_tpu import inference as inf
from markovmodels_tpu import viterbi as vit
from markovmodels_tpu.labels import Label
from markovmodels_tpu.lmfsm import language_model_fsm, totalngramsum
from markovmodels_tpu import fsmops


def hmm(unit: str, pdfs, self_p=0.5):
    """Left-to-right HMM for one unit: one state per pdf."""
    n = len(pdfs)
    arcs = [((i, i), np.log(self_p)) for i in range(n)] + [
        ((i, i + 1), np.log(1 - self_p)) for i in range(n - 1)
    ]
    return mm.FSM.from_pairs(
        [(0, 0.0)], arcs, [(n - 1, np.log(1 - self_p))],
        [Label(int(p)) for p in pdfs], mm.LOG,
    )


def main():
    rng = np.random.default_rng(0)

    # ---- 1. host graph build (the reference's G∘L∘H pipeline in miniature)
    units = ["a", "b", "c"]
    hmms = {u: hmm(u, [2 * i, 2 * i + 1]) for i, u in enumerate(units)}
    num_pdfs = 2 * len(units)

    # "training transcripts" -> bigram phonotactic LM -> denominator graph
    transcripts = [["a", "b", "a", "c"], ["b", "c", "a"], ["a", "c", "c"]]
    sr = mm.LOG
    ngrams = {}
    from markovmodels_tpu.lmfsm import merge_ngrams
    from markovmodels_tpu.fsmops import compose

    for words in transcripts:
        g = mm.FSM.from_pairs(
            [(0, 0.0)],
            [((i, i + 1), 0.0) for i in range(len(words) - 1)],
            [(len(words) - 1, 0.0)],
            [Label(w) for w in words], sr,
        )
        ngrams = merge_ngrams(ngrams, totalngramsum(g, order=2), sr)
    lm = language_model_fsm(ngrams, sr)  # bigram LM over units
    den_fsm = compose(lm, {Label(u): hmms[u] for u in units})
    den_spdf = np.array(
        [lab[-1] for lab in den_fsm.labels] + [num_pdfs], dtype=np.int32
    )

    # per-utterance numerator graphs: transcript ∘ HMMs
    num_cfs, texts = [], [["a", "b"], ["c", "a", "b"]]
    for words in texts:
        g = mm.FSM.from_pairs(
            [(0, 0.0)],
            [((i, i + 1), 0.0) for i in range(len(words) - 1)],
            [(len(words) - 1, 0.0)],
            [Label(w) for w in words], sr,
        )
        f = compose(g, {Label(u): hmms[u] for u in units})
        spdf = np.array(
            [lab[-1] for lab in f.labels] + [num_pdfs], dtype=np.int32
        )
        # linear lattices compile to the 'banded' strategy: the stacked
        # batch (one sequence per graph) then runs as ONE scan over all
        # graphs — the Triton kernel of ops/pallas_banded.py on the GPU
        num_cfs.append(inf.compile_fsm(f, spdf, num_pdfs, strategy="banded"))

    # ---- 2. compile + score on the device
    den = inf.compile_fsm(den_fsm, den_spdf, num_pdfs, strategy="dense")
    B, N = 2, 16
    lhs = jnp.asarray(rng.normal(size=(B, N, num_pdfs)).astype(np.float32))
    lengths = jnp.asarray([16, 11], dtype=jnp.int32)

    posts, logZ = inf.pdfposteriors(den, lhs, lengths)
    print("denominator logZ:", np.asarray(logZ))
    print("posteriors sum to 1 per frame:",
          np.allclose(np.asarray(posts[0].sum(-1))[: 16], 1.0, atol=1e-5))

    # differentiable LF-MMI loss (gradient = posterior difference)
    num = inf.stack(num_cfs)
    loss, grad = jax.value_and_grad(
        lambda x: inf.lfmmi_loss(num, den, x, lengths).mean()
    )(lhs)
    print("lfmmi loss:", float(loss), "| grad shape:", grad.shape)

    # Viterbi decode (the reference's disabled bestpath, first-class here)
    states, score = vit.viterbi(den, lhs, lengths)
    print("best-path score:", np.asarray(score))
    print("decoded pdf sequence (utt 0):",
          np.asarray(den.state_pdf)[np.asarray(states[0, :8])])

    # ---- 3. the same denominator state-sharded over a mesh
    n_dev = len(jax.devices())
    if n_dev > 1:
        from markovmodels_tpu.parallel import make_mesh
        from markovmodels_tpu.parallel.sharded import (
            halo_report, shard_compiled_prob, sharded_pdfposteriors_prob,
        )

        mesh = make_mesh({"model": n_dev})
        sf = shard_compiled_prob(den_fsm, den_spdf, num_pdfs,
                                 num_shards=n_dev)
        print("halo plan:", halo_report(sf))
        sposts, slogZ = sharded_pdfposteriors_prob(
            sf, lhs, lengths, mesh=mesh, data_axis=None
        )
        print("sharded logZ matches:",
              np.allclose(np.asarray(slogZ), np.asarray(logZ), atol=1e-4))


if __name__ == "__main__":
    main()
