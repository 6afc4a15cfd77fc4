"""LF-MMI supervision-graph preparation job.

Analog of the reference's TOML-config-driven batch pipeline
(reference examples/prepare-lfmmi-graphs.jl:102-224): per-utterance numerator
graphs ``G ∘ L ∘ H`` serialized to disk with .scp manifests, n-gram stats
accumulated in parallel (python multiprocessing instead of Julia Distributed,
with the same associative ⊕-merge reduction), then the denominator graph
``LanguageModelFSM(ngrams) ∘ H``.

Run:  python -m markovmodels_tpu.pipeline.prepare_lfmmi_graphs config.toml
Config sections match the reference (data: units/lexicon/traintext/devtext;
supervision: topo/folder/silprobs/ngram_order).

Restartability (reference examples/prepare-lfmmi-graphs.jl:122-132 keeps
per-utterance artifacts; this pipeline goes further): every utterance's
graph, state map AND n-gram stats are serialized individually, so a re-run
skips finished utterances entirely (loading only their cached stats) and
rewrites complete manifests at the end.  Progress is logged to stderr
(the reference uses @info + ProgressMeter).
"""
from __future__ import annotations

import json
import logging
import multiprocessing as mp
import os
import pickle
import sys
import time

import numpy as np

from .. import fsmops
from ..fsm import FSM, to_json
from ..labels import Label
from ..lmfsm import language_model_fsm, merge_ngrams, totalngramsum
from ..semiring import LOG
from .graphs import LinearFSM, make_hmms, make_lexicon, statemap

__all__ = ["make_numerator_graphs", "run_pipeline", "main"]

_WORKER_CTX = {}


def _init_worker(lexicon, hmms, numpdf, folder, silcfg, ngram_order):
    _WORKER_CTX.update(
        lexicon=lexicon,
        hmms=hmms,
        numpdf=numpdf,
        folder=folder,
        silcfg=silcfg,
        ngram_order=ngram_order,
    )


def _process_utterance(line: str):
    """Build and serialize one utterance's numerator graph; return
    (uttid, fsm_path, smap_path, ngram stats, skipped).  A re-run skips
    utterances whose three artifacts already exist, loading the cached
    n-gram stats."""
    c = _WORKER_CTX
    tokens = line.split()
    if len(tokens) < 2:
        return None
    uttid, seq = tokens[0], tokens[1:]
    fsm_path = os.path.join(c["folder"], uttid + ".fsm.json")
    smap_path = os.path.join(c["folder"], uttid + ".smap.npy")
    ng_path = os.path.join(c["folder"], uttid + ".ngrams.pkl")
    if all(os.path.exists(p) for p in (fsm_path, smap_path, ng_path)):
        try:
            with open(ng_path, "rb") as f:
                ngrams = pickle.load(f)
            return uttid, fsm_path, smap_path, ngrams, True
        except Exception:
            pass  # corrupt cache: rebuild

    # REBUILD (some artifact missing/corrupt): drop the done-marker first,
    # so a crash mid-rewrite cannot leave a valid marker next to a
    # truncated fsm/smap that the next run would skip as done
    if os.path.exists(ng_path):
        os.remove(ng_path)

    lexicon = c["lexicon"]
    seq = [s if Label(s) in lexicon else "<unk>" for s in seq]

    G = LinearFSM(LOG, seq, **c["silcfg"])
    GL = fsmops.compose(G, lexicon)
    GLH = fsmops.compose(GL, c["hmms"])

    with open(fsm_path, "w") as f:
        f.write(to_json(GLH))
    np.save(smap_path, statemap(GLH, c["numpdf"]))

    ngrams = totalngramsum(GL, order=c["ngram_order"])
    # write the stats cache last: its presence marks the utterance done
    with open(ng_path + ".tmp", "wb") as f:
        pickle.dump(ngrams, f)
    os.replace(ng_path + ".tmp", ng_path)
    return uttid, fsm_path, smap_path, ngrams, False


def make_numerator_graphs(
    folder: str,
    text_path: str,
    lexicon,
    hmms,
    numpdf: int,
    *,
    init_silprob: float = 0.0,
    silprob: float = 0.0,
    final_silprob: float = 0.0,
    ngram_order: int = 2,
    num_workers: int = 0,
):
    """Parallel numerator-graph build over the transcript file; returns the
    ⊕-merged n-gram stats (reference examples/prepare-lfmmi-graphs.jl:102-139).
    """
    os.makedirs(folder, exist_ok=True)
    silcfg = dict(
        init_silprob=init_silprob, silprob=silprob, final_silprob=final_silprob
    )
    with open(text_path) as f:
        lines = [l.strip() for l in f if l.strip()]

    args = (lexicon, hmms, numpdf, folder, silcfg, ngram_order)
    log = logging.getLogger("markovmodels_tpu.pipeline")
    total = len(lines)
    every = max(1, total // 20)
    t0 = time.time()

    def iter_results():
        if num_workers and num_workers > 1:
            with mp.Pool(
                num_workers, initializer=_init_worker, initargs=args
            ) as pool:
                yield from pool.imap(_process_utterance, lines, chunksize=8)
        else:
            _init_worker(*args)
            for l in lines:
                yield _process_utterance(l)

    ngrams: dict = {}
    done = skipped = 0
    with open(os.path.join(folder, "fsm.scp"), "w") as fscp, open(
        os.path.join(folder, "smap.scp"), "w"
    ) as sscp:
        for r in iter_results():
            done += 1
            if done % every == 0 or done == total:
                log.info(
                    "numerator graphs %s: %d/%d (%d skipped, %.1fs)",
                    folder, done, total, skipped, time.time() - t0,
                )
            if r is None:
                continue
            uttid, fsm_path, smap_path, ng, was_skipped = r
            skipped += was_skipped
            print(uttid, fsm_path, file=fscp)
            print(uttid, smap_path, file=sscp)
            ngrams = merge_ngrams(ngrams, ng, LOG)
    return ngrams


def run_pipeline(config: dict, num_workers: int = 0):
    """Full pipeline from a parsed TOML/JSON config dict
    (reference examples/prepare-lfmmi-graphs.jl:142-224)."""
    data, sup = config["data"], config["supervision"]
    folder = sup["folder"]
    os.makedirs(folder, exist_ok=True)

    hmms, numpdf = make_hmms(data["units"], sup["topo"])
    with open(os.path.join(folder, "numpdf"), "w") as f:
        print(numpdf, file=f)

    lexicon = make_lexicon(LOG, data["lexicon"])

    sil = dict(
        init_silprob=sup.get("initial_silprob", 0.0),
        silprob=sup.get("silprob", 0.0),
        final_silprob=sup.get("final_silprob", 0.0),
    )
    ngrams = None
    for split, key in [("train", "traintext"), ("dev", "devtext")]:
        if key not in data:
            continue
        out = os.path.join(folder, "numfsms", split)
        os.makedirs(out, exist_ok=True)
        ng = make_numerator_graphs(
            out,
            data[key],
            lexicon,
            hmms,
            numpdf,
            ngram_order=sup.get("ngram_order", 2),
            num_workers=num_workers,
            **sil,
        )
        if split == "train":
            ngrams = ng

    lmfsm = fsmops.compose(language_model_fsm(ngrams, LOG), hmms)
    with open(os.path.join(folder, "denominator.fsm.json"), "w") as f:
        f.write(to_json(lmfsm))
    np.save(os.path.join(folder, "denominator.smap.npy"), statemap(lmfsm, numpdf))
    return lmfsm, numpdf


def main(argv=None):
    import tomllib

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    argv = argv if argv is not None else sys.argv[1:]
    cfg_path = argv[0] if argv else os.environ.get("CONFIG")
    if not cfg_path:
        print("usage: python -m markovmodels_tpu.pipeline.prepare_lfmmi_graphs "
              "config.toml  (or set CONFIG=...)", file=sys.stderr)
        return 2
    with open(cfg_path, "rb") as f:
        config = tomllib.load(f)
    workers = int(argv[1]) if len(argv) > 1 else os.cpu_count()
    run_pipeline(config, num_workers=workers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
