"""markovmodels_tpu — a lattice-inference engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
FAST-ASR/MarkovModels.jl: semiring linear algebra over compiled FSMs, batched
forward-backward and Viterbi recursions over sparse HMM transition graphs,
and LF-MMI numerator/denominator graph scoring — built from `lax.scan` time
recursions, blocked matmul operators and device meshes rather than ported
from the reference's Julia/CUDA design.
"""

from .semiring import LOG, TROPICAL, PROB, BOOL, Semiring, get_semiring
from .labels import Label, LabelSet, UNION_CONCAT, show_label
from .fsm import FSM, from_json, to_json, nstates
from .fsmops import (
    union,
    rawunion,
    concat,
    reverse,
    renorm,
    compose,
    propagate,
    determinize,
    minimize,
)
from .algorithms import (
    totalcumsum,
    totalsum,
    totalweightsum,
    totallabelsum,
    fsmequal,
)
from .lmfsm import totalngramsum, language_model_fsm, merge_ngrams

__version__ = "0.1.0"

__all__ = [
    "LOG", "TROPICAL", "PROB", "BOOL", "Semiring", "get_semiring",
    "Label", "LabelSet", "UNION_CONCAT", "show_label",
    "FSM", "from_json", "to_json", "nstates",
    "union", "rawunion", "concat", "reverse", "renorm", "compose",
    "propagate", "determinize", "minimize",
    "totalcumsum", "totalsum", "totalweightsum", "totallabelsum", "fsmequal",
    "totalngramsum", "language_model_fsm", "merge_ngrams",
]
