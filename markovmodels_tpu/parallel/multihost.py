"""Multi-host (pod-slice) initialization helpers.

The reference's only distribution is Julia ``Distributed`` for host-side
graph prep (reference examples/prepare-lfmmi-graphs.jl:2-11).  The runtime
scale-out here is ``jax.distributed`` + GSPMD: utterance batches data-
parallel across hosts, the shared denominator graph replicated or
state-sharded over the devices of a host (SURVEY §5.8).

This module only wires process boot + global mesh construction; the math is
host-count agnostic (parallel/sharded.py works over any mesh).
"""
from __future__ import annotations

import jax

from .mesh import make_mesh

__all__ = ["initialize", "global_mesh", "process_local_batch_slice"]


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize jax.distributed (no-op for a single process).

    Pass the coordinator address, process count and process id
    explicitly: nothing in a plain GPU/CPU cluster announces them."""
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(model_axis_size: int = 1, *, data_axis: str = "data",
                model_axis: str = "model"):
    """Global mesh over all devices of all hosts: the model axis is kept
    within hosts by construction since jax.devices() orders devices
    host-major; the data axis spans hosts."""
    return make_mesh({data_axis: -1, model_axis: model_axis_size})


def process_local_batch_slice(global_batch: int):
    """(start, size) of this process's slice of a data-parallel batch."""
    n = jax.process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    per = global_batch // n
    return jax.process_index() * per, per
