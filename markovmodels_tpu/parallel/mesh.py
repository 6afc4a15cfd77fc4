"""Device-mesh utilities.

The reference has no in-engine distribution (single GPU; Julia ``Distributed``
only for host-side graph prep, reference examples/prepare-lfmmi-graphs.jl:106-109).
The scale-out story (SURVEY §5.8):

* utterance batch data-parallel over the 'data' axis (the reference's
  blockdiag batching is literally a batch axis);
* the large shared LF-MMI denominator graph either replicated (default) or
  state-sharded over the 'model' axis with psum/all_gather between devices
  (see ``parallel.sharded``).
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_parallel_sharding", "P", "NamedSharding"]


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """Build a mesh from {'axis': size}.  A size of -1 absorbs the remaining
    devices.  Example: ``make_mesh({'data': -1, 'model': 4})``."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    sizes = dict(axis_sizes)
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = int(np.prod([v for v in sizes.values() if v != -1]))
    if wild:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by {fixed}")
        sizes[wild[0]] = n // fixed
    shape = tuple(sizes.values())
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh {sizes} needs {np.prod(shape)} devices, have {n}")
    return Mesh(devices.reshape(shape), tuple(sizes.keys()))


def data_parallel_sharding(mesh: Mesh, axis: str = "data"):
    """NamedSharding placing the leading (batch) dim on the data axis."""
    return NamedSharding(mesh, P(axis))
