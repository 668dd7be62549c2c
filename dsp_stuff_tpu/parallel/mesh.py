"""Multi-device scaling: shard the stream/batch axis over a device mesh.

The reference is single-process with intra-process SPSC pipes as its only
"communication backend" (SURVEY.md section 5).  The equivalent here is
pure data parallelism over independent audio streams: the compiled render
program is vmapped over ``[stream]`` and the stream axis is sharded across
a flat 1-D ``("streams",)`` mesh with ``jax.sharding.NamedSharding``.  XLA
inserts no collectives for the forward render (streams are independent);
an all-reduce appears only in the differentiable fitting path
(train/fit.py) where gradients reduce over the batch, and on GPUs XLA
hands it to NCCL over NVLink.  The cards of one host are joined all to
all, so the mesh follows the algorithm alone.

Sequence-axis sharding is deliberately not used: at 48 kHz the batch axis
is where the scale is (SURVEY.md section 5 "long-context" note).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "streams") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_streams(arr, mesh: Mesh, axis: str = "streams"):
    """Place ``[S, ...]`` with S sharded across the mesh."""
    spec = P(axis, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def render_sharded(compiled, inputs, mesh: Mesh | None = None,
                   axis: str = "streams", T: int | None = None):
    """Batched render with the leading stream axis sharded over the mesh.

    inputs -- [S, n_inputs, T] (S divisible by mesh size)
    Returns (outs [S, n_out, T], aux, state).
    """
    mesh = mesh or make_mesh(axis=axis)
    inputs = jnp.asarray(inputs, jnp.float32)
    inputs = shard_streams(inputs, mesh, axis)
    return compiled.render(inputs, T=T, batch_shape=(inputs.shape[0],))
