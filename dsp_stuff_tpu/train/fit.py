"""Differentiable parameter fitting: optimize a graph's sliders by gradient.

This subsystem has no analog in the reference (its knobs are hand-turned in
the egui UI) — it exists because the compiled design makes the whole
effect graph a pure differentiable function.  Uses:

* match a target sound: fit distortion/filter settings so the rendered
  output approximates a recorded target (classic amp-matching);
* calibrate: recover the slider settings that produced a given render.

The compiled graph exposes its non-static sliders as a pytree
(``CompiledGraph.init_params``); the loss renders the graph with candidate
parameters and measures distance to the target.  Everything jits to a
single XLA program per optimization step; with a sharded batch XLA inserts
the gradient all-reduce (``psum``) from the sharding (parallel/mesh.py),
which runs over NCCL on GPUs.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from dsp_stuff_tpu.compiler.compile import CompiledGraph


def clamp_params(cg: CompiledGraph, params):
    """Project each slider back into its [lo, hi] range (the UI invariant —
    derive lib.rs sliders are range-clamped)."""
    out = {}
    for nid_s, entry in params.items():
        node = cg.graph.nodes[int(nid_s)]
        out[nid_s] = {
            name: jnp.clip(v, node.spec.param(name).lo,
                           node.spec.param(name).hi)
            for name, v in entry.items()
        }
    return out


def mse_loss(y, target):
    return jnp.mean((y - target) ** 2)


def spectral_loss(y, target, fft_size: int = 1024):
    """Log-magnitude STFT distance — far better conditioned than MSE for
    fitting nonlinear shapers (phase-insensitive)."""
    def mag(x):
        frames = x.reshape(*x.shape[:-1], -1, fft_size)
        win = jnp.hanning(fft_size).astype(x.dtype)
        return jnp.abs(jnp.fft.rfft(frames * win, axis=-1))
    eps = 1e-6
    return jnp.mean((jnp.log(mag(y) + eps) - jnp.log(mag(target) + eps)) ** 2)


def make_loss_fn(cg: CompiledGraph, distance: Callable = mse_loss):
    """loss(params, state, ext, target) -> scalar.

    ``ext``/``target`` may carry leading batch axes (vmapped here so a
    sharded batch axis data-parallelizes the fit)."""

    def single(params, state, ext, target):
        _, outs, _ = cg.fn(state, ext, params)
        y = jnp.stack([outs[i] for i in cg.output_ids], axis=-2)
        return distance(y, target)

    def loss(params, state, ext, target):
        sample = next(iter(ext.values()))
        n_batch = sample.ndim - 1
        f = single
        for _ in range(n_batch):
            f = jax.vmap(f, in_axes=(None, None, 0, 0))
        val = f(params, state, ext, target)
        return jnp.mean(val)

    return loss


def make_train_step(cg: CompiledGraph, optimizer=None,
                    distance: Callable = mse_loss):
    """Returns (step, init_opt_state); step is jittable:

        step(params, opt_state, state, ext, target)
            -> (params, opt_state, loss)
    """
    optimizer = optimizer or optax.adam(1e-2)
    loss_fn = make_loss_fn(cg, distance)

    def step(params, opt_state, state, ext, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, state, ext, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        params = clamp_params(cg, params)
        return params, opt_state, loss

    return step, optimizer.init


def make_sharded_train_step(cg: CompiledGraph, mesh, optimizer=None,
                            distance: Callable = mse_loss,
                            axis: str = "streams"):
    """Training step jitted over a device mesh: batch (ext/target leading
    axis) sharded across ``axis``, parameters/optimizer state replicated.
    XLA inserts the gradient all-reduce (psum, NCCL on GPUs) from the
    shardings — no explicit collectives.

    Returns (step_jitted, opt_init); call as
        step(params, opt_state, state, ext, target)
    with ext {input_id: [S, T]} and target [S, n_out, T], S divisible by
    the mesh size."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    step, opt_init = make_train_step(cg, optimizer, distance)
    repl = NamedSharding(mesh, P())
    shard_bt = NamedSharding(mesh, P(axis, None))
    shard_bct = NamedSharding(mesh, P(axis, None, None))

    def jit_for(params, opt_state, state, ext, target):
        in_shardings = (
            jax.tree.map(lambda _: repl, params),
            jax.tree.map(lambda _: repl, opt_state),
            jax.tree.map(lambda _: repl, state),
            {k: shard_bt for k in ext},
            shard_bct,
        )
        return jax.jit(step, in_shardings=in_shardings)

    class _Step:
        """Jits lazily on first call (needs the concrete ext keys)."""
        _fn = None

        def __call__(self, params, opt_state, state, ext, target):
            if self._fn is None:
                self._fn = jit_for(params, opt_state, state, ext, target)
            return self._fn(params, opt_state, state, ext, target)

    return _Step(), opt_init


def fit(cg: CompiledGraph, ext, target, *, steps: int = 200,
        optimizer=None, distance: Callable = mse_loss, params=None,
        verbose: bool = False):
    """Fit the graph's sliders so its render of ``ext`` matches ``target``.

    ext    -- {input_node_id(str): [..., T]} external inputs (batch leading)
    target -- [..., n_out, T] desired output
    Returns (params, losses [steps]).
    """
    params = params if params is not None else cg.init_params()
    state = cg.init_state()
    step, opt_init = make_train_step(cg, optimizer, distance)
    step = jax.jit(step)
    opt_state = opt_init(params)
    target = jnp.asarray(target, jnp.float32)
    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, state, ext, target)
        losses.append(float(loss))
        if verbose and (i % max(steps // 10, 1) == 0):
            print(f"step {i:4d}  loss {losses[-1]:.3e}")
    return params, losses
