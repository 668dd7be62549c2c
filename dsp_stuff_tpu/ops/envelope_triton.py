"""Chunk-parallel peak envelope as a Pallas kernel for NVIDIA GPUs
(Triton route).

Same two-pass contraction algorithm as ops/envelope._chunked_batched (see
there for the convergence bound): pass 1 runs every chunk from a guessed
start and keeps only its final envelope; pass 2 reruns every chunk seeded
with its predecessor's pass-1 final and emits the envelope.

XLA runs each pass as a ``lax.scan`` of ``chunk`` steps, i.e. thousands
of while-loop iterations, each a kernel launch over a [P, B] carry.  Here
each pass is ONE launch.  The layout is time-major ``[chunk, L]`` with
``L = P * B`` lanes (lane ``p * B + b`` is chunk p of stream b); each
program owns ``LANES`` adjacent lanes and loops over the chunk's samples
with the envelope carry in registers.  Every step is one coalesced row
load and store; ``UNROLL`` rows are loaded ahead of the dependent updates
so their memory latency overlaps.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Lanes per program: one warp, one lane per thread.  The config5 batch
# (B = 512 streams x P = 15 chunks = 7,680 lanes) gives 240 programs,
# enough to cover the H100's 132 SMs.
LANES = 32
# Rows loaded ahead of the sequential updates in each loop step.
UNROLL = 32


def _pass_kernel(chunk: int, emit: bool):
    def kernel(gains_ref, starts_ref, d_ref, *out_refs):
        atk = gains_ref[0]
        rel = gains_ref[1]

        def body(i, env):
            t0 = i * UNROLL
            rows = [d_ref[t0 + u, :] for u in range(UNROLL)]
            for u, d in enumerate(rows):
                gain = jnp.where(env < d, atk, rel)
                env = d + gain * (env - d)
                if emit:
                    out_refs[0][t0 + u, :] = env
            return env

        env = jax.lax.fori_loop(0, chunk // UNROLL, body, starts_ref[...])
        out_refs[-1][...] = env
    return kernel


def _pass(d, starts, gains, emit: bool, interpret: bool):
    """One pass over d [chunk, Lp] from starts [Lp]: (env [chunk, Lp]
    when ``emit``, finals [Lp])."""
    chunk, Lp = d.shape
    f32 = jnp.float32
    fin_spec = pl.BlockSpec((LANES,), lambda j: (j,))
    row_spec = pl.BlockSpec((chunk, LANES), lambda j: (0, j))
    fin_shape = jax.ShapeDtypeStruct((Lp,), f32)
    out_specs = [fin_spec]
    out_shape = [fin_shape]
    if emit:
        out_specs = [row_spec, fin_spec]
        out_shape = [jax.ShapeDtypeStruct((chunk, Lp), f32), fin_shape]
    # the package enables x64 globally; the kernel's indices are 32-bit
    with jax.enable_x64(False):
        return pl.pallas_call(
            _pass_kernel(chunk, emit),
            grid=(Lp // LANES,),
            in_specs=[pl.BlockSpec((2,), lambda j: (0,)), fin_spec,
                      row_spec],
            out_specs=out_specs,
            out_shape=out_shape,
            compiler_params=plgpu.CompilerParams(num_warps=1,
                                                 num_stages=1),
            backend="triton",
            interpret=interpret,
            name="envelope_emit" if emit else "envelope_finals",
        )(gains, starts, d)


@functools.partial(jax.jit, static_argnames=("chunk", "interpret"))
def peak_envelope_chunked(x, attack_gain, release_gain, env0, chunk: int,
                          interpret: bool = False):
    """x [B, T] -> (env [B, T], final_env [B]); env0 is [B].

    ``chunk`` must be a multiple of ``UNROLL``.  ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests)."""
    if chunk % UNROLL:
        raise ValueError(f"chunk {chunk} is not a multiple of {UNROLL}")
    f32 = jnp.float32
    x = jnp.asarray(x, f32)
    B, T = x.shape
    P = -(-T // chunk)
    L = P * B
    Lp = -(-L // LANES) * LANES

    def lanes(v):                       # [P, B] -> padded [Lp]
        return jnp.pad(v.reshape(L), (0, Lp - L))

    xp = jnp.pad(x, ((0, 0), (0, P * chunk - T)))
    d = jnp.abs(jnp.transpose(xp.reshape(B, P, chunk), (2, 1, 0)))
    d = jnp.pad(d.reshape(chunk, L), ((0, 0), (0, Lp - L)))
    gains = jnp.stack([jnp.asarray(attack_gain, f32),
                       jnp.asarray(release_gain, f32)])
    e0 = jnp.asarray(env0, f32)

    starts = jnp.zeros((P, B), f32).at[0].set(e0)
    (finals,) = _pass(d, lanes(starts), gains, False, interpret)
    finals = finals[:L].reshape(P, B)
    starts2 = jnp.concatenate([e0[None], finals[:-1]], axis=0)
    ys, _ = _pass(d, lanes(starts2), gains, True, interpret)
    env = jnp.transpose(ys[:, :L].reshape(chunk, P, B), (2, 1, 0))
    env = env.reshape(B, P * chunk)[:, :T]
    return env, env[:, -1]
