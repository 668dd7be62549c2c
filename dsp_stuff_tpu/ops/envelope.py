"""Peak envelope follower (dasp_envelope semantics).

The reference Envelope node (envelope.rs:43-51) wraps
``dasp_envelope::Detector<f32, Peak<FullWave>>`` with attack/release frame
counts set every block.  dasp's detector computes, per sample:

    d     = |x|                                   (full-wave rectify)
    gain  = attack_gain  if env < d  else release_gain
    env'  = d + gain * (env - d)

with ``gain_from_frames(n) = exp(-1/n)`` and ``0.0`` when n == 0.

The branch on ``env < d`` makes the recurrence non-associative (the
coefficient depends on the running state), so unlike the linear filters it
cannot lower to an associative scan.  It IS, however, a contraction in the
carry: for any two envelopes e1, e2 and the same input sample,
|f(e1) - f(e2)| <= max(atk, rel) * |e1 - e2| (both branch slopes are the
gains, which are < 1, and the cross-branch case splits into two
non-negative terms each bounded by its gain).  The ``fast`` policy exploits
that with a two-pass chunk-parallel evaluation whose sequential step count
is 2*chunk regardless of T (`_chunked_batched`; on a GPU the same two
passes run as one Pallas Triton launch each, ops/envelope_triton.py);
parity/exact keep the per-sample `lax.scan`.

The fast path is wrapped in

* ``jax.custom_batching.custom_vmap`` — a vmapped (per-stream) call
  re-dispatches to the explicit [B, T] implementation whose scan carry is
  laid out [P, B] (chunk-major, streams on the contiguous minor axis);
  vmap's default [B, P] carry puts the short chunk axis minor;
* ``jax.custom_vjp`` — the adjoint of the recurrence is a *linear*
  first-order reverse recurrence in the cotangent (coefficient = the
  forward's selected gain), so the backward pass lowers to the same fast
  associative-scan machinery as the linear filters (ops/scan.py) instead
  of AD-through-a-480k-step-scan, and the custom_vmap forward (which has
  no autodiff rule of its own) stays differentiable for train/fit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def gain_from_frames(frames):
    """exp(-1/frames); 0 when frames == 0 (dasp_envelope calc_gain).

    Concrete (untraced, scalar) frame counts evaluate in NumPy f32 at
    trace time: the gain becomes a compile-time constant identical on
    every backend.  The recurrence amplifies a 1-ulp gain difference over
    thousands of samples, so a device exp that rounds differently from
    NumPy's would cost a long parity render most of its -90 dBFS budget;
    with host-computed gains the backends agree exactly."""
    if not isinstance(frames, jax.core.Tracer) and np.ndim(frames) == 0:
        f = np.float32(frames)
        if f == 0.0:
            return jnp.float32(0.0)
        return jnp.float32(np.exp(np.float32(-1.0) / f))
    frames = jnp.asarray(frames, jnp.float32)
    safe = jnp.where(frames == 0.0, 1.0, frames)
    return jnp.where(frames == 0.0, 0.0, jnp.exp(-1.0 / safe))


def _use_triton(B: int, T: int) -> bool:
    """The chunked path runs the Pallas Triton kernel
    (ops/envelope_triton.py) on an NVIDIA GPU backend and XLA's two
    scans everywhere else.  Read at trace time."""
    return T > 2 * _CHUNK and jax.default_backend() == "gpu"


# Chunk length for the fast-policy chunk-parallel path.  Convergence of the
# guessed chunk starts is g^CHUNK with g = exp(-1/frames); at the reference's
# slider maximum (1000 frames, envelope.rs attack/release range) that is
# exp(-32.8) ~= 6e-15 -- far below f32 rounding.  Must stay comfortably above
# ~21 * max_expected_frames.
_CHUNK = 32768


def _scan_step(atk, rel):
    def step(env, dt):
        gain = jnp.where(env < dt, atk, rel)
        env = dt + gain * (env - dt)
        return env, env
    return step


def _seq_scan(x, atk, rel, env0, unroll=32):
    """Per-sample lax.scan along the last axis (any leading batch dims).
    The data-dependent branch keeps this sequential; unrolling amortizes
    the XLA while-loop per-iteration overhead."""
    d = jnp.abs(jnp.moveaxis(x, -1, 0))
    final, ys = jax.lax.scan(_scan_step(atk, rel), env0, d, unroll=unroll)
    return jnp.moveaxis(ys, 0, -1), final


def _chunked_batched(x, atk, rel, env0, chunk):
    """Two-pass chunk-parallel peak envelope for explicit [B, T] input.

    Pass 1 scans all T/chunk chunks in parallel from guessed (zero) starts,
    producing each chunk's final envelope; pass 2 rescans with each chunk
    seeded by its predecessor's pass-1 final.  Because the recurrence
    contracts the carry by max(atk, rel) < 1 per sample, every pass-2 start
    is correct to within g^chunk of the true envelope, so the emitted
    samples match the sequential evaluation to below f32 rounding
    (bit-identical on every tested input).  Sequential step count: 2*chunk,
    independent of T.

    Layout: the scan carry is [P, B] — streams on the contiguous minor
    axis — so each step is a few full-width vector ops; the
    [B, P, chunk] <-> [chunk, P, B] transposes at the boundary are cheap
    relative to the T-step scan they remove.
    """
    B, T = x.shape
    P = -(-T // chunk)
    xp = jnp.pad(x, ((0, 0), (0, P * chunk - T)))
    d = jnp.abs(jnp.transpose(xp.reshape(B, P, chunk), (2, 1, 0)))
    step = _scan_step(atk, rel)

    starts = jnp.zeros((P, B), x.dtype).at[0].set(env0)
    finals, _ = jax.lax.scan(lambda e, dt: (step(e, dt)[0], None),
                             starts, d, unroll=8)
    starts2 = jnp.concatenate([env0[None], finals[:-1]], axis=0)
    _, ys = jax.lax.scan(step, starts2, d, unroll=8)      # [chunk, P, B]
    env = jnp.transpose(ys, (2, 1, 0)).reshape(B, P * chunk)[:, :T]
    return env, env[:, -1]


def _fast_fwd_batched(x, atk, rel, env0):
    """Forward for explicit [B, T] input: chunked when long enough (the
    Triton kernel on a GPU), the sequential scan otherwise."""
    B, T = x.shape
    if _use_triton(B, T):
        from dsp_stuff_tpu.ops import envelope_triton
        return envelope_triton.peak_envelope_chunked(x, atk, rel, env0,
                                                     chunk=_CHUNK)
    if T > 2 * _CHUNK:
        return _chunked_batched(x, atk, rel, env0, _CHUNK)
    return _seq_scan(x, atk, rel, env0)


@jax.custom_batching.custom_vmap
def _env_fast(x, atk, rel, env0):
    """Fast-policy envelope core on unbatched [T] input.  A vmapped call
    re-dispatches to the explicit [B, T] implementation (streams-minor
    carry layout); gains must be unbatched scalars (they always are: the
    Envelope node has no as_input params and sliders are per-graph)."""
    env, fin = _fast_fwd_batched(x[None], atk, rel, env0[None])
    return env[0], fin[0]


@_env_fast.def_vmap
def _env_fast_vmap(axis_size, in_batched, x, atk, rel, env0):
    x_b, atk_b, rel_b, env0_b = in_batched
    if atk_b or rel_b or not x_b or x.ndim != 2:
        # unbatched x (vmap over env0 only with a closed-over signal) would
        # need a rank-3 broadcast the [B, T] fast kernel cannot take; no
        # real caller does this, so refuse uniformly rather than crash with
        # a shape error downstream
        raise NotImplementedError(
            "peak_envelope fast path: per-stream attack/release, unbatched "
            "signals, or nested batching are not supported (gains are "
            "per-graph sliders; the signal must carry the vmapped axis)")
    S = axis_size
    e0 = env0 if env0_b else jnp.broadcast_to(env0, (S,))
    env, fin = _fast_fwd_batched(x, atk, rel, e0)
    return (env, fin), (True, True)


def _env_core_fwd(x, atk, rel, env0):
    env, fin = _env_fast(x, atk, rel, env0)
    return (env, fin), (x, atk, rel, env0, env)


def _env_core_bwd(res, cts):
    """Analytic adjoint.  With g_t the gain the forward selected at step t,

        env_t = d_t + g_t * (env_{t-1} - d_t)

    gives the *linear* reverse recurrence for the cotangent
    lam_t = ybar_t + g_{t+1} * lam_{t+1}, which lowers to the associative
    first-order scan (ops/scan.first_order_affine) — no 480k-step reverse
    while-loop, no O(T) residual stack beyond the forward's own output."""
    from dsp_stuff_tpu.ops.scan import first_order_affine
    x, atk, rel, env0, env = res
    ybar, fbar = cts
    f32 = jnp.float32
    ybar = jnp.asarray(ybar, f32).at[..., -1].add(jnp.asarray(fbar, f32))

    d = jnp.abs(x)
    env_prev = jnp.concatenate(
        [jnp.broadcast_to(env0[..., None], (*env.shape[:-1], 1)),
         env[..., :-1]], axis=-1)
    is_atk = env_prev < d
    g = jnp.where(is_atk, atk, rel)

    # lam via reversed first-order affine scan: u_k = a_k u_{k-1} + yr_k
    # with u_k = lam_{T-1-k}, a_k = g_{T-k} (a_0 unused -> 0)
    gr = jnp.flip(g, axis=-1)
    a = jnp.concatenate([jnp.zeros_like(gr[..., :1]), gr[..., :-1]], axis=-1)
    lam = jnp.flip(first_order_affine(a, jnp.flip(ybar, axis=-1), 0.0),
                   axis=-1)

    xbar = lam * (1.0 - g) * jnp.sign(x)
    demd = env_prev - d                      # d env_t / d gain_t
    atkbar = jnp.sum(lam * demd * is_atk).astype(f32)
    relbar = jnp.sum(lam * demd * (~is_atk)).astype(f32)
    env0bar = lam[..., 0] * g[..., 0]
    return xbar, atkbar, relbar, env0bar


@jax.custom_vjp
def _env_core(x, atk, rel, env0):
    return _env_fast(x, atk, rel, env0)


_env_core.defvjp(_env_core_fwd, _env_core_bwd)


# The chunked path's convergence bound: g^_CHUNK must sit far below f32
# rounding, i.e. frames <~ _CHUNK / 21.  The Envelope node clamps its
# sliders to the reference's 0..1000 range; direct callers with larger
# CONCRETE frame counts fall back to the sequential scan here, and traced
# (fit-time) frame values rely on the node clamp (documented contract).
_MAX_CHUNKED_FRAMES = 1500.0


def _frames_maybe_too_large(frames) -> bool:
    """True when a concrete frame count is outside the chunked path's
    contraction contract: above _MAX_CHUNKED_FRAMES, negative (gain
    exp(-1/f) > 1 would *amplify* chunk-seed error), or NaN."""
    try:
        f = float(frames)
    except Exception:       # traced value: trust the node-level clamp
        return False
    return not (0.0 <= f <= _MAX_CHUNKED_FRAMES)


def peak_envelope(x, attack_frames=0.0, release_frames=0.0, env0=0.0):
    """Full-wave peak detection along the last axis.

    Returns (env [..., T] f32, final_env).

    NOT wrapped in a module-level jax.jit: the precision policy is read at
    trace time, and a shared jit cache keyed only on shapes would silently
    reuse a fast-policy trace for an exact-policy call (and vice versa).
    Callers inside compile_graph are jitted there; standalone callers jit
    themselves if they care.
    """
    from dsp_stuff_tpu.utils import precision
    f32 = jnp.float32
    x = jnp.asarray(x, f32)
    atk = gain_from_frames(attack_frames)
    rel = gain_from_frames(release_frames)
    env0 = jnp.broadcast_to(jnp.asarray(env0, f32), x.shape[:-1])
    if (precision.get_policy().name == "fast"
            and x.ndim <= 2 and atk.ndim == 0 and rel.ndim == 0
            and not _frames_maybe_too_large(attack_frames)
            and not _frames_maybe_too_large(release_frames)):
        if x.ndim == 2:
            # explicit batch: route through vmap so the custom_vmap rule
            # picks the streams-minor [P, B] carry layout
            return jax.vmap(_env_core, in_axes=(0, None, None, 0))(
                x, atk, rel, env0)
        return _env_core(x, atk, rel, env0)
    return _seq_scan(x, atk, rel, env0)
