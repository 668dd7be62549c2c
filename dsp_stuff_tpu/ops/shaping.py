"""Vectorized waveshapers.

Each function reproduces one of the reference's per-sample shaper loops as a
pure elementwise JAX op over ``[..., T]`` f32 arrays; XLA fuses chains of
these into single kernels.  ``level`` (and friends) may be scalars or
per-sample arrays (audio-rate modulation via ``as_input`` sliders).

Semantics sources (all in /root/reference/dsp-stuff/src/nodes/):
    distort.rs   -- 9 shaper modes (distort.rs:18-28, dispatch 184-194)
    overdrive.rs -- atan overdrive (overdrive.rs:31-43)
    chebyshev.rs -- asymmetric tanh shaper (chebyshev.rs:28-42)

Every mode bypasses (returns the input sample) when ``level < 0.001``
(e.g. distort.rs:60-66); with modulated level this is a per-sample choice.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from dsp_stuff_tpu.utils.precision import exact_div, exact_mul, get_policy

_F32 = jnp.float32
BYPASS_EPS = np.float32(0.001)


def _trans(fn, v):
    """Transcendental with policy-dependent internals.

    XLA's f32 tanh/atan/sin/exp are fast rational approximations that can be
    ~20 ulp off the correctly-rounded value; Rust's libm is <= 1 ulp.  Under
    the 'parity'/'exact' policies we evaluate in f64 and round, landing
    within ~1 ulp of the reference (-approx 138 dBFS at full scale); 'fast'
    keeps native f32 (-approx 87 dBFS worst case, still inaudible)."""
    if get_policy().name == "fast":
        return fn(v)
    return fn(v.astype(jnp.float64)).astype(jnp.float32)


def _bypass(level, shaped, x):
    return jnp.where(level < BYPASS_EPS, x, shaped)


def _safe_level(level):
    """Denominator-safe level: in the bypass region the shaped branch is
    discarded by the where, but 0/0 there still poisons jax.grad (the
    classic where-NaN-gradient pitfall), which would break gradient
    fitting of distortion sliders.  Values are unchanged outside bypass."""
    return jnp.where(level < BYPASS_EPS, jnp.float32(1.0), level)


def _tanh(v):
    """tanh with the argument clamped to |v| <= 20.

    tanh(v) rounds to f32 1.0 for every |v| > ~9.6, so the clamp is
    bit-invisible in the f32 result; it exists because a backend's f64
    tanh may return garbage/NaN in the far-saturated tail (an emulated
    f64 has returned tanh(88.)=0.0, tanh(90.)=NaN).
    NaN inputs propagate (clip keeps NaN)."""
    return _trans(jnp.tanh, jnp.clip(v, -20.0, 20.0))


def clip(x):
    """clip to [-1, 1] (distort.rs:53-61)."""
    return jnp.clip(x, -1.0, 1.0)


def hard_clip(x, level):
    """clip(x*level)/level (distort.rs:63-69).  The trailing division is
    rewrite-protected under 'exact' (recip-mul is ~1 ulp off a true f32
    divide when level is a trace-time constant)."""
    level = jnp.asarray(level, _F32)
    return _bypass(level, exact_div(clip(x * level), _safe_level(level)), x)


def soft_clip(x, level):
    """Cubic soft clip: v - v^3/3 inside [-1,1], +/-2/3 outside
    (distort.rs:71-86)."""
    level = jnp.asarray(level, _F32)
    v = x * level
    # (v*v)*v matches Rust powi(3) (LLVM repeated multiplication); the
    # branch order sends NaN to the -2/3 arm exactly like the reference's
    # if/else-if/else chain (distort.rs:77-83)
    inner = v - exact_div((v * v) * v, _F32(3.0))
    shaped = jnp.where(v > 1.0, _F32(2.0 / 3.0),
                       jnp.where((v >= -1.0) & (v <= 1.0), inner,
                                 _F32(-2.0 / 3.0)))
    return _bypass(level, exact_div(clip(shaped), _safe_level(level)), x)


def tanh_clip(x, level):
    """(x*level).tanh() (distort.rs:104-110)."""
    level = jnp.asarray(level, _F32)
    return _bypass(level, _tanh(x * level), x)


def recip_soft_clip(x, level):
    """sign(x) * (1 - 1/(|x|*level + 1)) (distort.rs:96-102)."""
    level = jnp.asarray(level, _F32)
    shaped = jnp.sign(x) * (1.0 - exact_div(1.0, exact_mul(jnp.abs(x), level)
                                             + 1.0))
    return _bypass(level, shaped, x)


def sin_shape(x, level):
    """(x*level).sin() (distort.rs:112-118)."""
    level = jnp.asarray(level, _F32)
    return _bypass(level, _trans(jnp.sin, x * level), x)


def atan_shape(x, level):
    """(x*level).atan() (distort.rs:120-126)."""
    level = jnp.asarray(level, _F32)
    return _bypass(level, _trans(jnp.arctan, x * level), x)


def square_shape(x, level):
    """(x*level)^2 * sign(x*level) (distort.rs:128-134)."""
    level = jnp.asarray(level, _F32)
    v = x * level
    return _bypass(level, v * v * jnp.sign(v), x)


def chebyshev4(x, level):
    """8v^4 - 8v^2 + 1 with v = x*level (distort.rs:136-144).
    Note: emits DC +1 at silence -- reference quirk, kept.  The 8x products
    are exact (power-of-two scaling), so FMA contraction of the following
    add/sub cannot change the result -- no 'exact' guard needed."""
    level = jnp.asarray(level, _F32)
    v = x * level
    v2 = v * v
    v4 = v2 * v2          # Rust powi(4) squares: (v*v)*(v*v)
    return _bypass(level, 8.0 * v4 - 8.0 * v2 + 1.0, x)


def fuzz(x, level, block_size: int = 128):
    """Block-max-normalized double-exp shaper (distort.rs:146-172).

    The reference normalizes by the max |x| of each 128-sample block, making
    the output depend on block boundaries (and NaN on all-zero blocks --
    quirk kept; see SURVEY.md section 2.4 #5).  ``x`` is processed in
    ``block_size`` frames along the last axis; T must be a multiple.

    Reference inner math, with mx = max|x| over the block:
        q = clip(x*level) / mx
        z = -(1 - exp(-|q|))          # copysign(-1.0) folds both signs
        y = clip(z*mx) / max|z|
        out = y * mx / max|y|
    """
    level = jnp.asarray(level, _F32)
    T = x.shape[-1]
    assert T % block_size == 0, (T, block_size)
    nb = T // block_size
    xb = x.reshape(*x.shape[:-1], nb, block_size)
    lb = jnp.broadcast_to(level, x.shape).reshape(*x.shape[:-1], nb, block_size)

    mx = jnp.max(jnp.abs(xb), axis=-1, keepdims=True)
    q = clip(xb * lb) / mx
    # (1 - (-|q|).exp()).copysign(-1) -> always non-positive (distort.rs:160)
    z = -(1.0 - _trans(jnp.exp, -jnp.abs(q)))
    mz = jnp.max(jnp.abs(z), axis=-1, keepdims=True)
    y = clip(z * mx) / mz
    my = jnp.max(jnp.abs(y), axis=-1, keepdims=True)
    out = y * mx / my
    return out.reshape(x.shape)


def overdrive(x, boost, drive, level):
    """drive*(2/pi)*atan(pi/4*boost*x) + (1-drive)*x, then *level
    (overdrive.rs:31-43); bypass on level < 0.001."""
    boost = jnp.asarray(boost, _F32)
    drive = jnp.asarray(drive, _F32)
    level = jnp.asarray(level, _F32)
    a = x * boost
    b = _F32(np.float32(np.pi / 4.0)) * a
    d = _F32(np.float32(2.0 / np.pi)) * _trans(jnp.arctan, b)
    mix = drive * d + (1.0 - drive) * x
    return jnp.where(level < BYPASS_EPS, x, mix * level)


def chebyshev_asym(x, level_pos, level_neg):
    """tanh(x*l)/tanh(l) with separate l for x>=0 / x<0 (chebyshev.rs:28-42);
    per-branch bypass when that branch's level < 0.001.

    Lowered with the level selected BEFORE the signal-sized tanh — one
    transcendental pass over x instead of two.  Per element this executes
    the exact ops of the taken branch (where/tanh/div are not subject to
    FMA recontraction), so it is bit-identical to the two-branch form
    under every policy; the denominators stay per-branch (free for scalar
    levels, and 3 passes instead of 4 for audio-rate modulated ones)."""
    lp = jnp.asarray(level_pos, _F32)
    ln = jnp.asarray(level_neg, _F32)
    pos_side = x >= 0.0
    l = jnp.where(pos_side, lp, ln)
    den = jnp.where(pos_side, _tanh(_safe_level(lp)), _tanh(_safe_level(ln)))
    return jnp.where(l < BYPASS_EPS, x, _tanh(x * l) / den)


DISTORT_MODES = {
    "HardClip": hard_clip,
    "SoftClip": soft_clip,
    "Tanh": tanh_clip,
    "RecipSoftClip": recip_soft_clip,
    "Fuzz": fuzz,
    "Sin": sin_shape,
    "Atan": atan_shape,
    "Square": square_shape,
    "Chebyshev4": chebyshev4,
}
