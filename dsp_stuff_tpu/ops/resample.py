"""16-tap windowed-sinc resampler as a vectorized JAX op.

The reference's output path resamples 48 kHz -> device rate with a sinc-16
interpolator on the host audio thread (devices.rs:550-556).  Here the same
16-tap Hann-windowed sinc runs on-device, restructured as a contraction: each
output sample is a dot product of 16 taps with a gathered input window, so
the whole resample is one [n_out, 16] tap matrix (precomputed per output
grid at trace time when the ratio is static) contracted against gathered
windows — no sequential loop.

Semantics are kept identical to the native C++ implementation
(native/dsp_host.cpp: dsp_resample_sinc16) and the NumPy fallback
(io/resample.py); tests assert cross-implementation agreement.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

HALF = 8          # 16 taps: m in [-7, 8]


def _tap_matrix(n_out: int, ratio: float):
    """Precompute (indices [n_out, 16] int32, taps [n_out, 16] f32)."""
    k = np.arange(n_out, dtype=np.float64)
    t = k / ratio
    i0 = np.floor(t).astype(np.int64)
    frac = t - i0
    m = np.arange(-HALF + 1, HALF + 1, dtype=np.float64)       # [16]
    x = m[None, :] - frac[:, None]                              # [n_out, 16]
    fc = min(ratio, 1.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(np.abs(x) < 1e-12, 1.0,
                        np.sin(np.pi * fc * x) / (np.pi * fc * x))
    w = np.where(np.abs(x) <= HALF, 0.5 * (1.0 + np.cos(np.pi * x / HALF)),
                 0.0)
    taps = (fc * sinc * w).astype(np.float32)
    idx = (i0[:, None] + m[None, :].astype(np.int64)).astype(np.int32)
    return idx, taps


def resample_sinc16(x, ratio: float):
    """Resample the last axis by out/in ``ratio`` (static).

    x -- [..., T] f32.  Returns [..., floor(T*ratio)] f32.
    """
    x = jnp.asarray(x, jnp.float32)
    T = x.shape[-1]
    n_out = int(np.floor(T * ratio))
    idx, taps = _tap_matrix(n_out, ratio)
    valid = (idx >= 0) & (idx < T)
    gathered = jnp.take(x, jnp.clip(idx, 0, T - 1), axis=-1)    # [..., n_out, 16]
    gathered = jnp.where(valid, gathered, 0.0)
    return jnp.einsum("...ot,ot->...o", gathered, jnp.asarray(taps),
                      precision=jax.lax.Precision.HIGHEST)
