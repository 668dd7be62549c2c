"""Polyphase oversampling wrappers for waveshapers (BASELINE config #3).

Nonlinear shapers generate harmonics above Nyquist that alias back down;
running them at 4x rate with band-limiting FIRs on both sides suppresses
that.  The reference has no oversampling (its Distort node aliases); this
is an extension.

    up:   y[R*t + p] = sum_k h[R*k + p] * x[t - k]      (polyphase)
    down: z[t]       = sum_k h[k] * y[R*t - k]          (strided FIR)

h is a Hann-windowed sinc low-pass at pi/R, length TAPS*R+1, gain R on the
upsampling side (to preserve amplitude through zero-stuffing).

Lowering: both converters are *banded block-Toeplitz matmuls* — 128
base-rate samples per block, the overlapping input window against a
precomputed static tap matrix:

    up:   Y[m, 128R] = Xw[m, 144]  @ Mu[144, 128R]
    down: Z[m, 128]  = Yw[m, 144R] @ Md[144R, 128]

(window = block + 8 base-rate samples of halo each side = the kernel's
group delay).  A `lax.conv_general_dilated` with batch=1/channel=1 maps
badly onto matrix hardware; the block matmul runs the identical sums as
one GEMM.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

TAPS_PER_PHASE = 16


@functools.lru_cache(maxsize=None)
def _lowpass_kernel(R: int, taps_per_phase: int = TAPS_PER_PHASE):
    """Hann-windowed sinc low-pass at cutoff pi/R.

    Odd length (R*taps_per_phase + 1) so the group delay (N-1)/2 is an
    integer sample at the oversampled rate — an even kernel leaves a
    half-sample shift that survives the up/shape/down round trip as a
    fractional-sample phase error."""
    N = R * taps_per_phase + 1
    n = np.arange(N, dtype=np.float64) - (N - 1) / 2.0
    with np.errstate(invalid="ignore", divide="ignore"):
        h = np.where(np.abs(n) < 1e-12, 1.0 / R,
                     np.sin(np.pi * n / R) / (np.pi * n))
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N) / (N - 1))
    h = h * w
    h /= h.sum() * 1.0          # unity DC gain at the base rate
    return h.astype(np.float32)


_BLK = 128      # base-rate samples per matmul block
_HALO = 8       # base-rate halo each side = (N-1)/2 / R group delay


@functools.lru_cache(maxsize=None)
def _up_matrix(R: int):
    """Mu[144, 128R]: Mu[j, R*tau+p] = R*h[R*(tau+16-j)+p] for
    0 <= tau+16-j <= 16 (zero outside the kernel's 17 base-rate taps)."""
    h = np.zeros((TAPS_PER_PHASE + 1) * R + R, np.float64)
    h[:TAPS_PER_PHASE * R + 1] = _lowpass_kernel(R).astype(np.float64) * R
    W = _BLK + 2 * _HALO
    Mu = np.zeros((W, _BLK * R), np.float64)
    for u in range(_BLK * R):
        tau, p = divmod(u, R)
        for i in range(TAPS_PER_PHASE + 1):
            idx = R * i + p
            if idx <= TAPS_PER_PHASE * R:
                Mu[tau + 2 * _HALO - i, u] = h[idx]
    return Mu.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _down_matrix(R: int):
    """Md[144R, 128]: Md[j, tau] = h[R*tau + 16R - j] for
    0 <= R*tau+16R-j <= 16R."""
    h = _lowpass_kernel(R).astype(np.float64)
    N = h.shape[0]                      # 16R + 1
    W = (_BLK + 2 * _HALO) * R
    Md = np.zeros((W, _BLK), np.float64)
    for tau in range(_BLK):
        for j in range(R * tau, R * tau + N):       # idx = R*tau+16R-j in h
            Md[j, tau] = h[R * tau + 2 * _HALO * R - j]
    return Md.astype(np.float32)


def _windows(x, blk: int, halo: int):
    """Overlapping block windows along the last axis: W[..., m, j] =
    xpad[..., blk*m + j], j < blk + 2*halo, with xpad = halo zeros | x |
    (halo + block-padding) zeros.  Two contiguous reshapes + a concat —
    no gather."""
    T = x.shape[-1]
    M = -(-T // blk)
    lead = [(0, 0)] * (x.ndim - 1)
    xp = jnp.pad(x, lead + [(halo, M * blk - T + halo + blk)])
    Tp = M * blk
    W1 = xp[..., :Tp].reshape(*x.shape[:-1], M, blk)
    W2 = xp[..., blk:blk + Tp].reshape(*x.shape[:-1], M, blk)[..., :2 * halo]
    return jnp.concatenate([W1, W2], axis=-1), M


def upsample(x, R: int):
    """[..., T] -> [..., R*T]: zero-stuff + low-pass (gain-compensated),
    lowered as one blocked matmul."""
    x = jnp.asarray(x, jnp.float32)
    T = x.shape[-1]
    Xw, M = _windows(x, _BLK, _HALO)                       # [..., M, 144]
    Mu = jnp.asarray(_up_matrix(R))
    Y = jnp.einsum("...mj,ju->...mu", Xw, Mu,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return Y.reshape(*x.shape[:-1], M * _BLK * R)[..., :R * T]


def downsample(x, R: int):
    """[..., R*T] -> [..., T]: low-pass + decimate, lowered as one blocked
    matmul."""
    x = jnp.asarray(x, jnp.float32)
    Tu = x.shape[-1]
    T = -(-Tu // R)
    Yw, M = _windows(x, _BLK * R, _HALO * R)               # [..., M, 144R]
    Md = jnp.asarray(_down_matrix(R))
    Z = jnp.einsum("...mj,jt->...mt", Yw, Md,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return Z.reshape(*x.shape[:-1], M * _BLK)[..., :T]


def oversampled(fn, x, R: int, *args, **kwargs):
    """Run elementwise shaper ``fn(x, *args)`` at R-times rate.

    R == 1 is a passthrough.  Scalars in args broadcast; per-sample
    modulation arrays are upsampled alongside the signal (sample-and-hold
    would also be defensible; band-limited interpolation avoids zipper
    noise)."""
    if R == 1:
        return fn(x, *args, **kwargs)
    xu = upsample(x, R)
    up_args = tuple(
        upsample(a, R) if (hasattr(a, "ndim") and getattr(a, "ndim", 0) > 0
                           and a.shape[-1] == x.shape[-1]) else a
        for a in args)
    yu = fn(xu, *up_args, **kwargs)
    return downsample(yu, R)
