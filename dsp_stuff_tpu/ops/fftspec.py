"""Spectrogram computation (batch analog of the Spectrogram node).

The reference node reads ``fft_size`` fresh samples per tick (no overlap)
and runs them through audioviz 0.6.0's spectrum ``Processor`` configured at
spectrogram.rs:236-250: 48 kHz, ``frequency_bounds [lower, upper]``,
``resolution: None``, ``volume: 1.0``, ``VolumeNormalisation::Mixture``,
``PositionNormalisation::Exponential``, ``Interpolation::Cubic``; the last
``buffer_size`` columns are kept for drawing (spectrogram.rs:255-262).

audioviz's pipeline shape (compute_all): apodize (hann window) -> FFT
magnitudes of the first half-spectrum -> volume normalisation -> frequency
bounding -> position distribution -> interpolation onto the display grid.
We reproduce that shape end to end; the crate itself is unvendored and this
image has no Rust toolchain or egress, so two inner curves are documented
approximations rather than transcriptions:

* **Mixture volume curve** (approximated): a sqrt-of-frequency boost --
  audioviz's Mixture mode mixes linear-index scaling into the volume so
  high bins aren't visually crushed; sqrt(freq) has the same monotone
  shape and fixed points.
* **Exponential position distribution** (shape reproduced): kept bin i of
  n gets display position ``sqrt(i / (n-1))`` in [0, 1] -- low frequencies
  stretch over proportionally more of the axis (the defining property of
  the mode); audioviz's exact exponent is unknown.

The **cubic interpolation is exact in spirit and matmul-shaped in form**: a
Catmull-Rom resampling of the non-uniformly positioned bins onto a uniform
display grid.  Positions are static per (fft_size, bounds), so the whole
interpolation collapses into one precomputed ``[K_out, n_bins]`` weight
matrix and the per-frame work is a single matmul, fused by XLA into the
surrounding pipeline.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _kept_bins(fft_size: int, lower_hz: float, upper_hz: float,
               sample_rate: int):
    """Frequencies of the rfft bins inside [lower, upper]."""
    freqs = np.fft.rfftfreq(fft_size, 1.0 / sample_rate)
    keep = np.nonzero((freqs >= lower_hz) & (freqs <= upper_hz))[0]
    return freqs, keep


def exponential_positions(n: int) -> np.ndarray:
    """Display positions of n bins under the Exponential distribution:
    p_i = sqrt(i/(n-1)).  Low bins spread out, high bins compress -- the
    audio-display property PositionNormalisation::Exponential exists for."""
    if n == 1:
        return np.zeros(1, np.float64)
    i = np.arange(n, dtype=np.float64)
    return np.sqrt(i / (n - 1))


@functools.lru_cache(maxsize=64)
def _catmull_rom_matrix(n: int, k_out: int) -> np.ndarray:
    """[k_out, n] weights resampling values at exponential_positions(n)
    onto k_out uniform positions via Catmull-Rom cubic interpolation
    (audioviz Interpolation::Cubic).  Static per shape -> one matmul at
    run time."""
    pos = exponential_positions(n)
    if n < 4 or k_out < 1:
        # degenerate: nearest-neighbor
        W = np.zeros((max(k_out, 1), n), np.float32)
        u = np.linspace(0.0, 1.0, max(k_out, 1))
        j = np.searchsorted(pos, u).clip(0, n - 1)
        W[np.arange(max(k_out, 1)), j] = 1.0
        return W
    u = np.linspace(0.0, 1.0, k_out)
    # segment index j: pos[j] <= u < pos[j+1]
    j = (np.searchsorted(pos, u, side="right") - 1).clip(0, n - 2)
    t = (u - pos[j]) / (pos[j + 1] - pos[j])
    W = np.zeros((k_out, n), np.float64)
    t2, t3 = t * t, t * t * t
    w_m1 = 0.5 * (-t3 + 2 * t2 - t)
    w_0 = 0.5 * (3 * t3 - 5 * t2 + 2)
    w_p1 = 0.5 * (-3 * t3 + 4 * t2 + t)
    w_p2 = 0.5 * (t3 - t2)
    rows = np.arange(k_out)
    # clamp the outer control points at the edges (standard CR boundary)
    np.add.at(W, (rows, (j - 1).clip(0, n - 1)), w_m1)
    np.add.at(W, (rows, j), w_0)
    np.add.at(W, (rows, (j + 1).clip(0, n - 1)), w_p1)
    np.add.at(W, (rows, (j + 2).clip(0, n - 1)), w_p2)
    return W.astype(np.float32)


def spectrogram(x, fft_size: int = 512, lower_hz: float = 20.0,
                upper_hz: float = 20_000.0, sample_rate: int = 48_000,
                resolution: int | None = None, interpolate: bool = True):
    """x [..., T] -> (freqs [K], columns [..., n_frames, K]).

    With ``interpolate`` (the reference configuration) the K output
    columns are the Catmull-Rom resampling of the bounded bins onto a
    uniform display grid; ``freqs[k]`` is the frequency whose exponential
    position lands on grid point k (so a pure tone's column peak sits at
    its own frequency).  ``resolution`` sets K (None keeps the bin count,
    matching audioviz ``resolution: None``).  ``interpolate=False`` returns
    the raw bounded bins (round-1 behavior).
    """
    T = x.shape[-1]
    n_frames = T // fft_size
    xb = x[..., : n_frames * fft_size].reshape(
        *x.shape[:-1], n_frames, fft_size)
    # apodize: hann window, the audioviz default apodization
    win = jnp.asarray(np.hanning(fft_size), jnp.float32)
    spec = jnp.abs(jnp.fft.rfft(xb * win, axis=-1)) / fft_size
    freqs, keep = _kept_bins(fft_size, lower_hz, upper_hz, sample_rate)
    spec = spec[..., keep]
    # Mixture volume normalisation (approximated curve, see module doc)
    boost = jnp.sqrt(jnp.asarray(np.maximum(freqs[keep], 1.0), jnp.float32))
    spec = spec * boost / jnp.sqrt(jnp.float32(sample_rate / 2.0))
    if not interpolate:
        return np.asarray(freqs[keep], np.float32), spec

    n = keep.size
    K = int(resolution) if resolution else n
    W = jnp.asarray(_catmull_rom_matrix(n, K))
    # HIGHEST: a default-precision f32 matmul may run in TF32 or bf16 on
    # an accelerator (10 or 7 mantissa bits)
    cols = jnp.einsum("...k,jk->...j", spec, W,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    return grid_frequencies(fft_size, lower_hz, upper_hz, sample_rate, K), \
        cols


def grid_frequencies(fft_size: int, lower_hz: float, upper_hz: float,
                     sample_rate: int = 48_000,
                     resolution: int | None = None) -> np.ndarray:
    """Frequency of each display-grid column: invert the exponential
    position map by interpolating bin frequency over position.  The single
    source of truth for 'a tone's column peak sits at its own frequency'
    (used by spectrogram() above and the Spectrogram node's
    ``frequencies``)."""
    freqs, keep = _kept_bins(fft_size, lower_hz, upper_hz, sample_rate)
    n = keep.size
    K = int(resolution) if resolution else n
    pos = exponential_positions(n)
    grid_f = np.interp(np.linspace(0.0, 1.0, K), pos, freqs[keep])
    return np.asarray(grid_f, np.float32)
