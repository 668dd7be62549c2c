"""Feedback comb / echo delay line.

The reference Reverb node (reverb.rs:76-111) is a feedback echo:

    out[n] = in[n] + delayed[n] * decay      # reverb.rs:87-92
    delay-line <- out[n]                     # reverb.rs:99-105

with the delay line a rivulet ring pre-filled with D zeros, i.e.

    y[n] = x[n] + decay * y[n - D],  y[n<0] = 0,
    D = max(int(seconds * 48000), 128)       # reverb.rs:57

(The ring is re-allocated and zero-filled whenever `seconds` changes,
reverb.rs:55-71; under jit that maps to a static max length with a reset.)

Parallel lowering: y[n] depends only on y[n - D], so the sequence splits
into chunks of exactly D samples with a first-order recurrence *between*
chunks: chunk_k = x_chunk_k + decay * chunk_{k-1}.  A `lax.scan` over T/D
chunks does O(T/D) sequential steps of fully-vectorized D-wide work --
for D >= 128 that is at least 128-way parallelism per step, and the
per-sample op order (t = delayed*decay; y = x + t) matches the reference
bit-for-bit in f32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dsp_stuff_tpu.utils.precision import get_policy, mul_unfused


def delay_samples(seconds: float, sample_rate: int = 48_000) -> int:
    """max(int(seconds*48000), 128) -- reverb.rs:57.  The 128 floor is the
    reference's fixed BUF_SIZE, NOT the compile block size (compiling with
    block_size > 128 must not change reverb semantics)."""
    return max(int(seconds * sample_rate), 128)


def feedback_comb(x, decay, delay: int, history=None):
    """y[n] = x[n] + decay * y[n-D] along the last axis.

    history -- [..., D] previous outputs (newest last), zeros if None.
    Returns (y, new_history).

    Lowering by policy: the inter-chunk recurrence chunk_k = x_k +
    decay * chunk_{k-1} is first-order affine in [D]-vectors, so 'fast'
    uses a log-depth associative scan over the T/D chunks (a T=60 s render
    at D=2400 would otherwise crawl through 1200 sequential scan steps of
    trivial per-step work); 'parity'/'exact' keep the sequential scan,
    whose per-sample op order (t = delayed*decay; y = x + t) matches the
    reference bit-for-bit."""
    f32 = jnp.float32
    x = jnp.asarray(x, f32)
    D = int(delay)
    if history is None:
        history = jnp.zeros((*x.shape[:-1], D), f32)
    associative = get_policy().name == "fast"
    # 'exact': keep the reference's two roundings (t = delayed*decay;
    # y = x + t) out of LLVM's reach -- FMA contraction is the only thing
    # standing between this comb and bitwise parity
    unfused = get_policy().sequential_recurrences
    import numpy as _np
    from dsp_stuff_tpu.ops.scan import _inside_trace
    if (associative and _np.ndim(decay) == 0
            and not isinstance(decay, jax.core.Tracer) and _inside_trace()):
        # static (hashable) decay (the normal case): the blocked solver's
        # Toeplitz powers are trace-time constants (see
        # ops/scan.first_order_affine) and standalone eager calls stay one
        # fused dispatch
        return _feedback_comb_static(x, float(decay), history, D,
                                     associative, unfused)
    return _feedback_comb_jit(x, jnp.asarray(decay, f32), history, D,
                              associative, unfused)


@functools.partial(jax.jit, static_argnums=(1, 3, 4, 5), inline=True)
def _feedback_comb_static(x, decay: float, history, D: int,
                          associative: bool, unfused: bool):
    return _feedback_comb_impl(x, decay, history, D, associative, unfused)


@functools.partial(jax.jit, static_argnums=(3, 4, 5), inline=True)
def _feedback_comb_jit(x, decay, history, D: int, associative: bool,
                       unfused: bool):
    return _feedback_comb_impl(x, decay, history, D, associative, unfused)


def _feedback_comb_impl(x, decay, history, D: int, associative: bool,
                        unfused: bool):
    f32 = jnp.float32
    T = x.shape[-1]
    batch = x.shape[:-1]
    mul = mul_unfused if unfused else (lambda a, b: a * b)

    if T <= D:
        # Block shorter than the delay line (the in-cycle / streaming case,
        # T = 128 vs D up to 48000): every delayed sample is already in
        # history, so the comb is one fused elementwise op — no chunking.
        # (The general path would zero-pad the block to D: 375x wasted
        # work per block for a 1 s delay.)
        y = x + mul(history[..., :T], decay)
        new_hist = jnp.concatenate([history[..., T:], y], axis=-1)
        return y, new_hist

    nchunks = -(-T // D)
    pad = nchunks * D - T
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    # batch-major [..., K, D] for the parallel paths: a contiguous
    # reshape, NOT a chunk-major moveaxis — the two transposes (to
    # [K, ..., D] and back) would be full read+write passes over the
    # signal
    xcb = xp.reshape(*batch, nchunks, D)

    if associative and nchunks > 1:
        # single-GEMM / two-level Toeplitz; even at 2-16 chunks the GEMM
        # beats an associative_scan (log2 K full-signal passes)
        yb, last = _comb_chunks_blocked(xcb, decay, history)
    else:
        def step(prev, xk):
            y = xk + mul(prev, decay)
            return y, y

        last, yc = jax.lax.scan(step, history,
                                jnp.moveaxis(xcb, -2, 0))
        yb = jnp.moveaxis(yc, 0, -2)

    y = yb.reshape(*batch, nchunks * D)[..., :T]

    if pad == 0:
        new_hist = last
    else:
        # last D true outputs (prepend old history in case T < D)
        new_hist = jnp.concatenate([history, y], axis=-1)[..., -D:]
    return y, new_hist


def _comb_chunks_blocked(xcb, decay, history, G_max: int = 256):
    """Solve y_k = decay * y_{k-1} + x_k over the chunk axis with Toeplitz
    matmuls (same scheme as ops/scan.py:_first_order_blocked, but the
    recurrence elements are whole [D]-vectors).

    XLA lowers a K-long associative_scan as a logarithmic while-loop of
    dynamic slices; Toeplitz matmuls replace it.  The chunk axis stays
    batch-major throughout: the natural [M, K] x [K, N] layout for the
    einsum, avoiding the two full-signal transposes a chunk-major layout
    costs.

    K <= G_max (the common offline case, e.g. 10 s / 0.05 s delay =
    200 chunks): ONE [K, K] Toeplitz GEMM with the carried history as a
    fused d^(k+1) epilogue -- no padding, no carry chain, no second
    signal read (a fixed two-level scheme would pad K=200 to 256 and
    materialize a 28%-larger signal copy).

    K > G_max: two-level with G = ceil(K/KG) rounded up to a multiple
    of 8 (exact fit or near it), so the pad stays <= 8*KG - 1 chunks
    (the 8-alignment can add up to 7 per super-chunk) instead of up to
    100%.

    xcb     -- [..., K, D] batch-major chunked input
    history -- [..., D] carry into chunk 0
    Returns (yb [..., K, D], last [..., D]).
    """
    f32 = jnp.float32
    K = xcb.shape[-2]
    D = xcb.shape[-1]
    batch = xcb.shape[:-2]
    from dsp_stuff_tpu.ops.scan import scalar_power_toeplitz

    if K <= G_max:
        # y_k = sum_{j<=k} d^(k-j) x_j + d^(k+1) history, one GEMM
        pows, LtK, _ = scalar_power_toeplitz(decay, K, row_ge_col=True)
        yb = jnp.einsum("ij,...jd->...id", LtK, xcb,
                        preferred_element_type=f32,
                        precision=jax.lax.Precision.HIGHEST) \
            + pows[1:].reshape(K, 1) * history[..., None, :]
        return yb, yb[..., K - 1, :]

    KG = -(-K // G_max)
    G = -(-(-(-K // KG)) // 8) * 8                        # ceil, 8-aligned
    pad = KG * G - K
    xp = jnp.pad(xcb, [(0, 0)] * (xcb.ndim - 2) + [(0, pad), (0, 0)])
    Xg = xp.reshape(*batch, KG, G, D)                      # [..., KG, G, D]

    # LtG[i, j] = decay^(i-j) for i >= j; the shared helper owns the
    # concrete-vs-traced constant split
    pows, LtG, dG = scalar_power_toeplitz(decay, G, row_ge_col=True)

    # two-phase (see ops/scan._first_order_blocked): super-chunk end
    # states first via one mat-vec over the last Toeplitz row (avoids
    # materializing the signal-sized zero-state response just to slice
    # one column out of it), then the carry chain, then y in ONE GEMM
    # whose +carry epilogue XLA fuses.
    # e_m = decay^G e_{m-1} + z[m, -1],  z[m, -1] = sum_j d^(G-1-j) x[m, j]
    ends = jnp.einsum("j,...jd->...d", pows[G - 1::-1], Xg,
                      preferred_element_type=f32,
                      precision=jax.lax.Precision.HIGHEST)  # [..., KG, D]
    ends = ends.at[..., 0, :].add(dG * history)
    a = jnp.full((*(1,) * len(batch), KG, 1), dG, f32)

    def combine(l, r):
        a1, b1 = l
        a2, b2 = r
        return a2 * a1, a2 * b1 + b2

    _, e = jax.lax.associative_scan(combine, (a, ends),
                                    axis=ends.ndim - 2)    # [..., KG, D]
    carry_in = jnp.concatenate(
        [jnp.broadcast_to(history[..., None, :], (*batch, 1, D)),
         e[..., :-1, :]], axis=-2)                         # [..., KG, D]

    yg = jnp.einsum("ij,...jd->...id", LtG, Xg,
                    preferred_element_type=f32,
                    precision=jax.lax.Precision.HIGHEST) \
        + carry_in[..., :, None, :] * pows[1:].reshape(G, 1)
    yb = yg.reshape(*batch, KG * G, D)[..., :K, :]
    return yb, yb[..., K - 1, :]
