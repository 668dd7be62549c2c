"""FIR filtering with the reference's exact warm-up semantics.

The reference FIR node (fir.rs:179-225) keeps a ``VecDeque<f64>`` of recent
inputs, capped at ``taps.len()``, and emits the dot product of the deque
(oldest first) with the *stored* taps, which were reversed at IR-load time
(fir.rs:160-170).  Consequences we reproduce:

* steady state (>= N samples seen): standard causal convolution with the
  un-reversed IR, f64 accumulation, cast to f32, then scaled by the mode
  divisor (Average: 1/N, Balanced: 1 -- fir.rs:187-190).
* warm-up (first N-1 samples ever): the deque is shorter than the taps and
  zips from the *front* of the reversed-tap array, so sample g (global
  index, g < N-1) emits  sum_{k=0..g} x[k] * taps_rev[k]  -- a running
  cumulative sum along the reversed taps, NOT a convolution prefix.  This
  is a reference quirk we keep for parity.

``fir_apply`` is fully vectorized: the warm-up region is a masked cumsum,
the steady region a convolution (direct for short IRs, FFT overlap-add for
long ones), selected per-sample on the global index.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dsp_stuff_tpu.utils.precision import get_policy

# IRs longer than this use FFT convolution (O(T log N) vs O(T*N))
DIRECT_CONV_MAX_TAPS = 256


def init_fir_state(n_taps: int, batch_shape=(), dtype=jnp.float64):
    """State pytree: (hist, first, n_seen).

    hist  -- last N-1 inputs (newest last), zero-filled before warm
    first -- the first N-1 inputs ever seen (for warm-up replay)
    n_seen -- int32 global sample counter
    """
    n = max(n_taps - 1, 0)
    z = jnp.zeros((*batch_shape, n), dtype)
    return (z, z, jnp.zeros(batch_shape, jnp.int32))


def causal_conv(x, h):
    """y[n] = sum_m h[m] * x[n-m], zero history; x [..., T], h [N]."""
    N = h.shape[0]
    if N <= DIRECT_CONV_MAX_TAPS:
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(N - 1, 0)])
        # correlate with reversed kernel == convolve
        idx = jnp.arange(x.shape[-1])[:, None] + jnp.arange(N)[None, :]
        # gather-based direct conv would blow memory for large T; use
        # conv_general_dilated instead
        del idx
        return _conv_cgd(xp, h)
    return _fft_conv(x, h)


def _conv_cgd(xp, h):
    """Direct convolution via lax.conv_general_dilated on [..., T+N-1]."""
    N = h.shape[0]
    batch_shape = xp.shape[:-1]
    flat = xp.reshape((-1, 1, xp.shape[-1]))                       # [B, C=1, W]
    kern = h[::-1].reshape((1, 1, N)).astype(xp.dtype)             # [O, I, W]
    out = jax.lax.conv_general_dilated(
        flat, kern, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        preferred_element_type=xp.dtype,
        precision=jax.lax.Precision.HIGHEST)
    return out.reshape((*batch_shape, -1))


def _fft_conv(x, h):
    """FFT convolution; overlap-save blocks when the signal is much longer
    than the IR (BASELINE config #4 names overlap-save: bounded FFT size,
    batched block transforms instead of one signal-length FFT).
    Accumulation dtype follows the precision policy (the caller's x
    dtype: f64 transforms under parity)."""
    T = x.shape[-1]
    N = h.shape[0]
    dt = x.dtype
    nfft_os = 1 << max(int(np.ceil(np.log2(max(2 * N, 2)))), 10)
    if T <= 4 * nfft_os:
        # short signal: one FFT is cheaper than framing
        nfft = 1 << (T + N - 2).bit_length()
        X = jnp.fft.rfft(x, nfft)
        H = jnp.fft.rfft(h.astype(dt), nfft)
        return jnp.fft.irfft(X * H, nfft)[..., :T].astype(dt)

    # overlap-save: frames of nfft with N-1 samples of history each; every
    # frame yields hop = nfft-(N-1) valid outputs after discarding the
    # wrap-around prefix.  nfft >= 2N guarantees overlap (N-1) <= hop, so
    # the overlapping frames build from two contiguous reshapes (cheap
    # block copies) instead of a [K, nfft] gather.
    nfft = nfft_os
    hop = nfft - (N - 1)
    K = -(-T // hop)
    batch = x.shape[:-1]
    lead = [(0, 0)] * (x.ndim - 1)
    xp = jnp.pad(x, lead + [(N - 1, K * hop - T + hop)])
    W1 = xp[..., :K * hop].reshape(*batch, K, hop)
    W2 = xp[..., hop:hop + K * hop].reshape(*batch, K, hop)[..., :N - 1]
    frames = jnp.concatenate([W1, W2], axis=-1)            # [..., K, nfft]
    H = jnp.fft.rfft(h.astype(dt), nfft)
    Y = jnp.fft.irfft(jnp.fft.rfft(frames, nfft) * H, nfft)
    y = Y[..., N - 1:].reshape(*batch, K * hop)[..., :T]
    return y.astype(dt)


def fir_apply(x, taps_rev, state, divisor=1.0):
    """Apply the reference FIR semantics to a segment.

    x        -- [..., T] f32 input segment
    taps_rev -- [N] f64 stored taps (already reversed, as saved in configs)
    state    -- from init_fir_state (or None for a fresh filter)
    divisor  -- f32 mode divisor (fir.rs:187-190)

    Returns (y [..., T] f32, new_state).
    """
    pol = get_policy()
    acc_dt = jnp.dtype(pol.fir_accum_dtype)
    taps_rev = jnp.asarray(taps_rev, jnp.float64)
    N = taps_rev.shape[0]
    h = taps_rev[::-1]                         # un-reversed IR for convolution
    T = x.shape[-1]
    batch = x.shape[:-1]
    if state is None:
        state = init_fir_state(N, batch)
    hist, first, n_seen = state
    xd = x.astype(acc_dt)
    ha = h.astype(acc_dt)

    if N == 1:
        y = (xd * ha[0]).astype(jnp.float32) * jnp.float32(divisor)
        return y, state

    # ---- steady path: convolution over [hist, x] ----
    full = jnp.concatenate([hist.astype(acc_dt), xd], axis=-1)     # [..., N-1+T]
    y_steady = causal_conv(full, ha)[..., N - 1:]                  # [..., T]

    # ---- warm-up path: running cumsum along reversed taps ----
    # place this segment's samples into the global "first N-1" buffer
    firstbuf = first.astype(acc_dt)
    n_seen = jnp.asarray(n_seen, jnp.int32)
    Wp = min(N - 1, T)
    gidx = jnp.arange(N - 1)                                       # global slots
    if n_seen.ndim == 0:
        # LOCKSTEP counter (the node path: Fir declares n_seen shared —
        # all streams advance together).  The two warm gathers then use
        # SHARED 1-D indices, i.e. whole-[B]-row fetches per index
        # instead of B per-element gathers per index.
        seg_pos = gidx - n_seen                                    # [N-1]
        in_seg = (seg_pos >= 0) & (seg_pos < T)
        # relevant slots satisfy seg_pos = g - n_seen <= N-2, so the
        # gather source only needs x's first min(N-1, T) samples
        gathered = xd[..., jnp.clip(seg_pos, 0, Wp - 1)]
        firstbuf = jnp.where(in_seg, gathered, firstbuf)
        warm_cum = jnp.cumsum(firstbuf * taps_rev[: N - 1].astype(acc_dt),
                              axis=-1)
        g_pre = n_seen + jnp.arange(Wp)                            # [Wp]
        warm_pre = warm_cum[..., jnp.clip(g_pre, 0, N - 2)]
        y_pre = jnp.where(g_pre < N - 1, warm_pre, y_steady[..., :Wp])
    else:
        # per-stream counters (raw-op callers with explicit batch state)
        seg_pos = gidx - n_seen[..., None]                         # [..., N-1]
        in_seg = (seg_pos >= 0) & (seg_pos < T)
        gathered = jnp.take_along_axis(
            jnp.broadcast_to(xd[..., :Wp], (*firstbuf.shape[:-1], Wp)),
            jnp.clip(seg_pos, 0, Wp - 1), axis=-1)
        firstbuf = jnp.where(in_seg, gathered, firstbuf)
        warm_cum = jnp.cumsum(firstbuf * taps_rev[: N - 1].astype(acc_dt),
                              axis=-1)
        g_pre = n_seen[..., None] + jnp.arange(Wp)                 # [..., Wp]
        warm_pre = jnp.take_along_axis(
            jnp.broadcast_to(warm_cum, (*g_pre.shape[:-1], N - 1)),
            jnp.clip(g_pre, 0, N - 2), axis=-1)
        y_pre = jnp.where(g_pre < N - 1, warm_pre, y_steady[..., :Wp])
    # warm-up output for global index g (< N-1) is warm_cum[g].  Warm
    # samples are always a segment PREFIX (g = n_seen + t < N-1), so only
    # the first min(N-1, T) samples can need it — gather over that static
    # prefix instead of all T (a 480k render warms at most its first N-1).
    y = jnp.concatenate([y_pre, y_steady[..., Wp:]], axis=-1)
    y = y.astype(jnp.float32) * jnp.float32(divisor)

    # ---- state update ----
    new_hist = full[..., -(N - 1):]
    new_state = (new_hist.astype(hist.dtype), firstbuf.astype(first.dtype),
                 jnp.minimum(n_seen + T, jnp.int32(2 ** 30)))
    return y, new_state
