"""Modulated fractional-delay effects (chorus / flanger / vibrato core).

Extension beyond the reference's 21 nodes (it has no chorus; BASELINE.json
config #2 calls for "ring-buffer delay lines with modulated fractional
taps").  Vectorized shape: the whole modulated tap is one vectorized gather —

    d[t]   = base + depth * sin(2*pi*rate*t/sr + phase0)     (samples)
    pos[t] = t - d[t]
    y[t]   = lerp(x[floor(pos)], x[floor(pos)+1], frac)      (linear interp)

with the history prefix carried as state so segments chain seamlessly.
No sequential loop anywhere: an LFO is closed-form in absolute time, so the
delay trajectory for a whole render materializes at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TAU = 2.0 * np.pi


def max_delay_samples(base_s: float, depth_s: float,
                      sample_rate: int = 48_000) -> int:
    """Static history length for a chorus line (structural param)."""
    return int(np.ceil((base_s + depth_s) * sample_rate)) + 2


_BARREL_FRAME = 128      # outputs per frame
_BARREL_MIN_T = 8192     # below this the gather is dispatch-bound anyway
_BARREL_MAX_E = 16       # residual range cap (fast+deep LFOs fall back)


def _batching_module():
    """Indirection point for the private batching internals (tests force
    the fallback by monkeypatching this to raise)."""
    try:
        from jax._src.interpreters import batching
    except ImportError:          # private layout changed: public fallback
        from jax.interpreters import batching
    return batching


def _vmap_batch_size(x) -> int:
    """Total vmapped batch size hidden above ``x`` (1 if unbatched).

    Heuristic over jax internals (BatchTracer nesting) used ONLY to pick
    between two equally-correct lowerings; any API drift falls back to the
    batched-gather path."""
    try:
        batching = _batching_module()
        # tracer types known NOT to hide a batch axis behind them; any
        # OTHER tracer (a future jax could layer batching behind one the
        # walker can't see through) takes the conservative huge default,
        # same as the exception path -- the batched-gather lowering is
        # correct either way, only slower for truly-small batches
        benign = {"DynamicJaxprTracer", "JaxprTracer", "JVPTracer",
                  "ADTracer"}
        n = 1
        t = x
        while isinstance(t, jax.core.Tracer):
            if isinstance(t, batching.BatchTracer):
                d = t.batch_dim
                if isinstance(d, int):
                    n *= t.val.shape[d]
                t = t.val
            elif type(t).__name__ in benign:
                break
            else:
                return 1 << 30
        return n
    except Exception:
        return 1 << 30


def _barrel_plan(rate_hz, depth_s, base_s, L: int, T: int,
                 sample_rate: int):
    """Static shift-plan for the barrel lowering, or None when it does not
    apply: needs concrete (untraced) LFO params, a long enough render, a
    delay comfortably above the interpolation window, and a slow enough
    trajectory that the per-frame residual stays tiny."""
    for v in (rate_hz, depth_s, base_s):
        if isinstance(v, jax.core.Tracer) or np.ndim(v) != 0:
            return None
    if T < _BARREL_MIN_T:
        return None
    rate = abs(float(rate_hz))
    depth = float(depth_s) * sample_rate
    base = float(base_s) * sample_rate
    dmin, dmax = base - depth, base + depth
    if dmin < 2.0:
        return None                    # pos clipping could bind; rare
    F = _BARREL_FRAME
    # per-frame residual bound: LFO slope depth*2*pi*rate/sr per sample,
    # integrated over a frame, +2 for floor jitter at both ends
    E = int(np.ceil(depth * 2.0 * np.pi * rate * F / sample_rate)) + 2
    if E > _BARREL_MAX_E:
        return None
    # offset u[t] = i[t] - t - c0 with c0 chosen so u >= 0:
    # i = floor(L + t - d) >= t + floor(L - dmax)
    c0 = int(np.floor(L - dmax)) - 1
    U = int(np.ceil(L - dmin)) - c0 + 1        # exclusive upper bound on u
    return c0, U, E


_BARREL_SUB = 8     # sub-block granularity of the window gather


def _barrel_taps(xx, i, c0: int, U: int, E: int):
    """Near-gather-free evaluation of a = xx[..., i], b = xx[..., i+1]
    for a smooth monotone shared index trajectory ``i`` (values
    t + c0 + u[t], 0 <= u < U, |u variation| < E per 128-frame).

    Pipeline:
    1. frames of F=128 outputs built by jnp.stack of row-shifted
       contiguous reshapes (NOT concatenate of minor-dim slices and NOT a
       log2 chain of shrinking wheres — both blow up XLA compile time);
    2. per frame, the minimum offset U_f rounded to 8 selects an aligned
       [18, 8] sub-block window via ONE vmapped dynamic_slice — 3750
       block fetches per 10 s render instead of 480k scalar gathers;
    3. the residual (U_f mod 8) + e in [0, 8+E) picks between shifted
       copies via one-hot where-selects — full-width vector ops (selects,
       not 0/1-mask multiplies, so a NaN/Inf input sample cannot smear
       across the outputs that merely share its window column).

    Returns values bit-identical to the plain gathers (the only rewrite
    risk is the documented sign-of-zero divergence class: a selected
    -0.0 accumulates to +0.0)."""
    f32 = jnp.float32
    T = i.shape[0]
    F = _BARREL_FRAME
    S = _BARREL_SUB
    Tf = -(-T // F)
    u = i - jnp.arange(T, dtype=jnp.int32) - c0            # [T], in [0, U)
    if T != Tf * F:
        u = jnp.pad(u, (0, Tf * F - T), mode="edge")
    u2 = u.reshape(Tf, F)
    U_f = u2.min(axis=1)                                   # [Tf]
    e2 = u2 - U_f[:, None]                                 # [Tf, F] in [0, E)
    q = U_f // S                                           # aligned start
    r2 = (U_f - q * S)[:, None] + e2                       # [Tf, F] < S+E

    # gathered window: S*R columns from aligned col S*q; the widest b-tap
    # index is (F-1) + (S-1 + E-1) + 1, so R rows of S must cover F+S+E-1
    R = -(-(F + S + E - 1) // S)
    # frame row width: every aligned window must fit entirely
    # (dynamic_slice clamps out-of-range starts, which would corrupt)
    Wz = F * (-(-(U - 1 + S * R + 1) // F))
    K = Wz // F
    zlen = (Tf + K) * F
    z = xx[..., c0:]
    pad = zlen - z.shape[-1]
    if pad > 0:
        z = jnp.pad(z, [(0, 0)] * (z.ndim - 1) + [(0, pad)])
    else:
        z = z[..., :zlen]
    batch = z.shape[:-1]
    Z2 = z.reshape(*batch, Tf + K, F)
    Z = jnp.stack([Z2[..., k:Tf + k, :] for k in range(K)],
                  axis=-2).reshape(*batch, Tf, Wz // S, S)

    def fetch(rows, qq):
        zero = jnp.zeros((), qq.dtype)   # match dtypes (x64 literals
        start = (zero,) * (rows.ndim - 2) + (qq, zero)  # promote to i64)
        return jax.lax.dynamic_slice(
            rows, start, (*rows.shape[:-2], R, S))

    win = jax.vmap(fetch, in_axes=(-3, 0), out_axes=-3)(Z, q)
    win = win.reshape(*batch, Tf, R * S)                   # [..., Tf, R*S]

    acc_a = jnp.zeros((*batch, Tf, F), f32)
    acc_b = jnp.zeros((*batch, Tf, F), f32)
    for ev in range(S + E - 1):
        # where-select, NOT a 0/1 mask multiply: 0.0 * NaN = NaN would
        # smear a single bad input sample across every output sharing its
        # window column (up to S+E-1 extra NaNs), breaking per-node NaN
        # attribution.  For finite values the two forms are bit-identical.
        m = r2 == ev
        acc_a = acc_a + jnp.where(m, win[..., ev:ev + F], f32(0))
        acc_b = acc_b + jnp.where(m, win[..., ev + 1:ev + 1 + F], f32(0))
    a = acc_a.reshape(*batch, Tf * F)[..., :T]
    b = acc_b.reshape(*batch, Tf * F)[..., :T]
    return a, b


def _tap_trajectory(rate_hz, depth_s, base_s, L: int, T: int, t0,
                    sample_rate: int = 48_000):
    """(i, frac) of the fractional tap into ``xx = [hist(L), x(T)]``
    coordinates: i int32 (clipped to [0, L+T-2]), frac f32 — the shared
    trajectory math of modulated_delay, factored so the fused mtap
    stage (ops/chain_segment) evaluates the IDENTICAL indices/weights."""
    f32 = jnp.float32
    t0a = jnp.asarray(t0, jnp.int32)
    # [T] for a scalar clock (the shared/lockstep case), [..., T] otherwise
    t_abs = (t0a + jnp.arange(T) if t0a.ndim == 0
             else t0a[..., None] + jnp.arange(T))
    # LFO phase in f64 fractional cycles, reduced mod 1 BEFORE the f32 sin:
    # a raw f32 sample clock quantizes past 2^24 samples (~6 min at 48 kHz)
    # and an unreduced argument loses precision as it grows -- the reduced
    # phase stays in [0, 1) with full precision for arbitrarily long
    # streams (t_abs is exact in f64 up to 2^53)
    cycles = (jnp.asarray(rate_hz, jnp.float64)
              * t_abs.astype(jnp.float64) / sample_rate)
    phase = (cycles - jnp.floor(cycles)).astype(f32)
    # LFO sin precision is policy-dependent (read at trace time, like the
    # recurrence lowerings): under parity/exact the f32 argument evaluates
    # through f64 sin and rounds back (the oracle's <=1-ulp transcendental
    # convention; a native f32 sin's ~1-ulp slack, scaled by depth*sr and
    # the signal slope, costs ~-92 dBFS per chorus — too close to the -90
    # graph budget).  fast keeps the cheap f32 sin.
    from dsp_stuff_tpu.utils import precision
    arg = f32(TAU) * phase
    if precision.get_policy().name == "fast":
        s = jnp.sin(arg)
        d = (jnp.asarray(base_s, f32) * sample_rate
             + jnp.asarray(depth_s, f32) * sample_rate * s)
    else:
        # XLA contracts (depth*sr*s) + base*sr into a single-rounding fma,
        # moving the f32 trajectory by 1 ulp (~6e-5 samples at d~576) --
        # which the interpolated tap turns into ~-88 dBFS of wet error,
        # above the parity budget.  An f32->f32 reduce_precision fence does
        # NOT stop it (it is an identity the simplifier sees through);
        # precision.mul_unfused computes the product in f64 and rounds it
        # onto the f32 grid, which is bit-identical to an unfused f32
        # multiply and cannot be contracted.
        from dsp_stuff_tpu.utils.precision import f32_grid, mul_unfused
        s = jnp.sin(f32_grid(arg)).astype(f32)
        sweep = mul_unfused(jnp.asarray(depth_s, f32) * sample_rate, s)
        d = f32_grid(jnp.asarray(base_s, f32) * sample_rate + sweep)
    # pos in f64: offline and streaming evaluate the same tap at offsets
    # differing by an exact integer (the segment start), so a double
    # subtraction keeps i/frac bit-identical across segmentations —
    # in f32 the differing magnitudes round frac differently (~2e-5 wet
    # error at block boundaries)
    pos = (L + jnp.arange(T, dtype=jnp.float64)) - d.astype(jnp.float64)
    pos = jnp.clip(pos, 0.0, L + T - 2)
    i = jnp.floor(pos).astype(jnp.int32)
    frac = (pos - jnp.floor(pos)).astype(f32)
    return i, frac


def modulated_delay(x, rate_hz, depth_s, base_s, mix, hist, t0,
                    sample_rate: int = 48_000):
    """Apply a sine-modulated fractional delay along the last axis.

    x     -- [..., T] dry signal
    hist  -- [..., L] previous inputs (newest last; L = max_delay_samples)
    t0    -- absolute sample index of x[..., 0] (int32 scalar or [...]) for
             LFO phase continuity across segments
    Returns (y [..., T], new_hist, new_t0).
    """
    f32 = jnp.float32
    x = jnp.asarray(x, f32)
    T = x.shape[-1]
    L = hist.shape[-1]
    xx = jnp.concatenate([hist, x], axis=-1)               # [..., L+T]
    i, frac = _tap_trajectory(rate_hz, depth_s, base_s, L, T, t0,
                              sample_rate)
    if i.ndim == 1:
        # shared tap trajectory (scalar LFO params + the lockstep sample
        # clock — the normal case).  Two lowerings:
        #
        # * barrel-shift (small/unbatched renders): a per-ELEMENT gather at
        #   batch<=1 serializes on one index at a time.  The trajectory is
        #   smooth (LFO slope depth*2*pi*rate samples/sample), so per
        #   128-frame the integer offset is a per-frame constant plus a
        #   tiny residual; the constant applies via log2(U) slice+select
        #   stages and the residual via E masked shifted adds — all
        #   full-width vector ops, no gather anywhere.
        # * operand-batched gather (large vmapped batches): with B streams
        #   each index fetches a whole [B] row instead of B per-element
        #   gathers — and the barrel frames would cost B x 11 MB of
        #   device memory there.  Plain indexing stays differentiable for
        #   train/fit (the barrel path is differentiable by construction: slices,
        #   selects and adds).
        shift = _barrel_plan(rate_hz, depth_s, base_s, L, T, sample_rate)
        # total batch = vmap-hidden batch x explicit leading dims (an
        # un-vmapped [B, T] call is just as batched: at B=512 the barrel
        # frames would materialize B x 11 MB while the operand-batched
        # gather fetches whole [B] rows per index)
        explicit_b = int(np.prod(xx.shape[:-1], dtype=np.int64)) \
            if xx.ndim > 1 else 1
        if shift is not None and _vmap_batch_size(xx) * explicit_b <= 8:
            a, b = _barrel_taps(xx, i, *shift)
        else:
            a = xx[..., i]
            b = xx[..., i + 1]
    else:
        # per-stream trajectories (modulated rate or per-stream clocks)
        ib = jnp.broadcast_to(i, (*xx.shape[:-1], T))
        a = jnp.take_along_axis(xx, ib, axis=-1)
        b = jnp.take_along_axis(xx, ib + 1, axis=-1)
    wet = a * (1.0 - frac) + b * frac
    mix = jnp.asarray(mix, f32)
    y = x * (1.0 - mix) + wet * mix
    new_hist = xx[..., -L:]
    new_t0 = jnp.asarray(t0, jnp.int32) + T
    return y, new_hist, new_t0


# ---------------------------------------------------------------------------
# Fused-chorus ("mtap") support: a chorus inside a chain segment
# (ops/chain_segment.py).  The trajectory is shared across streams
# (lockstep clock), so its decomposition — per-block window starts q,
# per-sample residuals r < EV, interpolation weights frac — precomputes
# once per render as three tiny [K]/[T] arrays (1/B-th of a signal pass)
# and rides in as shared segment operands.  mtap_apply evaluates the
# decomposition by gather, bit-identical to modulated_delay's batched
# path for finite values.

_MTAP_S = _BARREL_SUB       # window alignment granularity (8)


def mtap_static(rate_hz: float, depth_s: float, base_s: float, L: int,
                sample_rate: int = 48_000):
    """Static mtap geometry for CONCRETE LFO params, or None when the
    stage can't lower: (NH, EV, RS) with NH = history blocks (ring has
    NH+1 slots), EV = the per-block trajectory variation bound (q is
    exact, not 8-aligned, so EV carries no alignment residue), RS =
    window slice width.  Gates: the minimum delay must keep the whole
    window slice inside the (NH+1)-block window (dmin >= RS - 128 + 2),
    and EV must stay bounded."""
    C = _BARREL_FRAME
    rate = abs(float(rate_hz))
    depth = float(depth_s) * sample_rate
    base = float(base_s) * sample_rate
    dmin = base - depth
    EV = int(np.ceil(depth * 2.0 * np.pi * rate * C / sample_rate)) + 2
    if EV > _MTAP_S + _BARREL_MAX_E:
        return None
    RS = C + (-(-(EV + 1) // _MTAP_S)) * _MTAP_S
    if dmin < RS - C + 2.0:
        return None
    NH = -(-L // C)
    return NH, EV, RS


def mtap_shared(rate_hz, depth_s, base_s, L: int, T: int, t0,
                sample_rate: int = 48_000):
    """Shared (stream-independent) trajectory operands for one render:
    (q [T//128] int32, r [T] int32, frac [T] f32).

    Coordinates: in-render absolute tap position a[t] = i[t] - L (i from
    _tap_trajectory, so indices/weights are IDENTICAL to the unfused
    chorus); u[t] = a[t] - t + NH*128 is the offset into the
    (NH+1)-block window; q_b = per-block min of u (exact, no
    8-alignment), r = u - q_b[t // 128] in [0, EV)."""
    C = _BARREL_FRAME
    assert T % C == 0, T
    i, frac = _tap_trajectory(rate_hz, depth_s, base_s, L, T, t0,
                              sample_rate)
    NH = -(-L // C)
    u = i - L + NH * C - jnp.arange(T, dtype=jnp.int32)
    u2 = u.reshape(T // C, C)
    q = u2.min(axis=1)                                     # [K]
    r = (u2 - q[:, None]).reshape(T)                       # [T] < EV
    return q, r, frac


def mtap_apply(x, hist, q, r, frac, mix):
    """mtap evaluation on [..., T] via gather (indices and weights
    identical to modulated_delay's batched lowering; used by
    ops/chain_segment.chain_segment).  Returns (y, new_hist)."""
    f32 = jnp.float32
    x = jnp.asarray(x, f32)
    T = x.shape[-1]
    L = hist.shape[-1]
    C = _BARREL_FRAME
    NH = -(-L // C)
    pad0 = NH * C - L
    lead = [(0, 0)] * (x.ndim - 1)
    xxp = jnp.concatenate(
        [jnp.zeros((*x.shape[:-1], pad0), f32), jnp.asarray(hist, f32), x],
        axis=-1) if pad0 else jnp.concatenate(
        [jnp.asarray(hist, f32), x], axis=-1)
    del lead
    idx = (jnp.repeat(q, C) + r + jnp.arange(T, dtype=jnp.int32))
    a = xxp[..., idx]
    b = xxp[..., idx + 1]
    wet = a * (1.0 - frac) + b * frac
    mix = jnp.asarray(mix, f32)
    y = x * (1.0 - mix) + wet * mix
    new_hist = xxp[..., -L:] if T >= L else jnp.concatenate(
        [jnp.asarray(hist, f32), x], axis=-1)[..., -L:]
    return y, new_hist
