"""Linear-recurrence lowering: IIR filters as associative scans.

The reference evaluates all IIR state sequentially per sample on the CPU
(one-pole smoothers low_pass.rs:36-41 / high_pass.rs:36-41, DirectForm1
biquad biquad.rs:79-89).  On an accelerator a sequential 48 kHz loop would
waste the machine; linear recurrences are instead lowered to
``jax.lax.associative_scan`` (Blelloch scan over the affine-map monoid),
which XLA parallelizes over the sample axis:

* first order:  y[t] = a[t]*y[t-1] + b[t]
  elements (a, b); combine (a2, b2) o (a1, b1) = (a2*a1, a2*b1 + b2)
* second order (biquad): state s[t] = [y[t], y[t-1]],
  s[t] = A s[t-1] + [f[t], 0] with A = [[-a1, -a2], [1, 0]];
  elements (A, v); combine (A2, v2) o (A1, v1) = (A2A1, A2 v1 + v2)

Reassociation changes f32 rounding; the precision policy selects f64
internals (parity) or strictly sequential evaluation (exact) -- see
utils/precision.py.  All functions operate on ``[..., T]`` arrays
(recurrence along the last axis) and are vmap/batch friendly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dsp_stuff_tpu.utils.precision import get_policy


def _move_time_first(x):
    return jnp.moveaxis(x, -1, 0)


def _move_time_last(x):
    return jnp.moveaxis(x, 0, -1)


def first_order_affine(a, b, y0):
    """y[t] = a[t] * y[t-1] + b[t] along the last axis, y[-1] = y0.

    ``a`` may be scalar or [..., T]; ``b`` is [..., T]; ``y0`` broadcasts to
    b[..., 0].  Returns y with b's shape, f32.

    Lowering: with constant ``a`` under the 'fast' policy, the recurrence
    becomes per-chunk Toeplitz matmuls (see _first_order_blocked);
    otherwise a Blelloch associative scan at the policy's internal dtype;
    'exact' runs strictly sequentially.

    Jitted per precision policy so standalone calls don't pay eager
    per-level dispatch; inside compile_graph's jit this simply inlines.

    When ``a`` is a CONCRETE scalar (the normal case: slider params are
    Python floats) it enters the blocked path as a STATIC (hashable) jit
    argument: abstracted into a tracer, the Toeplitz tap matrix becomes
    per-call cumprod/where ops that XLA neither constant-folds (cumprod
    lowers through a while loop) nor hoists out of an enclosing
    feedback-cycle scan (a per-block rebuild that can outweigh the rest of
    a cycle body).  Static ``a`` builds the matrices in NumPy as
    trace-time constants while standalone eager calls stay one fused
    dispatch.
    """
    pol = get_policy()
    b_arr = jnp.asarray(b, jnp.float32)
    if (not pol.sequential_recurrences
            and pol.scan_internal_dtype == "float32"
            and np.ndim(a) == 0 and not isinstance(a, jax.core.Tracer)
            and _inside_trace()
            and b_arr.shape[-1] >= 2):
        # static (hashable) coefficient INSIDE an enclosing trace (the
        # compile_graph case): constants fold at trace time.  Eager
        # standalone calls keep the traced-operand jit below -- one cache
        # entry regardless of how many coefficient values a caller sweeps.
        return _first_order_blocked_static(float(a), b_arr,
                                           jnp.asarray(y0, jnp.float32))
    return _first_order_jit(jnp.asarray(a, jnp.float32),
                            b_arr,
                            jnp.asarray(y0, jnp.float32),
                            pol.scan_internal_dtype,
                            pol.sequential_recurrences)


def _trace_state_clean_fn():
    """Indirection point for the private API (tests force the fallback by
    monkeypatching this to raise)."""
    from jax._src import core as _core
    return _core.trace_state_clean


def _inside_trace() -> bool:
    """True when called under an enclosing jax trace (jit/vmap/grad).

    trace_state_clean is a private API; if a jax upgrade moves it, fall
    back to probing whether a trivial computation produces a Tracer (an
    eager context materializes a concrete array; under omnistaging every
    jnp op inside a trace is staged).  The fallback is slower but only
    changes WHICH equally-correct lowering is picked
    (tests/test_fallbacks.py pins their numerical equality)."""
    try:
        return not _trace_state_clean_fn()()
    except (ImportError, AttributeError):
        return isinstance(jnp.zeros(()) + 0, jax.core.Tracer)


@functools.partial(jax.jit, static_argnums=(0,), inline=True)
def _first_order_blocked_static(a: float, b, y0):
    return _first_order_blocked(a, b, y0)


@functools.partial(jax.jit, static_argnums=(3, 4), inline=True)
def _first_order_jit(a, b, y0, internal_dtype, sequential):
    if sequential:
        return _first_order_sequential(a, b, y0)
    if a.ndim == 0 and internal_dtype == "float32" and b.shape[-1] >= 2:
        return _first_order_blocked(a, b, y0)

    dt = jnp.dtype(internal_dtype)
    b = jnp.asarray(b)
    a = jnp.broadcast_to(jnp.asarray(a, dt), b.shape).astype(dt)
    bd = b.astype(dt)
    y0 = jnp.broadcast_to(jnp.asarray(y0, dt), b.shape[:-1])
    # fold the initial condition into the first element
    bd = bd.at[..., 0].add(a[..., 0] * y0)

    def combine(l, r):
        a1, b1 = l
        a2, b2 = r
        return a2 * a1, a2 * b1 + b2

    _, y = jax.lax.associative_scan(combine, (a, bd), axis=-1)
    return y.astype(jnp.float32)


# chunk length for blocked recurrences: y_chunk = B @ Lt is a
# [K, C] @ [C, C] matmul.  The [.., T] -> [.., K, C] reshape is
# layout-free, and the Toeplitz costs C MACs/sample
_BLOCK_C = 128


def scalar_power_toeplitz(a, n: int, row_ge_col: bool = False):
    """(pows [n+1], Lt [n, n], a^n) for a scalar coefficient ``a``.

    Default orientation: Lt[j, i] = a^(i-j) for i >= j (column form, the
    ``B @ Lt`` zero-state response); ``row_ge_col`` flips to
    Lt[i, j] = a^(i-j) for i >= j (the comb solver's ``Lt @ X`` form).

    The ONE place that owns the concrete-vs-traced split: a concrete
    (Python/NumPy scalar) coefficient builds everything in NumPy as
    trace-time constants — traced, a jnp.cumprod would sit inside the
    jaxpr as a while-lowered op XLA neither folds nor hoists out of an
    enclosing feedback-cycle scan."""
    f32 = jnp.float32
    if isinstance(a, (int, float, np.floating)):
        i = np.arange(n)
        pows_np = np.concatenate(
            [np.ones(1, np.float32),
             np.cumprod(np.full(n, a, np.float32), dtype=np.float32)])
        diff = (i[:, None] - i[None, :]) if row_ge_col else \
            (i[None, :] - i[:, None])
        Lt = jnp.asarray(np.where(
            diff >= 0, pows_np[np.clip(diff, 0, n)], 0.0
        ).astype(np.float32))
        return jnp.asarray(pows_np), Lt, pows_np[n]
    i = jnp.arange(n)
    pows = jnp.concatenate([jnp.ones((1,), f32),
                            jnp.cumprod(jnp.full((n,), a, f32))])
    diff = (i[:, None] - i[None, :]) if row_ge_col else \
        (i[None, :] - i[:, None])
    Lt = jnp.where(diff >= 0, pows[jnp.clip(diff, 0, n)], 0.0)
    return pows, Lt, pows[n]


def _first_order_blocked(a, b, y0, C: int = _BLOCK_C, scale=1.0):
    """Constant-coefficient first-order recurrence as matmuls.

    ``scale`` (concrete, trace-time) solves  y[t] = a y[t-1] + scale b[t]
    by folding the factor into the Toeplitz/ends tap constants -- b feeds
    the GEMM directly, with no prescale pass XLA might materialize.

    Split T into K chunks of C.  Within a chunk the zero-state response is

        z[k, i] = sum_{j<=i} a^(i-j) b[k, j]  =  (B @ Lt)[k, i],
        Lt[j, i] = a^(i-j) for i >= j else 0          ([C, C], constant)

    i.e. one batched triangular-Toeplitz matmul
    (a [T/C, C] @ [C, C] GEMM -- ~C MACs/sample).  Chunk carries follow
    the tiny K-length recurrence  e_k = a^C e_{k-1} + z[k, C-1]  (solved
    by associative scan -- C times fewer elements than the naive scan),
    and the carry folds back in as  y[k, i] = z[k, i] + e_{k-1} a^(i+1).
    This replaces a T-length Blelloch scan (log T passes over the signal
    in memory) by one GEMM pass.
    """
    f32 = jnp.float32
    T = b.shape[-1]
    batch = b.shape[:-1]
    K = -(-T // C)
    pad = K * C - T
    bp = jnp.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    B = bp.reshape(*batch, K, C)

    # powers a^0..a^C; guard pow for a == 0 (0^0 = 1 here); the helper
    # owns the concrete-vs-traced constant split
    pows, Lt, aC = scalar_power_toeplitz(a, C)
    ends_taps = pows[C - 1::-1]
    if not (isinstance(scale, float) and scale == 1.0):
        # fold the input scale into the tap constants (concrete scale +
        # concrete a -> XLA folds these at compile time); the carry
        # epilogue's a-powers stay unscaled (carries propagate through
        # the homogeneous part only)
        s32 = jnp.float32(scale)
        Lt = Lt * s32
        ends_taps = ends_taps * s32

    # two-phase evaluation: the chunk-end states first, via one cheap
    # mat-vec (the Toeplitz's last column, a^(C-1-j)) -- NOT by slicing
    # the full zero-state response z out of a materialized GEMM result.
    # z is as large as the signal, so its round-trip through memory
    # would be a whole extra pass.  With ends known, the carry chain
    # resolves and the final GEMM emits y directly, its +carry epilogue
    # fused by XLA.
    #
    # carry recurrence over chunks: e_k = a^C e_{k-1} + z[k, -1], e_{-1}=y0.
    # This is itself a constant-coefficient first-order recurrence of
    # length K, so recurse: T=2.88M resolves as 2-3 matmul levels
    # (11250 -> 44 -> direct) instead of a log-K Blelloch scan of ~14
    # dependent passes.
    ends = jnp.einsum("...kc,c->...k", B, ends_taps,
                      preferred_element_type=f32,
                      precision=jax.lax.Precision.HIGHEST)  # [..., K]
    y0b = jnp.broadcast_to(jnp.asarray(y0, f32), batch)
    if K > C:
        e = _first_order_blocked(aC, ends, y0b, C)
    elif K > 8:
        # single Toeplitz matmul level
        _, Lt2, _ = scalar_power_toeplitz(aC, K)
        ends0 = ends.at[..., 0].add(aC * y0b)
        e = jnp.einsum("...k,kd->...d", ends0, Lt2,
                       preferred_element_type=f32,
                       precision=jax.lax.Precision.HIGHEST)
    else:
        def combine(l, r):
            a1, b1 = l
            a2, b2 = r
            return a2 * a1, a2 * b1 + b2

        ends0 = ends.at[..., 0].add(aC * y0b)
        aa = jnp.broadcast_to(jnp.full((K,), aC, f32), ends0.shape)
        _, e = jax.lax.associative_scan(combine, (aa, ends0), axis=-1)
    # carry INTO chunk k is e_{k-1} (y0 for k = 0)
    carry_in = jnp.concatenate(
        [y0b[..., None], e[..., :-1]], axis=-1)            # [..., K]

    # y[k, i] = z[k, i] + e_{k-1} a^(i+1), z emitted by the GEMM with the
    # carry correction as a fused epilogue
    y = jnp.einsum("...kc,cd->...kd", B, Lt,
                   preferred_element_type=f32,
                   precision=jax.lax.Precision.HIGHEST) \
        + carry_in[..., :, None] * pows[1:][None, :]
    return y.reshape(*batch, K * C)[..., :T].astype(f32)


# canonical implementation lives in utils.precision (shared by every
# 'exact'-policy kernel); see its docstring for the full rationale
from dsp_stuff_tpu.utils.precision import mul_unfused as _mul_unfused


def _first_order_sequential(a, b, y0):
    """Strictly sequential f32 evaluation (bit-order parity with the
    reference's loops when the caller passes the same b expression)."""
    b = jnp.asarray(b, jnp.float32)
    a = jnp.broadcast_to(jnp.asarray(a, jnp.float32), b.shape)
    y0 = jnp.broadcast_to(jnp.asarray(y0, jnp.float32), b.shape[:-1])

    def step(y, ab):
        at, bt = ab
        y = _mul_unfused(at, y) + bt
        return y, y

    _, ys = jax.lax.scan(step, y0, (_move_time_first(a), _move_time_first(b)))
    return _move_time_last(ys)


def biquad_df1(x, a1, a2, b0, b1, b2, state=None):
    """DirectForm1 biquad (biquad crate semantics, used by biquad.rs:79-89):

        y[t] = b0*x[t] + b1*x[t-1] + b2*x[t-2] - a1*y[t-1] - a2*y[t-2]

    ``state = (x1, x2, y1, y2)`` (previous inputs/outputs, defaults 0).
    Returns (y, new_state).  Coefficients are scalars, already divided by a0
    (biquad.rs:62-76 divides at update; state resets whenever a slider
    changes, biquad.rs:74 -- handled by the caller).
    """
    x = jnp.asarray(x, jnp.float32)
    if state is None:
        z = jnp.zeros(x.shape[:-1], jnp.float32)
        state = (z, z, z, z)
    state = tuple(jnp.broadcast_to(jnp.asarray(s, jnp.float32), x.shape[:-1])
                  for s in state)
    pol = get_policy()
    cvals = (a1, a2, b0, b1, b2)
    if (not pol.sequential_recurrences
            and pol.scan_internal_dtype == "float32"
            and x.shape[-1] >= 2 and _inside_trace()
            and all(np.ndim(c) == 0 and not isinstance(c, jax.core.Tracer)
                    for c in cvals)):
        # concrete coefficients (the normal case): the blocked path builds
        # its impulse-response/Toeplitz/boundary constants in NumPy at
        # trace time — traced, they are per-call associative scans that
        # XLA cannot fold or hoist (see first_order_affine).  Both build
        # the constants from an f64 recurrence cast once to f32.
        cf = tuple(float(np.float32(c)) for c in cvals)
        if cf[0] == 0.0 and cf[1] == 0.0:
            # a1 == a2 == 0: pure 3-tap FIR, one fused elementwise pass
            # (2 passes over the signal vs the blocked solver's 3).
            return _biquad_pure_fir_static(x, cf, state)
        if cf[1] == 0.0 and cf[3] == 0.0 and cf[4] == 0.0:
            # a2 == b1 == b2 == 0: y[t] = b0 x[t] - a1 y[t-1], a scaled
            # first-order recurrence.  b0 folds into the trace-time tap
            # constants so x feeds the GEMM directly -- with a prescale
            # pass (f = b0 x) XLA would materialize f for the two einsum
            # readers; the scalar ends/carry machinery only wins when the
            # input is untouched.  The bench chain's biquad is this shape.
            return _biquad_degenerate_static(x, cf, state)
        return _biquad_blocked_static(x, cf, state)
    coeffs = tuple(jnp.asarray(c, jnp.float32) for c in cvals)
    return _biquad_jit(x, coeffs, state, pol.scan_internal_dtype,
                       pol.sequential_recurrences)


@functools.partial(jax.jit, static_argnums=(1,), inline=True)
def _biquad_pure_fir_static(x, cf: tuple, state):
    """DF1 biquad with a1 == a2 == 0: a pure 3-tap FIR, evaluated as one
    fused elementwise pass with the carried x-history prefix.  State
    layout matches the full biquad: (x1, x2, y1, y2)."""
    f32 = jnp.float32
    _a1, _a2, b0, b1, b2 = (np.float32(c) for c in cf)
    x1, x2, y1, y2 = state
    if float(b1) == 0.0 and float(b2) == 0.0:
        y = (x * b0).astype(f32)
    else:
        xp = jnp.concatenate([x2[..., None], x1[..., None], x], axis=-1)
        y = (b0 * xp[..., 2:] + b1 * xp[..., 1:-1]
             + b2 * xp[..., :-2]).astype(f32)
    # T >= 2 is guaranteed by the dispatch guard in biquad_df1
    return y, (x[..., -1], x[..., -2], y[..., -1], y[..., -2])


@functools.partial(jax.jit, static_argnums=(1,), inline=True)
def _biquad_degenerate_static(x, cf: tuple, state):
    """DF1 biquad with a2 == b1 == b2 == 0 (fast policy, concrete
    coefficients):

        y[t] = b0 x[t] - a1 y[t-1]

    routed through the scalar first-order blocked solver with b0 folded
    into its tap constants (``scale=``), so x feeds the GEMM directly.
    The y-history seed is exact: y[-1] participates only through the
    recurrence, which _first_order_blocked's y0 carries.  State layout
    matches the full biquad: (x1, x2, y1, y2)."""
    a1, _a2, b0, _b1, _b2 = cf
    x1, x2, y1, y2 = state
    y = _first_order_blocked(np.float32(-np.float32(a1)), x, y1,
                             scale=float(b0))
    # T >= 2 is guaranteed by the dispatch guard in biquad_df1
    return y, (x[..., -1], x[..., -2], y[..., -1], y[..., -2])


@functools.partial(jax.jit, static_argnums=(1,), inline=True)
def _biquad_blocked_static(x, cf: tuple, state):
    a1, a2, b0, b1, b2 = (np.float32(c) for c in cf)
    return _biquad_blocked(x, a1, a2, b0, b1, b2, state)


@functools.partial(jax.jit, static_argnums=(3, 4), inline=True)
def _biquad_jit(x, coeffs, state, internal_dtype, sequential):
    a1, a2, b0, b1, b2 = coeffs
    x1, x2, y1, y2 = state
    if sequential:
        return _biquad_sequential(x, a1, a2, b0, b1, b2, (x1, x2, y1, y2))
    if (internal_dtype == "float32" and x.shape[-1] >= 2
            and all(c.ndim == 0 for c in coeffs)):
        return _biquad_blocked(x, a1, a2, b0, b1, b2, (x1, x2, y1, y2))

    dt = jnp.dtype(internal_dtype)
    xd = x.astype(dt)
    a1d, a2d = jnp.asarray(a1, dt), jnp.asarray(a2, dt)
    b0d, b1d, b2d = (jnp.asarray(c, dt) for c in (b0, b1, b2))

    # FIR feed-forward part with carried x-history prefix
    xp = jnp.concatenate([x2[..., None].astype(dt), x1[..., None].astype(dt), xd],
                         axis=-1)
    f = (b0d * xp[..., 2:] + b1d * xp[..., 1:-1] + b2d * xp[..., :-2])

    T = x.shape[-1]
    batch = x.shape[:-1]
    # companion matrix A = [[-a1, -a2], [1, 0]], identical for every t
    A_single = jnp.stack([jnp.stack([-a1d, -a2d]),
                          jnp.asarray([1.0, 0.0], dt)])            # [2, 2]
    # time-first layout so one scan axis serves both leaves
    A = jnp.broadcast_to(A_single, (T, *batch, 2, 2))
    f_t = jnp.moveaxis(f, -1, 0)                                    # [T, ...]
    v = jnp.stack([f_t, jnp.zeros_like(f_t)], axis=-1)              # [T, ..., 2]
    s0 = jnp.stack([y1.astype(dt), y2.astype(dt)], axis=-1)         # [..., 2]
    hi = jax.lax.Precision.HIGHEST
    v = v.at[0].add(jnp.einsum("ij,...j->...i", A_single, s0, precision=hi))

    def combine(l, r):
        A1, v1 = l
        A2, v2 = r
        return (jnp.einsum("...ij,...jk->...ik", A2, A1, precision=hi),
                jnp.einsum("...ij,...j->...i", A2, v1, precision=hi) + v2)

    _, s = jax.lax.associative_scan(combine, (A, v), axis=0)
    y = jnp.moveaxis(s[..., 0], 0, -1).astype(jnp.float32)          # [..., T]
    y_prev_last = jnp.moveaxis(s[..., 1], 0, -1)[..., -1].astype(jnp.float32)
    new_state = (x[..., -1], xp[..., -2].astype(jnp.float32),
                 y[..., -1], y_prev_last)
    return y, new_state


def _vecn_recurrence(M_np: np.ndarray, w, C2: int = 128):
    """s_k = M s_{k-1} + w_k with constant [n, n] M (trace-time NumPy),
    s_{-1} = 0, w [..., K, n].  The n-dim blocked boundary-chain solver
    (_vec2_recurrence delegates its concrete-M case here): within a
    chunk of C2 steps the zero-state response is one einsum against the
    masked power tensor Lt[j, i] = M^(i-j) ([C2, C2, n, n], trace-time
    constant), chunk carries recurse."""
    f32 = jnp.float32
    n = M_np.shape[0]
    K = w.shape[-2]
    hi = jax.lax.Precision.HIGHEST
    if K <= 8:
        Mb = jnp.broadcast_to(jnp.asarray(M_np.astype(np.float32)),
                              (*w.shape[:-1], n, n))

        def combine(l, r):
            A1, v1 = l
            A2, v2 = r
            return jnp.einsum("...ij,...jk->...ik", A2, A1,
                              preferred_element_type=f32, precision=hi), \
                jnp.einsum("...ij,...j->...i", A2, v1,
                           preferred_element_type=f32, precision=hi) + v2

        _, s = jax.lax.associative_scan(combine, (Mb, w), axis=w.ndim - 2)
        return s

    KG = -(-K // C2)
    pad = KG * C2 - K
    wp = jnp.pad(w, [(0, 0)] * (w.ndim - 2) + [(0, pad), (0, 0)])
    W = wp.reshape(*w.shape[:-2], KG, C2, n)

    Mpow_np = np.empty((C2 + 1, n, n), np.float64)
    Mpow_np[0] = np.eye(n)
    M64 = M_np.astype(np.float64)
    for t in range(1, C2 + 1):
        Mpow_np[t] = M64 @ Mpow_np[t - 1]
    Mpow_np = Mpow_np.astype(np.float32)
    i = np.arange(C2)
    Lt = jnp.asarray(np.where(
        (i[:, None] <= i[None, :])[..., None, None],
        Mpow_np[np.clip(i[None, :] - i[:, None], 0, C2)], 0.0
    ).astype(np.float32))
    zs = jnp.einsum("jiab,...kjb->...kia", Lt, W,
                    preferred_element_type=f32, precision=hi)

    ends = zs[..., :, C2 - 1, :]                           # [..., KG, n]
    e = _vecn_recurrence(Mpow_np[C2], ends, C2)            # [..., KG, n]
    zero = jnp.zeros_like(e[..., :1, :])
    carry_in = jnp.concatenate([zero, e[..., :-1, :]], axis=-2)
    s = zs + jnp.einsum("iab,...kb->...kia", jnp.asarray(Mpow_np[1:]),
                        carry_in,
                        preferred_element_type=f32, precision=hi)
    return s.reshape(*w.shape[:-2], KG * C2, n)[..., :K, :]


def _vec2_recurrence(M, w, C2: int = 128, M_np=None):
    """s_k = M s_{k-1} + w_k with constant [2,2] M, s_{-1} = 0, w [..., K, 2].

    Same blocked scheme as the scalar case, on 2-vectors: within a chunk
    of C2 steps the zero-state response is one einsum against the masked
    power tensor  Lt2[j, i] = M^(i-j)  (a [C2, C2, 2, 2] constant), chunk
    carries recurse.  A K~22k associative scan of 2x2 matmuls was the
    last remaining while-loop in the compiled chain.
    ``M_np`` (a NumPy [2,2] mirror of M) makes the power tensors
    trace-time constants -- that case delegates to the n-dim solver
    (_vecn_recurrence); only the traced-M path (compile-time-unknown
    coefficients, e.g. fitted biquads) lives here.  A traced M may be
    f64: its powers are formed in M's dtype and cast to f32 once, as the
    concrete case's are.
    """
    if M_np is not None:
        return _vecn_recurrence(np.asarray(M_np), w, C2)
    f32 = jnp.float32
    K = w.shape[-2]
    if K <= 8:
        Mb = jnp.broadcast_to(M.astype(f32), (*w.shape[:-1], 2, 2))

        def combine(l, r):
            A1, v1 = l
            A2, v2 = r
            hi = jax.lax.Precision.HIGHEST
            return jnp.einsum("...ij,...jk->...ik", A2, A1,
                              preferred_element_type=f32, precision=hi), \
                jnp.einsum("...ij,...j->...i", A2, v1,
                           preferred_element_type=f32, precision=hi) + v2

        _, s = jax.lax.associative_scan(combine, (Mb, w), axis=w.ndim - 2)
        return s

    KG = -(-K // C2)
    pad = KG * C2 - K
    wp = jnp.pad(w, [(0, 0)] * (w.ndim - 2) + [(0, pad), (0, 0)])
    W = wp.reshape(*w.shape[:-2], KG, C2, 2)

    # M^0..M^C2 by associative scan over log C2 levels (tiny)
    Mb = jnp.broadcast_to(M, (C2, 2, 2))

    def mcomb(l, r):
        return jnp.einsum("...ij,...jk->...ik", r, l,
                          precision=jax.lax.Precision.HIGHEST)

    Mpow_w = jnp.concatenate([jnp.eye(2, dtype=M.dtype)[None],
                              jax.lax.associative_scan(mcomb, Mb, axis=0)])
    Mpow = Mpow_w.astype(f32)
    i = jnp.arange(C2)
    Lt2 = jnp.where((i[:, None] <= i[None, :])[..., None, None],
                    Mpow[jnp.clip(i[None, :] - i[:, None], 0, C2)], 0.0)

    zs = jnp.einsum("jiab,...kjb->...kia", Lt2, W,
                    preferred_element_type=f32,
                    precision=jax.lax.Precision.HIGHEST)   # [..., KG, C2, 2]

    # carries across super-chunks: e_m = M^C2 e_{m-1} + zs[m, -1]
    ends = zs[..., :, C2 - 1, :]                           # [..., KG, 2]
    e = _vec2_recurrence(Mpow_w[C2], ends, C2)             # [..., KG, 2]
    zero = jnp.zeros_like(e[..., :1, :])
    carry_in = jnp.concatenate([zero, e[..., :-1, :]], axis=-2)
    # fold: s[m, i] = zs[m, i] + M^(i+1) carry_in[m]
    s = zs + jnp.einsum("iab,...kb->...kia", Mpow[1:], carry_in,
                        preferred_element_type=f32,
                        precision=jax.lax.Precision.HIGHEST)
    return s.reshape(*w.shape[:-2], KG * C2, 2)[..., :K, :]


def _biquad_blocked(x, a1, a2, b0, b1, b2, state, C: int = _BLOCK_C):
    """Second-order recurrence as matmuls (block-parallel IIR).

    The full filter's truncated impulse response g[t] = b0 h[t] +
    b1 h[t-1] + b2 h[t-2] (h = recursive-part IR, h[0]=1) folds the
    numerator INTO the Toeplitz, so x feeds the GEMM directly -- no
    feed-forward pass, no x-history concatenate (two elementwise passes
    over the signal).  Chunks of C:

      * per-chunk zero-state response  z[k, i] = sum_{j<=i} g[i-j] x[k, j]
        = (X @ Ltg)[k, i]  -- one batched GEMM;
      * EVERY chunk's f[k, 0] / f[k, 1] reach back two samples into the
        previous chunk (chunk 0 into the carried x1, x2), contributing
        d0[k] h[i] + d1[k] h[i-1] with d0 = b1 x[k-1, C-1] + b2 x[k-1,
        C-2], d1 = b2 x[k-1, C-1] -- a per-chunk rank-2 update from two
        strided column reads, not a signal-wide pass;
      * the chunk-end pair (z[k, C-1], z[k, C-2]) drives the
        boundary-state recurrence s_k = M s_{k-1} + w_k (constant
        M = [[h[C], -a2 h[C-1]], [h[C-1], -a2 h[C-2]]], linearity of
        the ICs), resolved by _vec2_recurrence; the
        + s1 h[i+1] - s2 a2 h[i] fold is a fused elementwise epilogue.
    """
    f32 = jnp.float32
    x1, x2, y1, y2 = state
    T = x.shape[-1]
    batch = x.shape[:-1]
    concrete = all(isinstance(c, (int, float, np.floating))
                   for c in (a1, a2, b0, b1, b2))

    # truncated impulse response h[0..C] of y[t] = -a1 y[t-1] - a2 y[t-2].
    # Concrete coefficients: NumPy f64 recurrence, cast once -- a
    # trace-time constant.  Traced: f64 associative scan over
    # companion-matrix powers (not a C-step sequential lax.scan), cast once.
    if concrete:
        h64 = np.empty(C + 1, np.float64)
        h64[0] = 1.0
        hm1, hm2 = 1.0, 0.0
        for t in range(1, C + 1):
            cur = -float(a1) * hm1 - float(a2) * hm2
            h64[t] = cur
            hm2, hm1 = hm1, cur
        h = jnp.asarray(h64.astype(np.float32))
        # numerator-folded IR in f64, cast once
        g64 = float(b0) * h64
        g64[1:] += float(b1) * h64[:-1]
        g64[2:] += float(b2) * h64[:-2]
        g_np = g64.astype(np.float32)
        g = jnp.asarray(g_np)
    else:
        # Traced coefficients (fitting): the same f64 IR as the concrete
        # branch, cast once.  An f32 chain of companion-matrix powers
        # would drift in h by 26x the cast error on the CPU and 100x on
        # an H100, enough to set the filter's error: -89 and -83 dBFS vs
        # the exact response for a resonant biquad, against -104 and -98
        # with the f64 IR.
        f64 = jnp.float64
        a1d, a2d = jnp.asarray(a1, f64), jnp.asarray(a2, f64)
        A1 = jnp.stack([jnp.stack([-a1d, -a2d]),
                        jnp.asarray([1.0, 0.0], f64)])     # [2, 2]
        Ab = jnp.broadcast_to(A1, (C, 2, 2))

        def h_combine(l, r):
            return jnp.einsum("...ij,...jk->...ik", r, l,
                              precision=jax.lax.Precision.HIGHEST)

        Apow = jax.lax.associative_scan(h_combine, Ab, axis=0)  # A^1..A^C
        # h[t] = (A^t)[0, 0] applied to h-state [h0, h_-1] = [1, 0]
        h64 = jnp.concatenate([jnp.ones((1,), f64), Apow[:, 0, 0]])  # [C+1]
        zero1 = jnp.zeros((1,), f64)
        g64 = (jnp.asarray(b0, f64) * h64
               + jnp.asarray(b1, f64) * jnp.concatenate([zero1, h64[:-1]])
               + jnp.asarray(b2, f64) * jnp.concatenate(
                   [zero1, zero1, h64[:-2]]))
        h, g = h64.astype(f32), g64.astype(f32)
        g_np = None

    K = -(-T // C)
    pad = K * C - T
    xpad = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    X = xpad.reshape(*batch, K, C)

    hs = jnp.concatenate([jnp.zeros((1,), f32), h[:C - 1]])  # h[i-1], [C]

    # Everything the boundary recurrence needs from x comes out of ONE
    # [C, 4] side mat-vec: columns 0/1 are the chunk-end zero-state
    # responses z[k, C-1] / z[k, C-2] (reversed-g rows), columns 2/3
    # pick the raw samples x[k, C-1] / x[k, C-2] that the NEXT chunk's
    # numerator reaches back to (one-hots).  This replaces both the
    # materialized z (a signal-sized round-trip: z fed the epilogue
    # AND the w columns, which blocked output fusion) and the
    # stride-C column reads for the reach-back (a strided column touches
    # every sector of the array).
    if concrete:
        i = np.arange(C)
        Ltg = jnp.asarray(np.where(
            i[:, None] <= i[None, :],
            g_np[np.clip(i[None, :] - i[:, None], 0, C)], 0.0
        ).astype(np.float32))
        S_np = np.zeros((C, 4), np.float32)
        S_np[:, 0] = g_np[C - 1 - np.arange(C)]
        S_np[:C - 1, 1] = g_np[C - 2 - np.arange(C - 1)]
        S_np[C - 1, 2] = 1.0
        S_np[C - 2, 3] = 1.0
        S = jnp.asarray(S_np)
    else:
        i = jnp.arange(C)
        Ltg = jnp.where(i[:, None] <= i[None, :],
                        g[jnp.clip(i[None, :] - i[:, None], 0, C)], 0.0)
        S = jnp.stack(
            [g[C - 1 - jnp.arange(C)],
             jnp.concatenate([g[C - 2 - jnp.arange(C - 1)],
                              jnp.zeros((1,), f32)]),
             jnp.zeros((C,), f32).at[C - 1].set(1.0),
             jnp.zeros((C,), f32).at[C - 2].set(1.0)], axis=-1)
    side = jnp.einsum("...kc,cj->...kj", X, S,
                      preferred_element_type=f32,
                      precision=jax.lax.Precision.HIGHEST)  # [..., K, 4]

    # cross-chunk numerator corrections: f[k, 0] reaches b1 x[k-1, C-1]
    # + b2 x[k-1, C-2] and f[k, 1] reaches b2 x[k-1, C-1] (chunk 0 uses
    # the carried x1, x2) -- a per-chunk rank-2 update d0[k] h[i] +
    # d1[k] h[i-1], fused epilogues, never a signal-wide pass.
    x1b = jnp.broadcast_to(jnp.asarray(x1, f32), batch)[..., None]
    x2b = jnp.broadcast_to(jnp.asarray(x2, f32), batch)[..., None]
    xlast1 = jnp.concatenate([x1b, side[..., :-1, 2]], axis=-1)  # [..., K]
    xlast2 = jnp.concatenate([x2b, side[..., :-1, 3]], axis=-1)  # [..., K]
    d0 = b1 * xlast1 + b2 * xlast2                         # [..., K]
    d1 = b2 * xlast1                                       # [..., K]

    w = jnp.stack([side[..., :, 0] + d0 * h[C - 1] + d1 * h[C - 2],
                   side[..., :, 1] + d0 * h[C - 2] + d1 * h[C - 3]],
                  axis=-1)

    # boundary-state recurrence s_k = M s_{k-1} + w_k over K chunks
    if concrete:
        M_np = np.asarray(
            [[h64[C], -float(a2) * h64[C - 1]],
             [h64[C - 1], -float(a2) * h64[C - 2]]], np.float32)
        M = jnp.asarray(M_np)
    else:
        M_np = None
        M = jnp.stack([jnp.stack([h64[C], -a2d * h64[C - 1]]),
                       jnp.stack([h64[C - 1], -a2d * h64[C - 2]])])  # f64
    M32 = M.astype(f32)
    s0 = jnp.stack([jnp.broadcast_to(jnp.asarray(y1, f32), batch),
                    jnp.broadcast_to(jnp.asarray(y2, f32), batch)],
                   axis=-1)                                # [..., 2]
    w = w.at[..., 0, :].add(jnp.einsum("ij,...j->...i", M32, s0,
                                       precision=jax.lax.Precision.HIGHEST))
    s = _vec2_recurrence(M, w, M_np=M_np)
    # carry INTO chunk k is s_{k-1} (s0 for k = 0)
    s_in = jnp.concatenate([s0[..., None, :], s[..., :-1, :]], axis=-2)

    # fold: zero-state response emitted by the y-GEMM (its ONLY
    # consumer, so XLA output-fuses the epilogues; no z round-trip),
    # + IC response + cross-chunk numerator corrections
    y = (jnp.einsum("...kc,cd->...kd", X, Ltg,
                    preferred_element_type=f32,
                    precision=jax.lax.Precision.HIGHEST)
         + s_in[..., :, 0:1] * h[1:][None, :]
         - a2 * s_in[..., :, 1:2] * h[:-1][None, :]
         + d0[..., :, None] * h[:C][None, :]
         + d1[..., :, None] * hs[None, :])
    y = y.reshape(*batch, K * C)[..., :T].astype(f32)

    x1n = x[..., -1]
    x2n = x[..., -2] if T >= 2 else jnp.broadcast_to(
        jnp.asarray(x1, f32), batch)
    new_state = (x1n, x2n, y[..., -1], y[..., -2])
    return y, new_state


def _biquad_sequential(x, a1, a2, b0, b1, b2, state):
    """Per-sample f32 loop with the biquad crate's exact op order:
    out = b0*x + b1*x1 + b2*x2 - a1*y1 - a2*y2 (DirectForm1::run)."""
    f32 = jnp.float32
    a1, a2, b0, b1, b2 = (jnp.asarray(c, f32) for c in (a1, a2, b0, b1, b2))
    x1, x2, y1, y2 = state

    def step(carry, xt):
        x1, x2, y1, y2 = carry
        out = (_mul_unfused(b0, xt) + _mul_unfused(b1, x1)
               + _mul_unfused(b2, x2) - _mul_unfused(a1, y1)
               - _mul_unfused(a2, y2))
        return (xt, x1, out, y1), out

    carry, ys = jax.lax.scan(step, (x1, x2, y1, y2), _move_time_first(x))
    return _move_time_last(ys), carry
