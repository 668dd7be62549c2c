"""Global precision policy.

The reference computes in f32 with strictly sequential per-sample loops
(e.g. low_pass.rs:36-41, biquad.rs:87) and accumulates FIR dot products in
f64 (fir.rs:204-216).  Vectorizing those recurrences as associative scans
reassociates floating-point ops, which changes rounding.  The policy decides
how the lowered kernels trade accuracy against speed:

* ``fast``    -- f32 everywhere, associative scans for all linear
                 recurrences.  The throughput mode.
* ``parity``  -- f64 internals for linear-recurrence scans and FIR
                 accumulation; sequential semantics where a recurrence is
                 not associative (envelope follower).  Matches the Rust
                 reference to <= -90 dBFS on supported graphs.
* ``exact``   -- strictly sequential f32 evaluation (lax.scan per sample)
                 for recurrences, bit-matching the reference's operation
                 order everywhere except transcendental functions (on the
                 CPU and on an H100 alike: products and quotients go
                 through the f64 fences below).  Slow; for verification
                 only.

The policy is consulted at trace time, so it must be set before
``compile_graph``/``jax.jit`` tracing happens.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax

# f64 support must be on for parity/exact internals; f32 remains the default
# interchange dtype everywhere.
jax.config.update("jax_enable_x64", True)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    name: str
    # dtype used inside linear-recurrence associative scans
    scan_internal_dtype: str = "float32"
    # dtype used for FIR / convolution accumulation (reference uses f64,
    # fir.rs:204-216)
    fir_accum_dtype: str = "float64"
    # evaluate recurrences strictly sequentially (bit-order parity)
    sequential_recurrences: bool = False


FAST = PrecisionPolicy("fast", scan_internal_dtype="float32",
                       fir_accum_dtype="float32",
                       sequential_recurrences=False)
PARITY = PrecisionPolicy("parity", scan_internal_dtype="float64",
                         fir_accum_dtype="float64",
                         sequential_recurrences=False)
EXACT = PrecisionPolicy("exact", scan_internal_dtype="float32",
                        fir_accum_dtype="float64",
                        sequential_recurrences=True)

_POLICIES = {p.name: p for p in (FAST, PARITY, EXACT)}

_current = PARITY


def get_policy() -> PrecisionPolicy:
    return _current


def set_policy(p: str | PrecisionPolicy) -> PrecisionPolicy:
    global _current
    if isinstance(p, str):
        p = _POLICIES[p]
    _current = p
    return p


@contextlib.contextmanager
def policy(p: str | PrecisionPolicy):
    prev = get_policy()
    set_policy(p)
    try:
        yield get_policy()
    finally:
        set_policy(prev)


# -- bit-exactness primitives (the 'exact' policy's defense against XLA's
#    value-changing rewrites; rustc contracts nothing by default, so the
#    reference is always separate mul/add/div roundings) ---------------------

def mul_unfused(a, b):
    """f32 multiply that cannot be FMA-contracted with a following add/sub.

    XLA's backends contract ``a*b + c`` into a single-rounding fma at the
    LLVM level (a bare lax.optimization_barrier does not reliably prevent
    it -- barriers may be dropped late, after which the simplifier's
    convert_f32(mul_f64(convert(a), convert(b))) -> mul_f32 rewrite
    re-exposes the contraction), while the Rust reference compiles to
    separate mul and add roundings.  The proven fence: compute the
    product exactly in f64 (53 bits >= 2*24+2, Figueroa), round it onto
    the f32 grid with ``lax.reduce_precision`` -- a semantic op the
    simplifier never removes -- and convert (the single rounding is
    bit-identical to an unfused f32 multiply).

    Operands are rounded onto the f32 grid FIRST (``f32_grid``): a Python
    float carries f64 precision the reference's f32 math never sees, and
    XLA:GPU may keep an f32 operand in excess precision when it feeds the
    f64 convert (measured on an H100: a constant ``depth * sr`` product
    lost its f32 rounding and moved a quarter of the chorus sweep by
    1 ulp)."""
    import jax.numpy as jnp
    p = jax.lax.reduce_precision(f32_grid(a) * f32_grid(b), exponent_bits=8,
                                 mantissa_bits=23)
    return p.astype(jnp.float32)


def f32_grid(v):
    """``v`` rounded onto the f32 grid, as f64.  The rounding is a
    ``reduce_precision``, a semantic op that no excess-precision rewrite
    removes, where a bare ``astype(float32)`` feeding an f64 consumer may
    be elided by XLA:GPU."""
    import jax.numpy as jnp
    return jax.lax.reduce_precision(
        jnp.asarray(v, jnp.float32).astype(jnp.float64),
        exponent_bits=8, mantissa_bits=23)


def div_ieee(a, b):
    """Correctly rounded f32 division, immune to XLA's divide rewrites.

    Three things break bitwise parity with the reference's plain f32
    divides: ``x / const -> x * (1/const)`` (recip-mul, ~1 ulp),
    ``(x/b)/c -> x/(b*c)`` (divide-chain fusion -- one rounding fewer, and
    fan-in scalings after every node make divide chains ubiquitous), and
    XLA:GPU's f32 divide itself, which is not correctly rounded (about a
    quarter of random quotients land 1 ulp off on an H100).  The quotient
    is therefore computed in f64 and rounded once onto the f32 grid, the
    same fence as ``mul_unfused`` (53 >= 2*24 + 1 bits make the double
    rounding innocuous, Figueroa); the divisor hides behind
    ``optimization_barrier`` so no constant reaches the recip-mul rule,
    and the f64 round trip hides the inner divide of a chain from the
    outer one's pattern match."""
    import jax.numpy as jnp
    b = jax.lax.optimization_barrier(jnp.asarray(b, jnp.float32))
    q = jax.lax.reduce_precision(f32_grid(a) / f32_grid(b), exponent_bits=8,
                                 mantissa_bits=23)
    return q.astype(jnp.float32)


def exact_mul(a, b):
    """a*b, order-protected (mul_unfused) under the 'exact' policy."""
    if get_policy().sequential_recurrences:
        return mul_unfused(a, b)
    import jax.numpy as jnp
    return jnp.asarray(a, jnp.float32) * jnp.asarray(b, jnp.float32)


def exact_div(a, b):
    """a/b, rewrite-protected (div_ieee) under the 'exact' policy."""
    if get_policy().sequential_recurrences:
        return div_ieee(a, b)
    import jax.numpy as jnp
    return jnp.asarray(a, jnp.float32) / jnp.asarray(b, jnp.float32)
