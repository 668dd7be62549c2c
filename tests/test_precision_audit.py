"""Precision audit of the render path.

On an NVIDIA GPU a float32 contraction without an explicit precision may
run in TF32 (10 mantissa bits), far outside the fast policy's bound.  So
every f32 ``dot_general`` / ``conv_general_dilated`` that a compiled
preset traces must carry an explicit precision other than DEFAULT.  The
audit traces each benchmark graph batched under the fast and parity
policies (tracing only: nothing compiles).
"""

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

import dsp_stuff_tpu as dst
from dsp_stuff_tpu.models import PRESETS, chain10
from dsp_stuff_tpu.utils import precision

CONTRACTIONS = ("dot_general", "conv_general_dilated")
GRAPHS = {"chain10": chain10, **PRESETS}


def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _contractions(jaxpr):
    """(primitive name, operand dtypes, precision) of every contraction,
    sub-jaxprs (scan/cond/jit/custom rules) included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in CONTRACTIONS:
            yield (eqn.primitive.name,
                   tuple(v.aval.dtype for v in eqn.invars),
                   eqn.params.get("precision"))
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from _contractions(sub)


def _is_explicit(prec) -> bool:
    if prec is None:
        return False
    precs = prec if isinstance(prec, tuple) else (prec,)
    return all(p is not None and p != jax.lax.Precision.DEFAULT
               for p in precs)


def _traced_render(name, policy, B=2, T=4096):
    g, meta = GRAPHS[name]()
    with precision.policy(policy):
        cg = dst.compile_graph(g)
        ext = {str(meta["input"]): jnp.zeros((B, T), jnp.float32)}
        fn = jax.vmap(cg.fn, in_axes=(cg.state_axes(), 0, None),
                      out_axes=(cg.state_axes(), 0, 0))
        state = cg.broadcast_state(cg.init_state(), (B,))
        return jax.make_jaxpr(fn)(state, ext, None).jaxpr


@pytest.mark.parametrize("policy", ["fast", "parity"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_no_default_precision_f32_contraction(name, policy):
    found = list(_contractions(_traced_render(name, policy)))
    loose = [(prim, dts) for prim, dts, prec in found
             if jnp.float32 in dts and not _is_explicit(prec)]
    assert not loose, f"{name}/{policy}: default-precision f32 {loose}"


@pytest.mark.parametrize("policy", ["fast", "parity"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_no_default_precision_f32_contraction_long(name, policy):
    """At batch-render length (10 s) the size-gated lowerings trace too:
    the chunked envelope (T > 2 x 32768), the chorus barrel path and
    long-signal overlap-save FIRs."""
    found = list(_contractions(_traced_render(name, policy, T=480_000)))
    loose = [(prim, dts) for prim, dts, prec in found
             if jnp.float32 in dts and not _is_explicit(prec)]
    assert not loose, f"{name}/{policy}: default-precision f32 {loose}"


@pytest.mark.parametrize("name", ["chain10", "config5"])
def test_no_default_precision_f32_contraction_fit_step(name):
    """The fitting step traces the sliders (no trace-time constants), so
    it reaches the traced-coefficient solvers and their backward pass."""
    from dsp_stuff_tpu.train.fit import make_train_step
    g, meta = GRAPHS[name]()
    B, T = 2, 4096
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        step, opt_init = make_train_step(cg)
        params = cg.init_params()
        ext = {str(meta["input"]): jnp.zeros((B, T), jnp.float32)}
        target = jnp.zeros((B, len(cg.output_ids), T), jnp.float32)
        jaxpr = jax.make_jaxpr(step)(params, opt_init(params),
                                     cg.init_state(), ext, target).jaxpr
    loose = [(prim, dts) for prim, dts, prec in _contractions(jaxpr)
             if jnp.float32 in dts and not _is_explicit(prec)]
    assert not loose, f"{name}/fit: default-precision f32 {loose}"


def test_audit_sees_a_default_precision_dot():
    """The walker finds a contraction nested in a scan, and flags one
    left at default precision."""
    def f(x):
        def body(c, row):
            return c, row @ jnp.ones((4, 4), jnp.float32)
        return jax.lax.scan(body, 0.0, x)[1]

    jaxpr = jax.make_jaxpr(f)(np.zeros((3, 4), np.float32)).jaxpr
    found = list(_contractions(jaxpr))
    assert [p for p, _, _ in found] == ["dot_general"]
    assert not _is_explicit(found[0][2])
    assert _is_explicit((jax.lax.Precision.HIGHEST,) * 2)
