"""Stateless combinator nodes: Gain, Add, Mix, Mux, Demux.

These are single-expression elementwise ops; XLA fuses chains of them into
one kernel, so each costs ~zero beyond the memory traffic of its neighbors.
"""

from __future__ import annotations

import jax.numpy as jnp

from dsp_stuff_tpu.registry import register_node, ParamSpec, SelectSpec


@register_node(
    title="Gain", cfg_name="gain", description="Adjust gain of a signal",
    inputs=("in",), outputs=("out",),
    params=(ParamSpec("level", 0.0, 10.0, 1.0, as_input=True),),
)
class Gain:
    """out[i] = in[i] * level[i] (gain.rs:27-38)."""

    @staticmethod
    def process_seq(params, state, inputs):
        # exact_mul: under the 'exact' policy a bare trailing f32 multiply
        # would FMA-contract into the CONSUMER's fan-in add (one rounding
        # where the reference has two); order-protect it at the producer
        from dsp_stuff_tpu.utils.precision import exact_mul
        return {"out": exact_mul(inputs["in"], params["level"])}, state


@register_node(
    title="add", cfg_name="add", description="add two signals together",
    inputs=("a", "b"), outputs=("out",),
)
class Add:
    """out = a + b (add.rs:24-34)."""

    @staticmethod
    def process_seq(params, state, inputs):
        return {"out": inputs["a"] + inputs["b"]}, state


@register_node(
    title="Mix", cfg_name="mix", description="Mix two signals together",
    inputs=("a", "b"), outputs=("out",),
    params=(ParamSpec("ratio", 0.0, 1.0, 0.5, as_input=True,
                      label="Ratio (a:b)"),),
)
class Mix:
    """out = b*ratio + a*(1-ratio) (mix.rs:33-47).  Both products are
    order-protected under 'exact' so XLA cannot FMA-contract one of them
    into the central add (rustc emits three separate roundings)."""

    @staticmethod
    def process_seq(params, state, inputs):
        from dsp_stuff_tpu.utils.precision import exact_mul
        # 1 - r must be an F32 subtraction: the reference reads the f32
        # ratio atomic and subtracts in f32 (mix.rs:33-47).  With a
        # concrete Python-float ratio, `1.0 - r` would compute in f64 and
        # round differently for ~half of all ratios (1 ulp; caught by the
        # exact-policy bitwise fuzz).
        r = jnp.asarray(params["ratio"], jnp.float32)
        return {"out": exact_mul(inputs["b"], r)
                + exact_mul(inputs["a"], jnp.float32(1.0) - r)}, state


@register_node(
    title="mux", cfg_name="mux", description="Toggle between two input signals",
    inputs=("a", "b"), outputs=("out",),
    params=(SelectSpec("in_port", ("A", "B"), "A"),),
)
class Mux:
    """Copy the selected input (mux.rs:44-55); selection is a static param."""

    @staticmethod
    def process_seq(params, state, inputs):
        src = inputs["a"] if params["in_port"] == "A" else inputs["b"]
        return {"out": src}, state


@register_node(
    title="demux", cfg_name="demux",
    description="Toggle between two output signals",
    inputs=("in",), outputs=("a", "b"),
    params=(SelectSpec("out_port", ("A", "B"), "A"),),
)
class Demux:
    """Copy input to the selected output; the other output stays silent
    (demux.rs:44-58 -- the unselected buffer is simply left zeroed)."""

    @staticmethod
    def process_seq(params, state, inputs):
        x = inputs["in"]
        zero = jnp.zeros_like(x)
        if params["out_port"] == "A":
            return {"a": x, "b": zero}, state
        return {"a": zero, "b": x}, state
