"""Filter nodes: BiQuad, LowPass, HighPass, Envelope, Fir."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from dsp_stuff_tpu.registry import register_node, ParamSpec, SelectSpec, FieldSpec
from dsp_stuff_tpu.ops.scan import first_order_affine, biquad_df1, \
    _first_order_sequential
from dsp_stuff_tpu.ops.fir import fir_apply, init_fir_state
from dsp_stuff_tpu.ops.envelope import peak_envelope
from dsp_stuff_tpu.utils.precision import get_policy


@register_node(
    title="Biquad", cfg_name="biquad", description="Generic biquad filter",
    inputs=("in",), outputs=("out",),
    params=(
        ParamSpec("a0", -10.0, 10.0, 1.0),
        ParamSpec("a1", -10.0, 10.0, -0.24),
        ParamSpec("a2", -10.0, 10.0, 0.0),
        ParamSpec("b0", -10.0, 10.0, 0.758),
        ParamSpec("b1", -10.0, 10.0, 0.0),
        ParamSpec("b2", -10.0, 10.0, 0.0),
    ),
)
class BiQuad:
    """DirectForm1 biquad; all coefficients are divided by a0 when settings
    change (biquad.rs:62-76), and the 4-sample IIR state resets on every
    slider change (biquad.rs:74).  Offline, params are static per render, so
    state is fresh at t=0 -- matching a just-restored reference node (its
    restore path also runs regenerate_filter, derive lib.rs:319-325)."""

    @staticmethod
    def init_state(cfg, block_size):
        z = jnp.float32(0.0)
        return {"x1": z, "x2": z, "y1": z, "y2": z}

    @staticmethod
    def process_seq(params, state, inputs):
        # f32 division by a0 as in regenerate_filter (biquad.rs:64-71).
        # With concrete sliders (the normal case) the division happens in
        # NumPy f32 (identical IEEE rounding) so biquad_df1 receives
        # concrete coefficients and builds its impulse-response/Toeplitz
        # constants at trace time; traced (fitted) params keep jnp.
        import jax
        raw = [params[k] for k in ("a0", "a1", "a2", "b0", "b1", "b2")]
        if any(isinstance(v, jax.core.Tracer) for v in raw):
            a0 = jnp.asarray(raw[0], jnp.float32)
            a1, a2, b0, b1, b2 = (jnp.asarray(v, jnp.float32) / a0
                                  for v in raw[1:])
        else:
            import numpy as np
            a0 = np.float32(raw[0])
            a1, a2, b0, b1, b2 = (np.float32(np.float32(v) / a0)
                                  for v in raw[1:])
        y, (x1, x2, y1, y2) = biquad_df1(
            inputs["in"], a1, a2, b0, b1, b2,
            (state["x1"], state["x2"], state["y1"], state["y2"]))
        return {"out": y}, {"x1": x1, "x2": x2, "y1": y1, "y2": y2}


@register_node(
    # The reference's LowPass declares cfg_name = "high_pass" (low_pass.rs:9)
    # so its saves restore as HighPass over there (nodes/mod.rs:119).  We
    # write the unambiguous name, which the reference RESTORE table also
    # accepts (nodes/mod.rs:118); reads of "high_pass" resolve to HighPass
    # here exactly as there.
    title="Low Pass", cfg_name="low_pass",
    description="Attenuates higher frequencies",
    inputs=("in",), outputs=("out",),
    params=(ParamSpec("ratio", 0.0, 1.0, 0.5),),
)
class LowPass:
    """y[i] = x[i]*(1-r) + r*z; z = y[i] (low_pass.rs:36-41)."""

    @staticmethod
    def init_state(cfg, block_size):
        return {"z": jnp.float32(0.0)}

    @staticmethod
    def process_seq(params, state, inputs):
        # pass the RAW param as the coefficient: a Python float (the
        # normal, non-fitted case) lets first_order_affine build its
        # Toeplitz tap matrix as a trace-time constant -- converting to a
        # jnp array first would hand it a tracer and put per-call
        # cumprod/where ops inside every feedback-cycle block
        r = params["ratio"]
        rj = jnp.asarray(r, jnp.float32)
        b = inputs["in"] * (jnp.float32(1.0) - rj)
        y = first_order_affine(r, b, state["z"])
        return {"out": y}, {"z": y[..., -1]}


@register_node(
    title="High Pass", cfg_name="high_pass",
    description="Attenuates lower frequencies",
    inputs=("in",), outputs=("out",),
    params=(ParamSpec("ratio", 0.0, 1.0, 0.5),),
)
class HighPass:
    """z = x*(1-r) + r*z; y = x - z (high_pass.rs:36-41)."""

    @staticmethod
    def init_state(cfg, block_size):
        return {"z": jnp.float32(0.0)}

    @staticmethod
    def process_seq(params, state, inputs):
        x = inputs["in"]
        r = params["ratio"]                 # raw: see LowPass note
        rj = jnp.asarray(r, jnp.float32)
        z = first_order_affine(r, x * (jnp.float32(1.0) - rj), state["z"])
        return {"out": x - z}, {"z": z[..., -1]}


@register_node(
    title="Envelope", cfg_name="envelope", description="Envelope detection",
    inputs=("in",), outputs=("out",),
    params=(
        ParamSpec("attack", 0.0, 1000.0, 0.0),
        ParamSpec("release", 0.0, 1000.0, 0.0),
    ),
)
class Envelope:
    """dasp_envelope full-wave peak detector (envelope.rs:43-51); attack and
    release are frame counts re-applied every block."""

    @staticmethod
    def init_state(cfg, block_size):
        return {"env": jnp.float32(0.0)}

    @staticmethod
    def process_seq(params, state, inputs):
        # clamp to the slider's physical range (envelope.rs sliders are
        # 0..1000 frames; the reference can never see values outside it):
        # a fitted/modulated frame count < 0 would make
        # gain_from_frames(f) = exp(-1/f) > 1 -- an amplifying, divergent
        # recurrence the real node cannot express
        atk = jnp.clip(jnp.asarray(params["attack"], jnp.float32),
                       0.0, 1000.0)
        rel = jnp.clip(jnp.asarray(params["release"], jnp.float32),
                       0.0, 1000.0)
        y, env = peak_envelope(inputs["in"], atk, rel, state["env"])
        return {"out": y}, {"env": env}


@register_node(
    title="FIR Filter", cfg_name="fir", description="Perform a FIR operation",
    inputs=("in",), outputs=("out",),
    params=(
        SelectSpec("mode", ("Average", "Balanced"), "Balanced"),
        FieldSpec("file_name", None),
        # stored REVERSED, as the reference saves them (fir.rs:160-170);
        # persisted inside the graph JSON (fir.rs:58-62)
        FieldSpec("taps", (1.0,)),
    ),
)
class Fir:
    """Direct-form FIR over a loaded impulse response (fir.rs:179-225),
    f64 accumulation, with the reference's warm-up quirk (see ops/fir.py).

    The global sample counter ``n_seen`` is LOCKSTEP state (all streams
    of a batched render advance together), so it stays a shared scalar
    under vmap — which keeps the warm-up machinery's gathers on shared
    1-D indices (whole-row fetches instead of per-element gathers)."""

    shared_state_keys = ("n_seen",)

    @staticmethod
    def init_state(cfg, block_size):
        hist, first, n_seen = init_fir_state(len(cfg["taps"]))
        return {"hist": hist, "first": first, "n_seen": n_seen}

    @staticmethod
    def process_seq(params, state, inputs):
        taps_rev = np.asarray(params["taps"], np.float64)
        divisor = np.float32(1.0 / taps_rev.size) \
            if params["mode"] == "Average" else np.float32(1.0)
        y, (hist, first, n_seen) = fir_apply(
            inputs["in"], taps_rev,
            (state["hist"], state["first"], state["n_seen"]), divisor)
        return {"out": y}, {"hist": hist, "first": first, "n_seen": n_seen}
