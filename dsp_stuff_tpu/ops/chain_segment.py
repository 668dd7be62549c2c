"""Fused chain segments: linear cascades + elementwise shapers + feedback
combs composed as ONE op over a maximal sole-consumer run of nodes.

The reference runs every node as its own task (runtime.rs:718-728); the
linear-run fusion (ops/cascade.py) already collapses adjacent LINEAR
nodes.  A chain segment goes further: the compiler plans the whole run
as one stage list, folding the fan-in scales between members into it
(a fan-in divide is otherwise a full-signal pass of its own), and this
module evaluates the list stage by stage through the per-op lowerings,
so XLA sees one straight-line program to fuse.

Stage descriptors (static tuples; the compiler builds them in
``_plan_mega_fusion`` / ``_mega_run_eval``):

    ("cascade", sections)     -- ops/cascade section tuple; state: the
                                 composite delayed state [..., N]
    ("scale", h)              -- the link fan-in scale between nodes
    ("ew", kind, params)      -- stateless elementwise shaper; kind is
                                 "overdrive" | "chebyshev" |
                                 "distort:<Mode>" (ops/shaping.py)
    ("comb", decay, D)        -- feedback comb y[n] = x[n] + d*y[n-D]
                                 (reverb.rs:87-105); state: history
                                 [..., D] (newest last)
    ("tap", ti)               -- emit the current flow as output
                                 sequence ti (an intermediate node
                                 output with extra consumers — the
                                 reference's fan-out duplication,
                                 node.rs:321-325; a mid-chain tap no
                                 longer splits the segment in two)
    ("mtap", mix, L, NH, EV, RS)
                              -- sine-modulated fractional-delay tap
                                 (the chorus, ops/modfx.py) on the
                                 stage input; state: FOUR entries
                                 (hist [..., L], then the SHARED
                                 trajectory operands q [T//128] int32,
                                 r [T] int32, frac [T] f32 from
                                 modfx.mtap_shared — stream-independent
                                 by the lockstep clock, so they must
                                 NOT be broadcast under vmap).  NH/EV/
                                 RS from modfx.mtap_static.

``chain_segment(x, stages, state_in)`` returns
``(y, cascade_infos, comb_hists, taps)``:

    cascade_infos -- per cascade stage (s_tm1, s_tm2, x_tm1, x_tm2),
                     everything ops/cascade.cascade_state_out needs;
    comb_hists    -- per comb stage the new [..., D] history;
    taps          -- tuple of [..., T] emitted sequences, tap order.

The composition is plain differentiable JAX: it batches under vmap
(the mtap trajectory operands stay unbatched, as the lockstep clock
computes them) and differentiates without a custom rule.
"""

from __future__ import annotations

import jax.numpy as jnp

from dsp_stuff_tpu.ops import shaping
from dsp_stuff_tpu.ops.cascade import linear_cascade
from dsp_stuff_tpu.ops.delay_line import feedback_comb


def _ew_fn(kind: str):
    if kind == "overdrive":
        return lambda v, boost, drive, level: shaping.overdrive(
            v, boost, drive, level)
    if kind == "chebyshev":
        return lambda v, lp, ln: shaping.chebyshev_asym(v, lp, ln)
    if kind.startswith("distort:"):
        mode = kind.split(":", 1)[1]
        fn = shaping.DISTORT_MODES[mode]
        if mode == "Fuzz":
            return lambda v, level: shaping.fuzz(v, level, 128)
        return lambda v, level: fn(v, level)
    raise ValueError(f"unknown elementwise stage kind {kind!r}")


def apply_ew(kind: str, v, params):
    """One elementwise stage on ``v`` (chain segments and the cycle
    block program share it)."""
    return _ew_fn(kind)(v, *(jnp.float32(p) for p in params))


def chain_segment(x, stages, state_in):
    """Fused evaluation of a stage chain over ``x`` [..., T] (see the
    module docstring for the stage grammar and returns): a stage-by-stage
    composition of the per-op lowerings."""
    f32 = jnp.float32
    v = jnp.asarray(x, f32)
    si = 0
    cinfos = []
    hists = []
    n_t = sum(1 for st in stages if st[0] == "tap")
    taps = [None] * n_t
    for st in stages:
        if st[0] == "cascade":
            s0 = state_in[si]
            si += 1
            x_tm1, x_tm2 = v[..., -1], v[..., -2]
            v, s_tm1, s_tm2 = linear_cascade(v, st[1], s0)
            cinfos.append((s_tm1, s_tm2, x_tm1, x_tm2))
        elif st[0] == "scale":
            v = v * f32(st[1])
        elif st[0] == "ew":
            v = apply_ew(st[1], v, st[2])
        elif st[0] == "comb":
            hist = state_in[si]
            si += 1
            v, nh = feedback_comb(v, st[1], st[2], hist)
            hists.append(nh)
        elif st[0] == "mtap":
            from dsp_stuff_tpu.ops.modfx import mtap_apply
            hist, q, r, fr = state_in[si:si + 4]
            si += 4
            v, nh = mtap_apply(v, hist, q, r, fr, st[1])
            hists.append(nh)
        elif st[0] == "tap":
            taps[st[1]] = v
        else:
            raise ValueError(f"unknown stage {st[0]!r}")
    return v, tuple(cinfos), tuple(hists), tuple(taps)
