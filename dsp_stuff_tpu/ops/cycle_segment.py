"""Fused feedback cycles: a whole chain-shaped SCC body as ONE op.

The compiler lowers a feedback SCC whose members are all supported
(add/mix/gain/low_pass/high_pass/biquad/reverb + stateless shapers at
base rate) to a static BLOCK PROGRAM over 128-sample blocks; this module
executes the program as a ``lax.scan`` over the blocks (differentiable,
the semantic mirror of the compiler's per-node cycle scan, compile.py
_eval_cycle) with every carried quantity -- one-block-delayed member
outputs (REGISTERS), cascade composite states, comb delay rings -- in
the scan carry.

Program grammar (static tuples; built by compile.py _plan_cycle_program):

    ("join", terms, scale)          flow := (sum of term values) * scale
    ("lin2", tA, sA, tB, sB, cA, cB)
                                    flow := (sum tA)*sA*cA + (sum tB)*sB*cB
                                    (add: cA=cB=1; mix: cA=1-r, cB=r —
                                    mix.rs:33-47, add.rs:24-34)
    ("cascade", sections, ci)       ops/cascade composed linear run
    ("comb", decay, D, bi)          y[n] = x[n] + d*y[n-D] (reverb.rs:87-105)
    ("ew", kind, params)            stateless shaper (ops/shaping.py)
    ("scale", s)                    flow := flow * s
    ("setreg", ri)                  register ri := flow (read next block —
                                    or later this block — by join terms)
    ("tap", ti)                     emit flow as output sequence ti

    term := ("ext", ei) | ("reg", ri)

Back edges read a register BEFORE its writer runs in the block, i.e. the
previous block's value — exactly the reference's emergent one-block
feedback latency (runtime.rs:718-728).  Fan-in scales multiply by the
f32 reciprocal of (n + 1e-4) rather than divide — the documented 1-ulp
fast-policy class (the cycle program only ever runs under ``fast``).

``cycle_segment(exts, regs0, states, program, n_taps)`` returns
``(taps, regs_f, cinfos, hists)``:

    taps   -- tuple of [.., T] emitted sequences, tap-index order;
    regs_f -- tuple of [.., C] final register values (the next render's
              one-block-delay carry);
    cinfos -- per cascade stage (s_tm1, s_tm2, x_tm1, x_tm2) for
              ops/cascade.cascade_state_out;
    hists  -- per comb stage the new [.., D] history (oldest first).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dsp_stuff_tpu.ops.cascade import (_cascade_constants,
                                       cascade_tail_states)
from dsp_stuff_tpu.ops.chain_segment import apply_ew

C = 128


def _casc_step(sections: tuple, blk, carry):
    """One 128-block cascade step: (y, new_carry) — the same blocked
    math as ops/cascade.linear_cascade restricted to one chunk (Ltg taps
    GEMM + ends + f32 carry algebra, all at HIGHEST)."""
    f32 = jnp.float32
    hi = jax.lax.Precision.HIGHEST
    Ltg, W, E, P, N, B, _ = _cascade_constants(sections, C, ())
    AC = P[C].astype(np.float32)
    y = (jnp.einsum("...c,cd->...d", blk, jnp.asarray(Ltg),
                    preferred_element_type=f32, precision=hi)
         + jnp.einsum("...b,db->...d", carry, jnp.asarray(E),
                      preferred_element_type=f32, precision=hi))
    newc = (jnp.einsum("...c,cb->...b", blk, jnp.asarray(W),
                       preferred_element_type=f32, precision=hi)
            + jnp.einsum("ij,...j->...i", jnp.asarray(AC), carry,
                         preferred_element_type=f32, precision=hi))
    return y, newc


def cycle_segment(exts, regs0, states, program, n_taps: int):
    """Fused evaluation of a feedback-cycle block program (see the module
    docstring for the grammar and returns): a lax.scan over
    nb = T // 128 blocks."""
    program = tuple(program)
    f32 = jnp.float32
    exts = tuple(jnp.asarray(e, f32) for e in exts)
    T = exts[0].shape[-1] if exts else regs0[0].shape[-1] * 0
    assert T % C == 0, T
    nb = T // C
    batch = exts[0].shape[:-1] if exts else regs0[0].shape[:-1]
    n_t = 1 + max((ins[1] for ins in program if ins[0] == "tap"),
                  default=-1)

    casc_secs = [ins[1] for ins in program if ins[0] == "cascade"]
    si = 0
    casc0 = []
    hist0 = []
    for ins in program:
        if ins[0] == "cascade":
            s0 = jnp.asarray(states[si], f32)
            si += 1
            # pad to the embedded carry dim (callers may pass the raw
            # composite dim; the constants work in the embedding)
            N = _cascade_constants(ins[1], C, ())[4]
            if s0.shape[-1] < N:
                s0 = jnp.pad(s0, [(0, 0)] * (s0.ndim - 1)
                             + [(0, N - s0.shape[-1])])
            casc0.append(s0)
        elif ins[0] == "comb":
            hist0.append(jnp.asarray(states[si], f32))
            si += 1

    ext_blks = tuple(jnp.moveaxis(e.reshape(*batch, nb, C), -2, 0)
                     for e in exts)
    # cascade handoff snapshots: (carry entering the block, block input)
    snaps0 = tuple((c, jnp.zeros((*batch, C), f32)) for c in casc0)

    def body(carry, xs):
        regs, ccs, hists, _snaps = carry
        regs = list(regs)
        ccs = list(ccs)
        hists = list(hists)
        snaps = list(_snaps)
        taps = [None] * n_t
        flow = None

        def term_val(t):
            return xs[t[1]] if t[0] == "ext" else regs[t[1]]

        def join(terms, scale):
            acc = term_val(terms[0])
            for t in terms[1:]:
                acc = acc + term_val(t)
            return acc * f32(scale) if scale != 1.0 else acc

        for ins in program:
            op = ins[0]
            if op == "join":
                flow = join(ins[1], ins[2])
            elif op == "lin2":
                _, tA, sA, tB, sB, cA, cB = ins
                a = join(tA, sA)
                b = join(tB, sB)
                flow = b * f32(cB) + a * f32(cA)
            elif op == "cascade":
                ci = ins[2]
                snaps[ci] = (ccs[ci], flow)
                flow, ccs[ci] = _casc_step(ins[1], flow, ccs[ci])
            elif op == "comb":
                _, decay, D, bi = ins
                delayed = hists[bi][..., :C]
                flow = flow + f32(decay) * delayed
                hists[bi] = jnp.concatenate(
                    [hists[bi][..., C:], flow], axis=-1)
            elif op == "ew":
                flow = apply_ew(ins[1], flow, ins[2])
            elif op == "scale":
                flow = flow * f32(ins[1])
            elif op == "setreg":
                regs[ins[1]] = flow
            elif op == "tap":
                taps[ins[1]] = flow
            else:
                raise ValueError(f"unknown cycle instr {op!r}")
        return ((tuple(regs), tuple(ccs), tuple(hists), tuple(snaps)),
                tuple(taps))

    # unroll amortizes the XLA while-loop per-iteration overhead, same
    # rationale (and default) as compile_graph's cycle scan
    (regs_f, ccs_f, hists_f, snaps_f), tap_blks = jax.lax.scan(
        body, (tuple(regs0), tuple(casc0), tuple(hist0), snaps0), ext_blks,
        length=nb, unroll=min(8, nb))

    taps = tuple(jnp.moveaxis(tb, 0, -2).reshape(*batch, nb * C)
                 for tb in tap_blks)
    cinfos = tuple(
        (*cascade_tail_states(secs, x_last, c_in),
         x_last[..., -1], x_last[..., -2])
        for secs, (c_in, x_last) in zip(casc_secs, snaps_f))
    return taps, tuple(regs_f), cinfos, tuple(hists_f)
