"""Chain-segment mega fusion (ops/chain_segment.py + compiler
_plan_mega_fusion/_mega_run_eval): maximal sole-consumer chains of
linear + elementwise-shaper + feedback-comb nodes evaluate as ONE op, a
stage composition of the per-op lowerings (which these tests pin it
against).

Reference semantics per member: gain.rs:27-38, low_pass.rs:36-41,
biquad.rs:79-89, overdrive.rs:31-43, distort.rs:184-194,
chebyshev.rs:28-42, reverb.rs:87-105; the chain itself replaces the
reference's task-per-node loop (runtime.rs:718-728)."""

import numpy as np
import pytest

import dsp_stuff_tpu as dst
from dsp_stuff_tpu.compiler import compile as compile_mod
from dsp_stuff_tpu.ops import chain_segment as cs
from dsp_stuff_tpu.utils import precision
from oracle import rel_err_db


def _mega_plan_of(g):
    active = compile_mod._active_nodes(g)
    nodes = {nid: n for nid, n in g.nodes.items() if nid in active}
    edges = {nid: set() for nid in nodes}
    for l in g.links:
        if l.src in nodes and l.dst in nodes:
            edges[l.src].add(l.dst)
    from dsp_stuff_tpu.compiler.scc import condensation_topo_order
    sccs = condensation_topo_order(sorted(nodes), edges)
    return compile_mod._plan_mega_fusion(g, nodes, sccs)


def _bench_like_chain():
    """The bench.py 10-node shape: two linear groups, three shapers and
    a comb, all mega-fusable into one run."""
    g = dst.Graph()
    inp = g.add("input")
    gn = g.add("gain", level=1.2)
    bq = g.add("biquad", a0=1.0, a1=-0.24, a2=0.0, b0=0.758, b1=0.0, b2=0.0)
    od = g.add("overdrive", boost=4.0, drive=0.6, level=0.9)
    lp = g.add("low_pass", ratio=0.6)
    hp = g.add("high_pass", ratio=0.2)
    dt = g.add("distort", mode="Tanh", level=3.0)
    ch = g.add("chebyshev", level_pos=2.0, level_neg=4.0)
    rv = g.add("reverb", seconds=0.004, decay=0.4)   # D=192: off != 0
    out = g.add("output")
    g.chain(inp, gn, bq, od, lp, hp, dt, ch, rv, out)
    return g, inp.id, [gn.id, bq.id, od.id, lp.id, hp.id, dt.id, ch.id,
                       rv.id]


#: Cross-lowering envelope: fast-policy lowerings of the same math in
#: different fusion contexts differ by 1-ulp rounding noise (CLAUDE.md).
#: Every f32 contraction runs at HIGHEST, so the bound holds on the CPU
#: and on an H100 alike (measured).
CROSS_DB = -120.0

#: Handed-back states (carries, delay rings) across the same lowerings:
#: the same 1-ulp envelope, on either backend.
STATE_ATOL = 2e-6


def _assert_close_dbfs(got, want, db=CROSS_DB):
    """Error relative to the reference's peak: see CROSS_DB above."""
    err = rel_err_db(got, want)
    assert err <= db, (err, db)


def _render_unfused(g, ext, **kw):
    """Render with mega fusion structurally disabled (per-node linear
    fusion still applies, as before round 4)."""
    orig = compile_mod._plan_mega_fusion
    compile_mod._plan_mega_fusion = lambda *a, **k: []
    try:
        cg = compile_mod.compile_graph(g)
    finally:
        compile_mod._plan_mega_fusion = orig
    return cg.render(ext, **kw)


def test_mega_plan_bench_chain():
    g, _, members = _bench_like_chain()
    assert _mega_plan_of(g) == [members]


def test_mega_plan_rejects_oversampled_and_modded():
    g = dst.Graph()
    inp = g.add("input")
    lp = g.add("low_pass", ratio=0.5)
    dt = g.add("distort", mode="Tanh", level=2.0, oversample="4")
    out = g.add("output")
    g.chain(inp, lp, dt, out)
    assert _mega_plan_of(g) == []          # oversampled shaper excluded

    g2 = dst.Graph()
    inp2 = g2.add("input")
    lfo = g2.add("signal_gen", mode="Sine", frequency=1.0, amplitude=0.5)
    od = g2.add("overdrive", boost=2.0, drive=0.5, level=0.8)
    lp2 = g2.add("low_pass", ratio=0.5)
    out2 = g2.add("output")
    g2.chain(inp2, od, lp2, out2)
    g2.connect(lfo, "out", od, "drive")    # modulated member
    assert _mega_plan_of(g2) == []


def test_mega_plan_tap_continues_chain():
    """An extra consumer on an intermediate no longer ends the mega
    chain (round-5): the whole run plans as ONE segment and the
    intermediate becomes a ("tap", ti) stage."""
    g = dst.Graph()
    inp = g.add("input")
    lp = g.add("low_pass", ratio=0.5)
    dt = g.add("distort", mode="SoftClip", level=2.0)
    hp = g.add("high_pass", ratio=0.1)
    rv = g.add("reverb", seconds=0.004, decay=0.3)
    wv = g.add("wave_view")
    out = g.add("output")
    g.chain(inp, lp, dt, hp, rv, out)
    g.connect(hp, "out", wv, "in")         # tap on hp: chain continues
    assert _mega_plan_of(g) == [[lp.id, dt.id, hp.id, rv.id]]


def test_mega_plan_ambiguous_joint_takes_none():
    """Two distinct joint candidates out of one member: the chain ends
    there (ambiguous continuation), each candidate starts its own."""
    g = dst.Graph()
    inp = g.add("input")
    dt = g.add("distort", mode="Tanh", level=2.0)
    lp = g.add("low_pass", ratio=0.5)
    # two downstream mega-fusable branches
    rv1 = g.add("reverb", seconds=0.004, decay=0.3)
    ch1 = g.add("chebyshev", level_pos=2.0, level_neg=3.0)
    rv2 = g.add("reverb", seconds=0.008, decay=0.2)
    ch2 = g.add("chebyshev", level_pos=1.5, level_neg=2.5)
    out = g.add("output")
    g.chain(inp, dt, lp)
    g.chain(lp, ch1, rv1, out)
    g.chain(lp, ch2, rv2, out)
    plan = _mega_plan_of(g)
    assert [dt.id, lp.id] in plan           # upstream run ends at lp
    assert [ch1.id, rv1.id] in plan and [ch2.id, rv2.id] in plan


def test_tapped_mid_segment_matches_unfused():
    """Taps on BOTH a linear member (splits the composite cascade) and
    a shaper member, consumed by second Output nodes: one segment, all
    three outputs match the mega-disabled render, states included."""
    g = dst.Graph()
    inp = g.add("input")
    gn = g.add("gain", level=1.1)
    lp = g.add("low_pass", ratio=0.55)      # tapped linear member
    bq = g.add("biquad", a0=1.0, a1=-0.3, a2=0.05, b0=0.8, b1=0.1, b2=0.0)
    dt = g.add("distort", mode="SoftClip", level=2.5)   # tapped shaper
    rv = g.add("reverb", seconds=0.004, decay=0.45)
    out = g.add("output")
    tap_lp = g.add("output")
    tap_dt = g.add("output")
    g.chain(inp, gn, lp, bq, dt, rv, out)
    g.connect(lp, "out", tap_lp, "in")
    g.connect(dt, "out", tap_dt, "in")
    assert _mega_plan_of(g) == [[gn.id, lp.id, bq.id, dt.id, rv.id]]

    rng = np.random.default_rng(9)
    T = 4096
    x = (rng.standard_normal(T) * 0.3).astype(np.float32)
    ext = {str(inp.id): x}
    cg = compile_mod.compile_graph(g)
    with precision.policy("fast"):
        y_f, _, st_f = cg.render(ext)
        y_u, _, st_u = _render_unfused(g, ext)
    assert np.asarray(y_f).shape == np.asarray(y_u).shape == (3, T)
    _assert_close_dbfs(y_f, y_u)
    import jax
    for a, b in zip(jax.tree.leaves(st_f), jax.tree.leaves(st_u)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=0, atol=STATE_ATOL)


def test_tapped_segment_segmented_state_carry():
    """Tapped segment chained through state across a cut == one render
    (the cascade split at the tap hands off its states exactly)."""
    g = dst.Graph()
    inp = g.add("input")
    lp = g.add("low_pass", ratio=0.4)
    hp = g.add("high_pass", ratio=0.15)     # tapped mid-cascade
    dt = g.add("distort", mode="Tanh", level=2.0)
    rv = g.add("reverb", seconds=0.004, decay=0.4)
    out = g.add("output")
    wv = g.add("wave_view")
    g.chain(inp, lp, hp, dt, rv, out)
    g.connect(hp, "out", wv, "in")
    assert _mega_plan_of(g) == [[lp.id, hp.id, dt.id, rv.id]]
    rng = np.random.default_rng(10)
    T, cut = 4096, 2048
    x = (rng.standard_normal(T) * 0.3).astype(np.float32)
    cg = compile_mod.compile_graph(g)
    with precision.policy("fast"):
        y_full, _, _ = cg.render({str(inp.id): x})
        y1, _, st = cg.render({str(inp.id): x[:cut]})
        y2, _, _ = cg.render({str(inp.id): x[cut:]}, state=st)
    got = np.concatenate([np.asarray(y1)[0], np.asarray(y2)[0]])
    _assert_close_dbfs(got, np.asarray(y_full)[0])


def test_mega_plan_pure_linear_or_pure_ew_rejected():
    g = dst.Graph()
    inp = g.add("input")
    lp = g.add("low_pass", ratio=0.5)
    hp = g.add("high_pass", ratio=0.2)
    out = g.add("output")
    g.chain(inp, lp, hp, out)
    assert _mega_plan_of(g) == []          # pure-linear: cascade planner's

    g2 = dst.Graph()
    inp2 = g2.add("input")
    d1 = g2.add("distort", mode="Tanh", level=1.0)
    d2 = g2.add("chebyshev", level_pos=1.0, level_neg=2.0)
    out2 = g2.add("output")
    g2.chain(inp2, d1, d2, out2)
    assert _mega_plan_of(g2) == []         # stateless: XLA's fusion


def test_fused_render_matches_unfused():
    """The CPU fallback composes the same per-op lowerings the unfused
    eval uses: fused == unfused to FMA-contraction noise (-120 dBFS),
    states included."""
    g, inp_id, _ = _bench_like_chain()
    rng = np.random.default_rng(0)
    T = 4096
    x = (rng.standard_normal((1, T)) * 0.3).astype(np.float32)
    ext = {str(inp_id): x[0]}
    cg = compile_mod.compile_graph(g)
    with precision.policy("fast"):
        y_f, _, st_f = cg.render(ext)
        y_u, _, st_u = _render_unfused(g, ext)
    _assert_close_dbfs(y_f, y_u)
    import jax
    for a, b in zip(jax.tree.leaves(st_f), jax.tree.leaves(st_u)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=0, atol=STATE_ATOL)


def test_fused_segmented_state_carry():
    """Two fused renders chained through state == one fused render: the
    cascade tail-state rebuild and the comb-ring reconstruction hand off
    exactly."""
    g, inp_id, _ = _bench_like_chain()
    rng = np.random.default_rng(3)
    T = 4096
    x = (rng.standard_normal(T) * 0.3).astype(np.float32)
    cg = compile_mod.compile_graph(g)
    with precision.policy("fast"):
        y_full, _, _ = cg.render({str(inp_id): x})
        cut = 2048
        y1, _, st = cg.render({str(inp_id): x[:cut]})
        y2, _, _ = cg.render({str(inp_id): x[cut:]}, state=st)
    got = np.concatenate([np.asarray(y1)[0], np.asarray(y2)[0]])
    _assert_close_dbfs(got, np.asarray(y_full)[0])


def test_parity_policy_bypasses_mega():
    """Under parity the mega path deactivates; the per-node f64 eval must
    still agree with the fast fused render within the policy budget."""
    g, inp_id, _ = _bench_like_chain()
    rng = np.random.default_rng(5)
    T = 2048
    x = (rng.standard_normal(T) * 0.3).astype(np.float32)
    cg = compile_mod.compile_graph(g)
    with precision.policy("fast"):
        y_f, _, _ = cg.render({str(inp_id): x})
    with precision.policy("parity"):
        cg2 = compile_mod.compile_graph(g)
        y_p, _, _ = cg2.render({str(inp_id): x})
    err = np.abs(np.asarray(y_f) - np.asarray(y_p)).max()
    den = max(float(np.abs(np.asarray(y_p)).max()), 1e-9)
    assert 20 * np.log10(max(err, 1e-30) / den) <= -80.0


def test_node_hook_bypasses_mega():
    """debug_render needs every node's own output: with NODE_HOOK set the
    mega (and linear) fusion must deactivate and the hook must see all
    member nodes."""
    g, inp_id, members = _bench_like_chain()
    seen = []
    cg = compile_mod.compile_graph(g)
    x = np.zeros(512, np.float32)
    compile_mod.NODE_HOOK = lambda nid, cfg, outs: seen.append(nid)
    try:
        with precision.policy("fast"):
            cg.render({str(inp_id): x})
    finally:
        compile_mod.NODE_HOOK = None
    assert set(members) <= set(seen)


def _config2_like():
    """config2's shape (reverb -> chorus -> gain) plus a shaper so the
    segment exercises cascade + ew + comb + mtap stages together."""
    g = dst.Graph()
    inp = g.add("input")
    rv = g.add("reverb", seconds=0.004, decay=0.45)
    ch = g.add("chorus", rate=0.8, depth=0.004, base=0.012, mix=0.5)
    dt = g.add("distort", mode="SoftClip", level=2.0)
    gn = g.add("gain", level=0.9)
    out = g.add("output")
    g.chain(inp, rv, ch, dt, gn, out)
    return g, inp.id, [rv.id, ch.id, dt.id, gn.id]


def test_mega_plan_chorus_joins_and_gates():
    """A concrete-param chorus joins the mega chain as an ("mtap", ...)
    stage; geometries the mtap stage can't lower (minimum delay below the
    window-causality gate, LFO too fast/deep for the one-hot residual
    bound — ops/modfx.mtap_static) exclude the node and the chain plans
    around it."""
    g, _, members = _config2_like()
    assert _mega_plan_of(g) == [members]

    # dmin = (base - depth) * sr = 0: fails the RS - C + 2 causality gate
    g2 = dst.Graph()
    inp2 = g2.add("input")
    rv2 = g2.add("reverb", seconds=0.004, decay=0.3)
    ch2 = g2.add("chorus", rate=0.8, depth=0.004, base=0.004, mix=0.5)
    dt2 = g2.add("distort", mode="Tanh", level=2.0)
    out2 = g2.add("output")
    g2.chain(inp2, rv2, ch2, dt2, out2)
    plan2 = _mega_plan_of(g2)
    assert all(ch2.id not in run for run in plan2), plan2

    # per-block trajectory variation beyond _BARREL_MAX_E: excluded
    g3 = dst.Graph()
    inp3 = g3.add("input")
    rv3 = g3.add("reverb", seconds=0.004, decay=0.3)
    ch3 = g3.add("chorus", rate=10.0, depth=0.02, base=0.05, mix=0.5)
    dt3 = g3.add("distort", mode="Tanh", level=2.0)
    out3 = g3.add("output")
    g3.chain(inp3, rv3, ch3, dt3, out3)
    plan3 = _mega_plan_of(g3)
    assert all(ch3.id not in run for run in plan3), plan3


def test_chorus_fused_render_matches_unfused():
    """The mtap stage (fallback path) is BIT-IDENTICAL to the unfused
    chorus: mtap_shared/mtap_apply evaluate the same indices and weights
    as modulated_delay (ops/modfx.py), so fused == unfused bitwise here
    (no FMA-sensitive recurrence sits downstream of the tap)."""
    g, inp_id, _ = _config2_like()
    rng = np.random.default_rng(11)
    T = 5120
    x = (rng.standard_normal(T) * 0.3).astype(np.float32)
    ext = {str(inp_id): x}
    cg = compile_mod.compile_graph(g)
    with precision.policy("fast"):
        y_f, _, st_f = cg.render(ext)
        y_u, _, st_u = _render_unfused(g, ext)
    _assert_close_dbfs(y_f, y_u)
    import jax
    for a, b in zip(jax.tree.leaves(st_f), jax.tree.leaves(st_u)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=0, atol=STATE_ATOL)


def test_chorus_fused_segmented_state_carry():
    """Segmented fused renders == one fused render through the mtap
    state (hist + the lockstep t0 clock): LFO phase continuity across
    the cut (modulated_delay's t0 contract)."""
    g, inp_id, _ = _config2_like()
    rng = np.random.default_rng(12)
    T, cut = 5120, 2560
    x = (rng.standard_normal(T) * 0.3).astype(np.float32)
    cg = compile_mod.compile_graph(g)
    with precision.policy("fast"):
        y_full, _, _ = cg.render({str(inp_id): x})
        y1, _, st = cg.render({str(inp_id): x[:cut]})
        y2, _, _ = cg.render({str(inp_id): x[cut:]}, state=st)
    got = np.concatenate([np.asarray(y1)[0], np.asarray(y2)[0]])
    _assert_close_dbfs(got, np.asarray(y_full)[0])


def test_chain_segment_grad_matches_fallback():
    """Grads through chain_segment equal grads through the same per-op
    lowerings composed by hand (the segment adds no gradient rule of
    its own)."""
    import jax
    import jax.numpy as jnp
    from dsp_stuff_tpu.ops import shaping
    from dsp_stuff_tpu.ops.cascade import linear_cascade
    from dsp_stuff_tpu.ops.delay_line import feedback_comb
    stages = (("cascade", (("gain", 1.2), ("lp", 0.5))),
              ("ew", "overdrive", (2.0, 0.5, 0.8)),
              ("comb", 0.4, 192))
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(512) * 0.3, jnp.float32)
    state = (jnp.zeros((1,), jnp.float32), jnp.zeros((192,), jnp.float32))

    def loss_seg(x):
        y, _, _, _ = cs.chain_segment(x, stages, state)
        return jnp.sum(y ** 2)

    def loss_fb(x):
        v, _, _ = linear_cascade(x, stages[0][1], state[0])
        v = shaping.overdrive(v, *(jnp.float32(p) for p in stages[1][2]))
        y, _ = feedback_comb(v, 0.4, 192, state[1])
        return jnp.sum(y ** 2)

    with precision.policy("fast"):
        g1 = jax.grad(loss_seg)(x)
        g2 = jax.grad(loss_fb)(x)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=1e-5, atol=1e-6)
