"""Linear-run fusion (ops/cascade.py + compiler _plan_linear_fusion):
maximal chains of adjacent Gain/LowPass/HighPass/BiQuad nodes fuse into a
single blocked solve under the fast policy.  Oracle semantics per section:
gain.rs:27-38 / low_pass.rs:36-41 / high_pass.rs:36-41 / biquad.rs:79-89,
with the compiler's fan-in scale between nodes."""

import numpy as np
import pytest

import dsp_stuff_tpu as dst
from dsp_stuff_tpu.compiler import compile as compile_mod
from dsp_stuff_tpu.ops import cascade
from dsp_stuff_tpu.utils import precision

import oracle

# Fast-policy solver bound.  Every f32 contraction runs at HIGHEST, so
# the bound is the same on the CPU and on an H100 (the whole file was
# measured to pass there with it).
def bound_db():
    return -100.0

T = 19968      # 156 blocks


def _sig(T, seed=0):
    return (np.random.default_rng(seed).standard_normal(T) * 0.3
            ).astype(np.float32)


def _oracle_section(kind, r, v, z=np.float32(0.0)):
    if kind == "lp":
        return oracle.low_pass(v, r, z)
    return oracle.high_pass(v, r, z)


COMBOS = [("lp", "hp", 0.6, 0.2), ("hp", "lp", 0.3, 0.9),
          ("lp", "lp", 0.5, 0.5), ("hp", "hp", 0.97, 0.97)]


@pytest.mark.parametrize("k1,k2,r1,r2", COMBOS)
def test_one_pole_pair_vs_oracle(k1, k2, r1, r2):
    x = _sig(T)
    with precision.policy("fast"):
        y, z1, z2 = cascade.one_pole_pair(x, k1, r1, k2, r2, 1.0, 0.0, 0.0)
    o1, zw1 = _oracle_section(k1, r1, x)
    want, zw2 = _oracle_section(k2, r2, o1)
    err = np.max(np.abs(np.asarray(y, np.float64) - want))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()
    assert abs(float(z1) - float(zw1)) < 1e-6
    assert abs(float(z2) - float(zw2)) < 1e-6


@pytest.mark.parametrize("k1,k2,r1,r2", COMBOS[:2])
def test_one_pole_pair_state_carry(k1, k2, r1, r2):
    """Two chained segment solves equal the one-shot solve: the carried
    (z1, z2) are the nodes' true one-pole states, including the
    padded-last-chunk recovery (T2 not a multiple of the chunk size)."""
    x = _sig(T, seed=3)
    cut = 7 * 128 + 37                       # mid-chunk split
    with precision.policy("fast"):
        y_full, _, _ = cascade.one_pole_pair(x, k1, r1, k2, r2, 1.0,
                                             0.0, 0.0)
        y1, z1, z2 = cascade.one_pole_pair(x[:cut], k1, r1, k2, r2, 1.0,
                                           0.0, 0.0)
        y2, _, _ = cascade.one_pole_pair(x[cut:], k1, r1, k2, r2, 1.0,
                                         z1, z2)
    got = np.concatenate([np.asarray(y1), np.asarray(y2)])
    err = np.max(np.abs(got.astype(np.float64) - np.asarray(y_full)))
    assert 20 * np.log10(max(err, 1e-30)) <= -120.0


def _pair_graph(k1="lp", k2="hp", r1=0.6, r2=0.2):
    g = dst.Graph()
    inp = g.add("input")
    n1 = g.add("low_pass" if k1 == "lp" else "high_pass", ratio=r1)
    n2 = g.add("low_pass" if k2 == "lp" else "high_pass", ratio=r2)
    out = g.add("output")
    g.chain(inp, n1, n2, out)
    return g, inp, n1, n2, out


def test_compiled_graph_fuses_and_matches_oracle(monkeypatch):
    """The compiler routes an adjacent pair through linear_cascade (spy)
    and the render matches the sequential per-node oracle chain."""
    calls = []
    orig = cascade.linear_cascade

    def spy(x, sections, s_init, emits=()):
        calls.append(sections)
        return orig(x, sections, s_init, emits)

    monkeypatch.setattr(cascade, "linear_cascade", spy)
    g, inp, n1, n2, out = _pair_graph()
    x = _sig(T, seed=5)
    with precision.policy("fast"):
        outs, _, st = dst.compile_graph(g).render({str(inp.id): x})
    assert calls, "fusion did not engage on an adjacent lp->hp pair"

    F32 = np.float32

    def hop(v):
        return (v / F32(F32(1.0) + F32(0.0001))).astype(F32)

    o1, zw1 = _oracle_section("lp", 0.6, hop(x))
    o2, zw2 = _oracle_section("hp", 0.2, hop(o1))
    want = hop(o2)
    err = np.max(np.abs(np.asarray(outs)[0].astype(np.float64) - want))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()
    assert abs(float(np.asarray(st[str(n1.id)]["z"])) - float(zw1)) < 1e-6
    assert abs(float(np.asarray(st[str(n2.id)]["z"])) - float(zw2)) < 1e-6


def _plan_of(g):
    # recompute the structural plan exactly as compile_graph does
    active = compile_mod._active_nodes(g)
    nodes = {nid: n for nid, n in g.nodes.items() if nid in active}
    edges = {nid: set() for nid in nodes}
    for l in g.links:
        if l.src in nodes and l.dst in nodes:
            edges[l.src].add(l.dst)
    from dsp_stuff_tpu.compiler.scc import condensation_topo_order
    sccs = condensation_topo_order(sorted(nodes), edges)
    return compile_mod._plan_linear_fusion(g, nodes, sccs)


def test_fusion_with_extra_consumer_emits_tap():
    """A second consumer of sec1's output (e.g. a wave_view tap) no
    longer breaks the run (since r4): the fused solve emits sec1's own
    signal with an extra taps-GEMM row set, and the tap sees exactly
    the prefix system's output (vs the per-node oracle)."""
    g, inp, n1, n2, out = _pair_graph()
    wv = g.add("wave_view")
    g.connect(n1, "out", wv, "in")
    assert _plan_of(g) == [[n1.id, n2.id]]

    x = _sig(T, seed=47)
    with precision.policy("fast"):
        outs, aux, st = dst.compile_graph(g).render({str(inp.id): x})
    o1, zw1 = _oracle_section("lp", 0.6, _hop(x))
    o2, zw2 = _oracle_section("hp", 0.2, _hop(o1))
    want = _hop(o2)
    err = np.max(np.abs(np.asarray(outs)[0].astype(np.float64) - want))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()
    # the wave_view sink consumed the EMITTED intermediate (through its
    # own single-pipe fan-in scale): analyze sees the lp signal
    tap = np.asarray(aux[f"wave_view:{wv.id}"]["samples"])
    errt = np.max(np.abs(tap.astype(np.float64) - _hop(o1)))
    assert 20 * np.log10(max(errt, 1e-30)) <= bound_db()
    # per-node states still rebuild exactly
    assert abs(float(np.asarray(st[str(n1.id)]["z"])) - float(zw1)) < 1e-6
    assert abs(float(np.asarray(st[str(n2.id)]["z"])) - float(zw2)) < 1e-6


def test_fusion_inside_cycles_plans_run(monkeypatch):
    """A linear pair wrapped in a feedback edge fuses as an IN-CYCLE run
    (since r4 the planner handles contiguous-in-execution-order runs
    inside SCC bodies); the fused render must match the unfused one to
    fast-policy tolerance (the tail->head back edge reads the previous
    block either way)."""
    g, inp, n1, n2, out = _pair_graph()
    g.connect(n2, "out", n1, "in")           # feedback around the pair
    assert _plan_of(g) == [[n1.id, n2.id]]

    x = _sig(T, seed=11)
    with precision.policy("fast"):
        fused, _, _ = dst.compile_graph(g).render({str(inp.id): x})
        monkeypatch.setattr(compile_mod, "_plan_linear_fusion",
                            lambda *a, **k: [])
        unfused, _, _ = dst.compile_graph(g).render({str(inp.id): x})
    err = np.max(np.abs(np.asarray(fused, np.float64)
                        - np.asarray(unfused, np.float64)))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()


def test_fusion_plan_on_three_chain():
    """lp -> lp -> lp: dim 3 fits the dim-4 cap, so the whole chain
    fuses as ONE run."""
    g = dst.Graph()
    inp = g.add("input")
    f1 = g.add("low_pass", ratio=0.3)
    f2 = g.add("low_pass", ratio=0.5)
    f3 = g.add("low_pass", ratio=0.7)
    out = g.add("output")
    g.chain(inp, f1, f2, f3, out)
    plan = _plan_of(g)
    assert plan == [[f1.id, f2.id, f3.id]]
    x = _sig(T, seed=7)
    with precision.policy("fast"):
        outs, _, _ = dst.compile_graph(g).render({str(inp.id): x})

    F32 = np.float32

    def hop(v):
        return (v / F32(F32(1.0) + F32(0.0001))).astype(F32)

    v = hop(x)
    for r in (0.3, 0.5, 0.7):
        v, _ = _oracle_section("lp", r, v)
        v = hop(v)
    err = np.max(np.abs(np.asarray(outs)[0].astype(np.float64) - v))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()


def test_fusion_inactive_outside_fast_policy(monkeypatch):
    calls = []
    orig = cascade.linear_cascade

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(cascade, "linear_cascade", spy)
    g, inp, n1, n2, out = _pair_graph()
    x = _sig(1536, seed=9)
    with precision.policy("parity"):
        dst.compile_graph(g).render({str(inp.id): x})
    assert not calls


def test_fusion_inactive_under_fit_overrides(monkeypatch):
    """Traced parameter overrides (the fit path) must fall back to the
    per-node eval -- the ratios are no longer trace-time constants."""
    calls = []
    orig = cascade.linear_cascade

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(cascade, "linear_cascade", spy)
    g, inp, n1, n2, out = _pair_graph()
    x = _sig(1536, seed=11)
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        params = cg.init_params()
        outs, _, _ = cg.render({str(inp.id): x}, params=params)
        assert not calls, "fusion must not engage with traced overrides"
        ref, _, _ = cg.render({str(inp.id): x})    # no overrides: fuses
    # the override values equal the sliders, so outputs agree closely
    err = np.max(np.abs(np.asarray(outs)[0].astype(np.float64)
                        - np.asarray(ref)[0]))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()


def test_fusion_batched_matches_solo():
    """vmap invariance: stream 0 of a batched fused render equals the
    solo fused render."""
    g, inp, n1, n2, out = _pair_graph("hp", "lp", 0.4, 0.8)
    x = (np.random.default_rng(13).standard_normal((4, 1536)) * 0.25
         ).astype(np.float32)
    with precision.policy("fast"):
        outs, _, _ = dst.compile_graph(g).render({str(inp.id): x},
                                                 batch_shape=(4,))
        solo, _, _ = dst.compile_graph(g).render({str(inp.id): x[0]})
    np.testing.assert_allclose(np.asarray(outs)[0], np.asarray(solo),
                               rtol=0, atol=2e-6)

def _hop(v):
    F32 = np.float32
    return (v / F32(F32(1.0) + F32(0.0001))).astype(F32)


def test_gain_biquad_run_fuses_and_matches_oracle(monkeypatch):
    """gain -> biquad (the headline chain's shape) fuses into one solve
    with the gain's scale folded into the composite taps; output and the
    biquad's DirectForm1 state match the sequential oracle."""
    calls = []
    orig = cascade.linear_cascade

    def spy(x, sections, s_init, emits=()):
        calls.append(sections)
        return orig(x, sections, s_init, emits)

    monkeypatch.setattr(cascade, "linear_cascade", spy)
    g = dst.Graph()
    inp = g.add("input")
    gn = g.add("gain", level=1.2)
    bq = g.add("biquad", a0=1.0, a1=-0.24, a2=0.0, b0=0.758, b1=0.1,
               b2=0.05)
    out = g.add("output")
    g.chain(inp, gn, bq, out)
    x = _sig(T, seed=21)
    with precision.policy("fast"):
        outs, _, st = dst.compile_graph(g).render({str(inp.id): x})
    assert calls and [k for k, _ in calls[0]] == ["gain", "gain", "bq"]

    v = (_hop(x) * np.float32(1.2)).astype(np.float32)
    want, stw = oracle.biquad_df1(_hop(v), 1.0, -0.24, 0.0, 0.758, 0.1,
                                  0.05)
    want = _hop(want)
    err = np.max(np.abs(np.asarray(outs)[0].astype(np.float64) - want))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()
    got_st = st[str(bq.id)]
    for key, want_v in zip(("x1", "x2", "y1", "y2"), stw):
        assert abs(float(np.asarray(got_st[key])) - float(want_v)) < 1e-5, \
            key


def test_gain_biquad_run_segmented_state_carry():
    """Two chained half-renders through a fused gain -> biquad run equal
    the one-shot render (the rebuilt DirectForm1 state is the true carry)."""
    g = dst.Graph()
    inp = g.add("input")
    gn = g.add("gain", level=0.9)
    bq = g.add("biquad", a0=1.0, a1=-0.5, a2=0.2, b0=0.6, b1=0.2, b2=0.1)
    out = g.add("output")
    g.chain(inp, gn, bq, out)
    x = _sig(2560, seed=23)
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        full, _, _ = cg.render({str(inp.id): x})
        a, _, st = cg.render({str(inp.id): x[:1280]})
        b, _, _ = cg.render({str(inp.id): x[1280:]}, state=st)
    got = np.concatenate([np.asarray(a)[0], np.asarray(b)[0]])
    err = np.max(np.abs(got.astype(np.float64) - np.asarray(full)[0]))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()


def test_zero_post_gain_biquad_run_fuses(monkeypatch):
    """A level-0 gain AFTER a biquad no longer blocks the fold: the
    DirectForm1 history rebuilds by forward substitution (no division
    by the post-gain product).  Output is silence; the biquad state is
    still its own true history."""
    calls = []
    orig = cascade.linear_cascade

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(cascade, "linear_cascade", spy)
    g = dst.Graph()
    inp = g.add("input")
    bq = g.add("biquad", a0=1.0, a1=-0.24, a2=0.0, b0=0.758, b1=0.0,
               b2=0.0)
    gn = g.add("gain", level=0.0)
    out = g.add("output")
    g.chain(inp, bq, gn, out)
    x = _sig(1536, seed=25)
    with precision.policy("fast"):
        outs, _, st = dst.compile_graph(g).render({str(inp.id): x})
    assert calls
    got = np.asarray(outs)[0]
    assert np.max(np.abs(got)) < 1e-7
    _, stw = oracle.biquad_df1(_hop(x), 1.0, -0.24, 0.0, 0.758, 0.0, 0.0)
    for key, want_v in zip(("x1", "x2", "y1", "y2"), stw):
        assert abs(float(np.asarray(st[str(bq.id)][key]))
                   - float(want_v)) < 1e-5, key


def test_gain_chain_folds_into_one_pole():
    """gain -> gain -> lp is one run (dim 1): both gain scales fold into
    the solve and the lp state stays exact."""
    plan_g = dst.Graph()
    inp = plan_g.add("input")
    g1 = plan_g.add("gain", level=0.7)
    g2 = plan_g.add("gain", level=1.4)
    lp = plan_g.add("low_pass", ratio=0.6)
    out = plan_g.add("output")
    plan_g.chain(inp, g1, g2, lp, out)
    assert _plan_of(plan_g) == [[g1.id, g2.id, lp.id]]
    x = _sig(T, seed=27)
    with precision.policy("fast"):
        outs, _, st = dst.compile_graph(plan_g).render({str(inp.id): x})
    v = (_hop(x) * np.float32(0.7)).astype(np.float32)
    v = (_hop(v) * np.float32(1.4)).astype(np.float32)
    want, zw = oracle.low_pass(_hop(v), 0.6)
    want = _hop(want)
    err = np.max(np.abs(np.asarray(outs)[0].astype(np.float64) - want))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()
    assert abs(float(np.asarray(st[str(lp.id)]["z"])) - float(zw)) < 1e-6


def test_run_head_fan_in_allowed():
    """Fan-in INTO the head of a run is legal (only internal links must
    be sole): two sources average into gain -> lp, fused."""
    g = dst.Graph()
    i1 = g.add("input")
    sg = g.add("signal_gen", mode="Sine", frequency=200.0, amplitude=0.4)
    gn = g.add("gain", level=0.8)
    lp = g.add("low_pass", ratio=0.4)
    out = g.add("output")
    g.connect(i1, "out", gn, "in")
    g.connect(sg, "out", gn, "in")
    g.chain(gn, lp, out)
    assert _plan_of(g) == [[gn.id, lp.id]]
    x = _sig(1536, seed=31)
    with precision.policy("fast"):
        outs, _, _ = dst.compile_graph(g).render({str(i1.id): x})
    osc, _ = oracle.signal_gen("Sine", 0.4, 200.0, 1536)
    F32 = np.float32
    summed = (x + osc).astype(F32)
    v = (summed / F32(F32(2.0) + F32(0.0001))).astype(F32)
    v = (v * F32(0.8)).astype(F32)
    want, _ = oracle.low_pass(_hop(v), 0.4)
    want = _hop(want)
    err = np.max(np.abs(np.asarray(outs)[0].astype(np.float64) - want))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()


def test_biquad_biquad_run_fuses_and_matches_oracle(monkeypatch):
    """Two adjacent biquads (an EQ stack) fuse as one dim-4 solve; both
    nodes' DirectForm1 states match the sequential oracle."""
    calls = []
    orig = cascade.linear_cascade

    def spy(x, sections, s_init, emits=()):
        calls.append(sections)
        return orig(x, sections, s_init, emits)

    monkeypatch.setattr(cascade, "linear_cascade", spy)
    g = dst.Graph()
    inp = g.add("input")
    b1 = g.add("biquad", a0=1.0, a1=-0.6, a2=0.2, b0=0.8, b1=0.2, b2=0.1)
    b2n = g.add("biquad", a0=1.0, a1=0.3, a2=0.1, b0=0.5, b1=-0.2,
                b2=0.05)
    out = g.add("output")
    g.chain(inp, b1, b2n, out)
    x = _sig(T, seed=33)
    with precision.policy("fast"):
        outs, _, st = dst.compile_graph(g).render({str(inp.id): x})
    assert calls and [k for k, _ in calls[0]] == ["bq", "gain", "bq"]

    v1, st1w = oracle.biquad_df1(_hop(x), 1.0, -0.6, 0.2, 0.8, 0.2, 0.1)
    v2, st2w = oracle.biquad_df1(_hop(v1), 1.0, 0.3, 0.1, 0.5, -0.2, 0.05)
    want = _hop(v2)
    err = np.max(np.abs(np.asarray(outs)[0].astype(np.float64) - want))
    assert 20 * np.log10(max(err, 1e-30)) <= -95.0
    for nid, stw in ((b1.id, st1w), (b2n.id, st2w)):
        for key, want_v in zip(("x1", "x2", "y1", "y2"), stw):
            got_v = float(np.asarray(st[str(nid)][key]))
            assert abs(got_v - float(want_v)) < 2e-5, (nid, key)


def test_biquad_biquad_run_segmented_state_carry():
    g = dst.Graph()
    inp = g.add("input")
    b1 = g.add("biquad", a0=1.0, a1=-0.6, a2=0.2, b0=0.8, b1=0.2, b2=0.1)
    b2n = g.add("biquad", a0=1.0, a1=0.3, a2=0.1, b0=0.5, b1=-0.2,
                b2=0.05)
    out = g.add("output")
    g.chain(inp, b1, b2n, out)
    x = _sig(2560, seed=35)
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        full, _, _ = cg.render({str(inp.id): x})
        a, _, st = cg.render({str(inp.id): x[:1280]})
        b, _, _ = cg.render({str(inp.id): x[1280:]}, state=st)
    got = np.concatenate([np.asarray(a)[0], np.asarray(b)[0]])
    err = np.max(np.abs(got.astype(np.float64) - np.asarray(full)[0]))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()


def test_fusion_plan_dim_cap_split():
    """lp -> hp -> bq -> bq -> lp (dim 7) fits the dim-8 cap as ONE run;
    a 5th biquad (dim 9) splits greedily: [lp, hp, bq, bq, lp] (dim 7 --
    the next bq would overflow) then the trailing [bq] alone is dropped
    (< 2 nodes)."""
    g = dst.Graph()
    inp = g.add("input")
    f1 = g.add("low_pass", ratio=0.3)
    f2 = g.add("high_pass", ratio=0.2)
    q1 = g.add("biquad", a0=1.0, a1=-0.2, a2=0.05, b0=0.9, b1=0.0,
               b2=0.0)
    q2 = g.add("biquad", a0=1.0, a1=0.1, a2=0.0, b0=0.7, b1=0.1, b2=0.0)
    f3 = g.add("low_pass", ratio=0.8)
    out = g.add("output")
    g.chain(inp, f1, f2, q1, q2, f3, out)
    assert _plan_of(g) == [[f1.id, f2.id, q1.id, q2.id, f3.id]]

    g2 = dst.Graph()
    inp2 = g2.add("input")
    ns = [g2.add("biquad", a0=1.0, a1=-0.2, a2=0.05, b0=0.9, b1=0.0,
                 b2=0.0) for _ in range(5)]
    out2 = g2.add("output")
    g2.chain(inp2, *ns, out2)
    assert _plan_of(g2) == [[n.id for n in ns[:4]]]


def test_one_pole_pair_state_carry_block_boundary_split():
    """Segment length T == K*128 + 1 exercises the i_last == 0 branch of
    the composite-state recovery (s[T-2] lives in the previous chunk)."""
    x = _sig(1024, seed=41)
    cut = 2 * 128 + 1
    with precision.policy("fast"):
        y_full, _, _ = cascade.one_pole_pair(x, "lp", 0.6, "hp", 0.2,
                                             1.0, 0.0, 0.0)
        y1, z1, z2 = cascade.one_pole_pair(x[:cut], "lp", 0.6, "hp", 0.2,
                                           1.0, 0.0, 0.0)
        y2, _, _ = cascade.one_pole_pair(x[cut:], "lp", 0.6, "hp", 0.2,
                                         1.0, z1, z2)
    got = np.concatenate([np.asarray(y1), np.asarray(y2)])
    err = np.max(np.abs(got.astype(np.float64) - np.asarray(y_full)))
    assert 20 * np.log10(max(err, 1e-30)) <= -120.0


def test_linear_cascade_biquad_block_boundary_split():
    """Same i_last == 0 branch for a biquad section: the DirectForm1
    rebuild needs s[T-2] from the previous chunk."""
    secs = (("gain", 0.9), ("bq", (-0.5, 0.2, 0.6, 0.2, 0.1)))
    x = _sig(1024, seed=43)
    cut = 3 * 128 + 1
    with precision.policy("fast"):
        z0 = np.zeros(2, np.float32)
        y_full, _, _ = cascade.linear_cascade(x, secs, z0)
        y1, s1, s2 = cascade.linear_cascade(x[:cut], secs, z0)
        (st,) = cascade.cascade_state_out(secs, s1, s2,
                                          x[:cut][-1], x[:cut][-2])
        s_in = cascade.cascade_state_in(secs, [st])
        y2, _, _ = cascade.linear_cascade(x[cut:], secs, s_in)
    got = np.concatenate([np.asarray(y1), np.asarray(y2)])
    err = np.max(np.abs(got.astype(np.float64) - np.asarray(y_full)))
    assert 20 * np.log10(max(err, 1e-30)) <= -115.0


def test_in_cycle_tap_fuses_and_matches_unfused(monkeypatch):
    """An analysis tap on the INTERMEDIATE of an in-cycle run no longer
    breaks the fusion: the emitted block enters the scan carry, so a
    consumer reads exactly what the unfused body would publish."""
    g, inp, n1, n2, out = _pair_graph()
    g.connect(n2, "out", n1, "in")           # feedback around the pair
    wv = g.add("wave_view")
    g.connect(n1, "out", wv, "in")
    assert _plan_of(g) == [[n1.id, n2.id]]

    x = _sig(T, seed=51)
    with precision.policy("fast"):
        fused, aux_f, _ = dst.compile_graph(g).render({str(inp.id): x})
        monkeypatch.setattr(compile_mod, "_plan_linear_fusion",
                            lambda *a, **k: [])
        unfused, aux_u, _ = dst.compile_graph(g).render({str(inp.id): x})
    err = np.max(np.abs(np.asarray(fused, np.float64)
                        - np.asarray(unfused, np.float64)))
    assert 20 * np.log10(max(err, 1e-30)) <= bound_db()
    tap_f = np.asarray(aux_f[f"wave_view:{wv.id}"]["samples"], np.float64)
    tap_u = np.asarray(aux_u[f"wave_view:{wv.id}"]["samples"], np.float64)
    errt = np.max(np.abs(tap_f - tap_u))
    assert 20 * np.log10(max(errt, 1e-30)) <= bound_db()


def test_tapped_head_emits_own_output():
    """The run HEAD's output feeding a second consumer is emitted too
    (the head's own signal differs from the run input)."""
    g, inp, n1, n2, out = _pair_graph()
    out2 = g.add("output")
    g.connect(n1, "out", out2, "in")
    assert _plan_of(g) == [[n1.id, n2.id]]
    x = _sig(T, seed=53)
    with precision.policy("fast"):
        outs, _, _ = dst.compile_graph(g).render({str(inp.id): x})
    o1, _ = _oracle_section("lp", 0.6, _hop(x))
    o2, _ = _oracle_section("hp", 0.2, _hop(o1))
    # output ids ascending: out (tail) then out2 (head tap)
    got = np.asarray(outs)
    err_tail = np.max(np.abs(got[0].astype(np.float64) - _hop(o2)))
    err_head = np.max(np.abs(got[1].astype(np.float64) - _hop(o1)))
    assert 20 * np.log10(max(err_tail, 1e-30)) <= bound_db()
    assert 20 * np.log10(max(err_head, 1e-30)) <= bound_db()


def test_run_dim8_four_biquad_stack(monkeypatch):
    """With the cap at 8 a 4-biquad EQ stack fuses as ONE dim-8 solve;
    output and every DirectForm1 state match the sequential oracle
    (exercises _vecn_recurrence at n=8 and the dim-8 embed)."""
    monkeypatch.setattr(cascade, "MAX_RUN_DIM", 8)
    cascade._cascade_constants.cache_clear()
    coefs = [(1.0, -0.24, 0.05, 0.758, 0.1, 0.02),
             (1.0, 0.31, 0.12, 0.6, -0.15, 0.05),
             (1.0, -0.52, 0.2, 0.9, 0.05, 0.0),
             (1.0, 0.18, 0.07, 0.7, 0.12, 0.03)]
    g = dst.Graph()
    inp = g.add("input")
    ns = []
    for a0, a1, a2, b0, b1, b2 in coefs:
        ns.append(g.add("biquad", a0=a0, a1=a1, a2=a2, b0=b0, b1=b1,
                        b2=b2))
    out = g.add("output")
    g.chain(inp, *ns, out)
    assert _plan_of(g) == [[n.id for n in ns]]
    x = _sig(T, seed=55)
    with precision.policy("fast"):
        outs, _, st = dst.compile_graph(g).render({str(inp.id): x})
    v = x
    wants = []
    for a0, a1, a2, b0, b1, b2 in coefs:
        v, stw = oracle.biquad_df1(_hop(v), a0, a1, a2, b0, b1, b2)
        wants.append(stw)
    want = _hop(v)
    err = np.max(np.abs(np.asarray(outs)[0].astype(np.float64) - want))
    assert 20 * np.log10(max(err, 1e-30)) <= -90.0
    for n, stw in zip(ns, wants):
        for key, want_v in zip(("x1", "x2", "y1", "y2"), stw):
            got_v = float(np.asarray(st[str(n.id)][key]))
            assert abs(got_v - float(want_v)) < 5e-5, (n.id, key)
