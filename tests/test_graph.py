"""Graph-level tests: compiler protocol semantics + JSON config compat."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import dsp_stuff_tpu as dst
import oracle

RNG = np.random.default_rng(1)
T = 1024


def assert_dbfs(got, want, bound=-90.0):
    db = oracle.max_err_dbfs(got, want)
    assert db <= bound, f"max error {db:.1f} dBFS > {bound}"


def in_graph(*chain_types, **param_overrides):
    """input -> chain -> output graph."""
    g = dst.Graph()
    inp = g.add("input")
    prev = inp
    made = [inp]
    for t in chain_types:
        n = g.add(t, **param_overrides.get(t, {}))
        g.connect(prev, prev.spec.outputs[0], n, n.spec.inputs[0])
        prev = n
        made.append(n)
    out = g.add("output")
    g.connect(prev, prev.spec.outputs[0], out, out.spec.inputs[0])
    return g, made


def test_single_gain_chain():
    """input -> gain -> output with the per-hop 1/1.0001 fan-in scaling."""
    x = RNG.standard_normal(T).astype(np.float32)
    g, _ = in_graph("gain", gain={"level": 2.0})
    outs, _, _ = dst.render(g, x[None])
    d1 = oracle.fanin_average([x])                  # into gain
    d2 = oracle.fanin_average([(d1 * np.float32(2.0)).astype(np.float32)])
    assert_dbfs(outs[0], d2, -120.0)


def test_fan_in_averaging():
    """Two producers into one port: (a+b)/2.0001."""
    x = RNG.standard_normal(T).astype(np.float32)
    g = dst.Graph()
    inp = g.add("input")
    g1 = g.add("gain", level=1.0)
    g2 = g.add("gain", level=3.0)
    out = g.add("output")
    g.connect(inp, "out", g1, "in")
    g.connect(inp, "out", g2, "in")
    g.connect(g1, "out", out, "in")
    g.connect(g2, "out", out, "in")
    outs, _, _ = dst.render(g, x[None])
    xin = oracle.fanin_average([x])
    y1 = (xin * np.float32(1.0)).astype(np.float32)
    y2 = (xin * np.float32(3.0)).astype(np.float32)
    want = oracle.fanin_average([y1, y2])
    assert_dbfs(outs[0], want, -110.0)


def test_fan_in_three_way_exact_bitwise():
    """>= 3 sources into one port: the f32 sum must follow the canonical
    link-insertion order bit-for-bit (compile._avg contract).  The reference
    itself randomizes within-port order via HashSet iteration
    (runtime.rs:38,175-180), so canonical-order-vs-oracle is the strongest
    claim possible (VERDICT r1 missing #5)."""
    from dsp_stuff_tpu.utils import precision
    x = RNG.standard_normal(T).astype(np.float32)
    g = dst.Graph()
    inp = g.add("input")
    # awkward, inexact-product levels: identity/power-of-two levels would
    # mask a missing FMA fence (a fused mul+add rounds once where the
    # reference rounds twice -- caught only when the product is inexact)
    LV = (0.7310586, 1.3, 2.7)
    gains = [g.add("gain", level=lv) for lv in LV]
    out = g.add("output")
    for gn in gains:
        g.connect(inp, "out", gn, "in")
        g.connect(gn, "out", out, "in")
    with precision.policy("exact"):
        outs, _, _ = dst.render(g, x[None])
    xin = oracle.fanin_average([x])
    ys = [(xin * np.float32(lv)).astype(np.float32)
          for lv in LV]
    want = oracle.fanin_average(ys)
    np.testing.assert_array_equal(np.asarray(outs[0]), want)


def test_chain_exact_bitwise_end_to_end():
    """input -> gain -> low_pass -> output, whole graph bit-exact vs the
    oracle under 'exact' (fan-in divisions + the sequential recurrence)."""
    from dsp_stuff_tpu.utils import precision
    x = RNG.standard_normal(T).astype(np.float32)
    g = dst.Graph()
    inp = g.add("input")
    gn = g.add("gain", level=1.7)
    lp = g.add("low_pass", ratio=0.6)
    out = g.add("output")
    g.chain(inp, gn, lp, out)
    with precision.policy("exact"):
        outs, _, _ = dst.render(g, x[None])
    xin = oracle.fanin_average([x])
    y = (xin * np.float32(1.7)).astype(np.float32)
    y = oracle.fanin_average([y])
    y = oracle.low_pass(y, np.float32(0.6))[0]
    want = oracle.fanin_average([y])
    np.testing.assert_array_equal(np.asarray(outs[0]), want)


@pytest.mark.parametrize("mode,ofn,level", [
    ("HardClip", "hard_clip", 2.3),
    ("SoftClip", "soft_clip", 2.3),
    ("SoftClip", "soft_clip", 0.9),       # all-inner-branch regime
    ("Square", "square_shape", 2.3),
    ("Chebyshev4", "chebyshev4", 2.3),
    ("RecipSoftClip", "recip_soft_clip", 2.3),
])
def test_distort_polynomial_modes_exact_bitwise(mode, ofn, level):
    """The non-transcendental shapers through a full graph must be
    bit-exact under 'exact' (FMA-contraction + divide-rewrite guards in
    ops/shaping.py / utils/precision.py)."""
    from dsp_stuff_tpu.utils import precision
    x = RNG.standard_normal(T).astype(np.float32)
    g = dst.Graph()
    inp = g.add("input")
    dt = g.add("distort", mode=mode, level=level)
    out = g.add("output")
    g.chain(inp, dt, out)
    with precision.policy("exact"):
        outs, _, _ = dst.render(g, x[None])
    xin = oracle.fanin_average([x])
    want = oracle.fanin_average(
        [getattr(oracle, ofn)(xin, np.float32(level))])
    np.testing.assert_array_equal(np.asarray(outs[0]), want)


def test_mix_exact_bitwise():
    """mix's b*r + a*(1-r) (three separate f32 roundings in the reference,
    mix.rs:45) through a graph under 'exact'."""
    from dsp_stuff_tpu.utils import precision
    f = np.float32
    x = RNG.standard_normal(T).astype(np.float32)
    y = RNG.standard_normal(T).astype(np.float32)
    g = dst.Graph()
    ia = g.add("input")
    ib = g.add("input")
    mx = g.add("mix", ratio=0.37)
    out = g.add("output")
    g.connect(ia, "out", mx, "a")
    g.connect(ib, "out", mx, "b")
    g.connect(mx, "out", out, "in")
    with precision.policy("exact"):
        outs, _, _ = dst.render(g, {str(ia.id): x, str(ib.id): y})
    a_in = oracle.fanin_average([x])
    b_in = oracle.fanin_average([y])
    r = f(0.37)
    mixed = (b_in * r + a_in * f(f(1.0) - r)).astype(f)
    want = oracle.fanin_average([mixed])
    np.testing.assert_array_equal(np.asarray(outs[0]), want)


def test_reverb_exact_bitwise_via_graph():
    """Feedback comb through a graph: t = delayed*decay; y = x + t, two
    roundings per sample (reverb.rs:87-92), unfused under 'exact'."""
    from dsp_stuff_tpu.utils import precision
    x = RNG.standard_normal(T).astype(np.float32)
    g = dst.Graph()
    inp = g.add("input")
    rv = g.add("reverb", seconds=0.003, decay=0.6)
    out = g.add("output")
    g.chain(inp, rv, out)
    with precision.policy("exact"):
        outs, _, _ = dst.render(g, x[None])
    xin = oracle.fanin_average([x])
    want = oracle.fanin_average([oracle.reverb(xin, 0.003, 0.6)[0]])
    np.testing.assert_array_equal(np.asarray(outs[0]), want)


def test_unconnected_input_silence():
    """add with only port 'a' connected: b reads silence (SURVEY 2.4 #2)."""
    x = RNG.standard_normal(T).astype(np.float32)
    g = dst.Graph()
    inp = g.add("input")
    add = g.add("add")
    out = g.add("output")
    g.connect(inp, "out", add, "a")
    g.connect(add, "out", out, "in")
    outs, _, _ = dst.render(g, x[None])
    want = oracle.fanin_average([oracle.fanin_average([x])])
    assert_dbfs(outs[0], want, -110.0)


def test_modulated_gain():
    """signal_gen -> gain.level modulation: [-1,1] -> [0,10] mapping plus
    per-block knob semantics."""
    x = RNG.standard_normal(T).astype(np.float32)
    g = dst.Graph()
    inp = g.add("input")
    lfo = g.add("signal_gen", mode="Sine", frequency=3.0, amplitude=1.0)
    gain = g.add("gain", level=5.0)
    out = g.add("output")
    g.connect(inp, "out", gain, "in")
    g.connect(lfo, "out", gain, "level")
    g.connect(gain, "out", out, "in")
    outs, _, _ = dst.render(g, x[None])

    lfo_sig, _ = oracle.signal_gen("Sine", 1.0, 3.0, T)
    mod = oracle.fanin_average([lfo_sig])
    level = oracle.mod_map(mod, 0.0, 10.0)
    xin = oracle.fanin_average([x])
    y = (xin * level).astype(np.float32)
    want = oracle.fanin_average([y])
    assert_dbfs(outs[0], want)


def test_mux_demux():
    x = RNG.standard_normal(T).astype(np.float32)
    g = dst.Graph()
    inp = g.add("input")
    dmx = g.add("demux", out_port="B")
    mx = g.add("mux", in_port="B")
    out = g.add("output")
    g.connect(inp, "out", dmx, "in")
    g.connect(dmx, "b", mx, "b")
    g.connect(dmx, "a", mx, "a")
    g.connect(mx, "out", out, "in")
    outs, _, _ = dst.render(g, x[None])
    sig = oracle.fanin_average([oracle.fanin_average([oracle.fanin_average([x])])])
    assert_dbfs(outs[0], sig, -100.0)


def test_feedback_cycle_one_block_delay():
    """input -> add -> gain -> (back into add); the back edge carries one
    128-sample block of delay (the defined cycle semantic)."""
    B = 128
    x = RNG.standard_normal(T).astype(np.float32)
    g = dst.Graph()
    inp = g.add("input")
    add = g.add("add")
    fb = g.add("gain", level=0.5)
    out = g.add("output")
    g.connect(inp, "out", add, "a")
    g.connect(add, "out", fb, "in")
    g.connect(fb, "out", add, "b")
    g.connect(add, "out", out, "in")
    outs, _, _ = dst.render(g, x[None])

    # oracle: block-stepped with one-block-delayed feedback
    y_prev_fb = np.zeros(B, np.float32)
    want = np.empty(T, np.float32)
    for b0 in range(0, T, B):
        a_in = oracle.fanin_average([x[b0:b0 + B]])
        b_in = oracle.fanin_average([y_prev_fb])
        add_out = (a_in + b_in).astype(np.float32)
        fb_in = oracle.fanin_average([add_out])
        y_prev_fb = (fb_in * np.float32(0.5)).astype(np.float32)
        want[b0:b0 + B] = oracle.fanin_average([add_out])
    assert_dbfs(outs[0], want, -110.0)


def test_json_roundtrip_and_reference_schema():
    g = dst.Graph()
    sg = g.add("signal_gen", frequency=440.0)
    bq = g.add("biquad", a0=1.0, a1=-0.24, b0=0.758)
    out = g.add("output")
    g.chain(sg, bq)
    g.connect(bq, "out", out, "in")
    cfg = json.loads(dst.dumps_graph(g))

    # reference schema shape (runtime.rs:606-612, 560-564)
    assert set(cfg) == {"nodes", "links"}
    for n in cfg["nodes"]:
        assert set(n) == {"id", "typename", "position", "cfg"}
        assert n["cfg"]["id"] == n["id"]
    for l in cfg["links"]:
        assert set(l) == {"lhs", "rhs"}
        assert len(l["lhs"]) == 2 and len(l["rhs"]) == 2

    g2 = dst.loads_graph(json.dumps(cfg))
    o1, _, _ = dst.render(g, T=512)
    o2, _, _ = dst.render(g2, T=512)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))


def test_restore_id_fetch_max():
    """Fresh IDs after a restore must not collide (ids.rs:16)."""
    g = dst.Graph()
    sg = g.add("signal_gen")
    out = g.add("output")
    g.connect(sg, "out", out, "in")
    s = dst.dumps_graph(g)
    g2 = dst.loads_graph(s)
    n_new = g2.add("gain")
    assert n_new.id not in (sg.id, out.id)
    used_ports = {pid for n in g2.nodes.values()
                  for pid in (*n.in_port_ids.values(), *n.out_port_ids.values())
                  if n.id != n_new.id}
    assert not (set(n_new.in_port_ids.values()) & used_ports)


def test_low_pass_high_pass_cfg_names():
    """'high_pass' restores as High Pass (reference RESTORE behavior,
    nodes/mod.rs:118-119); 'low_pass' as Low Pass; we save Low Pass as
    'low_pass' (documented divergence from the reference's collision bug)."""
    for name, title in [("low_pass", "Low Pass"), ("high_pass", "High Pass")]:
        cfg = {"nodes": [{"id": 0, "typename": name, "position": [0, 0],
                          "cfg": {"id": 0, "inputs": {"in": 1},
                                  "outputs": {"out": 2}, "ratio": 0.25}}],
               "links": []}
        g = dst.loads_graph(json.dumps(cfg))
        node = g.nodes[0]
        assert node.spec.title == title
        assert node.params["ratio"] == 0.25
    g2 = dst.Graph()
    g2.add("low_pass")
    assert json.loads(dst.dumps_graph(g2))["nodes"][0]["typename"] == "low_pass"


def test_batch_vmap_invariance():
    """Same stream at different batch positions gives identical output."""
    x = RNG.standard_normal(T).astype(np.float32)
    g, _ = in_graph("gain", "low_pass")
    batch = np.stack([x[None]] * 4)                 # [4, 1, T]
    outs, _, _ = dst.render(g, batch, batch_shape=(4,))
    for i in range(1, 4):
        np.testing.assert_array_equal(outs[0], outs[i])


def test_generator_graph_no_input():
    g = dst.Graph()
    sg = g.add("signal_gen", frequency=440.0, amplitude=0.9)
    out = g.add("output")
    g.connect(sg, "out", out, "in")
    outs, _, _ = dst.render(g, T=512)
    want, _ = oracle.signal_gen("Sine", 0.9, 440.0, 512)
    assert_dbfs(outs[0], oracle.fanin_average([want]))


def test_analysis_sinks():
    g = dst.Graph()
    sg = g.add("signal_gen", frequency=440.0, amplitude=0.9)
    wv = g.add("wave_view")
    sp = g.add("spectrogram", fft_size=256)
    pt = g.add("pitch")
    for sink in (wv, sp, pt):
        g.connect(sg, "out", sink, "in")
    outs, aux, _ = dst.render(g, T=4096)
    assert f"wave_view:{wv.id}" in aux
    assert f"spectrogram:{sp.id}" in aux
    cols = np.asarray(aux[f"spectrogram:{sp.id}"]["columns"])
    assert cols.shape[0] == 4096 // 256
    freqs = np.asarray(aux[f"pitch:{pt.id}"]["frequency"])
    voiced = np.asarray(aux[f"pitch:{pt.id}"]["voiced"])
    assert voiced.any()
    est = freqs[voiced]
    assert np.all(np.abs(est - 440.0) < 5.0), est


def test_knob_writeback():
    """Quirk 2.4 #9: a connected modulation input drives the slider atomic;
    after a render the knob holds the mapped value of the last block's
    first sample."""
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.ids import IdSpace
    from dsp_stuff_tpu.compiler.compile import apply_knob_writeback
    import numpy as np

    g = dst.Graph(IdSpace())
    sg = g.add("signal_gen", mode="Constant", amplitude=0.5)  # mod signal 0.5
    gn = g.add("gain", level=1.0)
    inp = g.add("input")
    out = g.add("output")
    g.connect(inp, "out", gn, "in")
    g.connect(sg, "out", gn, "level")        # modulate the level knob
    g.connect(gn, "out", out, "in")

    x = np.ones(256, np.float32)
    outs, aux, _ = dst.render(g, {str(inp.id): x})
    # mod signal 0.5 through single-pipe fan-in (/1.0001) then mapped over
    # [0, 10]: ((0.49995+1)/2)*10 = 7.49975
    knob = float(np.asarray(aux["__knobs__"][f"{gn.id}:level"]))
    assert abs(knob - 7.49975) < 1e-3, knob
    apply_knob_writeback(g, aux)
    assert abs(g.nodes[gn.id].params["level"] - knob) < 1e-6


def test_param_automation_arrays():
    """Per-sample param automation: a [T] array in the params pytree
    becomes a time-varying slider (the offline analog of turning a knob
    while audio runs)."""
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.ids import IdSpace
    import numpy as np
    import jax.numpy as jnp

    g = dst.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.0)
    out = g.add("output")
    g.chain(inp, gn, out)
    cg = dst.compile_graph(g)
    T = 512
    x = np.ones(T, np.float32)
    ramp = jnp.linspace(0.0, 2.0, T).astype(jnp.float32)
    p = cg.init_params()
    p[str(gn.id)]["level"] = ramp
    outs, _, _ = cg.render({str(inp.id): x}, params=p)
    want = np.asarray(ramp) / np.float32(1.0001) / np.float32(1.0001)
    np.testing.assert_allclose(np.asarray(outs)[0], want, rtol=1e-5)


def test_batched_render_continuation():
    """The state returned by a batched render feeds back into the next
    batched render (segmented rendering) and equals one continuous run."""
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.ids import IdSpace
    import numpy as np

    g = dst.Graph(IdSpace())
    inp = g.add("input")
    bq = g.add("biquad")
    rv = g.add("reverb", seconds=0.005, decay=0.6)
    out = g.add("output")
    g.chain(inp, bq, rv, out)
    cg = dst.compile_graph(g)
    x = (np.random.default_rng(3).standard_normal((4, 1, 1024)) * 0.3
         ).astype(np.float32)
    full, _, _ = cg.render(x, batch_shape=(4,))
    h1, _, st = cg.render(x[..., :512], batch_shape=(4,))
    h2, _, _ = cg.render(x[..., 512:], batch_shape=(4,), state=st)
    got = np.concatenate([np.asarray(h1), np.asarray(h2)], axis=-1)
    np.testing.assert_allclose(got, np.asarray(full), atol=1e-6)


def test_intra_cycle_modulation_knob():
    """A cycle member modulating another member's as_input knob must
    compile and emit the knob writeback (emit_ports must keep mod-link
    source sequences alive)."""
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.ids import IdSpace
    import numpy as np
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.0)
    od = g.add("overdrive", boost=2.0, drive=0.5, level=0.5)
    out = g.add("output")
    g.connect(inp, "out", gn, "in")
    g.connect(gn, "out", od, "in")
    g.connect(od, "out", gn, "in")      # back edge -> {gn, od} is a cycle
    g.connect(gn, "out", od, "drive")   # intra-cycle modulation link
    g.connect(od, "out", out, "in")
    x = (np.random.default_rng(0).standard_normal(512) * 0.2
         ).astype(np.float32)
    outs, aux, _ = dst.render(g, {str(inp.id): x})
    assert np.isfinite(outs).all()
    assert f"{od.id}:drive" in aux["__knobs__"]


def test_batched_continuation_many_nodes():
    """Segmented batched continuation on a 10+ node graph (state-rank
    comparison must not depend on dict iteration order)."""
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.models import config5_feedback_16node
    import numpy as np
    g, meta = config5_feedback_16node()
    cg = dst.compile_graph(g)
    x = (np.random.default_rng(1).standard_normal((4, 1, 512)) * 0.2
         ).astype(np.float32)
    _, _, st = cg.render(x, batch_shape=(4,))
    outs2, _, _ = cg.render(x, batch_shape=(4,), state=st)
    assert np.isfinite(np.asarray(outs2)).all()


def test_muff_renders_and_responds_to_params():
    """Muff (license-clean Big Muff model): renders finite audio, and the
    tone/level/sustain knobs audibly change the output."""
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.ids import IdSpace
    import numpy as np

    def run(**params):
        g = dst.Graph(IdSpace())
        inp = g.add("input")
        mf = g.add("muff", **params)
        out = g.add("output")
        g.chain(inp, mf, out)
        x = (np.random.default_rng(0).standard_normal(1024) * 0.3
             ).astype(np.float32)
        outs, _, _ = dst.render(g, {str(inp.id): x})
        return np.asarray(outs)[0]

    base = run(toan=0.5, level=0.5, sustain=0.5)
    assert np.isfinite(base).all() and np.abs(base).max() > 1e-4
    dark = run(toan=0.0, level=0.5, sustain=0.5)
    loud = run(toan=0.5, level=1.0, sustain=0.5)
    fuzzy = run(toan=0.5, level=0.5, sustain=1.0)
    for other in (dark, loud, fuzzy):
        assert not np.allclose(base, other)
    # level=1.0 doubles level=0.5's output exactly (output-stage linearity)
    np.testing.assert_allclose(loud, base * 2.0, rtol=1e-5, atol=1e-7)


def test_compiled_fast_graph_builds_constants_at_trace_time():
    """Guard against the traced-constant regression class: with concrete
    slider params (the normal case), the compiled fast-policy program must
    not rebuild recurrence constants on device -- no cumprod (Toeplitz
    powers), and no associative-scan iota ladders from the biquad's
    impulse response.  These cost ~15 us per feedback block when XLA can
    neither fold nor hoist them (fixed round 2; see ops/scan.py)."""
    import json as _json
    from dsp_stuff_tpu.utils import precision
    g = dst.Graph()
    inp = g.add("input")
    ad = g.add("add")
    rv = g.add("reverb", seconds=0.05, decay=0.5)
    lp = g.add("low_pass", ratio=0.4)
    fb = g.add("gain", level=0.45)
    bq = g.add("biquad", a0=1.0, a1=-0.2, a2=0.1, b0=0.8, b1=0.1, b2=0.0)
    out = g.add("output")
    g.connect(inp, "out", ad, "a")
    g.connect(ad, "out", rv, "in")
    g.connect(rv, "out", lp, "in")
    g.connect(lp, "out", fb, "in")
    g.connect(fb, "out", ad, "b")          # feedback cycle
    g.connect(rv, "out", bq, "in")
    g.connect(bq, "out", out, "in")
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        x = jnp.zeros(1280, jnp.float32)
        jaxpr = str(jax.make_jaxpr(lambda s, e: cg.fn(s, e, None))(
            cg.init_state(), {str(inp.id): x}))
    assert "cumprod" not in jaxpr, "Toeplitz powers rebuilt on device"


def test_fitted_params_still_trace():
    """The concrete-constant fast paths must not break traced (fitted)
    coefficients: rendering with a params override pytree still works and
    tracks the override value."""
    from dsp_stuff_tpu.utils import precision
    g = dst.Graph()
    inp = g.add("input")
    lp = g.add("low_pass", ratio=0.3)
    bq = g.add("biquad", a0=1.0, a1=-0.2, a2=0.0, b0=0.8, b1=0.0, b2=0.0)
    out = g.add("output")
    g.chain(inp, lp, bq, out)
    x = np.random.default_rng(0).standard_normal(512).astype(np.float32) * 0.3
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        p = cg.init_params()
        p[str(lp.id)]["ratio"] = jnp.float32(0.7)        # traced override
        a, _, _ = cg.render({str(inp.id): x}, params=p)
        g2 = dst.Graph()
        i2 = g2.add("input")
        l2 = g2.add("low_pass", ratio=0.7)
        b2 = g2.add("biquad", a0=1.0, a1=-0.2, a2=0.0, b0=0.8, b1=0.0,
                    b2=0.0)
        o2 = g2.add("output")
        g2.chain(i2, l2, b2, o2)
        want, _, _ = dst.render(g2, {str(i2.id): x})
    # traced-override coefficients build per-call constants (vs the
    # concrete path's NumPy trace-time constants): a different program,
    # equal to the 1-ulp class on the CPU and an H100 alike
    np.testing.assert_allclose(np.asarray(a), np.asarray(want),
                               rtol=2e-5, atol=2e-6)
