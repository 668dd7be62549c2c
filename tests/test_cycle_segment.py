"""Feedback-cycle mega fusion (ops/cycle_segment.py + compiler
_cycle_program): a whole SCC of supported members evaluates as ONE
block-program op — an unrolled scan over 128-sample blocks — instead of
the per-node cycle scan, preserving the reference's one-block feedback latency
(runtime.rs:718-728) and the per-node state formats.

Reference semantics per member: add.rs:24-34, mix.rs:33-47,
gain.rs:27-38, low_pass.rs:36-41, reverb.rs:87-105, distort.rs:184-194;
the fan-in average is node.rs:173-192."""

import numpy as np
import pytest

import dsp_stuff_tpu as dst
from dsp_stuff_tpu.compiler import compile as compile_mod
from dsp_stuff_tpu.models.presets import config5_feedback_16node
from dsp_stuff_tpu.ops import cycle_segment as cyc
from dsp_stuff_tpu.utils import precision
from oracle import rel_err_db as _db

#: cross-lowering envelope and handed-back states: the 1-ulp rounding
#: class of tests/test_chain_segment.py, on the CPU and an H100 alike
CROSS_DB = -120.0
STATE_ATOL = 2e-6


def _render_scan(g, ext, **kw):
    """Render with the cycle mega path structurally disabled (the
    per-node scan, as before round 4)."""
    compile_mod.CYCLE_FUSION = False
    try:
        cg = compile_mod.compile_graph(g)
        return cg.render(ext, **kw)
    finally:
        compile_mod.CYCLE_FUSION = True


def test_config5_fused_matches_scan():
    """Full 16-node benchmark graph: fused cycle == per-node cycle scan
    to cross-lowering noise, same state treedef, equivalent states."""
    import jax
    g, meta = config5_feedback_16node()
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 0.3).astype(np.float32)
    ext = {str(meta["input"]): x}
    with precision.policy("fast"):
        cg = compile_mod.compile_graph(g)
        y_f, _, st_f = cg.render(ext)
        y_u, _, st_u = _render_scan(g, ext)
    assert _db(y_f, y_u) <= CROSS_DB
    assert jax.tree.structure(st_f) == jax.tree.structure(st_u)


def test_config5_segmented_continuation():
    """Two fused renders chained through state == one fused render
    (bit-level); a SCAN-produced state also continues through the fused
    path (the ring/pos representations are interchangeable)."""
    g, meta = config5_feedback_16node()
    rng = np.random.default_rng(1)
    T, cut = 8192, 4096
    x = (rng.standard_normal(T) * 0.3).astype(np.float32)
    k = str(meta["input"])
    with precision.policy("fast"):
        cg = compile_mod.compile_graph(g)
        y_full, _, _ = cg.render({k: x})
        y1, _, st = cg.render({k: x[:cut]})
        y2, _, _ = cg.render({k: x[cut:]}, state=st)
        y1u, _, st_scan = _render_scan(g, {k: x[:cut]})
        y2x, _, _ = cg.render({k: x[cut:]}, state=st_scan)
    got = np.concatenate([np.asarray(y1)[0], np.asarray(y2)[0]])
    assert _db(got, np.asarray(y_full)[0]) <= CROSS_DB
    gotx = np.concatenate([np.asarray(y1u)[0], np.asarray(y2x)[0]])
    assert _db(gotx, np.asarray(y_full)[0]) <= CROSS_DB


def _loop_graph(seconds=0.008, with_shaper=True):
    """input -> add -> [distort] -> reverb -> lp -> fbgain -> add (back
    edge); reverb also tapped to the output."""
    g = dst.Graph()
    inp = g.add("input")
    mixa = g.add("add")
    rv = g.add("reverb", seconds=seconds, decay=0.5)
    lp = g.add("low_pass", ratio=0.4)
    fbg = g.add("gain", level=0.45)
    out = g.add("output")
    g.connect(inp, "out", mixa, "a")
    if with_shaper:
        dt = g.add("distort", mode="SoftClip", level=2.0)
        g.connect(mixa, "out", dt, "in")
        g.connect(dt, "out", rv, "in")
    else:
        g.connect(mixa, "out", rv, "in")
    g.connect(rv, "out", lp, "in")
    g.connect(lp, "out", fbg, "in")
    g.connect(fbg, "out", mixa, "b")
    g.connect(rv, "out", out, "in")
    return g, inp.id


def test_loop_graph_fused_matches_scan():
    g, inp_id = _loop_graph()
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(2560) * 0.3).astype(np.float32)
    with precision.policy("fast"):
        cg = compile_mod.compile_graph(g)
        y_f, _, _ = cg.render({str(inp_id): x})
        y_u, _, _ = _render_scan(g, {str(inp_id): x})
    assert _db(y_f, y_u) <= CROSS_DB


def test_modulated_member_falls_back_to_scan():
    """An LFO on a member's mod port must reject the program (the scan
    handles modulation); outputs equal the structurally-disabled render
    bit-for-bit because the same path runs."""
    g, inp_id = _loop_graph()
    lfo = g.add("signal_gen", mode="Sine", frequency=1.0, amplitude=0.5)
    # modulate the fb gain level (a mod port on a member)
    fbg = [n for n in g.nodes.values() if n.cfg_name == "gain"][0]
    g.connect(lfo, "out", fbg, "level")
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(1024) * 0.3).astype(np.float32)
    with precision.policy("fast"):
        cg = compile_mod.compile_graph(g)
        y_f, _, _ = cg.render({str(inp_id): x})
        y_u, _, _ = _render_scan(g, {str(inp_id): x})
    np.testing.assert_array_equal(np.asarray(y_f), np.asarray(y_u))


def test_unsupported_member_falls_back():
    """A chorus inside the loop cannot lower; the scan path runs."""
    g = dst.Graph()
    inp = g.add("input")
    mixa = g.add("add")
    ch = g.add("chorus", rate=1.0, depth=0.002, base=0.006, mix=0.3)
    fbg = g.add("gain", level=0.3)
    out = g.add("output")
    g.connect(inp, "out", mixa, "a")
    g.connect(mixa, "out", ch, "in")
    g.connect(ch, "out", fbg, "in")
    g.connect(fbg, "out", mixa, "b")
    g.connect(ch, "out", out, "in")
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(1024) * 0.3).astype(np.float32)
    with precision.policy("fast"):
        cg = compile_mod.compile_graph(g)
        y_f, _, _ = cg.render({str(inp.id): x})
        y_u, _, _ = _render_scan(g, {str(inp.id): x})
    np.testing.assert_array_equal(np.asarray(y_f), np.asarray(y_u))


def test_self_link_single_node_cycle():
    """A single add with a self back edge (out -> b) is the smallest
    SCC; the program's register read-before-write gives the one-block
    delay."""
    g = dst.Graph()
    inp = g.add("input")
    mixa = g.add("add")
    out = g.add("output")
    g.connect(inp, "out", mixa, "a")
    g.connect(mixa, "out", mixa, "b")
    g.connect(mixa, "out", out, "in")
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(1024) * 0.1).astype(np.float32)
    with precision.policy("fast"):
        cg = compile_mod.compile_graph(g)
        y_f, _, _ = cg.render({str(inp.id): x})
        y_u, _, _ = _render_scan(g, {str(inp.id): x})
    assert _db(y_f, y_u) <= CROSS_DB


def test_node_hook_bypasses_cycle_fusion():
    g, meta = config5_feedback_16node()
    seen = []
    cg = compile_mod.compile_graph(g)
    x = np.zeros(512, np.float32)
    compile_mod.NODE_HOOK = lambda nid, cfg, outs: seen.append(cfg)
    try:
        with precision.policy("fast"):
            cg.render({str(meta["input"]): x})
    finally:
        compile_mod.NODE_HOOK = None
    assert "reverb" in seen and "add" in seen


def test_parity_policy_bypasses_cycle_fusion():
    g, meta = config5_feedback_16node()
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(2048) * 0.3).astype(np.float32)
    with precision.policy("fast"):
        cg = compile_mod.compile_graph(g)
        y_f, _, _ = cg.render({str(meta["input"]): x})
    with precision.policy("parity"):
        cg2 = compile_mod.compile_graph(g)
        y_p, _, _ = cg2.render({str(meta["input"]): x})
    assert _db(y_f, y_p) <= -80.0


def test_cycle_segment_grad_matches_interpreter():
    """Reverse-mode gradients through the block program agree with its
    forward-mode derivative along a random direction (the scan carries
    registers, cascade carries and comb rings through both)."""
    import jax
    import jax.numpy as jnp
    h = float(np.float32(1.0) / np.float32(1.0001))
    prog = (
        ("lin2", (("ext", 0),), h, (("reg", 0),), h, 1.0, 1.0),
        ("setreg", 1),
        ("join", (("reg", 1),), h),
        ("comb", 0.5, 256, 0),
        ("tap", 0),
        ("join", (("reg", 1),), h),
        ("cascade", (("lp", 0.4), ("gain", 0.45)), 0),
        ("setreg", 0),
    )
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(512) * 0.3, jnp.float32)
    regs0 = (jnp.zeros(128, jnp.float32), jnp.zeros(128, jnp.float32))
    states = (jnp.zeros(256, jnp.float32), jnp.zeros(1, jnp.float32))

    def loss_seg(x):
        taps, _, _, _ = cyc.cycle_segment((x,), regs0, states, prog, 1)
        return jnp.sum(taps[0] ** 2)

    v = jnp.asarray(rng.standard_normal(512), jnp.float32)
    with precision.policy("fast"):
        g = jax.grad(loss_seg)(x)
        _, dv = jax.jvp(loss_seg, (x,), (v,))
    np.testing.assert_allclose(float(jnp.vdot(g, v)), float(dv),
                               rtol=1e-4)
