"""The five BASELINE.json benchmark configurations render end-to-end."""

import numpy as np
import pytest

import dsp_stuff_tpu as dst
from dsp_stuff_tpu.models import PRESETS
from dsp_stuff_tpu.utils import precision

RNG = np.random.default_rng(0)


def _input(T, shape=()):
    return (RNG.standard_normal((*shape, T)) * 0.25).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_renders(name):
    if name == "config4":
        g, meta = PRESETS[name](ir_seconds=0.05)   # short IR for test speed
    else:
        g, meta = PRESETS[name]()
    T = 4096
    x = _input(T)
    with precision.policy("fast"):
        outs, aux, state = dst.render(g, {str(meta["input"]): x})
    assert outs.shape[-1] == T
    assert np.isfinite(outs).all(), name
    assert np.abs(outs).max() > 1e-6, f"{name} rendered silence"


def test_config4_stereo_outputs_differ():
    g, meta = PRESETS["config4"](ir_seconds=0.05)
    x = _input(4096)
    outs, _, _ = dst.render(g, {str(meta["input"]): x})
    assert outs.shape[0] == 2
    assert not np.allclose(outs[0], outs[1])       # decorrelated stereo IRs


def test_config5_batched_64_streams():
    g, meta = PRESETS["config5"]()
    T = 1024
    x = _input(T, (64,))
    with precision.policy("fast"):
        outs, aux, _ = dst.render(g, {str(meta["input"]): x},
                                  batch_shape=(64,))
    assert outs.shape == (64, 1, T)
    assert np.isfinite(outs).all()
    # streams are independent: stream 0 result == solo render of stream 0
    solo, _, _ = dst.render(g, {str(meta["input"]): x[0]})
    # batched vs solo lowerings: 1-ulp class (CPU and H100 alike)
    np.testing.assert_allclose(outs[0], solo, atol=2e-6)


def test_config5_feedback_alive():
    """The rv->lp->gain->add back edge must actually feed back: an impulse
    must echo at the delay period."""
    g, meta = PRESETS["config5"]()
    T = 48_000
    x = np.zeros(T, np.float32)
    x[100] = 1.0
    with precision.policy("fast"):
        outs, _, _ = dst.render(g, {str(meta["input"]): x})
    y = np.abs(outs[0])
    D = int(0.15 * 48_000)
    # energy near the first and second echo (the wet path is attenuated by
    # mix ratio, envelope follower and biquad, so levels are small but
    # must be clearly above the zero floor and geometrically decaying)
    e1 = y[100 + D - 200: 100 + D + 400].max()
    e2 = y[100 + 2 * D - 200: 100 + 2 * D + 400].max()
    assert e1 > 3e-5 and e2 > 1e-5, (e1, e2)


def test_preset_json_roundtrip():
    for name, build in PRESETS.items():
        g, meta = (build(ir_seconds=0.02) if name == "config4" else build())
        text = dst.dumps_graph(g)
        g2 = dst.loads_graph(text)
        x = _input(2048)
        a, _, _ = dst.render(g, {str(meta["input"]): x})
        b, _, _ = dst.render(g2, {str(meta["input"]): x})
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_config1_parity_vs_oracle():
    """Graph-level end-to-end parity: config1 (gain -> biquad low-pass)
    under the parity policy vs the composed sequential oracle."""
    import oracle
    g, meta = PRESETS["config1"]()
    x = _input(4096)
    with precision.policy("parity"):
        outs, _, _ = dst.render(g, {str(meta["input"]): x})
    F32 = np.float32

    def hop(v):
        return (v / F32(F32(1.0) + F32(0.0001))).astype(F32)

    bq = g.nodes_of_type("biquad")[0]
    p = bq.params
    v = hop(x.astype(F32))
    v = (v * F32(1.5)).astype(F32)
    v, _ = oracle.biquad_df1(hop(v), p["a0"], p["a1"], p["a2"],
                             p["b0"], p["b1"], p["b2"])
    want = hop(v)
    db = oracle.max_err_dbfs(np.asarray(outs)[0], want)
    assert db <= -90.0, db


def _h(v):
    """One fan-in hop: a single-source port divides by (1 + 1e-4) in f32
    (node.rs:166,190-192)."""
    F32 = np.float32
    return (np.asarray(v, F32) / F32(F32(1.0) + F32(0.0001))).astype(F32)


def test_config3_parity_vs_oracle():
    """Config #3 (4x-oversampled overdrive -> tanh distortion) under the
    parity policy vs the composed oracle: reference shaper semantics
    (overdrive.rs:31-43, distort.rs Tanh) wrapped in the f64 NumPy mirror
    of our polyphase rate converters (extension; ops/oversample.py)."""
    import oracle
    g, meta = PRESETS["config3"]()
    T = 2048
    x = _input(T)
    with precision.policy("parity"):
        outs, _, _ = dst.render(g, {str(meta["input"]): x})
    v = _h(x)
    v = oracle.oversampled(
        lambda u: oracle.overdrive(u, 8.0, 0.8, 0.9), v, 4)
    v = oracle.oversampled(
        lambda u: oracle.tanh_clip(u, 6.0), _h(v), 4)
    want = _h(v)
    db = oracle.max_err_dbfs(np.asarray(outs)[0], want)
    assert db <= -90.0, db


def test_config4_parity_vs_oracle():
    """Config #4 (stereo convolution reverb = two FIR nodes) under parity
    vs the per-sample f64-accumulate FIR oracle (fir.rs:179-225)."""
    import oracle
    g, meta = PRESETS["config4"](ir_seconds=0.02)
    T = 1024
    x = _input(T)
    with precision.policy("parity"):
        outs, _, _ = dst.render(g, {str(meta["input"]): x})
    for k, fid in enumerate(meta["firs"]):
        taps_rev = np.asarray(g.nodes[fid].params["taps"], np.float64)
        v, _ = oracle.fir(_h(x), taps_rev, mode="Balanced")
        want = _h(v)
        db = oracle.max_err_dbfs(np.asarray(outs)[k], want)
        assert db <= -90.0, (k, db)


def _oracle_config5(x):
    """Composed sequential oracle of the whole 16-node feedback graph,
    replicating the compiler's defined cycle semantics: SCC members (mixa,
    rv, lp, fbg — ascending id) run per 128-block; the one edge from a
    not-yet-run member (fbg -> mixa.b) carries the previous block
    (compiler/compile.py _eval_cycle).  Node math comes from the per-node
    oracles (reference file:line cites there); chorus is the extension
    oracle (ops/modfx.py semantics)."""
    import oracle
    F32 = np.float32
    T = len(x)
    B = 128

    pre = (_h(x) * F32(1.2)).astype(F32)
    lfo, _ = oracle.signal_gen("Sine", 0.6, 0.5, T)
    drive = oracle.mod_map(oracle.fanin_average([lfo]), 0.0, 1.0)
    od = oracle.overdrive(_h(pre), 6.0, drive, 0.8)
    dist = oracle.soft_clip(_h(od), 4.0)

    # feedback SCC, per 128-block
    ring = np.zeros(int(F32(0.15) * F32(48000.0)), F32)   # reverb.rs:57
    z_lp = F32(0.0)
    prev_fbg = np.zeros(B, F32)
    rv_seq = np.empty(T, F32)
    for b in range(0, T, B):
        mixa = (_h(dist[b:b + B]) + _h(prev_fbg)).astype(F32)
        rv, ring = oracle.reverb(_h(mixa), 0.15, 0.5, ring)
        lp, z_lp = oracle.low_pass(_h(rv), 0.4, z_lp)
        prev_fbg = (_h(lp) * F32(0.45)).astype(F32)
        rv_seq[b:b + B] = rv

    hp, _ = oracle.high_pass(_h(rv_seq), 0.05)
    ch, _, _ = oracle.chorus(_h(hp), 1.2, 0.003, 0.008, 0.4)
    a, bb, r = _h(pre), _h(ch), F32(0.6)
    mx = ((bb * r).astype(F32)
          + (a * F32(F32(1.0) - r)).astype(F32)).astype(F32)
    env, _ = oracle.envelope(_h(mx), 50.0, 400.0)
    bq, _ = oracle.biquad_df1(_h(env), 1.0, -0.2, 0.0, 0.8, 0.0, 0.0)
    return _h(bq)


def test_config5_parity_vs_oracle():
    """Graph-level end-to-end parity for the 16-node feedback benchmark
    graph (VERDICT r1 #7): parity-policy render vs the composed sequential
    oracle, including the feedback block latency, the LFO->drive modulation
    mapping, and every fan-in hop."""
    import oracle
    g, meta = PRESETS["config5"]()
    T = 48_000
    x = _input(T)
    with precision.policy("parity"):
        outs, _, _ = dst.render(g, {str(meta["input"]): x})
    want = _oracle_config5(x)
    db = oracle.max_err_dbfs(np.asarray(outs)[0], want)
    assert db <= -90.0, db


def test_config2_parity_vs_oracle():
    """Config #2 (echo + chorus): reverb oracle (reverb.rs:76-111) composed
    with the extension chorus oracle."""
    import oracle
    g, meta = PRESETS["config2"]()
    T = 4096
    x = _input(T)
    with precision.policy("parity"):
        outs, _, _ = dst.render(g, {str(meta["input"]): x})
    F32 = np.float32
    v, _ = oracle.reverb(_h(x), 0.25, 0.45, None)
    v, _, _ = oracle.chorus(_h(v), 0.8, 0.004, 0.012, 0.5)
    v = (_h(v) * F32(0.9)).astype(F32)
    want = _h(v)
    db = oracle.max_err_dbfs(np.asarray(outs)[0], want)
    assert db <= -90.0, db


def test_config5_stereo_pair_batching():
    """BASELINE names batch_shape=(64, 2): nested vmap with shared
    (lockstep) state leaves must compile and match the flat batch."""
    g, meta = PRESETS["config5"]()
    T = 512
    x = _input(T, (4, 2))
    with precision.policy("fast"):
        outs, _, st = dst.render(g, {str(meta["input"]): x},
                                 batch_shape=(4, 2))
        flat, _, _ = dst.render(g, {str(meta["input"]): x.reshape(8, T)},
                                batch_shape=(8,))
    assert outs.shape == (4, 2, 1, T)
    np.testing.assert_allclose(np.asarray(outs).reshape(8, 1, T),
                               np.asarray(flat), atol=1e-6)


def test_parity_no_drift_long_render():
    """Reassociation error must not accumulate over long audio: the
    10-node chain at 10 s stays at the ~-122 dBFS parity floor (SURVEY's
    'IIR numerics vs parallelism' hard part).  Runs the slow per-sample
    oracle, ~15 s."""
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    import oracle
    g, inp_id = bench.build_chain()
    T = 48_000 * 10
    x = (np.random.default_rng(0).standard_normal(T) * 0.25
         ).astype(np.float32)
    with precision.policy("parity"):
        cg = dst.compile_graph(g)
        outs, _, _ = cg.render({str(inp_id): x})
    got = np.asarray(outs)[0].astype(np.float64)
    want = oracle.chain10(x).astype(np.float64)
    err = np.max(np.abs(got - want))
    db = 20 * np.log10(err) if err > 0 else -np.inf
    assert db <= -90.0, db
