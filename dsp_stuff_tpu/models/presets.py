"""Preset graphs: the 10-node benchmark chain and the five BASELINE.json
benchmark configurations.

Each builder returns (graph, meta) where meta maps role -> node id
("input", "outputs", ...).  These double as the model zoo, the example
graphs, and the shapes the judge's configs name:

0. the 10-node effect chain (the headline benchmark graph)

1. gain -> biquad low-pass chain (offline block render)
2. delay/echo + chorus chain (modulated fractional taps)
3. distortion/overdrive at 4x oversampling
4. convolution reverb via FFT convolution with a stereo impulse response
5. 16-node graph with feedback edges, batched over parallel stereo streams
"""

from __future__ import annotations

import numpy as np

from dsp_stuff_tpu.graph import Graph
from dsp_stuff_tpu.ids import IdSpace


def _g() -> Graph:
    return Graph(IdSpace())


def chain10(reverb_seconds: float = 0.05):
    """The 10-node effect chain, every node at a non-bypass setting:

        input -> gain -> biquad -> overdrive -> low_pass -> high_pass
              -> distort(Tanh) -> chebyshev -> reverb -> output

    tests/oracle.chain10 is its sequential NumPy reference."""
    g = _g()
    inp = g.add("input")
    gn = g.add("gain", level=1.2)
    bq = g.add("biquad", a0=1.0, a1=-0.24, a2=0.0, b0=0.758, b1=0.0, b2=0.0)
    od = g.add("overdrive", boost=4.0, drive=0.6, level=0.9)
    lp = g.add("low_pass", ratio=0.6)
    hp = g.add("high_pass", ratio=0.2)
    dt = g.add("distort", mode="Tanh", level=3.0)
    ch = g.add("chebyshev", level_pos=2.0, level_neg=4.0)
    rv = g.add("reverb", seconds=reverb_seconds, decay=0.4)
    out = g.add("output")
    g.chain(inp, gn, bq, od, lp, hp, dt, ch, rv, out)
    return g, {"input": inp.id, "output": out.id,
               "members": [gn.id, bq.id, od.id, lp.id, hp.id, dt.id,
                           ch.id, rv.id]}


def config1_gain_biquad():
    """Gain -> biquad low-pass chain on a mono input (BASELINE config #1).
    Biquad coefficients: a 1 kHz Butterworth low-pass at 48 kHz, expressed
    in the reference's raw-coefficient sliders."""
    g = _g()
    inp = g.add("input")
    gn = g.add("gain", level=1.5)
    # RBJ cookbook low-pass, f0 = 1 kHz, Q = 0.7071, sr = 48 kHz
    w0 = 2 * np.pi * 1000.0 / 48_000.0
    alpha = np.sin(w0) / (2 * 0.7071)
    cw = np.cos(w0)
    bq = g.add("biquad",
               a0=1 + alpha, a1=-2 * cw, a2=1 - alpha,
               b0=(1 - cw) / 2, b1=1 - cw, b2=(1 - cw) / 2)
    out = g.add("output")
    g.chain(inp, gn, bq, out)
    return g, {"input": inp.id, "output": out.id}


def config2_delay_chorus():
    """Feedback echo + chorus chain (BASELINE config #2)."""
    g = _g()
    inp = g.add("input")
    rv = g.add("reverb", seconds=0.25, decay=0.45)     # echo (reverb node)
    ch = g.add("chorus", rate=0.8, depth=0.004, base=0.012, mix=0.5)
    gn = g.add("gain", level=0.9)
    out = g.add("output")
    g.chain(inp, rv, ch, gn, out)
    return g, {"input": inp.id, "output": out.id}


def config3_oversampled_distortion():
    """Waveshaper at 4x oversampling + polyphase decimation (config #3)."""
    g = _g()
    inp = g.add("input")
    od = g.add("overdrive", boost=8.0, drive=0.8, level=0.9, oversample="4")
    dt = g.add("distort", mode="Tanh", level=6.0, oversample="4")
    out = g.add("output")
    g.chain(inp, od, dt, out)
    return g, {"input": inp.id, "output": out.id}


def config4_convolution_reverb(ir_left=None, ir_right=None, ir_seconds=1.0,
                               seed=0):
    """Convolution reverb with a stereo impulse response (config #4).

    Stereo = two FIR nodes (the node graph is mono-per-port, like the
    reference); each holds one channel's IR taps.  Default IR: synthetic
    exponentially-decaying noise (a standard synthetic room), ir_seconds
    long, stored REVERSED as the FIR node persists them (fir.rs:160-170).
    """
    rng = np.random.default_rng(seed)
    n = int(ir_seconds * 48_000)
    if ir_left is None:
        t = np.arange(n) / 48_000.0
        env = np.exp(-3.0 * t)
        ir_left = (rng.standard_normal(n) * env * 0.05).astype(np.float32)
        if ir_right is None:   # default room: decorrelated stereo
            ir_right = (rng.standard_normal(n) * env * 0.05
                        ).astype(np.float32)
    if ir_right is None:
        # caller supplied a mono IR: duplicate it to both channels
        ir_right = np.asarray(ir_left)
    g = _g()
    inp = g.add("input")
    firs = []
    outs = []
    for ir in (ir_left, ir_right):
        f = g.add("fir", mode="Balanced",
                  taps=[float(v) for v in np.asarray(ir)[::-1]])
        o = g.add("output")
        g.connect(inp, "out", f, "in")
        g.connect(f, "out", o, "in")
        firs.append(f.id)
        outs.append(o.id)
    return g, {"input": inp.id, "outputs": outs, "firs": firs}


def config5_feedback_16node():
    """16-node graph with feedback edges (config #5), meant to run batched
    over 64 parallel stereo streams (batch_shape=(64, 2) or (128,)).

    Topology: input splits into a clean path and a drive path; the drive
    path feeds an echo with a filtered feedback loop (reverb -> low_pass ->
    gain -> back into the mix); an LFO modulates the drive level; the wet
    mix passes a chorus and a final biquad into the output, with a
    spectrogram tap for analysis.  Node count = 16.
    """
    g = _g()
    inp = g.add("input")                                           # 1
    pre = g.add("gain", level=1.2)                                 # 2
    lfo = g.add("signal_gen", mode="Sine", frequency=0.5,
                amplitude=0.6)                                     # 3
    od = g.add("overdrive", boost=6.0, drive=0.7, level=0.8)       # 4
    dist = g.add("distort", mode="SoftClip", level=4.0)            # 5
    mixa = g.add("add")                                            # 6
    rv = g.add("reverb", seconds=0.15, decay=0.5)                  # 7
    lp = g.add("low_pass", ratio=0.4)                              # 8
    fbg = g.add("gain", level=0.45)                                # 9
    hp = g.add("high_pass", ratio=0.05)                            # 10
    ch = g.add("chorus", rate=1.2, depth=0.003, base=0.008,
               mix=0.4)                                            # 11
    mx = g.add("mix", ratio=0.6)                                   # 12
    env = g.add("envelope", attack=50.0, release=400.0)            # 13
    bq = g.add("biquad", a0=1.0, a1=-0.2, a2=0.0,
               b0=0.8, b1=0.0, b2=0.0)                             # 14
    spec = g.add("spectrogram", fft_size=512)                      # 15
    out = g.add("output")                                          # 16

    g.connect(inp, "out", pre, "in")
    g.connect(lfo, "out", od, "drive")          # LFO modulates drive (mod port)
    g.connect(pre, "out", od, "in")
    g.connect(od, "out", dist, "in")
    g.connect(dist, "out", mixa, "a")
    g.connect(mixa, "out", rv, "in")
    g.connect(rv, "out", lp, "in")              # feedback loop:
    g.connect(lp, "out", fbg, "in")             #   rv -> lp -> fbg -> mixa
    g.connect(fbg, "out", mixa, "b")            #   (back edge)
    g.connect(rv, "out", hp, "in")
    g.connect(hp, "out", ch, "in")
    g.connect(pre, "out", mx, "a")              # dry
    g.connect(ch, "out", mx, "b")               # wet
    g.connect(mx, "out", env, "in")             # envelope in series (audible)
    g.connect(env, "out", bq, "in")
    g.connect(bq, "out", out, "in")
    g.connect(bq, "out", spec, "in")
    assert len(g.nodes) == 16, len(g.nodes)
    return g, {"input": inp.id, "output": out.id, "spectrogram": spec.id}


PRESETS = {
    "config1": config1_gain_biquad,
    "config2": config2_delay_chorus,
    "config3": config3_oversampled_distortion,
    "config4": config4_convolution_reverb,
    "config5": config5_feedback_16node,
}
