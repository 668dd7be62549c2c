"""Headline benchmark: real-time factor of a 10-node stereo chain @ 48 kHz.

BASELINE.json north star: >= 1000x real-time per chip on a 10-node stereo
chain at <= -90 dBFS max error vs the Rust reference.  The reference's own
implicit operating point is 1.0x real-time (a live effects rack,
/root/reference/README.md:48), which is the ``vs_baseline`` denominator.

Prints exactly ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Runs on one NVIDIA GPU and refuses to run without one.  The chain is
models/presets.chain10 (10 nodes, all at non-bypass values):

    input -> gain -> biquad -> overdrive -> low_pass -> high_pass
          -> distort(Tanh) -> chebyshev -> reverb -> output

Timing uses the 'fast' precision policy (the throughput mode) and ends each
timed call with ``block_until_ready``; the accuracy extra re-renders under
the 'parity' policy and compares against the sequential NumPy oracle
(tests/oracle) of the reference's per-sample semantics, reported in dBFS.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

import numpy as np


SECONDS = 60.0          # audio length per timed render
# chained renders per timing (state-fed, serialized inside ONE dispatch)
N_CHAIN = 50
N_TIMED = 3             # timings (best-of)
SR = 48_000
# parity-accuracy render length (seconds); override for quick local runs.
# Clamped to SECONDS: the accuracy slice reuses the timed input signal, so
# a larger request would silently truncate while reporting the requested
# length.
ACC_SECONDS = min(float(os.environ.get("DST_BENCH_ACC_SECONDS", "10")),
                  SECONDS)


def build_chain():
    """The 10-node chain (models/presets.chain10) and its input id."""
    from dsp_stuff_tpu.models import chain10
    g, meta = chain10()
    return g, meta["input"]


# Published peaks per device kind (NVIDIA H100 SXM data sheet: dense
# rates without sparsity, at the card's 700 W power limit).  A device
# kind missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "fp32_tflops": 67.0,
                              "tf32_tflops": 495.0, "bf16_tflops": 989.0,
                              "power_limit_w": 700.0},
}


def device_peaks(dev):
    """The PEAKS entry for a JAX device; raises off an NVIDIA GPU or for
    a kind the table lacks."""
    if dev.platform != "gpu":
        raise RuntimeError(f"bench needs an NVIDIA GPU, found {dev.platform}")
    if dev.device_kind not in PEAKS:
        raise KeyError(f"no published peaks for {dev.device_kind!r}")
    return PEAKS[dev.device_kind]


def main():
    import jax
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.utils import precision
    from dsp_stuff_tpu.utils.compile_cache import enable_compile_cache
    from dsp_stuff_tpu.utils.obs import card_name_and_power_limit

    enable_compile_cache()
    dev = jax.devices()[0]
    global HBM_GBPS
    HBM_GBPS = device_peaks(dev)["hbm_gbps"]
    card = card_name_and_power_limit()
    print(f"bench: {card}", file=sys.stderr)
    g, inp_id = build_chain()

    T = int(SECONDS * SR)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 1, T)) * 0.25).astype(np.float32)  # stereo

    # --- throughput (fast policy) ---
    best, hl_bytes = _time_chained_renders(g, {str(inp_id): x[:, 0, :]},
                                           batch=2, n_chain=N_CHAIN)
    rtf = SECONDS * N_CHAIN / best

    # --- batched throughput: 16-node feedback graph, 64 stereo streams ---
    # (BASELINE config #5: 128 mono streams = 64 stereo pairs, 10 s each)
    # Secondary sections degrade gracefully: one failing section must not
    # kill the headline metric.
    rtf_batched = None
    acc_dbfs = None
    gbps = {"headline": _gbps(hl_bytes, best)}
    try:
        rtf_batched, gbps["config5"] = _batched_metric(jax, dst, precision,
                                                       rng)
    except Exception as e:
        print(f"bench: batched metric failed: {e!r}", file=sys.stderr)

    try:
        acc_dbfs = _accuracy_metric(jax, dst, precision, g, inp_id, x)
    except Exception as e:
        print(f"bench: accuracy metric failed: {e!r}", file=sys.stderr)

    # fast-path accuracy: the batched fast path — the one producing the
    # aggregate numbers — against the oracle
    fast_acc = {}
    try:
        fast_acc = _fast_accuracy_metric(dst, precision, rng)
    except Exception as e:
        print(f"bench: fast-accuracy metric failed: {e!r}", file=sys.stderr)

    cfg_rtf = {}
    for name in ("config2", "config3", "config4"):
        try:
            r, gbps[name] = _config_metric(name, rng)
            cfg_rtf[name] = round(r, 1)
        except Exception as e:
            print(f"bench: {name} metric failed: {e!r}", file=sys.stderr)
            cfg_rtf[name] = None

    rtf_maxbatch = None
    try:
        rtf_maxbatch, gbps["batch512"] = _max_throughput_metric(rng)
    except Exception as e:
        print(f"bench: max-throughput metric failed: {e!r}", file=sys.stderr)

    # batch-1024 companion
    rtf_maxbatch_1k = None
    try:
        rtf_maxbatch_1k, gbps["batch1024"] = _max_throughput_metric(
            rng, batch=1024)
    except Exception as e:
        print(f"bench: batch-1024 metric failed: {e!r}", file=sys.stderr)

    # batched aggregates for the remaining configs
    cfg_batch = {}
    for name, nb in (("config2", 512), ("config3", 512), ("config4", 256),
                     ("config5", 512)):
        try:
            r, gb = _config_batched_metric(name, rng, nb)
            cfg_batch[name] = (round(r, 1), gb, nb)
        except Exception as e:
            print(f"bench: {name} batched metric failed: {e!r}",
                  file=sys.stderr)
            cfg_batch[name] = (None, None, nb)

    stream_rtf = {}
    try:
        stream_rtf = _streaming_metric()
    except Exception as e:
        print(f"bench: streaming metric failed: {e!r}", file=sys.stderr)

    print(json.dumps({
        "metric": "rtf_10node_stereo_chain_48k",
        "value": round(rtf, 1),
        "unit": "x_realtime_per_chip",
        "vs_baseline": round(rtf / 1.0, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "audio_seconds": SECONDS,
        "wall_seconds_best": round(best, 4),
        "accuracy_dbfs_vs_oracle_parity":
            round(float(acc_dbfs), 1) if acc_dbfs is not None else None,
        "accuracy_render_seconds": ACC_SECONDS,
        # fast policy at batch vs the NumPy oracles of the reference
        # semantics, stream 0
        "accuracy_dbfs_fast_chain_batch512": fast_acc.get("chain_batch512"),
        "accuracy_dbfs_fast_config5_batch128": fast_acc.get("config5"),
        "accuracy_dbfs_fast_config2_batch128": fast_acc.get("config2"),
        "rtf_16node_feedback_64_stereo_streams":
            round(rtf_batched, 1) if rtf_batched is not None else None,
        "rtf_config2_echo_chorus": cfg_rtf.get("config2"),
        "rtf_config3_oversampled_distortion": cfg_rtf.get("config3"),
        "rtf_config4_convolution_reverb_stereo": cfg_rtf.get("config4"),
        "rtf_10node_chain_batch512_aggregate":
            round(rtf_maxbatch, 1) if rtf_maxbatch is not None else None,
        "pct_hbm_roofline_batch512": _pct_roofline(rtf_maxbatch, 1, 1),
        "rtf_10node_chain_batch1024_aggregate":
            round(rtf_maxbatch_1k, 1) if rtf_maxbatch_1k is not None
            else None,
        "pct_hbm_roofline_batch1024": _pct_roofline(rtf_maxbatch_1k, 1, 1),
        # batched aggregates for the other configs (aggregate audio-s/s
        # across all streams; config4 at 256 streams — stereo outs +
        # overlap-save FFT frames double its footprint)
        "rtf_config2_batch512_aggregate": cfg_batch.get("config2",
                                                        (None,))[0],
        "rtf_config3_batch512_aggregate": cfg_batch.get("config3",
                                                        (None,))[0],
        "rtf_config4_batch256_aggregate": cfg_batch.get("config4",
                                                        (None,))[0],
        "rtf_config5_batch512_aggregate": cfg_batch.get("config5",
                                                        (None,))[0],
        "pct_hbm_roofline_config2_batch": _pct_roofline(
            cfg_batch.get("config2", (None,))[0], 1, 1),
        "pct_hbm_roofline_config3_batch": _pct_roofline(
            cfg_batch.get("config3", (None,))[0], 1, 1),
        "pct_hbm_roofline_config4_batch": _pct_roofline(
            cfg_batch.get("config4", (None,))[0], 1, 2),
        "pct_hbm_roofline_config5_batch": _pct_roofline(
            cfg_batch.get("config5", (None,))[0], 1, 1),
        "achieved_gbps_config2_batch": cfg_batch.get("config2",
                                                     (None, None))[1],
        "achieved_gbps_config3_batch": cfg_batch.get("config3",
                                                     (None, None))[1],
        "achieved_gbps_config4_batch": cfg_batch.get("config4",
                                                     (None, None))[1],
        "achieved_gbps_config5_batch": cfg_batch.get("config5",
                                                     (None, None))[1],
        # stream counts per set match the graphs (models/presets.py):
        # headline chain is a stereo pair (2 in, 2 out); config2/3/5 are
        # 1-in/1-out mono; config4 is 1 mono in, 2 outs (stereo reverb).
        "pct_hbm_roofline_headline": _pct_roofline(rtf, 2, 2),
        "pct_hbm_roofline_config5": _pct_roofline(rtf_batched, 1, 1),
        "pct_hbm_roofline_config2": _pct_roofline(cfg_rtf.get("config2"),
                                                  1, 1),
        "pct_hbm_roofline_config3": _pct_roofline(cfg_rtf.get("config3"),
                                                  1, 1),
        "pct_hbm_roofline_config4": _pct_roofline(cfg_rtf.get("config4"),
                                                  1, 2),
        "hbm_gbps_assumed": HBM_GBPS,
        # MEASURED achieved HBM bandwidth per section: XLA's own
        # bytes-accessed cost model for the compiled program (operand
        # reads + output writes per fused op) divided by the measured
        # wall time -- the trace-derived counterpart of the pure-I/O
        # roofline estimates above (None when the backend's
        # cost_analysis is unavailable)
        "achieved_gbps_headline": gbps.get("headline"),
        "achieved_gbps_batch512": gbps.get("batch512"),
        "achieved_gbps_batch1024": gbps.get("batch1024"),
        "achieved_gbps_config5": gbps.get("config5"),
        "achieved_gbps_config2": gbps.get("config2"),
        "achieved_gbps_config3": gbps.get("config3"),
        "achieved_gbps_config4": gbps.get("config4"),
        "rtf_streaming_block128": stream_rtf.get("block128"),
        "rtf_streaming_block2048": stream_rtf.get("block2048"),
        "rtf_streaming_pipelined_1s": stream_rtf.get("pipelined_1s"),
        "target_rtf": 1000.0,
        "target_accuracy_dbfs": -90.0,
    }))


# Device-memory bandwidth of the card in use (PEAKS, set by main).  The
# roofline percentage is wall-clock vs the pure-I/O lower bound: even a
# perfectly fused graph must read every input stream and write every
# output stream through device memory once, so
# time_min = streams_io * T * 4 bytes / BW.
HBM_GBPS = None


def _pct_roofline(rtf, n_streams_io_in: int, n_streams_io_out: int):
    """% of the HBM speed-of-light floor achieved.

    ``rtf`` is audio-seconds per wall-second for ONE stream-set; a
    stream-set moves (in + out) * 48000 * 4 bytes per audio-second, so the
    achieved HBM floor rate is rtf * bytes_per_audio_s, reported as a
    percentage of HBM_GBPS.  100% = the render is as fast as merely
    streaming its I/O through device memory once."""
    if rtf is None:
        return None
    bytes_per_audio_s = (n_streams_io_in + n_streams_io_out) * SR * 4
    return round(100.0 * rtf * bytes_per_audio_s / (HBM_GBPS * 1e9), 2)


def _streaming_metric():
    """StreamSession operating points on this device: per-dispatch blocks
    at 128 and 2048 samples (each process() call pays one dispatch and
    one host fetch), and the pipelined path (process_many: 375 blocks =
    1 s of audio per dispatch via lax.scan)."""
    from dsp_stuff_tpu.runtime.stream import StreamSession
    from dsp_stuff_tpu.utils import precision

    res = {}
    with precision.policy("fast"):
        g, inp_id = build_chain()
        for bs, key, reps in ((128, "block128", 40), (2048, "block2048", 20)):
            sess = StreamSession(g, block_size=bs)
            xb = np.zeros(bs, np.float32)
            sess.process({str(inp_id): xb})          # compile + warm
            t0 = time.perf_counter()
            for _ in range(reps):
                sess.process({str(inp_id): xb})
            wall = time.perf_counter() - t0
            res[key] = round(reps * bs / SR / wall, 2)
        sess = StreamSession(g)
        xp = np.zeros(375 * 128, np.float32)
        sess.process_many({str(inp_id): xp})         # compile + warm
        best = float("inf")
        for _ in range(N_TIMED):
            t0 = time.perf_counter()
            sess.process_many({str(inp_id): xp})
            best = min(best, time.perf_counter() - t0)
        res["pipelined_1s"] = round(1.0 / best, 1)
    return res


def _gbps(bytes_accessed, wall_s):
    """Achieved device-memory GB/s (None-safe)."""
    if bytes_accessed is None or not wall_s:
        return None
    return round(bytes_accessed / wall_s / 1e9, 1)


def _bytes_accessed(compiled):
    """XLA's modeled memory traffic for a compiled program: operand reads
    + output writes per fused op, from the compiler's own cost analysis.
    None when the backend doesn't expose it."""
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):          # older jax returned [dict]
            ca = ca[0] if ca else {}
        v = ca.get("bytes accessed")
        return float(v) if v is not None else None
    except Exception as e:
        print(f"bench: cost_analysis unavailable: {e!r}", file=sys.stderr)
        return None


def _time_chained_renders(g, ext_np, batch: int, n_chain: int):
    """(best wall seconds, XLA bytes-accessed) for n_chain renders of
    ``g`` over a [batch, T] input, under the fast policy; best of N_TIMED.

    Timing protocol: the renders chain through the carried state inside
    ONE jitted lax.scan (one XLA program, one dispatch), and each timed
    call ends in ``block_until_ready``."""
    import jax
    import jax.numpy as jnp
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.utils import precision

    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        state = jax.device_put(cg.broadcast_state(cg.init_state(), (batch,)))
        ext = jax.device_put(ext_np)
        vfn = jax.vmap(cg.fn, in_axes=(cg.state_axes(), 0, None),
                       out_axes=(cg.state_axes(), 0, 0))
        oid = cg.output_ids[0]

        @jax.jit
        def run(state, ext):
            def body(st, _):
                st, outs, _aux = vfn(st, ext, None)
                return st, jnp.sum(outs[oid])
            st, sums = jax.lax.scan(body, state, None, length=n_chain)
            return jnp.sum(sums)

        nbytes = _bytes_accessed(run.lower(state, ext).compile())
        jax.block_until_ready(run(state, ext))            # warm (cached)
        best = float("inf")
        for _ in range(N_TIMED):
            t0 = time.perf_counter()
            jax.block_until_ready(run(state, ext))
            best = min(best, time.perf_counter() - t0)
    return best, nbytes


def _batched_metric(jax, dst, precision, rng):
    from dsp_stuff_tpu.models import config5_feedback_16node
    S, Tb = 128, SR * 10
    g5, meta5 = config5_feedback_16node()
    xb = (rng.standard_normal((S, Tb)) * 0.2).astype(np.float32)
    best5, by = _time_chained_renders(g5, {str(meta5["input"]): xb},
                                      batch=S, n_chain=16)
    return (S * (Tb / SR) * 16) / best5, _gbps(by, best5)


def _config_metric(name: str, rng):
    """(fast-policy RTF, achieved GB/s) for one of the remaining BASELINE
    configs (mono, 10 s, chained N_CHAIN times like the headline)."""
    from dsp_stuff_tpu.models import PRESETS
    if name == "config4":
        g, meta = PRESETS[name](ir_seconds=0.5)
    else:
        g, meta = PRESETS[name]()
    T = SR * 10
    x = (rng.standard_normal((1, T)) * 0.25).astype(np.float32)
    best, by = _time_chained_renders(g, {str(meta["input"]): x}, batch=1,
                                     n_chain=N_CHAIN)
    return (T / SR) * N_CHAIN / best, _gbps(by, best)


def _config_batched_metric(name: str, rng, B: int):
    """Aggregate throughput for one BASELINE config at batch: B mono
    streams x 10 s, chained n_chain=16 (the same fetch-amortization
    protocol as the chain batch-512 section).  Returns (aggregate
    audio-seconds per wall-second, achieved GB/s)."""
    from dsp_stuff_tpu.models import PRESETS
    if name == "config4":
        g, meta = PRESETS[name](ir_seconds=0.5)
    else:
        g, meta = PRESETS[name]()
    T = SR * 10
    x = (rng.standard_normal((B, T)) * 0.2).astype(np.float32)
    best, by = _time_chained_renders(g, {str(meta["input"]): x}, batch=B,
                                     n_chain=16)
    return B * (T / SR) * 16 / best, _gbps(by, best)


def _max_throughput_metric(rng, batch=None):
    """Aggregate throughput at scale: the 10-node chain over 512 mono
    streams, 10 s each.  The number is aggregate audio-seconds per
    wall-second across all streams, and its ``pct_hbm_roofline_batch512``
    companion states how close the engine gets to merely streaming the
    I/O through device memory once."""
    B = batch or int(os.environ.get("DST_BENCH_MAXBATCH", "512"))
    g, inp_id = build_chain()
    T = SR * 10
    x = (rng.standard_normal((B, T)) * 0.25).astype(np.float32)
    best, by = _time_chained_renders(g, {str(inp_id): x}, batch=B,
                                     n_chain=16)
    return B * (T / SR) * 16 / best, _gbps(by, best)


def _fast_accuracy_metric(dst, precision, rng):
    """dBFS of the batched fast path vs the NumPy oracles, stream 0:

      chain_batch512 -- the 10-node chain, 512 streams x 2 s;
      config5        -- the 16-node feedback graph, 128 streams x 1 s;
      config2        -- reverb -> chorus -> gain, 128 streams x 1 s."""
    import oracle
    from dsp_stuff_tpu.models import config5_feedback_16node
    from oracle import rel_err_db as _dbfs
    from oracle.graph import evaluate
    out = {}

    g, inp_id = build_chain()
    T = SR * 2
    xb = (rng.standard_normal((512, 1, T)) * 0.25).astype(np.float32)
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        y, _, _ = cg.render(xb, batch_shape=(512,))
    out["chain_batch512"] = round(float(_dbfs(np.asarray(y)[0, 0],
                                        oracle.chain10(xb[0, 0]))), 1)

    g5, meta5 = config5_feedback_16node()
    T5 = SR * 1
    x5 = (rng.standard_normal((128, 1, T5)) * 0.2).astype(np.float32)
    with precision.policy("fast"):
        cg5 = dst.compile_graph(g5)
        y5, _, _ = cg5.render(x5, batch_shape=(128,))
    want = evaluate(g5, {int(meta5["input"]): x5[0, 0]}, T5)
    out["config5"] = round(float(_dbfs(np.asarray(y5)[0, 0],
                                       want[cg5.output_ids[0]])), 1)

    # config2 (reverb -> chorus -> gain): the chain segment's mtap
    # (modulated fractional-delay) stage
    from dsp_stuff_tpu.models import config2_delay_chorus
    g2, meta2 = config2_delay_chorus()
    T2 = SR * 1
    x2 = (rng.standard_normal((128, 1, T2)) * 0.2).astype(np.float32)
    with precision.policy("fast"):
        cg2 = dst.compile_graph(g2)
        y2, _, _ = cg2.render(x2, batch_shape=(128,))
    want2 = evaluate(g2, {int(meta2["input"]): x2[0, 0]}, T2)
    out["config2"] = round(float(_dbfs(np.asarray(y2)[0, 0],
                                       want2[cg2.output_ids[0]])), 1)
    return out


def _accuracy_metric(jax, dst, precision, g, inp_id, x):
    # accuracy vs oracle under the parity policy over ACC_SECONDS of audio
    # (10 s by default: long-form drift evidence; the per-sample NumPy
    # oracle dominates the cost)
    import oracle
    Ta = int(ACC_SECONDS * SR) // 128 * 128
    xa = x[0, :, :Ta]
    with precision.policy("parity"):
        cg2 = dst.compile_graph(g)
        outs, _, _ = cg2.render({str(inp_id): xa[0]})
        got = np.asarray(outs)[0]
    want = oracle.chain10(xa[0])
    err = np.max(np.abs(got.astype(np.float64) - want.astype(np.float64)))
    return 20.0 * np.log10(err) if err > 0 else float("-inf")


if __name__ == "__main__":
    main()
