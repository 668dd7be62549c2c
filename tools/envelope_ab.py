#!/usr/bin/env python3
"""A/B of the envelope's Triton kernel against XLA's plain evaluation.

Times, on one GPU, alternating runs (xla, triton, triton, xla, ...):

* config5 (models/presets.py) end to end, batched, fast policy, with the
  envelope on the Triton kernel and on ``_chunked_batched`` (two
  ``lax.scan`` passes), and the largest difference between the outputs;
* the envelope op alone at the same [streams, samples] shape;

then, with ``--trace-dir``, takes one profiler trace of the config5
render on the kernel path and reduces it: the device window, busy time,
idle share, kernel count, kernels and busy time per 128-sample block
step, and the kernels that take the most time.

    python tools/envelope_ab.py                      # 512 streams x 10 s
    python tools/envelope_ab.py --trace-dir DIR      # plus the trace
    python tools/envelope_ab.py --tiny               # CPU rehearsal

``--tiny`` runs 4 streams x 3 s with the op-alone kernel in the Pallas
interpreter, so the script can be checked without a GPU (there config5
takes XLA's path on both sides).  Each time is a median with its
quartiles and extremes; on a GPU the card's name and power limit come
first.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SR = 48_000
BLOCK = 128


@contextlib.contextmanager
def _envelope_path(name: str):
    """Route the batched envelope to XLA's scans ("xla") or leave the
    platform gate as it is ("triton")."""
    from dsp_stuff_tpu.ops import envelope as env_ops
    gate = env_ops._use_triton
    if name == "xla":
        env_ops._use_triton = lambda B, T: False
    try:
        yield
    finally:
        env_ops._use_triton = gate


def _quartiles(ms) -> str:
    ms = np.asarray(ms)
    return (f"median_ms={np.median(ms):.4f} q1={np.percentile(ms, 25):.4f} "
            f"q3={np.percentile(ms, 75):.4f} min={ms.min():.4f} "
            f"max={ms.max():.4f} n={len(ms)}")


def _alternate(fns: dict, reps: int) -> dict:
    """Wall ms of each fn over ``reps`` rounds of xla, triton, triton,
    xla; every call ends in block_until_ready."""
    import jax
    times = collections.defaultdict(list)
    for name in ["xla", "triton", "triton", "xla"] * reps:
        t0 = time.perf_counter()
        jax.block_until_ready(fns[name]())
        times[name].append((time.perf_counter() - t0) * 1e3)
    return times


def config5_ab(B: int, T: int, reps: int):
    """config5 renders on both envelope paths, timed and compared;
    returns the kernel path's compiled graph and the input."""
    import jax
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.models import PRESETS
    from dsp_stuff_tpu.utils import precision
    g, _ = PRESETS["config5"]()
    x = jax.random.normal(jax.random.key(2), (B, 1, T), np.float32) * 0.2
    cgs, outs = {}, {}
    with precision.policy("fast"):
        for name in ("xla", "triton"):
            with _envelope_path(name):
                cgs[name] = dst.compile_graph(g)
                t0 = time.perf_counter()
                outs[name] = np.asarray(
                    cgs[name].render(x, batch_shape=(B,))[0])
            print(f"config5 {name}: first call "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
        times = _alternate({k: (lambda k=k: cgs[k].render(
            x, batch_shape=(B,))[0]) for k in cgs}, reps)
    for k, v in times.items():
        print(f"config5 B={B} T={T} {k}: {_quartiles(v)}", flush=True)
    diff = np.abs(outs["xla"].astype(np.float64) - outs["triton"]).max()
    print(f"config5 triton vs xla max_abs_diff={diff:.3g}", flush=True)
    return cgs["triton"], x


def envelope_ab(B: int, T: int, reps: int, interpret: bool) -> None:
    import jax
    import jax.numpy as jnp
    from dsp_stuff_tpu.ops import envelope as env_ops
    from dsp_stuff_tpu.ops.envelope_triton import peak_envelope_chunked
    x = jax.random.normal(jax.random.key(0), (B, T), jnp.float32) * 0.5
    atk = env_ops.gain_from_frames(50.0)
    rel = env_ops.gain_from_frames(400.0)
    e0 = jnp.zeros((B,), jnp.float32)
    chunk = 256 if interpret else env_ops._CHUNK
    fx = jax.jit(env_ops._chunked_batched, static_argnums=4)
    ft = jax.jit(lambda *a: peak_envelope_chunked(*a, chunk=chunk,
                                                  interpret=interpret))
    fns = {"xla": lambda: fx(x, atk, rel, e0, chunk),
           "triton": lambda: ft(x, atk, rel, e0)}
    for f in fns.values():
        jax.block_until_ready(f())
    for k, v in _alternate(fns, reps).items():
        print(f"envelope op B={B} T={T} {k}: {_quartiles(v)}", flush=True)


def trace_reduce(cg, x, B: int, T: int, trace_dir: str) -> None:
    """One traced config5 render, reduced over the GPU's stream lines."""
    import jax
    from jax.profiler import ProfileData
    from dsp_stuff_tpu.utils import precision
    with precision.policy("fast"):
        jax.block_until_ready(cg.render(x, batch_shape=(B,))[0])
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(cg.render(x, batch_shape=(B,))[0])
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    ivs, by = [], collections.defaultdict(lambda: [0, 0])
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                ivs.append((e.start_ns, e.end_ns))
                by[e.name][0] += 1
                by[e.name][1] += e.duration_ns
    if not ivs:
        print("trace: no GPU kernel events", flush=True)
        return
    ivs.sort()
    busy, (cs, ce) = 0, ivs[0]
    for s, e in ivs[1:]:
        if s > ce:
            busy += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    busy += ce - cs
    window = max(e for _, e in ivs) - ivs[0][0]
    steps = T // BLOCK
    print(f"trace window_ms={window / 1e6:.4f} busy_ms={busy / 1e6:.4f} "
          f"idle_share={1 - busy / window:.4f} kernels={len(ivs)} "
          f"block_steps={steps} kernels_per_step={len(ivs) / steps:.3f} "
          f"busy_us_per_step={busy / 1e3 / steps:.3f}", flush=True)
    for name, (n, d) in sorted(by.items(), key=lambda kv: -kv[1][1])[:25]:
        print(f"  {d / 1e6:10.4f} ms  n={n:6d}  {name[:110]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="4 streams x 3 s, kernel in the Pallas interpreter")
    ap.add_argument("--reps", type=int, default=None,
                    help="rounds of xla, triton, triton, xla (default 7)")
    ap.add_argument("--trace-dir", default=None,
                    help="take and reduce one config5 trace here")
    args = ap.parse_args(argv)

    import jax
    from dsp_stuff_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if jax.devices()[0].platform != "gpu" and not args.tiny:
        print("envelope_ab: needs an NVIDIA GPU (or --tiny)", file=sys.stderr)
        return 1
    if jax.devices()[0].platform == "gpu":
        from dsp_stuff_tpu.utils.obs import card_name_and_power_limit
        print(f"card: {card_name_and_power_limit()}", flush=True)
    B, seconds = (4, 3.0) if args.tiny else (512, 10.0)
    reps = args.reps or (2 if args.tiny else 7)
    T = round(seconds * SR / BLOCK) * BLOCK
    cg, x = config5_ab(B, T, reps)
    envelope_ab(B, T, reps, interpret=args.tiny)
    if args.trace_dir:
        trace_reduce(cg, x, B, T, args.trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
