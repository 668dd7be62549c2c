"""CLI entry point — the analog of the reference's app entry
(/root/reference/dsp-stuff/src/main.rs: clap parsing + tracing setup +
app launch; its only flag is --clean).  Headless equivalents:

    python -m dsp_stuff_tpu nodes                     # list node types
    python -m dsp_stuff_tpu render GRAPH.json \\
        [--in IN.wav ...] [--out OUT.wav] [--seconds S] \\
        [--policy fast|parity|exact]                  # offline render
    python -m dsp_stuff_tpu fit GRAPH.json --in dry.wav --target wet.wav
                                                      # gradient amp-matching
    python -m dsp_stuff_tpu inspect GRAPH.json        # topology summary
    python -m dsp_stuff_tpu debug GRAPH.json --seconds S
                                                      # per-node stats render

Env: DST_LOG=debug|info|... (the RUST_LOG analog, utils/obs.py).
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_nodes(args):
    from dsp_stuff_tpu.registry import REGISTRY, ParamSpec, SelectSpec
    for spec in sorted(REGISTRY, key=lambda s: s.cfg_name):
        params = []
        for p in spec.params:
            if isinstance(p, ParamSpec):
                mod = " (mod)" if p.as_input else ""
                params.append(f"{p.name}[{p.lo}..{p.hi}]{mod}")
            elif isinstance(p, SelectSpec):
                params.append(f"{p.name}{{{'|'.join(p.choices)}}}")
            else:
                params.append(p.name)
        io = f"{len(spec.inputs)}->{len(spec.outputs)}"
        print(f"{spec.cfg_name:<12} {io:<6} {spec.title:<18} "
              f"{', '.join(params)}")


def _cmd_render(args):
    from dsp_stuff_tpu.utils.precision import set_policy
    from dsp_stuff_tpu.runtime.session import render_file
    set_policy(args.policy)
    outs, aux = render_file(args.graph, in_wavs=args.inputs or None,
                            out_wav=args.out, seconds=args.seconds,
                            out_rate=args.out_rate, stereo_out=args.stereo,
                            resample_inputs=args.resample_inputs)
    print(f"rendered {outs.shape[0]} channel(s) x {outs.shape[-1]} samples"
          + (f" -> {args.out}" if args.out else ""))
    for key in aux:
        print(f"aux: {key}")


def _cmd_fit(args):
    import numpy as np
    from dsp_stuff_tpu.graph import load_graph, save_graph
    from dsp_stuff_tpu.compiler.compile import compile_graph
    from dsp_stuff_tpu.io import wav as wav_io
    from dsp_stuff_tpu.train.fit import fit, spectral_loss, mse_loss
    from dsp_stuff_tpu.utils.precision import set_policy

    set_policy("fast")
    g = load_graph(args.graph)
    cg = compile_graph(g)
    xin, rate = wav_io.read_wav(getattr(args, "in"))
    tgt, rate2 = wav_io.read_wav(args.target)
    if rate != 48_000 or rate2 != 48_000:
        raise SystemExit("fit: inputs must be 48 kHz")
    T = min(xin.shape[-1], tgt.shape[-1])
    T -= T % 1024
    if T == 0:
        raise SystemExit("fit: input/target must be at least 1024 samples")
    x = wav_io.to_mono(xin)[:T]
    t = wav_io.to_mono(tgt)[:T]
    if not cg.input_ids or not cg.output_ids:
        raise SystemExit("fit: graph needs an Input and an Output node")
    if len(cg.input_ids) > 1:
        raise SystemExit("fit: only single-Input graphs are supported "
                         f"(this graph has {len(cg.input_ids)} Input nodes)")
    ext = {str(cg.input_ids[0]): x[None]}
    target = t[None, None, :]
    dist = spectral_loss if args.loss == "spectral" else mse_loss
    params, losses = fit(cg, ext, target, steps=args.steps, distance=dist,
                         verbose=True)
    # fold fitted sliders back into the graph and save
    for nid_s, entry in params.items():
        for name, val in entry.items():
            g.nodes[int(nid_s)].params[name] = float(np.asarray(val))
    out = args.out or args.graph
    save_graph(g, out)
    print(f"fit: final loss {losses[-1]:.3e}; wrote {out}")


def _cmd_inspect(args):
    from dsp_stuff_tpu.graph import load_graph
    g = load_graph(args.graph)
    print(f"{len(g.nodes)} nodes, {len(g.links)} links")
    for nid in sorted(g.nodes):
        n = g.nodes[nid]
        print(f"  [{nid}] {n.cfg_name} "
              f"{ {k: v for k, v in n.params.items() if not isinstance(v, list)} }")
    for l in g.links:
        print(f"  {l.src}.{l.src_port} -> {l.dst}.{l.dst_port}")


def _cmd_debug(args):
    import numpy as np
    from dsp_stuff_tpu.graph import load_graph
    from dsp_stuff_tpu.utils.obs import debug_render
    g = load_graph(args.graph)
    T = int((args.seconds or 1.0) * 48_000)
    T += (-T) % 128
    outs, report = debug_render(g, T=T)
    print(f"{'node':>5} {'cfg':<12} {'port':<6} {'ms':>8} {'rms':>10} "
          f"{'max':>10} {'nan':>6} {'inf':>6}")
    for r in report:
        print(f"{r['node']:>5} {r['cfg']:<12} {r['port']:<6} "
              f"{r['ms']:>8.2f} {r['out_rms']:>10.4f} {r['out_max']:>10.4f} "
              f"{r['nan']:>6} {r['inf']:>6}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dsp_stuff_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("nodes", help="list registered node types")

    rp = sub.add_parser("render", help="offline render of a graph JSON")
    rp.add_argument("graph")
    rp.add_argument("--in", dest="inputs", action="append",
                    help="input WAV (one per Input node, ascending id)")
    rp.add_argument("--out", help="output WAV path")
    rp.add_argument("--seconds", type=float,
                    help="render length for generator graphs")
    rp.add_argument("--policy", default="fast",
                    choices=("fast", "parity", "exact"))
    rp.add_argument("--out-rate", type=int, default=None,
                    help="export sample rate (sinc-16 device-rate path)")
    rp.add_argument("--stereo", action="store_true",
                    help="duplicate a mono render to stereo on export")
    rp.add_argument("--resample-inputs", action="store_true",
                    help="accept non-48kHz input WAVs (sinc-16 ingest)")

    fp = sub.add_parser("fit", help="gradient-fit graph sliders to a target")
    fp.add_argument("graph")
    fp.add_argument("--in", required=True, help="input WAV (dry signal)")
    fp.add_argument("--target", required=True, help="target WAV to match")
    fp.add_argument("--steps", type=int, default=300)
    fp.add_argument("--loss", default="mse", choices=("mse", "spectral"))
    fp.add_argument("--out", help="output graph JSON (default: in place)")

    ip = sub.add_parser("inspect", help="print graph topology")
    ip.add_argument("graph")

    dp = sub.add_parser("debug", help="per-node stats render")
    dp.add_argument("graph")
    dp.add_argument("--seconds", type=float, default=1.0)

    args = ap.parse_args(argv)
    from dsp_stuff_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    {"nodes": _cmd_nodes, "render": _cmd_render, "fit": _cmd_fit,
     "inspect": _cmd_inspect, "debug": _cmd_debug}[args.cmd](args)


if __name__ == "__main__":
    main()
