"""Observability: logging, profiler traces, NaN hunting, per-node debugging.

The reference's stack (SURVEY.md section 5): tracing-subscriber fmt layer
with span-close durations, EnvFilter (default "dsp_stuff=info"),
tokio-console task profiler, and #[tracing::instrument] on every
process().  Analogs here:

* ``logger`` / env filter: std logging, level from $DST_LOG (RUST_LOG
  analog), default INFO;
* ``trace(dir)``: jax.profiler context — the XLA trace viewer replaces
  tokio-console (kernels instead of tasks);
* ``debug_render``: eager node-by-node evaluation that reports per-node
  output stats (max/rms/NaN count) and wall time — the analog of per-span
  durations, plus the NaN detection Rust's runtime never needed;
* ``nan_guard``: wraps a compiled fn and raises if outputs go non-finite;
* ``card_name_and_power_limit``: the GPUs' name and power limit, to write
  beside every measured number.
"""

from __future__ import annotations

import contextlib
import logging
import os
import subprocess
import time

import jax
import numpy as np

logger = logging.getLogger("dsp_stuff_tpu")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("DST_LOG", "INFO").upper())


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/dst_trace"):
    """jax.profiler trace around a block (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        logger.info("profiler trace written to %s", log_dir)


def debug_render(graph, inputs=None, T: int | None = None,
                 block_size: int = 128):
    """Eager per-node render with per-node stats; returns (outs, report).

    report: list of dicts {node, cfg, port, ms, out_rms, out_max, nan, inf}
    in execution order (the compiler's NODE_HOOK fires after every node;
    in feedback cycles it fires once per block, and the stats aggregate).
    ~Python-speed; for debugging, not production.
    """
    from dsp_stuff_tpu.compiler import compile as C

    report: list[dict] = []
    by_key: dict[tuple, dict] = {}
    last_t = [time.perf_counter()]

    def hook(nid, cfg_name, outs):
        now = time.perf_counter()
        dt_ms = (now - last_t[0]) * 1e3
        last_t[0] = now
        for port, val in outs.items():
            if isinstance(val, jax.core.Tracer):
                # inside a feedback SCC the hook fires during lax.scan
                # tracing; values aren't concrete there — record presence
                # only (stats stay zero)
                key = (nid, port)
                if key not in by_key:
                    rec = {"node": nid, "cfg": cfg_name, "port": port,
                           "ms": 0.0, "out_rms": 0.0, "out_max": 0.0,
                           "nan": 0, "inf": 0, "traced": True}
                    by_key[key] = rec
                    report.append(rec)
                continue
            arr = np.asarray(val)
            key = (nid, port)
            rec = by_key.get(key)
            if rec is None:
                rec = {"node": nid, "cfg": cfg_name, "port": port,
                       "ms": 0.0, "out_rms": 0.0, "out_max": 0.0,
                       "nan": 0, "inf": 0}
                by_key[key] = rec
                report.append(rec)
            rec["ms"] += dt_ms
            rec["out_rms"] = max(rec["out_rms"],
                                 float(np.sqrt(np.mean(arr ** 2)))
                                 if arr.size else 0.0)
            rec["out_max"] = max(rec["out_max"],
                                 float(np.abs(arr).max()) if arr.size else 0.0)
            rec["nan"] += int(np.isnan(arr).sum())
            rec["inf"] += int(np.isinf(arr).sum())
            if rec["nan"] or rec["inf"]:
                logger.warning("node %s (%s) emitted %d NaN / %d Inf",
                               nid, cfg_name, rec["nan"], rec["inf"])

    prev = C.NODE_HOOK
    C.NODE_HOOK = hook
    try:
        cg = C.compile_graph(graph, block_size)
        ext = cg._pack_inputs(inputs, T, ())
        T_ = next(iter(ext.values())).shape[-1] if ext else T
        last_t[0] = time.perf_counter()
        # run WITHOUT jit so the hook sees concrete (eager) arrays
        state, outs, aux = cg.fn(cg.init_state(), ext, None)
        out_arr = np.stack([np.asarray(outs[i]) for i in cg.output_ids]) \
            if cg.output_ids else np.zeros((0, T_), np.float32)
    finally:
        C.NODE_HOOK = prev
    return out_arr, report


def nan_guard(fn, name: str = "fn"):
    """Wrap fn; raise FloatingPointError if any output leaf is non-finite."""
    def inner(*args, **kwargs):
        out = fn(*args, **kwargs)
        for leaf in jax.tree.leaves(out):
            arr = np.asarray(leaf)
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                raise FloatingPointError(
                    f"{name}: non-finite output "
                    f"({int(np.isnan(arr).sum())} NaN, "
                    f"{int(np.isinf(arr).sum())} Inf)")
        return out
    return inner


def card_name_and_power_limit() -> str:
    """nvidia-smi's name and power limit for the cards, one per line."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip()
