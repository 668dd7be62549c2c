#!/usr/bin/env python3
"""Bring-up check of dsp_stuff_tpu on NVIDIA GPUs.

Drives the main path once through the entry points a user calls
(``compile_graph`` / ``render``, ``StreamSession``, ``make_train_step``)
at batch-render sizes, checks every result against the repo's NumPy
oracles (tests/oracle), then runs the GPU-only tests
(``pytest -m gpu tests/``) in this same process.  One line per phase:

    phase=<name> wall_s=<steady call> compile_s=<first call - steady> ...

then the card's name and power limit as nvidia-smi reports them, and as
the last line one JSON object naming the device.  Any failed phase ends
the run with a non-zero exit and no JSON line; so does a machine where
JAX finds no GPU.

    python chip_smoke.py           # one GPU, every phase
    python chip_smoke.py --four    # four GPUs: sharded render + sharded
                                   # fitting step vs one card, nothing else

All data is generated from fixed seeds; one process holds the card(s).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np

from oracle import rel_err_db as _db

SR = 48_000
FAST_DB = -80.0      # fast-policy bound vs the oracle
PARITY_DB = -90.0    # parity budget vs the oracle
LIVE_DB = -100.0     # live blocks vs one-shot render: f32 reassociation


class PhaseFailed(AssertionError):
    pass


def _samples(seconds: float) -> int:
    return max(1, round(seconds * SR / 128)) * 128


def _report(name: str, **fields) -> dict:
    print(f"phase={name} " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in fields.items()), flush=True)
    return fields


def _check(name: str, what: str, value: float, bound: float) -> None:
    if not value <= bound:
        raise PhaseFailed(f"{name}: {what} {value:.2f} above bound {bound}")


def _timed_twice(fn):
    """(result, steady wall seconds, compile seconds): the first call
    compiles, the second is timed alone; both end in block_until_ready."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    steady = time.perf_counter() - t0
    return out, steady, max(first - steady, 0.0)


def _signal(B: int, T: int, seed: int, scale: float):
    """[B, 1, T] f32 noise made on the device."""
    import jax
    import jax.numpy as jnp
    return jax.random.normal(jax.random.key(seed), (B, 1, T),
                             jnp.float32) * scale


def _fanin(v):
    """The single-pipe fan-in scale every hop applies (node.rs:173-192)."""
    f32 = np.float32
    return (np.asarray(v, f32) / f32(f32(1.0) + f32(0.0001))).astype(f32)


# -- phases ------------------------------------------------------------------

def phase_device() -> dict:
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise PhaseFailed(f"device: JAX found {dev.platform}, not a GPU")
    from dsp_stuff_tpu.utils.compile_cache import enable_compile_cache
    from dsp_stuff_tpu.utils.obs import card_name_and_power_limit
    return _report("device", platform=dev.platform,
                   kind=repr(dev.device_kind), count=len(jax.devices()),
                   card=repr(card_name_and_power_limit().replace("\n", "; ")),
                   jax=jax.__version__,
                   xla_flags=repr(os.environ.get("XLA_FLAGS", "")),
                   compile_cache=enable_compile_cache())


def phase_chain(B=512, seconds=10.0, check_seconds=2.0) -> dict:
    """10-node chain, fast policy, batched render."""
    import jax
    import dsp_stuff_tpu as dst
    import oracle
    from dsp_stuff_tpu.models import chain10
    from dsp_stuff_tpu.utils import precision
    T, n = _samples(seconds), _samples(check_seconds)
    g, meta = chain10()
    x = _signal(B, T, 0, 0.25)
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        y, wall, comp = _timed_twice(
            lambda: cg.render(x, batch_shape=(B,))[0])
        ext = {str(meta["input"]): x[:, 0]}
        compiled = jax.jit(jax.vmap(
            cg.fn, in_axes=(None, 0, None),
            out_axes=(cg.state_axes(), 0, 0))).lower(
                cg.init_state(), ext, None).compile()
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    db = _db(np.asarray(y[0, 0, :n]),
             oracle.chain10(np.asarray(x[0, 0, :n])))
    r = _report("chain", streams=B, seconds=T / SR, wall_s=wall,
                compile_s=comp, audio_s_per_s=B * T / SR / wall,
                dbfs_vs_oracle=db, bound=FAST_DB,
                temp_bytes=getattr(mem, "temp_size_in_bytes", None),
                argument_bytes=getattr(mem, "argument_size_in_bytes", None),
                output_bytes=getattr(mem, "output_size_in_bytes", None),
                peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    _check("chain", "dBFS", db, FAST_DB)
    return r


def phase_parity(seconds=10.0) -> dict:
    """The chain under the parity policy (f64 internals), one stream."""
    import dsp_stuff_tpu as dst
    import oracle
    from dsp_stuff_tpu.models import chain10
    from dsp_stuff_tpu.utils import precision
    T = _samples(seconds)
    g, meta = chain10()
    x = _signal(1, T, 1, 0.25)[0]
    with precision.policy("parity"):
        cg = dst.compile_graph(g)
        y, wall, comp = _timed_twice(lambda: cg.render(x)[0])
    db = _db(np.asarray(y[0]), oracle.chain10(np.asarray(x[0])))
    r = _report("parity", streams=1, seconds=T / SR, wall_s=wall,
                compile_s=comp, dbfs_vs_oracle=db, bound=PARITY_DB)
    _check("parity", "dBFS", db, PARITY_DB)
    return r


def _config_oracle(name, g, meta, x0):
    """Reference output of stream 0 for a preset: the block-wise graph
    oracle, or for the oversampled config3 (which that oracle does not
    cover) the composed per-node oracle of tests/test_presets.py."""
    import oracle
    if name == "config3":
        v = oracle.oversampled(
            lambda u: oracle.overdrive(u, 8.0, 0.8, 0.9), _fanin(x0), 4)
        v = oracle.oversampled(
            lambda u: oracle.tanh_clip(u, 6.0), _fanin(v), 4)
        return _fanin(v)
    from oracle.graph import evaluate
    return evaluate(g, {int(meta["input"]): x0}, len(x0))[meta["output"]]


def phase_config(name, B=512, seconds=10.0, check_seconds=1.0) -> dict:
    """A feedback/echo/oversampling preset (config5, config2, config3),
    fast policy, batched render."""
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.models import PRESETS
    from dsp_stuff_tpu.utils import precision
    T, n = _samples(seconds), _samples(check_seconds)
    g, meta = PRESETS[name]()
    x = _signal(B, T, 2, 0.2)
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        y, wall, comp = _timed_twice(
            lambda: cg.render(x, batch_shape=(B,))[0])
    out = cg.output_ids.index(meta["output"])
    # the oracle sees one block past the window: config3's oversampling
    # FIRs are zero-phase and look 8 samples ahead
    ahead = np.asarray(x[0, 0, :n + 128])
    db = _db(np.asarray(y[0, out, :n]),
             _config_oracle(name, g, meta, ahead)[:n])
    r = _report(name, streams=B, seconds=T / SR, wall_s=wall,
                compile_s=comp, audio_s_per_s=B * T / SR / wall,
                dbfs_vs_oracle=db, bound=FAST_DB)
    _check(name, "dBFS", db, FAST_DB)
    return r


def phase_config4(B=64, seconds=10.0, check_seconds=2.0,
                  ir_seconds=1.0) -> dict:
    """Stereo convolution reverb at the preset's own IR length: fast at
    batch, then one stream under parity (f64 FFTs)."""
    import dsp_stuff_tpu as dst
    import oracle
    from dsp_stuff_tpu.models import PRESETS
    from dsp_stuff_tpu.utils import precision
    T, n = _samples(seconds), _samples(check_seconds)
    g, meta = PRESETS["config4"](ir_seconds=ir_seconds)
    x = _signal(B, T, 3, 0.25)

    def reference(x0):
        x0 = _fanin(x0)
        return [_fanin(oracle.fir_vectorized(
                    x0, np.asarray(g.nodes[f].params["taps"], np.float64)))
                for f in meta["firs"]]

    def worst(y, x0):
        return max(_db(np.asarray(y[cg.output_ids.index(o)]), want)
                   for o, want in zip(meta["outputs"], reference(x0)))

    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        y, wall, comp = _timed_twice(
            lambda: cg.render(x, batch_shape=(B,))[0])
    db_fast = worst(np.asarray(y[0, :, :n]), np.asarray(x[0, 0, :n]))
    with precision.policy("parity"):
        cgp = dst.compile_graph(g)
        yp, wall_p, comp_p = _timed_twice(lambda: cgp.render(x[0])[0])
    db_par = worst(np.asarray(yp[:, :n]), np.asarray(x[0, 0, :n]))
    r = _report("config4", streams=B, seconds=T / SR,
                ir_seconds=ir_seconds, wall_s=wall, compile_s=comp,
                audio_s_per_s=B * T / SR / wall, dbfs_vs_oracle=db_fast,
                bound=FAST_DB, parity_wall_s=wall_p,
                parity_compile_s=comp_p, parity_dbfs_vs_oracle=db_par,
                parity_bound=PARITY_DB)
    _check("config4", "fast dBFS", db_fast, FAST_DB)
    _check("config4", "parity dBFS", db_par, PARITY_DB)
    return r


def phase_live(seconds=1.0) -> dict:
    """StreamSession: single 128-sample blocks, then process_many over
    the same audio, both against the one-shot render."""
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.models import chain10
    from dsp_stuff_tpu.runtime.stream import StreamSession
    from dsp_stuff_tpu.utils import precision
    T = _samples(seconds)
    g, meta = chain10()
    x = np.asarray(_signal(1, T, 4, 0.25)[0, 0])
    key = str(meta["input"])
    with precision.policy("fast"):
        sess = StreamSession(g)
        t0 = time.perf_counter()
        first = sess.process({key: x[:128]})
        comp = time.perf_counter() - t0
        blocks, lat = [first], []
        for b in range(128, T, 128):
            t0 = time.perf_counter()
            blocks.append(sess.process({key: x[b:b + 128]}))
            lat.append(time.perf_counter() - t0)
        streamed = np.concatenate(blocks, axis=-1)
        many = StreamSession(g)
        t0 = time.perf_counter()
        piped = many.process_many({key: x})
        many_first = time.perf_counter() - t0
        ref = np.asarray(dst.compile_graph(g).render({key: x})[0])
    lat_ms = np.asarray(lat) * 1e3
    db_blocks = _db(streamed, ref)
    db_many = _db(piped, streamed)
    r = _report("live", blocks=T // 128, block_compile_s=comp,
                p50_block_ms=float(np.percentile(lat_ms, 50)),
                p99_block_ms=float(np.percentile(lat_ms, 99)),
                process_many_first_call_s=many_first,
                db_blocks_vs_render=db_blocks,
                db_many_vs_blocks=db_many, bound=LIVE_DB)
    _check("live", "blocks vs render dB", db_blocks, LIVE_DB)
    _check("live", "process_many vs blocks dB", db_many, LIVE_DB)
    return r


def phase_fit(B=64, seconds=1.0, steps=5) -> dict:
    """make_train_step on the chain: the loss falls from a perturbed
    start towards a target rendered at the preset's own sliders."""
    import jax
    import jax.numpy as jnp
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.models import chain10
    from dsp_stuff_tpu.train.fit import make_train_step
    from dsp_stuff_tpu.utils import precision
    T = _samples(seconds)
    g, meta = chain10()
    x = _signal(B, T, 5, 0.25)
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        target = cg.render(x, batch_shape=(B,))[0]
        step, opt_init = make_train_step(cg)
        step = jax.jit(step)
        params = jax.tree.map(lambda v: jnp.asarray(v) * 0.8,
                              cg.init_params())
        opt = opt_init(params)
        state = cg.init_state()
        ext = {str(meta["input"]): x[:, 0]}
        losses, times = [], []
        p = params
        for _ in range(steps):
            t0 = time.perf_counter()
            p, opt, loss = jax.block_until_ready(
                step(p, opt, state, ext, target))
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    moved = any(float(jnp.max(jnp.abs(a - b))) > 0 for a, b in
                zip(jax.tree.leaves(p), jax.tree.leaves(params)))
    steady = float(np.median(times[1:])) if steps > 1 else times[0]
    r = _report("fit", streams=B, seconds=T / SR, steps=steps,
                wall_s=steady, compile_s=max(times[0] - steady, 0.0),
                loss_first=losses[0], loss_last=losses[-1],
                params_moved=moved)
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]
            and moved):
        raise PhaseFailed(f"fit: losses {losses}, params moved {moved}")
    return r


def phase_exact(seconds=1.0) -> dict:
    """exact policy on a transcendental-free chain, bitwise vs the
    per-node oracles."""
    import dsp_stuff_tpu as dst
    import oracle
    from dsp_stuff_tpu.ids import IdSpace
    from dsp_stuff_tpu.utils import precision
    T = _samples(seconds)
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.3)
    bq = g.add("biquad", a0=1.0, a1=-0.5, a2=0.2, b0=0.6, b1=0.2, b2=0.1)
    lp = g.add("low_pass", ratio=0.6)
    hp = g.add("high_pass", ratio=0.2)
    out = g.add("output")
    g.chain(inp, gn, bq, lp, hp, out)
    x = np.asarray(_signal(1, T, 6, 0.25)[0, 0])
    with precision.policy("exact"):
        cg = dst.compile_graph(g)
        y, wall, comp = _timed_twice(
            lambda: cg.render({str(inp.id): x})[0])
    v = (_fanin(x) * np.float32(1.3)).astype(np.float32)
    v, _ = oracle.biquad_df1(_fanin(v), 1.0, -0.5, 0.2, 0.6, 0.2, 0.1)
    v, _ = oracle.low_pass(_fanin(v), 0.6)
    v, _ = oracle.high_pass(_fanin(v), 0.2)
    want = _fanin(v)
    got = np.asarray(y[0])
    diff = float(np.abs(got.astype(np.float64) - want).max())
    n_diff = int(np.count_nonzero(got != want))
    r = _report("exact", seconds=T / SR, wall_s=wall, compile_s=comp,
                max_abs_diff=diff, samples_differing=n_diff,
                bitwise=n_diff == 0)
    if n_diff:
        raise PhaseFailed(f"exact: {n_diff} samples differ from the "
                          f"oracle (max {diff:.3g})")
    return r


def phase_gpu_tests() -> dict:
    """The GPU-only tests, in this process (one process holds the card)."""
    import pytest
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    r = _report("gpu_tests", wall_s=time.perf_counter() - t0, rc=int(rc))
    if rc != 0:
        raise PhaseFailed(f"gpu_tests: pytest exit code {int(rc)}")
    return r


def phase_render_sharded(n_dev=4, B=2048, seconds=10.0) -> dict:
    """render_sharded over an n-card ("streams",) mesh vs single-card
    renders of the same stream slices."""
    import jax
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.models import chain10
    from dsp_stuff_tpu.parallel.mesh import make_mesh, render_sharded
    from dsp_stuff_tpu.utils import precision
    T = _samples(seconds)
    g, meta = chain10()
    mesh = make_mesh(n_dev)
    x = _signal(B, T, 7, 0.25)
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        y, wall, comp = _timed_twice(
            lambda: render_sharded(cg, x, mesh)[0])
        S = B // n_dev
        dev0 = jax.devices()[0]
        err = 0.0
        for k in range(n_dev):
            xs = jax.device_put(x[k * S:(k + 1) * S], dev0)
            ys = cg.render(xs, batch_shape=(S,))[0]
            err = max(err, float(np.abs(np.asarray(ys, np.float64)
                                        - np.asarray(y[k * S:(k + 1) * S],
                                                     np.float64)).max()))
    r = _report("render_sharded", devices=n_dev, streams=B, seconds=T / SR,
                wall_s=wall, compile_s=comp,
                audio_s_per_s=B * T / SR / wall, max_abs_diff=err)
    if err != 0.0:
        raise PhaseFailed(f"render_sharded: sharded != single-card ({err})")
    return r


def phase_fit_sharded(n_dev=4, B=64, seconds=1.0) -> dict:
    """make_sharded_train_step over n cards vs make_train_step on one
    card with the same batch: same loss and updated sliders up to the
    order of the gradient reduction."""
    import jax
    import jax.numpy as jnp
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.models import chain10
    from dsp_stuff_tpu.parallel.mesh import make_mesh
    from dsp_stuff_tpu.train.fit import (make_sharded_train_step,
                                         make_train_step)
    from dsp_stuff_tpu.utils import precision
    T = _samples(seconds)
    g, meta = chain10()
    mesh = make_mesh(n_dev)
    x = _signal(B, T, 8, 0.25)
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        target = cg.render(x, batch_shape=(B,))[0]
        params = jax.tree.map(lambda v: jnp.asarray(v) * 0.8,
                              cg.init_params())
        state = cg.init_state()
        ext = {str(meta["input"]): x[:, 0]}
        sh_step, sh_init = make_sharded_train_step(cg, mesh)
        (p_sh, _, loss_sh), wall, comp = _timed_twice(
            lambda: sh_step(params, sh_init(params), state, ext, target))
        one_step, one_init = make_train_step(cg)
        p_one, _, loss_one = jax.block_until_ready(jax.jit(one_step)(
            params, one_init(params), state, ext, target))
    dp = max(float(jnp.max(jnp.abs(a - b))) for a, b in
             zip(jax.tree.leaves(p_sh), jax.tree.leaves(p_one)))
    dl = abs(float(loss_sh) - float(loss_one)) / max(abs(float(loss_one)),
                                                     1e-30)
    r = _report("fit_sharded", devices=n_dev, streams=B, seconds=T / SR,
                wall_s=wall, compile_s=comp, loss=float(loss_sh),
                loss_rel_diff=dl, max_param_diff=dp)
    if not (dl <= 1e-5 and dp <= 1e-5):
        raise PhaseFailed(f"fit_sharded: loss rel diff {dl}, "
                          f"param diff {dp}")
    return r


# -- main --------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded render and sharded fitting "
                         "step over four GPUs")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devs[0].platform}); nothing was run", file=sys.stderr)
        return 1
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX found {len(devs)}",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    phase_device()
    if args.four:
        phase_render_sharded(n_dev=4)
        phase_fit_sharded(n_dev=4)
    else:
        phase_chain()
        phase_parity()
        for name in ("config5", "config2", "config3"):
            phase_config(name)
        phase_config4()
        phase_live()
        phase_fit()
        phase_exact()
        phase_gpu_tests()
    print(f"total_s={time.perf_counter() - t_start:.1f}")
    from dsp_stuff_tpu.utils.obs import card_name_and_power_limit
    print(card_name_and_power_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
