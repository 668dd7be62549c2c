"""Tests that need an NVIDIA GPU (skipped elsewhere by the conftest
fixture).  Run them with ``python -m pytest -m gpu tests/``;
``chip_smoke.py`` runs them as its last phase.

They pin what the CPU suite cannot reach: the Triton envelope kernel as
compiled for the card (the CPU tests run it in the Pallas interpreter),
and the batched fast path against the NumPy oracles of the reference
semantics on the GPU's own arithmetic.
"""

import numpy as np
import pytest

import dsp_stuff_tpu as dst
from dsp_stuff_tpu.utils import precision
from oracle import rel_err_db as _db

SR = 48_000
FAST_DB = -80.0

pytestmark = pytest.mark.gpu


def test_triton_envelope_matches_xla_chunked():
    """The compiled kernel vs XLA's two-scan evaluation at config5's
    batch width (512 streams x 10 s), same chunk: the same per-sample
    ops, so only FMA contraction of env' = d + g (env - d) may differ."""
    import jax
    import jax.numpy as jnp
    from dsp_stuff_tpu.ops import envelope as env_ops
    from dsp_stuff_tpu.ops.envelope_triton import peak_envelope_chunked
    B, T = 512, 10 * SR
    assert env_ops._use_triton(B, T)
    x = jax.random.normal(jax.random.key(0), (B, T), jnp.float32) * 0.5
    atk = env_ops.gain_from_frames(50.0)
    rel = env_ops.gain_from_frames(400.0)
    e0 = jnp.zeros((B,), jnp.float32)
    got, fin = peak_envelope_chunked(x, atk, rel, e0, chunk=env_ops._CHUNK)
    want, wfin = jax.jit(env_ops._chunked_batched, static_argnums=4)(
        x, atk, rel, e0, env_ops._CHUNK)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=2e-7)
    np.testing.assert_allclose(np.asarray(fin), np.asarray(wfin),
                               rtol=0, atol=2e-7)


def test_fast_batched_chain_vs_oracle():
    """The 10-node chain at batch, fast policy, stream 0 vs the
    sequential oracle."""
    import oracle
    from dsp_stuff_tpu.models import chain10
    g, meta = chain10()
    B, T = 64, 2 * SR
    x = (np.random.default_rng(13).standard_normal((B, 1, T)) * 0.25
         ).astype(np.float32)
    with precision.policy("fast"):
        y, _, _ = dst.compile_graph(g).render(x, batch_shape=(B,))
    assert _db(np.asarray(y)[0, 0], oracle.chain10(x[0, 0])) <= FAST_DB


@pytest.mark.parametrize("traced", [False, True])
def test_fast_batched_resonant_biquad_vs_oracle(traced):
    """A resonant biquad (double pole at 0.9) at batch, fast policy:
    rendered from a graph (trace-time coefficients) and with traced
    coefficients (the fitting path), stream 0 vs the sequential oracle
    at the CPU suite's bound (tests/test_nodes_oracle.py)."""
    import jax
    import jax.numpy as jnp
    import oracle
    from dsp_stuff_tpu.ops import scan
    co = (1.0, -1.8, 0.81, 0.1, 0.2, 0.1)
    B, T = 64, SR
    x = (np.random.default_rng(15).standard_normal((B, T)) * 0.25
         ).astype(np.float32)
    f32 = np.float32
    if traced:
        c = [jnp.float32(f32(v) / f32(co[0])) for v in co[1:]]
        with precision.policy("fast"):
            y = jax.jit(lambda v, *cc: scan.biquad_df1(v, *cc)[0])(x, *c)
        got, want = np.asarray(y)[0], oracle.biquad_df1(x[0], *co)[0]
    else:
        g = dst.Graph()
        inp = g.add("input")
        bq = g.add("biquad", **dict(zip(("a0", "a1", "a2", "b0", "b1", "b2"),
                                        co)))
        out = g.add("output")
        g.chain(inp, bq, out)
        with precision.policy("fast"):
            y, _, _ = dst.compile_graph(g).render(x[:, None],
                                                  batch_shape=(B,))

        def fanin(v):
            return (v / f32(f32(1.0) + f32(0.0001))).astype(f32)
        got = np.asarray(y)[0, 0]
        want = fanin(oracle.biquad_df1(fanin(x[0]), *co)[0])
    assert oracle.max_err_dbfs(got, want) <= -84.0


def test_fast_batched_config5_vs_graph_oracle():
    """config5 at batch over 3 s, long enough (T > 2 x 32768) for the
    envelope's chunked Triton path, stream 0 vs the graph oracle."""
    from oracle.graph import evaluate
    from dsp_stuff_tpu.models import config5_feedback_16node
    g, meta = config5_feedback_16node()
    B, T = 64, 3 * SR
    x = (np.random.default_rng(14).standard_normal((B, 1, T)) * 0.2
         ).astype(np.float32)
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        y, _, _ = cg.render(x, batch_shape=(B,))
    want = evaluate(g, {int(meta["input"]): x[0, 0]}, T)[meta["output"]]
    out = cg.output_ids.index(meta["output"])
    assert _db(np.asarray(y)[0, out], want) <= FAST_DB
