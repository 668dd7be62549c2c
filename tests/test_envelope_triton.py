"""The chunk-parallel envelope kernel (ops/envelope_triton.py) in the
Pallas interpreter, against the sequential scan and XLA's two-scan
evaluation, plus its dispatch gate and its gradient.  The compiled
kernel is pinned on the card by tests/test_gpu.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsp_stuff_tpu.ops import envelope as env_ops
from dsp_stuff_tpu.ops import envelope_triton
from dsp_stuff_tpu.utils import precision


def _case(B, T, atk_frames, rel_frames, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T)) * 0.6).astype(np.float32)
    e0 = np.abs(rng.standard_normal(B)).astype(np.float32)
    return (jnp.asarray(x), env_ops.gain_from_frames(atk_frames),
            env_ops.gain_from_frames(rel_frames), jnp.asarray(e0))


@pytest.mark.parametrize("B,T,chunk,atk,rel", [
    (3, 512 * 5 + 77, 256, 4.0, 12.0),   # ragged T, 11 chunks, 33 lanes
    (32, 1024, 256, 2.0, 8.0),           # lanes exactly one program
    (1, 700, 128, 0.0, 10.0),            # 0-frame attack: gain 0
    (5, 2048, 512, 6.0, 0.0),            # 0-frame release
    (7, 333, 64, 3.0, 5.0),              # T < 2 chunks... and odd B
    (2, 4096, 1024, 20.0, 40.0),         # long chunk, slow gains
])
def test_kernel_interpret_matches_scans(B, T, chunk, atk, rel):
    x, a, r, e0 = _case(B, T, atk, rel, seed=B + T)
    got, fin = envelope_triton.peak_envelope_chunked(
        x, a, r, e0, chunk=chunk, interpret=True)
    ref, rfin = env_ops._chunked_batched(x, a, r, e0, chunk)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(fin), np.asarray(rfin))
    seq, sfin = env_ops._seq_scan(x, a, r, e0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(seq),
                               rtol=0, atol=2e-7)
    np.testing.assert_allclose(np.asarray(fin), np.asarray(sfin),
                               rtol=0, atol=2e-7)


def test_kernel_rejects_chunk_off_unroll():
    x, a, r, e0 = _case(2, 256, 4.0, 8.0, seed=0)
    with pytest.raises(ValueError):
        envelope_triton.peak_envelope_chunked(
            x, a, r, e0, chunk=envelope_triton.UNROLL + 1, interpret=True)


def _uses_pallas(fn, *args) -> bool:
    return "pallas_call" in str(jax.make_jaxpr(fn)(*args))


def _interpret_kernel(monkeypatch, chunk):
    """Route the envelope's fast path through the interpreted kernel
    (traces of the custom rules are cached, so drop them)."""
    jax.clear_caches()
    monkeypatch.setattr(env_ops, "_CHUNK", chunk)
    monkeypatch.setattr(env_ops, "_use_triton", lambda B, T: True)
    monkeypatch.setattr(
        envelope_triton, "peak_envelope_chunked",
        functools.partial(envelope_triton.peak_envelope_chunked,
                          interpret=True))


def test_gate_picks_xla_on_cpu(monkeypatch):
    """Off a GPU the chunked path is XLA's two scans, never the kernel
    (on a GPU it is the kernel); with the gate forced the same call
    traces a pallas_call."""
    on_gpu = jax.default_backend() == "gpu"
    assert env_ops._use_triton(512, 480_000) == on_gpu
    assert not env_ops._use_triton(512, 2 * env_ops._CHUNK)
    x = jnp.zeros((4, 3 * env_ops._CHUNK), jnp.float32)
    f = functools.partial(env_ops.peak_envelope, attack_frames=50.0,
                          release_frames=400.0)
    with precision.policy("fast"):
        assert _uses_pallas(f, x) == on_gpu
        _interpret_kernel(monkeypatch, 256)
        assert _uses_pallas(f, x)


def test_grad_through_custom_vjp_with_kernel_forward(monkeypatch):
    """The custom_vjp backward is shared: gradients with the interpreted
    kernel as forward equal those with XLA's chunked scans."""
    B, T = 3, 1536
    x, _, _, _ = _case(B, T, 5.0, 20.0, seed=11)

    def loss(x, atk, rel):
        env, fin = env_ops.peak_envelope(x, atk, rel)
        return jnp.sum(env ** 2) + jnp.sum(fin)

    grad = jax.grad(loss, argnums=(0, 1, 2))
    args = (x, jnp.float32(5.0), jnp.float32(20.0))
    with precision.policy("fast"):
        jax.clear_caches()
        monkeypatch.setattr(env_ops, "_CHUNK", 256)
        monkeypatch.setattr(env_ops, "_use_triton", lambda B, T: False)
        assert not _uses_pallas(grad, *args)
        want = grad(*args)
        _interpret_kernel(monkeypatch, 256)
        assert _uses_pallas(grad, *args)
        got = grad(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-6, atol=1e-7)
