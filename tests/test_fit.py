"""Differentiable parameter fitting (train/fit.py) and the params pytree."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dsp_stuff_tpu as dst
from dsp_stuff_tpu.ids import IdSpace
from dsp_stuff_tpu.train.fit import fit, make_train_step
from dsp_stuff_tpu.utils import precision


def _chain_graph():
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.0)
    lp = g.add("low_pass", ratio=0.3)
    out = g.add("output")
    g.chain(inp, gn, lp, out)
    return g, inp, gn, lp


def test_init_params_pytree():
    g, inp, gn, lp = _chain_graph()
    cg = dst.compile_graph(g)
    p = cg.init_params()
    assert float(p[str(gn.id)]["level"]) == 1.0
    assert float(p[str(lp.id)]["ratio"]) == pytest.approx(0.3)
    # static / field params excluded
    assert str(inp.id) not in p


def test_params_override_render():
    g, inp, gn, lp = _chain_graph()
    cg = dst.compile_graph(g)
    x = np.random.default_rng(0).standard_normal(512).astype(np.float32) * 0.3
    ext = {str(inp.id): x}
    base, _, _ = cg.render(ext)
    p = cg.init_params()
    p[str(gn.id)]["level"] = jnp.float32(2.0)
    doubled, _, _ = cg.render(ext, params=p)
    # low_pass(2x) == 2*low_pass(x) only up to f32 rounding
    np.testing.assert_allclose(np.asarray(doubled), np.asarray(base) * 2.0,
                               rtol=1e-5, atol=1e-7)


def test_reverb_seconds_is_static():
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    rv = g.add("reverb", seconds=0.01, decay=0.5)
    out = g.add("output")
    g.chain(inp, rv, out)
    cg = dst.compile_graph(g)
    p = cg.init_params()
    assert "seconds" not in p[str(rv.id)]
    assert "decay" in p[str(rv.id)]


def test_fit_recovers_gain():
    """Render a target with level=2.5, fit starting from level=1.0."""
    with precision.policy("fast"):
        g, inp, gn, lp = _chain_graph()
        cg = dst.compile_graph(g)
        rng = np.random.default_rng(1)
        x = rng.standard_normal((4, 512)).astype(np.float32) * 0.3
        ext = {str(inp.id): x}
        true = cg.init_params()
        true[str(gn.id)]["level"] = jnp.float32(2.5)
        target = jnp.stack(
            [jax.vmap(cg.fn, in_axes=(None, 0, None))(
                cg.init_state(), ext, true)[1][i]
             for i in cg.output_ids], axis=-2)
        import optax
        params, losses = fit(cg, ext, target, steps=250,
                             optimizer=optax.adam(0.05))
    assert losses[-1] < 1e-6, losses[-1]
    assert float(params[str(gn.id)]["level"]) == pytest.approx(2.5, abs=0.02)


def test_train_step_sharded_mesh(monkeypatch, tmp_path):
    """One training step with the batch sharded over all (8 virtual) devices:
    the dryrun_multichip path (its compile cache kept out of the repo)."""
    import sys, os
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__
    __graft_entry__.dryrun_multichip(len(jax.devices()))


def test_grad_finite_at_bypass_levels():
    """Distortion sliders at/below the bypass epsilon must yield finite
    gradients (the where-NaN-grad pitfall in clip(x*l)/l at l=0)."""
    from dsp_stuff_tpu.train.fit import make_loss_fn
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    dt = g.add("distort", mode="HardClip", level=0.0)
    ch = g.add("chebyshev", level_pos=0.0, level_neg=0.0)
    out = g.add("output")
    g.chain(inp, dt, ch, out)
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        loss = make_loss_fn(cg)
        x = np.random.default_rng(0).standard_normal((2, 256)).astype(np.float32) * 0.3
        ext = {str(inp.id): x}
        target = jnp.zeros((2, 1, 256), jnp.float32)
        grads = jax.grad(loss)(cg.init_params(), cg.init_state(), ext, target)
    for leaf in jax.tree.leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all(), grads


def test_fit_differentiable_through_chorus():
    """Gradient fitting must flow through Chorus graphs (config2) — guards
    against non-differentiable gather wrappers."""
    from dsp_stuff_tpu.train.fit import make_loss_fn
    from dsp_stuff_tpu.models import config2_delay_chorus
    g, meta = config2_delay_chorus()
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        loss = make_loss_fn(cg)
        x = (np.random.default_rng(0).standard_normal((2, 512)) * 0.3
             ).astype(np.float32)
        ext = {str(meta["input"]): x}
        target = jnp.zeros((2, 1, 512), jnp.float32)
        grads = jax.grad(loss)(cg.init_params(), cg.init_state(), ext, target)
    leaves = jax.tree.leaves(grads)
    assert leaves and all(np.isfinite(np.asarray(l)).all() for l in leaves)


def test_fit_through_envelope():
    """Gradients flow THROUGH an envelope node (the fast path's analytic
    custom_vjp, ops/envelope.py) and recover an upstream gain: the train
    path must work on graphs containing the non-associative recurrence."""
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=0.5)
    en = g.add("envelope", attack=10.0, release=60.0)
    out = g.add("output")
    g.chain(inp, gn, en, out)
    cg = dst.compile_graph(g)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1024) * 0.5).astype(np.float32)
    ext = {str(inp.id): x}
    with precision.policy("fast"):
        target_p = cg.init_params()
        target_p[str(gn.id)]["level"] = jnp.float32(1.7)
        target, _, _ = cg.render(ext, params=target_p)
        import optax
        fitted, losses = fit(cg, ext, np.asarray(target), steps=250,
                             optimizer=optax.adam(0.05))
    assert losses[-1] < 1e-4, losses[-1]
    assert abs(float(fitted[str(gn.id)]["level"]) - 1.7) < 0.08
    # the envelope's own sliders picked up finite (possibly zero) grads
    assert np.isfinite(float(fitted[str(en.id)]["attack"]))
