"""Sharded forward render (parallel/mesh.py) + multichip self-provisioning.

The scaling story is pure data parallelism over independent streams
(SURVEY.md section 5): render_sharded must (a) match the unsharded batched
render numerically, (b) handle lockstep (shared, unbatched) state leaves
under NamedSharding, and (c) compile to a module with NO collectives for
the forward pass.  dryrun_multichip(cpu=True) must self-provision a
virtual mesh when the ambient backend is too small.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dsp_stuff_tpu as dst
from dsp_stuff_tpu.ids import IdSpace
from dsp_stuff_tpu.parallel.mesh import make_mesh, render_sharded, shard_streams
from dsp_stuff_tpu.utils import precision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph_with_lockstep_state():
    """Chain with reverb (shared 'pos' write clock) and chorus (shared 't0'
    sample clock) -- the lockstep state leaves that must stay unbatched."""
    g = dst.Graph(IdSpace())
    inp = g.add("input")
    gn = g.add("gain", level=1.3)
    rv = g.add("reverb", seconds=0.003, decay=0.5)
    ch = g.add("chorus", rate=1.5, depth=0.002, mix=0.4)
    out = g.add("output")
    g.chain(inp, gn, rv, ch, out)
    return g, inp


def test_render_sharded_matches_unsharded():
    g, inp = _graph_with_lockstep_state()
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        mesh = make_mesh()
        S = 2 * mesh.size
        x = (np.random.default_rng(0)
             .standard_normal((S, 1, 512)).astype(np.float32) * 0.25)
        outs_sh, _, st_sh = render_sharded(cg, x, mesh)
        outs_ref, _, st_ref = cg.render(jnp.asarray(x), batch_shape=(S,))
    np.testing.assert_array_equal(np.asarray(outs_sh), np.asarray(outs_ref))
    # lockstep leaves come back unbatched (scalar clock, not per-stream)
    for st in (st_sh, st_ref):
        leaves = {k: v for k, v in st.items() if isinstance(v, dict)}
        shared = [v[k] for v in leaves.values()
                  for k in ("pos", "t0") if k in v]
        assert shared, "expected lockstep leaves in the state"
        for leaf in shared:
            assert jnp.ndim(leaf) == 0 or jnp.shape(leaf)[0] != S, leaf.shape


def test_render_sharded_continuation_state():
    """A second segment fed the sharded first segment's state must equal
    one long unsharded render (state round-trips through NamedSharding)."""
    g, inp = _graph_with_lockstep_state()
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        mesh = make_mesh()
        S = mesh.size
        x = (np.random.default_rng(1)
             .standard_normal((S, 1, 1024)).astype(np.float32) * 0.25)
        long, _, _ = cg.render(jnp.asarray(x), batch_shape=(S,))
        a, _, st = render_sharded(cg, x[..., :512], mesh)
        b, _, _ = cg.render(jnp.asarray(x[..., 512:]), state=st,
                            batch_shape=(S,))
    # T=512 and T=1024 programs fuse differently under the fast policy, so
    # segmentation is 1-ulp-class, not bitwise
    np.testing.assert_allclose(
        np.concatenate([np.asarray(a), np.asarray(b)], axis=-1),
        np.asarray(long), atol=1e-6, rtol=0)


def test_forward_render_compiles_without_collectives():
    """Pure DP over streams: the compiled sharded forward module must not
    contain any cross-device collective."""
    g, inp = _graph_with_lockstep_state()
    with precision.policy("fast"):
        cg = dst.compile_graph(g)
        mesh = make_mesh()
        S = mesh.size
        x = (np.random.default_rng(2)
             .standard_normal((S, 512)).astype(np.float32) * 0.25)
        ext = {str(inp.id): shard_streams(jnp.asarray(x), mesh)}
        fn = jax.vmap(cg.fn, in_axes=(None, 0, None),
                      out_axes=(cg.state_axes(), 0, 0))
        txt = (jax.jit(fn).lower(cg.init_state(), ext, None)
               .compile().as_text())
    for coll in ("all-reduce", "all-gather", "all-to-all",
                 "collective-permute", "reduce-scatter"):
        assert coll not in txt, f"forward render emitted {coll}"


def test_dryrun_multichip_self_provisions(tmp_path):
    """From a 1-device process, dryrun_multichip(8, cpu=True) must
    provision its own 8-device CPU mesh (re-exec path), succeed, and say
    where it ran; without cpu=True it refuses to run short of devices."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    code = ("import jax; jax.devices();"          # pre-initialize: 1 device
            "import __graft_entry__ as g; g.dryrun_multichip(8, cpu=True)")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dryrun_multichip(8): ok on 8 cpu devices" in r.stderr

    code = "import __graft_entry__ as g; g.dryrun_multichip(8)"
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0
    assert "only 1 devices" in r.stderr
