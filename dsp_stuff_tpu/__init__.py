"""dsp_stuff_tpu — a batched DSP-graph framework for accelerators.

A ground-up rebuild of the capabilities of simmsb/dsp-stuff (a desktop,
real-time, node-based audio effects application written in Rust) as a
batched DSP pipeline in JAX, run on NVIDIA GPUs.

Where the reference runs one tokio task per node exchanging 128-sample
blocks through lock-free SPSC ring buffers (reference: dsp-stuff/src/node.rs,
runtime.rs), this framework *compiles* the effect graph: acyclic regions are
vectorized over the full sample axis (elementwise chains fuse into single XLA
kernels, IIR recurrences lower to associative scans), and only feedback
cycles are wrapped in a `lax.scan` over 128-sample blocks, which reproduces
the reference's one-block feedback latency. Streams batch over a leading
axis via `vmap`, and shard over device meshes via `jax.sharding`.

Public API:
    Graph, load_graph, save_graph      -- graph IR + reference JSON compat
    compile_graph                      -- graph -> jittable render program
    render                             -- one-call offline render
    REGISTRY                           -- node-type registry

Reference file citations throughout the tree use paths relative to
/root/reference (snapshot of simmsb/dsp-stuff @ 2024-10-08).
"""

from dsp_stuff_tpu.utils.precision import PrecisionPolicy, get_policy, set_policy, policy
from dsp_stuff_tpu.registry import REGISTRY, register_node, NodeSpec
from dsp_stuff_tpu.graph import Graph, GraphNode, load_graph, loads_graph, save_graph, dumps_graph
from dsp_stuff_tpu.compiler.compile import compile_graph, CompiledGraph
from dsp_stuff_tpu.runtime.session import render, render_file
from dsp_stuff_tpu.runtime.stream import StreamSession
from dsp_stuff_tpu.runtime.checkpoint import save_checkpoint, load_checkpoint

# Importing the node library registers every node type.
import dsp_stuff_tpu.nodes  # noqa: F401

BLOCK_SIZE = 128        # reference block size (node.rs:257 BUF_SIZE)
SAMPLE_RATE = 48_000    # reference fixed rate (devices.rs:281, README.md:48)

__version__ = "0.1.0"

__all__ = [
    "Graph", "GraphNode", "load_graph", "loads_graph", "save_graph", "dumps_graph",
    "compile_graph", "CompiledGraph", "render", "render_file",
    "StreamSession", "save_checkpoint", "load_checkpoint",
    "REGISTRY", "register_node", "NodeSpec",
    "PrecisionPolicy", "get_policy", "set_policy", "policy",
    "BLOCK_SIZE", "SAMPLE_RATE",
]
