"""Graph compiler: effect graph -> single jittable render program.

This replaces the reference's entire runtime layer (task-per-node + SPSC
pipes + emergent dataflow scheduling, runtime.rs:614-752, node.rs:267-352)
with ahead-of-time compilation:

* links dissolve into SSA values (fan-out = value reuse);
* fan-in becomes the reference's averaging mix ``sum / (n + 1e-4)``
  (node.rs:162-194, divisor quirk SURVEY.md 2.4 #1);
* modulation (`as_input`) ports apply the [-1,1] -> slider-range mapping of
  the derive macro (dsp-stuff-derive/src/lib.rs:135-153);
* acyclic regions evaluate one node per *full sequence* -- elementwise
  chains fuse in XLA, IIRs lower to associative scans (ops/scan.py);
* each feedback SCC compiles to one `lax.scan` over 128-sample blocks, with
  intra-cycle back edges carrying exactly one block of delay (the defined
  semantic for the reference's emergent pipe latency; SURVEY.md section 7
  "hard parts");
* Input nodes bind external source columns, Output nodes produce rendered
  channels, analysis sinks produce aux arrays.

The emitted callable has signature

    fn(state, ext) -> (new_state, outs, aux)

with everything a pytree of [T]-shaped f32 arrays; batching is plain
`jax.vmap`, sharding is `jax.sharding` on the batch axis (parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from dsp_stuff_tpu.graph import Graph, GraphNode
from dsp_stuff_tpu.registry import ParamSpec
from dsp_stuff_tpu.compiler.scc import condensation_topo_order

EXTERNAL = "__external__"

# Optional observability hook: when set to a callable
# (node_id, cfg_name, outs_dict) it is invoked after every node evaluation
# at trace/eager time (utils/obs.debug_render uses it for per-node stats;
# the reference's analog is #[tracing::instrument] on process(),
# e.g. gain.rs:26).  None (the default) costs nothing.
NODE_HOOK = None


def _fanin_divisor(n: int) -> np.float32:
    """num_frames starts at 0.0001 and gains 1.0 per connected pipe, in f32
    (node.rs:166,179,190-192)."""
    d = np.float32(0.0001)
    for _ in range(n):
        d = np.float32(d + np.float32(1.0))
    return d


def _avg(sources: list, T: int):
    """Fan-in average; returns (signal [T], n_connected).

    Sum order contract: sources arrive in ``graph.links`` insertion order,
    which equals ascending-LinkId order in the reference (restore_config
    generates LinkIds in JSON list order, runtime.rs:118-120).  The
    reference's own within-port sum order is the iteration order of a
    ``HashSet<LinkId>`` (runtime.rs:38,175-180 feeding collect_and_average
    node.rs:173-184) -- randomized per process -- so for >= 3 sources no
    fixed order can be bitwise-stable against it; ours is the canonical
    deterministic choice within that envelope.  The f32 chain ``(s0+s1)+s2``
    matches the oracle's (tests/oracle fanin_average) exactly.

    Under the 'exact' policy two XLA rewrites must be blocked to get the
    reference's bit pattern:

    * FMA contraction of a producer's trailing multiply into the fan-in
      add (the Rust reference compiles mul and add as two roundings).
      An f32->f32 ``reduce_precision`` fence here does NOT stop it (it is
      an identity the simplifier sees through), so the protection lives at
      the PRODUCERS: every bitwise-class node whose last op is a bare
      multiply emits it via ``precision.exact_mul`` (Gain, Mix,
      signal_gen, the reverb comb) -- the f64-product-rounded-to-f32 form
      LLVM cannot contract (ops/scan._mul_unfused);
    * the algebraic simplifier's divide rewrites (recip-mul and
      divide-chain fusion) vs the reference's true f32 division
      (node.rs:190-192) -- handled by ``precision.div_ieee``."""
    n = len(sources)
    if n == 0:
        return jnp.zeros((T,), jnp.float32), 0
    from dsp_stuff_tpu.utils import precision
    pol = precision.get_policy()
    acc = sources[0]
    for s in sources[1:]:
        acc = acc + s
    if pol.name != "fast":
        # parity AND exact take the true f32 divide: the recip-mul rewrite
        # costs 1 ulp per hop, and a phase-sensitive modulation target
        # (chorus rate) amplifies a single fan-in ulp ~1000x past the -90
        # parity budget (found by the random-graph fuzz)
        return precision.div_ieee(acc, _fanin_divisor(n)), n
    return acc / _fanin_divisor(n), n


def _map_mod(sig, p: ParamSpec):
    """Modulation-signal -> slider-range mapping (lib.rs:140-148):
    y=(x+1)/2; z=clamp(y,0,1); lo + (hi-lo)*z, all f32.

    Under parity/exact the final multiply is FMA-fenced: a 1-ulp shift in
    a mapped CHORUS RATE moves the LFO phase enough to shift the tap
    trajectory ~1e-5 samples — past the -90 dBFS budget (found by the
    random-graph fuzz; same class as the ops/modfx.py trajectory fences)."""
    y = (sig + np.float32(1.0)) / np.float32(2.0)
    z = jnp.clip(y, 0.0, 1.0)
    span = np.float32(np.float32(p.hi) - np.float32(p.lo))
    from dsp_stuff_tpu.utils import precision
    if precision.get_policy().name != "fast":
        return np.float32(p.lo) + precision.mul_unfused(span, z)
    return np.float32(p.lo) + span * z


def _call(impl, params, state, inputs, T, block_size):
    if getattr(impl, "needs_length", False):
        return impl.process_seq(params, state, inputs, T=T,
                                block_size=block_size)
    return impl.process_seq(params, state, inputs)


def _call_block(impl, params, state, inputs, block_size):
    fn = getattr(impl, "process_block", impl.process_seq)
    if getattr(impl, "needs_length", False):
        return fn(params, state, inputs, T=block_size, block_size=block_size)
    return fn(params, state, inputs)


@dataclasses.dataclass
class CompiledGraph:
    graph: Graph
    block_size: int
    input_ids: list[int]          # Input-node ids, ascending
    output_ids: list[int]         # Output-node ids, ascending
    sink_ids: list[int]           # analysis sinks, ascending
    fn: Callable                  # fn(state, ext, params=None) -> (state, outs, aux)
    _init_state: Callable
    _init_params: Callable

    def init_state(self):
        return self._init_state()

    def init_params(self):
        """Differentiable parameter pytree {node_id: {param: f32 scalar}}
        holding every non-static slider, initialized from the graph's
        values.  Pass (a perturbed copy of) it as ``fn``'s third argument /
        ``render(params=...)`` to override trace-time constants — this is
        the handle the gradient-fitting path (train/fit.py) optimizes."""
        return self._init_params()

    def _walk_state(self, state, on_batched, on_shared):
        """Apply on_batched/on_shared per node-state entry.  Nodes may
        declare ``shared_state_keys`` on their impl: those leaves are
        LOCKSTEP state (e.g. the chorus sample clock) — identical across
        streams by construction, so they stay unbatched under vmap (which
        is also what keeps shared-tap gathers on the fast row-gather
        path, ops/modfx.py)."""
        out = {}
        for nid_s, nst in sorted(state.items(), key=lambda kv: kv[0]):
            if nid_s.startswith("__cycle__"):
                # per-cycle back-edge blocks: per-stream signal state
                out[nid_s] = jax.tree.map(on_batched, nst)
                continue
            impl = self.graph.nodes[int(nid_s)].spec.impl
            shared = set(getattr(impl, "shared_state_keys", ()))
            if shared and isinstance(nst, dict):
                out[nid_s] = {k: (on_shared(v) if k in shared
                                  else jax.tree.map(on_batched, v))
                              for k, v in nst.items()}
            else:
                out[nid_s] = jax.tree.map(on_batched, nst)
        return out

    @functools.cached_property
    def _state_axes_cache(self):
        return self._walk_state(self.init_state(),
                                on_batched=lambda _: 0,
                                on_shared=lambda _: None)

    def state_axes(self):
        """vmap in_axes pytree for a batched state: 0 for per-stream
        leaves, None for node-declared shared (lockstep) leaves."""
        return self._state_axes_cache

    def _state_is_batched(self, state, batch_shape) -> bool:
        """True when the state pytree carries leading batch axes — e.g. the
        state a previous batched render returned, fed back for segmented
        continuation.  Detected by rank against a fresh init_state
        (shared/lockstep leaves excluded — they never batch)."""
        if not batch_shape:
            return False
        fresh = self.init_state()

        def ranks(st):
            acc = []
            self._walk_state(st, on_batched=lambda l: acc.append(jnp.ndim(l)),
                             on_shared=lambda l: None)
            return acc

        got, want = ranks(state), ranks(fresh)
        if got == want:
            return False
        nb = len(batch_shape)
        if got == [w + nb for w in want]:
            return True
        raise ValueError(
            f"state ranks {got} match neither fresh {want} nor batched "
            f"(+{nb}) layout; pass a state from a render with the same "
            f"batch_shape, or broadcast_state(init_state(), batch_shape)")

    def broadcast_state(self, state, batch_shape: tuple[int, ...]):
        """Tile a (fresh, unbatched) state pytree across leading batch axes
        so it can be carried through a vmapped fn (state in_axes =
        ``state_axes()``); shared/lockstep leaves stay unbatched."""
        return self._walk_state(
            state,
            on_batched=lambda s: jnp.broadcast_to(
                jnp.asarray(s), (*batch_shape, *jnp.shape(s))),
            on_shared=lambda s: s)

    @functools.cached_property
    def jit_fn(self):
        return jax.jit(self.fn)

    def render(self, inputs=None, T: int | None = None, state=None,
               batch_shape: tuple[int, ...] = (), params=None):
        """One-call offline render.

        inputs -- None (no Input nodes / silence), an [n_inputs, T] array,
                  a dict {node_id: [T] array}, or with leading batch axes
                  [..., n_inputs, T] matching batch_shape.
        Returns (outs [n_out, T] (or [..., n_out, T]), aux dict, state).
        """
        ext = self._pack_inputs(inputs, T, batch_shape)
        T = next(iter(ext.values())).shape[-1] if ext else T
        if T is None:
            raise ValueError("T is required when the graph has no Input nodes")
        if T % self.block_size:
            raise ValueError(f"T={T} must be a multiple of block_size={self.block_size}")
        if state is None:
            state = self.init_state()
            state_batched = False
        else:
            state_batched = self._state_is_batched(state, batch_shape)
        fn = self.jit_fn
        st_axes = self.state_axes() if state_batched else None
        for _ in range(len(batch_shape)):
            # out_axes mirrors state_axes so shared (lockstep) leaves come
            # back unbatched — the default 0 would broadcast them per-stream
            fn = jax.vmap(fn, in_axes=(st_axes, 0, None),
                          out_axes=(self.state_axes(), 0, 0))
        state, outs, aux = fn(state, ext, params)
        out_arr = jnp.stack([outs[i] for i in self.output_ids], axis=-2) \
            if self.output_ids else jnp.zeros((*batch_shape, 0, T), jnp.float32)
        return out_arr, aux, state

    def _pack_inputs(self, inputs, T, batch_shape):
        if inputs is None:
            if T is None:
                raise ValueError("T required to synthesize silent inputs")
            ext = {str(i): jnp.zeros((*batch_shape, T), jnp.float32)
                   for i in self.input_ids}
            if not ext:
                # length-carrying dummy so fn can infer T under jit
                ext["__len__"] = jnp.zeros((*batch_shape, T), jnp.float32)
            return ext
        if isinstance(inputs, dict):
            ext = {str(k): jnp.asarray(v, jnp.float32)
                   for k, v in inputs.items()}
            want = 1 + len(batch_shape)
            for k, v in ext.items():
                if v.ndim != want:
                    raise ValueError(
                        f"input {k!r} has shape {v.shape}; expected "
                        f"{want}-d [*batch_shape, T] for "
                        f"batch_shape={batch_shape}.  Pass "
                        f"batch_shape=... to render() for batched "
                        f"streams (stateful nodes need vmapped state, "
                        f"not broadcasting).")
            missing = [i for i in self.input_ids if str(i) not in ext]
            if missing:
                Td = next(iter(ext.values())).shape[-1] if ext else T
                for i in missing:
                    ext[str(i)] = jnp.zeros((*batch_shape, Td), jnp.float32)
            return ext
        arr = jnp.asarray(inputs, jnp.float32)
        if arr.ndim == 1:
            arr = arr[None]
        assert arr.shape[-2] == len(self.input_ids), \
            (arr.shape, self.input_ids)
        return {str(nid): arr[..., i, :]
                for i, nid in enumerate(self.input_ids)}


def apply_knob_writeback(graph: Graph, aux) -> Graph:
    """Fold aux["__knobs__"] values back into the graph's slider settings
    (host side), so a subsequent save reflects the knob positions the
    reference UI would show after running (quirk SURVEY.md 2.4 #9)."""
    for key, val in (aux.get("__knobs__") or {}).items():
        nid_s, pname = key.split(":", 1)
        graph.nodes[int(nid_s)].params[pname] = float(np.asarray(val).ravel()[-1])
    return graph


def _cycle_key(comp) -> str:
    """State key for a feedback SCC's carried previous-block outputs."""
    return f"__cycle__{min(comp)}"


def _active_nodes(graph: Graph) -> set[int]:
    """Nodes with at least one connected link (the reference never starts a
    node with zero connections, runtime.rs:661-668)."""
    act = set()
    for l in graph.links:
        act.add(l.src)
        act.add(l.dst)
    return act


#: graph node types that are linear systems fusable into one blocked
#: solve (ops/cascade.py), and their section kinds
_LINEAR_KINDS = {"gain": "gain", "low_pass": "lp", "high_pass": "hp",
                 "biquad": "bq"}

#: structural switch for the feedback-cycle mega path (tests flip it to
#: pin the fused render against the per-node cycle scan)
CYCLE_FUSION = True

#: stateless elementwise node types fusable into a chain segment
#: (ops/chain_segment.py) between linear runs
_EW_KINDS = ("distort", "overdrive", "chebyshev")

#: stateful node types that keep a chain segment worthwhile
_MEGA_STATEFUL = ("low_pass", "high_pass", "biquad", "reverb", "chorus")


def _chorus_mega_geo(node):
    """(L, NH, EV, RS) for a chorus node's mtap stage, or None when the
    LFO geometry can't lower (non-concrete params, too-fast/deep LFO,
    too-small minimum delay — ops/modfx.mtap_static)."""
    from dsp_stuff_tpu.ops.modfx import max_delay_samples, mtap_static
    ps = [node.params.get(k) for k in ("rate", "depth", "base", "mix")]
    if not all(isinstance(v, (int, float, np.floating)) for v in ps):
        return None
    L = max_delay_samples(float(ps[2]), float(ps[1]))
    geo = mtap_static(float(ps[0]), float(ps[1]), float(ps[2]), L)
    if geo is None:
        return None
    return (L, *geo)


def _plan_mega_fusion(graph: Graph, nodes: dict, sccs) -> list:
    """Maximal ACYCLIC chains of mega-fusable nodes (the linear kinds +
    distort/overdrive/chebyshev at base rate + reverb) joined by chain
    links, evaluated as ONE ops/chain_segment (a stage composition with
    the fan-in scales between members folded into it).

    The chain joint out of a member is the ONE out-link into another
    mega-fusable node's sole-source "in" port (two distinct candidates
    would make the chain ambiguous — none is taken, mirroring
    _plan_linear_fusion's sole_joint).  Extra consumers of a member's
    output (analysis sinks, second outputs, modulation targets outside
    the run) no longer end the chain: the segment EMITS that
    intermediate with a ("tap", ti) stage — the reference's fan-out
    duplication (node.rs:321-325) — so a mid-chain wave_view no longer
    splits the segment.  A run must have >= 2
    nodes, >= 1 stateful member and >= 1 non-linear member (pure-linear
    runs belong to _plan_linear_fusion's richer handling,
    pure-elementwise ones to XLA fusion)."""
    cyclic = set()
    for comp in sccs:
        if len(comp) > 1 or any(l.src == l.dst == comp[0]
                                for l in graph.links):
            cyclic.update(comp)
    out_links: dict[int, list] = {}
    modded = set()
    for l in graph.links:
        out_links.setdefault(l.src, []).append(l)
        if l.dst_port != "in":
            modded.add(l.dst)

    def mega_ok(nid) -> bool:
        node = nodes.get(nid)
        if node is None or nid in modded or nid in cyclic:
            return False
        cn = node.cfg_name
        if cn in _LINEAR_KINDS or cn in ("chebyshev", "reverb"):
            return True
        if cn in ("distort", "overdrive"):
            # oversampled shaping runs through the FIR rate ladder --
            # not a resident-block stage
            return str(node.params.get("oversample", "1")) == "1"
        if cn == "chorus":
            return _chorus_mega_geo(node) is not None
        return False

    nxt: dict[int, int] = {}
    for nid in nodes:
        if not mega_ok(nid):
            continue
        joints = []
        for l in out_links.get(nid, []):
            if (l.dst_port == "in" and l.dst != nid
                    and len(graph.in_links(l.dst, "in")) == 1
                    and mega_ok(l.dst)):
                joints.append(l.dst)
        if len(joints) == 1:
            nxt[nid] = joints[0]

    runs = []
    targets = set(nxt.values())
    for nid in sorted(nxt):
        if nid in targets:
            continue
        chain = [nid]
        while chain[-1] in nxt:
            chain.append(nxt[chain[-1]])
        kinds = [nodes[n].cfg_name for n in chain]
        if (len(chain) >= 2
                and any(k in _MEGA_STATEFUL for k in kinds)
                and any(k not in _LINEAR_KINDS for k in kinds)):
            runs.append(chain)
    return runs


def _plan_linear_fusion(graph: Graph, nodes: dict, sccs,
                        exclude: frozenset = frozenset()) -> list:
    """Maximal runs of adjacent linear nodes fusable into one
    ops/cascade.linear_cascade solve.  Returns a list of runs, each a
    list of node ids in signal order — acyclic runs AND in-cycle runs
    alike (the eval sites tell them apart by node membership).

    Structural preconditions (anything else falls back to per-node eval):
      * every node is gain/low_pass/high_pass/biquad;
      * consecutive nodes are joined by a chain link: the downstream
        node's "in" has exactly that one source, and it is the upstream
        node's only outgoing link INTO A LINEAR NODE.  Other consumers
        of an intermediate's output (analysis sinks, second outputs,
        modulation ports of nodes outside the run) no longer break the
        run: the fused solve EMITS the intermediate signal with one
        extra taps-GEMM row set (ops/cascade.linear_cascade ``emits``) —
        the run's eval site publishes it like a normal node output;
      * no run member receives links on any port besides "in" (no
        modulation into a fused section -- gain's level port included);
      * the composite state dimension is capped at
        ops/cascade.MAX_RUN_DIM; longer chains split greedily;
      * a run keeps >= 2 nodes and >= 1 stateful section (pure-gain
        chains are XLA's elementwise fusion problem, not ours).

    Because intermediates may now have consumers scheduled BEFORE the
    run's tail in the SCC topo order, fused runs evaluate at their HEAD
    node's position (the head's inputs are the run's only external
    inputs, so everything is ready there and every emitted signal exists
    before any consumer runs).

    Runs INSIDE a feedback SCC additionally require the members to
    occupy CONSECUTIVE positions of the cycle's execution order
    (ascending node ids).  That makes fused evaluation semantically
    identical to the per-node block body: every intra-run link is a
    same-block forward edge (no hidden one-block delay), and since no
    OTHER node evaluates between head and tail, every edge in or out of
    the run resolves to the same cur-vs-prev choice fused or not (a
    tail->head self-feedback still reads the previous block, exactly as
    unfused; an in-cycle tap consumer sits before the head -> reads the
    carried previous block, or after the tail -> reads the emitted
    current block, both exactly as unfused).  Runs never span SCC
    boundaries.
    """
    from dsp_stuff_tpu.ops.cascade import SECTION_DIMS, MAX_RUN_DIM
    cyclic = set()
    cycle_comps = []
    for comp in sccs:
        if len(comp) > 1 or any(l.src == l.dst == comp[0]
                                for l in graph.links):
            cyclic.update(comp)
            cycle_comps.append(comp)
    out_links: dict[int, list] = {}
    modded = set()
    for l in graph.links:
        out_links.setdefault(l.src, []).append(l)
        if l.dst_port != "in":
            modded.add(l.dst)

    def dim(nid) -> int:
        return SECTION_DIMS[_LINEAR_KINDS[nodes[nid].cfg_name]]

    def segment(chain) -> list:
        """Greedy split of a maximal chain into runs under MAX_RUN_DIM,
        keeping only runs with >= 2 nodes and >= 1 stateful section."""
        runs = []
        seg: list = []
        d = 0
        for n in chain + [None]:
            if n is None or d + dim(n) > MAX_RUN_DIM:
                if len(seg) >= 2 and d >= 1:
                    runs.append(seg)
                seg, d = [], 0
            if n is not None:
                seg.append(n)
                d += dim(n)
        return runs

    def chains_from(nxt: dict) -> list:
        runs = []
        targets = set(nxt.values())
        for nid in sorted(set(nxt)):
            if nid in targets:
                continue
            chain = [nid]
            while chain[-1] in nxt:
                chain.append(nxt[chain[-1]])
            runs.extend(segment(chain))
        return runs

    def sole_joint(nid, extra_ok) -> int | None:
        """The downstream node id when nid's output has exactly one
        chain-joint candidate: a link into a linear node's "in" port
        that is that port's sole source.  Other outgoing links are
        allowed (they become emitted taps); two distinct joint
        candidates would make the chain ambiguous, so none is taken."""
        joints = []
        for l in out_links.get(nid, []):
            if (l.dst_port == "in" and l.dst != nid
                    and len(graph.in_links(l.dst, "in")) == 1
                    and extra_ok(l.dst)):
                joints.append(l.dst)
        if len(joints) == 1:
            return joints[0]
        return None

    def linear(nid) -> bool:
        node = nodes.get(nid)
        return (node is not None and node.cfg_name in _LINEAR_KINDS
                and nid not in modded and nid not in exclude)

    # acyclic runs
    nxt: dict[int, int] = {}
    for nid in nodes:
        if not (linear(nid) and nid not in cyclic):
            continue
        dst = sole_joint(nid, lambda d: linear(d) and d not in cyclic)
        if dst is not None:
            nxt[nid] = dst
    runs = chains_from(nxt)

    # in-cycle runs, per SCC, contiguous in execution order
    for comp in cycle_comps:
        order = sorted(comp)
        pos = {nid: i for i, nid in enumerate(order)}
        cnxt: dict[int, int] = {}
        for nid in comp:
            if not linear(nid):
                continue
            dst = sole_joint(nid, lambda d: linear(d) and d in pos)
            if dst is not None and pos[dst] == pos[nid] + 1:
                cnxt[nid] = dst
        runs.extend(chains_from(cnxt))
    return runs


def compile_graph(graph: Graph, block_size: int = 128,
                  cycle_unroll: int = 8) -> CompiledGraph:
    if block_size % 128:
        # the reference frame (node.rs:257) is semantically visible: Fuzz
        # block-max and the signal_gen clock wrap are pinned to the 128
        # grid (SURVEY 2.4 #4/#5), so block_size must tile it; feedback
        # latency legitimately changes with block_size (documented)
        raise ValueError(
            f"block_size must be a multiple of 128 (the reference frame, "
            f"node.rs:257); got {block_size}")
    active = _active_nodes(graph)
    nodes = {nid: n for nid, n in graph.nodes.items() if nid in active}

    input_ids = sorted(n.id for n in nodes.values()
                       if getattr(n.spec.impl, "graph_input", False))
    output_ids = sorted(n.id for n in nodes.values()
                        if getattr(n.spec.impl, "graph_output", False))
    sink_ids = sorted(n.id for n in nodes.values()
                      if n.spec.is_sink and not getattr(n.spec.impl,
                                                        "graph_output", False))

    # node-level dependency edges (src -> dst)
    edges: dict[int, set[int]] = {nid: set() for nid in nodes}
    for l in graph.links:
        if l.src in nodes and l.dst in nodes:
            edges[l.src].add(l.dst)
    sccs = condensation_topo_order(sorted(nodes), edges)

    # structural plans: chain segments first (linear cascades +
    # elementwise shapers + combs as ONE op, ops/chain_segment.py), then
    # linear-run fusion (ops/cascade.py)
    # over the remaining nodes (tapped intermediates are emitted from
    # the solve).  Dynamic preconditions (fast policy, no NODE_HOOK,
    # concrete params, no fit overrides) are re-checked per trace.
    mega_plan = _plan_mega_fusion(graph, nodes, sccs)
    mega_members = frozenset(n for run in mega_plan for n in run)
    fusion_plan = _plan_linear_fusion(graph, nodes, sccs,
                                      exclude=mega_members)

    def init_state():
        st = {
            str(nid): nodes[nid].spec.impl.init_state(nodes[nid].params,
                                                      block_size)
            for nid in nodes
        }
        # per-cycle back-edge context: the defined semantic gives every
        # intra-cycle edge from a not-yet-run member ONE BLOCK of delay --
        # that previous block is real DSP state and must chain across
        # segmented/streamed renders (zeros only at true t=0; found by the
        # random-graph segmentation fuzz: resetting it glitched feedback
        # graphs by -25 dBFS at every segment boundary)
        for comp in sccs:
            if len(comp) > 1 or any(l.src == l.dst == comp[0]
                                    for l in graph.links):
                st[_cycle_key(comp)] = {
                    f"{nid}:{port}": jnp.zeros((block_size,), jnp.float32)
                    for nid in comp for port in nodes[nid].spec.outputs}
        return st

    def init_params():
        out = {}
        for nid, node in nodes.items():
            entry = {p.name: jnp.float32(node.params[p.name])
                     for p in node.spec.params
                     if isinstance(p, ParamSpec) and not p.static}
            if entry:
                out[str(nid)] = entry
        return out

    def fn(state, ext, params=None):
        T = None
        for k, v in ext.items():
            if T is not None and v.shape[-1] != T:
                bad = {kk: vv.shape[-1] for kk, vv in ext.items()}
                raise ValueError(
                    f"external inputs disagree on render length: input "
                    f"node {k!r} has T={v.shape[-1]}, others {bad}; all "
                    f"inputs must share the same trailing length")
            T = v.shape[-1]
        if T is None:
            raise ValueError(
                "graphs without Input nodes need a length hint; "
                "use CompiledGraph.render(T=...)")
        return _eval(state, ext, T, params)

    def _resolve_params(node: GraphNode, in_sigs: dict, T: int, pdict):
        """params dict with modulation ports resolved; in_sigs maps port ->
        (avg signal, n_connected).  pdict (if given) supplies traced
        override values for non-static sliders."""
        over = (pdict or {}).get(str(node.id), {})
        params: dict[str, Any] = {}
        for p in node.spec.params:
            if isinstance(p, ParamSpec) and p.as_input:
                sig, n = in_sigs.get(p.name, (None, 0))
                if n > 0:
                    params[p.name] = _map_mod(sig, p)
                elif p.name in over:
                    params[p.name] = over[p.name]
                else:
                    params[p.name] = float(node.params[p.name])
            elif isinstance(p, ParamSpec) and p.name in over:
                params[p.name] = over[p.name]
            else:
                params[p.name] = node.params[p.name]
        return params

    def _run_sections(run, pdict):
        """(sections, member_end) for a fusable run: the concrete
        (kind, param) section tuple with the link fan-in scales
        interleaved as gain sections, and member_end mapping each node
        id to the index of ITS last section (the emit point for tapped
        intermediates) -- or None when this trace cannot fuse it (traced
        fit overrides or non-concrete params)."""
        h = 1.0 / float(_fanin_divisor(1))
        secs: list = []
        member_end: dict[int, int] = {}
        for i, nid in enumerate(run):
            if str(nid) in (pdict or {}):
                return None                  # traced overrides: no fold
            node = nodes[nid]
            kind = _LINEAR_KINDS[node.cfg_name]
            if i:
                secs.append(("gain", h))
            if kind == "gain":
                lvl = node.params["level"]
                if not isinstance(lvl, (int, float, np.floating)):
                    return None
                secs.append(("gain", float(np.float32(lvl))))
            elif kind in ("lp", "hp"):
                r = node.params["ratio"]
                if not isinstance(r, (int, float, np.floating)):
                    return None
                secs.append((kind, float(r)))
            else:
                raw = [node.params[k]
                       for k in ("a0", "a1", "a2", "b0", "b1", "b2")]
                if not all(isinstance(v, (int, float, np.floating))
                           for v in raw):
                    return None
                # same f32 division as BiQuad.process_seq (biquad.rs:64-71)
                a0 = np.float32(raw[0])
                cf = tuple(float(np.float32(np.float32(v) / a0))
                           for v in raw[1:])
                secs.append(("bq", cf))
            member_end[nid] = len(secs) - 1
        return tuple(secs), member_end

    def _run_taps(run) -> list[int]:
        """Non-tail run members whose output has a consumer besides the
        internal chain link (analysis taps, second outputs, modulation
        of nodes outside the run): the fused solve must emit them."""
        internal = set(zip(run[:-1], run[1:]))
        tapped = []
        for nid in run[:-1]:
            # any link to the next member is the chain joint (members
            # accept no non-"in" links, and a second source into "in"
            # would have broken the chain); everything else is a tap
            if any(l.src == nid and (nid, l.dst) not in internal
                   for l in graph.links):
                tapped.append(nid)
        return tapped

    def _mega_stages(run, pdict):
        """(stages, state_specs, head_single, out_fold, tapped) for a
        mega run in ops/chain_segment's stage grammar, or None when this
        trace cannot fuse it (traced fit overrides or non-concrete
        params).  Adjacent linear members collapse into shared
        ``("cascade", sections)`` stages (split at cascade.MAX_RUN_DIM)
        with the link fan-in scales interleaved as gain sections exactly
        like _run_sections; scales between non-linear stages accumulate
        into one ``("scale", s)`` (fast policy only, so the fold's
        single rounding is in-contract).  state_specs parallels the
        STATEFUL stages in order:
        ("cascade", sections, stateful_ids) | ("comb", nid).

        ``tapped`` lists the non-tail members whose output has consumers
        besides the chain joint, in ("tap", ti) index order: the open
        cascade closes at a tapped linear member's section (the tap
        point must be the node's own output, so the composite solve
        splits there) and a ("tap", ti) stage emits the flow — the
        segment publishes it like a normal node output.

        Two boundary scale folds save a full-signal pass each (an
        _avg is a divide over the whole signal):
          * ``head_single`` — the head has exactly one in-link, so its
            fan-in scale seeds the pending scale (usually folding into
            the first cascade's gain section) and the eval skips _avg;
          * ``out_fold`` — the tail's sole consumer is a single-source
            Output node, so the output's fan-in scale appends as a
            trailing stage and the output collection reads the published
            value directly (out_fold is that Output's node id, or None).
        Both replace the reference's fan-in divide with a multiply by the
        f32 reciprocal — the documented 1-ulp fast-policy class."""
        from dsp_stuff_tpu.ops.cascade import SECTION_DIMS, MAX_RUN_DIM
        from dsp_stuff_tpu.ops.delay_line import delay_samples
        h = 1.0 / float(_fanin_divisor(1))
        stages: list = []
        specs: list = []
        cur: list = []          # open cascade: (kind, param) sections
        cur_ids: list = []      # stateful member node ids of cur
        cur_dim = 0
        head_single = len(graph.in_links(run[0], "in")) == 1
        pend = h if head_single else 1.0   # pending scale before next stage
        tail_out = [l for l in graph.links if l.src == run[-1]]
        out_fold = None
        if (len(tail_out) == 1 and tail_out[0].dst_port == "in"
                and tail_out[0].dst in output_ids
                and len(graph.in_links(tail_out[0].dst, "in")) == 1):
            out_fold = tail_out[0].dst

        def concrete(v):
            return isinstance(v, (int, float, np.floating))

        def close():
            nonlocal cur, cur_ids, cur_dim, pend
            if not cur:
                return
            if cur_dim == 0:
                # stateless (pure-gain) group: fold into the running scale
                for _, v in cur:
                    pend *= float(v)
            else:
                stages.append(("cascade", tuple(cur)))
                specs.append(("cascade", tuple(cur), tuple(cur_ids)))
            cur, cur_ids, cur_dim = [], [], 0

        def flush_scale():
            nonlocal pend
            if pend != 1.0:
                stages.append(("scale", float(np.float32(pend))))
                pend = 1.0

        # members with consumers besides the chain joint: emitted taps
        # (any member->member link is the joint — members accept links
        # only on their sole-source "in")
        internal = set(zip(run[:-1], run[1:]))
        tap_set = {n for n in run[:-1]
                   if any(l.src == n and (n, l.dst) not in internal
                          for l in graph.links)}
        tapped: list[int] = []

        for i, nid in enumerate(run):
            if str(nid) in (pdict or {}):
                return None
            node = nodes[nid]
            cn = node.cfg_name
            if cn in _LINEAR_KINDS:
                kind = _LINEAR_KINDS[cn]
                d = SECTION_DIMS[kind]
                if kind == "gain":
                    lvl = node.params["level"]
                    if not concrete(lvl):
                        return None
                    sec = ("gain", float(np.float32(lvl)))
                elif kind in ("lp", "hp"):
                    r = node.params["ratio"]
                    if not concrete(r):
                        return None
                    sec = (kind, float(r))
                else:
                    raw = [node.params[k]
                           for k in ("a0", "a1", "a2", "b0", "b1", "b2")]
                    if not all(concrete(v) for v in raw):
                        return None
                    # same f32 division as BiQuad (biquad.rs:64-71)
                    a0 = np.float32(raw[0])
                    sec = ("bq", tuple(float(np.float32(np.float32(v) / a0))
                                       for v in raw[1:]))
                if cur and cur_dim + d > MAX_RUN_DIM:
                    close()
                if cur:
                    cur.append(("gain", h))
                else:
                    if i:
                        pend *= h
                    if pend != 1.0:
                        cur.append(("gain", float(np.float32(pend))))
                        pend = 1.0
                cur.append(sec)
                if d:
                    cur_ids.append(nid)
                cur_dim += d
            else:
                close()
                if i:
                    pend *= h
                if cn == "reverb":
                    dec = node.params["decay"]
                    if not concrete(dec):
                        return None
                    flush_scale()
                    D = delay_samples(float(node.params["seconds"]))
                    stages.append(("comb", float(np.float32(dec)), int(D)))
                    specs.append(("comb", nid))
                elif cn == "chorus":
                    geo = _chorus_mega_geo(node)
                    if geo is None:
                        return None
                    L, NH, EV, RS = geo
                    flush_scale()
                    stages.append(("mtap",
                                   float(np.float32(node.params["mix"])),
                                   int(L), int(NH), int(EV), int(RS)))
                    specs.append(("mtap", nid,
                                  float(node.params["rate"]),
                                  float(node.params["depth"]),
                                  float(node.params["base"]), int(L)))
                elif cn == "overdrive":
                    ps = [node.params[k] for k in ("boost", "drive", "level")]
                    if not all(concrete(v) for v in ps):
                        return None
                    flush_scale()
                    stages.append(("ew", "overdrive",
                                   tuple(float(np.float32(v)) for v in ps)))
                elif cn == "chebyshev":
                    ps = [node.params[k]
                          for k in ("level_pos", "level_neg")]
                    if not all(concrete(v) for v in ps):
                        return None
                    flush_scale()
                    stages.append(("ew", "chebyshev",
                                   tuple(float(np.float32(v)) for v in ps)))
                else:                           # distort (planner-vetted)
                    lvl = node.params["level"]
                    if not concrete(lvl):
                        return None
                    flush_scale()
                    stages.append(("ew", f"distort:{node.params['mode']}",
                                   (float(np.float32(lvl)),)))
            if nid in tap_set:
                # the tap point is the node's OWN output: close the open
                # cascade (splitting the composite solve there) and flush
                # any folded scale before emitting
                close()
                flush_scale()
                stages.append(("tap", len(tapped)))
                tapped.append(nid)
        close()
        if out_fold is not None:
            pend *= h
        flush_scale()
        return (tuple(stages), tuple(specs), head_single, out_fold,
                tuple(tapped))

    def _active_mega(pdict) -> tuple[dict, set]:
        """(head node id -> (run, stages, specs, head_single, out_fold,
        tapped), non-head member ids) for the mega runs whose dynamic
        preconditions hold for THIS trace (same gates as
        _active_fusion)."""
        from dsp_stuff_tpu.utils import precision
        if (not mega_plan or NODE_HOOK is not None
                or precision.get_policy().name != "fast"):
            return {}, set()
        heads: dict[int, tuple] = {}
        interior: set = set()
        for run in mega_plan:
            got = _mega_stages(run, pdict)
            if got is None:
                continue
            heads[run[0]] = (run, *got)
            interior.update(run[1:])
        return heads, interior

    def _mega_run_eval(run, stages, specs, tapped, x1, st):
        """Evaluate a mega run over its head input ``x1`` [..., T] as one
        ops/chain_segment, updating the member states in ``st``; returns
        {(nid, "out"): signal} for the tail and every tapped
        intermediate (("tap", ti) stages, index order == ``tapped``)."""
        from dsp_stuff_tpu.ops import cascade
        from dsp_stuff_tpu.ops.chain_segment import chain_segment
        from dsp_stuff_tpu.ops.modfx import mtap_shared
        T_run = x1.shape[-1]
        state_in = []
        for sp in specs:
            if sp[0] == "cascade":
                _, secs, ids = sp
                state_in.append(cascade.cascade_state_in(
                    secs, [st[str(n)] for n in ids]))
            elif sp[0] == "mtap":
                _, nid_m, rate, depth, base, L = sp
                nst = st[str(nid_m)]
                # shared trajectory operands (stream-independent: the
                # chorus clock t0 is lockstep state, so these stay
                # unbatched under vmap — chain_segment's shared slots)
                q, r, fr = mtap_shared(rate, depth, base, L, T_run,
                                       nst["t0"])
                state_in += [nst["hist"], q, r, fr]
            else:
                nst = st[str(sp[1])]
                # canonicalize the reverb ring oldest-first (pos from a
                # prior block-path render may be nonzero)
                state_in.append(jnp.roll(nst["ring"], -nst["pos"], axis=-1))
        y, cinfos, hists, tap_sigs = chain_segment(x1, stages,
                                                   tuple(state_in))
        ci = hi = 0
        for sp in specs:
            if sp[0] == "cascade":
                _, secs, ids = sp
                s_tm1, s_tm2, x_tm1, x_tm2 = cinfos[ci]
                ci += 1
                outs = cascade.cascade_state_out(secs, s_tm1, s_tm2,
                                                 x_tm1, x_tm2)
                for n, ns in zip(ids, outs):
                    st[str(n)] = ns
            elif sp[0] == "mtap":
                nid_m = sp[1]
                st[str(nid_m)] = {
                    "hist": hists[hi],
                    "t0": jnp.asarray(st[str(nid_m)]["t0"],
                                      jnp.int32) + T_run}
                hi += 1
            else:
                st[str(sp[1])] = {"ring": hists[hi], "pos": jnp.int32(0)}
                hi += 1
        out = {(run[-1], "out"): y}
        for n, sig in zip(tapped, tap_sigs):
            out[(n, "out")] = sig
        return out

    _CYCLE_EW = ("distort", "overdrive", "chebyshev")

    def _cycle_program(comp, pdict):
        """Lower a feedback SCC to the ops/cycle_segment block program,
        or None when any member (or this trace) cannot.

        Members evaluate in ascending-id order exactly like the cycle
        scan; every member output read by another member flows through a
        REGISTER (read-before-write gives back edges the previous
        block's value — the reference's one-block feedback latency),
        every output read outside the SCC is TAPPED as a full sequence.
        Contiguous-in-order linear members connected by sole links fold
        into one cascade stage (MAX_RUN_DIM splits), interleaving the
        link fan-in scales as gain sections — the same composition as
        the in-cycle fused runs this path supersedes.  Fan-in divides
        become multiplies by the f32 reciprocal (fast-only, documented
        1-ulp class).  Returns (program, ext_keys, reg_ports, tap_ports,
        state_specs) with state_specs in PROGRAM order:
        ("cascade", sections, stateful_ids) | ("comb", nid)."""
        from dsp_stuff_tpu.ops.cascade import SECTION_DIMS, MAX_RUN_DIM
        from dsp_stuff_tpu.ops.delay_line import delay_samples
        if block_size != 128:
            return None        # the block program's frame is 128
        order = sorted(comp)
        comp_set = set(order)

        def concrete(v):
            return isinstance(v, (int, float, np.floating))

        ports_of = {}
        for nid in order:
            node = nodes[nid]
            cn = node.cfg_name
            if str(nid) in (pdict or {}):
                return None
            if cn in ("add", "mix"):
                ports_of[nid] = ("a", "b")
            elif (cn in _LINEAR_KINDS or cn == "reverb"
                  or cn in _CYCLE_EW):
                if cn in ("distort", "overdrive") and str(
                        node.params.get("oversample", "1")) != "1":
                    return None
                ports_of[nid] = ("in",)
            else:
                return None
            if cn == "mix" and not concrete(node.params["ratio"]):
                return None

        in_links: dict[tuple[int, str], list] = {}
        out_links: dict[int, list] = {}
        for l in graph.links:
            if l.dst in comp_set:
                if l.dst_port not in ports_of[l.dst]:
                    return None        # modulated member: scan path
                in_links.setdefault((l.dst, l.dst_port), []).append(l)
            if l.src in comp_set:
                out_links.setdefault(l.src, []).append(l)

        # linear grouping: member i absorbs the NEXT member in order when
        # both are linear, the link between them is i's only out-link and
        # the next's only source, and the composite dim fits the cap
        def sections_of(nid):
            node = nodes[nid]
            kind = _LINEAR_KINDS[node.cfg_name]
            if kind == "gain":
                lvl = node.params["level"]
                return None if not concrete(lvl) else \
                    ("gain", float(np.float32(lvl))), 0, ()
            if kind in ("lp", "hp"):
                r = node.params["ratio"]
                return None if not concrete(r) else \
                    (kind, float(r)), 1, (nid,)
            raw = [node.params[k]
                   for k in ("a0", "a1", "a2", "b0", "b1", "b2")]
            if not all(concrete(v) for v in raw):
                return None
            a0 = np.float32(raw[0])
            return ("bq", tuple(float(np.float32(np.float32(v) / a0))
                                for v in raw[1:])), 2, (nid,)

        h1 = 1.0 / float(_fanin_divisor(1))
        units = []            # (members, port_terms builder deferred)
        i = 0
        while i < len(order):
            nid = order[i]
            members = [nid]
            if nodes[nid].cfg_name in _LINEAR_KINDS:
                dim = SECTION_DIMS[_LINEAR_KINDS[nodes[nid].cfg_name]]
                j = i
                while j + 1 < len(order):
                    nxt = order[j + 1]
                    ls = out_links.get(order[j], [])
                    if (nodes[nxt].cfg_name in _LINEAR_KINDS
                            and len(ls) == 1 and ls[0].dst == nxt
                            and ls[0].dst_port == "in"
                            and len(in_links.get((nxt, "in"), [])) == 1):
                        d2 = SECTION_DIMS[_LINEAR_KINDS[nodes[nxt].cfg_name]]
                        if dim + d2 > MAX_RUN_DIM:
                            break
                        members.append(nxt)
                        dim += d2
                        j += 1
                    else:
                        break
                i = j + 1
            else:
                i += 1
            units.append(members)

        # registers for unit-tail ports read by members; taps for ports
        # read outside
        reg_of: dict[tuple[int, str], int] = {}
        tap_of: dict[tuple[int, str], int] = {}
        reg_ports: list = []
        tap_ports: list = []
        for members in units:
            tail = members[-1]
            for port in nodes[tail].spec.outputs:
                kp = (tail, port)
                ls = [l for l in out_links.get(tail, [])
                      if l.src_port == port]
                if any(l.dst in comp_set for l in ls):
                    reg_of[kp] = len(reg_ports)
                    reg_ports.append(kp)
                if any(l.dst not in comp_set for l in ls):
                    tap_of[kp] = len(tap_ports)
                    tap_ports.append(kp)

        ext_keys: list = []
        ext_of: dict = {}

        def term_for(l):
            key = (l.src, l.src_port)
            if l.src in comp_set:
                if key not in reg_of:
                    return None        # non-tail member port (grouped
                                       # interior read) — planner bug
                                       # guard; cannot happen by const.
                return ("reg", reg_of[key])
            if key not in ext_of:
                ext_of[key] = len(ext_keys)
                ext_keys.append(key)
            return ("ext", ext_of[key])

        def port_join(nid, port):
            ls = in_links.get((nid, port), [])
            terms = []
            for l in ls:
                t = term_for(l)
                if t is None:
                    return None
                terms.append(t)
            return tuple(terms), 1.0 / float(_fanin_divisor(len(ls)))

        program: list = []
        specs: list = []
        for members in units:
            head = members[0]
            node = nodes[head]
            cn = node.cfg_name
            if cn in ("add", "mix"):
                ja = port_join(head, "a")
                jb = port_join(head, "b")
                if ja is None or jb is None:
                    return None
                if cn == "add":
                    cA = cB = 1.0
                else:
                    r = np.float32(node.params["ratio"])
                    cA, cB = float(np.float32(1.0) - r), float(r)
                program.append(("lin2", ja[0], ja[1], jb[0], jb[1],
                                cA, cB))
            else:
                j = port_join(head, "in")
                if j is None:
                    return None
                program.append(("join", j[0], j[1]))
                if cn == "reverb":
                    dec = node.params["decay"]
                    sec = node.params["seconds"]
                    if not (concrete(dec) and concrete(sec)):
                        return None
                    D = delay_samples(float(sec))
                    program.append(("comb", float(np.float32(dec)),
                                    int(D), sum(1 for s in specs
                                                if s[0] == "comb")))
                    specs.append(("comb", head))
                elif cn in _CYCLE_EW:
                    if cn == "overdrive":
                        ps = [node.params[k]
                              for k in ("boost", "drive", "level")]
                        kind = "overdrive"
                    elif cn == "chebyshev":
                        ps = [node.params[k]
                              for k in ("level_pos", "level_neg")]
                        kind = "chebyshev"
                    else:
                        ps = [node.params["level"]]
                        kind = f"distort:{node.params['mode']}"
                    if not all(concrete(v) for v in ps):
                        return None
                    program.append(("ew", kind,
                                    tuple(float(np.float32(v))
                                          for v in ps)))
                else:                  # linear unit (1..k members)
                    secs = []
                    ids = []
                    dim = 0
                    for m_i, m in enumerate(members):
                        got = sections_of(m)
                        if got is None:
                            return None
                        sec, d, sids = got
                        if m_i:
                            secs.append(("gain", h1))
                        secs.append(sec)
                        ids.extend(sids)
                        dim += d
                    if dim == 0:
                        for _, v in secs:
                            program.append(("scale", float(v)))
                    else:
                        program.append(("cascade", tuple(secs),
                                        sum(1 for s in specs
                                            if s[0] == "cascade")))
                        specs.append(("cascade", tuple(secs),
                                      tuple(ids)))
            tail = members[-1]
            for port in nodes[tail].spec.outputs:
                kp = (tail, port)
                if kp in reg_of:
                    program.append(("setreg", reg_of[kp]))
                if kp in tap_of:
                    program.append(("tap", tap_of[kp]))
        if not ext_keys:
            return None        # self-oscillator: length unknown to the op
        return (tuple(program), tuple(ext_keys), tuple(reg_ports),
                tuple(tap_ports), tuple(specs))

    def _active_fusion(pdict) -> tuple[dict, set]:
        """(head node id -> (run, sections, emits, tapped), non-head
        member ids) for the runs whose dynamic preconditions hold for
        THIS trace: fast policy, no observability hook (debug_render
        needs every node's own output), concrete params, no traced fit
        overrides.  ``emits`` are section indices for
        ops/cascade.linear_cascade; ``tapped`` the matching node ids."""
        from dsp_stuff_tpu.utils import precision
        if (not fusion_plan or NODE_HOOK is not None
                or precision.get_policy().name != "fast"):
            return {}, set()
        heads: dict[int, tuple] = {}
        interior: set = set()
        for run in fusion_plan:
            got = _run_sections(run, pdict)
            if got is None:
                continue
            secs, member_end = got
            tapped = _run_taps(run)
            emits = tuple(member_end[n] for n in tapped)
            heads[run[0]] = (run, secs, emits, tapped)
            interior.update(run[1:])
        return heads, interior

    def _fused_run_eval(run, secs, emits, tapped, x1, st):
        """Evaluate a fused linear run over its head input ``x1`` (any
        T >= 2), updating the per-node states in ``st`` (keys str(nid));
        returns {(nid, "out"): signal} for the tail and every tapped
        intermediate."""
        from dsp_stuff_tpu.ops import cascade
        stateful = [n for n in run
                    if cascade.SECTION_DIMS[
                        _LINEAR_KINDS[nodes[n].cfg_name]] > 0]
        s_in = cascade.cascade_state_in(secs, [st[str(n)] for n in stateful])
        res = cascade.linear_cascade(x1, secs, s_in, emits)
        if emits:
            y, s_tm1, s_tm2, emit_sigs = res
        else:
            y, s_tm1, s_tm2 = res
            emit_sigs = ()
        st_outs = cascade.cascade_state_out(secs, s_tm1, s_tm2,
                                            x1[..., -1], x1[..., -2])
        for n, st_new in zip(stateful, st_outs):
            st[str(n)] = st_new
        out = {(run[-1], "out"): y}
        for n, sig in zip(tapped, emit_sigs):
            out[(n, "out")] = sig
        return out

    def _eval(state, ext, T: int, pdict=None):
        state = dict(state)
        values: dict[tuple[int, str], Any] = {}
        fused_heads, fused_interior = _active_fusion(pdict)
        mega_heads, mega_interior = _active_mega(pdict)
        # Output-node ids whose fan-in scale a mega run already applied
        # (its published tail value IS the output signal)
        mega_out_folds: dict[int, tuple[int, str]] = {}

        def port_sources(nid, port, lookup):
            return [lookup(l.src, l.src_port)
                    for l in graph.in_links(nid, port)]

        def seq_lookup(src, src_port):
            return values[(src, src_port)]

        for comp in sccs:
            is_cycle = len(comp) > 1 or any(
                l.src == l.dst == comp[0] for l in graph.links)
            if not is_cycle:
                nid = comp[0]
                if nid in mega_interior or nid in fused_interior:
                    continue                  # evaluated at the run head
                if nid in mega_heads:
                    run, stages, specs, head_single, out_fold, tapped = \
                        mega_heads[nid]
                    srcs = port_sources(run[0], "in", seq_lookup)
                    if head_single:
                        x1 = srcs[0]   # fan-in scale folded into stages
                    else:
                        x1, _ = _avg(srcs, T)
                    values.update(_mega_run_eval(run, stages, specs,
                                                 tapped, x1, state))
                    if out_fold is not None:
                        mega_out_folds[out_fold] = (run[-1], "out")
                    continue
                if nid in fused_heads:
                    run, secs, emits, tapped = fused_heads[nid]
                    x1, _ = _avg(port_sources(run[0], "in", seq_lookup), T)
                    values.update(_fused_run_eval(run, secs, emits, tapped,
                                                  x1, state))
                    continue
                node = nodes[nid]
                impl = node.spec.impl
                in_sigs = {}
                for port in node.spec.all_inputs:
                    srcs = port_sources(nid, port, seq_lookup)
                    in_sigs[port] = _avg(srcs, T)
                if getattr(impl, "graph_input", False):
                    inputs = {EXTERNAL: ext[str(nid)]}
                else:
                    inputs = {p: in_sigs[p][0] for p in node.spec.inputs}
                params = _resolve_params(node, in_sigs, T, pdict)
                outs, new_st = _call(impl, params, state[str(nid)], inputs,
                                     T, block_size)
                if NODE_HOOK is not None:
                    NODE_HOOK(nid, node.cfg_name, outs)
                state[str(nid)] = new_st
                for port in node.spec.outputs:
                    values[(nid, port)] = outs[port]
            else:
                _eval_cycle(comp, state, values, ext, T, pdict,
                            fused_heads, fused_interior)

        # graph outputs: fan-in average into each Output node (output.rs:215-250)
        outs = {}
        for nid in output_ids:
            if nid in mega_out_folds:
                outs[nid] = values[mega_out_folds[nid]]
                continue
            node = nodes[nid]
            sig, _ = _avg(port_sources(nid, "in", seq_lookup), T)
            outs[nid] = sig

        # modulation knob writeback (reference quirk SURVEY.md 2.4 #9):
        # every block, the derive-generated {field}_input() stores the first
        # sample of the mapped modulation buffer back into the slider atomic
        # (lib.rs:140-148), so after a render the knob sits at the mapped
        # value of the LAST block's first sample (global index T - block).
        # Emitted under aux["__knobs__"]; apply_knob_writeback() folds it
        # back into the Graph before saving, mirroring save-after-run.
        knobs = {}
        for nid, node in nodes.items():
            for p in node.spec.params:
                if isinstance(p, ParamSpec) and p.as_input:
                    srcs = port_sources(nid, p.name, seq_lookup)
                    if srcs:
                        sig, _ = _avg(srcs, T)
                        knobs[f"{nid}:{p.name}"] = _map_mod(
                            sig[..., T - block_size], p)

        # analysis sinks
        aux = {}
        if knobs:
            aux["__knobs__"] = knobs
        for nid in sink_ids:
            node = nodes[nid]
            impl = node.spec.impl
            if not hasattr(impl, "analyze"):
                continue
            in_sigs = {port: _avg(port_sources(nid, port, seq_lookup), T)
                       for port in node.spec.all_inputs}
            inputs = {p: in_sigs[p][0] for p in node.spec.inputs}
            params = _resolve_params(node, in_sigs, T, pdict)
            aux[f"{node.cfg_name}:{nid}"] = impl.analyze(params, inputs)

        return state, outs, aux

    def _eval_cycle(comp, state, values, ext, T: int, pdict=None,
                    fused_heads=None, fused_interior=None):
        """Compile one feedback SCC to a lax.scan over blocks.

        Member nodes execute in ascending-id order within a block; an
        intra-cycle edge from a not-yet-run member carries the previous
        block's value (one BLOCK of delay), which is the defined semantic
        for the reference's emergent feedback latency.

        Linear runs CONTIGUOUS in that order (see _plan_linear_fusion)
        evaluate as one ops/cascade solve per block at the head's
        position — the config5 lesson: the cycle scan's per-iteration
        cost is dominated by op count, and an unfused k-node run pays k
        solver rounds per 128 block.  Non-head members are skipped;
        tapped intermediates publish their emitted block into ``cur``
        (so later members and the carry see the current block, exactly
        as unfused), while untapped interiors' carried prev entries pass
        through untouched (dead — no edge can read them — but the carry
        structure must stay policy-independent)."""
        fused_heads = fused_heads or {}
        fused_interior = fused_interior or set()
        B = block_size
        assert T % B == 0
        nb = T // B

        # cycle mega path: when every member lowers to the block program
        # (and the dynamic gates hold), the whole SCC evaluates as ONE
        # ops/cycle_segment, an unrolled scan over blocks, instead of
        # the per-node scan below
        from dsp_stuff_tpu.utils import precision as _prec
        if (CYCLE_FUSION and NODE_HOOK is None
                and _prec.get_policy().name == "fast"):
            planned = _cycle_program(comp, pdict)
            if planned is not None:
                program, ext_keys, reg_ports, tap_ports, cspecs = planned
                from dsp_stuff_tpu.ops import cascade as _casc
                from dsp_stuff_tpu.ops.cycle_segment import cycle_segment
                ckey = _cycle_key(comp)
                exts = tuple(values[k] for k in ext_keys)
                regs0 = tuple(state[ckey][f"{kp[0]}:{kp[1]}"]
                              for kp in reg_ports)
                st_in = []
                for sp in cspecs:
                    if sp[0] == "cascade":
                        st_in.append(_casc.cascade_state_in(
                            sp[1], [state[str(n)] for n in sp[2]]))
                    else:
                        nst = state[str(sp[1])]
                        st_in.append(jnp.roll(nst["ring"], -nst["pos"],
                                              axis=-1))
                taps, regs_f, cinfos, hists = cycle_segment(
                    exts, regs0, tuple(st_in), program, len(tap_ports))
                ci = hi = 0
                for sp in cspecs:
                    if sp[0] == "cascade":
                        s1, s2, x1, x2 = cinfos[ci]
                        ci += 1
                        for n, ns in zip(sp[2], _casc.cascade_state_out(
                                sp[1], s1, s2, x1, x2)):
                            state[str(n)] = ns
                    else:
                        state[str(sp[1])] = {"ring": hists[hi],
                                             "pos": jnp.int32(0)}
                        hi += 1
                newprev = dict(state[ckey])
                reg_set = set(reg_ports)
                for kp, r in zip(reg_ports, regs_f):
                    newprev[f"{kp[0]}:{kp[1]}"] = r
                for kp, tseq in zip(tap_ports, taps):
                    values[kp] = tseq
                    if kp not in reg_set:
                        newprev[f"{kp[0]}:{kp[1]}"] = tseq[..., -B:]
                state[ckey] = newprev
                return

        order = sorted(comp)
        pos = {nid: i for i, nid in enumerate(order)}

        # external sequences feeding this SCC, chopped into blocks
        ext_feeds: dict[tuple[int, str], Any] = {}
        for nid in order:
            node = nodes[nid]
            for port in node.spec.all_inputs:
                for l in graph.in_links(nid, port):
                    if l.src not in pos:
                        key = (l.src, l.src_port)
                        if key not in ext_feeds:
                            seq = values[key]
                            ext_feeds[key] = jnp.moveaxis(
                                seq.reshape(*seq.shape[:-1], nb, B), -2, 0)
        ext_ins = {}
        for nid in order:
            if getattr(nodes[nid].spec.impl, "graph_input", False):
                seq = ext[str(nid)]
                ext_ins[str(nid)] = jnp.moveaxis(
                    seq.reshape(*seq.shape[:-1], nb, B), -2, 0)

        member_ports = [(nid, port) for nid in order
                        for port in nodes[nid].spec.outputs]
        comp_set = set(order)

        def _needs_sequence(nid, port):
            for l in graph.links:
                if l.src != nid or l.src_port != port:
                    continue
                if l.dst not in comp_set:
                    return True          # consumed outside the cycle
                # intra-cycle modulation links: the knob-writeback pass
                # (aux __knobs__) reads the full source sequence
                dst_spec = nodes[l.dst].spec
                if l.dst_port in dst_spec.mod_inputs:
                    return True
            return False

        # only ports whose full sequence is needed get stacked by the scan;
        # internal-only audio ports would otherwise each write a
        # [T/B, ..., B] tensor per render
        emit_ports = [(nid, port) for (nid, port) in member_ports
                      if _needs_sequence(nid, port)]

        def body(carry, xs):
            st, prev = carry
            ext_blk, ext_in_blk = xs
            st = dict(st)
            cur: dict[tuple[int, str], Any] = {}

            def blk_lookup(src, src_port):
                if src in pos:
                    key = (src, src_port)
                    return cur[key] if key in cur else prev[key]
                return ext_blk[(src, src_port)]

            for nid in order:
                if nid in fused_interior:
                    continue                  # evaluated at the run head
                if nid in fused_heads:
                    run, secs, emits, tapped = fused_heads[nid]
                    x1, _ = _avg([blk_lookup(l.src, l.src_port)
                                  for l in graph.in_links(run[0], "in")], B)
                    cur.update(_fused_run_eval(run, secs, emits, tapped,
                                               x1, st))
                    continue
                node = nodes[nid]
                impl = node.spec.impl
                in_sigs = {}
                for port in node.spec.all_inputs:
                    srcs = [blk_lookup(l.src, l.src_port)
                            for l in graph.in_links(nid, port)]
                    in_sigs[port] = _avg(srcs, B)
                if getattr(impl, "graph_input", False):
                    inputs = {EXTERNAL: ext_in_blk[str(nid)]}
                else:
                    inputs = {p: in_sigs[p][0] for p in node.spec.inputs}
                params = _resolve_params(node, in_sigs, B, pdict)
                outs, new_st = _call_block(impl, params, st[str(nid)], inputs,
                                           block_size)
                if NODE_HOOK is not None:
                    NODE_HOOK(nid, node.cfg_name, outs)
                st[str(nid)] = new_st
                for port in node.spec.outputs:
                    cur[(nid, port)] = outs[port]

            # skipped UNTAPPED members (the head included -- its own
            # output only materializes when tapped): dead carry entries
            # (no edge can read them -- a reader would have made them
            # tapped) pass through so the carry pytree structure stays
            # identical to the unfused trace
            for kp in member_ports:
                if kp not in cur and (kp[0] in fused_interior
                                      or kp[0] in fused_heads):
                    cur[kp] = prev[kp]

            return (st, cur), {kp: cur[kp] for kp in emit_ports}

        st0 = {str(nid): state[str(nid)] for nid in order}
        ckey = _cycle_key(comp)
        prev0 = {kp: state[ckey][f"{kp[0]}:{kp[1]}"] for kp in member_ports}
        # unrolling amortizes the XLA while-loop per-iteration overhead,
        # which dominates a feedback path of many short blocks; larger
        # unrolls cost compile time roughly in proportion
        (st_f, prev_f), ys = jax.lax.scan(body, (st0, prev0),
                                          (ext_feeds, ext_ins),
                                          length=nb,
                                          unroll=min(cycle_unroll, nb))
        for nid in order:
            state[str(nid)] = st_f[str(nid)]
        state[ckey] = {f"{kp[0]}:{kp[1]}": prev_f[kp] for kp in member_ports}
        for kp in emit_ports:
            blocks = ys[kp]                     # [nb, B]
            values[kp] = jnp.moveaxis(blocks, 0, -2).reshape(
                *blocks.shape[1:-1], nb * B)

    return CompiledGraph(
        graph=graph, block_size=block_size,
        input_ids=input_ids, output_ids=output_ids, sink_ids=sink_ids,
        fn=fn, _init_state=init_state, _init_params=init_params)
