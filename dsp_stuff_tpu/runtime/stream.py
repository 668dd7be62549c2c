"""Streaming block session: the live-rack operating mode.

The reference processes audio as an endless stream of 128-sample blocks
pulled through per-node tasks (node.rs:267-352).  The analog here keeps ONE
compiled block-step function and carries the state pytree across calls:

    sess = StreamSession(graph)            # compiles once
    out = sess.process(in_block)           # [block] in -> [n_out, block] out

Device I/O (the cpal analog) is modeled by host-side ring buffers
(native/dsp_host.cpp SPSC rings when built, a NumPy deque otherwise) with
the reference's failure semantics: write overrun drops the excess
(devices.rs:239-241), read underrun zero-fills (devices.rs:436-440), and
``resync()`` drains every ring (runtime.rs:524-526, 587-594).

Practical note: every block costs one dispatch, so large blocks or
``process_many`` amortize it; ``block_size`` may be any multiple of
128 — semantics that depend on the 128 frame (Fuzz block-max,
signal_gen phase wrap) are evaluated on the 128 grid inside the step
regardless.
"""

from __future__ import annotations

import jax
import numpy as np

from dsp_stuff_tpu.compiler.compile import compile_graph
from dsp_stuff_tpu.graph import Graph


def _freeze_params(p):
    """Hashable snapshot of a params pytree (dicts / scalars / arrays),
    used to key the chunk-fn cache on params CONTENT."""
    if p is None:
        return None
    if isinstance(p, dict):
        return tuple(sorted((str(k), _freeze_params(v)) for k, v in p.items()))
    if isinstance(p, (list, tuple)):
        return tuple(_freeze_params(v) for v in p)
    if isinstance(p, np.ndarray) or (hasattr(p, "shape") and hasattr(p, "dtype")
                                     and not np.isscalar(p)):
        # np.ndarray AND jax.Array alike: a non-scalar jnp param left as-is
        # would make the tuple-key comparison raise "truth value is
        # ambiguous" instead of retracing
        a = np.asarray(p)
        return (a.shape, a.dtype.str, a.tobytes())
    return p


class _PyRing:
    """NumPy fallback for native.Ring with identical semantics: an ndarray
    circular buffer (vectorized slice copies -- no per-sample Python, so
    CI-without-g++ streams at array speed)."""

    def __init__(self, capacity: int = 8192):
        self._cap = capacity
        self._buf = np.zeros(capacity, np.float32)
        self._head = 0          # read position
        self._size = 0

    def write(self, x) -> int:
        x = np.asarray(x, np.float32).ravel()
        k = min(x.size, self._cap - self._size)
        if k:
            start = (self._head + self._size) % self._cap
            end = start + k
            if end <= self._cap:
                self._buf[start:end] = x[:k]
            else:
                split = self._cap - start
                self._buf[start:] = x[:split]
                self._buf[:end - self._cap] = x[split:k]
            self._size += k
        return k

    def read(self, n: int) -> np.ndarray:
        k = min(n, self._size)
        out = np.empty(k, np.float32)
        end = self._head + k
        if end <= self._cap:
            out[:] = self._buf[self._head:end]
        else:
            split = self._cap - self._head
            out[:split] = self._buf[self._head:]
            out[split:] = self._buf[:end - self._cap]
        self._head = end % self._cap
        self._size -= k
        return out

    @property
    def readable(self) -> int:
        return self._size

    @property
    def writable(self) -> int:
        return self._cap - self._size

    def drain(self) -> None:
        self._head = 0
        self._size = 0


def make_ring(capacity: int = 8192):
    """Native SPSC ring when built, NumPy fallback otherwise.
    8192 is the reference's per-link capacity (runtime.rs:568)."""
    from dsp_stuff_tpu.io import native
    if native.available():
        return native.Ring(capacity)
    return _PyRing(capacity)


class StreamSession:
    """Carries compiled graph + state; processes fixed-size blocks."""

    def __init__(self, graph: Graph, block_size: int = 128,
                 ring_capacity: int = 8192, params=None):
        if block_size % 128:
            raise ValueError("block_size must be a multiple of 128 "
                             "(the reference frame, node.rs:257)")
        self.block_size = block_size
        self.cg = compile_graph(graph, block_size=128)
        self.state = self.cg.init_state()
        self.params = params
        self._fn = jax.jit(self.cg.fn)
        # host-side device rings: one per Input node (capture) and one per
        # Output node (playback)
        self.in_rings = {nid: make_ring(ring_capacity)
                         for nid in self.cg.input_ids}
        self.out_rings = {nid: make_ring(ring_capacity)
                          for nid in self.cg.output_ids}
        # per-output catch-up counter (the reference's per-device AtomicU8
        # resync counter, devices.rs:33,150-156)
        self._catchup = {nid: 0 for nid in self.cg.output_ids}
        # per-(output, device_rate) streaming resampler (the reference's
        # persistent Converter<CountingSignal, Sinc>, devices.rs:550-556)
        self._resamplers = {}

    # -- direct block API --------------------------------------------------

    def process(self, inputs=None):
        """Process one block.  inputs: {input_node_id: [block]} or
        [n_inputs, block] or None (silence).  Returns [n_out, block]."""
        B = self.block_size
        ext = {}
        if inputs is None:
            ext = {str(i): np.zeros(B, np.float32) for i in self.cg.input_ids}
        elif isinstance(inputs, dict):
            ext = {str(k): np.asarray(v, np.float32) for k, v in inputs.items()}
            for i in self.cg.input_ids:
                ext.setdefault(str(i), np.zeros(B, np.float32))
        else:
            arr = np.atleast_2d(np.asarray(inputs, np.float32))
            ext = {str(nid): arr[i]
                   for i, nid in enumerate(self.cg.input_ids)}
        if not ext:
            ext["__len__"] = np.zeros(B, np.float32)
        for v in ext.values():
            if v.shape[-1] != B:
                raise ValueError(f"block must be {B} samples, got {v.shape}")
        self.state, outs, _aux = self._fn(self.state, ext, self.params)
        out = np.stack([np.asarray(outs[i]) for i in self.cg.output_ids]) \
            if self.cg.output_ids else np.zeros((0, B), np.float32)
        return out

    def process_many(self, inputs=None, n_blocks: int | None = None):
        """Process k consecutive blocks in ONE dispatch.

        Pipelining k blocks through a ``lax.scan`` inside one jitted
        call pays one dispatch for all k while preserving block-exact
        semantics: the
        scan body IS the single-block step, state carried across
        iterations.  Under the fast policy XLA may contract a*y+b
        differently inside the scan body than in the straight-line block
        fn (fusion-context FMA), so vs k ``process()`` calls the samples
        agree to the 1-ulp class, bit-exactly under exact/parity fences.

        inputs: {input_node_id: [k*block]} / [n_inputs, k*block] / None
        (then ``n_blocks`` is required).  Returns [n_out, k*block].
        """
        B = self.block_size
        if inputs is None:
            if not n_blocks:
                raise ValueError("process_many() needs inputs or n_blocks")
            k = int(n_blocks)
            ext = {str(i): np.zeros((k, B), np.float32)
                   for i in self.cg.input_ids}
        elif isinstance(inputs, dict) and not inputs:
            if not n_blocks:
                raise ValueError("process_many({}) needs n_blocks: an empty "
                                 "dict carries no block count")
            k = int(n_blocks)
            ext = {str(i): np.zeros((k, B), np.float32)
                   for i in self.cg.input_ids}
        else:
            if isinstance(inputs, dict):
                ext = {str(kk): np.asarray(v, np.float32)
                       for kk, v in inputs.items()}
            else:
                arr = np.atleast_2d(np.asarray(inputs, np.float32))
                ext = {str(nid): arr[i]
                       for i, nid in enumerate(self.cg.input_ids)}
            T = next(iter(ext.values())).shape[-1]
            if T % B:
                raise ValueError(f"input length {T} is not a multiple of "
                                 f"block_size {B}")
            k = T // B
            if n_blocks is not None and int(n_blocks) != k:
                raise ValueError(f"n_blocks={n_blocks} but inputs carry "
                                 f"{k} blocks")
            ext = {kk: v.reshape(k, B) for kk, v in ext.items()}
            for i in self.cg.input_ids:
                ext.setdefault(str(i), np.zeros((k, B), np.float32))
        if not ext:
            ext = {"__len__": np.zeros((k, B), np.float32)}
        self.state, outs = self._chunk_fn(self.state, ext)
        out = (np.stack([np.asarray(outs[i]) for i in self.cg.output_ids])
               .reshape(len(self.cg.output_ids), k * B)
               if self.cg.output_ids else np.zeros((0, k * B), np.float32))
        return out

    @property
    def _chunk_fn(self):
        """jitted scan-over-blocks step.

        ``self.params`` is baked in at TRACE time (the recurrence ops build
        their Toeplitz/impulse-tap constants from concrete params in NumPy;
        a traced param would rebuild them inside every scan iteration --
        CLAUDE.md), so the cache is keyed on a params snapshot: changing
        ``self.params`` between calls triggers a retrace/recompile, after
        which the audio matches k ``process()`` calls under the same
        params.  The scan *length* k is static per input shape -- each
        distinct block count compiles once and is cached by shape.
        """
        key = _freeze_params(self.params)
        fn = getattr(self, "_chunk_fn_cached", None)
        if fn is None or getattr(self, "_chunk_fn_key", None) != key:
            step = self.cg.fn
            params = self.params
            out_ids = list(self.cg.output_ids)

            @jax.jit
            def run(state, ext_blocks):
                def body(st, ext):
                    st, outs, _aux = step(st, ext, params)
                    return st, {i: outs[i] for i in out_ids}
                return jax.lax.scan(body, state, ext_blocks)

            fn = self._chunk_fn_cached = run
            self._chunk_fn_key = key
        return fn

    # -- ring-buffered device-style API -------------------------------------

    def feed(self, node_id: int, samples) -> int:
        """Capture-side write (overrun drops, devices.rs:239-241)."""
        return self.in_rings[node_id].write(samples)

    def pump(self) -> bool:
        """Run one block if every input ring has a block buffered.
        Output blocks land in the output rings.  Returns True if a block
        was processed."""
        B = self.block_size
        if any(r.readable < B for r in self.in_rings.values()):
            return False
        ins = {nid: r.read(B) for nid, r in self.in_rings.items()}
        out = self.process({str(k): v for k, v in ins.items()})
        for i, nid in enumerate(self.cg.output_ids):
            self.out_rings[nid].write(out[i])
        return True

    def drain_output(self, node_id: int, n: int,
                     device_rate: int | None = None,
                     stereo: bool = False) -> np.ndarray:
        """Playback-side read with the reference's callback semantics
        (devices.rs:400-500):

        * underrun (fewer source samples buffered than the read needs) ->
          a full block of silence, the ring untouched (try_grant fails,
          devices.rs:436-440,495-499);
        * otherwise the catch-up counter saturating-decrements once per
          read, and if its PREVIOUS value was > 0 while the backlog is
          >= 2 blocks' worth of input, the backlog is skipped: the newest
          samples play and everything older is dropped
          (devices.rs:408-427,459-483) -- the graduated latency-recovery
          protocol behind "Sync output".

        ``device_rate`` (the composed output path, devices.rs:516-556):
        ``n`` counts DEVICE-rate samples; the read pulls the exact number
        of 48 kHz source samples the persistent sinc-16 resampler consumes
        (the reference releases source().index, devices.rs:434) and emits n
        resampled samples.  Chained reads are bit-identical to a one-shot
        ``resample_sinc16`` of the 8-sample-delayed source stream
        (io/playback.StreamingSinc16).  ``stereo`` duplicates the mono
        result into interleaved stereo [2n] (devices.rs:476-480).
        """
        out = self._drain_mono(node_id, n, device_rate)
        if stereo:
            from dsp_stuff_tpu.io.playback import dup_to_stereo
            out = dup_to_stereo(out)
        return out

    def _drain_mono(self, node_id: int, n: int,
                    device_rate: int | None) -> np.ndarray:
        ring = self.out_rings[node_id]
        if device_rate is None or device_rate == 48_000:
            if ring.readable < n:
                return np.zeros(n, np.float32)
            c = self._catchup[node_id]
            self._catchup[node_id] = c - 1 if c > 0 else 0  # saturating_sub
            backlog = ring.readable - n
            if c > 0 and backlog >= 2 * n:
                ring.read(backlog)      # skip ahead; ring drains fully
            return ring.read(n)

        from dsp_stuff_tpu.io.playback import StreamingSinc16
        key = (node_id, int(device_rate))
        rs = self._resamplers.get(key)
        if rs is None:
            rs = self._resamplers[key] = StreamingSinc16(int(device_rate))
        input_len = rs.input_needed(n)
        if ring.readable < input_len:
            return np.zeros(n, np.float32)      # underrun, nothing advances
        c = self._catchup[node_id]
        self._catchup[node_id] = c - 1 if c > 0 else 0
        backlog = ring.readable - input_len
        if c > 0 and backlog >= 2 * input_len:
            rs.skip(ring.read(backlog))         # drop oldest, keep history
        return rs.produce(ring.read(input_len), n)

    def resync(self) -> None:
        """The Sync-output action (runtime.rs:513-529): inter-node pipes
        drain (our in_rings -- the compiled graph itself holds no buffered
        audio, links are SSA) and every output device's catch-up counter
        gains 5 (TriggerResync, devices.rs:150-156; AtomicU8, so the add
        wraps at 256).  Output rings are NOT drained -- the playback reader
        skips their backlog gradually (see drain_output).  DSP state is
        kept, matching the reference (resync touches pipes, not node
        state)."""
        for r in self.in_rings.values():
            r.drain()
        for nid in self._catchup:
            self._catchup[nid] = (self._catchup[nid] + 5) & 0xFF

    def reset(self) -> None:
        """Fresh DSP state (the restart_node analog, runtime.rs:153)."""
        self.state = self.cg.init_state()
