"""Streaming block processing with ring-buffer device I/O.

The live-rack operating mode: feed capture samples in, pump compiled
blocks, drain playback samples out — with the reference's overrun/underrun
semantics (runtime/stream.py).
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import dsp_stuff_tpu as dst
from dsp_stuff_tpu.ids import IdSpace
from dsp_stuff_tpu.runtime.stream import StreamSession

g = dst.Graph(IdSpace())
inp = g.add("input")
od = g.add("overdrive", boost=6.0, drive=0.7, level=0.9)
rv = g.add("reverb", seconds=0.05, decay=0.4)
out = g.add("output")
g.chain(inp, od, rv, out)

sess = StreamSession(g, block_size=128)

# simulate a capture callback delivering irregular chunk sizes
rng = np.random.default_rng(0)
pos, total = 0, 48_000
sig = (np.sin(2 * np.pi * 220.0 * np.arange(total) / 48_000) * 0.5
       ).astype(np.float32)
played = []
while pos < total:
    n = int(rng.integers(64, 400))
    sess.feed(inp.id, sig[pos:pos + n])
    pos += n
    while sess.pump():
        pass
    played.append(sess.drain_output(out.id, 128))

y = np.concatenate(played)
print(f"streamed {pos} samples in, {y.size} out, "
      f"peak {np.abs(y).max():.3f}, rms {np.sqrt((y**2).mean()):.3f}")

# device-rate playback: drain the SAME session at 44.1 kHz interleaved
# stereo, like the reference's output callback (sinc-16 + dup-to-stereo,
# devices.rs:476-556).  Feed more signal, then pull device-sized chunks.
sess2 = StreamSession(g)
sess2.feed(inp.id, sig)
while sess2.pump():
    pass
device_chunks = []
for _ in range(10):
    device_chunks.append(
        sess2.drain_output(out.id, 441, device_rate=44_100, stereo=True))
dev = np.concatenate(device_chunks)
print(f"device-rate drain: {dev.size // 2} stereo frames @ 44.1 kHz, "
      f"peak {np.abs(dev).max():.3f}")

# pipelined mode: k blocks per dispatch
sess3 = StreamSession(g)
y3 = sess3.process_many({str(inp.id): sig[:128 * 300]})
print(f"process_many: {y3.shape[-1]} samples in one dispatch")
