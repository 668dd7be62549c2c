"""bench.py must keep its contract: one JSON line, roofline math sane.

bench.py runs on an NVIDIA GPU; these CPU tests only guard the pure
helpers so a refactor cannot silently break the reported fields.
"""

import numpy as np
import pytest


def test_pct_roofline_math(monkeypatch):
    import bench
    monkeypatch.setattr(bench, "HBM_GBPS",
                        bench.PEAKS["NVIDIA H100 80GB HBM3"]["hbm_gbps"])
    # 1000x realtime on a mono in/out config moves 2*48000*4 B per
    # audio-second -> 384 MB/s of I/O floor
    pct = bench._pct_roofline(1000.0, 1, 1)
    want = 100.0 * 1000.0 * 2 * 48_000 * 4 / (bench.HBM_GBPS * 1e9)
    assert abs(pct - round(want, 2)) < 1e-9
    assert bench._pct_roofline(None, 1, 1) is None
    # scaling: stereo out costs 1.5x the mono-out floor
    assert bench._pct_roofline(1000.0, 1, 2) > bench._pct_roofline(
        1000.0, 1, 1)


def test_oracle_chain_matches_graph_parity():
    """The chain's oracle (tests/oracle.chain10) agrees with a parity
    render of the bench's chain on a short signal (the full-length check
    runs on the GPU)."""
    import bench
    import oracle
    import dsp_stuff_tpu as dst
    from dsp_stuff_tpu.utils import precision
    g, inp_id = bench.build_chain()
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(128 * 30) * 0.25).astype(np.float32)
    with precision.policy("parity"):
        cg = dst.compile_graph(g)
        outs, _, _ = cg.render({str(inp_id): x})
    got = np.asarray(outs)[0]
    want = oracle.chain10(x)
    err = np.max(np.abs(got.astype(np.float64) - want.astype(np.float64)))
    dbfs = 20 * np.log10(err) if err > 0 else -np.inf
    assert dbfs <= -90.0, dbfs


def test_max_throughput_metric_runs(monkeypatch):
    """The batch-aggregate section must keep returning audio-seconds per
    wall-second across ALL streams (B * seconds * n_chain / wall)."""
    import bench
    monkeypatch.setenv("DST_BENCH_MAXBATCH", "2")
    monkeypatch.setattr(bench, "SR", 4800)   # 10x shorter render
    monkeypatch.setattr(bench, "N_TIMED", 1)
    r, gbps = bench._max_throughput_metric(np.random.default_rng(0))
    assert r > 0.0
    assert gbps is None or gbps > 0.0


def test_device_peaks_refuses_cpu_and_unknown_kind():
    """The peak table is keyed by device kind; a CPU device or a kind the
    table lacks is an error, never a default."""
    import jax
    import bench

    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    class UnknownGpu(FakeGpu):
        device_kind = "Some Other GPU"

    assert bench.device_peaks(FakeGpu())["hbm_gbps"] == 3350.0
    with pytest.raises(KeyError):
        bench.device_peaks(UnknownGpu())
    with pytest.raises(RuntimeError):
        bench.device_peaks(jax.devices("cpu")[0])


def test_gbps_and_bytes_helpers():
    import bench
    assert bench._gbps(None, 1.0) is None
    assert bench._gbps(2e9, 0.0) is None
    assert bench._gbps(2e9, 2.0) == 1.0

    class FakeCompiled:
        def cost_analysis(self):
            return {"bytes accessed": 123.0}

    class FakeCompiledList:
        def cost_analysis(self):
            return [{"bytes accessed": 7.0}]

    class Broken:
        def cost_analysis(self):
            raise NotImplementedError

    assert bench._bytes_accessed(FakeCompiled()) == 123.0
    assert bench._bytes_accessed(FakeCompiledList()) == 7.0
    assert bench._bytes_accessed(Broken()) is None
