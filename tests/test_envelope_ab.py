"""tools/envelope_ab.py, the measurement that keeps the Triton envelope:
its CPU rehearsal runs end to end, and without --tiny it refuses to run
off a GPU."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ab(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "envelope_ab", os.path.join(ROOT, "tools", "envelope_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # keep the test process's compile-cache setting as it is
    from dsp_stuff_tpu.utils import compile_cache
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)
    return mod


def test_envelope_ab_tiny_rehearsal(ab, capsys, tmp_path):
    assert ab.main(["--tiny", "--reps", "1",
                    "--trace-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for path in ("xla", "triton"):
        assert f"config5 B=4 T=144000 {path}: median_ms=" in out
        assert f"envelope op B=4 T=144000 {path}: median_ms=" in out
    assert "config5 triton vs xla max_abs_diff=0" in out
    assert "trace" in out


def test_envelope_ab_refuses_without_gpu(ab, capsys):
    from conftest import on_gpu
    if on_gpu():
        pytest.skip("the full-size A/B runs when a GPU is present")
    assert ab.main([]) == 1
    assert capsys.readouterr().out == ""
