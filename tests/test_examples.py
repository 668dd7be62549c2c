"""The example scripts run end-to-end (subprocess, CPU backend)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}


def _run(script, timeout=400):
    return subprocess.run([sys.executable, os.path.join(ROOT, script)],
                          capture_output=True, text=True, timeout=timeout,
                          env=ENV, cwd=ROOT)


@pytest.mark.parametrize("script", ["examples/streaming.py",
                                    "examples/render_batch.py"])
def test_example_scripts(script):
    r = _run(script)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip(), "example printed nothing"


def test_cli_render_example_graph(tmp_path):
    out = str(tmp_path / "c2.wav")
    r = subprocess.run(
        [sys.executable, "-m", "dsp_stuff_tpu", "render",
         "examples/graphs/config2.json", "--seconds", "0.25", "--out", out],
        capture_output=True, text=True, timeout=400, env=ENV, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)
