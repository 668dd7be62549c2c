"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to
run without a GPU.  On the card the same functions run at full size."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_chain_tiny():
    r = cs.phase_chain(B=2, seconds=0.1, check_seconds=0.1)
    assert r["dbfs_vs_oracle"] <= cs.FAST_DB


def test_phase_parity_tiny():
    assert cs.phase_parity(seconds=0.1)["dbfs_vs_oracle"] <= cs.PARITY_DB


@pytest.mark.parametrize("name", ["config5", "config2", "config3"])
def test_phase_config_tiny(name):
    r = cs.phase_config(name, B=2, seconds=0.1, check_seconds=0.1)
    assert r["dbfs_vs_oracle"] <= cs.FAST_DB


def test_phase_config4_tiny():
    r = cs.phase_config4(B=2, seconds=0.1, check_seconds=0.1,
                         ir_seconds=0.02)
    assert r["parity_dbfs_vs_oracle"] <= cs.PARITY_DB


def test_phase_live_tiny():
    r = cs.phase_live(seconds=0.05)
    assert r["db_blocks_vs_render"] <= cs.LIVE_DB


def test_phase_fit_tiny():
    r = cs.phase_fit(B=2, seconds=0.05, steps=3)
    assert r["loss_last"] < r["loss_first"]


def test_phase_exact_tiny():
    assert cs.phase_exact(seconds=0.05)["bitwise"]


def test_phases_sharded_tiny():
    """The --four phases on the CPU's virtual devices."""
    cs.phase_render_sharded(n_dev=4, B=8, seconds=0.05)
    cs.phase_fit_sharded(n_dev=4, B=8, seconds=0.05)


def test_phase_check_raises():
    with pytest.raises(cs.PhaseFailed):
        cs._check("x", "dBFS", -70.0, cs.FAST_DB)
    cs._check("x", "dBFS", -95.0, cs.FAST_DB)


def test_main_refuses_without_gpu(capsys):
    from conftest import on_gpu
    if on_gpu():
        pytest.skip("main runs every phase when a GPU is present")
    assert cs.main([]) != 0
    assert cs.main(["--four"]) != 0
    assert capsys.readouterr().out == ""


def test_script_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    fails and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
