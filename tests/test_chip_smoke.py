"""Rehearsal of chip_smoke.py without a card: the script (and bench.py)
refuses the CPU, and its phases run end to end on the CPU at a tiny size
when called directly."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_main_refuses_the_cpu(capsys):
    assert chip_smoke.main(["--positions", "1000"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """Outside the repository (the script and nothing else) it must
    fail and print no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "bench.py"], cwd=REPO,
                       capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode != 0
    assert '"metric"' not in r.stdout


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    data = chip_smoke.make_dataset(work, 40_000, region_len=15_000)
    return work, data, chip_smoke.phase_pipeline(work, data)


def test_pipeline_phase_on_cpu(pipeline):
    _work, data, res = pipeline
    assert len(res["logliks"]) == 3
    for mode in ("viterbi", "maxpost"):
        assert res[mode]["accuracy"] >= 0.95
        assert np.isfinite(res[mode]["loglik"])
        path = chip_smoke.bed_path(res[mode]["bed"], "chr1",
                                   data["positions"],
                                   [str(i) for i in range(40)])
        assert len(path) == data["positions"]


def test_oracle_phase_on_cpu(pipeline):
    work, _data, res = pipeline
    chip_smoke.phase_oracle(work, res["model"], res["xml"], slice_len=512)


def test_checks_reject_bad_output(tmp_path):
    with pytest.raises(chip_smoke.SmokeFailure, match="decreased"):
        chip_smoke.check_monotone([-10.0, -5.0, -7.0])
    with pytest.raises(chip_smoke.SmokeFailure, match="finite"):
        chip_smoke.check_monotone([-10.0, float("nan")])
    chip_smoke.check_monotone([-10.0, -5.0, -5.0 - 1e-5])   # f32 jitter
    bed = tmp_path / "gap.bed"
    bed.write_text("chr1\t0\t10\t0\nchr1\t12\t20\t1\n")
    with pytest.raises(chip_smoke.SmokeFailure, match="tile"):
        chip_smoke.bed_path(str(bed), "chr1", 20, ["0", "1"])


def test_cards_phase_on_virtual_devices(tmp_path):
    """The --cards phase on 4 of the virtual CPU devices: mesh train and
    eval agree with one device, and the multi-device dry run passes."""
    chip_smoke.phase_cards(str(tmp_path), 4, 40_000)
