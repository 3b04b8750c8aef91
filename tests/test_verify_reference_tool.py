"""Self-test for tools/verify_reference.py against a synthetic stub.

The reference-day script cannot run its stages 2-5 while the reference
mount is empty, so it needs a self-test.  These tests fake a populated reference directory —
landmark files with the SURVEY symbols plus runnable
teHmmTrain/teHmmEval stubs whose outputs derive from the repo's own
goldens — so every stage (inventory, cites, run, diff) is exercised
end-to-end, and a planted BED mismatch is proven to FAIL the diff stage.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.filterwarnings("ignore")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "verify_reference.py")
DATA = os.path.join(REPO, "tests", "data")
GOLD = os.path.join(DATA, "golden")

# every (file, symbol) pair verify_reference greps for (its LANDMARKS),
# plus the KEY_FILES it inventories
_STUB_SOURCES = {
    "basehmm.py": (
        "# stub of the vendored sklearn hmm base\n"
        "def _do_forward_pass(obs):\n"
        "    pass  # logsumexp over states\n"
    ),
    "emission.py": (
        "class IndependentMultinomialEmissionModel:\n    pass\n\n"
        "class PairEmissionModel:\n    pass\n"
    ),
    "hmm.py": "class MultitrackHmm:\n    pass\n",
    "cfg.py": "class MultitrackCfg:\n    pass\n",
    "track.py": "class TrackList:\n    pass\n",
    "trackIO.py": "def readTrackData(path):\n    pass\n",
    "common.py": "EPSILON = 1e-9\n",
}


def _write_stub_reference(ref_dir, bed_source: str) -> None:
    """A fake teHmm checkout: landmark modules + runnable train/eval
    CLIs.  The eval stub 'decodes' by copying ``bed_source`` to --bed,
    standing in for a reference whose Viterbi output is that file."""
    os.makedirs(ref_dir, exist_ok=True)
    for name, body in _STUB_SOURCES.items():
        with open(os.path.join(ref_dir, name), "w") as f:
            f.write(body)
    with open(os.path.join(ref_dir, "teHmmTrain.py"), "w") as f:
        f.write(
            "import sys\n"
            "# options: --supervised --segLen (stub)\n"
            "def main(argv):\n"
            "    out = argv[2]\n"
            "    open(out, 'wb').write(b'stub-model')\n"
            "if __name__ == '__main__':\n"
            "    main(sys.argv[1:])\n"
        )
    with open(os.path.join(ref_dir, "teHmmEval.py"), "w") as f:
        f.write(
            "import shutil, sys\n"
            "def main(argv):\n"
            "    bed = argv[argv.index('--bed') + 1]\n"
            f"    shutil.copy({bed_source!r}, bed)\n"
            "if __name__ == '__main__':\n"
            "    main(sys.argv[1:])\n"
        )


def _run_tool(ref_dir, out_dir):
    return subprocess.run(
        [sys.executable, TOOL, "--reference", str(ref_dir),
         "--out", str(out_dir)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "TEHMM_PLATFORM": "cpu",
             "TEHMM_COMPILE_CACHE": "0"},
    )


def test_empty_mount_fails_stage_one(tmp_path):
    ref = tmp_path / "empty_ref"
    ref.mkdir()
    r = _run_tool(ref, tmp_path / "out")
    assert r.returncode == 1
    assert "EMPTY" in r.stdout


def test_all_stages_pass_on_matching_stub(tmp_path):
    ref = tmp_path / "ref"
    _write_stub_reference(str(ref), os.path.join(GOLD, "viterbi.bed"))
    r = _run_tool(ref, tmp_path / "out")
    assert "ALL PASS" in r.stdout, r.stdout + r.stderr
    assert r.returncode == 0
    # every stage actually ran
    for needle in ("inventory basehmm.py", "cite", "run teHmmTrain",
                   "run teHmmEval", "diff reference vs golden BED",
                   "diff reference vs tehmm_tpu BED"):
        assert needle in r.stdout, needle


def test_planted_mismatch_fails_diff_stage(tmp_path):
    # perturb one state name in the reference's 'output'
    bad_bed = tmp_path / "bad_viterbi.bed"
    lines = open(os.path.join(GOLD, "viterbi.bed")).read().splitlines()
    cols = lines[0].split("\t")
    cols[3] = cols[3] + "_X"
    lines[0] = "\t".join(cols)
    bad_bed.write_text("\n".join(lines) + "\n")

    ref = tmp_path / "ref"
    _write_stub_reference(str(ref), str(bad_bed))
    r = _run_tool(ref, tmp_path / "out")
    assert r.returncode == 1
    assert "MISMATCH" in r.stdout
    assert "FAILURES" in r.stdout
