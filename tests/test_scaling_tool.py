"""The scaling-efficiency harness runs end-to-end on the virtual mesh.

BASELINE.json's ≥80%-at-2-hosts north star needs a measurement path;
tools/bench_scaling.py is that path.  This
test keeps it runnable: a tiny weak+strong sweep over 1..2 of the
virtual CPU devices must emit records with sane fields and a baseline
efficiency of exactly 1.0.
"""

import importlib.util
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "bench_scaling", os.path.join(REPO, "tools", "bench_scaling.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sweep_runs_and_reports_efficiency(tmp_path, capsys):
    tool = _load_tool()
    out = tmp_path / "scaling.jsonl"
    tool.main([
        "--devices", "2", "--batchPerDevice", "2", "--length", "16",
        "--numStates", "4", "--numTracks", "2", "--alphabetSize", "4",
        "--reps", "2", "--jsonl", str(out),
    ])
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    # weak + strong, em + decode, n in {1, 2} = 8 records
    assert len(recs) == 8
    for r in recs:
        assert r["seconds_per_iter"] > 0
        assert r["positions_per_sec"] > 0
        if r["devices"] == 1:
            assert r["efficiency_vs_1dev"] == 1.0
        assert r["batch"] % r["devices"] == 0
    # human-readable summary printed
    assert "eff" in capsys.readouterr().out
