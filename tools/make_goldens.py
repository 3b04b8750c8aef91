"""Generate the bundled fixture dataset and float64-oracle golden outputs.

SURVEY.md §4 "Parity harness implication": the contract is outputs — the
same Viterbi BED and tolerance-equal trained tables.  The reference mount
is empty (SURVEY.md provenance), so the goldens are produced by this
repo's float64 NumPy oracle (tehmm_tpu/oracle.py — written in the
reference's O(L·S²) loop style, validated against brute-force
enumeration).  When the reference becomes available, re-run it on
tests/data and diff against these files; tests/test_golden.py asserts the
production device pipeline reproduces them (BED bit-exact, parameters to
f32 tolerance).

Run from the repo root:  python tools/make_goldens.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tehmm_tpu import oracle  # noqa: E402
from tehmm_tpu.io import write_bed_intervals  # noqa: E402
from tehmm_tpu.utils.common import EPSILON  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "tests", "data")
GOLD = os.path.join(DATA, "golden")


def make_fixtures():
    rng = np.random.RandomState(1234)
    L = 2400
    # truth: 3 states BG / LINE / SINE
    truth = np.zeros(L, int)
    blocks = [(250, 420, 1), (700, 820, 2), (1100, 1350, 1),
              (1600, 1700, 2), (1950, 2200, 1)]
    for s, e, st in blocks:
        truth[s:e] = st

    # track a: TE-family calls (categorical, noisy)
    names = ["BG", "LINE", "SINE"]
    rows_a = []
    pos = 0
    while pos < L:
        end = min(pos + rng.randint(15, 45), L)
        st = np.bincount(truth[pos:end], minlength=3).argmax()
        if rng.rand() < 0.85:
            val = ["none", "L1", "Alu"][st]
        else:
            val = ["none", "L1", "Alu"][rng.randint(3)]
        rows_a.append(("chr1", pos, end, val))
        pos = end
    write_bed_intervals(rows_a, os.path.join(DATA, "trackA.bed"))

    # track b: binary coverage correlated with any TE
    rows_b = [
        ("chr1", i, min(i + 10, L), "cov")
        for i in range(0, L, 10)
        if truth[i] > 0 and rng.rand() < 0.75
    ]
    write_bed_intervals(rows_b, os.path.join(DATA, "trackB.bed"))

    # track c: genome sequence with GC skew inside TEs
    seq = []
    for i in range(L):
        if truth[i] > 0:
            seq.append(rng.choice(list("GCGCAT")))
        else:
            seq.append(rng.choice(list("ATATGC")))
    with open(os.path.join(DATA, "genome.fa"), "w") as fh:
        fh.write(">chr1\n")
        s = "".join(seq)
        for i in range(0, L, 60):
            fh.write(s[i : i + 60] + "\n")

    xml = (
        '<teModelConfig>\n'
        '  <track name="family" path="trackA.bed"/>\n'
        '  <track name="cov" path="trackB.bed" distribution="binary"/>\n'
        '  <track name="seq" path="genome.fa"/>\n'
        '</teModelConfig>\n'
    )
    with open(os.path.join(DATA, "tracks.xml"), "w") as fh:
        fh.write(xml)

    truth_rows = []
    start = 0
    for i in range(1, L + 1):
        if i == L or truth[i] != truth[i - 1]:
            truth_rows.append(("chr1", start, i, names[truth[start]]))
            start = i
    write_bed_intervals(truth_rows, os.path.join(DATA, "truth.bed"))
    write_bed_intervals([("chr1", 0, L)], os.path.join(DATA, "regions.bed"))
    return L, names


def load_symbols(L):
    """Load tests/data tracks with the production loader (host-side,
    deterministic) — symbol construction is shared; the DP math is what
    the oracle replaces."""
    from tehmm_tpu.io import TrackList, load_track_data

    tl = TrackList(os.path.join(DATA, "tracks.xml"))
    # paths in the xml are relative to tests/data
    for t in tl:
        t.path = os.path.join(DATA, os.path.basename(t.path))
    td = load_track_data(tl, [("chr1", 0, L)])
    return td


def main():
    os.makedirs(GOLD, exist_ok=True)
    L, state_names = make_fixtures()
    td = load_symbols(L)
    (tab,) = td.tables
    symbols = tab.symbols.astype(np.int64)
    sizes = td.alphabet_sizes
    V = max(sizes)
    T = symbols.shape[1]
    S = len(state_names)

    # ---- supervised training, oracle-style (float64 counting) ----
    from tehmm_tpu.io import read_bed_intervals

    labeled = read_bed_intervals(os.path.join(DATA, "truth.bed"), ncol=4)
    name_to_idx = {n: i for i, n in enumerate(state_names)}
    states = np.full(L, -1, np.int64)
    for c, s, e, n in labeled:
        states[s:e] = name_to_idx[str(n)]
    assert (states >= 0).all()

    start_c = np.zeros(S)
    trans_c = np.zeros((S, S))
    em_c = np.zeros((S, T, V))
    start_c[states[0]] += 1
    np.add.at(trans_c, (states[:-1], states[1:]), 1)
    for t in range(T):
        np.add.at(em_c, (states, t, symbols[:, t]), 1)

    def norm_rows(c):
        sm = c + EPSILON
        return sm / sm.sum(-1, keepdims=True)

    log_start = np.log(norm_rows(start_c[None])[0])
    log_trans = np.log(norm_rows(trans_c))
    # emissions: normalize over real symbols only, missing col = 0
    log_em = np.zeros((S, T, V))
    for t in range(T):
        n_real = sizes[t] - 1
        sm = em_c[:, t, 1 : sizes[t]] + EPSILON
        probs = sm / sm.sum(-1, keepdims=True)
        log_em[:, t, 1 : sizes[t]] = np.log(probs)

    np.savez(
        os.path.join(GOLD, "supervised_params.npz"),
        log_start=log_start, log_trans=log_trans, log_em=log_em,
    )

    # ---- oracle decode (float64) ----
    obs = oracle.obs_log_likelihoods(log_em, symbols)
    path, score = oracle.viterbi(log_start, log_trans, obs)
    _, loglik = oracle.forward(log_start, log_trans, obs)

    rows = []
    run_start = 0
    for i in range(1, L + 1):
        if i == L or path[i] != path[run_start]:
            rows.append(
                ("chr1", run_start, i, state_names[path[run_start]])
            )
            run_start = i
    write_bed_intervals(rows, os.path.join(GOLD, "viterbi.bed"))

    with open(os.path.join(GOLD, "metrics.json"), "w") as fh:
        json.dump({
            "viterbi_score": float(score),
            "loglik": float(loglik),
            "alphabet_sizes": [int(x) for x in sizes],
            "state_names": state_names,
        }, fh, indent=1)
    print(f"goldens written to {GOLD}")


if __name__ == "__main__":
    main()
