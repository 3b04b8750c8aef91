"""Planted-state synthetic genomes written as real input files.

Builds an on-disk dataset from a seed — a FASTA, BED tracks, BigWig
tracks and the tracks XML that names them — over one chromosome whose
positions follow a planted 3-state path (sticky runs of geometric
length).  Every track is informative about the planted state, so a
trained model's decode can be scored against the truth
(``greedy_state_map``).  Used by tools/demo_genome_real.py and
chip_smoke.py; everything is loaded back through the production readers.
"""

from __future__ import annotations

import os

import numpy as np

TRUE_S = 3
GC = np.array([0.25, 0.5, 0.75])          # per-true-state GC content
BED_KEEP = 0.85                           # interval dropout (noise)
FAMILY_NAMES = ["LINE", "SINE", "LTR", "DNA"]


def planted_path(rng, n, run_len):
    """Sticky-run hidden path: geometric run lengths, uniform states.
    Returns (states, starts, lens) of the runs."""
    n_runs = int(n / run_len * 2) + 16
    lens = rng.geometric(1.0 / run_len, size=n_runs).astype(np.int64)
    states = rng.randint(0, TRUE_S, size=n_runs).astype(np.int8)
    ends = np.cumsum(lens)
    k = int(np.searchsorted(ends, n)) + 1
    lens, states, ends = lens[:k], states[:k], ends[:k]
    lens[-1] -= ends[-1] - n
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return states, starts, lens


def write_fasta(path, rng, state_per_pos, chrom="chr1"):
    """GC content tracks the planted state."""
    n = len(state_per_pos)
    u = rng.random_sample(n)
    gc = u < GC[state_per_pos]
    second = rng.randint(0, 2, size=n, dtype=np.uint8)
    # AT pair: A/T ; GC pair: G/C
    codes = np.where(gc, np.where(second == 0, ord("G"), ord("C")),
                     np.where(second == 0, ord("A"), ord("T"))
                     ).astype(np.uint8)
    width = 80
    pad = (-n) % width
    arr = np.concatenate([codes, np.full(pad, ord("N"), np.uint8)])
    arr = arr.reshape(-1, width)
    with_nl = np.concatenate(
        [arr, np.full((arr.shape[0], 1), ord("\n"), np.uint8)], axis=1
    )
    body = with_nl.tobytes()
    if pad:
        # drop the padding Ns from the final line
        body = body[: -(pad + 1)] + b"\n"
    with open(path, "wb") as fh:
        fh.write(f">{chrom}\n".encode())
        fh.write(body)


def write_bed_track(path, rng, states, starts, lens, target, names,
                    chrom="chr1"):
    """Intervals over planted runs of ``target`` state (with dropout);
    name column cycles over ``names`` (multinomial via BED name)."""
    sel = (states == target) & (rng.random_sample(len(states)) < BED_KEEP)
    idx = np.nonzero(sel)[0]
    with open(path, "w") as fh:
        for i, j in enumerate(idx):
            s, e = int(starts[j]), int(starts[j] + lens[j])
            fh.write(f"{chrom}\t{s}\t{e}\t{names[i % len(names)]}\n")


def write_bigwig_track(path, rng, n, states, starts, lens, chrom="chr1"):
    """Piecewise-constant signal: value = state + U[0,1) per planted
    run (floor-binned by scale=1.0 in the XML back to ~the state)."""
    from tehmm_tpu.io.bigwig_writer import write_bigwig

    vals = states.astype(np.float64) + rng.random_sample(len(states))
    entries = [
        (chrom, int(s), int(s + l), float(v))
        for s, l, v in zip(starts, lens, vals)
    ]
    write_bigwig(path, {chrom: n}, entries)


def build_dataset(work, n_positions, n_tracks=15, seed=0, run_len=500,
                  chrom="chr1"):
    """Write the dataset into ``work`` and return (tracks XML path,
    planted state per position int8[n_positions]).

    ``n_tracks`` counts the FASTA; the rest split between BED tracks
    (multinomial and binary, alternating) and BigWig tracks."""
    os.makedirs(work, exist_ok=True)
    rng = np.random.RandomState(seed)
    states, starts, lens = planted_path(rng, n_positions, run_len)
    state_per_pos = np.repeat(states, lens)
    write_fasta(os.path.join(work, "genome.fa"), rng, state_per_pos, chrom)
    n_rest = n_tracks - 1
    n_bed = n_rest // 2
    rows = ['  <track name="seq" path="genome.fa"/>']
    for k in range(n_bed):
        name = f"bed{k}"
        write_bed_track(
            os.path.join(work, f"{name}.bed"), rng, states, starts, lens,
            target=k % TRUE_S, names=FAMILY_NAMES, chrom=chrom,
        )
        dist = "binary" if k % 2 else "multinomial"
        rows.append(f'  <track name="{name}" path="{name}.bed" '
                    f'distribution="{dist}"/>')
    for k in range(n_rest - n_bed):
        name = f"sig{k}"
        write_bigwig_track(
            os.path.join(work, f"{name}.bw"),
            np.random.RandomState(seed + 100 + k),
            n_positions, states, starts, lens, chrom,
        )
        rows.append(f'  <track name="{name}" path="{name}.bw" '
                    f'distribution="multinomial" scale="1.0"/>')
    xml_path = os.path.join(work, "tracks.xml")
    with open(xml_path, "w") as fh:
        fh.write("<teModelConfig>\n" + "\n".join(rows)
                 + "\n</teModelConfig>\n")
    return xml_path, state_per_pos


def greedy_state_map(paths, truth, num_states):
    """Map each learned state to its majority planted state
    (bincount: np.add.at is ~6x slower at genome scale)."""
    conf = np.zeros(num_states * TRUE_S, np.int64)
    for p, t in zip(paths, truth):
        flat = p.astype(np.int64) * TRUE_S + t
        conf += np.bincount(flat, minlength=num_states * TRUE_S)
    return conf.reshape(num_states, TRUE_S).argmax(axis=1)
