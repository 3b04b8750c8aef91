"""End-to-end genome-scale run through the REAL I/O path.

Builds an on-disk dataset (tehmm_tpu/synth.py: FASTA + BED + BigWig
fixtures referenced by a tracks XML), loads it through the
production readers (native C++ BED paint / threaded BigWig decode /
FASTA LUT), trains unsupervised EM on the loaded tables — through the
host-streamed pass loop when the batch exceeds the device staging
budget — decodes with the stitched Viterbi pipeline, writes the BED,
and prints one wall-clock row per stage (reference analogue:
teHmmBenchmark.py end-to-end runs, SURVEY.md §2b).

    python tools/demo_genome_real.py --positions 20_000_000 --tracks 15
    python tools/demo_genome_real.py --positions 250_000_000 --tracks 15 \
        --iters 3 --states 40   # BASELINE.json config #4's shape

A 3-true-state structure is planted (sticky runs, mean --runLen); the
final stage greedily maps learned states to planted ones and reports
base accuracy, so the run also demonstrates the model LEARNS from the
real files, not just that the plumbing moves bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from tehmm_tpu.synth import (  # noqa: E402
    build_dataset, greedy_state_map, planted_path, TRUE_S,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--positions", type=int, default=20_000_000)
    ap.add_argument("--tracks", type=int, default=15,
                    help="total tracks incl. the FASTA (rest split "
                         "between BED and BigWig)")
    ap.add_argument("--states", type=int, default=20)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--runLen", type=int, default=500)
    ap.add_argument("--maxDeviceBytes", type=int, default=None,
                    help="device staging budget override (forces the "
                         "host-streamed fit loop when exceeded)")
    ap.add_argument("--compareStreaming", action="store_true",
                    help="after the main train, re-train with a tiny "
                         "device budget to force the host-streamed "
                         "pass loop and report both EM rates")
    ap.add_argument("--workdir", default=None,
                    help="fixture directory (default: temp, deleted "
                         "unless --keep)")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--reuse", action="store_true",
                    help="reuse fixtures already in --workdir (skips "
                         "generation; still rebuilds the planted truth "
                         "in memory for the accuracy check)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from tehmm_tpu.utils.platform import setup_jax

    setup_jax()
    import jax

    from tehmm_tpu.io import TrackList, load_track_data
    from tehmm_tpu.io.bed import write_bed_intervals
    from tehmm_tpu.models.hmm import MultitrackHmm

    N, S = args.positions, args.states
    work = args.workdir or tempfile.mkdtemp(prefix="tehmm_genome_")
    os.makedirs(work, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    stages = {}
    print(f"device: {jax.devices()[0]}", flush=True)
    print(f"workload: {N/1e6:.0f}M positions x {args.tracks} tracks, "
          f"S={S}, workdir={work}", flush=True)

    # ---- [fixtures] planted truth + on-disk dataset -------------------
    t0 = time.perf_counter()
    xml_path = os.path.join(work, "tracks.xml")
    if args.reuse and os.path.exists(xml_path):
        # fixture files already on disk (the planted truth is
        # deterministic in --seed, so the accuracy check still holds)
        states, _starts, lens = planted_path(rng, N, args.runLen)
        state_per_pos = np.repeat(states, lens)
        stages["fixtures"] = time.perf_counter() - t0
        print(f"[fixtures] {stages['fixtures']:7.1f}s  reused {work}",
              flush=True)
    else:
        xml_path, state_per_pos = build_dataset(
            work, N, args.tracks, args.seed, args.runLen
        )
        disk = sum(
            os.path.getsize(os.path.join(work, f))
            for f in os.listdir(work)
        )
        stages["fixtures"] = time.perf_counter() - t0
        print(f"[fixtures] {stages['fixtures']:7.1f}s  "
              f"{disk/1e6:.0f}MB on disk", flush=True)
    assert len(state_per_pos) == N

    # ---- [load] the real track readers --------------------------------
    t0 = time.perf_counter()
    tl = TrackList(xml_path)
    td = load_track_data(tl, [("chr1", 0, N)])
    stages["load"] = time.perf_counter() - t0
    nbytes = sum(t.symbols.nbytes for t in td.tables)
    print(f"[load]     {stages['load']:7.1f}s  "
          f"{N * args.tracks / stages['load'] / 1e6:.1f}M track-"
          f"positions/s -> {nbytes/1e6:.0f}MB symbols", flush=True)

    # ---- [train] unsupervised EM (host-streamed when oversized) -------
    t0 = time.perf_counter()
    model = MultitrackHmm.initialized(S, td, init="random",
                                      seed=args.seed)
    res = model.fit(
        td.tables, max_iterations=args.iters, convergence_tol=0.0,
        chunk_len=args.chunk, max_device_bytes=args.maxDeviceBytes,
    )
    stages["train"] = time.perf_counter() - t0
    print(f"[train]    {stages['train']:7.1f}s  {res.iterations} EM "
          f"iters ({res.iterations * N / stages['train'] / 1e6:.1f}M "
          f"pos/s); loglik {res.logliks[0]/1e6:.3f} -> "
          f"{res.logliks[-1]/1e6:.3f} (x1e6)", flush=True)

    if args.compareStreaming:
        # A/B/A protocol: a single ordered pair is confounded by warm
        # compiles (a streamed run once "won" 4.1x purely by going
        # second).  All three trains here run AFTER the main train, so
        # compiles are warm for every arm; the resident rate is the
        # mean of the two A arms bracketing the streamed B arm.
        nbytes = sum(t.symbols.nbytes for t in td.tables)

        def _arm(budget):
            t0 = time.perf_counter()
            m2 = MultitrackHmm.initialized(S, td, init="random",
                                           seed=args.seed)
            res2 = m2.fit(
                td.tables, max_iterations=args.iters,
                convergence_tol=0.0, chunk_len=args.chunk,
                max_device_bytes=budget,
                retain_staging=False,   # main model's cache is enough
            )
            return res2, time.perf_counter() - t0

        # force streaming with a REALISTIC block size: half the input
        # (budget=1 would cap blocks at 1 row — fit bounds blocks to
        # budget/2 for double buffering)
        res_a1, dt_a1 = _arm(None)
        res_b, dt_b = _arm(nbytes // 2)
        res_a2, dt_a2 = _arm(None)
        stages["train_resident_A1"] = dt_a1
        stages["train_streamed_B"] = dt_b
        stages["train_resident_A2"] = dt_a2
        # f32 stat-summation reorder across different block sizes:
        # |loglik| is ~1e8-1e9 at genome scale, so allow a few e-5 rel
        for r in (res_a1, res_b, res_a2):
            np.testing.assert_allclose(
                r.logliks, res.logliks, rtol=5e-5
            )
        it = res_b.iterations
        rate_b = it * N / dt_b
        rate_a = it * N / ((dt_a1 + dt_a2) / 2)
        print(f"[stream]   A/B/A warm trains: resident {dt_a1:.1f}s / "
              f"streamed {dt_b:.1f}s / resident {dt_a2:.1f}s -> "
              f"streamed {rate_b/1e6:.1f}M pos/s = "
              f"{rate_b / rate_a:.2f}x the bracketed resident rate "
              f"({rate_a/1e6:.1f}M pos/s); logliks equal", flush=True)

    # ---- [decode] stitched Viterbi + BED write ------------------------
    t0 = time.perf_counter()
    paths, _report = model.decode_tables(td.tables, chunk_len=4096,
                                         halo=256)
    stages["decode"] = time.perf_counter() - t0
    print(f"[decode]   {stages['decode']:7.1f}s  "
          f"{N / stages['decode'] / 1e6:.1f}M pos/s incl. path "
          f"download", flush=True)

    t0 = time.perf_counter()
    mapping = greedy_state_map([paths[0]], [state_per_pos], S)
    acc = float((mapping[paths[0]] == state_per_pos).mean())
    from tehmm_tpu.models.hmm import path_to_intervals

    intervals = path_to_intervals(
        "chr1", 0, paths[0], model.state_names
    )
    out_bed = os.path.join(work, "annotations.bed")
    write_bed_intervals(intervals, out_bed)
    stages["write"] = time.perf_counter() - t0
    print(f"[write]    {stages['write']:7.1f}s  {len(intervals)} "
          f"intervals -> {out_bed}", flush=True)
    print(f"base accuracy vs planted truth (greedy {S}->{TRUE_S} "
          f"mapping): {acc:.4f}", flush=True)

    # the optional --compareStreaming A/B/A re-trains are a side
    # experiment, not part of the fixtures->load->train->decode->write
    # pipeline — exclude every arm from the end-to-end total
    _side = {"train_resident_A1", "train_streamed_B",
             "train_resident_A2"}
    total = sum(v for k, v in stages.items() if k not in _side)
    print(json.dumps({
        "metric": "genome_scale_end_to_end",
        "positions": N, "tracks": args.tracks, "states": S,
        "stages_s": {k: round(v, 2) for k, v in stages.items()},
        "total_s": round(total, 2),
        "em_positions_per_sec": round(
            res.iterations * N / stages["train"], 1
        ),
        "accuracy_vs_planted": round(acc, 4),
    }), flush=True)
    if not args.keep and args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
