"""tehmm-benchmark: end-to-end experiment harness
(reference: teHmmBenchmark.py; SURVEY.md §2b, §3.3 — for each
configuration: train -> eval -> (fit state names) -> compare vs truth,
aggregated into an accuracy table).

Configs are supplied as repeated --config "name:FLAGS" entries, e.g.

  python -m tehmm_tpu.cli.benchmark tracks.xml truth.bed regions.bed out/ \
      --config "sup:--supervised" \
      --config "em2:--numStates 2 --iter 30" \
      --config "em4:--numStates 4 --iter 30 --reps 2"

Each config's model, prediction BED, renamed BED, and accuracy JSON land
in out/<name>.*; a summary table is printed and saved to out/summary.json.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import time

from tehmm_tpu.cli import compare_bed_states as cbs
from tehmm_tpu.cli import eval as cli_eval
from tehmm_tpu.cli import fit_state_names as fsn
from tehmm_tpu.cli import train as cli_train
from tehmm_tpu.utils.common import add_logging_options, logger, \
    set_logging_from_options


def run_config(
    name: str,
    flags: list[str],
    tracks_xml: str,
    truth_bed: str,
    regions_bed: str,
    out_dir: str,
    slack: int = 0,
) -> dict:
    model_path = os.path.join(out_dir, f"{name}.mod.npz")
    pred_bed = os.path.join(out_dir, f"{name}.pred.bed")
    fit_bed = os.path.join(out_dir, f"{name}.fit.bed")

    t0 = time.time()
    rc = cli_train.main(
        [tracks_xml, truth_bed, model_path] + flags
    )
    train_s = time.time() - t0
    if rc:
        return {"name": name, "error": f"train rc={rc}"}

    t0 = time.time()
    rc = cli_eval.main(
        [tracks_xml, model_path, regions_bed, "--bed", pred_bed]
    )
    eval_s = time.time() - t0
    if rc:
        return {"name": name, "error": f"eval rc={rc}"}

    supervised = "--supervised" in flags
    scored_bed = pred_bed
    if not supervised:
        # anonymous states: greedily rename against truth first
        fsn.main([truth_bed, pred_bed, fit_bed])
        scored_bed = fit_bed

    res = cbs.compare_bed_files(truth_bed, scored_bed, slack=slack)
    return {
        "name": name,
        "flags": " ".join(flags),
        "train_seconds": round(train_s, 2),
        "eval_seconds": round(eval_s, 2),
        "base_accuracy": res["base_accuracy"],
        "base": res["base"],
        "interval": res["interval"],
    }


def worker_platform() -> str | None:
    """Platform that --numProcesses workers must force, or None.

    Spawned workers re-initialize JAX from scratch.  A parent that runs
    on the CPU (TEHMM_PLATFORM=cpu, or tests forcing the platform
    through jax.config) would otherwise hand its workers the GPU, so
    the parent's explicit choice is propagated and re-applied in each
    worker.  None leaves the worker at its default platform.
    """
    plat = os.environ.get("TEHMM_PLATFORM")
    if plat:
        return plat
    if "jax" in sys.modules:
        import jax

        return jax.config.jax_platforms or None
    return None


def make_worker_pool(num_workers: int):
    """Process pool for --numProcesses (here and in track_ranking).
    Spawned workers each start a fresh JAX; on a GPU host worker k sees
    only card k (utils/gpu.pool_pinning), since a second JAX process on
    a card fails for want of memory — more workers than cards is
    refused."""
    import concurrent.futures as cf
    import multiprocessing as mp

    from tehmm_tpu.utils.gpu import pool_pinning

    ctx = mp.get_context("spawn")
    return cf.ProcessPoolExecutor(
        max_workers=num_workers, mp_context=ctx,
        **pool_pinning(ctx, num_workers, worker_platform()),
    )


def run_config_on(platform: str | None, *args) -> dict:
    """run_config, forcing the JAX platform first (worker-side entry for
    the --numProcesses process pools here and in track_ranking)."""
    if platform:
        import jax

        jax.config.update("jax_platforms", platform)
    return run_config(*args)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tehmm-benchmark",
        description="train -> eval -> compare sweep over configurations",
    )
    p.add_argument("tracksInfo")
    p.add_argument("truthBed", help="labeled truth BED (training + scoring)")
    p.add_argument("regionsBed", help="regions to decode")
    p.add_argument("outDir")
    p.add_argument("--config", action="append", required=True,
                   help='"name:train flags", repeatable')
    p.add_argument("--slack", type=int, default=0)
    p.add_argument("--numProcesses", type=int, default=1,
                   help="run configs concurrently in worker processes "
                        "(reference: teHmmBenchmark parallel configs "
                        "[R?]).  On a GPU host each worker gets a card "
                        "of its own, so at most one worker per visible "
                        "card; use TEHMM_PLATFORM=cpu for parallel CPU "
                        "sweeps")
    add_logging_options(p)
    return p


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    set_logging_from_options(opts)
    os.makedirs(opts.outDir, exist_ok=True)
    jobs = []
    seen = set()
    for spec in opts.config:
        name, _, flag_str = spec.partition(":")
        if name in seen:
            # duplicates silently collide: both write out/<name>.* and
            # the results table reports one config's numbers twice
            raise SystemExit(f"duplicate --config name {name!r}")
        seen.add(name)
        jobs.append((name, shlex.split(flag_str)))

    if opts.numProcesses > 1:
        import concurrent.futures as cf

        plat = worker_platform()
        by_name = {}
        with make_worker_pool(opts.numProcesses) as ex:
            futs = {
                ex.submit(
                    run_config_on, plat, name, flags, opts.tracksInfo,
                    opts.truthBed, opts.regionsBed, opts.outDir,
                    opts.slack,
                ): name
                for name, flags in jobs
            }
            for fut in cf.as_completed(futs):
                name = futs[fut]
                try:
                    by_name[name] = fut.result()
                except Exception as e:  # noqa: BLE001 — per-config
                    by_name[name] = {"name": name, "error": str(e)}
                logger.info("benchmark config %s done", name)
        results = [by_name[name] for name, _ in jobs]
    else:
        results = []
        for name, flags in jobs:
            logger.info("benchmark config %s: %s", name, flags)
            try:
                results.append(run_config(
                    name, flags, opts.tracksInfo, opts.truthBed,
                    opts.regionsBed, opts.outDir, opts.slack,
                ))
            except Exception as e:  # noqa: BLE001 — per-config, like
                # the parallel path: one failing config must not
                # discard every completed result
                results.append({"name": name, "error": str(e)})

    with open(os.path.join(opts.outDir, "summary.json"), "w") as fh:
        json.dump(results, fh, indent=1)

    print(f"{'config':12s} {'base-acc':>9s} {'train-s':>8s} {'eval-s':>7s}")
    for r in results:
        if "error" in r:
            print(f"{r['name']:12s} ERROR: {r['error']}")
        else:
            print(
                f"{r['name']:12s} {r['base_accuracy']:9.4f} "
                f"{r['train_seconds']:8.2f} {r['eval_seconds']:7.2f}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
