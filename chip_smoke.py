"""Smoke test of tehmm on an NVIDIA GPU: the user's train -> eval path at a
real width, checked against the float64 oracle and the XLA reference.

    python chip_smoke.py                 # one card
    python chip_smoke.py --cards 4       # only the four-card mesh phase

Phases (one process, each printed on its own lines; any failure exits
non-zero):

* device   — the card is a GPU (no CPU fallback); prints the card's name
             and power limit from ``nvidia-smi``, JAX's version, the
             compile-cache directory and the device memory limit.
* kernels  — compiles every GPU kernel of the decode/train path
             (ops/gpu_kernels.py) at real widths and compares it with the
             XLA scans; later times it against them.
* pipeline — builds a planted-state genome on disk (FASTA, BED, BigWig,
             tracks XML) from ``--seed``, trains a 40-state model with
             ``tehmm_tpu.cli.train`` and decodes it with
             ``tehmm_tpu.cli.eval`` (Viterbi and --maxPost); checks the EM
             log-likelihoods, the BEDs and the accuracy on the planted
             truth.
* oracle   — the golden fixtures decode byte-identically to the oracle's
             BED on the card, and the E-step log-likelihood of a
             4,096-position slice agrees with the float64 oracle.
* cards4   — (``--cards 4`` only) train/eval with ``--mesh 4`` against
             ``--mesh 1`` and the multi-device dry run.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


class SmokeFailure(RuntimeError):
    pass


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- device

def phase_device():
    import jax

    from tehmm_tpu.utils.gpu import card_info
    from tehmm_tpu.utils.platform import compile_cache_dir, setup_jax

    setup_jax()
    devs = jax.devices()
    dev = devs[0]
    check(dev.platform == "gpu",
          f"no GPU: JAX's first device is on {dev.platform!r}")
    print(card_info(), flush=True)
    log("device", f"jax {jax.__version__}; {len(devs)} x {dev.device_kind}")
    log("device", f"compile cache: {compile_cache_dir() or 'off'}")
    stats = dev.memory_stats() or {}
    log("device", f"bytes_limit: {stats.get('bytes_limit', 'not reported')}")
    return dev


# --------------------------------------------------------------- kernels

def phase_kernel_check(widths, B, L):
    """Compile each kernel at every width and compare it with XLA."""
    from tehmm_tpu.ops import gpu_kernels as gk
    from tehmm_tpu.utils.kernel_bench import (
        check_passes, check_shape, make_inputs,
    )

    for S, T in widths:
        kinds = tuple(k for k, cap in gk.MAX_STATES.items() if S <= cap)
        params, symbols, lengths = make_inputs(S, T, 8, B, L)
        t0 = time.perf_counter()
        err = check_shape(params, symbols, lengths, kinds)
        ok = check_passes(err)
        log("kernels", f"S={S} T={T} B={B} L={L} {'+'.join(kinds)}: "
                       f"{'ok' if ok else 'FAIL'} "
                       f"({time.perf_counter() - t0:.1f}s incl. compile) "
                       f"{json.dumps(err)}")
        check(ok, f"kernel parity failed at S={S} T={T}: {err}")


def phase_kernel_timing(shapes, B, L, reps):
    """Kernel against the XLA scans, end to end, median of ``reps``."""
    from tehmm_tpu.ops import dp
    from tehmm_tpu.utils.kernel_bench import make_inputs, time_shape

    for S, T in shapes:
        params, symbols, lengths = make_inputs(S, T, 8, B, L)
        sec = time_shape(params, symbols, lengths, [dp._UNROLL], reps)
        xla = sec[f"xla_unroll{dp._UNROLL}"]
        for unit in ("em_iteration", "viterbi_decode", "maxpost_decode"):
            log("kernels", f"S={S} T={T} {unit}: kernel "
                           f"{sec['kernel'][unit] * 1e3:.3f} ms, xla "
                           f"{xla[unit] * 1e3:.3f} ms")


# -------------------------------------------------------------- pipeline

def _write_bed(path, rows):
    with open(path, "w") as fh:
        for r in rows:
            fh.write("\t".join(str(x) for x in r) + "\n")


def _read_logliks(jsonl):
    out = []
    with open(jsonl) as fh:
        for line in fh:
            rec = json.loads(line)
            if "loglik" in rec:
                out.append((rec["loglik"], rec.get("wall")))
    return out


def check_monotone(logliks):
    lls = np.asarray(logliks, np.float64)
    check(len(lls) > 0 and np.isfinite(lls).all(),
          f"EM log-likelihoods not finite: {lls}")
    drops = lls[:-1] - lls[1:]
    check((drops <= 1e-4 * np.abs(lls[:-1])).all(),
          f"EM log-likelihood decreased: {lls}")


def bed_path(bed, chrom, n, state_names):
    """Parse a decode BED, check it is well formed and tiles
    [0, n) of ``chrom``, and return the per-position state index."""
    index = {name: i for i, name in enumerate(state_names)}
    starts, ends, states = [], [], []
    with open(bed) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            check(len(f) >= 4 and f[0] == chrom, f"bad BED row {line!r}")
            check(f[3] in index, f"unknown state {f[3]!r} in {bed}")
            starts.append(int(f[1]))
            ends.append(int(f[2]))
            states.append(index[f[3]])
    starts, ends = np.asarray(starts), np.asarray(ends)
    check(len(starts) > 0 and starts[0] == 0 and ends[-1] == n,
          f"{bed} does not span [0, {n})")
    check((ends > starts).all() and (starts[1:] == ends[:-1]).all(),
          f"{bed} does not tile the chromosome")
    return np.repeat(np.asarray(states, np.int32), ends - starts)


def _eval(args):
    """Run the eval CLI, returning (rc, printed log-likelihood)."""
    from tehmm_tpu.cli import eval as cli_eval

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_eval.main(args)
    printed = buf.getvalue().strip().splitlines()
    return rc, float(printed[-1]) if printed else float("nan")


def make_dataset(work, positions, tracks=15, seed=0,
                 region_len=1_000_000, tag="pipeline"):
    """The planted genome on disk, a training BED over the whole
    chromosome and a query BED of ``region_len`` regions tiling it."""
    from tehmm_tpu.synth import build_dataset, TRUE_S

    t0 = time.perf_counter()
    xml, truth = build_dataset(work, positions, tracks, seed)
    _write_bed(os.path.join(work, "train.bed"), [("chr1", 0, positions)])
    regions = os.path.join(work, "regions.bed")
    _write_bed(regions, [
        ("chr1", s, min(s + region_len, positions))
        for s in range(0, positions, region_len)
    ])
    log(tag, f"dataset: {positions} positions x {tracks} tracks "
             f"({TRUE_S} planted states, {region_len}-position query "
             f"regions) in {time.perf_counter() - t0:.1f}s")
    return {"xml": xml, "truth": truth, "regions": regions,
            "positions": positions}


def phase_pipeline(work, data, states=40, iters=3, seed=0,
                   min_accuracy=0.95, tag="pipeline", train_flags=(),
                   eval_flags=(), evals=True):
    """train CLI -> eval CLI (Viterbi and maxPost, unless ``evals`` is
    false) on ``make_dataset``'s files, checked.  Returns a dict of what
    it produced."""
    from tehmm_tpu.cli import train as cli_train
    from tehmm_tpu.models.hmm import MultitrackHmm
    from tehmm_tpu.synth import greedy_state_map

    xml, truth, regions = data["xml"], data["truth"], data["regions"]
    positions = data["positions"]
    out = {}

    run = f"{'_'.join(train_flags)}_it{iters}"
    model_path = os.path.join(work, f"model{run}.npz")
    metrics = os.path.join(work, f"train{run}.jsonl")
    t0 = time.perf_counter()
    rc = cli_train.main([
        xml, os.path.join(work, "train.bed"), model_path,
        "--numStates", str(states), "--iter", str(iters),
        "--emThresh", "0", "--seed", str(seed), "--logJson", metrics,
        *train_flags,
    ])
    train_s = time.perf_counter() - t0
    check(rc == 0, f"train exited {rc}")
    rec = _read_logliks(metrics)
    lls = [r[0] for r in rec]
    walls = [r[1] for r in rec if r[1] is not None]
    check_monotone(lls)
    check(len(lls) == iters, f"{len(lls)} EM iterations, wanted {iters}")
    steady = float(np.median(walls[1:])) if len(walls) > 1 else 0.0
    log(tag, f"train: {train_s:.1f}s wall; EM logliks {lls}")
    log(tag, f"train: iteration walls {[round(w, 3) for w in walls]} s; "
             f"first-call set-up (compile) ~{walls[0] - steady:.1f}s")
    out.update(model=model_path, logliks=lls, xml=xml, regions=regions,
               truth=truth)

    model = MultitrackHmm.load(model_path)
    out["params"] = model.params
    modes = (("viterbi", []), ("maxpost", ["--maxPost"])) if evals else ()
    for mode, flags in modes:
        bed = os.path.join(work, f"{mode}{'_'.join(eval_flags)}.bed")
        t0 = time.perf_counter()
        rc, ll = _eval([xml, model_path, regions, "--bed", bed,
                        *flags, *eval_flags])
        dt = time.perf_counter() - t0
        check(rc == 0, f"eval {mode} exited {rc}")
        check(np.isfinite(ll), f"eval {mode} printed loglik {ll}")
        path = bed_path(bed, "chr1", positions, model.state_names)
        mapping = greedy_state_map([path], [truth], model.num_states)
        acc = float((mapping[path] == truth).mean())
        log(tag, f"eval {mode}: {dt:.1f}s wall, printed loglik {ll}, "
                 f"planted-state accuracy {acc:.4f} "
                 f"(bound {min_accuracy})")
        check(acc >= min_accuracy,
              f"{mode} accuracy {acc:.4f} < {min_accuracy}")
        out[mode] = {"bed": bed, "loglik": ll, "accuracy": acc}
    return out


# ---------------------------------------------------------------- oracle

def phase_oracle(work, model_path=None, xml=None, slice_len=4096):
    """Golden Viterbi BEDs byte-identical on the device (exact and
    stitched decoders); E-step log-likelihood of a slice of the pipeline
    data within 1e-5 relative of the float64 oracle."""
    from tehmm_tpu.cli import train as cli_train

    data = os.path.join(REPO, "tests", "data")
    gold = os.path.join(data, "golden", "viterbi.bed")
    gdir = os.path.join(work, "golden")
    os.makedirs(gdir, exist_ok=True)
    for f in os.listdir(data):
        if os.path.isfile(os.path.join(data, f)):
            shutil.copy(os.path.join(data, f), gdir)
    gmodel = os.path.join(gdir, "model.npz")
    check(cli_train.main([os.path.join(gdir, "tracks.xml"),
                          os.path.join(gdir, "truth.bed"), gmodel,
                          "--supervised"]) == 0, "golden train failed")
    want = open(gold).read()
    for flag in ("--exact", "--no-exact"):
        bed = os.path.join(gdir, f"pred{flag}.bed")
        rc, _ = _eval([os.path.join(gdir, "tracks.xml"), gmodel,
                       os.path.join(gdir, "regions.bed"), "--bed", bed,
                       flag])
        check(rc == 0, f"golden eval {flag} exited {rc}")
        same = open(bed).read() == want
        log("oracle", f"golden Viterbi BED ({flag} decoder) "
                      f"byte-identical to the oracle: {same}")
        check(same, f"golden Viterbi BED differs ({flag})")

    if model_path is None:
        return
    import jax.numpy as jnp

    from tehmm_tpu import oracle
    from tehmm_tpu.io import TrackList, load_track_data
    from tehmm_tpu.models.hmm import MultitrackHmm
    from tehmm_tpu.ops import em as em_ops, gpu_kernels as gk

    model = MultitrackHmm.load(model_path)
    td = load_track_data(TrackList(xml), [("chr1", 0, slice_len)],
                         category_maps=model.category_maps)
    sym = np.asarray(td.tables[0].symbols).astype(np.int32)
    engine = gk.select_engine("estep", model.num_states)
    st = em_ops.em_sufficient_stats(model.params, jnp.asarray(sym)[None])
    p = model.params
    obs = oracle.obs_log_likelihoods(np.asarray(p.log_em, np.float64), sym)
    _, want_ll = oracle.forward(np.asarray(p.log_start, np.float64),
                                np.asarray(p.log_trans, np.float64), obs)
    rel = abs(float(st.loglik) - want_ll) / abs(want_ll)
    log("oracle", f"E-step loglik S={model.num_states} T={sym.shape[1]} "
                  f"L={slice_len} on the {engine} engine: "
                  f"{float(st.loglik)} vs oracle {want_ll} "
                  f"(rel {rel:.3g}, bound 1e-5)")
    check(rel <= 1e-5, f"E-step loglik off the oracle by {rel:.3g}")


# ----------------------------------------------------------- four cards

def phase_cards(work, n, positions, seed=0):
    # the printed --maxPost score under --mesh runs the sequence-parallel
    # forward: positions / n sequential operator steps, so this phase
    # uses a shorter chromosome than the one-card pipeline
    """train/eval with --mesh n against --mesh 1, plus the multi-device
    dry run; every collective path must agree with one device."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    from tehmm_tpu.parallel.mesh import make_data_mesh, stage_batch

    check(len(jax.devices()) >= n, f"need {n} devices, have "
                                   f"{len(jax.devices())}")
    staged = stage_batch(np.zeros((2 * n, 8), np.int8), make_data_mesh(n))
    placed = len(staged.sharding.device_set)
    log("cards", f"staged batch spans {placed} devices")
    check(placed == n, "mesh staging placed the batch on one device")

    data = make_dataset(work, positions, seed=seed,
                        region_len=max(1, positions // 4), tag="cards")
    one = phase_pipeline(work, data, seed=seed, tag="cards",
                         train_flags=("--mesh", "1"),
                         eval_flags=("--mesh", "1"))
    many = phase_pipeline(work, data, seed=seed, tag="cards",
                          train_flags=("--mesh", str(n)), evals=False)
    np.testing.assert_allclose(many["logliks"], one["logliks"], rtol=1e-5)
    # parameters after one EM iteration: later iterations compound the
    # f32 reordering of the psum-merged sums (EM amplifies it), so the
    # parameter tolerance is checked where it is a property of one step
    step = [phase_pipeline(work, data, iters=1, seed=seed, tag="cards",
                           train_flags=("--mesh", m), evals=False)
            for m in ("1", str(n))]
    worst = 0.0
    for f in ("log_start", "log_trans", "log_em"):
        a, b = (np.exp(np.asarray(getattr(r["params"], f), np.float64))
                for r in step)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        c, d = (np.exp(np.asarray(getattr(r["params"], f), np.float64))
                for r in (many, one))
        worst = max(worst, float(np.max(np.abs(c - d) / (np.abs(d)
                                                        + 1e-30))))
    log("cards", f"train --mesh {n} == --mesh 1: EM logliks over "
                 f"{len(one['logliks'])} iterations within 1e-5 "
                 f"(psum-merged statistics); parameters after one "
                 f"iteration within rtol=1e-4/atol=1e-5; after "
                 f"{len(one['logliks'])} iterations the largest relative "
                 f"parameter difference is {worst:.3g}")
    # one model decoded both ways: byte-identical BEDs, and the maxPost
    # score from the sequence-parallel forward (all_gather of per-device
    # operators) equals the single-device streaming forward
    for mode in ("viterbi", "maxpost"):
        flags = ["--maxPost"] if mode == "maxpost" else []
        bed = os.path.join(work, f"{mode}_mesh{n}.bed")
        t0 = time.perf_counter()
        rc, ll = _eval([one["xml"], one["model"], one["regions"],
                        "--bed", bed, "--mesh", str(n), *flags])
        check(rc == 0, f"eval {mode} --mesh {n} exited {rc}")
        same = open(bed).read() == open(one[mode]["bed"]).read()
        check(same, f"{mode} BED differs between meshes")
        np.testing.assert_allclose(ll, one[mode]["loglik"], rtol=1e-5)
        log("cards", f"eval {mode} --mesh {n} == --mesh 1 "
                     f"({time.perf_counter() - t0:.1f}s): BED "
                     f"byte-identical, loglik {ll} vs "
                     f"{one[mode]['loglik']}")
    for d in jax.devices()[:n]:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use")
        log("cards", f"device {d.id} peak bytes in use: {peak}")
    __graft_entry__.dryrun_multichip(n)
    log("cards", f"dryrun_multichip({n}): sharded EM step (psum), "
                 "data-parallel Viterbi, data x state mesh (all_gather), "
                 "CFG mesh EM and CYK decode all equal one device")
    jax.block_until_ready(jnp.zeros(()))


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the four-card mesh phase")
    ap.add_argument("--positions", type=int, default=50_000_000,
                    help="pipeline chromosome length (about chr21)")
    ap.add_argument("--meshPositions", type=int, default=1_000_000,
                    help="chromosome length of the --cards phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    opts = ap.parse_args(argv)

    work = opts.workdir or tempfile.mkdtemp(prefix="tehmm_smoke_")
    t_all = time.perf_counter()
    try:
        dev = phase_device()
        import jax

        if opts.cards > 1:
            phase_cards(work, opts.cards, opts.meshPositions, opts.seed)
        else:
            phase_kernel_check(
                [(S, T) for S in (20, 40, 64, 128) for T in (5, 15)],
                B=2048, L=1024,
            )
            data = make_dataset(work, opts.positions, seed=opts.seed)
            res = phase_pipeline(work, data, seed=opts.seed)
            phase_oracle(work, res["model"], res["xml"])
            phase_kernel_timing([(20, 5), (40, 15), (64, 15)],
                                B=2048, L=1024, reps=5)
        log("done", f"all phases passed in "
                    f"{time.perf_counter() - t_all:.1f}s")
    except Exception as e:  # any failed phase fails the run
        print(f"FAILED: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        return 1
    finally:
        if opts.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
