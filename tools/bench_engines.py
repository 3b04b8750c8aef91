"""Kernel-vs-XLA parity and timing for the HMM recurrences on the GPU.

Usage:
    python tools/bench_engines.py [--shapes 20x5,40x15,64x15] [--B 2048]
        [--L 1024] [--unroll 1,8] [--reps 7] [--check-only]
        [--out engines.json]

For every ``SxT`` shape it builds a random model and symbol batch from a
seed, then

1. compiles the kernels of ops/gpu_kernels.py at that width, compares
   each with the XLA scan of ops/dp.py and prints the largest errors
   (log-likelihood, alpha/beta, posteriors, Viterbi paths and scores);
2. unless ``--check-only``, times — warmed up, ``block_until_ready``,
   median of ``--reps`` runs — one full EM iteration
   (``em_sufficient_stats`` + ``em_m_step``), one Viterbi and one maxPost
   decode of a row group (``parallel/stitch._decode_batch`` /
   ``_posterior_batch``), and each recurrence alone, on the kernel and
   on the XLA scans at every ``--unroll`` factor.

Prints one JSON object per shape and writes them all to ``--out``.  Needs
a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="20x5,40x15,64x15",
                    help="comma-separated SxT state/track widths")
    ap.add_argument("--V", type=int, default=8, help="alphabet size")
    ap.add_argument("--B", type=int, default=2048)
    ap.add_argument("--L", type=int, default=1024)
    ap.add_argument("--unroll", default="1,8",
                    help="XLA scan unroll factors to compare")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_engines: needs a GPU, found {dev.platform!r}",
              file=sys.stderr)
        return 1
    from tehmm_tpu.utils.gpu import card_info
    from tehmm_tpu.utils.kernel_bench import (
        check_passes, check_shape, make_inputs, time_shape,
    )

    print(f"device: {dev.device_kind} | {card_info()}", flush=True)
    unrolls = [int(u) for u in opts.unroll.split(",") if u]
    results, ok = [], True
    for shape in opts.shapes.split(","):
        S, T = (int(x) for x in shape.split("x"))
        params, symbols, lengths = make_inputs(
            S, T, opts.V, opts.B, opts.L, opts.seed
        )
        t0 = time.perf_counter()
        rec = {"S": S, "T": T, "B": opts.B, "L": opts.L,
               "device_kind": dev.device_kind, "card": card_info()}
        try:
            rec["errors"] = check_shape(params, symbols, lengths)
            rec["check_ok"] = check_passes(rec["errors"])
        except Exception as e:  # report the shape and go on
            rec["check_ok"] = False
            rec["error"] = f"{type(e).__name__}: {str(e)[:2000]}"
        rec["check_seconds"] = time.perf_counter() - t0
        ok &= rec["check_ok"]
        if rec["check_ok"] and not opts.check_only:
            rec["seconds"] = time_shape(
                params, symbols, lengths, unrolls, opts.reps
            )
        print(json.dumps(rec), flush=True)
        results.append(rec)
    if opts.out:
        os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
        with open(opts.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
