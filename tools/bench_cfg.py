"""Benchmark the CFG inside-outside EM and CYK decode engines.

Measures, on the local accelerator:
  * cfg_em_stats batched E-step (inside chart + fused outside counts)
  * cfg_inside_loglik (the match-bonus grid's inner pass)
  * batched CYK Viterbi decode (chart + in-device traceback)

Usage:  python tools/bench_cfg.py [--windows N] [--span L] [--states S]

Timing: median of ``--iters`` warmed-up calls, each ended by
``block_until_ready`` (tehmm_tpu.utils.profiling.median_time).  Rates are
cell-updates/s and issued matmul FLOP/s; no peak is divided in.
"""

from __future__ import annotations

import argparse

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=64)
    ap.add_argument("--span", type=int, default=256)
    ap.add_argument("--states", type=int, default=8)
    ap.add_argument("--tracks", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=6)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tehmm_tpu.models.cfg import (
        _cfg_decode_batch, cfg_inside_loglik, make_cfg_params,
    )
    from tehmm_tpu.models.cfg_em import _cfg_em_stats_batched
    from tehmm_tpu.models.emission import track_log_likelihoods
    from tehmm_tpu.models.params import init_random
    from tehmm_tpu.utils.platform import setup_jax

    setup_jax()
    N, L, S, T, V = (args.windows, args.span, args.states,
                     args.tracks, args.vocab)
    print(f"device={jax.devices()[0]}  N={N} L={L} S={S} T={T} V={V}",
          flush=True)

    rng = np.random.RandomState(0)
    hmm = init_random(S, [V] * T, seed=0)
    params = make_cfg_params(hmm, pair_states=[1], match_bonus=1.0)
    sym = jnp.asarray(rng.randint(1, V, size=(N, L, T)), jnp.int32)
    obs = track_log_likelihoods(hmm.log_em, sym)

    from tehmm_tpu.utils.profiling import median_time

    def timed(tag, fn, iters=args.iters, cells_per_iter=None,
              flops_per_iter=None, maxplus_ops_per_iter=None):
        dt = median_time(fn, iters)
        pos = N * L / dt
        extra = ""
        if cells_per_iter:
            extra = f"  {cells_per_iter / dt / 1e9:8.1f} Gcell/s"
        if flops_per_iter:
            extra += f"  {flops_per_iter / dt / 1e12:5.2f} TFLOP/s issued"
        if maxplus_ops_per_iter:
            extra += (f"  {maxplus_ops_per_iter / dt / 1e12:5.2f} "
                      "Top/s add+max")
        print(f"{tag:28s} {dt * 1e3:9.2f} ms  {pos / 1e6:8.2f} Mpos/s"
              f"{extra}", flush=True)
        return dt

    # cells: inside chart cell-updates O(L^2/2 * S^2) per window for the
    # two rules; outside pass doubles it
    em_cells = N * (L * L // 2) * S * S * 2 * 2
    # ISSUED matmul FLOPs (the scans run fixed-shape [2L, S] matmuls on
    # every diagonal, padded rows included): inside 4L²S², outside
    # 4L²S², xi contraction 4L²S², r1_in 2L²S² per window
    em_flops = N * 14 * L * L * S * S
    inside_flops = N * 4 * L * L * S * S
    # CYK max-plus: 2 rules x (add + max) per [cell, S] pair per diagonal
    decode_maxplus = N * 4 * L * L * S * S
    timed(
        "cfg_em_stats (batched)",
        lambda: _cfg_em_stats_batched(params, obs, sym),
        cells_per_iter=em_cells,
        flops_per_iter=em_flops,
    )
    v_in = jax.jit(jax.vmap(
        lambda o, sy: cfg_inside_loglik(params, o, sy, L)
    ))
    timed(
        "cfg_inside_loglik (vmapped)",
        lambda: v_in(obs, sym),
        cells_per_iter=em_cells // 2,
        flops_per_iter=inside_flops,
    )
    timed(
        "CYK decode (batched)",
        lambda: _cfg_decode_batch(params, obs, sym, L),
        cells_per_iter=em_cells // 2,
        maxplus_ops_per_iter=decode_maxplus,
    )


if __name__ == "__main__":
    main()
