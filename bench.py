"""Benchmark harness: Baum-Welch EM throughput on the local GPU.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": ...}

Workload: 20-state, 5-track, unsupervised EM over a batch of 2048 chunks
of 1024 positions on one card (BASELINE.json milestone config #3's shape
class).

* value: DP cell-updates/sec for one full EM iteration (E-step + M-step),
  counting the forward + backward recurrences (2 · positions · S² updates)
  — the metric defined in BASELINE.json.  Timed as the median of warmed-up
  iterations, each ended by ``block_until_ready``.
* vs_baseline: speedup over the reference-style implementation.  The
  reference (glennhickey/teHmm) is pure single-thread NumPy loops and
  publishes no numbers, so the baseline is this repo's NumPy float64
  oracle (tehmm_tpu/oracle.py — written in the reference's O(L·S²) loop
  style), timed live on this machine's host over a 512-position slice.

Exits non-zero without a GPU: a CPU number is not this metric.
"""

import json
import statistics
import sys
import time

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp

    from tehmm_tpu import oracle
    from tehmm_tpu.models.params import init_random
    from tehmm_tpu.ops import em as em_ops
    from tehmm_tpu.utils.gpu import card_info
    from tehmm_tpu.utils.platform import setup_jax

    setup_jax()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, found {dev.platform!r}",
              file=sys.stderr)
        return 1
    card = card_info()
    print(card, flush=True)

    S, T, V = 20, 5, 8
    B, L = 2048, 1024
    reps = 20

    rng = np.random.RandomState(0)
    params = init_random(S, [V] * T, seed=0)
    symbols = jnp.asarray(
        rng.randint(1, V, size=(B, L, T)), dtype=jnp.int32
    )
    lengths = jnp.full((B,), L, dtype=jnp.int32)
    sizes = jnp.asarray([V] * T)

    def step(params):
        stats = em_ops.em_sufficient_stats(params, symbols, lengths)
        return em_ops.em_m_step(stats, params, sizes), stats.loglik

    t0 = time.perf_counter()
    jax.block_until_ready(step(params))          # compile + warm
    setup_s = time.perf_counter() - t0
    jax.block_until_ready(step(params))
    times = []
    p = params
    for _ in range(reps):
        t0 = time.perf_counter()
        p, ll = step(p)
        jax.block_until_ready((p, ll))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)

    positions = B * L
    cells = 2 * positions * S * S          # fwd + bwd updates

    # reference-style NumPy baseline, live on this host
    L_ref = 512
    sym_ref = np.asarray(symbols[0, :L_ref])
    ls = np.asarray(params.log_start, np.float64)
    lt = np.asarray(params.log_trans, np.float64)
    le = np.asarray(params.log_em, np.float64)
    t0 = time.perf_counter()
    obs = oracle.obs_log_likelihoods(le, sym_ref)
    oracle.baum_welch_counts(ls, lt, obs, sym_ref, V)
    ref_dt = (time.perf_counter() - t0) / L_ref * positions

    print(json.dumps({
        "metric": "baum_welch_cell_updates_per_sec_per_chip",
        "value": cells / dt,
        "unit": "cellupdates/s",
        "vs_baseline": ref_dt / dt,
        "detail": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
            "config": {"S": S, "T": T, "V": V, "B": B, "L": L},
            "em_iter_seconds_median": dt,
            "em_iter_seconds": times,
            "setup_seconds": setup_s,
            "positions_per_sec": positions / dt,
            "numpy_ref_iter_seconds_scaled": ref_dt,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
