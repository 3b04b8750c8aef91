"""Weak/strong scaling sweep of the sharded EM step and data-parallel decode.

BASELINE.json's north star asks for >=80% scaling efficiency at >=2
hosts.  This harness produces that number with ONE command wherever a
mesh exists: on real hardware it sweeps the actual chips; in this
1-chip dev environment it validates the sweep on a virtual CPU mesh
(``--virtual N`` forces ``xla_force_host_platform_device_count``).

    python tools/bench_scaling.py --virtual 8            # CPU, 8 virtual devices
    python tools/bench_scaling.py                        # real devices, all
    python tools/bench_scaling.py --jsonl scaling.jsonl  # machine-readable out

For each device count n in the sweep it times — median of ``--reps``
warmed-up iterations, each ended by ``block_until_ready``:

* **EM step** (`parallel.em_sharded.sharded_em_step`): the E-step psum +
  replicated M-step — the production `train --mesh` path.
* **Viterbi decode**: chunk batch sharded over the data axis, each
  device decoding its shard locally (`shard_map` over `ops.dp.viterbi`)
  — the device-compute portion of chunked decode on a pod.

Modes: weak scaling holds batch-per-device constant (efficiency =
thr(n) / (n * thr(1))); strong scaling holds the total batch constant
(same formula — ideal is linear throughput in n either way).

Caveat (logged, not hidden): on a VIRTUAL CPU mesh all "devices" share
the host's cores, so weak-scaling efficiency measures the sweep's
correctness and the collective overhead, not NVLink scaling — n
virtual devices do n times the work on fixed silicon.  Numbers >=80%
are only meaningful on real chips.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--virtual", type=int, default=None, metavar="N",
                   help="force an N-device virtual CPU mesh (dev/test)")
    p.add_argument("--devices", type=int, default=None,
                   help="max device count to sweep (default: all)")
    p.add_argument("--numStates", type=int, default=20)
    p.add_argument("--numTracks", type=int, default=5)
    p.add_argument("--alphabetSize", type=int, default=8)
    p.add_argument("--batchPerDevice", type=int, default=None,
                   help="weak-scaling chunk rows per device "
                        "(default: 256 on a GPU, 8 on CPU)")
    p.add_argument("--totalBatch", type=int, default=None,
                   help="strong-scaling total chunk rows "
                        "(default: batchPerDevice * max devices)")
    p.add_argument("--length", type=int, default=None,
                   help="chunk length (default: 1024 GPU, 256 CPU)")
    p.add_argument("--reps", type=int, default=None,
                   help="timed iterations per point, median reported "
                        "(default: 3 CPU, 10 GPU)")
    p.add_argument("--mode", choices=["em", "decode", "both"],
                   default="both")
    p.add_argument("--scaling", choices=["weak", "strong", "both"],
                   default="both")
    p.add_argument("--jsonl", default=None,
                   help="append one JSON line per measurement here")
    return p.parse_args(argv)


def _sweep_counts(n_max: int) -> list[int]:
    counts, n = [], 1
    while n <= n_max:
        counts.append(n)
        n *= 2
    if counts[-1] != n_max:
        counts.append(n_max)
    return counts


def main(argv=None) -> None:
    opts = _parse_args(argv)
    if opts.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={opts.virtual}"
        )
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["TEHMM_PLATFORM"] = "cpu"

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from tehmm_tpu.models.params import init_random
    from tehmm_tpu.ops import dp
    from tehmm_tpu.parallel.em_sharded import sharded_em_step
    from tehmm_tpu.parallel.mesh import DATA_AXIS, make_data_mesh
    from tehmm_tpu.utils.platform import setup_jax

    if opts.virtual:
        jax.config.update("jax_platforms", "cpu")
    else:
        setup_jax()

    devs = jax.devices()
    on_cpu = devs[0].platform == "cpu"
    n_max = min(opts.devices or len(devs), len(devs))
    S, T, V = opts.numStates, opts.numTracks, opts.alphabetSize
    L = opts.length or (256 if on_cpu else 1024)
    bpd = opts.batchPerDevice or (8 if on_cpu else 256)
    total_b = opts.totalBatch or bpd * n_max
    reps = opts.reps or (3 if on_cpu else 10)

    rng = np.random.RandomState(0)
    params = init_random(S, [V] * T, seed=0)
    sizes = jnp.asarray([V] * T)
    counts = _sweep_counts(n_max)
    # one symbol pool reused by every configuration (max batch we need)
    max_b = max(total_b, bpd * n_max)
    pool = rng.randint(1, V, size=(max_b, L, T)).astype(np.int32)

    out_f = open(opts.jsonl, "a") if opts.jsonl else None

    def emit(rec):
        line = json.dumps(rec)
        if out_f:
            out_f.write(line + "\n")
            out_f.flush()
        print(line)

    from tehmm_tpu.utils.profiling import median_time

    def time_em(mesh, B):
        symbols = jnp.asarray(pool[:B])
        lengths = jnp.full((B,), L, dtype=jnp.int32)
        return median_time(
            lambda: sharded_em_step(params, symbols, lengths, sizes, mesh),
            reps,
        )

    def time_decode(mesh, B):
        symbols = jnp.asarray(pool[:B])
        lengths = jnp.full((B,), L, dtype=jnp.int32)

        def local(params, symbols, lengths):
            from tehmm_tpu.models.emission import track_log_likelihoods

            obs = track_log_likelihoods(params.log_em, symbols)
            return dp.viterbi(
                params.log_start, params.log_trans, obs, lengths
            )

        fn = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        ))
        return median_time(lambda: fn(params, symbols, lengths), reps)

    timers = {"em": time_em, "decode": time_decode}
    modes = ["em", "decode"] if opts.mode == "both" else [opts.mode]
    scalings = (["weak", "strong"] if opts.scaling == "both"
                else [opts.scaling])

    base_thr: dict[tuple[str, str], float] = {}
    summary = []
    for scaling in scalings:
        for n in counts:
            mesh = make_data_mesh(n)
            B = bpd * n if scaling == "weak" else total_b
            if B % n:
                continue
            for kernel in modes:
                dt = timers[kernel](mesh, B)
                thr = B * L / dt
                key = (scaling, kernel)
                if n == counts[0]:
                    # n=1 weak and strong share per-row cost only when
                    # B matches; keep separate baselines to stay honest
                    base_thr[key] = thr / n
                eff = thr / (n * base_thr[key])
                rec = {
                    "scaling": scaling, "kernel": kernel,
                    "devices": n, "batch": B, "length": L,
                    "S": S, "T": T, "V": V,
                    "platform": devs[0].platform,
                    "virtual": bool(opts.virtual),
                    "seconds_per_iter": round(dt, 6),
                    "positions_per_sec": round(thr, 1),
                    "positions_per_sec_per_device": round(thr / n, 1),
                    "efficiency_vs_1dev": round(eff, 4),
                }
                emit(rec)
                summary.append(rec)

    # human summary table
    print(f"\n{'scaling':8} {'kernel':7} {'n':>3} {'batch':>6} "
          f"{'pos/s':>12} {'pos/s/dev':>12} {'eff':>6}")
    for r in summary:
        print(f"{r['scaling']:8} {r['kernel']:7} {r['devices']:>3} "
              f"{r['batch']:>6} {r['positions_per_sec']:>12.3g} "
              f"{r['positions_per_sec_per_device']:>12.3g} "
              f"{r['efficiency_vs_1dev']:>6.2f}")
    if on_cpu and opts.virtual:
        print("\nNOTE: virtual CPU mesh — all devices share one host's "
              "cores; weak-scaling efficiency here validates the sweep "
              "and the collective overhead, not hardware scaling.")
    if out_f:
        out_f.close()


if __name__ == "__main__":
    main()
