"""Whole-"genome" end-to-end demo: synthesize tracks, train EM, decode.

Exercises the full production path at realistic scale on the local
accelerator and prints wall-clock for every stage — the shape of run a
user doing TE annotation on a real genome would see (BASELINE.json
milestone configs #2-#4).  Default: 50M positions, 20 states, 5 tracks.

Run:  python tools/demo_genome_scale.py [--positions N] [--states S]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--positions", type=int, default=50_000_000)
    ap.add_argument("--states", type=int, default=20)
    ap.add_argument("--tracks", type=int, default=5)
    ap.add_argument("--alphabet", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=2048)
    args = ap.parse_args()

    from tehmm_tpu.utils.platform import setup_jax

    setup_jax()
    import jax
    import jax.numpy as jnp

    from tehmm_tpu.models.params import init_random
    from tehmm_tpu.ops import dp, em as em_ops
    from tehmm_tpu.models.emission import track_log_likelihoods

    S, T, V = args.states, args.tracks, args.alphabet
    N = args.positions
    print(f"device: {jax.devices()[0]}", flush=True)
    print(f"workload: {N/1e6:.0f}M positions, S={S}, T={T}, V={V}",
          flush=True)

    # ---- synthesize symbols host-side (stand-in for track loading) ----
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    sym = rng.randint(1, V, size=(N, T)).astype(np.uint8)
    t_gen = time.perf_counter() - t0
    print(f"[gen]    {t_gen:6.1f}s  host symbol synthesis "
          f"({sym.nbytes/1e6:.0f}MB)", flush=True)

    # ---- chunk into device batches; stage ALL data on device ONCE ----
    # (uint8 symbols: a 50M x 5-track genome is 250MB — far under HBM;
    # the streaming path in ops.dp covers datasets that exceed it)
    B, L = args.batch, args.chunk
    per_pass = B * L
    n_pass = N // per_pass
    if n_pass == 0:
        raise SystemExit(
            f"--positions {N} is below one pass ({per_pass}); lower "
            f"--batch/--chunk (this demo works in whole passes)"
        )
    dropped = N - n_pass * per_pass
    if dropped:
        print(f"[note]   trailing {dropped} positions (<1 pass) are "
              f"excluded from train/decode", flush=True)
    params = init_random(S, [V] * T, seed=0)
    sizes = jnp.asarray([V] * T)
    lengths = jnp.full((B,), L, jnp.int32)
    t0 = time.perf_counter()
    dev_passes = jax.device_put(
        sym[: n_pass * per_pass].reshape(n_pass, B, L, T)
    )
    dev_lens = jnp.broadcast_to(lengths, (n_pass, B))
    jax.block_until_ready(dev_passes)
    t_up = time.perf_counter() - t0
    print(f"[stage]  {t_up:6.1f}s  one-time upload of "
          f"{n_pass*per_pass*T/1e6:.0f}MB to HBM", flush=True)

    # ---- EM training: ONE dispatch per iteration (scan over passes) ----
    t0 = time.perf_counter()
    lls = []
    for it in range(args.iters):
        stats = em_ops.em_epoch_scan(params, dev_passes, dev_lens)
        params = em_ops.em_m_step(stats, params, sizes)
        lls.append(float(stats.loglik))
    t_train = time.perf_counter() - t0
    pos_rate = args.iters * n_pass * per_pass / t_train
    print(f"[train]  {t_train:6.1f}s  {args.iters} EM iterations over "
          f"{n_pass*per_pass/1e6:.0f}M positions "
          f"({pos_rate/1e6:.1f}M pos/s)", flush=True)

    # ---- decode ----
    t0 = time.perf_counter()
    n_states_decoded = 0
    state_hist = np.zeros(S, np.int64)
    for p in range(n_pass):
        sb = dev_passes[p]
        obs = track_log_likelihoods(params.log_em, sb)
        paths, _ = dp.viterbi(
            params.log_start, params.log_trans, obs, lengths
        )
        arr = np.asarray(paths)  # paths come back for BED writing
        state_hist += np.bincount(arr.ravel(), minlength=S)
        n_states_decoded += arr.size
    t_dec = time.perf_counter() - t0
    print(f"[decode] {t_dec:6.1f}s  Viterbi over "
          f"{n_states_decoded/1e6:.0f}M positions "
          f"({n_states_decoded/t_dec/1e6:.1f}M pos/s incl. path "
          f"download)", flush=True)
    print(f"loglik trajectory: {[round(x/1e6, 3) for x in lls]} (x1e6)",
          flush=True)
    print(f"decoded state occupancy (top 5): "
          f"{np.argsort(state_hist)[::-1][:5].tolist()}", flush=True)
    print("DEMO COMPLETE", flush=True)


if __name__ == "__main__":
    main()
