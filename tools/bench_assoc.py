"""Parallel-in-time engines vs the sequential scans — on-chip numbers.

Times ops/assoc.py (log-depth associative scans) and the sequence-parallel
operator composition against the sequential scans, at the
small-batch/long-L regime the assoc docstring claims to win:

  1. dp.forward_scaled        — the production sequential vector scan
  2. assoc.forward_assoc      — all-prefix parallel-in-time forward
  3. seqpar chunk-operator composition — the per-device local reduction
     of parallel/seqpar.forward_loglik_seqpar, timed at L/D steps; the
     distributed latency model is (L/D)·t_op vs L·t_vec, so the
     single-chip crossover D* = t_op/t_vec is THE number that decides
     when the mesh path wins
  4. dp.viterbi vs assoc.viterbi_assoc (same shapes)

Usage: python tools/bench_assoc.py [--L 65536] [--B 2] [--S 20 64]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--L", type=int, default=65536)
    p.add_argument("--B", type=int, default=2)
    p.add_argument("--S", type=int, nargs="+", default=[20, 64])
    p.add_argument("--T", type=int, default=5)
    p.add_argument("--V", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    opts = p.parse_args(argv)

    from tehmm_tpu.utils.platform import setup_jax

    setup_jax()

    import jax
    import jax.numpy as jnp

    from tehmm_tpu.models.emission import track_log_likelihoods
    from tehmm_tpu.models.params import init_random
    from tehmm_tpu.ops import assoc, dp
    from tehmm_tpu.parallel.seqpar import _chunk_operator
    from tehmm_tpu.utils.profiling import median_time

    print(f"device: {jax.devices()[0]}")
    L, B, T, V = opts.L, opts.B, opts.T, opts.V
    rng = np.random.RandomState(0)

    for S in opts.S:
        params = init_random(S, [V] * T, seed=0)
        sym = jnp.asarray(rng.randint(1, V, size=(B, L, T)), jnp.int32)
        obs = track_log_likelihoods(params.log_em, sym)
        obs = jax.block_until_ready(obs)
        print(f"\n[S={S}  B={B}  L={L}]")

        def t_of(run):
            return median_time(run, opts.iters)

        t_vec = t_of(
            lambda: dp.forward_scaled(
                params.log_start, params.log_trans, obs
            ),
        )
        print(
            f"  forward sequential   {t_vec * 1e3:9.2f} ms  "
            f"({B * L / t_vec / 1e6:8.1f}M pos/s)"
        )
        try:
            t_assoc = t_of(
                lambda: assoc.forward_assoc(
                    params.log_start, params.log_trans, obs
                ),
            )
            print(
                f"  forward_assoc        {t_assoc * 1e3:9.2f} ms  "
                f"({B * L / t_assoc / 1e6:8.1f}M pos/s)  "
                f"{t_vec / t_assoc:.2f}x sequential"
            )
        except Exception as e:  # [B,L,S,S] prefixes can exhaust HBM
            print(f"  forward_assoc        FAILED ({type(e).__name__}: "
                  f"{str(e)[:80]})")

        # seqpar local chunk-operator reduction: t_op per step at the
        # SAME L (no batch; one sequence per device in the SP regime)
        obs1 = obs[0]
        valid = jnp.ones((L,), bool)
        op_fn = jax.jit(
            lambda o: _chunk_operator(params.log_trans, o, valid)
        )
        t_op = t_of(
            lambda: op_fn(obs1),
        )
        # vector scan at B=1 for the same latency comparison
        t_vec1 = t_of(
            lambda: dp.forward_scaled(
                params.log_start, params.log_trans, obs[:1]
            ),
        )
        print(
            f"  seqpar operator scan {t_op * 1e3:9.2f} ms  vs B=1 "
            f"vector scan {t_vec1 * 1e3:.2f} ms -> crossover at "
            f"D* = {t_op / t_vec1:.1f} devices "
            f"(mesh wins one long sequence when D > D*)"
        )

        t_vit = t_of(
            lambda: dp.viterbi(
                params.log_start, params.log_trans, obs
            ),
        )
        print(
            f"  viterbi sequential   {t_vit * 1e3:9.2f} ms  "
            f"({B * L / t_vit / 1e6:8.1f}M pos/s)"
        )
        try:
            t_va = t_of(
                lambda: assoc.viterbi_assoc(
                    params.log_start, params.log_trans, obs
                ),
            )
            print(
                f"  viterbi_assoc        {t_va * 1e3:9.2f} ms  "
                f"({B * L / t_va / 1e6:8.1f}M pos/s)  "
                f"{t_vit / t_va:.2f}x sequential"
            )
        except Exception as e:
            print(f"  viterbi_assoc        FAILED ({type(e).__name__}: "
                  f"{str(e)[:80]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
