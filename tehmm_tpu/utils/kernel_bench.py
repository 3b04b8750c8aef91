"""Kernel-vs-XLA parity and timing of the HMM recurrences at one width.

Shared by tools/bench_engines.py (the kernel-decision measurement) and
chip_smoke.py's ``kernels`` phase.  ``check_shape`` compares the kernels
of ops/gpu_kernels.py with the XLA scans of ops/dp.py and returns the
largest errors; ``check_passes`` applies the tolerances they are held
to; ``time_shape`` times the end-to-end units (one EM iteration, one
Viterbi and one maxPost decode of a row group) and each recurrence alone
on both engines.  Timings mean something only on the GPU.
"""

from __future__ import annotations

import numpy as np

from tehmm_tpu.utils.profiling import median_time

# Kernel against the XLA f32 path (PERF.md "Kernel decisions on the H100")
TOLERANCES = {
    "loglik_rel": 1e-6,
    "estep_loglik_rel": 1e-6,
    "stats_tol_ratio": 1.0,      # EmStats within rtol=1e-4, atol=1e-5
    "posterior_abs": 1e-5,
    "maxpost_mismatch": 0,       # where the top two posteriors differ
    "viterbi_path_mismatch": 0,
    "viterbi_score_rel": 1e-6,
}


def make_inputs(S, T, V, B, L, seed=0):
    import jax.numpy as jnp

    from tehmm_tpu.models.params import HmmParams

    rng = np.random.RandomState(seed)
    start = rng.dirichlet(np.ones(S))
    trans = rng.dirichlet(np.ones(S), size=S)
    log_em = np.zeros((S, T, V), np.float32)
    for t in range(T):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V - 1), size=S))
    params = HmmParams(
        log_start=jnp.asarray(np.log(start), jnp.float32),
        log_trans=jnp.asarray(np.log(trans), jnp.float32),
        log_em=jnp.asarray(log_em),
    )
    symbols = rng.randint(1, V, size=(B, L, T)).astype(np.int32)
    lengths = np.full((B,), L, np.int32)
    lengths[-3:] = [L // 2, 1, 0]           # ragged tail rows
    return params, symbols, lengths


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def check_shape(params, symbols, lengths, kinds=("estep", "viterbi")):
    """Kernel vs XLA at one width; returns the largest errors of the
    recurrences named in ``kinds`` ("estep": forward/backward, E-step
    statistics, posteriors and maxPost; "viterbi": paths and scores)."""
    import jax.numpy as jnp

    from tehmm_tpu.models.emission import track_log_likelihoods
    from tehmm_tpu.ops import dp, em as em_ops, gpu_kernels as gk

    sym = jnp.asarray(symbols)
    lens = jnp.asarray(lengths)
    obs = track_log_likelihoods(params.log_em, sym)
    ls, lt = params.log_start, params.log_trans
    valid = np.arange(symbols.shape[1])[None, :] < lengths[:, None]

    def masked_abs(a, b):
        d = np.asarray(a) - np.asarray(b)
        if d.ndim == 3:
            return float(np.max(np.abs(np.where(valid[..., None], d, 0))))
        return float(np.max(np.abs(np.where(valid, d, 0))))

    err = {}
    if "estep" in kinds:
        ah_x, _, ll_x = dp.forward_scaled(ls, lt, obs, lens)
        ah_k, _, ll_k = gk.forward_scaled(ls, lt, obs, lens)
        bh_x, _ = dp.backward_scaled(lt, obs, lens)
        bh_k, _ = gk.backward_scaled(lt, obs, lens)
        g_x = np.asarray(dp.posterior_scaled(ah_x, bh_x))
        g_k = np.asarray(dp.posterior_scaled(ah_k, bh_k))
        # maxPost paths must agree wherever the top two posteriors differ
        top2 = np.sort(g_x, axis=-1)[..., -2:]
        decisive = valid & (top2[..., 1] - top2[..., 0] > 1e-5)
        st_x = em_ops.em_sufficient_stats(params, sym, lens, engine="xla")
        st_k = em_ops.em_sufficient_stats(params, sym, lens,
                                          engine="kernel")

        def stats_ratio(field):
            a = np.asarray(getattr(st_k, field), np.float64)
            b = np.asarray(getattr(st_x, field), np.float64)
            return float(np.max(np.abs(a - b) / (1e-4 * np.abs(b) + 1e-5)))

        err.update({
            "loglik_rel": _rel(ll_k, ll_x),
            "estep_loglik_rel": _rel(st_k.loglik, st_x.loglik),
            # max of |k - x| / (rtol·|x| + atol): <= 1 passes
            "stats_tol_ratio": max(
                stats_ratio(f) for f in ("start", "trans", "em")
            ),
            "alpha_hat_abs": masked_abs(ah_k, ah_x),
            "beta_hat_abs": masked_abs(bh_k, bh_x),
            "posterior_abs": masked_abs(g_k, g_x),
            "maxpost_mismatch": int(
                (decisive & (g_x.argmax(-1) != g_k.argmax(-1))).sum()
            ),
        })
    if "viterbi" in kinds:
        p_x, s_x = dp.viterbi(ls, lt, obs, lens)
        p_k, s_k = gk.viterbi(ls, lt, obs, lens)
        nonempty = lengths > 0
        err.update({
            "viterbi_path_mismatch": int(
                (valid & (np.asarray(p_x) != np.asarray(p_k))).sum()
            ),
            "viterbi_score_rel": _rel(
                np.asarray(s_k)[nonempty], np.asarray(s_x)[nonempty]
            ),
        })
    return err


def check_passes(err):
    return all(err[k] <= tol for k, tol in TOLERANCES.items() if k in err)


def time_shape(params, symbols, lengths, unrolls, reps):
    """Median seconds of each end-to-end unit on the kernel and on the
    XLA scans at each unroll factor in ``unrolls``."""
    import jax
    import jax.numpy as jnp

    from tehmm_tpu.models.emission import track_log_likelihoods
    from tehmm_tpu.ops import dp, em as em_ops, gpu_kernels as gk
    from tehmm_tpu.parallel.stitch import _decode_batch, _posterior_batch

    B, L, T = symbols.shape
    V = int(params.log_em.shape[2])
    sizes = jnp.asarray([V] * T)
    sym = jnp.asarray(symbols)
    lens = jnp.asarray(lengths)
    obs = track_log_likelihoods(params.log_em, sym)
    ls, lt = params.log_start, params.log_trans

    def units(engine):
        def em_iter():
            st = em_ops.em_sufficient_stats(params, sym, lens,
                                            engine=engine)
            return em_ops.em_m_step(st, params, sizes)

        mod = gk if engine == "kernel" else dp
        return {
            "em_iteration": em_iter,
            "viterbi_decode": lambda: _decode_batch(
                params, symbols, lengths, B, engine=engine),
            "maxpost_decode": lambda: _posterior_batch(
                params, symbols, lengths, B, engine=engine),
            "forward": lambda: mod.forward_scaled(ls, lt, obs, lens),
            "backward": lambda: mod.backward_scaled(lt, obs, lens),
            "viterbi": lambda: mod.viterbi(ls, lt, obs, lens),
        }

    out = {"kernel": {k: median_time(f, reps)
                      for k, f in units("kernel").items()}}
    saved = dp._UNROLL
    try:
        for u in unrolls:
            dp._UNROLL = u
            jax.clear_caches()
            out[f"xla_unroll{u}"] = {
                k: median_time(f, reps) for k, f in units("xla").items()
            }
    finally:
        dp._UNROLL = saved
        jax.clear_caches()
    return out


