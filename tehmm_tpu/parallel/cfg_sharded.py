"""Data-parallel CFG training and decode across the device mesh.

The pair-grammar paths (models/cfg.py, models/cfg_em.py) get the same
mesh twins as the HMM EM/decode.  CFG windows are independent full-span parses — exactly the
shape the ``data`` axis wants: windows shard over devices, each device
runs the vmapped inside-outside / CYK kernels on its local window block,
and the only collectives are a ``psum`` of the (already psum-able)
EmStats pytree + bonus counts for training.  Decode needs no collective
at all — paths come back still sharded and are fetched row-wise.

Callers pad each window group to a multiple of the mesh size with dummy
windows and pass a ``valid`` mask; the mask zeroes the dummy windows'
statistics inside the shard (their parses still run — same compiled
shape everywhere — but contribute nothing).

SURVEY.md §2c DP row (training generally, not just the HMM);
reference: cfg.py MultitrackCfg had no parallel story at all.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tehmm_tpu.models.emission import track_log_likelihoods
from tehmm_tpu.ops import em as em_ops
from tehmm_tpu.parallel.mesh import DATA_AXIS


def pad_group(arrays, n_devices: int):
    """Pad the leading (window) axis of every array to a multiple of
    ``n_devices`` with zeros; returns (padded_arrays, valid f32[N_pad])."""
    import numpy as np

    n = arrays[0].shape[0]
    n_pad = -(-n // n_devices) * n_devices
    valid = np.zeros(n_pad, np.float32)
    valid[:n] = 1.0
    if n_pad == n:
        return list(arrays), valid
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        a = np.asarray(a)
        pad = np.zeros((n_pad - n,) + a.shape[1:], a.dtype)
        out.append(np.concatenate([a, pad]))
    return out, valid


@partial(jax.jit, static_argnames=("mesh", "has_gauss"))
def sharded_cfg_em_group(
    cfg_params,
    sym_b: jax.Array,
    valid: jax.Array,
    mesh: jax.sharding.Mesh,
    gauss_params=None,
    vals_b: jax.Array | None = None,
    has_gauss: bool = False,
):
    """Inside-outside E-step for one equal-length window group, windows
    sharded over the data axis.

    Args:
      sym_b: int[N, L, T] with N divisible by the data-axis size.
      valid: f32[N] — 1 for real windows, 0 for padding.
      vals_b: optional f32[N, L, G] gaussian track values.

    Returns (EmStats, e_match[S], e_tot[S], gmoments|None), globally
    summed over all real windows and replicated on every device —
    equal to summing models/cfg_em.cfg_em_stats over the group."""
    from tehmm_tpu.models.cfg_em import cfg_em_stats
    from tehmm_tpu.models.gauss import gauss_log_likelihoods, gauss_stats

    def local(cfg_params, gp, sym, vals, valid):
        obs = track_log_likelihoods(cfg_params.hmm.log_em, sym)
        if has_gauss:
            obs = obs + gauss_log_likelihoods(gp, vals)
        stats_b, gamma_b, e_m, e_t = jax.vmap(
            cfg_em_stats, in_axes=(None, 0, 0)
        )(cfg_params, obs, sym)
        # f32 sums: an unqualified f32 contraction may run in TF32
        hi = jax.lax.Precision.HIGHEST
        stats = jax.tree.map(
            lambda x: jnp.einsum("n,n...->...", valid, x, precision=hi),
            stats_b,
        )
        e_m = jnp.einsum("n,ns->s", valid, e_m, precision=hi)
        e_t = jnp.einsum("n,ns->s", valid, e_t, precision=hi)
        if has_gauss:
            gm = gauss_stats(gamma_b * valid[:, None, None], vals)
        else:
            gm = (jnp.zeros(()),) * 3  # uniform pytree for psum
        return jax.lax.psum((stats, e_m, e_t, gm), DATA_AXIS)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(), P(),
            P(DATA_AXIS), P(DATA_AXIS) if has_gauss else P(),
            P(DATA_AXIS),
        ),
        out_specs=P(),
        # constants (params) enter the vmapped kernels unvarying while
        # window data is device-varying; the kernels' scan carries mix
        # the two, which the static varying-axes check rejects — the
        # psum'd outputs are replicated by construction
        check_vma=False,
    )
    stats, e_m, e_t, gm = fn(
        cfg_params, gauss_params, sym_b,
        vals_b if has_gauss else jnp.zeros(()), valid,
    )
    return stats, e_m, e_t, (gm if has_gauss else None)


def sharded_cfg_decode_group(
    cfg_params,
    obs_wins: jax.Array,
    sym_wins: jax.Array,
    mesh: jax.sharding.Mesh,
    max_span: int,
):
    """Batched CYK decode (models/cfg._cfg_decode_batch) with windows
    sharded over the data axis; embarrassingly parallel — no collective.
    The window count must be a MULTIPLE of the mesh size (use
    pad_group to pad it up).

    Returns (paths int32[N, W], scores f32[N])."""
    from tehmm_tpu.models.cfg import _cfg_decode_batch

    def local(cfg_params, ow, sw):
        return _cfg_decode_batch(cfg_params, ow, sw, max_span)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    return fn(cfg_params, obs_wins, sym_wins)


def sharded_cfg_gamma_group(
    cfg_params,
    obs_wins: jax.Array,
    sym_wins: jax.Array,
    roots: jax.Array,
    mesh: jax.sharding.Mesh,
):
    """Per-window inside-outside gamma (models/cfg_em.cfg_em_stats with
    per-window roots) sharded over the data axis — the mesh twin of the
    _cfg_em_stats_rooted dispatch behind eval --maxPost/--pd on CFG
    models.  Returns gamma f32[N, W, S]."""
    from tehmm_tpu.models.cfg_em import cfg_em_stats

    def local(cfg_params, ow, sw, roots):
        _, gamma_b, _, _ = jax.vmap(
            cfg_em_stats, in_axes=(None, 0, 0, 0)
        )(cfg_params, ow, sw, roots)
        return gamma_b

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    return fn(cfg_params, obs_wins, sym_wins, roots)
