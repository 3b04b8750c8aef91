"""Data-parallel EM across the device mesh.

SURVEY.md §2c DP row and §7 layer 6: genome chunks are sharded over the
``data`` mesh axis with ``jax.shard_map``; each device computes the EM
sufficient statistics of its chunk shard locally, the EmStats pytree and
total log-likelihood are summed with ``jax.lax.psum`` (NCCL: NVLink
between the cards of a host, the network across hosts), and the M-step
runs replicated on every device.
This is the whole distributed story — no other collective is required
for training (BASELINE.json: "EM sufficient statistics are merged via
jax.lax.psum before the M-step").
"""

from __future__ import annotations

from functools import partial

import jax
from jax.sharding import PartitionSpec as P

from tehmm_tpu.models.params import HmmParams
from tehmm_tpu.ops import em as em_ops
from tehmm_tpu.parallel.mesh import DATA_AXIS
from tehmm_tpu.utils.common import EPSILON


@partial(jax.jit, static_argnames=("mesh", "matmul", "engine", "interpret"))
def sharded_em_stats(
    params: HmmParams,
    symbols: jax.Array,
    lengths: jax.Array,
    mesh: jax.sharding.Mesh,
    matmul: bool = True,
    obs_weights: jax.Array | None = None,
    gauss_params=None,
    gauss_values: jax.Array | None = None,
    engine: str = "auto",
    interpret: bool = False,
) -> em_ops.EmStats:
    """E-step with chunks sharded over the data axis.

    Args:
      symbols: int[B, L, T] with B divisible by the data-axis size
        (use parallel.chunking.pad_batch_rows); padded rows have length 0.
      lengths: int[B].
      obs_weights: optional f32[B, L] emission weights (segment mode).
      gauss_params / gauss_values: gaussian-track emissions
        (models/gauss.py); values shard over the data axis like symbols
        and the moment sums psum-merge with the rest of the EmStats
        pytree.
      engine / interpret: the recurrence engine of every device's local
        E-step (ops/gpu_kernels.select_engine).

    Returns:
      Globally summed EmStats, replicated on every device.
    """
    has_w = obs_weights is not None
    has_g = gauss_values is not None

    def local(params, symbols, lengths, *rest):
        i = 0
        w = None
        gp = gv = None
        if has_w:
            w = rest[i]
            i += 1
        if has_g:
            gp, gv = rest[i], rest[i + 1]
        # "auto": each device runs the GPU kernels on its local shard
        # on a GPU mesh (inside their envelope), the XLA scans on CPU
        # meshes (tests)
        stats = em_ops.em_sufficient_stats(
            params, symbols, lengths, matmul=matmul, obs_weights=w,
            engine=engine, gauss_params=gp, gauss_values=gv,
            interpret=interpret,
        )
        return jax.lax.psum(stats, DATA_AXIS)

    args = [params, symbols, lengths]
    in_specs = [P(), P(DATA_AXIS), P(DATA_AXIS)]
    if has_w:
        args.append(obs_weights)
        in_specs.append(P(DATA_AXIS))
    if has_g:
        args.extend([gauss_params, gauss_values])
        in_specs.extend([P(), P(DATA_AXIS)])
    # check_vma=False: the GPU kernels' pallas_call does not type its
    # outputs' variance over mesh axes; the psum above makes the
    # statistics replicated either way
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=tuple(in_specs), out_specs=P(),
        check_vma=False,
    )
    return fn(*args)


def sharded_em_step(
    params: HmmParams,
    symbols: jax.Array,
    lengths: jax.Array,
    alphabet_sizes: jax.Array,
    mesh: jax.sharding.Mesh,
    masks: em_ops.ParamMasks | None = None,
    epsilon: float = EPSILON,
    matmul: bool = True,
    obs_weights: jax.Array | None = None,
) -> tuple[HmmParams, jax.Array]:
    """One full EM iteration over the mesh; M-step replicated."""
    stats = sharded_em_stats(
        params, symbols, lengths, mesh, matmul, obs_weights
    )
    new_params = em_ops.em_m_step(
        stats, params, alphabet_sizes, masks, epsilon
    )
    return new_params, stats.loglik


@partial(jax.jit, static_argnames=("mesh",))
def sharded_loglik(
    params: HmmParams,
    symbols: jax.Array,
    lengths: jax.Array,
    mesh: jax.sharding.Mesh,
    obs_weights: jax.Array | None = None,
    gauss_params=None,
    gauss_values: jax.Array | None = None,
) -> jax.Array:
    """Total data log-likelihood across the mesh (for scoring /
    convergence checks without a parameter update).  Accepts the same
    segment-weight / gaussian-track observations as sharded_em_stats —
    a gaussian model scored without its values would silently return
    the categorical-only likelihood."""
    from tehmm_tpu.models.emission import track_log_likelihoods
    from tehmm_tpu.ops import dp

    has_w = obs_weights is not None
    has_g = gauss_values is not None

    def local(params, symbols, lengths, *rest):
        i = 0
        w = gp = gv = None
        if has_w:
            w = rest[i]
            i += 1
        if has_g:
            gp, gv = rest[i], rest[i + 1]
        obs = track_log_likelihoods(params.log_em, symbols)
        if gv is not None:
            from tehmm_tpu.models.gauss import gauss_log_likelihoods

            obs = obs + gauss_log_likelihoods(gp, gv)
        if w is not None:
            obs = obs * w[:, :, None]
        _, _, ll = dp.forward_scaled(
            params.log_start, params.log_trans, obs, lengths
        )
        return jax.lax.psum(ll.sum(), DATA_AXIS)

    args = [params, symbols, lengths]
    in_specs = [P(), P(DATA_AXIS), P(DATA_AXIS)]
    if has_w:
        args.append(obs_weights)
        in_specs.append(P(DATA_AXIS))
    if has_g:
        args.extend([gauss_params, gauss_values])
        in_specs.extend([P(), P(DATA_AXIS)])
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=tuple(in_specs), out_specs=P()
    )
    return fn(*args)


@partial(jax.jit, static_argnames=("mesh",))
def sharded_viterbi(
    params: HmmParams,
    symbols: jax.Array,
    lengths: jax.Array,
    mesh: jax.sharding.Mesh,
) -> tuple[jax.Array, jax.Array]:
    """Data-parallel Viterbi over a chunk batch: rows shard over the
    data axis and each device decodes its shard locally — the
    device-compute portion of chunked decode on a pod (the halo
    stitching of parallel/stitch stays host-side and is
    device-count-independent).  Paths and scores equal ``dp.viterbi``
    on the full batch (no cross-chunk collective exists to change
    them).  Returns (path int32[B, L], score f32[B])."""
    from tehmm_tpu.models.emission import track_log_likelihoods
    from tehmm_tpu.ops import dp

    def local(params, symbols, lengths):
        obs = track_log_likelihoods(params.log_em, symbols)
        return dp.viterbi(
            params.log_start, params.log_trans, obs, lengths
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
    )
    return fn(params, symbols, lengths)
