"""Exact cross-device sequence-parallel forward.

SURVEY.md §2c SP/CP row names the associative operator composition "the
basis for multi-chip sequence parallelism"; this module delivers that
promise as a production path: ONE long sequence is split into D
contiguous chunks sharded over the data mesh axis, each device reduces
its chunk to a single S×S forward operator

    A_d = a_{t0} ⊗ a_{t0+1} ⊗ ... ⊗ a_{t1}     (log-matmul-exp)

by a LOCAL sequential scan (L/D steps instead of L), the D small
operators are all_gather'ed (S² floats per device — one tiny
collective), and every device composes them in order behind the
start-seeded alpha_0 row.  The result is the EXACT forward
log-likelihood — no halo, no agreement heuristic — with wall-clock
≈ (L/D) × step-latency: a D× latency win for the few-long-chromosomes
regime where the batch dimension cannot hide the sequential scan
(ops/assoc.py module docstring; Särkkä & García-Fernández 2021,
PAPERS.md).

Memory model: the per-step operator a_t =
log_trans + obs_t is formed INSIDE the scan from the [Lc, S] obs rows
— nothing [Lc, S, S]-shaped ever materializes — and the production
scorer (`score_table_seqpar`) shards the raw SYMBOLS over the mesh and
builds obs blockwise inside the sharded computation, so no device ever
holds the whole sequence's observation matrix (in the genome regime,
250M positions would be 20 GB of obs at S=20, let alone the one-hot
temporaries).

Cost trade-off: each operator-composition step is an S×S ⊗ S×S product
(S× the FLOPs of the vector step), so per-chip THROUGHPUT is lower
than the sequential vector scan for wide chunk batches — use this when
latency of one long sequence bounds the run.  tools/bench_assoc.py
measures the crossover device count D* = t_op / t_vec (operator step
vs B=1 vector step); not yet measured on the GPU.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tehmm_tpu.ops.assoc import _log_matmul_exp
from tehmm_tpu.parallel.mesh import DATA_AXIS
from tehmm_tpu.utils.common import LOG_ZERO


def _eye_log(S: int) -> jax.Array:
    return jnp.where(
        jnp.eye(S, dtype=bool), 0.0, LOG_ZERO
    ).astype(jnp.float32)


def _chunk_operator(log_trans, obs_chunk, valid):
    """Compose one chunk's per-step operators a_t = trans + obs_t
    sequentially: f32[Lc, S] (+ bool[Lc] valid mask) -> f32[S, S].
    Invalid (masked) steps compose the identity.  The a_t matrix is
    formed per step inside the scan — the scan xs stay [Lc, S]."""
    S = log_trans.shape[0]
    eye = _eye_log(S)

    def step(M, xs):
        o, v = xs
        a_t = jnp.where(v, log_trans + o[None, :], eye)
        return _log_matmul_exp(M, a_t), None

    M, _ = jax.lax.scan(
        step, eye, (obs_chunk, valid), unroll=4
    )
    return M


def _compose_and_reduce(M, v0, length, mesh_axis=DATA_AXIS):
    """all_gather the per-device operators, fold them behind the
    start-seeded alpha_0 row with S² vector-matrix steps, and return
    the log-likelihood (replicated)."""
    ops = jax.lax.all_gather(M, mesh_axis)          # [D, S, S]

    def compose(row, A):
        return _log_matmul_exp(row[None, :], A)[0], None

    alpha, _ = jax.lax.scan(compose, v0, ops)
    m = jnp.maximum(jnp.max(alpha), LOG_ZERO)
    ll = jnp.log(jnp.sum(jnp.exp(alpha - m))) + m
    return jnp.where(length > 0, ll, 0.0)


@partial(jax.jit, static_argnames=("mesh",))
def forward_loglik_seqpar(
    log_start: jax.Array,
    log_trans: jax.Array,
    obs: jax.Array,
    length,
    mesh: jax.sharding.Mesh,
) -> jax.Array:
    """Exact forward log-likelihood of ONE sequence from a precomputed
    obs matrix, parallel over the data mesh axis.

    Args:
      obs: f32[L, S] observation log-likelihoods, L divisible by the
        mesh's data-axis size (pad with anything; masked via length).
      length: true sequence length (int; 0 -> loglik 0).

    Equals ``dp.forward_scaled``'s loglik on the same obs within f32
    tolerance (different but fixed reduction order).  For genome-scale
    inputs prefer ``score_table_seqpar``, which never materializes the
    whole obs matrix anywhere.
    """
    L, S = obs.shape
    D = int(np.prod(list(mesh.shape.values())))
    Lc = L // D
    length = jnp.asarray(length, jnp.int32)

    obs_sharded = obs.reshape(D, Lc, S)

    def local(obs_loc):
        obs_c = obs_loc[0]                          # [Lc, S]
        d = jax.lax.axis_index(DATA_AXIS)
        pos = d * Lc + jnp.arange(Lc, dtype=jnp.int32)
        # position 0 is handled as the start-seeded alpha_0 VECTOR
        # (not an operator), so the chunk scan masks it to identity
        valid = (pos < length) & (pos != 0)
        M = _chunk_operator(log_trans, obs_c, valid)
        # alpha_0 lives on device 0; gather the D candidate rows
        # (S floats each) and take device 0's — exact even when obs
        # rows dip below LOG_ZERO (impossible symbols)
        v0 = jax.lax.all_gather(
            log_start + obs_c[0], DATA_AXIS
        )[0]
        return _compose_and_reduce(M, v0, length)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS),),
        out_specs=P(),
        check_vma=False,
    )
    return fn(obs_sharded)


@partial(
    jax.jit, static_argnames=("mesh", "block", "has_values")
)
def _loglik_seqpar_symbols(
    log_start, log_trans, log_em, sym_sharded, val_sharded,
    length, mesh, block, has_values, gauss_mu, gauss_log_var,
):
    """Sharded-symbols forward: each device scans its [Lc, T] symbol
    chunk in [block, T] tiles, building each tile's obs rows on the
    fly (one-hot contraction over `block` positions only)."""
    from tehmm_tpu.models.emission import track_log_likelihoods

    D, Lc, _T = sym_sharded.shape
    S = log_trans.shape[0]
    length = jnp.asarray(length, jnp.int32)
    NB = Lc // block

    def obs_rows(sym_b, val_b):
        o = track_log_likelihoods(log_em, sym_b[None])[0]
        if has_values:
            from tehmm_tpu.models.gauss import (
                GaussParams, gauss_log_likelihoods,
            )

            gp = GaussParams(mu=gauss_mu, log_var=gauss_log_var)
            o = o + gauss_log_likelihoods(gp, val_b[None])[0]
        return o

    def local(sym_loc, val_loc):
        sym_c = sym_loc[0]                          # [Lc, T]
        val_c = None if val_loc is None else val_loc[0]
        d = jax.lax.axis_index(DATA_AXIS)
        base = d * Lc
        eye = _eye_log(S)

        def tile_step(M, inp):
            b, = inp
            sym_b = jax.lax.dynamic_slice_in_dim(
                sym_c, b * block, block
            )
            val_b = (
                None if val_c is None
                else jax.lax.dynamic_slice_in_dim(
                    val_c, b * block, block
                )
            )
            o = obs_rows(sym_b, val_b)              # [block, S]
            pos = base + b * block + jnp.arange(
                block, dtype=jnp.int32
            )
            valid = (pos < length) & (pos != 0)

            def step(Mi, xs):
                oi, vi = xs
                a_t = jnp.where(
                    vi, log_trans + oi[None, :], eye
                )
                return _log_matmul_exp(Mi, a_t), None

            Mb, _ = jax.lax.scan(
                step, eye, (o, valid), unroll=4
            )
            return _log_matmul_exp(M, Mb), None

        M, _ = jax.lax.scan(
            tile_step, eye,
            (jnp.arange(NB, dtype=jnp.int32),)
        )
        v0_row = obs_rows(
            sym_c[:1], None if val_c is None else val_c[:1]
        )[0]
        v0 = jax.lax.all_gather(
            log_start + v0_row, DATA_AXIS
        )[0]
        return _compose_and_reduce(M, v0, length)

    if val_sharded is None:
        fn = jax.shard_map(
            lambda s: local(s, None),
            mesh=mesh, in_specs=(P(DATA_AXIS),), out_specs=P(),
            check_vma=False,
        )
        return fn(sym_sharded)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(sym_sharded, val_sharded)


def _shard_over_data(arr, mesh):
    """Host [D, ...] array -> mesh-sharded device array, materializing
    only each process's addressable shards (multi-host safe)."""
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx]
    )


def score_table_seqpar(params, table, mesh, gauss_params=None) -> float:
    """Exact log-likelihood of one TrackTable (or raw [L, T] symbol
    array) via the sequence-parallel forward.

    The SYMBOLS are sharded over the mesh (uint8, T bytes/position)
    and each device builds obs blockwise inside its local scan — no
    whole-sequence obs matrix, no single-device staging of anything
    larger than the local symbol shard."""
    sym = np.asarray(getattr(table, "symbols", table))
    L = len(sym)
    if L == 0:
        return 0.0
    D = int(np.prod(list(mesh.shape.values())))
    block = 4096
    Lc = -(-L // (D * block)) * block      # per-device, block-aligned
    Lp = Lc * D
    sym_p = np.zeros((Lp,) + sym.shape[1:], sym.dtype)
    sym_p[:L] = sym
    sym_sh = _shard_over_data(
        sym_p.reshape(D, Lc, *sym.shape[1:]), mesh
    )
    val_sh = None
    gm = glv = None
    values = getattr(table, "values", None)
    has_values = gauss_params is not None and values is not None
    if has_values:
        vals = np.asarray(values, np.float32)
        vp = np.zeros((Lp, vals.shape[1]), np.float32)
        vp[:L] = vals
        val_sh = _shard_over_data(
            vp.reshape(D, Lc, vals.shape[1]), mesh
        )
        gm, glv = gauss_params.mu, gauss_params.log_var
    return float(
        _loglik_seqpar_symbols(
            params.log_start, params.log_trans, params.log_em,
            sym_sh, val_sh, L, mesh, block, has_values, gm, glv,
        )
    )
