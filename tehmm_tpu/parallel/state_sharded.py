"""State-axis (tensor-parallel) sharding for very large state counts.

SURVEY.md §2c "Tensor/model parallel (TP)": an optional second mesh axis
shards the S dimension.  For the reference's model sizes (S ≤ 64)
replicated parameters are faster — this path exists for scaled-up models
(S in the hundreds-plus, e.g. one state per TE family) where the [S,S]
contractions and the [B,L,S] activation tables no longer fit comfortably
per-chip.

Design: on a ``(data, state)`` mesh each device owns one STATE BLOCK
end-to-end:

* emission table rows ``log_em[s0:s1]`` — the obs one-hot matmul runs on
  the local rows only, so the [B,L,S] observation table is born sharded;
* transition column block ``log_trans[:, s0:s1]`` for forward / Viterbi
  steps and row block ``log_trans[s0:s1, :]`` for backward steps;
* per-position alpha/beta/gamma/value tables ``[B, L, S_loc]``.

Each scan step reassembles the full S-vector with one ``all_gather``
over the state axis (NVLink between the cards of a host) and takes
global per-step normalizers
with ``pmax``; EM statistics are contracted locally ([S, S_loc] /
[S_loc, T, V] blocks), ``psum``-merged over data, and gathered to
replicated form only at the very end (tiny vs the scan).  The Viterbi
backtrace keeps the full [S,S] log-transition table replicated — it is
a per-row vector gather, not a matmul, and S² bytes are negligible next
to the sharded [B,L,S] value tables that motivate TP.

Parity: every entry point equals its replicated ops/ counterpart on the
same inputs (asserted on the 2x4 virtual CPU mesh in
tests/test_parallel.py::TestStateSharded).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tehmm_tpu.models.emission import (
    expected_emission_counts,
    track_log_likelihoods,
)
from tehmm_tpu.ops import em as em_ops
from tehmm_tpu.parallel.mesh import DATA_AXIS, STATE_AXIS
from tehmm_tpu.utils.common import LOG_ZERO


def _fwd_init(log_start, obs_t0):
    """Shared sharded-forward init: this shard's start block + global
    per-row max renorm.  log_start arrives replicated (full [S])."""
    S_loc = obs_t0.shape[-1]
    idx = jax.lax.axis_index(STATE_AXIS)
    s0 = jax.lax.dynamic_slice_in_dim(
        log_start, idx * S_loc, S_loc, axis=0
    )
    a0 = s0[None, :] + obs_t0                       # [B, S_loc]
    m0 = jax.lax.pmax(
        jnp.maximum(jnp.max(a0, axis=-1), LOG_ZERO), STATE_AXIS
    )
    return a0 - m0[:, None], m0


def _make_fwd_step(trans_exp_cols, lengths, with_values):
    """ONE canonical sharded forward step (bit-identity between the
    loglik-only and value-storing scans depends on both executing the
    identical op sequence — same rule as ops/dp._fwd_step; the drift
    risk is real: a duplicated copy here once lost the empty-row
    guard)."""

    def step(a_hat_loc, xs):
        obs_row, t = xs
        a_full = _gather_states(a_hat_loc)          # [B, S]
        s = jnp.dot(jnp.exp(a_full), trans_exp_cols,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
        new = jnp.where(s > 0, jnp.log(s), LOG_ZERO) + obs_row
        m = jax.lax.pmax(
            jnp.maximum(jnp.max(new, axis=-1), LOG_ZERO), STATE_AXIS
        )
        new_hat = new - m[:, None]
        valid = t < lengths
        new_hat = jnp.where(valid[:, None], new_hat, a_hat_loc)
        dm = jnp.where(valid, m, 0.0)
        return new_hat, ((new_hat, dm) if with_values else dm)

    return step


def _fwd_loglik(final_hat, m0, dms, lengths):
    """Global LSE over the final sharded alpha; zero-length rows (mesh
    row padding) return exactly 0.0, matching dp.forward_scaled."""
    loc = jnp.sum(jnp.exp(final_hat), axis=-1)
    tot = jax.lax.psum(loc, STATE_AXIS)
    loglik = jnp.log(tot) + m0 + jnp.sum(dms, axis=0)
    return jnp.where(lengths > 0, loglik, 0.0)


def _fwd_local(log_start, log_trans_cols, obs_cols, lengths):
    """Per-device forward: owns obs/trans column block [.., S_loc].

    alpha is reassembled to full S each step via all_gather over the
    state axis; the per-step normalizer uses the global max (psum-style
    max over the axis).
    """
    B, L, S_loc = obs_cols.shape
    obs_t = jnp.moveaxis(obs_cols, 1, 0)
    trans_exp_cols = jnp.exp(log_trans_cols)        # [S, S_loc]
    a0_hat, m0 = _fwd_init(log_start, obs_t[0])
    step = _make_fwd_step(trans_exp_cols, lengths, with_values=False)
    ts = jnp.arange(1, L)
    final_hat, dms = jax.lax.scan(step, a0_hat, (obs_t[1:], ts))
    # reduce over data axis handled by caller
    return _fwd_loglik(final_hat, m0, dms, lengths)


@partial(jax.jit, static_argnames=("mesh",))
def forward_loglik_state_sharded(
    log_start: jax.Array,
    log_trans: jax.Array,
    obs: jax.Array,
    lengths: jax.Array,
    mesh: jax.sharding.Mesh,
) -> jax.Array:
    """Total log-likelihood with obs/params sharded over (data, state).

    Args:
      obs: f32[B, L, S]; B divides the data-axis size, S the state-axis
        size.

    Returns loglik[B] (replicated).
    """
    def local(log_start, log_trans_cols, obs_cols, lengths):
        return _fwd_local(log_start, log_trans_cols, obs_cols, lengths)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(),                          # log_start replicated
            P(None, STATE_AXIS),          # trans column blocks
            P(DATA_AXIS, None, STATE_AXIS),
            P(DATA_AXIS),
        ),
        out_specs=P(DATA_AXIS),
    )
    return fn(log_start, log_trans, obs, lengths)


# ---------------------------------------------------------------------
# state-sharded E-step (obs matmul, forward, backward, contractions)
# ---------------------------------------------------------------------


def _gather_states(x_loc):
    """[..., S_loc] -> [..., S] over the state axis (tiled)."""
    return jax.lax.all_gather(
        x_loc, STATE_AXIS, axis=x_loc.ndim - 1, tiled=True
    )


def _forward_values_local(log_start, log_trans_cols, obs_cols, lengths):
    """Scaled forward storing per-position alpha_hat columns.

    Mirrors dp.forward_scaled's op order (transition in prob space, add
    obs, subtract the GLOBAL per-step max) with pmax/all_gather standing
    in for the full-width reductions.

    Returns (alpha_hat_cols f32[B, L, S_loc], loglik f32[B])."""
    B, L, S_loc = obs_cols.shape
    obs_t = jnp.moveaxis(obs_cols, 1, 0)
    trans_exp_cols = jnp.exp(log_trans_cols)          # [S, S_loc]
    a0_hat, m0 = _fwd_init(log_start, obs_t[0])
    step = _make_fwd_step(trans_exp_cols, lengths, with_values=True)
    ts = jnp.arange(1, L)
    final_hat, (a_hats, dms) = jax.lax.scan(
        step, a0_hat, (obs_t[1:], ts)
    )
    alpha = jnp.concatenate([a0_hat[None], a_hats], axis=0)
    loglik = _fwd_loglik(final_hat, m0, dms, lengths)
    return jnp.moveaxis(alpha, 0, 1), loglik


def _backward_values_local(log_trans_rows, obs_cols, lengths):
    """Scaled backward storing per-position beta_hat columns.

    b_new[i] = log sum_j exp(logT[i, j] + x_hat[j]) with the row block
    of the transition matrix local and x gathered to full width; the
    per-step renormalizers are global maxima (pmax), mirroring
    dp.backward_scaled.

    Returns beta_hat_cols f32[B, L, S_loc]."""
    B, L, S_loc = obs_cols.shape
    obs_t = jnp.moveaxis(obs_cols, 1, 0)
    trans_exp_rows = jnp.exp(log_trans_rows)          # [S_loc, S]

    # the zero init is axis-invariant; the scan carry becomes varying
    # over both mesh axes after the first gather/pmax, so the carry
    # types must be aligned up front
    b_init = jax.lax.pcast(
        jnp.zeros((B, S_loc), obs_cols.dtype),
        (STATE_AXIS, DATA_AXIS),
        to="varying",
    )

    def step(b_hat_loc, xs):
        obs_next, t_next = xs
        x = obs_next + b_hat_loc
        xm = jax.lax.pmax(
            jnp.maximum(jnp.max(x, axis=-1), LOG_ZERO), STATE_AXIS
        )
        x_hat_full = _gather_states(x - xm[:, None])
        s = jnp.dot(jnp.exp(x_hat_full), trans_exp_rows.T,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
        new = jnp.where(s > 0, jnp.log(s), LOG_ZERO)
        m = jax.lax.pmax(
            jnp.maximum(jnp.max(new, axis=-1), LOG_ZERO), STATE_AXIS
        )
        new_hat = new - m[:, None]
        valid = t_next < lengths
        new_hat = jnp.where(valid[:, None], new_hat, b_hat_loc)
        return new_hat, new_hat

    ts = jnp.arange(1, L)
    _, b_hats = jax.lax.scan(
        step, b_init, (obs_t[1:], ts), reverse=True
    )
    beta = jnp.concatenate([b_hats, b_init[None]], axis=0)
    return jnp.moveaxis(beta, 0, 1)


def _estep_local(
    log_start, log_trans, log_trans_cols, log_trans_rows, log_em_rows,
    symbols, lengths,
):
    """Per-device E-step over its (data x state) block; returns EmStats
    with LOCAL state blocks (caller psums over data and gathers)."""
    B, L, _T = symbols.shape
    valid = jnp.arange(L)[None, :] < lengths[:, None]

    obs_cols = track_log_likelihoods(log_em_rows, symbols)
    alpha, loglik = _forward_values_local(
        log_start, log_trans_cols, obs_cols, lengths
    )
    beta = _backward_values_local(log_trans_rows, obs_cols, lengths)

    ab_loc = jnp.exp(alpha + beta)
    denom = jax.lax.psum(
        jnp.sum(ab_loc, axis=-1, keepdims=True), STATE_AXIS
    )
    gamma_cols = ab_loc / jnp.maximum(denom, 1e-30)
    gamma_cols = gamma_cols * valid[..., None]

    start_cols = gamma_cols[:, 0, :].sum(axis=0)

    # factored transition counts (same math as em_sufficient_stats):
    # full a_fac via one gather, column-block b_fac local
    a_fac = jnp.exp(_gather_states(alpha[:, :-1, :]))          # [B,L-1,S]
    bb = obs_cols[:, 1:, :] + beta[:, 1:, :]
    bbm = jax.lax.pmax(
        jnp.maximum(jnp.max(bb, axis=-1), LOG_ZERO), STATE_AXIS
    )
    b_fac = jnp.exp(jnp.clip(bb - bbm[..., None], -60.0, 60.0))
    trans_exp_cols = jnp.exp(log_trans_cols)
    aT_cols = jnp.einsum(
        "bli,ij->blj", a_fac, trans_exp_cols,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    z = jax.lax.psum(
        jnp.sum(aT_cols * b_fac, axis=-1), STATE_AXIS
    )
    valid_from = jnp.arange(L - 1)[None, :] < (lengths[:, None] - 1)
    w = jnp.where(valid_from, 1.0 / jnp.maximum(z, 1e-30), 0.0)
    pair_cols = jnp.einsum(
        "bli,blj->ij", a_fac * w[..., None], b_fac,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    trans_cols = pair_cols * trans_exp_cols

    S_loc = obs_cols.shape[-1]
    em_rows = expected_emission_counts(
        (S_loc,) + log_em_rows.shape[1:], symbols, gamma_cols,
        valid=None,
    )

    stats = em_ops.EmStats(
        start=start_cols,
        trans=trans_cols,
        em=em_rows,
        loglik=loglik.sum(),
        n_obs=valid.sum().astype(jnp.float32),
    )
    return jax.lax.psum(stats, DATA_AXIS)


@partial(jax.jit, static_argnames=("mesh",))
def em_stats_state_sharded(
    params,
    symbols: jax.Array,
    lengths: jax.Array,
    mesh: jax.sharding.Mesh,
) -> "em_ops.EmStats":
    """Full E-step with the state axis sharded over the mesh's
    ``state`` dimension and chunks over ``data``.

    The observation matmul, forward/backward scans, posterior, and all
    three count contractions run on per-device state blocks; one
    [B, S] ``all_gather`` per scan step plus global-max ``pmax``es are
    the only cross-shard traffic until the final (tiny) stat gather.

    Returns EmStats replicated on every device, equal to
    ``em_sufficient_stats(..., engine="xla")`` to f32 tolerance."""
    def local(log_start, log_trans, lt_cols, lt_rows, lem, sym, lens):
        st = _estep_local(
            log_start, log_trans, lt_cols, lt_rows, lem, sym, lens
        )
        return em_ops.EmStats(
            start=_gather_states(st.start),
            trans=jax.lax.all_gather(
                st.trans, STATE_AXIS, axis=1, tiled=True
            ),
            em=jax.lax.all_gather(
                st.em, STATE_AXIS, axis=0, tiled=True
            ),
            loglik=st.loglik,
            n_obs=st.n_obs,
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(),                          # log_start replicated
            P(),                          # log_trans replicated (unused)
            P(None, STATE_AXIS),          # column blocks (fwd)
            P(STATE_AXIS, None),          # row blocks (bwd)
            P(STATE_AXIS, None, None),    # emission rows (obs matmul)
            P(DATA_AXIS, None, None),
            P(DATA_AXIS),
        ),
        out_specs=P(),
        # the final all_gathers make every output identical on all
        # state shards, which the static varying-axes check cannot infer
        check_vma=False,
    )
    return fn(
        params.log_start, params.log_trans, params.log_trans,
        params.log_trans, params.log_em, symbols, lengths,
    )


# ---------------------------------------------------------------------
# state-sharded posterior / max-posterior decode
# ---------------------------------------------------------------------


def _posterior_cols_local(
    log_start, log_trans_cols, log_trans_rows, log_em_rows,
    symbols, lengths,
):
    """Sharded gamma columns, mirroring dp.posterior_scaled's op order
    (x = alpha_hat + beta_hat, subtract the per-position max, exp,
    normalize) with pmax/psum standing in for the full-width reductions.

    Returns (gamma_cols f32[B, L, S_loc], x_loc f32[B, L, S_loc] the
    max-shifted log-posterior whose argmax IS the maxPost path)."""
    obs_cols = track_log_likelihoods(log_em_rows, symbols)
    alpha, _ = _forward_values_local(
        log_start, log_trans_cols, obs_cols, lengths
    )
    beta = _backward_values_local(log_trans_rows, obs_cols, lengths)
    x = alpha + beta
    m = jax.lax.pmax(
        jnp.maximum(jnp.max(x, axis=-1), LOG_ZERO), STATE_AXIS
    )
    x = x - m[..., None]
    p = jnp.exp(x)
    denom = jax.lax.psum(
        jnp.sum(p, axis=-1, keepdims=True), STATE_AXIS
    )
    return p / denom, x


def _global_argmax(x_loc):
    """argmax over the sharded last axis with the replicated argmax's
    tie-break (lowest GLOBAL state index): shards report their local
    best; the winning value's lowest global index wins via pmin."""
    S_loc = x_loc.shape[-1]
    S = S_loc * jax.lax.axis_size(STATE_AXIS)
    offset = jax.lax.axis_index(STATE_AXIS) * S_loc
    best = jnp.max(x_loc, axis=-1)
    arg = offset + jnp.argmax(x_loc, axis=-1).astype(jnp.int32)
    gbest = jax.lax.pmax(best, STATE_AXIS)
    cand = jnp.where(best == gbest, arg, S)
    return jax.lax.pmin(cand, STATE_AXIS)


@partial(jax.jit, static_argnames=("mesh",))
def posterior_state_sharded(
    params,
    symbols: jax.Array,
    lengths: jax.Array,
    mesh: jax.sharding.Mesh,
) -> jax.Array:
    """Posterior gamma with the value tables sharded over (data, state);
    equals ``dp.posterior_scaled`` over the replicated pipeline to f32
    tolerance (reference: teHmmEval.py --pd; SURVEY.md §2b).

    Returns gamma f32[B, L, S] sharded over (data, ·, state) — each
    device holds only its [B/dp, L, S/tp] block; fetching to host
    assembles the global array.  Positions past ``lengths`` are zeroed
    (the replicated pipeline leaves held carry values there)."""
    def local(log_start, lt_cols, lt_rows, lem, sym, lens):
        gamma_cols, _ = _posterior_cols_local(
            log_start, lt_cols, lt_rows, lem, sym, lens
        )
        L = sym.shape[1]
        valid = jnp.arange(L)[None, :] < lens[:, None]
        return gamma_cols * valid[..., None]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(),
            P(None, STATE_AXIS),
            P(STATE_AXIS, None),
            P(STATE_AXIS, None, None),
            P(DATA_AXIS, None, None),
            P(DATA_AXIS),
        ),
        out_specs=P(DATA_AXIS, None, STATE_AXIS),
    )
    return fn(
        params.log_start, params.log_trans, params.log_trans,
        params.log_em, symbols, lengths,
    )


@partial(jax.jit, static_argnames=("mesh",))
def maxpost_state_sharded(
    params,
    symbols: jax.Array,
    lengths: jax.Array,
    mesh: jax.sharding.Mesh,
) -> jax.Array:
    """Max-posterior (argmax-gamma) decode with the state axis sharded
    (reference: teHmmEval.py --maxPost).  The per-position argmax runs
    on local GAMMA columns — the same quantity the replicated pipeline
    argmaxes, so f32 exp/divide rounding collapses ties identically —
    and shards combine via pmax + lowest-global-index pmin, matching
    the replicated ``jnp.argmax`` tie-break (residual divergence is
    limited to last-ulp differences in the psum'd denominator's
    reduction order on exact ties).

    Returns path int32[B, L] (positions past ``lengths`` and zero-length
    rows are 0)."""
    def local(log_start, lt_cols, lt_rows, lem, sym, lens):
        gamma_cols, _ = _posterior_cols_local(
            log_start, lt_cols, lt_rows, lem, sym, lens
        )
        path = _global_argmax(gamma_cols)
        L = sym.shape[1]
        valid = jnp.arange(L)[None, :] < lens[:, None]
        return jnp.where(valid, path, 0)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(),
            P(None, STATE_AXIS),
            P(STATE_AXIS, None),
            P(STATE_AXIS, None, None),
            P(DATA_AXIS, None, None),
            P(DATA_AXIS),
        ),
        out_specs=P(DATA_AXIS, None),
        # the pmin-combined path is identical on every state shard,
        # which the static varying-axes check cannot infer
        check_vma=False,
    )
    return fn(
        params.log_start, params.log_trans, params.log_trans,
        params.log_em, symbols, lengths,
    )


# ---------------------------------------------------------------------
# state-sharded Viterbi
# ---------------------------------------------------------------------


def _viterbi_local(log_start, log_trans, log_trans_cols, log_em_rows,
                   symbols, lengths):
    """Max-plus forward on state column blocks + backtrace via one
    [B, S] gather per step (value rows stay sharded end-to-end)."""
    B, L, _T = symbols.shape
    obs_cols = track_log_likelihoods(log_em_rows, symbols)
    obs_t = jnp.moveaxis(obs_cols, 1, 0)
    S_loc = obs_cols.shape[-1]

    v0_hat, m0 = _fwd_init(log_start, obs_t[0])   # same init as forward

    if L == 1:
        # no transitions: the two scans below would disagree on their
        # leading axis (1 vs 0) and crash — mirror dp.viterbi's guard
        v_full0 = _gather_states(v0_hat)
        nonempty = lengths > 0
        score = jnp.where(
            nonempty, jnp.max(v_full0, axis=-1) + m0, 0.0
        )
        path = jnp.where(
            nonempty,
            jnp.argmax(v_full0, axis=-1).astype(jnp.int32), 0,
        )
        return path[:, None], score

    def step(carry, xs):
        v_hat_loc, m = carry
        obs_row, t = xs
        v_full = _gather_states(v_hat_loc)                  # [B, S]
        best = jnp.max(
            v_full[:, :, None] + log_trans_cols[None, :, :], axis=1
        )
        new_v = best + obs_row
        dm = jax.lax.pmax(
            jnp.maximum(jnp.max(new_v, axis=-1), LOG_ZERO), STATE_AXIS
        )
        new_hat = new_v - dm[:, None]
        valid = t < lengths
        new_hat = jnp.where(valid[:, None], new_hat, v_hat_loc)
        new_m = jnp.where(valid, m + dm, m)
        return (new_hat, new_m), new_hat

    ts = jnp.arange(1, L)
    (v_final_loc, m), v_hats = jax.lax.scan(
        step, (v0_hat, m0), (obs_t[1:], ts)
    )
    v_final = _gather_states(v_final_loc)
    score = jnp.max(v_final, axis=-1) + m
    last_state = jnp.argmax(v_final, axis=-1).astype(jnp.int32)

    v_prev_rows = jnp.concatenate([v0_hat[None], v_hats[:-1]], axis=0)
    trans_T = log_trans.T                                   # replicated

    def back(state, xs):
        v_prev_loc, t = xs
        v_prev = _gather_states(v_prev_loc)                 # [B, S]
        col = trans_T[state]
        prev = jnp.argmax(v_prev + col, axis=-1).astype(jnp.int32)
        valid_t = t < lengths
        prev = jnp.where(valid_t, prev, state)
        return prev, prev

    ts_back = jnp.arange(1, L)
    _, rev_path = jax.lax.scan(
        back, last_state, (v_prev_rows, ts_back), reverse=True
    )
    path = jnp.concatenate([rev_path, last_state[None]], axis=0)
    # zero-length rows (mesh row padding): path 0 / score 0, matching
    # dp.viterbi's empty-product convention
    nonempty = lengths > 0
    score = jnp.where(nonempty, score, 0.0)
    path = jnp.where(nonempty[None, :], path, 0)
    return jnp.moveaxis(path, 0, 1), score


@partial(jax.jit, static_argnames=("mesh",))
def viterbi_state_sharded(
    params,
    symbols: jax.Array,
    lengths: jax.Array,
    mesh: jax.sharding.Mesh,
) -> tuple[jax.Array, jax.Array]:
    """Viterbi with the obs matmul and value tables sharded over the
    state axis (chunks over data).  Paths are bit-identical to
    ``dp.viterbi`` on the same inputs: the per-step maximization sees
    the identical full-width value row after the gather, and ties break
    to the lowest state index in both.

    Returns (path int32[B, L], score f32[B]) replicated."""
    def local(log_start, log_trans, lt_cols, lem, sym, lens):
        return _viterbi_local(
            log_start, log_trans, lt_cols, lem, sym, lens
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(),
            P(),
            P(None, STATE_AXIS),
            P(STATE_AXIS, None, None),
            P(DATA_AXIS, None, None),
            P(DATA_AXIS),
        ),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS)),
        # path/score come from gathered full-width rows — identical on
        # every state shard, invisible to the static vma check
        check_vma=False,
    )
    return fn(
        params.log_start, params.log_trans, params.log_trans,
        params.log_em, symbols, lengths,
    )
