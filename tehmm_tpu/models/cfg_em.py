"""Inside-outside EM for the restricted pair-grammar CFG.

Unsupervised training of the CFG's parameters — start distribution,
transition matrix, emission tables, and the per-state pair match bonus —
by expectation-maximization under the pair grammar itself (reference:
cfg.py `MultitrackCfg` + emission.py `PairEmissionModel`; SURVEY.md §2a.
The reference trains its HMM with Baum-Welch; this module is the CFG
counterpart the rebuild adds so pair-grammar models are trainable end to
end rather than HMM-trained and decorated with pair weights afterwards).

Grammar (models/cfg.py's documented contract):

  s(i, j) -> x_i  s'(i+1, j)           left emission + transition
  p(i, j) -> x_i  s'(i+1, j-1)  x_j    pair emission at both ends
  s(i, i) -> x_i                       terminal

Both rules advance the left edge by one, so every derivation is a linear
chain of cells (0, L-1) -> (1, ·) -> ...; a position is emitted exactly
once — either as some cell's left edge or as a pair rule's right end.

E-step = one inside pass (all diagonals kept, O(L²·S) memory) plus one
outside pass that FUSES the expected-count accumulation: per diagonal d
the rule posteriors reduce to [S, L-d]·[L-d, S] matmuls against the
inside chart, so nothing of size [L, S, S] is ever materialized and the
outside chart itself lives only in the two-diagonal scan carry.  The
counts land in the same ``EmStats`` pytree as the HMM E-step, so the
M-step (EPSILON smoothing, fix/force masks, gaussian moments) is the
shared ``ops/em.em_m_step`` — with no pair states the whole procedure
provably reduces to HMM Baum-Welch (tested in tests/test_cfg_em.py
against ops/em.em_sufficient_stats and a brute-force parse enumerator).

Complexity: O(L²·S²) time, O(L²·S) memory — training tables must fit the
chart (L <= --maxSpan), exactly the bounded-span premise of CFG decode
(models/cfg.py) and the reference's own region-chunking practice
(SURVEY.md §5 long-context row).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from tehmm_tpu.models.cfg import (
    CfgParams, _logmatmulexp, _pair_emission, make_cfg_params,
)
from tehmm_tpu.models.emission import (
    expected_emission_counts,
    track_log_likelihoods,
)
from tehmm_tpu.ops.em import EmStats, em_m_step
from tehmm_tpu.utils.common import EPSILON, LOG_ZERO

_HI = jax.lax.Precision.HIGHEST   # f32 sums; not TF32 on the GPU


def _lse(x: jax.Array, axis: int) -> jax.Array:
    m = jnp.maximum(jnp.max(x, axis=axis, keepdims=True), LOG_ZERO)
    out = jnp.log(jnp.sum(jnp.exp(x - m), axis=axis))
    return out + jnp.squeeze(m, axis)


@jax.jit
def cfg_inside_chart(
    params: CfgParams, obs: jax.Array, symbols: jax.Array
) -> jax.Array:
    """Full inside chart ``in[d, i, s]`` — log P(x_i..x_{i+d} | root s)
    for every span, all L diagonals kept (cells with i + d >= L are
    LOG_ZERO).  Same recursion as models/cfg.cfg_inside_loglik, which
    keeps only a two-diagonal carry; the outside pass needs the chart.
    Child contractions run as probability-space matmuls
    (models/cfg._logmatmulexp), not [L, S, S] elementwise reductions."""
    L, S = obs.shape
    trans_pT = jnp.exp(params.hmm.log_trans).T        # [s', s]
    neg = jnp.full((L, S), LOG_ZERO, obs.dtype)
    idx = jnp.arange(L)
    sa_left = jnp.where(params.pair_mask, params.log_sa[0], 0.0)

    def step(carry, d):
        prev, prev2 = carry
        # both children shift left one position; one [2L, S] matmul
        # serves both rules' contractions
        children = jnp.concatenate(
            [prev[1:], neg[:1], prev2[1:], neg[:1]], axis=0
        )
        z = _logmatmulexp(children, trans_pT)
        r0 = z[:L] + obs + sa_left[None, :]
        j_idx = jnp.minimum(idx + d, L - 1)
        pair_em = _pair_emission(params, obs, symbols, idx, j_idx)
        r1 = z[L:] + pair_em + params.log_sa[1]
        r1 = jnp.where(params.pair_mask[None, :], r1, LOG_ZERO)
        r1 = jnp.where(d >= 2, r1, LOG_ZERO)
        cur = jnp.logaddexp(r0, r1)
        cur = jnp.where((idx + d < L)[:, None], cur, LOG_ZERO)
        return (cur, prev), cur

    if L == 1:
        return obs[None]
    (_, _), diags = jax.lax.scan(
        step, (obs, neg), jnp.arange(1, L), unroll=8
    )
    return jnp.concatenate([obs[None], diags], axis=0)


def _xi_matmul(
    a: jax.Array, c: jax.Array, log_trans: jax.Array, Z: jax.Array
) -> jax.Array:
    """xi[s, s'] = sum_i exp(a[i, s] + log_trans[s, s'] + c[i, s'] - Z)
    via one per-state-max-shifted [S, L] @ [L, S] matmul.  Every term is
    an event probability (<= 1 in exact math) so the log-space recombine
    cannot overflow; fully-LOG_ZERO columns come out as exact zeros."""
    m1 = jnp.maximum(jnp.max(a, axis=0), LOG_ZERO)           # [S]
    m2 = jnp.maximum(jnp.max(c, axis=0), LOG_ZERO)           # [S]
    ea = jnp.exp(a - m1[None, :])
    ec = jnp.exp(c - m2[None, :])
    E = jnp.einsum(
        "is,ip->sp", ea, ec,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    logxi = (log_trans + m1[:, None] + m2[None, :] - Z
             + jnp.log(jnp.maximum(E, 1e-300)))
    # exact math bounds each count by L; the clip only guards fp noise
    return jnp.exp(jnp.minimum(logxi, 30.0))


@jax.jit
def cfg_em_stats(
    params: CfgParams, obs: jax.Array, symbols: jax.Array,
    log_root: jax.Array | None = None,
) -> tuple[EmStats, jax.Array, jax.Array, jax.Array]:
    """Inside-outside expected counts for ONE sequence.

    ``log_root`` overrides the root-state distribution (default:
    ``params.hmm.log_start``).  Interior windows of a chunked long
    sequence pass a flat root here — their left edge is arbitrary
    sequence context, not a fresh sequence start, and a sharply peaked
    log_start would otherwise bias posteriors near window edges beyond
    what the halo absorbs.

    Returns ``(stats, gamma, e_match, e_tot)``:
      stats:   EmStats — start/trans/em counts + inside loglik, directly
               consumable by ops/em.em_m_step (and psum-able).
      gamma:   f32[L, S] per-position state posterior (for gaussian
               moment sums; rows sum to 1).
      e_match: f32[S] expected number of agreeing (track, pair-event)
               end-symbol comparisons per state.
      e_tot:   f32[S] expected number of comparable (both ends
               non-missing) comparisons — the posterior-weighted
               denominator for the match-bonus log-odds update.
    """
    L, S = obs.shape
    log_trans = params.hmm.log_trans
    trans_p = jnp.exp(log_trans)                      # [s, s']
    trans_pT = trans_p.T                              # [s', s]
    neg = jnp.full((L, S), LOG_ZERO, obs.dtype)
    idx = jnp.arange(L)
    sa_left = jnp.where(params.pair_mask, params.log_sa[0], 0.0)
    w0 = obs + sa_left[None, :]            # left-emit weight at any cell

    root = params.hmm.log_start if log_root is None else log_root
    inchart = cfg_inside_chart(params, obs, symbols)         # [L, L, S]
    Z = _lse(inchart[L - 1, 0] + root, 0)
    root_out = jnp.full((L, S), LOG_ZERO).at[0].set(root)

    def pair_w(d):
        """Pair-rule weight at diagonal d (LOG_ZERO where inapplicable)."""
        j_idx = jnp.minimum(idx + d, L - 1)
        pe = (_pair_emission(params, obs, symbols, idx, j_idx)
              + params.log_sa[1])
        pe = jnp.where(params.pair_mask[None, :], pe, LOG_ZERO)
        pe = jnp.where(d >= 2, pe, LOG_ZERO)
        return jnp.where((idx + d < L)[:, None], pe, LOG_ZERO)

    def diag(chart, d):
        return jax.lax.dynamic_index_in_dim(
            chart, jnp.clip(d, 0, L - 1), 0, keepdims=False
        )

    def step(carry, d):
        out_d1, out_d2, trans_acc, gamma_acc, em_acc, et_acc = carry
        # ---- outside at diagonal d from parents at d+1 / d+2 ----
        # parent-side contractions sum over the PARENT state s, i.e.
        # x @ P (vs the inside pass's child-side x @ P^T); one [2L, S]
        # matmul serves both parent rules
        P = out_d1 + w0                       # rule-0 parent factor
        Q = out_d2 + pair_w(d + 2)            # pair-rule parent factor
        z = _logmatmulexp(jnp.concatenate(
            [neg[:1], P[:-1], neg[:1], Q[:-1]], axis=0
        ), trans_p)
        out_d = jnp.logaddexp(z[:L], z[L:])
        out_d = jnp.where(d == L - 1, root_out, out_d)
        out_d = jnp.where((idx + d < L)[:, None], out_d, LOG_ZERO)

        in_d = diag(inchart, d)
        in_d1 = jnp.where(d >= 1, diag(inchart, d - 1), LOG_ZERO)
        in_d2 = jnp.where(d >= 2, diag(inchart, d - 2), LOG_ZERO)

        # ---- cell posterior -> left-edge emission responsibility ----
        mu = jnp.exp(jnp.minimum(out_d + in_d - Z, 0.0))
        gamma_acc = gamma_acc + mu

        # ---- transition counts, both rules in ONE contraction ----
        # xi0 + xi1 = sum_i a0[i,s]·c0[i,s'] + a1[i,s]·c1[i,s'] is a
        # single [S, 2L]·[2L, S] matmul over the stacked (a, c) pairs;
        # rule gating moves onto the inputs (a LOG_ZERO row zeroes its
        # half through the shared max shift)
        a0 = jnp.where(
            ((idx + d < L)[:, None]) & (d >= 1), out_d + w0, LOG_ZERO
        )
        c0 = jnp.concatenate([in_d1[1:], neg[:1]], axis=0)   # child i+1
        a1 = out_d + pair_w(d)                # pair_w gates d >= 2
        c1 = jnp.concatenate([in_d2[1:], neg[:1]], axis=0)
        trans_acc = trans_acc + _xi_matmul(
            jnp.concatenate([a0, a1], axis=0),
            jnp.concatenate([c0, c1], axis=0),
            log_trans, Z,
        )

        r1_in = _logmatmulexp(c1, trans_pT)                  # [L, S]
        p1 = jnp.exp(jnp.minimum(a1 + r1_in - Z, 0.0))
        p1 = jnp.where(d >= 2, p1, 0.0)
        # right-end emission responsibility lands at position i + d;
        # invalid rows of p1 are exact zeros so the roll wraps only zeros
        gamma_acc = gamma_acc + jnp.roll(p1, d, axis=0)

        j_idx = jnp.minimum(idx + d, L - 1)
        si, sj = symbols[idx], symbols[j_idx]
        both = (si > 0) & (sj > 0)
        nm = jnp.sum((si == sj) & both, -1).astype(jnp.float32)
        nb = jnp.sum(both, -1).astype(jnp.float32)
        em_acc = em_acc + jnp.einsum("i,is->s", nm, p1, precision=_HI)
        et_acc = et_acc + jnp.einsum("i,is->s", nb, p1, precision=_HI)

        return (out_d, out_d1, trans_acc, gamma_acc, em_acc, et_acc), None

    init = (
        neg, neg,
        jnp.zeros((S, S), jnp.float32),
        jnp.zeros((L, S), jnp.float32),
        jnp.zeros((S,), jnp.float32),
        jnp.zeros((S,), jnp.float32),
    )
    (_, _, trans, gamma, e_match, e_tot), _ = jax.lax.scan(
        step, init, jnp.arange(L - 1, -1, -1), unroll=8
    )

    em = expected_emission_counts(
        params.hmm.log_em.shape, symbols, gamma
    )
    start = jnp.exp(jnp.minimum(root + inchart[L - 1, 0] - Z, 0.0))
    stats = EmStats(
        start=start,
        trans=trans,
        em=em,
        loglik=Z,
        n_obs=jnp.float32(L),
    )
    return stats, gamma, e_match, e_tot


# ---------------------------------------------------------------------
# Packed group engine: G windows share one matmul tile
# (measured slower — kept as an executable record, not wired in)
# ---------------------------------------------------------------------
#
# Hypothesis: at small S the CFG contractions run [·, S]×[S, S] matmuls
# that leave a wide matrix unit mostly idle; packing G windows into the
# state dimension — children [G, n, S] reshaped to [n, G·S] against a
# block-diagonal [G·S, G·S] transition — fills the tile with
# wasted-but-free off-block FLOPs.  Per-window max shifts keep the
# dynamic-range contract identical (the matmul is block-diagonal, so
# cross-window shift interference multiplies exact zeros).
#
# Measured on the accelerator this was first built for, the packed
# engine was SLOWER at every (S, G) tried: XLA already collapses the
# vmapped per-window dots into one [(N·2L), S] matmul, so small-S tile
# waste was never the binding constraint, and packing adds two
# [G, n, S] <-> [n, G·S] relayouts per matmul per scan step.  Not
# re-measured on the GPU.  cfg_em_stats_g stays correct (parity-tested)
# as the executable record of the experiment.


def _blockdiag(mat: jax.Array, G: int) -> jax.Array:
    """[S, S] -> block-diagonal [G·S, G·S] (G copies)."""
    S = mat.shape[0]
    out = jnp.zeros((G, S, G, S), mat.dtype)
    out = out.at[jnp.arange(G), :, jnp.arange(G), :].set(mat[None])
    return out.reshape(G * S, G * S)


def _lmm_g(x: jax.Array, big: jax.Array) -> jax.Array:
    """Per-window log-matmul-exp, G windows packed into one matmul tile.

    x: [G, n, S]; big: block-diagonal [G·S, G·S] probability matrix.
    Equals vmapping models/cfg._logmatmulexp over the leading axis (the
    extra accumulation terms are exact zeros)."""
    G, n, S = x.shape
    m = jnp.maximum(jnp.max(x, axis=-1, keepdims=True), LOG_ZERO)
    e = jnp.exp(x - m)
    xp = jnp.moveaxis(e, 0, 1).reshape(n, G * S)
    y = jnp.einsum(
        "nk,km->nm", xp, big,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    y = jnp.moveaxis(y.reshape(n, G, S), 1, 0)
    return jnp.where(y > 0, jnp.log(jnp.maximum(y, 1e-38)) + m, LOG_ZERO)


def _xi_matmul_g(
    a: jax.Array, c: jax.Array, log_trans: jax.Array, Z: jax.Array
) -> jax.Array:
    """Per-window xi counts (models/cfg_em._xi_matmul) with the G
    windows' [S, n]·[n, S] contractions packed into one
    [G·S, n]·[n, G·S] matmul; the per-window results are the diagonal
    blocks (off-blocks are discarded — wasted FLOPs on an otherwise
    idle tile)."""
    G, n, S = a.shape
    m1 = jnp.maximum(jnp.max(a, axis=1), LOG_ZERO)           # [G, S]
    m2 = jnp.maximum(jnp.max(c, axis=1), LOG_ZERO)           # [G, S]
    ea = jnp.exp(a - m1[:, None, :])
    ec = jnp.exp(c - m2[:, None, :])
    A = jnp.moveaxis(ea, 0, 1).reshape(n, G * S)
    C = jnp.moveaxis(ec, 0, 1).reshape(n, G * S)
    E = jnp.einsum(
        "ns,np->sp", A, C,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(G, S, G, S)
    E_g = E[jnp.arange(G), :, jnp.arange(G), :]              # [G, S, S]
    logxi = (log_trans[None] + m1[:, :, None] + m2[:, None, :]
             - Z[:, None, None]
             + jnp.log(jnp.maximum(E_g, 1e-300)))
    return jnp.exp(jnp.minimum(logxi, 30.0))


_vpair = jax.vmap(_pair_emission, in_axes=(None, 0, 0, None, None))


def _cfg_inside_chart_g(params, obs_g, sym_g, big_T):
    """Packed-group inside chart: [G, L, L, S] (== vmapped
    cfg_inside_chart up to matmul reduction order)."""
    G, L, S = obs_g.shape
    negg = jnp.full((G, L, S), LOG_ZERO, obs_g.dtype)
    idx = jnp.arange(L)
    sa_left = jnp.where(params.pair_mask, params.log_sa[0], 0.0)

    def step(carry, d):
        prev, prev2 = carry
        children = jnp.concatenate(
            [prev[:, 1:], negg[:, :1], prev2[:, 1:], negg[:, :1]],
            axis=1,
        )                                                    # [G, 2L, S]
        z = _lmm_g(children, big_T)
        r0 = z[:, :L] + obs_g + sa_left[None, None, :]
        j_idx = jnp.minimum(idx + d, L - 1)
        pair_em = _vpair(params, obs_g, sym_g, idx, j_idx)
        r1 = z[:, L:] + pair_em + params.log_sa[1]
        r1 = jnp.where(params.pair_mask[None, None, :], r1, LOG_ZERO)
        r1 = jnp.where(d >= 2, r1, LOG_ZERO)
        cur = jnp.logaddexp(r0, r1)
        cur = jnp.where((idx + d < L)[None, :, None], cur, LOG_ZERO)
        return (cur, prev), cur

    if L == 1:
        return obs_g[:, None]
    (_, _), diags = jax.lax.scan(
        step, (obs_g, negg), jnp.arange(1, L), unroll=8
    )
    chart = jnp.concatenate([obs_g[None], diags], axis=0)    # [L, G, L, S]
    return jnp.moveaxis(chart, 0, 1)


@jax.jit
def cfg_em_stats_g(
    params: CfgParams, obs_g: jax.Array, sym_g: jax.Array,
    log_root_g: jax.Array | None = None,
) -> tuple[EmStats, jax.Array, jax.Array, jax.Array]:
    """Inside-outside expected counts for a GROUP of equal-length
    windows with every matmul tile-packed (see module note above).

    Drop-in equal to ``vmap(cfg_em_stats)`` over the leading axis
    (same returns, leading G axis on every output) — asserted in
    tests/test_cfg_em.py::TestPackedGroupEngine."""
    G, L, S = obs_g.shape
    log_trans = params.hmm.log_trans
    big_P = _blockdiag(jnp.exp(log_trans), G)
    big_T = _blockdiag(jnp.exp(log_trans).T, G)
    negg = jnp.full((G, L, S), LOG_ZERO, obs_g.dtype)
    idx = jnp.arange(L)
    sa_left = jnp.where(params.pair_mask, params.log_sa[0], 0.0)
    w0 = obs_g + sa_left[None, None, :]

    root = (
        jnp.broadcast_to(params.hmm.log_start, (G, S))
        if log_root_g is None else log_root_g
    )
    inchart = _cfg_inside_chart_g(params, obs_g, sym_g, big_T)
    Z = _lse(inchart[:, L - 1, 0] + root, 1)                 # [G]
    root_out = jnp.full((G, L, S), LOG_ZERO).at[:, 0].set(root)

    def pair_w(d):
        j_idx = jnp.minimum(idx + d, L - 1)
        pe = (_vpair(params, obs_g, sym_g, idx, j_idx)
              + params.log_sa[1])
        pe = jnp.where(params.pair_mask[None, None, :], pe, LOG_ZERO)
        pe = jnp.where(d >= 2, pe, LOG_ZERO)
        return jnp.where((idx + d < L)[None, :, None], pe, LOG_ZERO)

    def diag(chart, d):
        return jax.lax.dynamic_index_in_dim(
            chart, jnp.clip(d, 0, L - 1), 1, keepdims=False
        )

    def step(carry, d):
        out_d1, out_d2, trans_acc, gamma_acc, em_acc, et_acc = carry
        P = out_d1 + w0
        Q = out_d2 + pair_w(d + 2)
        z = _lmm_g(jnp.concatenate(
            [negg[:, :1], P[:, :-1], negg[:, :1], Q[:, :-1]], axis=1
        ), big_P)
        out_d = jnp.logaddexp(z[:, :L], z[:, L:])
        out_d = jnp.where(d == L - 1, root_out, out_d)
        out_d = jnp.where((idx + d < L)[None, :, None], out_d, LOG_ZERO)

        in_d = diag(inchart, d)
        in_d1 = jnp.where(d >= 1, diag(inchart, d - 1), LOG_ZERO)
        in_d2 = jnp.where(d >= 2, diag(inchart, d - 2), LOG_ZERO)

        mu = jnp.exp(jnp.minimum(
            out_d + in_d - Z[:, None, None], 0.0
        ))
        gamma_acc = gamma_acc + mu

        a0 = jnp.where(
            ((idx + d < L)[None, :, None]) & (d >= 1),
            out_d + w0, LOG_ZERO,
        )
        c0 = jnp.concatenate([in_d1[:, 1:], negg[:, :1]], axis=1)
        a1 = out_d + pair_w(d)
        c1 = jnp.concatenate([in_d2[:, 1:], negg[:, :1]], axis=1)
        trans_acc = trans_acc + _xi_matmul_g(
            jnp.concatenate([a0, a1], axis=1),
            jnp.concatenate([c0, c1], axis=1),
            log_trans, Z,
        )

        r1_in = _lmm_g(c1, big_T)
        p1 = jnp.exp(jnp.minimum(a1 + r1_in - Z[:, None, None], 0.0))
        p1 = jnp.where(d >= 2, p1, 0.0)
        gamma_acc = gamma_acc + jnp.roll(p1, d, axis=1)

        j_idx = jnp.minimum(idx + d, L - 1)
        si = sym_g[:, idx]
        sj = sym_g[:, j_idx]
        both = (si > 0) & (sj > 0)
        nm = jnp.sum((si == sj) & both, -1).astype(jnp.float32)
        nb = jnp.sum(both, -1).astype(jnp.float32)
        em_acc = em_acc + jnp.einsum("gi,gis->gs", nm, p1,
                                     precision=_HI)
        et_acc = et_acc + jnp.einsum("gi,gis->gs", nb, p1,
                                     precision=_HI)

        return (out_d, out_d1, trans_acc, gamma_acc, em_acc,
                et_acc), None

    init = (
        negg, negg,
        jnp.zeros((G, S, S), jnp.float32),
        jnp.zeros((G, L, S), jnp.float32),
        jnp.zeros((G, S), jnp.float32),
        jnp.zeros((G, S), jnp.float32),
    )
    (_, _, trans, gamma, e_match, e_tot), _ = jax.lax.scan(
        step, init, jnp.arange(L - 1, -1, -1), unroll=8
    )

    em = jax.vmap(
        lambda sy, g: expected_emission_counts(
            params.hmm.log_em.shape, sy, g
        )
    )(sym_g, gamma)
    start = jnp.exp(jnp.minimum(
        root + inchart[:, L - 1, 0] - Z[:, None], 0.0
    ))
    stats = EmStats(
        start=start,
        trans=trans,
        em=em,
        loglik=Z,
        n_obs=jnp.full((G,), jnp.float32(L)),
    )
    return stats, gamma, e_match, e_tot


def _chance_agreement(
    log_em: np.ndarray, alphabet_sizes
) -> np.ndarray:
    """Per-state chance that two independent draws agree, averaged over
    tracks that can actually contribute comparisons (mirrors
    models/cfg.estimate_match_bonus's chance norm: missing and pad
    columns excluded).  Tracks with ~no categorical mass — e.g. a
    gaussian track whose symbols column is all-missing — are skipped,
    matching e_match/e_tot which only count tracks with comparable
    non-missing ends; including them would deflate p_chance and inflate
    the learned bonus.  States with no contributing track return NaN
    (caller keeps bonus 0)."""
    em_p = np.exp(np.asarray(log_em, np.float64)).copy()      # [S, T, V]
    em_p[:, :, 0] = 0.0
    if alphabet_sizes is not None:
        for t, size in enumerate(alphabet_sizes):
            em_p[:, t, int(size):] = 0.0
    norm = em_p.sum(axis=2, keepdims=True)                    # [S, T, 1]
    valid = norm[:, :, 0] > 1e-6                              # [S, T]
    em_p = em_p / np.maximum(norm, 1e-9)
    per_track = np.sum(em_p**2, axis=2)                       # [S, T]
    n_valid = valid.sum(axis=1)
    with np.errstate(invalid="ignore"):
        return np.where(
            n_valid > 0,
            (per_track * valid).sum(axis=1) / np.maximum(n_valid, 1),
            np.nan,
        )


def match_bonus_from_counts(
    e_match: np.ndarray,
    e_tot: np.ndarray,
    log_em: np.ndarray,
    pair_mask: np.ndarray,
    alphabet_sizes,
    max_bonus: float = 8.0,
    min_events: float = 1.0,
) -> np.ndarray:
    """Posterior-weighted log-odds match bonus (the EM counterpart of
    models/cfg.estimate_match_bonus's supervised count): observed
    agreement rate under the pair-event posterior vs the chance
    agreement implied by the current emissions.  States with too little
    posterior pair mass keep bonus 0."""
    eps = 1e-9
    chance = _chance_agreement(log_em, alphabet_sizes)
    out = np.zeros(len(pair_mask), np.float32)
    for s in np.nonzero(np.asarray(pair_mask))[0]:
        if e_tot[s] < min_events or not np.isfinite(chance[s]):
            continue
        p_obs = min(max(float(e_match[s] / e_tot[s]), eps), 1 - eps)
        p_ch = min(max(float(chance[s]), eps), 1 - eps)
        bonus = (np.log(p_obs / (1 - p_obs))
                 - np.log(p_ch / (1 - p_ch)))
        out[s] = np.clip(bonus, -max_bonus, max_bonus)
    return out


@dataclasses.dataclass
class CfgEmResult:
    params: CfgParams
    logliks: list[float]          # inside loglik per iteration (pre-update)
    iterations: int
    converged: bool


_cfg_em_stats_batched = jax.jit(
    jax.vmap(cfg_em_stats, in_axes=(None, 0, 0))
)

# decode-side variant with a per-window root distribution (first window
# keeps log_start; interior windows of a chunked sequence get a flat
# root — their left edge is arbitrary context, not a sequence start)
_cfg_em_stats_rooted = jax.jit(
    jax.vmap(cfg_em_stats, in_axes=(None, 0, 0, 0))
)

# chart budget per vmapped group (the [N, L, L, S] inside charts are the
# dominant allocation; mirrors models/cfg._cfg_decode_batch's bound)
_CHART_BYTES = 256 << 20


def cfg_em_run(
    params: CfgParams,
    symbols_list,
    alphabet_sizes,
    iterations: int = 10,
    masks=None,
    epsilon: float = EPSILON,
    update_match: bool = True,
    threshold: float = 1e-4,
    gauss_params=None,
    values_list=None,
    log_fn=None,
    mesh=None,
) -> tuple[CfgEmResult, "GaussParams | None"]:
    """Inside-outside EM over a list of sequences.

    Each iteration recomputes obs from the current emissions, sums
    ``cfg_em_stats`` over the tables, and applies the shared HMM M-step
    (ops/em.em_m_step — EPSILON smoothing + fix/force masks).  With
    ``update_match`` the per-state pair bonus is re-estimated each
    iteration from the posterior pair-event counts (a generalized-EM
    update; with it off, transitions/emissions/start follow the exact
    EM monotone-likelihood guarantee).  Gaussian tracks contribute their
    densities to obs and are refit from posterior moment sums
    (models/gauss.gauss_stats / gauss_m_step).

    Convergence: relative total-loglik improvement < ``threshold``.

    ``mesh``: optional ``data`` device mesh — window groups shard over
    it (parallel/cfg_sharded.py; groups pad to a multiple of the mesh
    size with masked dummy windows), statistics psum-merge, and the
    M-step stays replicated.  Equal to mesh=None on the same inputs.
    """
    from tehmm_tpu.models.gauss import (
        gauss_log_likelihoods, gauss_m_step, gauss_stats,
    )

    sizes = jnp.asarray(list(alphabet_sizes))
    S = params.hmm.num_states
    has_gauss = gauss_params is not None and values_list is not None
    n_dev = 1
    if mesh is not None:
        n_dev = int(np.prod(list(mesh.shape.values())))

    # Group equal-length windows so each group's E-step is ONE vmapped
    # device dispatch (same lesson as the batched CFG decode: the
    # per-window Python loop was dispatch-bound).  Group size is bounded
    # by the vmapped inside-chart memory — PER DEVICE, so a mesh scales
    # the group n_dev-fold; at most two compiled shapes per distinct
    # length (full groups + the remainder).
    by_len: dict[int, list[int]] = {}
    for k, sym in enumerate(symbols_list):
        by_len.setdefault(int(np.shape(sym)[0]), []).append(k)
    groups = []   # (sym_b, vals_b, valid) — stacked once, reused per iter
    for L, idxs in sorted(by_len.items()):
        group = max(1, _CHART_BYTES // max(L * L * S * 4, 1)) * n_dev
        for g0 in range(0, len(idxs), group):
            ids = idxs[g0:g0 + group]
            sym_b = np.stack(
                [np.asarray(symbols_list[i]) for i in ids]
            )
            vals_b = None
            if has_gauss:
                vals_b = np.stack(
                    [np.asarray(values_list[i]) for i in ids]
                )
            valid = None
            if mesh is not None:
                from tehmm_tpu.parallel.cfg_sharded import pad_group

                (sym_b, vals_b), valid = pad_group(
                    [sym_b, vals_b], n_dev
                )
                valid = jnp.asarray(valid)
            sym_b = jnp.asarray(sym_b)
            if vals_b is not None:
                vals_b = jnp.asarray(vals_b)
            groups.append((sym_b, vals_b, valid))

    logliks: list[float] = []
    converged = False
    it = 0
    for it in range(1, iterations + 1):
        total = None
        em_sum = tot_sum = None
        gmoments = None
        for sym_b, vals_b, valid in groups:
            if mesh is not None:
                from tehmm_tpu.parallel.cfg_sharded import (
                    sharded_cfg_em_group,
                )

                stats, e_m, e_t, g = sharded_cfg_em_group(
                    params, sym_b, valid, mesh,
                    gauss_params=gauss_params, vals_b=vals_b,
                    has_gauss=has_gauss,
                )
            else:
                obs_b = track_log_likelihoods(params.hmm.log_em, sym_b)
                if vals_b is not None:
                    obs_b = obs_b + gauss_log_likelihoods(
                        gauss_params, vals_b
                    )
                stats_b, gamma_b, e_m, e_t = _cfg_em_stats_batched(
                    params, obs_b, sym_b
                )
                stats = jax.tree.map(lambda x: x.sum(0), stats_b)
                e_m, e_t = e_m.sum(0), e_t.sum(0)
                g = (
                    gauss_stats(gamma_b, vals_b)
                    if vals_b is not None else None
                )
            total = stats if total is None else total + stats
            em_sum = e_m if em_sum is None else em_sum + e_m
            tot_sum = e_t if tot_sum is None else tot_sum + e_t
            if g is not None:
                gmoments = g if gmoments is None else tuple(
                    a + b for a, b in zip(gmoments, g)
                )
        ll = float(total.loglik)
        if ll <= LOG_ZERO / 2:
            # every parse scored impossible — either the model truly
            # forbids the data (structural-zero transitions/emissions)
            # or the only legal parse fell below _logmatmulexp's f32
            # dynamic range (models/cfg._logmatmulexp contract); the
            # counts from this iteration are meaningless either way
            import logging

            logging.getLogger("tehmm").warning(
                "cfg EM iteration %d: inside log-likelihood collapsed "
                "to -inf — the model scores the training windows as "
                "impossible; check fix/force priors and initial "
                "emissions", it,
            )
        logliks.append(ll)
        if log_fn is not None:
            log_fn(it, ll)

        new_hmm = em_m_step(total, params.hmm, sizes, masks, epsilon)
        if gmoments is not None:
            gauss_params = gauss_m_step(
                *gmoments, gauss_params,
                fix_states=getattr(masks, "fix_em_states", None)
                if masks is not None else None,
            )
        log_match = params.log_match
        if update_match:
            log_match = jnp.asarray(match_bonus_from_counts(
                np.asarray(em_sum), np.asarray(tot_sum),
                np.asarray(new_hmm.log_em),
                np.asarray(params.pair_mask),
                list(alphabet_sizes),
            ))
        params = CfgParams(
            hmm=new_hmm,
            pair_mask=params.pair_mask,
            log_match=log_match,
            log_sa=params.log_sa,
        )
        if len(logliks) >= 2:
            prev = logliks[-2]
            if abs(ll - prev) <= threshold * max(abs(prev), 1.0):
                converged = True
                break
    return CfgEmResult(
        params=params, logliks=logliks, iterations=it,
        converged=converged,
    ), gauss_params


def cfg_posterior_tables(
    params: CfgParams,
    obs: jax.Array,
    symbols: jax.Array,
    max_span: int,
    halo: int = 128,
    mesh=None,
) -> np.ndarray:
    """Per-position state posteriors under the PAIR GRAMMAR (not the
    HMM approximation) for one sequence — the decode-side consumer of
    the inside-outside gamma (eval --maxPost / --pd on a CFG model).

    Sequences longer than the chart budget are cut into core windows
    with ``halo`` overlap; each window's gamma comes from an independent
    full-span inside-outside pass (bounded-element premise: pair
    brackets live within a window, exactly as in CFG Viterbi decode,
    models/cfg.cfg_viterbi_decode_chunked) and only core rows are kept.
    Only the first window roots with ``log_start``; interior windows use
    a flat root, since their left edge is arbitrary sequence context —
    a sharply peaked log_start would otherwise bias edge posteriors
    beyond what the halo absorbs.  All windows share one length, so the
    whole pass is a few vmapped dispatches bounded by the chart memory.

    Returns f32[L, S]; rows sum to 1.
    """
    L, S = obs.shape
    if L <= max_span:
        _, gamma, _, _ = cfg_em_stats(params, obs, symbols)
        return np.asarray(gamma)

    halo = min(halo, (max_span - 1) // 2)
    core = max_span - 2 * halo
    W = max_span
    n_win = -(-L // core)
    los = np.empty(n_win, np.int64)
    cores = []
    for k in range(n_win):
        c_lo, c_hi = k * core, min((k + 1) * core, L)
        los[k] = min(max(c_lo - halo, 0), L - W)
        cores.append((c_lo, c_hi))
    idx = los[:, None] + np.arange(W)[None, :]
    obs_wins = jnp.asarray(obs)[idx]                       # [N, W, S]
    sym_wins = jnp.asarray(symbols)[idx]                   # [N, W, T]

    roots = np.zeros((n_win, S), np.float32)     # flat (unnormalized)
    first = np.nonzero(los == 0)[0]
    roots[first] = np.asarray(params.hmm.log_start, np.float32)
    roots_j = jnp.asarray(roots)

    out = np.empty((L, S), np.float32)
    n_dev = 1
    if mesh is not None:
        n_dev = int(np.prod(list(mesh.shape.values())))
    group = max(1, _CHART_BYTES // max(W * W * S * 4, 1)) * n_dev
    for g0 in range(0, n_win, group):
        g1 = min(g0 + group, n_win)
        if mesh is not None:
            from tehmm_tpu.parallel.cfg_sharded import (
                sharded_cfg_gamma_group,
            )

            # pad ON DEVICE (repeat the last window; padded results are
            # discarded) — a host round trip here would move hundreds
            # of MB of f32 windows through the host
            ow, sw, rt = (obs_wins[g0:g1], sym_wins[g0:g1],
                          roots_j[g0:g1])
            pad = (-(g1 - g0)) % n_dev
            if pad:
                ow = jnp.concatenate(
                    [ow, jnp.repeat(ow[-1:], pad, axis=0)])
                sw = jnp.concatenate(
                    [sw, jnp.repeat(sw[-1:], pad, axis=0)])
                rt = jnp.concatenate(
                    [rt, jnp.repeat(rt[-1:], pad, axis=0)])
            gamma_b = sharded_cfg_gamma_group(
                params, ow, sw, rt, mesh,
            )[: g1 - g0]
        else:
            _, gamma_b, _, _ = _cfg_em_stats_rooted(
                params, obs_wins[g0:g1], sym_wins[g0:g1], roots_j[g0:g1]
            )
        gamma_np = np.asarray(gamma_b)
        for k in range(g0, g1):
            c_lo, c_hi = cores[k]
            lo = int(los[k])
            out[c_lo:c_hi] = gamma_np[k - g0, c_lo - lo : c_hi - lo]
    return out


def cfg_posterior_decode(
    params: CfgParams,
    obs: jax.Array,
    symbols: jax.Array,
    max_span: int,
    halo: int = 128,
    mesh=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Max-posterior state path under the pair grammar.

    Returns (path int32[L], gamma f32[L, S])."""
    gamma = cfg_posterior_tables(
        params, obs, symbols, max_span, halo, mesh=mesh
    )
    return np.argmax(gamma, axis=-1).astype(np.int32), gamma


__all__ = [
    "cfg_inside_chart",
    "cfg_em_stats",
    "cfg_em_run",
    "cfg_posterior_tables",
    "cfg_posterior_decode",
    "match_bonus_from_counts",
    "CfgEmResult",
    "make_cfg_params",
]
