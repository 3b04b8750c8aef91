"""Baum-Welch EM: E-step sufficient statistics + M-step normalization.

Rebuild of the reference's EM loop (reference: basehmm.py `fit` — per-
iteration forward/backward over every sequence, ξ/γ accumulation,
normalize with EPSILON smoothing; hmm.py applies user fix/force masks;
SURVEY.md §2a, §3.1).  Design decisions:

* The whole E-step over a batch of chunks is ONE jitted function
  ``em_sufficient_stats``: obs matmul → forward recurrence → backward
  recurrence → three matrix contractions for the ξ / γ / emission
  counts.  No [L,S,S] tensor is ever materialized (SURVEY.md §7 layer 3).
* ξ (transition) counts exploit that ξ at every position sums to exactly 1,
  so each step can be normalized by its own partition value z — computed
  from the same scaled factors — and no cumulative normalizer or total
  log-likelihood ever enters the arithmetic (length-independent f32
  accuracy; see the inline comment in ``em_sufficient_stats``).  The sum
  over (batch, time) is a single einsum.
* M-step = pure renormalization with EPSILON pseudo-counts, then
  semi-supervised fix/force masks applied as ``where`` over rows
  (reference: teHmmTrain.py --fixTrans/--fixEm/--forceTransProbs/
  --forceEmProbs semantics).
* Statistics are a pytree summed with ``jax.lax.psum`` across the data
  mesh axis in parallel/em_sharded.py — the M-step is then replicated.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from tehmm_tpu.utils.common import EPSILON
from tehmm_tpu.models.emission import (
    expected_emission_counts,
    normalize_log_em,
    track_log_likelihoods,
)
from tehmm_tpu.models.params import HmmParams
from tehmm_tpu.ops import dp, gpu_kernels

_CLIP = 60.0  # exp-range guard; see module docstring


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EmStats:
    """EM sufficient statistics (a psum-able pytree).

    start:  f32[S]      expected initial-state counts
    trans:  f32[S, S]   expected transition counts
    em:     f32[S,T,V]  expected symbol counts
    loglik: f32[]       total data log-likelihood
    n_obs:  f32[]       number of (valid) observed positions
    """

    start: jax.Array
    trans: jax.Array
    em: jax.Array
    loglik: jax.Array
    n_obs: jax.Array
    # gaussian-track moment sums (models/gauss.py); None when the model
    # has no gaussian tracks
    gauss_n: jax.Array | None = None
    gauss_x: jax.Array | None = None
    gauss_x2: jax.Array | None = None

    def __add__(self, other: "EmStats") -> "EmStats":
        return jax.tree.map(jnp.add, self, other)


@partial(jax.jit, static_argnames=("matmul", "engine", "interpret"))
def em_sufficient_stats(
    params: HmmParams,
    symbols: jax.Array,
    lengths: jax.Array | None = None,
    matmul: bool = True,
    obs_weights: jax.Array | None = None,
    engine: str = "auto",
    gauss_params=None,
    gauss_values: jax.Array | None = None,
    interpret: bool = False,
) -> EmStats:
    """One E-step over a batch of chunks.

    Args:
      symbols: int[B, L, T] discretized observations.
      lengths: optional int[B]; positions >= length are padding.
      obs_weights: optional f32[B, L] per-position emission weights —
        segment mode (reference: emission.py effectiveSegmentLength
        [R?]): a segment standing for w identical positions emits
        P(obs|state)^w, and its expected emission counts scale by w.
      engine: which implementation runs the forward/backward
        recurrences — "auto" (ops/gpu_kernels.select_engine: the GPU
        kernels on a GPU inside their state envelope, the XLA scans
        otherwise), "xla", or "kernel".  Everything else (observation
        log-likelihoods, segment weights, gaussian tracks, the three
        contractions) is the same XLA code for both.
      interpret: run the kernels in the Pallas interpreter (tests;
        required for engine="kernel" off the GPU).
      gauss_params / gauss_values: gaussian-track emissions
        (models/gauss.py): values f32[B, L, G] with NaN missing.  Adds
        the per-state normal log-densities to obs and returns the
        posterior moment sums in EmStats.gauss_*.

    Returns:
      EmStats summed over the batch.
    """
    B, L, T = symbols.shape
    S = params.num_states
    lengths = jnp.full((B,), L) if lengths is None else lengths
    valid = jnp.arange(L)[None, :] < lengths[:, None]          # [B,L]
    if engine == "auto" and not matmul:
        engine = "xla"            # the broadcast-logsumexp parity path
    engine = gpu_kernels.select_engine("estep", S, engine, interpret)

    has_gauss = gauss_params is not None and gauss_values is not None
    obs = track_log_likelihoods(params.log_em, symbols)        # [B,L,S]
    if has_gauss:
        from tehmm_tpu.models.gauss import gauss_log_likelihoods

        obs = obs + gauss_log_likelihoods(gauss_params, gauss_values)
    if obs_weights is not None:
        obs = obs * obs_weights[:, :, None]
    if engine == "kernel":
        alpha_hat, _, loglik = gpu_kernels.forward_scaled(
            params.log_start, params.log_trans, obs, lengths,
            interpret=interpret,
        )
        beta_hat, _ = gpu_kernels.backward_scaled(
            params.log_trans, obs, lengths, interpret=interpret
        )
    else:
        alpha_hat, _, loglik = dp.forward_scaled(
            params.log_start, params.log_trans, obs, lengths,
            matmul=matmul,
        )
        beta_hat, _ = dp.backward_scaled(
            params.log_trans, obs, lengths, matmul=matmul
        )
    gamma = dp.posterior_scaled(alpha_hat, beta_hat)
    # ----- factored, per-step-normalized transition counts -----
    # For every (b, t):  xi[t,i,j] = a[i]·T[i,j]·b[j] / z[t]  with
    #   a[i] = exp(alpha_hat[t,i]),  b[j] = exp(obs[t+1,j]+
    #   beta_hat[t+1,j] − max_j(·)),  z[t] = Σ_ij a T b = (a@T)·b,
    # which is EXACT (Σ_ij xi[t] = 1 in exact math, so every
    # cumulative normalizer cancels per step) and keeps all factors
    # in [0, 1].  Then trans[i,j] = Σ_{b,t} xi = T ⊙ einsum(a/z, b)
    # — one [B·L, S] @ [S, B·L] contraction, no [L,S,S] materialized.
    a_fac = jnp.exp(alpha_hat[:, :-1, :])                      # <= 1
    bb = obs[:, 1:, :] + beta_hat[:, 1:, :]
    bb = bb - jnp.max(bb, axis=-1, keepdims=True)
    b_fac = jnp.exp(jnp.clip(bb, -_CLIP, _CLIP))               # <= 1

    gamma = gamma * valid[..., None]
    start = gamma[:, 0, :].sum(axis=0)
    trans_exp = jnp.exp(params.log_trans)
    aT = jnp.einsum(
        "bli,ij->blj", a_fac, trans_exp,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    z = jnp.sum(aT * b_fac, axis=-1)                           # [B,L-1]
    # transitions OUT of the last valid position don't exist
    valid_from = jnp.arange(L - 1)[None, :] < (lengths[:, None] - 1)
    w = jnp.where(valid_from, 1.0 / jnp.maximum(z, 1e-30), 0.0)
    pair = jnp.einsum(
        "bli,blj->ij", a_fac * w[..., None], b_fac,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    trans = pair * trans_exp

    gamma_w = gamma
    if obs_weights is not None:
        gamma_w = gamma * obs_weights[:, :, None]
    em = expected_emission_counts(
        params.log_em.shape, symbols, gamma_w, valid=None  # pre-masked
    )

    gauss_fields = {}
    if has_gauss:
        from tehmm_tpu.models.gauss import gauss_stats

        # segment mode: the likelihood raises the gaussian density to
        # the power w, so the matching Q-function maximizer weights the
        # moment sums by w as well (a segment stands for w positions) —
        # unweighted moments would break EM's monotone-loglik guarantee
        gn, gx, gx2 = gauss_stats(gamma_w, gauss_values)
        gauss_fields = dict(gauss_n=gn, gauss_x=gx, gauss_x2=gx2)

    return EmStats(
        start=start,
        trans=trans,
        em=em,
        loglik=loglik.sum(),
        n_obs=valid.sum().astype(jnp.float32),
        **gauss_fields,
    )


def _normalize_rows(counts: jax.Array, epsilon: float) -> jax.Array:
    smoothed = counts + epsilon
    probs = smoothed / smoothed.sum(axis=-1, keepdims=True)
    return jnp.log(jnp.maximum(probs, 1e-300)).astype(jnp.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ParamMasks:
    """Semi-supervised parameter pinning (reference: teHmmTrain.py
    --fixTrans / --fixEm / --forceTransProbs / --forceEmProbs; SURVEY.md
    §2b).  All fields optional (None == no constraint).

    fix_trans_rows: bool[S]   rows of log_trans frozen at their init values
    fix_em_states:  bool[S]   states whose emission tables are frozen
    force_trans:    f32[S,S]  entries >= 0 overwrite the trained matrix
                              (row renormalized over the free entries);
                              negative entries mean "free"
    force_em:       f32[S,T,V] same semantics for emissions
    """

    fix_trans_rows: jax.Array | None = None
    fix_em_states: jax.Array | None = None
    force_trans: jax.Array | None = None
    force_em: jax.Array | None = None


def _apply_force(log_p: jax.Array, force: jax.Array) -> jax.Array:
    """Overwrite entries where force >= 0 and renormalize the remaining
    (free) entries of each row to the leftover probability mass."""
    forced = force >= 0.0
    p = jnp.exp(log_p)
    forced_mass = jnp.sum(jnp.where(forced, force, 0.0), -1, keepdims=True)
    free_mass = jnp.sum(jnp.where(forced, 0.0, p), -1, keepdims=True)
    scale = jnp.where(
        free_mass > 0, (1.0 - forced_mass) / jnp.maximum(free_mass, 1e-300), 0.0
    )
    new_p = jnp.where(forced, force, p * scale)
    return jnp.log(jnp.maximum(new_p, 1e-300)).astype(jnp.float32)


def _apply_force_em(
    log_em: jax.Array, force: jax.Array, alphabet_sizes: jax.Array
) -> jax.Array:
    """Emission variant of _apply_force: only REAL symbols (1 <= v <
    alphabet size) participate — the missing column carries probability
    1.0 by convention and pads are inert, so including them in the free
    mass would corrupt the renormalization.  Output re-obeys the params
    conventions (missing col 0.0, pads 0.0)."""
    S, T, V = log_em.shape
    v_idx = jnp.arange(V)[None, :]
    sizes = jnp.asarray(alphabet_sizes)[:, None]
    real = ((v_idx >= 1) & (v_idx < sizes))[None]          # [1, T, V]
    forced = (force >= 0.0) & real
    p = jnp.where(real, jnp.exp(log_em), 0.0)
    forced_mass = jnp.sum(jnp.where(forced, force, 0.0), -1, keepdims=True)
    free_mass = jnp.sum(jnp.where(forced, 0.0, p), -1, keepdims=True)
    scale = jnp.where(
        free_mass > 0,
        (1.0 - forced_mass) / jnp.maximum(free_mass, 1e-300),
        0.0,
    )
    new_p = jnp.where(forced, force, p * scale)
    log_out = jnp.log(jnp.maximum(new_p, 1e-300)).astype(jnp.float32)
    return jnp.where(real, log_out, 0.0)


@partial(jax.jit, static_argnames=("epsilon",))
def em_m_step(
    stats: EmStats,
    old_params: HmmParams,
    alphabet_sizes: jax.Array,
    masks: ParamMasks | None = None,
    epsilon: float = EPSILON,
) -> HmmParams:
    """Counts -> new parameters (reference: basehmm M-step + hmm.py user
    priors).  ``old_params`` supplies the frozen rows for fix masks."""
    log_start = _normalize_rows(stats.start, epsilon)
    log_trans = _normalize_rows(stats.trans, epsilon)
    log_em = normalize_log_em(stats.em, alphabet_sizes, epsilon)

    if masks is not None:
        if masks.fix_trans_rows is not None:
            keep = masks.fix_trans_rows[:, None]
            log_trans = jnp.where(keep, old_params.log_trans, log_trans)
        if masks.fix_em_states is not None:
            keep = masks.fix_em_states[:, None, None]
            log_em = jnp.where(keep, old_params.log_em, log_em)
        if masks.force_trans is not None:
            log_trans = _apply_force(log_trans, masks.force_trans)
        if masks.force_em is not None:
            log_em = _apply_force_em(
                log_em, masks.force_em, alphabet_sizes
            )

    return HmmParams(
        log_start=log_start, log_trans=log_trans, log_em=log_em
    )


def em_step(
    params: HmmParams,
    symbols: jax.Array,
    alphabet_sizes: jax.Array,
    lengths: jax.Array | None = None,
    masks: ParamMasks | None = None,
    epsilon: float = EPSILON,
    matmul: bool = True,
    obs_weights: jax.Array | None = None,
) -> tuple[HmmParams, jax.Array]:
    """One full EM iteration on a single device. Returns (params, loglik)."""
    stats = em_sufficient_stats(
        params, symbols, lengths, matmul=matmul, obs_weights=obs_weights
    )
    new_params = em_m_step(stats, params, alphabet_sizes, masks, epsilon)
    return new_params, stats.loglik


# ---------------------------------------------------------------------------
# Supervised training (reference: hmm.py supervisedTrain — count transitions
# from labeled BED adjacency + emission symbol counts; no DP needed).
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("num_states", "epsilon"))
def supervised_counts(
    num_states: int,
    symbols: jax.Array,
    states: jax.Array,
    lengths: jax.Array | None = None,
    epsilon: float = EPSILON,
) -> EmStats:
    """Hard-count sufficient statistics from labeled data.

    Args:
      symbols: int[B, L, T]; states: int[B, L] gold state labels.
    """
    B, L, T = symbols.shape
    S = num_states
    lengths = jnp.full((B,), L) if lengths is None else lengths
    valid = jnp.arange(L)[None, :] < lengths[:, None]

    oh = jax.nn.one_hot(states, S, dtype=jnp.float32) * valid[..., None]
    start = oh[:, 0, :].sum(axis=0)
    # adjacency counting: trans[i,j] += [state_l==i][state_{l+1}==j]
    valid_pair = valid[:, 1:]
    trans = jnp.einsum(
        "bli,blj->ij", oh[:, :-1, :] * valid_pair[..., None], oh[:, 1:, :],
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return EmStats(
        start=start,
        trans=trans,
        em=jnp.zeros(()),  # filled by supervised_train wrapper
        loglik=jnp.zeros(()),
        n_obs=valid.sum().astype(jnp.float32),
    )


def supervised_train(
    num_states: int,
    alphabet_sizes,
    symbols: jax.Array,
    states: jax.Array,
    lengths: jax.Array | None = None,
    epsilon: float = EPSILON,
) -> HmmParams:
    """Full supervised training: count + normalize (reference:
    teHmmTrain.py --supervised)."""
    from tehmm_tpu.models.emission import supervised_emission_counts

    B, L, T = symbols.shape
    V = int(max(alphabet_sizes))
    lengths = jnp.full((B,), L) if lengths is None else lengths
    valid = (jnp.arange(L)[None, :] < lengths[:, None])

    stats = supervised_counts(num_states, symbols, states, lengths, epsilon)
    em = supervised_emission_counts(
        (num_states, T, V), symbols, states,
        valid=valid.astype(jnp.float32),
    )
    log_start = _normalize_rows(stats.start, epsilon)
    log_trans = _normalize_rows(stats.trans, epsilon)
    log_em = normalize_log_em(em, jnp.asarray(alphabet_sizes), epsilon)
    return HmmParams(log_start=log_start, log_trans=log_trans, log_em=log_em)


# ---------------------------------------------------------------------------
# Batched random restarts (reference: teHmmTrain.py --reps/--numThreads —
# the reference forks OS processes; here R restarts are ONE vmapped device
# program over stacked parameters, sharing the staged observations).
# ---------------------------------------------------------------------------

@jax.jit
def em_stats_reps(
    params_stack: HmmParams,
    symbols: jax.Array,
    lengths: jax.Array | None = None,
    obs_weights: jax.Array | None = None,
    gauss_params_stack=None,
    gauss_values: jax.Array | None = None,
) -> EmStats:
    """E-step for R stacked parameter sets over ONE shared batch.

    ``params_stack`` leaves (and ``gauss_params_stack``, when the model
    has gaussian tracks) carry a leading R axis; the observations and
    ``gauss_values`` do not.  Returns EmStats with leading R axis.  Uses
    the XLA engine: the vmapped scan batches the R restarts into
    [R·B, S] matmuls, which is exactly the large-batch regime the scan
    kernels like."""
    if gauss_params_stack is None:
        return jax.vmap(
            lambda p: em_sufficient_stats(
                p, symbols, lengths, obs_weights=obs_weights,
                engine="xla",
            )
        )(params_stack)
    return jax.vmap(
        lambda p, g: em_sufficient_stats(
            p, symbols, lengths, obs_weights=obs_weights,
            gauss_params=g, gauss_values=gauss_values, engine="xla",
        )
    )(params_stack, gauss_params_stack)


@partial(jax.jit, static_argnames=("epsilon",))
def em_m_step_reps(
    stats_stack: EmStats,
    params_stack: HmmParams,
    alphabet_sizes: jax.Array,
    masks: ParamMasks | None = None,
    epsilon: float = EPSILON,
) -> HmmParams:
    """M-step for R stacked stat/parameter sets (masks shared)."""
    return jax.vmap(
        lambda s, p: em_m_step(s, p, alphabet_sizes, masks, epsilon)
    )(stats_stack, params_stack)


@partial(
    jax.jit,
    static_argnames=("max_iterations", "epsilon", "matmul"),
)
def em_run(
    params: HmmParams,
    symbols: jax.Array,
    alphabet_sizes: jax.Array,
    lengths: jax.Array | None = None,
    max_iterations: int = 100,
    convergence_tol: float = 1e-3,
    masks: ParamMasks | None = None,
    epsilon: float = EPSILON,
    matmul: bool = True,
    obs_weights: jax.Array | None = None,
    gauss_params=None,
    gauss_values: jax.Array | None = None,
):
    """The ENTIRE EM training loop as one on-device ``lax.while_loop``.

    No host round-trip happens between iterations.  The while_loop
    blocks XLA's cross-iteration buffer donation, so each iteration can
    pay extra copies; the host-driven loop (models/hmm.fit) is the
    default.  Use this path when iterations are tiny relative to host
    latency or when a single dispatch per training run is operationally
    valuable; outputs are bit-identical to the host loop (tested).

    Returns (params, logliks f32[max_iterations] with NaN beyond the last
    executed iteration, n_iterations) — plus the final GaussParams when
    ``gauss_params`` is given (gaussian tracks, models/gauss.py).
    """
    sentinel = jnp.float32(-1e30)
    has_gauss = gauss_params is not None and gauss_values is not None

    def cond(carry):
        prev_ll, ll, it = carry[1], carry[2], carry[3]
        return (it < max_iterations) & (
            jnp.abs(ll - prev_ll) >= convergence_tol
        )

    def body(carry):
        p, _prev_ll, ll, it, hist = carry[:5]
        g = carry[5] if has_gauss else None
        stats = em_sufficient_stats(
            p, symbols, lengths, matmul=matmul, obs_weights=obs_weights,
            gauss_params=g, gauss_values=gauss_values if has_gauss
            else None,
        )
        new_p = em_m_step(stats, p, alphabet_sizes, masks, epsilon)
        hist = hist.at[it].set(stats.loglik)
        out = (new_p, ll, stats.loglik, it + 1, hist)
        if has_gauss:
            from tehmm_tpu.models.gauss import gauss_m_step

            out = out + (gauss_m_step(
                stats.gauss_n, stats.gauss_x, stats.gauss_x2, g,
                fix_states=getattr(masks, "fix_em_states", None)
                if masks is not None else None,
            ),)
        return out

    hist0 = jnp.full((max_iterations,), jnp.nan, jnp.float32)
    init = (params, sentinel, sentinel / 2, jnp.int32(0), hist0)
    if has_gauss:
        init = init + (gauss_params,)
    final = jax.lax.while_loop(cond, body, init)
    final_p, _prev, _ll, n_it, hist = final[:5]
    if has_gauss:
        return final_p, hist, n_it, final[5]
    return final_p, hist, n_it


@partial(jax.jit, static_argnames=("matmul",))
def em_epoch_scan(
    params: HmmParams,
    symbols_passes: jax.Array,
    lengths_passes: jax.Array,
    matmul: bool = True,
    obs_weights_passes: jax.Array | None = None,
) -> EmStats:
    """One E-step over MANY chunk batches in a single device dispatch.

    ``symbols_passes`` int[P, B, L, T] holds P pass-blocks (stage the
    whole dataset to HBM once); a ``lax.scan`` over the pass dimension
    accumulates EmStats without returning to the host, so an epoch of
    many passes costs one dispatch instead of one per pass.
    """
    S, T, V = params.log_em.shape

    zero = EmStats(
        start=jnp.zeros((S,), jnp.float32),
        trans=jnp.zeros((S, S), jnp.float32),
        em=jnp.zeros((S, T, V), jnp.float32),
        loglik=jnp.zeros((), jnp.float32),
        n_obs=jnp.zeros((), jnp.float32),
    )

    if obs_weights_passes is None:
        def body(acc, xs):
            sym, lens = xs
            stats = em_sufficient_stats(params, sym, lens, matmul=matmul)
            return acc + stats, None

        acc, _ = jax.lax.scan(
            body, zero, (symbols_passes, lengths_passes)
        )
    else:
        def body_w(acc, xs):
            sym, lens, w = xs
            stats = em_sufficient_stats(
                params, sym, lens, matmul=matmul, obs_weights=w
            )
            return acc + stats, None

        acc, _ = jax.lax.scan(
            body_w, zero,
            (symbols_passes, lengths_passes, obs_weights_passes),
        )
    return acc
