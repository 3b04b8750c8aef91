"""Parallel-in-time HMM inference via associative scans.

SURVEY.md §5 "Long-context" and PAPERS.md "Temporal Parallelization of
Inference in Hidden Markov Models" (Särkkä & García-Fernández, 2021,
arXiv:2102.05743): the forward recursion is an associative composition of
per-step S×S operators

    a_t[i, j] = log_trans[i, j] + obs[t, j]        (t >= 1)
    a_0[i, j] = log_start[j]    + obs[0, j]        (rows identical)

under log-matmul-exp ``(a ⊗ b)[i,j] = LSE_k a[i,k] + b[k,j]``;
``jax.lax.associative_scan`` evaluates all prefixes in O(log L) depth
with S×S matrix products — matrix-unit work instead of a latency-bound
sequential scan.  The max-plus semiring gives the Viterbi analogue.

Trade-off: ~2·L·S³ FLOPs total vs the sequential scan's L·S² per batch
row — a win when the batch is too small to hide the sequential scan's
per-step latency (few long chromosomes), and the basis for multi-chip
sequence parallelism (compose per-chunk operators across devices).
The sequential kernels in ops/dp.py remain the default for wide batches.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from tehmm_tpu.utils.common import LOG_ZERO


def _log_matmul_exp(a: jax.Array, b: jax.Array) -> jax.Array:
    """(... , S, S) ⊗ (..., S, S) in the (LSE, +) semiring, max-shifted
    per row/col pair for f32 safety."""
    am = jnp.max(a, axis=-1, keepdims=True)                  # [..., S, 1]
    bm = jnp.max(b, axis=-2, keepdims=True)                  # [..., 1, S]
    am = jnp.maximum(am, LOG_ZERO)
    bm = jnp.maximum(bm, LOG_ZERO)
    p = jnp.einsum(
        "...ik,...kj->...ij",
        jnp.exp(a - am), jnp.exp(b - bm),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.where(p > 0, jnp.log(p), LOG_ZERO) + am + bm


def _max_plus_matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """(..., S, S) ⊗ (..., S, S) in the (max, +) semiring."""
    return jnp.max(a[..., :, :, None] + b[..., None, :, :], axis=-2)


def _elements(log_start, log_trans, obs):
    """Per-step operators a_t for obs [B, L, S] -> [B, L, S, S]."""
    B, L, S = obs.shape
    el = log_trans[None, None, :, :] + obs[:, :, None, :]    # [B,L,S,S]
    first = jnp.broadcast_to(
        (log_start[None, :] + obs[:, 0, :])[:, None, :], (B, S, S)
    )
    return el.at[:, 0].set(first)


@jax.jit
def forward_assoc(
    log_start: jax.Array,
    log_trans: jax.Array,
    obs: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """All-prefix forward pass, parallel in time.

    Returns (log_alpha[B, L, S], loglik[B]).  No variable-length masking:
    intended for fixed-length chunk batches (pad with obs rows of 0 and
    slice — a 0-obs row multiplies the operator by the transition matrix,
    so use exact lengths or the sequential kernel for ragged batches).
    """
    el = _elements(log_start, log_trans, obs)                # [B,L,S,S]
    pref = jax.lax.associative_scan(_log_matmul_exp, el, axis=1)
    log_alpha = pref[:, :, 0, :]                             # rows equal
    m = jnp.maximum(jnp.max(log_alpha[:, -1], -1, keepdims=True), LOG_ZERO)
    loglik = jnp.log(jnp.sum(jnp.exp(log_alpha[:, -1] - m), -1)) + m[:, 0]
    return log_alpha, loglik


@jax.jit
def viterbi_assoc(
    log_start: jax.Array,
    log_trans: jax.Array,
    obs: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Viterbi path, parallel in time (max-plus associative scan).

    The scan yields V_t[i, j] = best score of any path ending in state j
    at time t (identical rows for the prefix including a_0).  The path is
    recovered position-parallel: state_t = argmax_j (V_t[j] + η_t[j])
    where η_t[j] = best score from state j at time t to the end, from a
    reverse max-plus scan — no sequential backtrace at all.

    Tie-breaking caveat (stronger than "a different equal-scoring
    path"): the position-wise argmax decides each position
    INDEPENDENTLY, so under exact per-position score ties the returned
    states need not form a connected optimal path — e.g. with uniform
    obs and a transition matrix whose optimal paths are (0,1)/(1,0),
    the lowest-index rule can return (0,0), which traverses a forbidden
    transition while ``score`` still reports the true optimum.  Exact
    ties require exactly equal floats (missing-data stretches, degenerate
    hand-built models).  The production decoders (ops.dp.viterbi and the
    Pallas kernels) backtrace sequentially and never do this; use them
    whenever the path itself matters — this engine's argmax output is a
    research/throughput formulation.

    Returns (path int32[B, L], score f32[B]).
    """
    B, L, S = obs.shape
    el = _elements(log_start, log_trans, obs)
    pref = jax.lax.associative_scan(_max_plus_matmul, el, axis=1)
    v = pref[:, :, 0, :]                                     # [B,L,S]
    score = jnp.max(v[:, -1], axis=-1)

    # reverse suffix operators: b_t = a_{t+1} ⊗ ... (exclusive suffix);
    # eta_t[j] = max over paths j -> end = max_k suffix_t[j, k]
    rev = jnp.flip(jnp.swapaxes(el, -1, -2), axis=1)         # transpose ops
    suf = jax.lax.associative_scan(_max_plus_matmul, rev, axis=1)
    # suf[:, k] = a_L-1^T ⊗ ... ⊗ a_{L-1-k}^T ; eta for position t uses
    # operators t+1..L-1 -> index k = L-2-t
    eta_rows = jnp.max(suf, axis=-2)                         # [B,L,S]
    eta = jnp.flip(eta_rows, axis=1)                         # eta[t] uses t..L-1
    # shift: position t needs suffix starting at t+1
    eta = jnp.concatenate(
        [eta[:, 1:], jnp.zeros((B, 1, S), obs.dtype)], axis=1
    )
    path = jnp.argmax(v + eta, axis=-1).astype(jnp.int32)
    return path, score
