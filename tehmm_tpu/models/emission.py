"""Independent multinomial (categorical) emission model — device ops.

Rebuild of the reference's ``IndependentMultinomialEmissionModel``
(reference: emission.py `allLogProbs`, `supervisedTrain`, `accumulateStats`,
`normalize`; SURVEY.md §2a).  The per-position observation log-likelihood

    obs[l, s] = sum_t log_em[s, t, x[l, t]]

is computed as a single one-hot × table matmul:

    onehot(x)[L, T*V] @ log_em.reshape(S, T*V).T  ->  [L, S]

The independence assumption (sum over tracks) is exactly the reference's.
Missing data (symbol 0) emits log-prob 0 by the conventions enforced in
``models.params`` so no masking is needed here.

A per-track table gather is the alternative formulation; it is not
offered here and has not been measured on the GPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tehmm_tpu.utils.common import EPSILON


def symbols_one_hot(symbols: jax.Array, max_symbols: int) -> jax.Array:
    """uint{8,16}[..., T] -> f32[..., T, V] one-hot."""
    return jax.nn.one_hot(symbols.astype(jnp.int32), max_symbols,
                          dtype=jnp.float32)


def track_log_likelihoods(log_em: jax.Array, symbols: jax.Array) -> jax.Array:
    """Observation log-likelihood matrix.

    Args:
      log_em: f32[S, T, V] emission table (params convention: missing symbol
        column is 0.0, pad symbols are 0.0 — inert under one-hot contraction).
      symbols: int[..., L, T] discretized per-position per-track symbols.

    Returns:
      f32[..., L, S]: summed per-state log-likelihood per position
      (reference: emission.py allLogProbs).
    """
    S, T, V = log_em.shape
    oh = symbols_one_hot(symbols, V)                     # [..., L, T, V]
    flat = oh.reshape(*oh.shape[:-2], T * V)             # [..., L, T*V]
    table = log_em.reshape(S, T * V)                     # [S, T*V]
    # HIGHEST keeps the contraction in true f32 (one-hot rows make it an
    # exact gather-sum; TF32 or bf16 passes would round the table).
    return jnp.einsum(
        "...lk,sk->...ls", flat, table,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def expected_emission_counts(
    log_em_shape: tuple[int, int, int],
    symbols: jax.Array,
    gamma: jax.Array,
    valid: jax.Array | None = None,
) -> jax.Array:
    """Posterior-weighted expected symbol counts for the EM M-step.

    counts[s, t, v] = sum_l gamma[l, s] * [x[l, t] == v]

    computed as gamma^T @ onehot — one [S, L] @ [L, T*V] matmul
    (reference: emission.py accumulateStats; SURVEY.md §2a).

    Args:
      symbols: int[..., L, T]; gamma: f32[..., L, S] posterior state probs;
      valid: optional bool/f32[..., L] mask (padding positions excluded).

    Returns:
      f32[S, T, V] counts summed over all leading batch dims.
    """
    S, T, V = log_em_shape
    oh = symbols_one_hot(symbols, V).reshape(*symbols.shape[:-1], T * V)
    if valid is not None:
        gamma = gamma * valid[..., None].astype(gamma.dtype)
    counts = jnp.einsum(
        "...ls,...lk->sk", gamma, oh, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return counts.reshape(S, T, V)


def supervised_emission_counts(
    log_em_shape: tuple[int, int, int],
    symbols: jax.Array,
    states: jax.Array,
    valid: jax.Array | None = None,
) -> jax.Array:
    """Hard-label symbol counts for supervised training
    (reference: emission.py supervisedTrain — count symbols under labeled
    intervals).  ``states`` is int[..., L]; equivalent to EM counts with a
    one-hot gamma."""
    S = log_em_shape[0]
    gamma = jax.nn.one_hot(states.astype(jnp.int32), S, dtype=jnp.float32)
    return expected_emission_counts(log_em_shape, symbols, gamma, valid)


def normalize_log_em(
    counts: jax.Array,
    alphabet_sizes: jax.Array,
    epsilon: float = EPSILON,
) -> jax.Array:
    """Counts -> normalized log emission table, with EPSILON pseudo-count
    smoothing over the *real* (non-missing, non-pad) symbols of each track
    (reference: emission.py normalize; SURVEY.md §2a).

    Args:
      counts: f32[S, T, V] expected symbol counts.
      alphabet_sizes: int[T] true alphabet size per track (incl. missing).

    Returns:
      f32[S, T, V] log_em obeying the params conventions (missing col = 0,
      pads = 0).
    """
    S, T, V = counts.shape
    v_idx = jnp.arange(V)[None, :]                        # [1, V]
    sizes = jnp.asarray(alphabet_sizes)[:, None]          # [T, 1]
    real = (v_idx >= 1) & (v_idx < sizes)                 # [T, V] bool
    realf = real.astype(jnp.float32)[None]                # [1, T, V]
    smoothed = (counts + epsilon) * realf
    denom = smoothed.sum(axis=2, keepdims=True)
    probs = smoothed / jnp.maximum(denom, 1e-300)
    log_em = jnp.where(realf > 0, jnp.log(jnp.maximum(probs, 1e-300)), 0.0)
    return log_em
