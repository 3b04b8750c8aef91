"""Gaussian (continuous-valued) track emissions.

Reference: track.py ``distribution="gaussian"`` [R?] — round 1 accepted
the attribute; binning the values into a multinomial loses them.  This
module implements REAL normal emissions: a
gaussian track contributes

    log N(x[l, g] | mu[s, g], var[s, g])

to the observation log-likelihood of every state instead of a
categorical term, with per-state mean/variance learned by EM
(posterior-weighted moments) or supervised counting.  Missing positions
(NaN values) contribute nothing — the same convention as the
categorical missing symbol 0.

Formulation: the per-position per-state log-density is a sum of three
``[B·L, G] @ [G, S]`` matmuls (coefficients of 1, x, x²), so no
``[B, L, S, G]`` tensor is ever materialized.  Gaussian tracks keep an all-missing symbols column so every
categorical code path (chunking, batching, engines) is untouched; the
values ride a parallel float matrix on the TrackTable.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

LOG_2PI = float(np.log(2.0 * np.pi))
MIN_VAR = 1e-4


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GaussParams:
    """Per-state normal emission parameters for the gaussian tracks.

    mu:      f32[S, G] means.
    log_var: f32[S, G] log variances (floored at MIN_VAR).
    """

    mu: jax.Array
    log_var: jax.Array

    @property
    def num_tracks(self) -> int:
        return self.mu.shape[1]


def init_gauss(
    num_states: int,
    values_list,
    seed: int = 0,
    spread: bool = True,
) -> GaussParams:
    """Initialize from data moments: state means spread across the
    empirical quantiles (breaks EM symmetry deterministically, like the
    reference's random emission init breaks categorical symmetry),
    variance = global variance."""
    allv = np.concatenate(
        [np.asarray(v, np.float32).reshape(-1, v.shape[-1])
         for v in values_list]
    )
    G = allv.shape[1]
    S = num_states
    mu = np.zeros((S, G), np.float32)
    var = np.ones((S, G), np.float32)
    rng = np.random.RandomState(seed)
    for g in range(G):
        col = allv[:, g]
        col = col[np.isfinite(col)]
        if len(col) == 0:
            continue
        v = max(float(col.var()), MIN_VAR)
        var[:, g] = v
        if spread and S > 1:
            qs = (np.arange(S) + 0.5) / S
            mu[:, g] = np.quantile(col, qs) + \
                rng.normal(0, np.sqrt(v) * 0.01, S)
        else:
            mu[:, g] = float(col.mean())
    return GaussParams(
        mu=jnp.asarray(mu), log_var=jnp.asarray(np.log(var))
    )


def _coeffs(params: GaussParams):
    """Quadratic-form coefficients: logN = c0 + c1*x + c2*x²."""
    var = jnp.exp(params.log_var)
    inv = 1.0 / var
    c2 = -0.5 * inv                                     # [S, G]
    c1 = params.mu * inv
    c0 = -0.5 * (params.mu**2 * inv + params.log_var + LOG_2PI)
    return c0, c1, c2


def gauss_log_likelihoods(
    params: GaussParams, values: jax.Array
) -> jax.Array:
    """Summed per-state log-density of the gaussian tracks.

    Args:
      values: f32[..., L, G]; NaN = missing (contributes 0).

    Returns:
      f32[..., L, S].
    """
    c0, c1, c2 = _coeffs(params)
    mask = jnp.isfinite(values).astype(jnp.float32)
    x = jnp.where(mask > 0, values, 0.0)
    # three [.., G] @ [G, S] contractions — no [.., S, G] intermediate.
    # HIGHEST precision: a reduced-precision default (TF32 on the GPU)
    # rounds the fixed coefficients identically at every position,
    # biasing the total log-likelihood systematically.
    kw = dict(precision=jax.lax.Precision.HIGHEST)
    return (
        jnp.matmul(mask, c0.T, **kw)
        + jnp.matmul(x * mask, c1.T, **kw)
        + jnp.matmul(x * x * mask, c2.T, **kw)
    )


def gauss_stats(gamma: jax.Array, values: jax.Array):
    """Posterior-weighted moments for the M-step.

    Args:
      gamma: f32[B, L, S] (already padding-masked).
      values: f32[B, L, G].

    Returns:
      (gn, gx, gx2) each f32[S, G].
    """
    mask = jnp.isfinite(values).astype(jnp.float32)
    x = jnp.where(mask > 0, values, 0.0)
    kw = dict(
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    gn = jnp.einsum("bls,blg->sg", gamma, mask, **kw)
    gx = jnp.einsum("bls,blg->sg", gamma, x * mask, **kw)
    gx2 = jnp.einsum("bls,blg->sg", gamma, x * x * mask, **kw)
    return gn, gx, gx2


def gauss_m_step(
    gn: jax.Array, gx: jax.Array, gx2: jax.Array,
    old: GaussParams, min_var: float = MIN_VAR,
    fix_states: jax.Array | None = None,
) -> GaussParams:
    """Moments -> new means/variances; states with (numerically) no
    posterior mass keep their previous parameters.

    ``fix_states`` (bool[S], from --fixEm) freezes those states'
    means/variances at their current values — gaussian-track normal
    parameters ARE emission parameters, so the fix-emissions contract
    must cover them exactly like the categorical log_em rows
    (ops/em.em_m_step's fix_em_states handling)."""
    ok = gn > 1e-6
    denom = jnp.maximum(gn, 1e-6)
    mu = jnp.where(ok, gx / denom, old.mu)
    var = jnp.where(
        ok, gx2 / denom - mu**2, jnp.exp(old.log_var)
    )
    var = jnp.maximum(var, min_var)
    if fix_states is not None:
        keep = fix_states[:, None]
        mu = jnp.where(keep, old.mu, mu)
        var = jnp.where(keep, jnp.exp(old.log_var), var)
    return GaussParams(mu=mu, log_var=jnp.log(var))


def supervised_gauss(
    num_states: int,
    values_list,
    states_list,
    min_var: float = MIN_VAR,
) -> GaussParams:
    """Hard-label moment estimation (reference: supervised counting).

    Unlabeled (-1) and NaN positions are excluded; states never seen
    with a finite value get the global moments."""
    allv = np.concatenate(
        [np.asarray(v, np.float32) for v in values_list]
    )
    alls = np.concatenate(
        [np.asarray(s, np.int64) for s in states_list]
    )
    G = allv.shape[1]
    S = num_states
    mu = np.zeros((S, G), np.float32)
    var = np.ones((S, G), np.float32)
    for g in range(G):
        col = allv[:, g]
        fin = np.isfinite(col)
        gcol = col[fin]
        gmu = float(gcol.mean()) if len(gcol) else 0.0
        gva = max(float(gcol.var()), min_var) if len(gcol) else 1.0
        for s in range(S):
            sel = fin & (alls == s)
            n = int(sel.sum())
            if n > 0:
                mu[s, g] = float(col[sel].mean())
                var[s, g] = max(float(col[sel].var()), min_var)
            else:
                mu[s, g] = gmu
                var[s, g] = gva
    return GaussParams(
        mu=jnp.asarray(mu), log_var=jnp.asarray(np.log(var))
    )
