"""NumPy float64 oracle implementations for golden testing.

The reference repo's math core is pure NumPy (reference: basehmm.py —
vendored pre-0.16 sklearn `hmm.py`; SURVEY.md §2a).  With the reference
mount empty (SURVEY.md provenance notice), this module serves as the
executable specification the device kernels are tested against, written in the
same straightforward O(L·S²) loop style the reference uses, plus the
brute-force all-paths enumerators the reference's own tests use as *their*
oracle (SURVEY.md §4: "validated against brute-force enumeration over all
state paths").

Everything here is float64 NumPy, deliberately slow, and never imported by
the production path.
"""

from __future__ import annotations

import itertools

import numpy as np

NEG = -1e30  # matches utils.common.LOG_ZERO


def logsumexp(a: np.ndarray, axis=None) -> np.ndarray:
    m = np.max(a, axis=axis, keepdims=True)
    m = np.maximum(m, NEG)
    out = np.log(np.sum(np.exp(a - m), axis=axis)) + np.squeeze(m, axis=axis)
    return out


def obs_log_likelihoods(log_em: np.ndarray, symbols: np.ndarray) -> np.ndarray:
    """obs[l,s] = sum_t log_em[s, t, x[l,t]] (reference: emission.allLogProbs)."""
    L, T = symbols.shape
    S = log_em.shape[0]
    obs = np.zeros((L, S))
    for l in range(L):
        for t in range(T):
            obs[l] += log_em[:, t, symbols[l, t]]
    return obs


def forward(log_start, log_trans, obs):
    L, S = obs.shape
    alpha = np.zeros((L, S))
    alpha[0] = log_start + obs[0]
    for t in range(1, L):
        for j in range(S):
            alpha[t, j] = logsumexp(alpha[t - 1] + log_trans[:, j], axis=0)
        alpha[t] += obs[t]
    return alpha, logsumexp(alpha[-1], axis=0)


def backward(log_trans, obs):
    L, S = obs.shape
    beta = np.zeros((L, S))
    for t in range(L - 2, -1, -1):
        for i in range(S):
            beta[t, i] = logsumexp(
                log_trans[i] + obs[t + 1] + beta[t + 1], axis=0
            )
    return beta


def viterbi(log_start, log_trans, obs):
    L, S = obs.shape
    v = np.zeros((L, S))
    ptr = np.zeros((L, S), dtype=np.int64)
    v[0] = log_start + obs[0]
    for t in range(1, L):
        scores = v[t - 1][:, None] + log_trans      # [i, j]
        ptr[t] = np.argmax(scores, axis=0)          # lowest-i tie break
        v[t] = np.max(scores, axis=0) + obs[t]
    path = np.zeros(L, dtype=np.int64)
    path[-1] = np.argmax(v[-1])
    for t in range(L - 2, -1, -1):
        path[t] = ptr[t + 1][path[t + 1]]
    return path, np.max(v[-1])


def posterior(log_alpha, log_beta, loglik):
    return np.exp(log_alpha + log_beta - loglik)


def brute_force_loglik(log_start, log_trans, obs):
    """Total likelihood by explicit enumeration of all S^L paths
    (the reference test pattern, SURVEY.md §4; use only for L,S tiny)."""
    L, S = obs.shape
    scores = []
    for path in itertools.product(range(S), repeat=L):
        s = log_start[path[0]] + obs[0, path[0]]
        for t in range(1, L):
            s += log_trans[path[t - 1], path[t]] + obs[t, path[t]]
        scores.append(s)
    return logsumexp(np.array(scores), axis=0)


def brute_force_viterbi(log_start, log_trans, obs):
    """Best path by enumeration.  Ties resolve to the path that is
    lexicographically smallest read RIGHT-TO-LEFT — exactly what
    backward backtracking with lowest-index argmax yields (dp.viterbi
    picks the lowest final state first, then the lowest predecessor at
    each earlier step), NOT the forward-lex smallest path."""
    L, S = obs.shape
    best, best_path = -np.inf, None
    for path in itertools.product(range(S), repeat=L):
        s = log_start[path[0]] + obs[0, path[0]]
        for t in range(1, L):
            s += log_trans[path[t - 1], path[t]] + obs[t, path[t]]
        if s > best + 1e-12:
            best, best_path = s, path
        elif s > best - 1e-12 and best_path is not None and (
            tuple(reversed(path)) < tuple(reversed(best_path))
        ):
            best_path = path
    return np.array(best_path), best


def baum_welch_counts(log_start, log_trans, obs, symbols, num_symbols):
    """One E-step's expected sufficient statistics (reference: basehmm.fit
    accumulation + emission.accumulateStats).

    Returns (start_counts[S], trans_counts[S,S], em_counts[S,T,V], loglik).
    """
    L, S = obs.shape
    T = symbols.shape[1]
    alpha, loglik = forward(log_start, log_trans, obs)
    beta = backward(log_trans, obs)
    gamma = posterior(alpha, beta, loglik)
    start_counts = gamma[0].copy()
    trans_counts = np.zeros((S, S))
    for t in range(L - 1):
        log_xi = (
            alpha[t][:, None]
            + log_trans
            + obs[t + 1][None, :]
            + beta[t + 1][None, :]
            - loglik
        )
        trans_counts += np.exp(log_xi)
    em_counts = np.zeros((S, T, num_symbols))
    for l in range(L):
        for tr in range(T):
            em_counts[:, tr, symbols[l, tr]] += gamma[l]
    return start_counts, trans_counts, em_counts, loglik
