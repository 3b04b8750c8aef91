"""MultitrackCfg: restricted stochastic context-free grammar over tracks.

Rebuild of the reference's CFG layer (reference: cfg.py `MultitrackCfg`
with `pairStates`, emission.py `PairEmissionModel`; SURVEY.md §2a): a
restricted SCFG generalizing the multi-track HMM so *paired elements*
(e.g. the two LTR ends of a retrotransposon, or TSD copies) can be
modeled with matched, nested left/right emissions.  With no pair states
the grammar reduces exactly to the HMM (tested — the reference's own
equivalence test pattern, SURVEY.md §4).

Grammar (this rebuild's documented contract; the reference mount was
empty at survey time so the rule set is reconstructed [R?]):

  every state s:        s(i, j) -> x_i  s'(i+1, j)        left emission +
                                                          transition s->s'
  pair state p:         p(i, j) -> x_i  s'(i+1, j-1) x_j  joint pair
                                                          emission at both
                                                          ends + transition
  every state s:        s(i, i) -> x_i                    terminal

Scores are log-space; the single-position emission table is the HMM's
``log_em``; the pair emission adds the two end emissions plus a per-state
match bonus applied per track when the two ends carry the same symbol
(reference: PairEmissionModel "match/mismatch weighting").

DP: CYK over span diagonals d = j - i, each diagonal a [L-d, S] tensor
updated from the previous one (HMM-shaped max-plus/LSE batched matvec —
the same matmul pattern as ops/dp.py), under ``jax.lax.scan`` with a
fixed-width carry.  Complexity O(L · D · S²) with D = --maxSpan (TE
elements are bounded; full-triangle O(L²) available with D = L).

Viterbi traceback runs host-side over the device-computed argmax tables
(rule choice + next state per cell).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from tehmm_tpu.models.params import HmmParams
from tehmm_tpu.utils.common import LOG_ZERO


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CfgParams:
    """HMM parameters + pair-state extension.

    hmm:        the underlying HmmParams (log_start/log_trans/log_em).
    pair_mask:  bool[S] — True where the state is a pair state.
    log_match:  f32[S] per-track bonus added per track whose symbols at
                the two ends agree (0 for non-pair states).
    log_sa:     f32[2] rule-choice prior for pair states (reference:
                teHmmTrain --saPrior [R?], the self-alignment prior):
                [log(1-p), log(p)] added to the left-emit / pair rule
                respectively each time a pair state expands.  [0, 0]
                (no prior) when --saPrior is unset.
    """

    hmm: HmmParams
    pair_mask: jax.Array
    log_match: jax.Array
    log_sa: jax.Array


def make_cfg_params(
    hmm: HmmParams,
    pair_states: list[int],
    match_bonus: float = 0.0,
    log_match: np.ndarray | None = None,
    sa_prior: float | None = None,
) -> CfgParams:
    """``log_match`` (per-state learned weights, see
    ``estimate_match_bonus``) overrides the scalar ``match_bonus``.
    ``sa_prior`` in (0, 1) biases pair states toward the pair rule
    (p close to 1) or the left-emit rule (p close to 0); ``None``
    applies no prior."""
    S = hmm.num_states
    mask = np.zeros(S, bool)
    for s in pair_states:
        mask[s] = True
    if log_match is not None:
        bonus = np.where(mask, np.asarray(log_match, np.float32), 0.0)
        bonus = bonus.astype(np.float32)
    else:
        bonus = np.where(
            mask, np.float32(match_bonus), 0.0
        ).astype(np.float32)
    if sa_prior is None:
        log_sa = np.zeros(2, np.float32)
    else:
        p = float(sa_prior)
        if not 0.0 < p < 1.0:
            raise ValueError(f"--saPrior must be in (0, 1), got {p}")
        log_sa = np.log(np.asarray([1.0 - p, p], np.float32))
    return CfgParams(
        hmm=hmm,
        pair_mask=jnp.asarray(mask),
        log_match=jnp.asarray(bonus),
        log_sa=jnp.asarray(log_sa),
    )


def _logmatmulexp(x: jax.Array, prob_mat: jax.Array) -> jax.Array:
    """``log(exp(x) @ prob_mat)`` with a per-row max shift.

    The CFG recursions' per-diagonal ``LSE_k(x[i, k] + log_M[k or ·, ·])``
    contractions are [n, S]·[S, S] log-matmul-exps; materializing the
    [n, S, S] sum and reducing it elementwise is the O(S²)-per-cell cost
    that dominated the inside/outside passes.  Shifting each row by its
    max turns the contraction into one probability-space matmul
    (every addend <= 1, so no overflow; same max-shift recipe as the
    scaled HMM scans in ops/dp.py and the xi recombine below).

    x: [..., n, K] log values; prob_mat: f32[K, M] = exp(log_M) with
    entries in [0, 1].  Rows that are entirely LOG_ZERO stay ~LOG_ZERO
    (the shift cancels and the result is LOG_ZERO + log(rowsum)); rows
    whose image under prob_mat is structurally zero come out exactly
    LOG_ZERO.

    Dynamic-range contract (same as the scaled HMM scans in ops/dp.py):
    the shift is the ROW max of x, so a contribution more than ~87 nats
    (f32 exp underflow) below its row's max underflows to 0.  If the
    row-max entry cannot reach an output column at all (structural-zero
    transitions from fix/force priors or supervised counting) and the
    only reachable entry is that far down, the column collapses to
    LOG_ZERO where the old [n, S, S] per-(row, column)-shifted LSE kept
    it finite.  Such a parse is ~e^-87 of the dominant one; EM counts
    and posteriors are unaffected at f32, but a model whose ONLY legal
    parse sits that far down scores -inf — cfg_em_run warns when the
    total inside loglik collapses.
    """
    m = jnp.maximum(jnp.max(x, axis=-1, keepdims=True), LOG_ZERO)
    e = jnp.exp(x - m)
    y = jnp.einsum(
        "...nk,km->...nm", e, prob_mat,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.where(y > 0, jnp.log(jnp.maximum(y, 1e-38)) + m, LOG_ZERO)


def _pair_emission(
    params: CfgParams, obs: jax.Array, symbols: jax.Array,
    i: jax.Array, j: jax.Array,
) -> jax.Array:
    """log P(x_i, x_j | pair state) for all states: emission at both ends
    plus per-track match bonus (broadcast over the diagonal).

    Missing symbols (0) never count as a match — mirroring
    estimate_match_bonus, which masks them when counting agreement.
    (A sparse track's missing ends — or a gaussian track's all-missing
    symbols column — would otherwise earn the bonus at every
    position.)"""
    em_i = obs[i]                                   # [n, S]
    em_j = obs[j]
    same = (
        (symbols[i] == symbols[j])
        & (symbols[i] > 0) & (symbols[j] > 0)
    )                                               # [n, T]
    n_match = jnp.sum(same, axis=-1).astype(jnp.float32)  # [n]
    return em_i + em_j + n_match[:, None] * params.log_match[None, :]


@partial(jax.jit, static_argnames=("max_span",))
def cfg_viterbi_chart(
    params: CfgParams,
    obs: jax.Array,       # [L, S] single-position log-likelihoods
    symbols: jax.Array,   # [L, T]
    max_span: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Build the CYK Viterbi chart.

    Returns:
      scores:  f32[D, L, S]  best score of span [i, i+d] rooted at s
      ptr_s:   int32[D, L, S] best next state s'
      ptr_r:   int32[D, L, S] rule: 0 = left-emit, 1 = pair-emit
      (d indexes span length-1; entries beyond the sequence are LOG_ZERO)
    """
    L, S = obs.shape
    D = min(max_span, L)
    log_trans = params.hmm.log_trans
    neg = jnp.full((L, S), LOG_ZERO, obs.dtype)

    # d = 0 diagonal: terminal rule
    diag0 = obs                                            # [L, S]
    idx = jnp.arange(L)

    def step(carry, d):
        prev, prev2 = carry                                # [L,S] each
        # --- rule 0: s -> x_i s'(i+1, i+d) ---
        # child value at start i+1, span d-1: prev[i+1]
        child = jnp.concatenate([prev[1:], neg[:1]], axis=0)   # [L,S]
        cand = child[:, None, :] + log_trans[None, :, :]       # [L,S,S] (i, s, s')
        sa_left = jnp.where(params.pair_mask, params.log_sa[0], 0.0)
        r0_best = jnp.max(cand, axis=-1) + obs + sa_left[None, :]  # [L,S]
        r0_ptr = jnp.argmax(cand, axis=-1)
        # --- rule 1 (pair states): p -> x_i s'(i+1, i+d-1) x_{i+d} ---
        child2 = jnp.concatenate([prev2[1:], neg[:1]], axis=0) # start i+1, span d-2
        cand2 = child2[:, None, :] + log_trans[None, :, :]
        j_idx = jnp.minimum(idx + d, L - 1)
        pair_em = _pair_emission(params, obs, symbols, idx, j_idx)
        r1_best = jnp.max(cand2, axis=-1) + pair_em + params.log_sa[1]
        r1_ptr = jnp.argmax(cand2, axis=-1)
        r1_best = jnp.where(params.pair_mask[None, :], r1_best, LOG_ZERO)
        # d == 1 pair would need an empty inner span; disallow (pairs
        # must enclose at least one position)
        r1_best = jnp.where(d >= 2, r1_best, LOG_ZERO)

        use_pair = r1_best > r0_best
        best = jnp.where(use_pair, r1_best, r0_best)
        pdt = jnp.uint8 if S <= 255 else jnp.int32  # chart memory: D·L·S
        ptr_s = jnp.where(use_pair, r1_ptr, r0_ptr).astype(pdt)
        ptr_r = use_pair.astype(jnp.uint8)
        # mask spans that run off the end: start i valid iff i + d < L
        valid = (idx + d < L)[:, None]
        best = jnp.where(valid, best, LOG_ZERO)
        return (best, prev), (best, ptr_s, ptr_r)

    ds = jnp.arange(1, D)
    (_, _), (scores, ptr_s, ptr_r) = jax.lax.scan(
        step, (diag0, neg), ds, unroll=8
    )
    scores = jnp.concatenate([diag0[None], scores], axis=0)
    ptr_s = jnp.concatenate(
        [jnp.zeros((1, L, S), ptr_s.dtype), ptr_s], axis=0
    )
    ptr_r = jnp.concatenate(
        [jnp.zeros((1, L, S), ptr_r.dtype), ptr_r], axis=0
    )
    return scores, ptr_s, ptr_r


@partial(jax.jit, static_argnames=("max_span",))
def cfg_inside_loglik(
    params: CfgParams,
    obs: jax.Array,
    symbols: jax.Array,
    max_span: int,
) -> jax.Array:
    """Inside algorithm (LSE instead of max) -> total log-likelihood of
    the whole sequence spanning [0, L-1] from the start distribution.
    Requires max_span >= L to cover the root span.

    The per-diagonal child contractions run as probability-space
    matmuls (_logmatmulexp), not [L, S, S] elementwise reductions."""
    L, S = obs.shape
    D = min(max_span, L)
    trans_pT = jnp.exp(params.hmm.log_trans).T        # [s', s]
    neg = jnp.full((L, S), LOG_ZERO, obs.dtype)
    idx = jnp.arange(L)

    def step(carry, d):
        prev, prev2 = carry
        # both children shift left one position; one [2L, S] matmul
        # serves both rules' contractions
        children = jnp.concatenate(
            [prev[1:], neg[:1], prev2[1:], neg[:1]], axis=0
        )
        z = _logmatmulexp(children, trans_pT)
        sa_left = jnp.where(params.pair_mask, params.log_sa[0], 0.0)
        r0 = z[:L] + obs + sa_left[None, :]
        j_idx = jnp.minimum(idx + d, L - 1)
        pair_em = _pair_emission(params, obs, symbols, idx, j_idx)
        r1 = z[L:] + pair_em + params.log_sa[1]
        r1 = jnp.where(params.pair_mask[None, :], r1, LOG_ZERO)
        r1 = jnp.where(d >= 2, r1, LOG_ZERO)
        best = jnp.logaddexp(r0, r1)
        valid = (idx + d < L)[:, None]
        best = jnp.where(valid, best, LOG_ZERO)
        return (best, prev), None

    ds = jnp.arange(1, D)
    (final, _), _ = jax.lax.scan(step, (obs, neg), ds, unroll=8)
    root = final[0] + params.hmm.log_start          # span [0, L-1]
    m = jnp.maximum(jnp.max(root), LOG_ZERO)
    return jnp.log(jnp.sum(jnp.exp(root - m))) + m


# ---------------------------------------------------------------------
# pair-parameter training (reference: emission.py PairEmissionModel
# match/mismatch weighting + cfg.py supervised training [R?])
# ---------------------------------------------------------------------


def estimate_match_bonus(
    tables: "Sequence",
    states_per_table: "Sequence[np.ndarray]",
    pair_state_indices: "Sequence[int]",
    log_em: np.ndarray,
    num_states: int,
    max_bonus: float = 8.0,
    alphabet_sizes: "Sequence[int] | None" = None,
) -> np.ndarray:
    """Supervised estimation of the per-state match weight from labeled
    paths (reference: PairEmissionModel match/mismatch weighting fit by
    supervised counting [R?]).

    Within every maximal labeled run of a pair state, positions pair up
    symmetrically — (s+k, e-1-k), the grammar's own nesting — and the
    observed cross-track symbol agreement rate is counted.  The learned
    bonus is the log-odds ratio between the OBSERVED agreement and the
    CHANCE agreement implied by the state's (independently trained)
    emission distribution:

        log_match[s] = logit(p_observed) - logit(p_chance),
        p_chance(track) = sum_v P(v | s, track)^2  (non-missing v)

    so the pair emission ``em_i + em_j + n_match * log_match`` upweights
    parses exactly as much as the training data says matched ends are
    enriched over independence.  States with no (or degenerate) counts
    keep bonus 0.  Missing symbols (0) never count as matches.

    Returns f32[num_states] (0 for non-pair states)."""
    log_em = np.asarray(log_em, np.float64)
    S, T, V = log_em.shape
    out = np.zeros(num_states, np.float32)
    pair_set = set(int(i) for i in pair_state_indices)
    eps = 1e-9
    for p in pair_set:
        n_match = 0.0
        n_tot = 0.0
        for tab, states in zip(tables, states_per_table):
            sym = getattr(tab, "symbols", tab)
            runs = _state_runs(np.asarray(states), p)
            for s, e in runs:
                half = (e - s) // 2
                if half == 0:
                    continue
                left = sym[s : s + half]                  # [half, T]
                right = sym[e - half : e][::-1]
                both = (left > 0) & (right > 0)
                n_match += float(((left == right) & both).sum())
                n_tot += float(both.sum())
        if n_tot < 1:
            continue
        p_obs = min(max(n_match / n_tot, eps), 1 - eps)
        em_p = np.exp(log_em[p])                          # [T, V]
        em_p[:, 0] = 0.0
        if alphabet_sizes is not None:
            # pad columns beyond a track's alphabet are stored as
            # log-prob 0.0 (= probability 1!) by the params convention;
            # including them poisons the chance-agreement norm for any
            # track whose alphabet is smaller than V
            for t, size in enumerate(alphabet_sizes):
                em_p[t, int(size):] = 0.0
        norm = em_p.sum(axis=1, keepdims=True)
        # only tracks with real categorical mass can contribute
        # comparisons (n_match/n_tot above skip all-missing tracks the
        # same way); a gaussian track's all-missing column would
        # otherwise collapse to chance ~0 and inflate the bonus
        valid = norm[:, 0] > 1e-6
        if not valid.any():
            continue
        em_p = em_p / np.maximum(norm, eps)
        p_chance = float(np.mean(np.sum(em_p[valid] ** 2, axis=1)))
        p_chance = min(max(p_chance, eps), 1 - eps)
        bonus = (np.log(p_obs / (1 - p_obs))
                 - np.log(p_chance / (1 - p_chance)))
        out[p] = np.clip(bonus, -max_bonus, max_bonus)
    return out


def _state_runs(states: np.ndarray, s: int) -> list[tuple[int, int]]:
    """Maximal [start, end) runs where states == s."""
    hit = states == s
    if not hit.any():
        return []
    d = np.diff(hit.astype(np.int8))
    starts = list(np.where(d == 1)[0] + 1)
    ends = list(np.where(d == -1)[0] + 1)
    if hit[0]:
        starts.insert(0, 0)
    if hit[-1]:
        ends.append(len(states))
    return list(zip(starts, ends))


def fit_match_bonus(
    params: CfgParams,
    obs_list: "Sequence[jax.Array]",
    symbols_list: "Sequence[jax.Array]",
    max_span: int,
    candidates: "Sequence[float]" = (0.0, 0.5, 1.0, 2.0, 4.0),
    refine_rounds: int = 2,
) -> float:
    """Unsupervised fit of a SHARED match bonus: maximize the total
    inside log-likelihood over a coarse grid, then golden-style refine
    around the best point (the likelihood in w is smooth and unimodal in
    practice).  Every round's candidates are evaluated as ONE vmapped
    inside pass per table (the candidates differ only in the log_match
    vector), not one dispatch per (candidate, table).  This is the
    trainable counterpart of the reference's user-set match weighting
    (reference: teHmmTrain --cfg [R?])."""

    def batch_ll(ws: "list[float]") -> "list[float]":
        lm = jnp.where(
            params.pair_mask[None, :],
            jnp.asarray(ws, jnp.float32)[:, None], 0.0
        )                                                # [W, S]

        def one(log_match, obs, sym, span):
            p = CfgParams(
                hmm=params.hmm,
                pair_mask=params.pair_mask,
                log_match=log_match,
                log_sa=params.log_sa,
            )
            return cfg_inside_loglik(p, obs, sym, span)

        tot = np.zeros(len(ws))
        for obs, sym in zip(obs_list, symbols_list):
            span = min(max_span, obs.shape[0])
            tot += np.asarray(jax.vmap(
                one, in_axes=(0, None, None, None)
            )(lm, obs, sym, span))
        return [float(t) for t in tot]

    ws0 = [float(w) for w in candidates]
    scored = dict(zip(ws0, batch_ll(ws0)))
    for _ in range(refine_rounds):
        ws = sorted(scored)
        best = max(ws, key=lambda w: scored[w])
        i = ws.index(best)
        lo = ws[max(i - 1, 0)]
        hi = ws[min(i + 1, len(ws) - 1)]
        new = [
            w for w in (
                round((lo + best) / 2, 6), round((best + hi) / 2, 6)
            ) if w not in scored
        ]
        if new:
            scored.update(zip(new, batch_ll(new)))
    return max(scored, key=lambda w: scored[w])


def _cfg_traceback(
    scores: np.ndarray,
    ptr_s: np.ndarray,
    ptr_r: np.ndarray,
    log_start: np.ndarray,
    L: int,
) -> tuple[np.ndarray, float]:
    """Host-side chart traceback: assign each position the state that
    emitted it, rooted at the best start-weighted state over [0, L-1]."""
    root_scores = scores[L - 1, 0] + log_start
    state = int(np.argmax(root_scores))
    score = float(root_scores[state])

    path = np.zeros(L, dtype=np.int32)
    stack = [(0, L - 1, state)]
    while stack:
        i, j, s = stack.pop()
        d = j - i
        path[i] = s
        if d == 0:
            continue
        nxt = int(ptr_s[d, i, s])
        if ptr_r[d, i, s] == 1:      # pair rule: emits at i and j
            path[j] = s
            if d >= 2:
                stack.append((i + 1, j - 1, nxt))
        else:                         # left emission
            stack.append((i + 1, j, nxt))
    return path, score


def cfg_viterbi_decode(
    params: CfgParams,
    obs: jax.Array,
    symbols: jax.Array,
    max_span: int | None = None,
) -> tuple[np.ndarray, float]:
    """Full-sequence Viterbi parse -> per-position state path.

    The root is the best state over span [0, L-1] weighted by log_start
    (max_span must be >= L; use chunking for long sequences).  Host-side
    traceback assigns each position the state that emitted it.
    """
    L, S = obs.shape
    if max_span is None:
        max_span = L
    if max_span < L:
        raise ValueError(
            "cfg_viterbi_decode needs max_span >= L (chunk the input)"
        )
    scores, ptr_s, ptr_r = map(
        np.asarray, cfg_viterbi_chart(params, obs, symbols, max_span)
    )
    return _cfg_traceback(
        scores, ptr_s, ptr_r, np.asarray(params.hmm.log_start), L
    )


def _cfg_traceback_device(scores, ptr_s, ptr_r, log_start):
    """In-device chart traceback for ONE window.

    The grammar's two rules both advance the left edge by exactly one
    (left-emit: (i, j) -> (i+1, j); pair: (i, j) -> (i+1, j-1)), so
    the parse is a LINEAR walk with i == step index: a lax.scan over
    the pointer tables emits the left-edge state per step and scatters
    the pair-partner states afterwards.  Keeping the traceback on
    device means the O(W²·S) chart never crosses to the host — only
    the int32 path does (a host traceback would move ~6 MB of chart
    per 512-position window)."""
    D, W, S = scores.shape
    root_scores = scores[W - 1, 0] + log_start
    s0 = jnp.argmax(root_scores).astype(jnp.int32)
    score = root_scores[s0]

    def step(carry, t):
        j, s, done = carry
        d = j - t
        nxt = ptr_s[d, t, s].astype(jnp.int32)
        r = ptr_r[d, t, s]
        is_last = d == 0
        pair = (r == 1) & ~is_last & ~done
        pw_idx = jnp.where(pair, j, W)       # W -> dropped scatter
        j_next = jnp.where(pair, j - 1, j)
        s_next = jnp.where(is_last | done, s, nxt)
        return (
            (j_next, s_next, done | is_last),
            (s, pw_idx, s),
        )

    (_, _, _), (emit_s, pw_idx, pw_s) = jax.lax.scan(
        step, (jnp.int32(W - 1), s0, jnp.bool_(False)),
        jnp.arange(W, dtype=jnp.int32),
    )
    # every position is either a left-edge emission (index == step) or
    # some pair's right end — the scatter overwrites exactly the latter
    path = emit_s.astype(jnp.int32)
    path = path.at[pw_idx].set(pw_s.astype(jnp.int32), mode="drop")
    return path, score


@partial(jax.jit, static_argnames=("max_span",))
def _cfg_decode_batch(params, obs_wins, sym_wins, max_span):
    """vmapped CYK chart + in-device traceback over a batch of
    equal-length windows — ONE device dispatch for the whole pass
    instead of a Python loop of per-window dispatches with per-window
    chart transfers (the per-window loop and the host traceback were
    each slower by orders of magnitude on the accelerator this was
    first built for; not re-measured on the GPU)."""

    def one(o, sy):
        scores, ptr_s, ptr_r = cfg_viterbi_chart(
            params, o, sy, max_span
        )
        return _cfg_traceback_device(
            scores, ptr_s, ptr_r, params.hmm.log_start
        )

    return jax.vmap(one)(obs_wins, sym_wins)


def cfg_viterbi_decode_chunked(
    params: CfgParams,
    obs: jax.Array,
    symbols: jax.Array,
    max_span: int,
    halo: int = 128,
    max_halo: int | None = None,
    agree_frac: float = 0.5,
    strict: bool = False,
    mesh=None,
) -> tuple[np.ndarray, float]:
    """CYK decode of sequences LONGER than the chart budget.

    The sequence is cut into core windows stitched with the same
    halo-agreement machinery as the HMM Viterbi stitcher
    (parallel/stitch.py): each window of core C + 2·halo is parsed as an
    independent full-span CFG (window length <= max_span bounds the
    chart to O(max_span²·S)); neighboring windows overlap 2·halo around
    every boundary and must agree on a window centered there, else the
    halo doubles and the pass retries.  Pair brackets therefore live
    WITHIN a window span — the grammar's bounded-element premise
    (reference: cfg.py bounded TE elements [R?]; SURVEY.md §2a) — while
    unbounded background runs stitch exactly like the HMM case.

    Returns (path, score) where score sums the window root scores over
    cores (an upper-bound surrogate, printed nowhere; eval reports the
    HMM forward log-likelihood for CFG models)."""
    import logging

    logger = logging.getLogger("tehmm")
    L = obs.shape[0]
    if L <= max_span:
        return cfg_viterbi_decode(params, obs, symbols, max_span)
    if max_halo is None:
        max_halo = max_span // 4
    cur_halo = min(halo, max_halo)

    while True:
        core = max_span - 2 * cur_halo
        if core <= 0:
            raise ValueError(
                f"halo {cur_halo} leaves no core in max_span {max_span}"
            )
        n_win = -(-L // core)
        # uniform window length W: edge windows slide inward (L > W
        # here) so every window's chart has the same compiled shape
        # and the whole pass is ONE vmapped dispatch per group
        W = min(max_span, L)
        S = obs.shape[1]
        los = np.empty(n_win, np.int64)
        cores = []
        for k in range(n_win):
            c_lo, c_hi = k * core, min((k + 1) * core, L)
            los[k] = min(max(c_lo - cur_halo, 0), L - W)
            cores.append((c_lo, c_hi))
        idx = los[:, None] + np.arange(W)[None, :]         # [N, W]
        obs_wins = jnp.asarray(obs)[idx]                   # [N, W, S]
        sym_wins = jnp.asarray(symbols)[idx]               # [N, W, T]

        # group windows to bound the chart memory; FIXED group size
        # with padding so every group reuses one compiled (group, W)
        # shape.  Bytes per chart cell: f32 scores + ptr_s (uint8 up
        # to 255 states, int32 beyond — cfg_viterbi_chart's pdt) +
        # uint8 ptr_r.
        ptr_bytes = 4 if S > 255 else 1
        per_win = W * W * S * (4 + ptr_bytes + 1)
        # chart budget is PER DEVICE: a mesh shards the window axis, so
        # the dispatch group scales with the mesh size
        n_dev = 1
        if mesh is not None:
            n_dev = int(np.prod(list(mesh.shape.values())))
        group = max(1, (256 << 20) // max(per_win, 1)) * n_dev
        group = min(-(-n_win // n_dev) * n_dev, group)
        decoded = []
        score = 0.0
        for g0 in range(0, n_win, group):
            g1 = min(g0 + group, n_win)
            ow, sw = obs_wins[g0:g1], sym_wins[g0:g1]
            if g1 - g0 < group:   # pad with repeats of the last window
                pad = group - (g1 - g0)
                ow = jnp.concatenate(
                    [ow, jnp.repeat(ow[-1:], pad, axis=0)]
                )
                sw = jnp.concatenate(
                    [sw, jnp.repeat(sw[-1:], pad, axis=0)]
                )
            if mesh is not None:
                from tehmm_tpu.parallel.cfg_sharded import (
                    sharded_cfg_decode_group,
                )

                paths_g, scores_g = sharded_cfg_decode_group(
                    params, ow, sw, mesh, W
                )
            else:
                paths_g, scores_g = _cfg_decode_batch(params, ow, sw, W)
            paths_np = np.asarray(paths_g)
            scores_np = np.asarray(scores_g)
            for k in range(g0, g1):
                c_lo, c_hi = cores[k]
                lo = int(los[k])
                hi = lo + W
                decoded.append((lo, hi, c_lo, c_hi, paths_np[k - g0]))
                score += float(scores_np[k - g0]) \
                    * (c_hi - c_lo) / (hi - lo)

        ok = True
        w = max(1, int(cur_halo * agree_frac))
        for (lo_a, hi_a, _, ce_a, pa), (lo_b, hi_b, cs_b, _, pb) in zip(
            decoded[:-1], decoded[1:]
        ):
            x = ce_a  # == cs_b
            lo = max(x - w, lo_a, lo_b)
            hi = min(x + w, hi_a, hi_b)
            if lo >= hi:
                continue
            if not np.array_equal(
                pa[lo - lo_a : hi - lo_a], pb[lo - lo_b : hi - lo_b]
            ):
                ok = False
                break

        if ok or cur_halo * 2 > max_halo:
            if not ok:
                msg = (
                    f"cfg_viterbi_decode_chunked: boundary disagreement "
                    f"persists at halo={cur_halo} (max_span "
                    f"{max_span}); a pair bracket may straddle a window "
                    f"boundary — raise --maxSpan"
                )
                if strict:
                    raise RuntimeError(msg)
                logger.warning(msg)
            path = np.zeros(L, np.int32)
            for lo, hi, c_lo, c_hi, p in decoded:
                path[c_lo:c_hi] = p[c_lo - lo : c_hi - lo]
            return path, score
        cur_halo = min(cur_halo * 2, max_halo)
