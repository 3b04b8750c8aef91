"""Log-space HMM dynamic-programming kernels (forward/backward/Viterbi).

Accelerator rebuild of the reference's pure-NumPy DP loops (reference:
basehmm.py `_do_forward_pass` / `_do_backward_pass` / `_do_viterbi_pass`,
O(L·S²) Python loops; SURVEY.md §2a, §3.1–3.2).  Design:

* Time recurrence as ``jax.lax.scan`` with a ``[B, S]`` carry — the batch
  dimension B (parallel genome chunks) gives the device wide tiles.
* **Scaled scans**: the carry is a per-step max-normalized vector plus a
  scalar cumulative log-normalizer.  Unnormalized log-alpha grows as
  O(L·mean obs) (≈ -3700 at L=2048 already), so f32 rounding of the carry
  costs ~1% in posteriors by a few thousand positions; the scaled form
  keeps every per-position quantity O(1) and makes accuracy independent of
  sequence length — measured posterior row-sum error drops from ~1e-2 to
  ~1e-6 at L=2048.  The reference gets the same effect only by using
  float64 everywhere.
* Two math paths for the log-sum-exp contraction per step:
  - ``matmul=True`` (default): ``exp`` then a ``[B,S] @ [S,S]`` matmul
    against the probability-space transition matrix
    (``Precision.HIGHEST``: a reduced-precision default — TF32 on the
    GPU — costs ~2-3 digits per step and compounds over the scan).
  - ``matmul=False``: broadcast ``logsumexp`` over a ``[B,S,S]`` tensor —
    association order matches a NumPy oracle (parity path).
* Variable-length sequences: positions ``t >= length`` carry the DP state
  through unchanged, so padded batches give bit-identical results to
  per-sequence runs (tests assert this).
* Viterbi ties break toward the lowest state index (``argmax`` first-hit),
  matching NumPy semantics for bit-exact path parity (SURVEY.md §7 "Hard
  parts" #1).  The Viterbi carry is also max-rescaled so that state-score
  *differences* — which decide the path — are computed on O(1) floats.

All public functions take batch-major ``obs[B, L, S]`` and return
batch-major results; internally scans are time-major.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tehmm_tpu.utils.common import LOG_ZERO

# lax.scan unroll factor for every DP recurrence: each scan step is a few
# small kernels whose launch and loop overhead exceeds the step's useful
# work.  On an H100 (700 W) at B=2048, L=1024, unrolling 8 steps per loop
# iteration against 1 measured forward 8.8 vs 15.0 ms and Viterbi 8.9 vs
# 33.4 ms at S=20, and a full EM iteration 19.7 vs 40.3 ms (S=20/T=5),
# 24.1 vs 50.4 ms (S=40/T=15) and 27.2 vs 52.1 ms (S=64/T=15), with
# bit-identical results (same ops, same order).  The GPU kernels of
# ops/gpu_kernels.py replace these scans inside their state envelope.
_UNROLL = 8


def _logdot(x: jax.Array, log_mat: jax.Array, mat_exp: jax.Array,
            matmul: bool) -> jax.Array:
    """LSE_i(x[b,i] + log_mat[i,j]) for x [B,S] -> [B,S].

    ``mat_exp`` must equal exp(log_mat) (precomputed once per scan).
    ``x`` is assumed pre-normalized to max 0 (scaled scan), so exp is safe.
    """
    if matmul:
        p = jnp.exp(x)                                         # [B,S] <= 1
        s = jnp.dot(p, mat_exp, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
        return jnp.where(s > 0, jnp.log(s), LOG_ZERO)
    y = x[:, :, None] + log_mat[None, :, :]                    # [B,S,S]
    m = jnp.max(y, axis=1, keepdims=True)
    m_safe = jnp.maximum(m, LOG_ZERO)
    s = jnp.sum(jnp.exp(y - m_safe), axis=1)
    return jnp.where(s > 0, jnp.log(s), LOG_ZERO) + m_safe[:, 0, :]


def _renorm(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Split x[B,S] into (x - max, max); max clamped to stay finite."""
    m = jnp.maximum(jnp.max(x, axis=-1), LOG_ZERO)             # [B]
    return x - m[:, None], m


def _mask_carry(new: jax.Array, old: jax.Array, valid_t: jax.Array):
    """Carry ``old`` through for batch rows whose position t is padding."""
    return jnp.where(valid_t[:, None], new, old)


def _fwd_step(log_trans, trans_exp, lengths, matmul, emit):
    """The CANONICAL forward step — one op sequence shared by the
    monolithic scan (forward_scaled) and the chunk continuations
    (forward_final, forward_chunk_values).  Their documented
    bit-identity depends on every copy executing identical ops in
    identical order, so there is exactly one copy.

    emit: "both" -> (new_hat, dm); "dm" -> dm; "hat" -> new_hat."""

    def step(a_hat, xs):
        obs_row, t = xs
        new = _logdot(a_hat, log_trans, trans_exp, matmul) + obs_row
        new_hat, dm = _renorm(new)
        valid_t = t < lengths
        new_hat = _mask_carry(new_hat, a_hat, valid_t)
        if emit == "hat":
            return new_hat, new_hat
        dm = jnp.where(valid_t, dm, 0.0)
        if emit == "dm":
            return new_hat, dm
        return new_hat, (new_hat, dm)

    return step


def _bwd_step(log_trans_T, trans_exp_T, lengths, matmul, emit):
    """The canonical backward step shared by backward_scaled and
    backward_chunk_values (same bit-identity contract as _fwd_step).

    emit: "both" -> (new_hat, dm); "hat" -> new_hat."""

    def step(b_hat, xs):
        obs_next, t_next = xs                              # position t+1
        x = obs_next + b_hat                               # [B,S]
        x_hat, xm = _renorm(x)
        new = _logdot(x_hat, log_trans_T, trans_exp_T, matmul)
        new_hat, nm = _renorm(new)
        valid_t = t_next < lengths
        new_hat = _mask_carry(new_hat, b_hat, valid_t)
        if emit == "hat":
            return new_hat, new_hat
        dm = jnp.where(valid_t, xm + nm, 0.0)
        return new_hat, (new_hat, dm)

    return step


def _maxplus_step(log_trans, lengths, emit):
    """The canonical max-plus step shared by viterbi_carry and
    viterbi_chunk_values (same bit-identity contract as _fwd_step).

    emit: "hat" -> new_hat; "none" -> None."""

    def step(v_hat, xs):
        obs_row, t = xs
        best = jnp.max(
            v_hat[:, :, None] + log_trans[None, :, :], axis=1
        )
        new_hat, _ = _renorm(best + obs_row)
        valid_t = t < lengths
        new_hat = _mask_carry(new_hat, v_hat, valid_t)
        return new_hat, (new_hat if emit == "hat" else None)

    return step


@partial(jax.jit, static_argnames=("matmul",))
def forward_scaled(
    log_start: jax.Array,
    log_trans: jax.Array,
    obs: jax.Array,
    lengths: jax.Array | None = None,
    matmul: bool = True,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Scaled forward pass (reference: basehmm.py `_do_forward_pass`).

    Args:
      log_start: f32[S]; log_trans: f32[S,S]; obs: f32[B,L,S];
      lengths: optional int[B] valid lengths (default: all L).

    Returns:
      (alpha_hat[B,L,S], log_c[B,L], loglik[B]) with
      ``log_alpha[b,t] = alpha_hat[b,t] + log_c[b,t]`` and every row of
      alpha_hat having max 0.
    """
    B, L, S = obs.shape
    lengths = jnp.full((B,), L) if lengths is None else lengths
    obs_t = jnp.moveaxis(obs, 1, 0)                       # [L,B,S]
    trans_exp = jnp.exp(log_trans)

    a0 = log_start[None, :] + obs_t[0]
    a0 = jnp.where((lengths > 0)[:, None], a0, LOG_ZERO)
    a0_hat, c0 = _renorm(a0)

    step = _fwd_step(log_trans, trans_exp, lengths, matmul, "both")
    ts = jnp.arange(1, L)
    _, (a_hats, dms) = jax.lax.scan(step, a0_hat, (obs_t[1:], ts), unroll=_UNROLL)
    alpha_hat = jnp.concatenate([a0_hat[None], a_hats], axis=0)
    # Cumulative normalizers are derived OUTSIDE the scan: the loglik uses
    # a tree-order jnp.sum over the per-step increments (error O(log L))
    # instead of a sequentially accumulated carry (error O(L)).
    incs = jnp.concatenate([c0[None], dms], axis=0)       # [L,B]
    log_c = jnp.cumsum(incs, axis=0)
    final_hat = alpha_hat[-1]
    loglik = (
        jnp.log(jnp.sum(jnp.exp(final_hat), axis=-1)) + jnp.sum(incs, axis=0)
    )
    # empty sequences (length 0, e.g. mesh row padding) have loglik 0
    # (empty product), not the LOG_ZERO their masked init would imply
    loglik = jnp.where(lengths > 0, loglik, 0.0)
    return (
        jnp.moveaxis(alpha_hat, 0, 1),
        jnp.moveaxis(log_c, 0, 1),
        loglik,
    )


@partial(jax.jit, static_argnames=("matmul",))
def backward_scaled(
    log_trans: jax.Array,
    obs: jax.Array,
    lengths: jax.Array | None = None,
    matmul: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Scaled backward pass (reference: basehmm.py `_do_backward_pass`).

    Returns (beta_hat[B,L,S], log_d[B,L]) with
    ``log_beta[b,t] = beta_hat[b,t] + log_d[b,t]``; beta at the last valid
    position is exactly 0 (= beta_hat 0, log_d 0).
    """
    B, L, S = obs.shape
    lengths = jnp.full((B,), L) if lengths is None else lengths
    obs_t = jnp.moveaxis(obs, 1, 0)
    log_trans_T = log_trans.T
    trans_exp_T = jnp.exp(log_trans_T)
    # derive the init from obs (zeros_like keeps shard_map's varying-axis
    # type; a fresh jnp.zeros would be "unvarying" and fail scan typing)
    b_last = jnp.zeros_like(obs_t[0])
    d_last = jnp.zeros_like(obs_t[0, :, 0])

    step = _bwd_step(log_trans_T, trans_exp_T, lengths, matmul, "both")
    ts = jnp.arange(1, L)
    _, (b_hats, dms) = jax.lax.scan(
        step, b_last, (obs_t[1:], ts), reverse=True
    , unroll=_UNROLL)  # index k == position k, for k = 0..L-2
    beta_hat = jnp.concatenate([b_hats, b_last[None]], axis=0)
    # log_d[t] = sum of increments from the end down to t (reverse cumsum
    # outside the scan; see forward_scaled note on accumulation error).
    incs = jnp.concatenate([dms, d_last[None]], axis=0)    # [L,B]
    log_d = jnp.cumsum(incs[::-1], axis=0)[::-1]
    return jnp.moveaxis(beta_hat, 0, 1), jnp.moveaxis(log_d, 0, 1)


@partial(jax.jit, static_argnames=("matmul",))
def forward(
    log_start: jax.Array,
    log_trans: jax.Array,
    obs: jax.Array,
    lengths: jax.Array | None = None,
    matmul: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Unscaled-API forward: returns (log_alpha[B,L,S], loglik[B])."""
    alpha_hat, log_c, loglik = forward_scaled(
        log_start, log_trans, obs, lengths, matmul
    )
    return alpha_hat + log_c[:, :, None], loglik


@partial(jax.jit, static_argnames=("matmul",))
def backward(
    log_trans: jax.Array,
    obs: jax.Array,
    lengths: jax.Array | None = None,
    matmul: bool = True,
) -> jax.Array:
    """Unscaled-API backward: returns log_beta[B,L,S]."""
    beta_hat, log_d = backward_scaled(log_trans, obs, lengths, matmul)
    return beta_hat + log_d[:, :, None]


@jax.jit
def posterior_scaled(alpha_hat: jax.Array, beta_hat: jax.Array) -> jax.Array:
    """gamma from scaled quantities via per-position normalization.

    gamma[t] = alpha[t]·beta[t] / Σ_s alpha[t,s]·beta[t,s] exactly (each
    position's posterior sums to 1), so the cumulative normalizers and the
    total loglik cancel and never enter the computation — f32 accuracy is
    independent of sequence length.  (Accumulating the large log-scalars
    instead costs ~1% error by L=2048 and diverges by L=65536.)"""
    x = alpha_hat + beta_hat
    x = x - jnp.max(x, axis=-1, keepdims=True)
    p = jnp.exp(x)
    return p / jnp.sum(p, axis=-1, keepdims=True)


@jax.jit
def posterior(
    log_alpha: jax.Array, log_beta: jax.Array, loglik: jax.Array
) -> jax.Array:
    """gamma[b,l,s] = P(state_l = s | obs) (reference: basehmm posteriors)."""
    return jnp.exp(
        jnp.minimum(log_alpha + log_beta - loglik[:, None, None], 0.0)
    )


@jax.jit
def viterbi(
    log_start: jax.Array,
    log_trans: jax.Array,
    obs: jax.Array,
    lengths: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Max-plus Viterbi DP + backtrace (reference: basehmm.py
    `_do_viterbi_pass`).

    Ties break to the lowest state index (NumPy argmax first-hit), both in
    the per-step predecessor choice and the final state selection —
    required for bit-exact path parity with a NumPy implementation.  The
    value carry is max-rescaled every step so the score differences
    deciding the argmax stay O(1) regardless of L.

    Design note: no predecessor-pointer tables are materialized.  The
    forward pass stores only the max-normalized value rows; the backtrace
    recomputes ``argmax_i(v[t-1, i] + logT[i, state_t])`` from them — the
    same maximization a pointer table would cache, so the result is
    bit-identical, but the forward step drops its argmax/pointer stream
    (a per-row transition-column gather replaces it in the backtrace).

    Returns:
      (path int32[B, L], score f32[B]).  Entries at t >= length replicate
      the state at length-1 (callers slice to length).
    """
    B, L, S = obs.shape
    lengths = jnp.full((B,), L) if lengths is None else lengths
    obs_t = jnp.moveaxis(obs, 1, 0)
    trans_T = log_trans.T                                   # [j, i]

    v0 = log_start[None, :] + obs_t[0]
    v0_hat, m0 = _renorm(v0)

    if L == 1:
        # no transitions: the two scans below would disagree on their
        # leading axis (1 vs 0) and crash — the path is just the best
        # start-weighted state
        nonempty = lengths > 0
        score = jnp.where(nonempty, jnp.max(v0, axis=-1), 0.0)
        path = jnp.where(
            nonempty, jnp.argmax(v0, axis=-1).astype(jnp.int32), 0
        )
        return path[:, None], score

    def step(carry, xs):
        v_hat, m = carry
        obs_row, t = xs
        best = jnp.max(
            v_hat[:, :, None] + log_trans[None, :, :], axis=1
        )
        new_v = best + obs_row
        new_hat, dm = _renorm(new_v)
        valid_t = t < lengths
        new_hat = _mask_carry(new_hat, v_hat, valid_t)
        new_m = jnp.where(valid_t, m + dm, m)
        return (new_hat, new_m), new_hat

    ts = jnp.arange(1, L)
    (v_final, m), v_hats = jax.lax.scan(
        step, (v0_hat, m0), (obs_t[1:], ts)
    , unroll=_UNROLL)  # v_hats[k] == values at position k+1
    score = jnp.max(v_final, axis=-1) + m                   # [B]
    last_state = jnp.argmax(v_final, axis=-1).astype(jnp.int32)

    v_prev_rows = jnp.concatenate([v0_hat[None], v_hats[:-1]], axis=0)

    def back(state, xs):
        v_prev, t = xs                                      # values at t-1
        col = trans_T[state]                                # [B, S]
        prev = jnp.argmax(v_prev + col, axis=-1).astype(jnp.int32)
        valid_t = t < lengths
        prev = jnp.where(valid_t, prev, state)
        return prev, state

    first_state, states = jax.lax.scan(
        back, last_state, (v_prev_rows, ts), reverse=True
    , unroll=_UNROLL)
    path = jnp.concatenate([first_state[None], states], axis=0)  # [L,B]
    # zero-length rows: empty product — score 0, path 0 (matching
    # forward_scaled's lengths>0 guard and ops/gpu_kernels.viterbi)
    nonempty = lengths > 0
    score = jnp.where(nonempty, score, 0.0)
    path = jnp.where(nonempty[None, :], path, 0)
    return jnp.moveaxis(path, 0, 1), score


@partial(jax.jit, static_argnames=("matmul",))
def forward_final(
    log_trans: jax.Array,
    obs: jax.Array,
    alpha_hat_init: jax.Array,
    lengths: jax.Array | None = None,
    matmul: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Forward pass continuation for streaming whole-chromosome
    likelihoods (SURVEY.md §5 "forward ... across chunk boundaries via
    carried alpha — exact, sequential in chunk index").

    Consumes an incoming normalized alpha carry and a chunk of
    observations; every position of this chunk applies a transition
    first (the carry is the previous chunk's last position).  Only the
    final carry and the summed normalizer increments are returned — no
    per-position output, so memory is O(B·S) regardless of chromosome
    length.

    Args:
      obs: f32[B, Lc, S] chunk observations.
      alpha_hat_init: f32[B, S] max-normalized carry from the previous
        chunk (for the first chunk use ``log_start[None] + obs[:, 0]``
        normalized, and pass obs[:, 1:]).
      lengths: optional int[B] valid positions within THIS chunk.

    Returns:
      (alpha_hat_final f32[B,S], dm_sum f32[B]) — accumulate dm_sum into
      the running log-normalizer; the total log-likelihood after the last
      chunk is ``dm_total + logsumexp(alpha_hat_final)``.
    """
    B, Lc, S = obs.shape
    lengths = jnp.full((B,), Lc) if lengths is None else lengths
    obs_t = jnp.moveaxis(obs, 1, 0)
    trans_exp = jnp.exp(log_trans)

    step = _fwd_step(log_trans, trans_exp, lengths, matmul, "dm")
    ts = jnp.arange(Lc)
    final_hat, dms = jax.lax.scan(step, alpha_hat_init, (obs_t, ts), unroll=_UNROLL)
    return final_hat, jnp.sum(dms, axis=0)


def streaming_loglik(
    log_start: jax.Array,
    log_trans: jax.Array,
    obs_chunks,
    lengths_per_chunk=None,
) -> jax.Array:
    """Exact log-likelihood of arbitrarily long sequences from an
    iterator of obs chunks (each f32[B, Lc, S]), O(B·S) device memory.

    ``lengths_per_chunk``: optional iterable of int[B] valid lengths
    aligned with the chunks (rows may end mid-stream).
    """
    it = iter(obs_chunks)
    lens_it = iter(lengths_per_chunk) if lengths_per_chunk is not None \
        else None
    first = next(it)
    lens0 = next(lens_it) if lens_it is not None else None
    B, Lc, S = first.shape
    a0 = log_start[None, :] + first[:, 0, :]
    row_lens = None
    if lens0 is not None:
        row_lens = jnp.asarray(lens0)
        a0 = jnp.where((row_lens > 0)[:, None], a0, LOG_ZERO)
    a_hat, m0 = _renorm(a0)
    rest_lens = None if lens0 is None else jnp.maximum(
        jnp.asarray(lens0) - 1, 0
    )
    a_hat, dm = forward_final(log_trans, first[:, 1:, :], a_hat, rest_lens)
    total = m0 + dm
    for chunk in it:
        lens = next(lens_it) if lens_it is not None else None
        if lens is not None:
            row_lens = row_lens + jnp.asarray(lens) \
                if row_lens is not None else jnp.asarray(lens)
        a_hat, dm = forward_final(
            log_trans, chunk, a_hat,
            None if lens is None else jnp.asarray(lens),
        )
        total = total + dm
    total = total + jnp.log(jnp.sum(jnp.exp(a_hat), axis=-1))
    if row_lens is not None:
        # zero-length rows: empty product — loglik 0, matching
        # forward_scaled's lengths>0 guard (the masked a0 would
        # otherwise leak its -1e30 normalizer into the total)
        total = jnp.where(row_lens > 0, total, 0.0)
    return total


# ---------------------------------------------------------------------
# exact chunked posteriors (checkpointed carries + per-chunk recompute)
#
# The op sequence inside these chunk continuations is IDENTICAL to the
# monolithic forward_scaled / backward_scaled scans (same per-step
# renormalizations in the same order), so recomputed alpha_hat/beta_hat
# — and therefore posterior argmax decisions — are bit-identical to a
# monolithic pass, with device memory bounded by one chunk
# (reference: teHmmEval.py --maxPost/--pd at genome scale; SURVEY.md §5
# long-context, §7 hard part #3).
# ---------------------------------------------------------------------

@partial(jax.jit, static_argnames=("matmul",))
def forward_chunk_values(
    log_trans: jax.Array,
    obs: jax.Array,
    a_hat_init: jax.Array,
    lengths: jax.Array | None = None,
    matmul: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Per-position scaled alphas of one chunk from its incoming carry.

    Every position of this chunk applies a transition first (the carry
    is the previous chunk's — or position 0's — alpha_hat).

    Returns (alpha_hats f32[B, Lc, S], final carry f32[B, S])."""
    B, Lc, S = obs.shape
    lengths = jnp.full((B,), Lc) if lengths is None else lengths
    obs_t = jnp.moveaxis(obs, 1, 0)
    trans_exp = jnp.exp(log_trans)

    step = _fwd_step(log_trans, trans_exp, lengths, matmul, "hat")
    ts = jnp.arange(Lc)
    final, a_hats = jax.lax.scan(
        step, a_hat_init, (obs_t, ts), unroll=_UNROLL
    )
    return jnp.moveaxis(a_hats, 0, 1), final


@partial(jax.jit, static_argnames=("matmul",))
def backward_chunk_values(
    log_trans: jax.Array,
    obs: jax.Array,
    x_carry: jax.Array,
    continuing: jax.Array,
    lengths: jax.Array | None = None,
    matmul: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Per-position scaled betas of one chunk from its incoming carry.

    Args:
      obs: f32[B, Lc, S] chunk observations.
      x_carry: f32[B, S] the max-normalized ``obs + beta`` row at the
        NEXT chunk's first position (the quantity backward_scaled
        renormalizes internally before each transition).
      continuing: bool[B] rows whose sequence extends past this chunk
        (rows that END inside the chunk init from beta = 0 at their last
        valid position instead, exactly like the monolithic scan).
      lengths: int[B] valid positions WITHIN this chunk.

    Returns (beta_hats f32[B, Lc, S], x_carry_out f32[B, S] for the
    previous chunk, computed at this chunk's first position)."""
    B, Lc, S = obs.shape
    lengths = jnp.full((B,), Lc) if lengths is None else lengths
    obs_t = jnp.moveaxis(obs, 1, 0)
    log_trans_T = log_trans.T
    trans_exp_T = jnp.exp(log_trans_T)

    b_cont = _renorm(
        _logdot(x_carry, log_trans_T, trans_exp_T, matmul)
    )[0]
    b_init = jnp.where(
        continuing[:, None], b_cont, jnp.zeros_like(b_cont)
    )

    step = _bwd_step(log_trans_T, trans_exp_T, lengths, matmul, "hat")
    ts = jnp.arange(1, Lc)
    _, b_hats = jax.lax.scan(
        step, b_init, (obs_t[1:], ts), reverse=True, unroll=_UNROLL
    )
    beta_hat = jnp.concatenate([b_hats, b_init[None]], axis=0)
    beta_hat = jnp.moveaxis(beta_hat, 0, 1)
    x_out = _renorm(obs[:, 0, :] + beta_hat[:, 0, :])[0]
    return beta_hat, x_out


# ---------------------------------------------------------------------
# exact chunked Viterbi (checkpointed carries + per-chunk recompute)
# ---------------------------------------------------------------------

@jax.jit
def viterbi_carry(
    log_trans: jax.Array,
    obs: jax.Array,
    v_hat_init: jax.Array,
    lengths: jax.Array | None = None,
) -> jax.Array:
    """Max-plus forward continuation: only the final carry is returned
    (the cheap first sweep of checkpointed Viterbi; SURVEY.md §7 hard
    part #3)."""
    B, Lc, S = obs.shape
    lengths = jnp.full((B,), Lc) if lengths is None else lengths
    obs_t = jnp.moveaxis(obs, 1, 0)

    step = _maxplus_step(log_trans, lengths, "none")
    ts = jnp.arange(Lc)
    final, _ = jax.lax.scan(step, v_hat_init, (obs_t, ts), unroll=_UNROLL)
    return final


@jax.jit
def viterbi_chunk_values(
    log_trans: jax.Array,
    obs: jax.Array,
    v_hat_init: jax.Array,
    lengths: jax.Array | None = None,
) -> jax.Array:
    """Recompute all per-position max-plus values of one chunk from its
    incoming carry (the backtrace sweep of checkpointed Viterbi).

    Returns v_hats f32[B, Lc, S]; row t holds the values AT chunk
    position t (position 0 already includes one transition from the
    carry)."""
    B, Lc, S = obs.shape
    lengths = jnp.full((B,), Lc) if lengths is None else lengths
    obs_t = jnp.moveaxis(obs, 1, 0)

    step = _maxplus_step(log_trans, lengths, "hat")
    ts = jnp.arange(Lc)
    _, v_hats = jax.lax.scan(step, v_hat_init, (obs_t, ts), unroll=_UNROLL)
    return jnp.moveaxis(v_hats, 0, 1)


@jax.jit
def viterbi_backtrace_chunk(
    log_trans: jax.Array,
    v_hats: jax.Array,       # [B, Lc, S] from viterbi_chunk_values
    v_carry_in: jax.Array,   # [B, S] carry that entered this chunk
    end_state: jax.Array,    # int32[B] state at the last valid position
    lengths: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Backtrace one chunk given its end state.

    Returns (path int32[B, Lc], entry_state int32[B]) where entry_state
    is the optimal state at the previous chunk's last position (computed
    against ``v_carry_in``)."""
    B, Lc, S = v_hats.shape
    lengths = jnp.full((B,), Lc) if lengths is None else lengths
    trans_T = log_trans.T
    # clamp the end state onto the last VALID position: positions beyond
    # length carry values through, so argmax rows there replicate
    v_prev_rows = jnp.concatenate(
        [v_carry_in[:, None, :], v_hats[:, :-1, :]], axis=1
    )                                            # value rows at t-1
    ts = jnp.arange(Lc)

    def back(state, xs):
        v_prev, t = xs                           # [B, S], scalar
        col = trans_T[state]
        prev = jnp.argmax(v_prev + col, axis=-1).astype(jnp.int32)
        valid_t = t < lengths
        prev = jnp.where(valid_t, prev, state)
        return prev, state

    v_prev_t = jnp.moveaxis(v_prev_rows, 1, 0)
    entry_state, states = jax.lax.scan(
        back, end_state, (v_prev_t, ts), reverse=True
    , unroll=_UNROLL)
    return jnp.moveaxis(states, 0, 1), entry_state
