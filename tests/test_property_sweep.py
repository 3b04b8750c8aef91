"""Randomized property sweep: DP and EM invariants across many random
models/datasets (seeded, deterministic).  A cheap fuzz layer on top of
the targeted oracle tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from tehmm_tpu import oracle
from tehmm_tpu.models.params import HmmParams
from tehmm_tpu.ops import dp, em
from tests.conftest import random_hmm


@pytest.fixture(scope="module", autouse=True)
def _fresh_executable_cache():
    """Full-suite runs SIGSEGV inside the XLA CPU compiler once enough
    executables have accumulated from earlier modules (see the in-test
    note below, and the same clear in tests/test_cfg_em.py).  Start
    this compile-heavy sweep from a clean slate."""
    import jax

    jax.clear_caches()
    yield


@pytest.mark.parametrize("seed", range(8))
def test_dp_invariants_random_model(seed):
    rng = np.random.RandomState(1000 + seed)
    S = rng.randint(2, 9)
    T = rng.randint(1, 4)
    V = rng.randint(3, 7)
    L = rng.randint(20, 120)
    zero_frac = float(rng.choice([0.0, 0.2, 0.4]))
    log_start, log_trans, log_em = random_hmm(
        rng, S, T, V, zero_trans_frac=zero_frac
    )
    symbols = rng.randint(1, V, size=(L, T))
    # sprinkle missing data
    missing = rng.rand(L, T) < 0.1
    symbols = np.where(missing, 0, symbols)
    obs64 = oracle.obs_log_likelihoods(log_em, symbols)

    ls = jnp.asarray(log_start, jnp.float32)
    lt = jnp.asarray(log_trans, jnp.float32)
    obs = jnp.asarray(obs64, jnp.float32)[None]

    # 1. loglik matches the float64 oracle
    _, ll = dp.forward(ls, lt, obs)
    _, want_ll = oracle.forward(log_start, log_trans, obs64)
    np.testing.assert_allclose(float(ll[0]), want_ll, rtol=1e-4)

    # 2. Viterbi path bit-matches the oracle and respects zero transitions
    path, score = dp.viterbi(ls, lt, obs)
    want_path, want_score = oracle.viterbi(log_start, log_trans, obs64)
    np.testing.assert_array_equal(np.asarray(path[0]), want_path)
    np.testing.assert_allclose(float(score[0]), want_score, rtol=1e-4)
    assert float(score[0]) <= float(ll[0]) + 1e-3

    # 3. posteriors sum to one
    ah, _, llx = dp.forward_scaled(ls, lt, obs)
    bh, _ = dp.backward_scaled(lt, obs)
    gamma = dp.posterior_scaled(ah, bh)
    np.testing.assert_allclose(
        np.asarray(gamma.sum(-1)[0]), np.ones(L), atol=1e-4
    )

    # 4. EM statistics match the oracle
    params = HmmParams(log_start=ls, log_trans=lt,
                       log_em=jnp.asarray(log_em, jnp.float32))
    stats = em.em_sufficient_stats(params, jnp.asarray(symbols)[None])
    w_start, w_trans, w_em, w_ll = oracle.baum_welch_counts(
        log_start, log_trans, obs64, symbols, V
    )
    np.testing.assert_allclose(
        np.asarray(stats.trans), w_trans, rtol=5e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(stats.em), w_em, rtol=5e-3, atol=1e-3
    )

    # 5. one EM step never decreases the likelihood
    sizes = jnp.asarray([V] * T)
    p2 = em.em_m_step(stats, params, sizes)
    stats2 = em.em_sufficient_stats(p2, jnp.asarray(symbols)[None])
    assert float(stats2.loglik) >= float(stats.loglik) - 1e-3


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("engine", ["xla", "kernel"])
def test_engine_invariants_random_model(engine, seed):
    """Every recurrence engine (the GPU kernels in interpret mode) across
    random models with random combinations of segment weights and
    gaussian tracks: the E-step log-likelihood and transition counts
    match the float64 oracle, every Viterbi path scores the oracle's
    optimum, and maxPost picks the oracle's argmax wherever it is
    decisive."""
    import jax

    from tehmm_tpu.models.emission import track_log_likelihoods
    from tehmm_tpu.parallel.stitch import _decode_batch, _posterior_batch

    # full-suite runs crash (SIGSEGV/SIGABRT) inside the XLA CPU
    # compile of interpret-mode kernels once many earlier tests have
    # filled jax's executable caches; the same compiles are rock solid
    # in isolation.  Dropping the accumulated executables before the
    # heavy compiles sidesteps the crash.
    if seed == 0:
        jax.clear_caches()
    eng = {"engine": engine}
    if engine == "kernel":
        eng["interpret"] = True

    rng = np.random.RandomState(2000 + seed)
    S = rng.randint(2, 24)
    T = rng.randint(1, 4)
    V = rng.randint(3, 7)
    L = rng.randint(10, 60)
    B = rng.randint(1, 5)
    log_start, log_trans, log_em = random_hmm(rng, S, T, V)
    params = HmmParams(
        log_start=jnp.asarray(log_start, jnp.float32),
        log_trans=jnp.asarray(log_trans, jnp.float32),
        log_em=jnp.asarray(log_em, jnp.float32),
    )
    sym_np = rng.randint(0, V, size=(B, L, T)).astype(np.int32)
    symbols = jnp.asarray(sym_np)
    lens_np = rng.randint(0, L + 1, size=B).astype(np.int32)
    lens_np[0] = L
    lengths = jnp.asarray(lens_np, jnp.int32)

    w_np = None
    if rng.rand() < 0.5:
        w_np = rng.randint(1, 6, size=(B, L)).astype(np.float32)
    w = None if w_np is None else jnp.asarray(w_np)

    gp, v_np = None, None
    if rng.rand() < 0.5:
        from tehmm_tpu.models.gauss import GaussParams

        Gn = rng.randint(1, 3)
        v_np = rng.randn(B, L, Gn).astype(np.float32)
        v_np[rng.rand(B, L, Gn) < 0.15] = np.nan
        gp = GaussParams(
            mu=jnp.asarray(rng.randn(S, Gn).astype(np.float32)),
            log_var=jnp.asarray(
                np.log(0.3 + rng.rand(S, Gn).astype(np.float32))
            ),
        )
    vals = None if v_np is None else jnp.asarray(v_np)

    # the observation log-likelihoods every engine consumes, in float64
    obs = track_log_likelihoods(params.log_em, symbols)
    if gp is not None:
        from tehmm_tpu.models.gauss import gauss_log_likelihoods

        obs = obs + gauss_log_likelihoods(gp, vals)
    if w is not None:
        obs = obs * w[:, :, None]
    obs64 = np.asarray(obs, np.float64)

    stats = em.em_sufficient_stats(
        params, symbols, lengths, obs_weights=w, gauss_params=gp,
        gauss_values=vals, **eng,
    )
    vit = _decode_batch(params, sym_np, lens_np, B, w_np, gp, v_np, **eng)
    mp = _posterior_batch(params, sym_np, lens_np, B, gp, v_np, w_np,
                          **eng)

    want_ll, want_trans = 0.0, np.zeros((S, S))
    for b in range(B):
        n = lens_np[b]
        if n == 0:
            continue
        o = obs64[b, :n]
        _, tr, _, ll = oracle.baum_welch_counts(
            log_start, log_trans, o, sym_np[b, :n], V
        )
        want_ll, want_trans = want_ll + ll, want_trans + tr
        # Viterbi: the decoded path's own score is the optimum
        _, best = oracle.viterbi(log_start, log_trans, o)
        p = vit[b, :n]
        score = log_start[p[0]] + o[0, p[0]] + sum(
            log_trans[p[t - 1], p[t]] + o[t, p[t]] for t in range(1, n)
        )
        np.testing.assert_allclose(score, best, rtol=1e-5, atol=1e-3)
        # maxPost: the oracle argmax wherever the top two differ
        alpha, llo = oracle.forward(log_start, log_trans, o)
        gamma = oracle.posterior(
            alpha, oracle.backward(log_trans, o), llo
        )
        top2 = np.sort(gamma, axis=-1)[:, -2:]
        decisive = top2[:, 1] - top2[:, 0] > 1e-3
        np.testing.assert_array_equal(
            mp[b, :n][decisive], gamma.argmax(-1)[decisive]
        )
    np.testing.assert_allclose(float(stats.loglik), want_ll,
                               rtol=2e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(stats.trans), want_trans,
                               rtol=5e-3, atol=1e-3)


@pytest.mark.parametrize("seed", range(6))
def test_cfg_invariants_random_model(seed):
    """Pair-grammar inside-outside invariants across random models —
    including structural-zero transitions and missing symbols, which
    stress the prob-space _logmatmulexp contractions' LOG_ZERO handling
    (models/cfg._logmatmulexp dynamic-range contract).  Tiny seeds also
    cross-check the full chart pipeline against the brute-force parse
    enumerator."""
    from tehmm_tpu.models.cfg import cfg_inside_loglik, make_cfg_params
    from tehmm_tpu.models.cfg_em import cfg_em_stats
    from tehmm_tpu.models.emission import track_log_likelihoods
    from tests.test_cfg_em import _brute_counts

    rng = np.random.RandomState(3000 + seed)
    S = rng.randint(2, 7)
    T = rng.randint(1, 4)
    V = rng.randint(3, 7)
    L = int(rng.choice([6, 7, 24, 48, 96]))
    zero_frac = float(rng.choice([0.0, 0.3]))
    log_start, log_trans, log_em = random_hmm(
        rng, S, T, V, zero_trans_frac=zero_frac
    )
    symbols = rng.randint(1, V, size=(L, T))
    symbols = np.where(rng.rand(L, T) < 0.15, 0, symbols)
    n_pair = rng.randint(1, S)
    pair_states = list(rng.choice(S, size=n_pair, replace=False))
    params = HmmParams(
        log_start=jnp.asarray(log_start, jnp.float32),
        log_trans=jnp.asarray(log_trans, jnp.float32),
        log_em=jnp.asarray(log_em, jnp.float32),
    )
    cfgp = make_cfg_params(
        params, [int(p) for p in pair_states],
        match_bonus=float(rng.uniform(0, 2)),
        sa_prior=float(rng.uniform(0.1, 0.9)),
    )
    sym_j = jnp.asarray(symbols, jnp.int32)
    obs = track_log_likelihoods(params.log_em, sym_j[None])[0]

    stats, gamma, e_m, e_t = cfg_em_stats(cfgp, obs, sym_j)
    gamma = np.asarray(gamma)

    # 1. per-position posteriors normalize; counts are non-negative
    np.testing.assert_allclose(gamma.sum(axis=1), 1.0, atol=1e-4)
    assert np.asarray(stats.trans).min() >= 0
    assert np.asarray(e_m).min() >= 0 and np.asarray(e_t).min() >= 0
    np.testing.assert_allclose(float(np.asarray(stats.start).sum()),
                               1.0, atol=1e-4)

    # 2. expected emission counts per track total the non-missing mass
    em_counts = np.asarray(stats.em)                     # [S, T, V]
    for t in range(T):
        want = float((symbols[:, t] > 0).sum())
        np.testing.assert_allclose(
            em_counts[:, t, 1:].sum(), want, rtol=1e-4, atol=1e-3
        )
        np.testing.assert_allclose(
            em_counts[:, t, 0].sum(), L - want, rtol=1e-4, atol=1e-3
        )

    # 3. the chart pipeline's Z equals the carry-only inside loglik
    #    (independent implementations: cfg_em.cfg_inside_chart vs
    #    cfg.cfg_inside_loglik)
    ll_carry = float(cfg_inside_loglik(cfgp, obs, sym_j, L))
    np.testing.assert_allclose(
        float(stats.loglik), ll_carry, rtol=1e-4, atol=1e-3
    )

    # 4. tiny lengths: exact vs the brute-force parse enumerator
    if L <= 7:
        Z_ref, g_ref, tr_ref, st_ref = _brute_counts(cfgp, obs, sym_j)
        np.testing.assert_allclose(float(stats.loglik), Z_ref, rtol=1e-4)
        np.testing.assert_allclose(gamma, g_ref, atol=1e-4)
        np.testing.assert_allclose(np.asarray(stats.trans), tr_ref,
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(stats.start), st_ref,
                                   atol=1e-4)
