"""Baum-Welch EM tests vs. the NumPy oracle (SURVEY.md §4 test strategy)."""

import numpy as np
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.smoke

from tehmm_tpu import oracle
from tehmm_tpu.models.params import HmmParams
from tehmm_tpu.ops import em


def _to_params(log_start, log_trans, log_em):
    return HmmParams(
        log_start=jnp.asarray(log_start, jnp.float32),
        log_trans=jnp.asarray(log_trans, jnp.float32),
        log_em=jnp.asarray(log_em, jnp.float32),
    )


class TestSufficientStats:
    def _check(self, rng, make_hmm, S, T, V, L, **hmm_kw):
        log_start, log_trans, log_em = make_hmm(S, T, V, **hmm_kw)
        symbols = rng.randint(1, V, size=(L, T))
        obs = oracle.obs_log_likelihoods(log_em, symbols)
        want_start, want_trans, want_em, want_ll = oracle.baum_welch_counts(
            log_start, log_trans, obs, symbols, V
        )
        params = _to_params(log_start, log_trans, log_em)
        stats = em.em_sufficient_stats(params, jnp.asarray(symbols)[None])
        np.testing.assert_allclose(float(stats.loglik), want_ll, rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(stats.start), want_start, rtol=1e-3, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(stats.trans), want_trans, rtol=1e-3, atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(stats.em), want_em, rtol=1e-3, atol=1e-4
        )
        assert float(stats.n_obs) == L

    def test_matches_oracle(self, rng, make_hmm):
        self._check(rng, make_hmm, S=4, T=2, V=5, L=60)

    def test_matches_oracle_zero_transitions(self, rng, make_hmm):
        self._check(rng, make_hmm, S=5, T=2, V=4, L=80, zero_trans_frac=0.3)

    def test_batched_equals_sum_of_sequences(self, rng, make_hmm):
        S, T, V, L = 3, 2, 4, 40
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = _to_params(log_start, log_trans, log_em)
        seqs = [rng.randint(1, V, size=(L, T)) for _ in range(3)]
        batched = em.em_sufficient_stats(
            params, jnp.asarray(np.stack(seqs))
        )
        singles = [
            em.em_sufficient_stats(params, jnp.asarray(s)[None]) for s in seqs
        ]
        total_trans = sum(np.asarray(s.trans) for s in singles)
        np.testing.assert_allclose(
            np.asarray(batched.trans), total_trans, rtol=1e-4, atol=1e-5
        )
        np.testing.assert_allclose(
            float(batched.loglik),
            sum(float(s.loglik) for s in singles),
            rtol=1e-6,
        )

    def test_padding_excluded(self, rng, make_hmm):
        S, T, V, L = 3, 2, 4, 30
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = _to_params(log_start, log_trans, log_em)
        symbols = rng.randint(1, V, size=(L, T))
        full = em.em_sufficient_stats(params, jnp.asarray(symbols)[None])
        padded = np.concatenate(
            [symbols, rng.randint(1, V, size=(10, T))], axis=0
        )
        trimmed = em.em_sufficient_stats(
            params, jnp.asarray(padded)[None], jnp.asarray([L])
        )
        np.testing.assert_allclose(
            np.asarray(full.trans), np.asarray(trimmed.trans),
            rtol=1e-5, atol=1e-6,
        )
        np.testing.assert_allclose(
            float(full.loglik), float(trimmed.loglik), rtol=1e-6
        )
        assert float(trimmed.n_obs) == L

    def test_zero_length_rows_inert(self, rng, make_hmm):
        """All-padding rows (mesh row padding has length 0) contribute
        NOTHING — in particular not a LOG_ZERO per row to the loglik
        (regression) — on both the XLA and kernel engines."""
        S, T, V, L = 3, 2, 4, 30
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = _to_params(log_start, log_trans, log_em)
        symbols = rng.randint(1, V, size=(L, T))
        base = em.em_sufficient_stats(params, jnp.asarray(symbols)[None])
        padded = np.stack([symbols, np.zeros_like(symbols)])
        for engine in ("xla", "kernel"):
            got = em.em_sufficient_stats(
                params, jnp.asarray(padded), jnp.asarray([L, 0]),
                engine=engine, interpret=engine == "kernel",
            )
            np.testing.assert_allclose(
                float(base.loglik), float(got.loglik), rtol=1e-5,
                err_msg=engine,
            )
            np.testing.assert_allclose(
                np.asarray(base.trans), np.asarray(got.trans),
                rtol=1e-4, atol=1e-5, err_msg=engine,
            )
            assert float(got.n_obs) == L
            assert np.isfinite(np.asarray(got.em)).all(), engine


class TestEmIteration:
    def test_loglik_monotone(self, rng, make_hmm):
        """EM must be monotonically non-decreasing in data log-likelihood."""
        S, T, V, L = 4, 2, 5, 120
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = _to_params(log_start, log_trans, log_em)
        symbols = jnp.asarray(rng.randint(1, V, size=(2, L, T)))
        sizes = jnp.asarray([V] * T)
        lls = []
        for _ in range(8):
            params, ll = em.em_step(params, symbols, sizes)
            lls.append(float(ll))
        for a, b in zip(lls, lls[1:]):
            assert b >= a - 1e-3, lls

    def test_em_recovers_planted_structure(self, rng):
        """Two well-separated states: EM should find near-deterministic
        emissions from a flat-ish start."""
        L = 400
        true = (np.arange(L) // 50) % 2
        symbols = (true + 1)[:, None]  # track symbol = state + 1
        params = _to_params(
            np.log([0.5, 0.5]),
            np.log([[0.9, 0.1], [0.1, 0.9]]),
            np.log(
                np.array(
                    [[[1e-9, 0.6, 0.4]], [[1e-9, 0.4, 0.6]]]
                )
            ),
        )
        # enforce missing-symbol convention
        le = np.asarray(params.log_em).copy()
        le[:, :, 0] = 0.0
        params = _to_params(
            np.asarray(params.log_start), np.asarray(params.log_trans), le
        )
        sizes = jnp.asarray([3])
        sym = jnp.asarray(symbols)[None]
        for _ in range(30):
            params, ll = em.em_step(params, sym, sizes)
        emis = np.exp(np.asarray(params.log_em))
        # each state should emit "its" symbol with prob ~1
        assert emis[0, 0, 1] > 0.95 or emis[0, 0, 2] > 0.95
        assert emis[1, 0, 1] > 0.95 or emis[1, 0, 2] > 0.95


class TestMasks:
    def test_fix_trans_rows(self, rng, make_hmm):
        S, T, V, L = 3, 1, 4, 50
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = _to_params(log_start, log_trans, log_em)
        symbols = jnp.asarray(rng.randint(1, V, size=(1, L, T)))
        sizes = jnp.asarray([V])
        masks = em.ParamMasks(
            fix_trans_rows=jnp.asarray([True, False, False])
        )
        new_params, _ = em.em_step(params, symbols, sizes, masks=masks)
        np.testing.assert_array_equal(
            np.asarray(new_params.log_trans[0]), np.asarray(params.log_trans[0])
        )
        assert not np.allclose(
            np.asarray(new_params.log_trans[1]), np.asarray(params.log_trans[1])
        )

    def test_force_trans_probs(self, rng, make_hmm):
        S, T, V, L = 3, 1, 4, 50
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = _to_params(log_start, log_trans, log_em)
        symbols = jnp.asarray(rng.randint(1, V, size=(1, L, T)))
        sizes = jnp.asarray([V])
        force = np.full((S, S), -1.0, np.float32)
        force[0, 1] = 0.25
        masks = em.ParamMasks(force_trans=jnp.asarray(force))
        new_params, _ = em.em_step(params, symbols, sizes, masks=masks)
        trans = np.exp(np.asarray(new_params.log_trans))
        np.testing.assert_allclose(trans[0, 1], 0.25, rtol=1e-5)
        np.testing.assert_allclose(trans.sum(axis=1), np.ones(S), rtol=1e-5)


class TestSupervised:
    def test_counts_match_manual(self, rng):
        S, T, V, L = 3, 2, 4, 200
        states = rng.randint(0, S, size=(L,))
        symbols = rng.randint(1, V, size=(L, T))
        params = em.supervised_train(
            S, [V, V], jnp.asarray(symbols)[None], jnp.asarray(states)[None]
        )
        # manual transition frequencies
        counts = np.zeros((S, S))
        for a, b in zip(states[:-1], states[1:]):
            counts[a, b] += 1
        from tehmm_tpu.utils.common import EPSILON
        want = (counts + EPSILON) / (counts + EPSILON).sum(1, keepdims=True)
        np.testing.assert_allclose(
            np.exp(np.asarray(params.log_trans)), want, rtol=1e-4
        )
        # manual emission frequencies for state 0, track 0
        em_counts = np.zeros(V)
        for st, sy in zip(states, symbols[:, 0]):
            if st == 0:
                em_counts[sy] += 1
        want_em = (em_counts[1:] + EPSILON) / (em_counts[1:] + EPSILON).sum()
        np.testing.assert_allclose(
            np.exp(np.asarray(params.log_em[0, 0, 1:])), want_em, rtol=1e-4
        )
        # missing symbol column must be log-prob 0
        np.testing.assert_array_equal(
            np.asarray(params.log_em[:, :, 0]), np.zeros((S, T))
        )


class TestDeviceLoop:
    def test_em_run_matches_stepwise(self, rng, make_hmm):
        """The on-device while_loop must match the host-driven loop."""
        import jax.numpy as jnp

        S, T, V, L = 3, 1, 4, 100
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = _to_params(log_start, log_trans, log_em)
        symbols = jnp.asarray(rng.randint(1, V, size=(2, L, T)))
        sizes = jnp.asarray([V])
        n = 6
        p_dev, hist, n_it = em.em_run(
            params, symbols, sizes, max_iterations=n,
            convergence_tol=0.0,
        )
        p_host = params
        lls = []
        for _ in range(n):
            p_host, ll = em.em_step(p_host, symbols, sizes)
            lls.append(float(ll))
        assert int(n_it) == n
        np.testing.assert_allclose(
            np.asarray(hist)[:n], lls, rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(p_dev.log_trans), np.asarray(p_host.log_trans),
            rtol=1e-4, atol=1e-5,
        )

    def test_em_run_converges_early(self, rng, make_hmm):
        import jax.numpy as jnp

        S, T, V, L = 2, 1, 3, 60
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = _to_params(log_start, log_trans, log_em)
        symbols = jnp.asarray(rng.randint(1, V, size=(1, L, T)))
        sizes = jnp.asarray([V])
        _p, hist, n_it = em.em_run(
            params, symbols, sizes, max_iterations=100,
            convergence_tol=1.0,
        )
        n = int(n_it)
        assert n < 100
        assert np.isfinite(np.asarray(hist)[: n]).all()
        assert np.isnan(np.asarray(hist)[n:]).all()


class TestBatchedRestarts:
    """--reps as one vmapped device program (reference: teHmmTrain.py
    --reps/--numThreads; round-1 review item #6)."""

    def test_fit_restarts_matches_sequential(self, rng, make_hmm):
        from tehmm_tpu.io.trackdata import TrackTable
        from tehmm_tpu.models.hmm import MultitrackHmm, fit_restarts
        from tehmm_tpu.models.params import HmmParams as HP

        S, T, V, L = 3, 2, 5, 400
        sym = rng.randint(1, V, size=(L, T)).astype(np.int32)
        tab = TrackTable(chrom="chr1", start=0, end=L, symbols=sym)

        class _Hmm(MultitrackHmm):
            @property
            def alphabet_sizes(self):
                return [V] * T

        def mk(seed):
            ls, lt, lem = random_hmm_seeded(seed, S, T, V)
            params = HP(
                log_start=jnp.asarray(ls, jnp.float32),
                log_trans=jnp.asarray(lt, jnp.float32),
                log_em=jnp.asarray(lem, jnp.float32),
            )
            return _Hmm(params, None, None,
                        [str(i) for i in range(S)])

        seq_lls = []
        for seed in (0, 1):
            m = mk(seed)
            res = m.fit([tab], max_iterations=4, convergence_tol=0.0)
            seq_lls.append(res.logliks)

        models = [mk(0), mk(1)]
        best, results = fit_restarts(
            models, [tab], max_iterations=4, convergence_tol=0.0
        )
        for r in range(2):
            np.testing.assert_allclose(
                results[r].logliks, seq_lls[r], rtol=1e-5,
                err_msg=f"rep {r}",
            )
        finals = [res.logliks[-1] for res in results]
        assert best == int(np.argmax(finals))


def random_hmm_seeded(seed, S, T, V):
    from tests.conftest import random_hmm

    return random_hmm(np.random.RandomState(seed), S, T, V)
