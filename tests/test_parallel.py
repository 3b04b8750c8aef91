"""Chunk/halo stitching and multi-device (8 virtual CPU) EM tests.

SURVEY.md §4: the rebuild must add what the reference never had —
single-process multi-device tests via xla_force_host_platform_device_count
so DP/psum/stitching logic is testable without a pod.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tehmm_tpu import oracle
from tehmm_tpu.models.params import HmmParams
from tehmm_tpu.models.emission import track_log_likelihoods
from tehmm_tpu.ops import dp, em
from tehmm_tpu.parallel import (
    plan_chunks,
    batch_chunks,
    viterbi_chunked,
    make_data_mesh,
    sharded_em_stats,
    sharded_em_step,
)
from tehmm_tpu.parallel.chunking import pad_batch_rows


def _params(rng_hmm):
    log_start, log_trans, log_em = rng_hmm
    return HmmParams(
        log_start=jnp.asarray(log_start, jnp.float32),
        log_trans=jnp.asarray(log_trans, jnp.float32),
        log_em=jnp.asarray(log_em, jnp.float32),
    )


@pytest.mark.smoke
class TestChunkPlanning:
    def test_plan_covers_exactly(self):
        chunks = plan_chunks([1000, 500], chunk_len=300, halo=50)
        by_table = {}
        for c in chunks:
            by_table.setdefault(c.table_idx, []).append(c)
        assert [c.core_len for c in by_table[0]] == [300, 300, 300, 100]
        assert [c.core_len for c in by_table[1]] == [300, 200]
        # cores tile [0, L) without gap or overlap
        for idx, L in ((0, 1000), (1, 500)):
            pos = 0
            for c in by_table[idx]:
                assert c.core_start == pos
                pos = c.core_end
                assert c.load_start == max(0, c.core_start - 50)
                assert c.load_end == min(L, c.core_end + 50)
            assert pos == L

    def test_batch_padding(self):
        mats = [np.ones((100, 2), np.uint8) * 3]
        chunks = plan_chunks([100], chunk_len=40, halo=10)
        batch = batch_chunks(mats, chunks)
        assert batch.symbols.shape[0] == 3
        assert batch.lengths.tolist() == [50, 60, 30]
        assert batch.symbols[2, 30:, :].max() == 0  # pad symbol = missing

    def test_pad_batch_rows(self):
        mats = [np.ones((100, 1), np.uint8)]
        batch = batch_chunks(mats, plan_chunks([100], 40, 0))
        padded = pad_batch_rows(batch, 8)
        assert padded.symbols.shape[0] == 8
        assert padded.lengths[3:].tolist() == [0] * 5


@pytest.mark.smoke
class TestViterbiStitch:
    def _planted(self, rng, L):
        """Sticky 3-state chain so chunks 'forget' boundaries quickly."""
        lt = np.log(np.array(
            [[0.98, 0.01, 0.01], [0.02, 0.96, 0.02], [0.01, 0.01, 0.98]],
            np.float32))
        log_em = np.zeros((3, 1, 5), np.float32)
        probs = np.array([
            [0.7, 0.1, 0.1, 0.1],
            [0.1, 0.7, 0.1, 0.1],
            [0.1, 0.1, 0.1, 0.7],
        ])
        log_em[:, 0, 1:] = np.log(probs)
        params = HmmParams(
            log_start=jnp.asarray(np.log(np.full(3, 1 / 3, np.float32))),
            log_trans=jnp.asarray(lt),
            log_em=jnp.asarray(log_em),
        )
        true = np.zeros(L, int)
        s = 0
        tp = np.exp(lt).astype(np.float64)
        tp /= tp.sum(1, keepdims=True)
        for i in range(L):
            s = rng.choice(3, p=tp[s])
            true[i] = s
        sym = np.zeros((L, 1), np.uint8)
        for i in range(L):
            sym[i, 0] = (
                rng.choice(4, p=probs[true[i]]) + 1
            )
        return params, sym

    def test_chunked_equals_monolithic(self, rng):
        L = 5000
        params, sym = self._planted(rng, L)
        obs = track_log_likelihoods(params.log_em, jnp.asarray(sym))[None]
        mono, _ = dp.viterbi(params.log_start, params.log_trans, obs)
        mono = np.asarray(mono[0])
        paths, report = viterbi_chunked(
            params, [sym], chunk_len=512, halo=64, rows_per_pass=4
        )
        assert report.boundaries_ok
        np.testing.assert_array_equal(paths[0], mono)

    def test_multiple_tables(self, rng):
        params, sym1 = self._planted(rng, 1500)
        _, sym2 = self._planted(rng, 700)
        paths, report = viterbi_chunked(
            params, [sym1, sym2], chunk_len=256, halo=64, rows_per_pass=4
        )
        for sym, path in ((sym1, paths[0]), (sym2, paths[1])):
            obs = track_log_likelihoods(
                params.log_em, jnp.asarray(sym))[None]
            mono, _ = dp.viterbi(params.log_start, params.log_trans, obs)
            np.testing.assert_array_equal(path, np.asarray(mono[0]))

    def test_halo_widening_on_adversarial_ties(self, rng):
        """A near-uniform model gives long-range boundary dependence; the
        stitcher must detect disagreement and widen (or flag)."""
        S = 2
        lt = np.log(np.full((S, S), 0.5, np.float32))
        log_em = np.zeros((S, 1, 3), np.float32)
        log_em[:, 0, 1:] = np.log(
            np.array([[0.5001, 0.4999], [0.4999, 0.5001]])
        )
        params = HmmParams(
            log_start=jnp.asarray(np.log([0.5, 0.5]).astype(np.float32)),
            log_trans=jnp.asarray(lt),
            log_em=jnp.asarray(log_em),
        )
        sym = (rng.randint(0, 2, size=(800, 1)) + 1).astype(np.uint8)
        paths, report = viterbi_chunked(
            params, [sym], chunk_len=100, halo=8, max_halo=1024,
            rows_per_pass=4,
        )
        obs = track_log_likelihoods(params.log_em, jnp.asarray(sym))[None]
        mono, _ = dp.viterbi(params.log_start, params.log_trans, obs)
        # halo widening or the exact-decoder fallback: either way the
        # result must now equal the monolithic decode unconditionally
        assert report.boundaries_ok
        np.testing.assert_array_equal(paths[0], np.asarray(mono[0]))

    def test_targeted_widening_converges(self, rng):
        """Starting from a deliberately tiny halo, the TARGETED retry
        loop (round-3: only chunks adjacent to disagreeing boundaries
        re-decode at doubled halo; every boundary is checked, not just
        the first) must converge to the monolithic path without the
        exact fallback."""
        S = 3
        lt = np.full((S, S), 0.06, np.float32)
        np.fill_diagonal(lt, 0.88)
        log_em = np.zeros((S, 1, 4), np.float32)
        log_em[:, 0, 1:] = np.log(np.array(
            [[0.5, 0.3, 0.2], [0.3, 0.4, 0.3], [0.2, 0.3, 0.5]]
        ))
        params = HmmParams(
            log_start=jnp.asarray(
                np.log(np.full(S, 1 / 3)).astype(np.float32)
            ),
            log_trans=jnp.asarray(np.log(lt)),
            log_em=jnp.asarray(log_em),
        )
        sym = (rng.randint(0, 3, size=(3000, 1)) + 1).astype(np.uint8)
        paths, report = viterbi_chunked(
            params, [sym], chunk_len=100, halo=1, max_halo=256,
            rows_per_pass=8,
        )
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(sym)
        )[None]
        mono, _ = dp.viterbi(params.log_start, params.log_trans, obs)
        assert report.boundaries_ok and report.retries >= 1
        assert report.boundaries_checked == 29   # ALL internal bounds
        np.testing.assert_array_equal(paths[0], np.asarray(mono[0]))


class TestShardedEm:
    @pytest.fixture
    def mesh(self):
        assert jax.device_count() >= 8, "conftest should give 8 CPU devices"
        return make_data_mesh(8)

    def test_psum_matches_single_device(self, rng, make_hmm, mesh):
        S, T, V, L, B = 4, 2, 5, 64, 16
        params = _params(make_hmm(S, T, V))
        symbols = rng.randint(1, V, size=(B, L, T))
        lengths = np.full((B,), L, np.int32)
        lengths[-3:] = [20, 0, 55]  # ragged + empty rows
        want = em.em_sufficient_stats(
            params, jnp.asarray(symbols), jnp.asarray(lengths)
        )
        got = sharded_em_stats(
            params, jnp.asarray(symbols), jnp.asarray(lengths), mesh
        )
        for name in ("start", "trans", "em"):
            np.testing.assert_allclose(
                np.asarray(getattr(got, name)),
                np.asarray(getattr(want, name)),
                rtol=1e-5, atol=1e-6,
            )
        np.testing.assert_allclose(
            float(got.loglik), float(want.loglik), rtol=1e-6
        )
        assert float(got.n_obs) == float(want.n_obs)

    def test_sharded_em_step_improves_loglik(self, rng, make_hmm, mesh):
        S, T, V, L, B = 3, 1, 4, 128, 8
        params = _params(make_hmm(S, T, V))
        symbols = jnp.asarray(rng.randint(1, V, size=(B, L, T)))
        lengths = jnp.full((B,), L, dtype=jnp.int32)
        sizes = jnp.asarray([V])
        lls = []
        for _ in range(5):
            params, ll = sharded_em_step(
                params, symbols, lengths, sizes, mesh
            )
            lls.append(float(ll))
        for a, b in zip(lls, lls[1:]):
            assert b >= a - 1e-3 * abs(a), lls


class TestStateSharded:
    def test_forward_loglik_matches_replicated(self, rng, make_hmm):
        """2-D data x state mesh (SURVEY.md §2c TP row): sharding the
        transition columns must reproduce the replicated loglik."""
        from tehmm_tpu.parallel.mesh import make_data_state_mesh
        from tehmm_tpu.parallel.state_sharded import (
            forward_loglik_state_sharded,
        )

        S, T, V, L, B = 8, 2, 5, 40, 4
        log_start, log_trans, log_em = make_hmm(S, T, V)
        ls = jnp.asarray(log_start, jnp.float32)
        lt = jnp.asarray(log_trans, jnp.float32)
        obs = np.stack([
            oracle.obs_log_likelihoods(
                log_em, np.random.RandomState(i).randint(1, V, (L, T))
            )
            for i in range(B)
        ]).astype(np.float32)
        obs_j = jnp.asarray(obs)
        lens = jnp.asarray([L, L, 17, L])
        _, ll_ref = dp.forward(ls, lt, obs_j, lens)
        mesh = make_data_state_mesh(4)  # 2 data x 4 state on 8 devices
        ll = forward_loglik_state_sharded(ls, lt, obs_j, lens, mesh)
        np.testing.assert_allclose(
            np.asarray(ll), np.asarray(ll_ref), rtol=1e-5
        )

    def test_estep_matches_replicated(self, rng, make_hmm):
        """Full state-sharded E-step (obs matmul + scans + contractions
        on per-device state blocks) == replicated em_sufficient_stats
        (round-1 review item #7)."""
        from tehmm_tpu.parallel.mesh import make_data_state_mesh
        from tehmm_tpu.parallel.state_sharded import (
            em_stats_state_sharded,
        )

        S, T, V, L, B = 8, 2, 5, 60, 4
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = HmmParams(
            log_start=jnp.asarray(log_start, jnp.float32),
            log_trans=jnp.asarray(log_trans, jnp.float32),
            log_em=jnp.asarray(log_em, jnp.float32),
        )
        symbols = jnp.asarray(
            rng.randint(1, V, size=(B, L, T)), jnp.int32
        )
        lens = jnp.asarray([L, L, 23, 0])
        ref = em.em_sufficient_stats(
            params, symbols, lens, engine="xla"
        )
        mesh = make_data_state_mesh(4)
        got = em_stats_state_sharded(params, symbols, lens, mesh)
        np.testing.assert_allclose(
            float(got.loglik), float(ref.loglik), rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(got.start), np.asarray(ref.start),
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(got.trans), np.asarray(ref.trans),
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(got.em), np.asarray(ref.em),
            rtol=1e-4, atol=1e-4,
        )
        assert float(got.n_obs) == float(ref.n_obs)

    def test_viterbi_matches_replicated(self, rng, make_hmm):
        """State-sharded Viterbi paths are bit-identical to dp.viterbi
        (round-1 review item #7)."""
        from tehmm_tpu.parallel.mesh import make_data_state_mesh
        from tehmm_tpu.parallel.state_sharded import (
            viterbi_state_sharded,
        )

        S, T, V, L, B = 8, 2, 5, 80, 4
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = HmmParams(
            log_start=jnp.asarray(log_start, jnp.float32),
            log_trans=jnp.asarray(log_trans, jnp.float32),
            log_em=jnp.asarray(log_em, jnp.float32),
        )
        symbols = jnp.asarray(
            rng.randint(1, V, size=(B, L, T)), jnp.int32
        )
        lens = jnp.asarray([L, 31, L, 2])
        obs = track_log_likelihoods(params.log_em, symbols)
        path_ref, score_ref = dp.viterbi(
            params.log_start, params.log_trans, obs, lens
        )
        mesh = make_data_state_mesh(4)
        path, score = viterbi_state_sharded(
            params, symbols, lens, mesh
        )
        np.testing.assert_allclose(
            np.asarray(score), np.asarray(score_ref), rtol=1e-5,
            atol=1e-4,
        )
        for b in range(B):
            n = int(lens[b])
            np.testing.assert_array_equal(
                np.asarray(path)[b, :n], np.asarray(path_ref)[b, :n],
                err_msg=f"row {b}",
            )

    def test_zero_length_and_l1_parity(self, rng, make_hmm):
        """Mesh row padding (length 0) and single-position inputs must
        match the replicated kernels exactly: path 0 / score 0 /
        loglik 0 for empty rows, and no leading-axis crash at L == 1
        (round-3 review findings — the sharded copies had dropped
        dp.viterbi's L==1 guard and the lengths>0 guards)."""
        from tehmm_tpu.parallel.mesh import make_data_state_mesh
        from tehmm_tpu.parallel.state_sharded import (
            forward_loglik_state_sharded, viterbi_state_sharded,
        )

        S, T, V, B = 8, 2, 5, 4
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = HmmParams(
            log_start=jnp.asarray(log_start, jnp.float32),
            log_trans=jnp.asarray(log_trans, jnp.float32),
            log_em=jnp.asarray(log_em, jnp.float32),
        )
        mesh = make_data_state_mesh(4)
        for L, lens_np in ((1, [1, 0, 1, 0]), (12, [12, 0, 5, 0])):
            symbols = jnp.asarray(
                rng.randint(1, V, size=(B, L, T)), jnp.int32
            )
            lens = jnp.asarray(lens_np)
            obs = track_log_likelihoods(params.log_em, symbols)
            path_ref, score_ref = dp.viterbi(
                params.log_start, params.log_trans, obs, lens
            )
            path, score = viterbi_state_sharded(
                params, symbols, lens, mesh
            )
            np.testing.assert_allclose(
                np.asarray(score), np.asarray(score_ref),
                rtol=1e-5, atol=1e-4, err_msg=f"L={L}",
            )
            np.testing.assert_array_equal(
                np.asarray(path), np.asarray(path_ref),
                err_msg=f"L={L}",
            )
            assert float(np.asarray(score)[1]) == 0.0
            _, ll_ref = dp.forward(
                params.log_start, params.log_trans, obs, lens
            )
            ll = forward_loglik_state_sharded(
                params.log_start, params.log_trans, obs, lens, mesh
            )
            np.testing.assert_allclose(
                np.asarray(ll), np.asarray(ll_ref), rtol=1e-5,
                atol=1e-5, err_msg=f"L={L}",
            )
            assert float(np.asarray(ll)[1]) == 0.0

    def test_maxpost_and_posterior_match_replicated(self, rng, make_hmm):
        """State-sharded maxPost / posterior == the replicated XLA
        pipeline (every decode mode has a state-sharded twin).  Covers ragged lengths, L == 1, and
        zero-length mesh-padding rows."""
        from tehmm_tpu.parallel.mesh import make_data_state_mesh
        from tehmm_tpu.parallel.state_sharded import (
            maxpost_state_sharded, posterior_state_sharded,
        )

        S, T, V, B = 8, 2, 5, 4
        log_start, log_trans, log_em = make_hmm(S, T, V)
        params = HmmParams(
            log_start=jnp.asarray(log_start, jnp.float32),
            log_trans=jnp.asarray(log_trans, jnp.float32),
            log_em=jnp.asarray(log_em, jnp.float32),
        )
        mesh = make_data_state_mesh(4)
        for L, lens_np in ((80, [80, 31, 80, 2]), (1, [1, 0, 1, 0]),
                           (12, [12, 0, 5, 0])):
            symbols = jnp.asarray(
                rng.randint(1, V, size=(B, L, T)), jnp.int32
            )
            lens = jnp.asarray(lens_np)
            obs = track_log_likelihoods(params.log_em, symbols)
            ah, _, _ = dp.forward_scaled(
                params.log_start, params.log_trans, obs, lens
            )
            bh, _ = dp.backward_scaled(params.log_trans, obs, lens)
            gamma_ref = np.asarray(dp.posterior_scaled(ah, bh))
            path_ref = np.argmax(gamma_ref, axis=-1)

            path = np.asarray(
                maxpost_state_sharded(params, symbols, lens, mesh)
            )
            gamma = np.asarray(
                posterior_state_sharded(params, symbols, lens, mesh)
            )
            for b in range(B):
                n = int(lens[b])
                np.testing.assert_array_equal(
                    path[b, :n], path_ref[b, :n],
                    err_msg=f"L={L} row {b}",
                )
                np.testing.assert_allclose(
                    gamma[b, :n], gamma_ref[b, :n],
                    rtol=1e-4, atol=1e-5, err_msg=f"L={L} row {b}",
                )
                # invalid positions zeroed (documented convention)
                assert (path[b, n:] == 0).all()
                assert (gamma[b, n:] == 0).all()


class TestChunkedPosterior:
    def test_chunked_matches_monolithic(self, rng):
        """Chunked max-posterior decode == whole-sequence decode once the
        halo exceeds the posterior mixing range."""
        from tehmm_tpu.io.trackdata import TrackTable
        from tehmm_tpu.models.hmm import MultitrackHmm
        from tehmm_tpu.io.trackxml import TrackList, Track
        from tehmm_tpu.io.category import CategoryMap

        lt = np.log(np.array(
            [[0.97, 0.02, 0.01], [0.02, 0.96, 0.02], [0.01, 0.02, 0.97]],
            np.float32))
        log_em = np.zeros((3, 1, 5), np.float32)
        probs = np.array([
            [0.7, 0.1, 0.1, 0.1],
            [0.1, 0.7, 0.1, 0.1],
            [0.1, 0.1, 0.1, 0.7],
        ])
        log_em[:, 0, 1:] = np.log(probs)
        params = HmmParams(
            log_start=jnp.asarray(np.log(np.full(3, 1 / 3, np.float32))),
            log_trans=jnp.asarray(lt),
            log_em=jnp.asarray(log_em),
        )
        L = 3000
        sym = (rng.randint(0, 4, (L, 1)) + 1).astype(np.uint8)
        tl = TrackList()
        tl.add(Track(name="a", path="unused.bed"))
        cm = CategoryMap()
        for v in "1234":
            cm.get_map(v, update=True)
        model = MultitrackHmm(params, tl, {"a": cm}, ["x", "y", "z"])
        tab = TrackTable("chr1", 0, L, sym)
        mono = model.posterior_decode_tables(
            [tab], chunk_len=1 << 14
        )[0]
        chunked = model.posterior_decode_tables(
            [tab], chunk_len=400, halo=96, rows_per_pass=4
        )[0]
        np.testing.assert_array_equal(chunked, mono)


class TestViterbiExact:
    def test_exact_matches_monolithic_adversarial(self, rng):
        """The checkpointed exact decoder must equal monolithic Viterbi
        even on the near-uniform model where halo stitching struggles."""
        from tehmm_tpu.parallel.stitch import viterbi_exact

        S = 2
        lt = np.log(np.full((S, S), 0.5, np.float32))
        log_em = np.zeros((S, 1, 3), np.float32)
        log_em[:, 0, 1:] = np.log(
            np.array([[0.5001, 0.4999], [0.4999, 0.5001]])
        )
        params = HmmParams(
            log_start=jnp.asarray(np.log([0.5, 0.5]).astype(np.float32)),
            log_trans=jnp.asarray(lt),
            log_em=jnp.asarray(log_em),
        )
        sym = (rng.randint(0, 2, size=(900, 1)) + 1).astype(np.uint8)
        obs = track_log_likelihoods(params.log_em, jnp.asarray(sym))[None]
        mono, _ = dp.viterbi(params.log_start, params.log_trans, obs)
        got = viterbi_exact(params, [sym], chunk_len=128)
        np.testing.assert_array_equal(got[0], np.asarray(mono[0]))

    def test_exact_ragged_batch(self, rng):
        from tehmm_tpu.parallel.stitch import viterbi_exact

        lt = np.log(np.array(
            [[0.95, 0.05], [0.05, 0.95]], np.float32))
        log_em = np.zeros((2, 1, 4), np.float32)
        log_em[:, 0, 1:] = np.log(
            np.array([[0.6, 0.2, 0.2], [0.2, 0.2, 0.6]])
        )
        params = HmmParams(
            log_start=jnp.asarray(np.log([0.5, 0.5]).astype(np.float32)),
            log_trans=jnp.asarray(lt),
            log_em=jnp.asarray(log_em),
        )
        syms = [
            (rng.randint(0, 3, size=(L, 1)) + 1).astype(np.uint8)
            for L in (701, 350, 513)
        ]
        got = viterbi_exact(params, syms, chunk_len=100)
        for sym, path in zip(syms, got):
            obs = track_log_likelihoods(
                params.log_em, jnp.asarray(sym))[None]
            mono, _ = dp.viterbi(params.log_start, params.log_trans, obs)
            np.testing.assert_array_equal(path, np.asarray(mono[0]))


class TestPosteriorExact:
    def _adversarial(self, rng, L=900):
        """Near-uniform emissions: posterior argmax rides razor-thin
        margins, so halo forgetting never converges — the exact path
        must still equal the monolithic decode BITWISE."""
        S = 2
        lt = np.log(np.full((S, S), 0.5, np.float32))
        log_em = np.zeros((S, 1, 3), np.float32)
        log_em[:, 0, 1:] = np.log(
            np.array([[0.5001, 0.4999], [0.4999, 0.5001]])
        )
        params = HmmParams(
            log_start=jnp.asarray(np.log([0.5, 0.5]).astype(np.float32)),
            log_trans=jnp.asarray(lt),
            log_em=jnp.asarray(log_em),
        )
        sym = (rng.randint(0, 2, size=(L, 1)) + 1).astype(np.uint8)
        return params, sym

    def _mono_gamma(self, params, sym):
        obs = track_log_likelihoods(params.log_em, jnp.asarray(sym))[None]
        ah, _, _ = dp.forward_scaled(
            params.log_start, params.log_trans, obs
        )
        bh, _ = dp.backward_scaled(params.log_trans, obs)
        return np.asarray(dp.posterior_scaled(ah, bh)[0])

    def test_exact_matches_monolithic_adversarial(self, rng):
        from tehmm_tpu.parallel.stitch import posterior_exact

        params, sym = self._adversarial(rng)
        mono = np.argmax(self._mono_gamma(params, sym), axis=-1)
        got = posterior_exact(params, [sym], chunk_len=128)
        np.testing.assert_array_equal(got[0], mono)

    def test_exact_ragged_batch(self, rng):
        from tehmm_tpu.parallel.stitch import posterior_exact

        lt = np.log(np.array([[0.95, 0.05], [0.05, 0.95]], np.float32))
        log_em = np.zeros((2, 1, 4), np.float32)
        log_em[:, 0, 1:] = np.log(
            np.array([[0.6, 0.2, 0.2], [0.2, 0.2, 0.6]])
        )
        params = HmmParams(
            log_start=jnp.asarray(np.log([0.5, 0.5]).astype(np.float32)),
            log_trans=jnp.asarray(lt),
            log_em=jnp.asarray(log_em),
        )
        syms = [
            (rng.randint(0, 3, size=(L, 1)) + 1).astype(np.uint8)
            for L in (701, 350, 513, 1)
        ]
        got = posterior_exact(params, syms, chunk_len=100)
        for sym, path in zip(syms, got):
            mono = np.argmax(self._mono_gamma(params, sym), axis=-1)
            np.testing.assert_array_equal(path, mono)

    def test_chunked_posterior_falls_back_to_exact(self, rng):
        """posterior_chunked on the adversarial model must end up equal
        to monolithic via the exact fallback (boundaries_ok reports
        True because the fallback is unconditional)."""
        from tehmm_tpu.parallel.stitch import posterior_chunked

        params, sym = self._adversarial(rng, L=800)
        mono = np.argmax(self._mono_gamma(params, sym), axis=-1)
        paths, report = posterior_chunked(
            params, [sym], chunk_len=100, halo=8, max_halo=256,
            rows_per_pass=4,
        )
        assert report.boundaries_ok
        np.testing.assert_array_equal(paths[0], mono)

    def test_stitcher_exact_fallback_branch(self, rng):
        """Drive _stitched_decode with a decoder that NEVER agrees
        across chunks: the loop must widen failing boundaries to the
        cap, keep capped-but-still-failing boundaries in the failing
        set (round-3 review: recomputing `failing` from the recheck set
        alone silently dropped them), and hand the whole input to the
        exact decoder — whose output is returned with
        boundaries_ok=True (the fallback is unconditional)."""
        from tehmm_tpu.models.params import HmmParams
        from tehmm_tpu.parallel import stitch

        S = 2
        params = HmmParams(
            log_start=jnp.asarray(np.log([0.5, 0.5]).astype(np.float32)),
            log_trans=jnp.asarray(
                np.log(np.full((S, S), 0.5, np.float32))
            ),
            log_em=jnp.asarray(np.zeros((S, 1, 3), np.float32)),
        )
        sym = (rng.randint(0, 2, size=(500, 1)) + 1).astype(np.uint8)
        counter = [0]

        def decode_rows(symbols, lens, wb, vb):
            # every chunk gets a distinct constant row: neighbors can
            # never agree on any window
            n, L, _ = symbols.shape
            out = np.empty((n, L), np.int32)
            for k in range(n):
                counter[0] += 1
                out[k] = counter[0] % 7
            return out

        sentinel = [np.full(500, 3, np.int32)]

        def exact_fn(params, tables, chunk_len, gauss_params=None,
                     weight_arrays=None):
            return [p.copy() for p in sentinel]

        paths, report = stitch._stitched_decode(
            params, [sym], chunk_len=100, halo=4, max_halo=8,
            agree_frac=0.5, decode_rows=decode_rows,
            exact_fn=exact_fn, name="test",
            weight_arrays=None, gauss_params=None,
        )
        assert report.retries >= 1 and report.final_halo == 8
        assert report.boundaries_ok        # exact output: unconditional
        np.testing.assert_array_equal(paths[0], sentinel[0])

    def test_posterior_distributions_stream_bitexact(self, rng):
        """--pd streaming: chunk-recomputed gamma == monolithic gamma
        bitwise (identical op sequences)."""
        from tehmm_tpu.io.trackdata import TrackTable
        from tehmm_tpu.models.hmm import MultitrackHmm
        from tehmm_tpu.io.trackxml import TrackList, Track
        from tehmm_tpu.io.category import CategoryMap

        lt = np.log(np.array(
            [[0.97, 0.02, 0.01], [0.02, 0.96, 0.02], [0.01, 0.02, 0.97]],
            np.float32))
        log_em = np.zeros((3, 1, 5), np.float32)
        log_em[:, 0, 1:] = np.log(np.array([
            [0.7, 0.1, 0.1, 0.1],
            [0.1, 0.7, 0.1, 0.1],
            [0.1, 0.1, 0.1, 0.7],
        ]))
        params = HmmParams(
            log_start=jnp.asarray(np.log(np.full(3, 1 / 3, np.float32))),
            log_trans=jnp.asarray(lt),
            log_em=jnp.asarray(log_em),
        )
        L = 1777
        sym = (rng.randint(0, 4, (L, 1)) + 1).astype(np.uint8)
        tl = TrackList()
        tl.add(Track(name="a", path="unused.bed"))
        cm = CategoryMap()
        for v in "1234":
            cm.get_map(v, update=True)
        model = MultitrackHmm(params, tl, {"a": cm}, ["x", "y", "z"])
        tab = TrackTable("chr1", 0, L, sym)
        got = model.posterior_distributions([tab], chunk_len=256)[0]
        mono = self._mono_gamma(params, sym)
        np.testing.assert_array_equal(got, mono.astype(np.float32))


class TestRegressions:
    """Fixes from the round-2 latent-bug review."""

    def test_viterbi_single_position(self, rng, make_hmm):
        """dp.viterbi on L == 1 inputs (e.g. decoding a single-bp BED
        interval) must not crash and must pick the best start-weighted
        state; zero-length rows get path 0 / score 0."""
        S, T, V = 3, 1, 4
        params = _params(make_hmm(S, T, V))
        obs = jnp.asarray(
            rng.randn(2, 1, S).astype(np.float32)
        )
        lens = jnp.asarray([1, 0], jnp.int32)
        path, score = dp.viterbi(
            params.log_start, params.log_trans, obs, lens
        )
        want = int(jnp.argmax(params.log_start + obs[0, 0]))
        assert int(path[0, 0]) == want
        assert int(path[1, 0]) == 0 and float(score[1]) == 0.0
        np.testing.assert_allclose(
            float(score[0]),
            float(params.log_start[want] + obs[0, 0, want]),
            rtol=1e-6,
        )

    def test_streaming_loglik_empty_row(self, rng, make_hmm):
        """streaming_loglik must give empty rows loglik 0 like
        forward_scaled (an unmasked -1e30 normalizer used to leak into
        the total and poison MultitrackHmm.score)."""
        S, T, V, L = 3, 1, 4, 12
        params = _params(make_hmm(S, T, V))
        obs = jnp.asarray(rng.randn(2, L, S).astype(np.float32))
        lens = np.asarray([L, 0])
        want = np.asarray(dp.forward_scaled(
            params.log_start, params.log_trans, obs, jnp.asarray(lens)
        )[2])
        got = np.asarray(dp.streaming_loglik(
            params.log_start, params.log_trans,
            [obs[:, :6], obs[:, 6:]],
            [np.clip(lens, 0, 6), np.clip(lens - 6, 0, 6)],
        ))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert got[1] == 0.0

    def test_score_all_empty_tables(self, make_hmm):
        """MultitrackHmm.score of only empty tables returns 0.0 instead
        of raising StopIteration from an exhausted chunk iterator."""
        import dataclasses as dc

        from tehmm_tpu.models.hmm import MultitrackHmm
        from tehmm_tpu.io.trackxml import TrackList

        params = _params(make_hmm(3, 2, 5))
        model = MultitrackHmm(params, TrackList(), {})

        @dc.dataclass
        class _Tab:
            symbols: np.ndarray
            values = None

            def __len__(self):
                return len(self.symbols)

        empty = _Tab(np.zeros((0, 2), np.int32))
        assert model.score([empty, empty]) == 0.0

    def test_sharded_loglik_matches_score(self, rng, make_hmm):
        """sharded_loglik == the single-device forward loglik, including
        gaussian tracks and segment weights (it used to silently drop
        both)."""
        from tehmm_tpu.models.gauss import (
            GaussParams, gauss_log_likelihoods,
        )
        from tehmm_tpu.parallel.em_sharded import sharded_loglik
        from tehmm_tpu.parallel.mesh import make_data_mesh

        S, T, V, L, B, Gn = 3, 2, 5, 32, 8, 2
        params = _params(make_hmm(S, T, V))
        symbols = jnp.asarray(rng.randint(1, V, size=(B, L, T)))
        lengths = jnp.asarray(
            np.r_[np.full(B - 2, L), [10, 0]], jnp.int32
        )
        w = jnp.asarray(
            rng.randint(1, 5, size=(B, L)).astype(np.float32)
        )
        vals = rng.randn(B, L, Gn).astype(np.float32)
        vals[rng.rand(B, L, Gn) < 0.1] = np.nan
        vals = jnp.asarray(vals)
        gp = GaussParams(
            mu=jnp.asarray(rng.randn(S, Gn).astype(np.float32)),
            log_var=jnp.asarray(np.zeros((S, Gn), np.float32)),
        )
        obs = track_log_likelihoods(params.log_em, symbols)
        obs = (obs + gauss_log_likelihoods(gp, vals)) * w[:, :, None]
        want = float(np.asarray(dp.forward_scaled(
            params.log_start, params.log_trans, obs, lengths
        )[2]).sum())
        got = float(sharded_loglik(
            params, symbols, lengths, make_data_mesh(8),
            obs_weights=w, gauss_params=gp, gauss_values=vals,
        ))
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestResidentDecodeRLE:
    """Round-5: device-resident decode + run-length path transport
    (parallel/stitch._ResidentDecoder, _rle_pack/_rle_expand).  Genome
    decode was transfer-bound (per-dispatch symbol re-upload + per-base
    path download); the resident path must be BIT-IDENTICAL to the
    host-batched path and to the monolithic decode."""

    def test_rle_pack_expand_roundtrip(self, rng):
        from tehmm_tpu.parallel import stitch

        n, L = 6, 512
        K = stitch._rle_slots(L)
        paths = np.repeat(
            rng.randint(0, 7, size=(n, L // 16)), 16, axis=1
        ).astype(np.int32)
        paths[0] = 2                       # single run
        paths[1] = np.tile([0, 1], L // 2)  # 512 runs: overflows K=64
        lens = np.asarray([L, L, L, 100, 1, 0], np.int32)
        packed = np.asarray(stitch._rle_pack(
            jnp.asarray(paths), jnp.asarray(lens), K, 8
        ))
        calls = [0]

        def full():
            calls[0] += 1
            return paths

        rows = stitch._rle_expand(packed, lens, 8, full)
        for i in range(n):
            np.testing.assert_array_equal(rows[i], paths[i, : lens[i]])
        assert calls[0] == 1   # overflow row fetched the block once

    @pytest.mark.parametrize("mode", ["viterbi", "maxpost"])
    def test_resident_equals_host_batch(self, rng, make_hmm, mode):
        from tehmm_tpu.parallel.stitch import (
            posterior_chunked, viterbi_chunked,
        )

        params = _params(make_hmm(4, 2, 5))
        tabs = [
            rng.randint(1, 5, size=(L, 2)).astype(np.uint8)
            for L in (1500, 1, 0, 700)
        ]
        fn = viterbi_chunked if mode == "viterbi" else posterior_chunked
        got_r, rep_r = fn(
            params, tabs, chunk_len=256, halo=32, resident=True
        )
        got_h, _ = fn(
            params, tabs, chunk_len=256, halo=32, resident=False
        )
        for a, b in zip(got_r, got_h):
            np.testing.assert_array_equal(a, b)
        # and == the monolithic decode on the big table
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(tabs[0][None])
        )
        if mode == "viterbi":
            want, _ = dp.viterbi(
                params.log_start, params.log_trans, obs
            )
        else:
            ah, _, _ = dp.forward_scaled(
                params.log_start, params.log_trans, obs
            )
            bh, _ = dp.backward_scaled(params.log_trans, obs)
            want = jnp.argmax(dp.posterior_scaled(ah, bh), axis=-1)
        np.testing.assert_array_equal(got_r[0], np.asarray(want)[0])

    @pytest.mark.parametrize("mode", ["viterbi", "maxpost"])
    def test_resident_gauss_and_weights(self, rng, make_hmm, mode):
        """Gaussian values and segment weights gather from the resident
        arrays with the same zero padding as batch_chunks."""
        from tehmm_tpu.models.gauss import GaussParams
        from tehmm_tpu.parallel.stitch import (
            posterior_chunked, viterbi_chunked,
        )

        S, Gn = 3, 2
        params = _params(make_hmm(S, 2, 5))
        gp = GaussParams(
            mu=jnp.asarray(rng.randn(S, Gn).astype(np.float32)),
            log_var=jnp.asarray(np.zeros((S, Gn), np.float32)),
        )

        class _Tab:
            def __init__(self, sym, vals):
                self.symbols = sym
                self.values = vals

        tabs = []
        weights = []
        for L in (900, 333):
            vals = rng.randn(L, Gn).astype(np.float32)
            vals[rng.rand(L, Gn) < 0.1] = np.nan
            tabs.append(_Tab(
                rng.randint(1, 5, size=(L, 2)).astype(np.uint8), vals
            ))
            weights.append(
                rng.randint(1, 4, size=L).astype(np.float32)
            )
        fn = viterbi_chunked if mode == "viterbi" else posterior_chunked
        got_r, _ = fn(
            params, tabs, chunk_len=128, halo=16,
            weight_arrays=weights, gauss_params=gp, resident=True,
        )
        got_h, _ = fn(
            params, tabs, chunk_len=128, halo=16,
            weight_arrays=weights, gauss_params=gp, resident=False,
        )
        for a, b in zip(got_r, got_h):
            np.testing.assert_array_equal(a, b)

    def test_env_gate_disables_resident(self, rng, make_hmm, monkeypatch):
        from tehmm_tpu.parallel import stitch

        monkeypatch.setenv("TEHMM_DECODE_RESIDENT", "off")
        factory = stitch._make_decoder_factory(
            _params(make_hmm(3, 1, 4)), None, None, 8, "viterbi", None
        )
        assert factory([np.zeros((10, 1), np.uint8)], None) is None

    def test_budget_gate_falls_back(self, rng, make_hmm, monkeypatch):
        monkeypatch.setenv("TEHMM_MAX_DEVICE_BYTES", "16")
        from tehmm_tpu.parallel import stitch

        factory = stitch._make_decoder_factory(
            _params(make_hmm(3, 1, 4)), None, None, 8, "viterbi", None
        )
        assert factory([np.zeros((100, 1), np.uint8)], None) is None


class TestSeqParForward:
    """Round-5: exact cross-device sequence-parallel forward
    (parallel/seqpar) — the SURVEY §2c SP/CP promise of composing
    per-chunk S×S operators over the mesh, wired into score()."""

    def test_seqpar_equals_monolithic(self, rng, make_hmm):
        from tehmm_tpu.parallel.mesh import make_data_mesh
        from tehmm_tpu.parallel.seqpar import score_table_seqpar

        params = _params(make_hmm(5, 2, 6))
        mesh = make_data_mesh(8)
        for L in (4096, 1000, 17, 1, 0):
            sym = rng.randint(1, 6, size=(L, 2)).astype(np.uint8)
            got = score_table_seqpar(params, sym, mesh)
            if L == 0:
                assert got == 0.0
                continue
            obs = track_log_likelihoods(
                params.log_em, jnp.asarray(sym[None])
            )
            _, _, ll = dp.forward_scaled(
                params.log_start, params.log_trans, obs
            )
            np.testing.assert_allclose(got, float(ll[0]), rtol=2e-5)

    def test_score_mesh_dispatch_with_gauss(self, rng, make_hmm):
        from tehmm_tpu.models.gauss import GaussParams
        from tehmm_tpu.models.hmm import MultitrackHmm
        from tehmm_tpu.io.trackxml import Track, TrackList
        from tehmm_tpu.io.category import CategoryMap
        from tehmm_tpu.io.trackdata import TrackTable
        from tehmm_tpu.parallel.mesh import make_data_mesh

        S, Gn = 3, 2
        params = _params(make_hmm(S, 2, 5))
        tl = TrackList()
        tl.add(Track(name="a", path="a.bed"))
        tl.add(Track(name="b", path="b.bed"))
        model = MultitrackHmm(
            params, tl,
            {"a": CategoryMap(), "b": CategoryMap()},
            [str(i) for i in range(S)],
        )
        model.gauss = GaussParams(
            mu=jnp.asarray(rng.randn(S, Gn).astype(np.float32)),
            log_var=jnp.zeros((S, Gn), jnp.float32),
        )
        tabs = []
        for L in (511, 33):
            vals = rng.randn(L, Gn).astype(np.float32)
            vals[rng.rand(L, Gn) < 0.1] = np.nan
            tabs.append(TrackTable(
                "chr1", 0, L,
                rng.randint(1, 5, size=(L, 2)).astype(np.uint8),
                values=vals,
            ))
        want = model.score(tabs)
        got = model.score(tabs, mesh=make_data_mesh(8))
        np.testing.assert_allclose(got, want, rtol=2e-5)


class TestFitStagingCacheDecode:
    """round-5: fit() retains its staged device batch; decode_tables on
    the same tables gathers from it (no re-upload) and must be
    bit-identical to a cache-free decode."""

    def _model(self, rng, S, T, V):
        from tehmm_tpu.io.category import CategoryMap
        from tehmm_tpu.io.trackxml import Track, TrackList
        from tehmm_tpu.models.hmm import MultitrackHmm
        from tehmm_tpu.models.params import init_random

        tl = TrackList()
        cmaps = {}
        for t in range(T):
            tl.add(Track(name=f"t{t}", path=f"t{t}.bed"))
            cm = CategoryMap()
            for v in range(V - 1):
                cm.get_map(str(v), update=True)
            cmaps[f"t{t}"] = cm
        return MultitrackHmm(
            init_random(S, [V] * T, seed=11), tl, cmaps
        )

    def test_cached_decode_equals_fresh(self, rng):
        from tehmm_tpu.io.trackdata import TrackTable

        S, T, V = 4, 2, 5
        tabs = [
            TrackTable(
                "chr1", 0, L,
                rng.randint(1, V, size=(L, T)).astype(np.uint8),
            )
            for L in (2047, 513)      # odd sizes: padded last rows
        ]
        m = self._model(rng, S, T, V)
        m.fit(tabs, max_iterations=2, convergence_tol=0.0,
              chunk_len=256)
        assert m._staging is not None
        assert m._prestaged_for(tabs) is not None
        cached, _ = m.decode_tables(tabs, chunk_len=128, halo=32)
        m.release_staging()
        fresh, _ = m.decode_tables(tabs, chunk_len=128, halo=32)
        for a, b in zip(cached, fresh):
            np.testing.assert_array_equal(a, b)

    def test_cache_misses_on_other_tables(self, rng):
        from tehmm_tpu.io.trackdata import TrackTable

        S, T, V = 4, 2, 5
        tabs = [TrackTable(
            "chr1", 0, 500,
            rng.randint(1, V, size=(500, T)).astype(np.uint8),
        )]
        other = [TrackTable(
            "chr1", 0, 500,
            rng.randint(1, V, size=(500, T)).astype(np.uint8),
        )]
        m = self._model(rng, S, T, V)
        m.fit(tabs, max_iterations=1, convergence_tol=0.0,
              chunk_len=256)
        assert m._prestaged_for(other) is None   # different arrays
        paths, _ = m.decode_tables(other, chunk_len=128, halo=32)
        fresh, _ = m.decode_tables(other, chunk_len=128, halo=32)
        np.testing.assert_array_equal(paths[0], fresh[0])

    def test_cached_decode_with_gauss_values(self, rng):
        from tehmm_tpu.io.trackdata import TrackTable
        from tehmm_tpu.models.gauss import GaussParams

        S, T, V, Gn = 4, 2, 5, 2
        L = 1023
        vals = rng.randn(L, Gn).astype(np.float32)
        vals[rng.rand(L, Gn) < 0.1] = np.nan
        tabs = [TrackTable(
            "chr1", 0, L,
            rng.randint(1, V, size=(L, T)).astype(np.uint8),
            values=vals,
        )]
        m = self._model(rng, S, T, V)
        m.gauss = GaussParams(
            mu=jnp.asarray(rng.randn(S, Gn).astype(np.float32)),
            log_var=jnp.zeros((S, Gn), jnp.float32),
        )
        m.fit(tabs, max_iterations=2, convergence_tol=0.0,
              chunk_len=256)
        assert m._prestaged_for(tabs) is not None
        cached, _ = m.decode_tables(tabs, chunk_len=128, halo=32)
        m.release_staging()
        fresh, _ = m.decode_tables(tabs, chunk_len=128, halo=32)
        np.testing.assert_array_equal(cached[0], fresh[0])

    def test_score_mesh_multi_tile_blocks(self, rng, make_hmm,
                                          monkeypatch):
        """round-5 review: the sharded scorer builds obs per [block,T]
        tile inside the mesh computation (no whole-sequence obs).
        Force several tiles per device and check == plain score."""
        import tehmm_tpu.parallel.seqpar as sp
        from tehmm_tpu.io.trackdata import TrackTable
        from tehmm_tpu.models.hmm import MultitrackHmm
        from tehmm_tpu.io.trackxml import Track, TrackList
        from tehmm_tpu.io.category import CategoryMap
        from tehmm_tpu.parallel.mesh import make_data_mesh

        S = 3
        params = _params(make_hmm(S, 2, 5))
        tl = TrackList()
        tl.add(Track(name="a", path="a.bed"))
        tl.add(Track(name="b", path="b.bed"))
        model = MultitrackHmm(
            params, tl,
            {"a": CategoryMap(), "b": CategoryMap()},
            [str(i) for i in range(S)],
        )
        L = 5003                      # with block=64 and D=8: NB ~ 10
        tab = TrackTable(
            "chr1", 0, L,
            rng.randint(1, 5, size=(L, 2)).astype(np.uint8),
        )
        want = model.score([tab])
        orig = sp.score_table_seqpar

        def small_block(params, table, mesh, gauss_params=None):
            # shrink the tile so several compose per device
            sym = np.asarray(getattr(table, "symbols", table))
            import tehmm_tpu.parallel.seqpar as s2
            Lt = len(sym)
            D = 8
            block = 64
            Lc = -(-Lt // (D * block)) * block
            sym_p = np.zeros((Lc * D,) + sym.shape[1:], sym.dtype)
            sym_p[:Lt] = sym
            sym_sh = s2._shard_over_data(
                sym_p.reshape(D, Lc, *sym.shape[1:]), mesh
            )
            return float(s2._loglik_seqpar_symbols(
                params.log_start, params.log_trans, params.log_em,
                sym_sh, None, Lt, mesh, block, False, None, None,
            ))

        got = small_block(params, tab, make_data_mesh(8))
        np.testing.assert_allclose(got, want, rtol=2e-5)
