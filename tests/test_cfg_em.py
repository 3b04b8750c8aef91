"""Inside-outside EM for the pair-grammar CFG (models/cfg_em.py).

Validation strategy (the reference's own gold pattern, SURVEY.md §4):
brute-force enumeration over ALL parses for tiny inputs, plus the
zero-pair-states reduction to HMM Baum-Welch (reference: cfgTest.py
HMM-equivalence tests [R]).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.models.cfg import make_cfg_params  # noqa: E402
from tehmm_tpu.models.cfg_em import (  # noqa: E402
    cfg_em_run,
    cfg_em_stats,
    cfg_inside_chart,
    match_bonus_from_counts,
)
from tehmm_tpu.models.emission import track_log_likelihoods  # noqa: E402
from tehmm_tpu.models.params import init_random  # noqa: E402
from tehmm_tpu.ops import em as em_ops  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _drop_chart_executables():
    """The vmapped inside-outside charts compile into large CPU
    executables; holding them for the rest of the session pushes the
    full suite over the known XLA-CPU compile crash threshold
    (tests/test_property_sweep.py's cache note).  Drop them when this
    module is done."""
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.RandomState(7)


def _random_problem(rng, S=3, T=2, V=5, L=6, seed=1):
    params = init_random(S, [V] * T, seed=seed)
    symbols = rng.randint(1, V, size=(L, T)).astype(np.int32)
    return params, symbols


# ---------------------------------------------------------------------
# brute-force parse enumeration (exponential; L <= ~7)
# ---------------------------------------------------------------------


def _enumerate_parses(ls, lt, obs, symbols, pair_mask, log_match, log_sa):
    """All derivations of span (i, j) rooted at s -> list of
    (logweight, {pos: state}, [(s, s') transitions], n_match_pairs)."""
    L, S = obs.shape
    sa_left = np.where(pair_mask, log_sa[0], 0.0)

    def pair_em(i, j, s):
        both = (symbols[i] > 0) & (symbols[j] > 0)
        nm = int(((symbols[i] == symbols[j]) & both).sum())
        return obs[i, s] + obs[j, s] + nm * log_match[s], nm

    memo = {}

    def derive(i, j, s):
        key = (i, j, s)
        if key in memo:
            return memo[key]
        out = []
        if i == j:
            out.append((obs[i, s], {i: s}, [], 0.0))
        else:
            for sp in range(S):
                for w, asg, tr, nm in derive(i + 1, j, s=sp):
                    out.append((
                        obs[i, s] + sa_left[s] + lt[s, sp] + w,
                        {**asg, i: s}, [(s, sp)] + tr, nm,
                    ))
            if pair_mask[s] and j - i >= 2:
                pe, nmatch = pair_em(i, j, s)
                for sp in range(S):
                    for w, asg, tr, nm in derive(i + 1, j - 1, sp):
                        out.append((
                            pe + log_sa[1] + lt[s, sp] + w,
                            {**asg, i: s, j: s},
                            [(s, sp)] + tr, nm + nmatch,
                        ))
        memo[key] = out
        return out

    parses = []
    for s in range(S):
        for w, asg, tr, nm in derive(0, L - 1, s):
            parses.append((ls[s] + w, asg, tr, nm, s))
    return parses


def _brute_counts(params_cfg, obs, symbols):
    ls = np.asarray(params_cfg.hmm.log_start, np.float64)
    lt = np.asarray(params_cfg.hmm.log_trans, np.float64)
    pm = np.asarray(params_cfg.pair_mask)
    lm = np.asarray(params_cfg.log_match, np.float64)
    sa = np.asarray(params_cfg.log_sa, np.float64)
    obs64 = np.asarray(obs, np.float64)
    L, S = obs64.shape
    parses = _enumerate_parses(ls, lt, obs64, symbols, pm, lm, sa)
    ws = np.array([p[0] for p in parses])
    m = ws.max()
    Z = m + np.log(np.exp(ws - m).sum())
    post = np.exp(ws - Z)
    gamma = np.zeros((L, S))
    trans = np.zeros((S, S))
    start = np.zeros(S)
    e_match = np.zeros(S)
    for p, (w, asg, tr, nm, root) in zip(post, parses):
        for pos, s in asg.items():
            gamma[pos, s] += p
        for (a, b) in tr:
            trans[a, b] += p
        start[root] += p
    return Z, gamma, trans, start


class TestBruteForce:
    def test_inside_outside_matches_enumeration(self, rng):
        S, T, V, L = 3, 2, 4, 6
        params, symbols = _random_problem(rng, S, T, V, L)
        cfgp = make_cfg_params(
            params, pair_states=[1], match_bonus=0.7, sa_prior=0.6
        )
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(symbols)[None]
        )[0]
        stats, gamma, e_m, e_t = cfg_em_stats(
            cfgp, obs, jnp.asarray(symbols)
        )
        Z, g_ref, tr_ref, st_ref = _brute_counts(cfgp, obs, symbols)
        np.testing.assert_allclose(float(stats.loglik), Z, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(gamma), g_ref, atol=1e-5)
        np.testing.assert_allclose(np.asarray(stats.trans), tr_ref,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(stats.start), st_ref,
                                   atol=1e-5)
        # every position emitted exactly once
        np.testing.assert_allclose(
            np.asarray(gamma).sum(axis=1), 1.0, atol=1e-5
        )

    def test_missing_symbols_never_match(self, rng):
        S, T, V, L = 2, 1, 4, 5
        params, symbols = _random_problem(rng, S, T, V, L)
        symbols[:] = 0                       # all-missing track
        cfgp = make_cfg_params(params, pair_states=[0], match_bonus=3.0)
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(symbols)[None]
        )[0]
        _, _, e_m, e_t = cfg_em_stats(cfgp, obs, jnp.asarray(symbols))
        assert float(jnp.sum(e_m)) == 0.0
        assert float(jnp.sum(e_t)) == 0.0


class TestHmmReduction:
    def test_no_pairs_equals_hmm_estep(self, rng):
        S, T, V, L = 4, 2, 5, 9
        params, symbols = _random_problem(rng, S, T, V, L, seed=3)
        cfgp = make_cfg_params(params, pair_states=[])
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(symbols)[None]
        )[0]
        stats, gamma, _, _ = cfg_em_stats(cfgp, obs, jnp.asarray(symbols))
        ref = em_ops.em_sufficient_stats(
            params, jnp.asarray(symbols)[None], engine="xla"
        )
        np.testing.assert_allclose(
            float(stats.loglik), float(ref.loglik), rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(stats.start), np.asarray(ref.start), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(stats.trans), np.asarray(ref.trans), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(stats.em), np.asarray(ref.em), atol=1e-4
        )

    def test_inside_chart_root_matches_loglik(self, rng):
        from tehmm_tpu.models.cfg import cfg_inside_loglik

        params, symbols = _random_problem(rng, 3, 2, 4, 7, seed=5)
        cfgp = make_cfg_params(params, pair_states=[2], match_bonus=1.0)
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(symbols)[None]
        )[0]
        chart = cfg_inside_chart(cfgp, obs, jnp.asarray(symbols))
        L = obs.shape[0]
        root = chart[L - 1, 0] + cfgp.hmm.log_start
        m = float(jnp.max(root))
        z_chart = m + float(jnp.log(jnp.sum(jnp.exp(root - m))))
        z_ref = float(cfg_inside_loglik(
            cfgp, obs, jnp.asarray(symbols), max_span=L
        ))
        assert abs(z_chart - z_ref) < 1e-4


class TestEmRun:
    def test_monotone_loglik_without_match_update(self, rng):
        S, T, V, L = 3, 2, 5, 16
        params, _ = _random_problem(rng, S, T, V, L, seed=11)
        syms = [
            rng.randint(1, V, size=(L, T)).astype(np.int32)
            for _ in range(3)
        ]
        cfgp = make_cfg_params(params, pair_states=[1], match_bonus=0.5)
        res, _ = cfg_em_run(
            cfgp, syms, [V] * T, iterations=6, update_match=False,
            threshold=0.0,
        )
        lls = res.logliks
        assert len(lls) >= 3
        for a, b in zip(lls, lls[1:]):
            assert b >= a - 1e-3, lls

    def test_learns_positive_bonus_on_mirrored_data(self, rng):
        # palindromic sequences: ends agree far above chance
        S, T, V, L = 2, 1, 5, 12
        params, _ = _random_problem(rng, S, T, V, L, seed=13)
        syms = []
        for _ in range(4):
            half = rng.randint(1, V, size=(L // 2, T)).astype(np.int32)
            syms.append(np.concatenate([half, half[::-1]], axis=0))
        cfgp = make_cfg_params(params, pair_states=[1], match_bonus=0.0,
                               sa_prior=0.7)
        res, _ = cfg_em_run(
            cfgp, syms, [V] * T, iterations=4, update_match=True,
            threshold=0.0,
        )
        assert float(res.params.log_match[1]) > 0.0

    def test_match_bonus_from_counts_zero_without_mass(self):
        log_em = np.log(np.full((2, 1, 4), 0.25))
        out = match_bonus_from_counts(
            np.zeros(2), np.zeros(2), log_em,
            np.array([False, True]), [4],
        )
        np.testing.assert_array_equal(out, 0.0)

    def test_single_position_sequence(self, rng):
        params, symbols = _random_problem(rng, 2, 1, 4, 1, seed=17)
        cfgp = make_cfg_params(params, pair_states=[1], match_bonus=1.0)
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(symbols)[None]
        )[0]
        stats, gamma, _, _ = cfg_em_stats(cfgp, obs, jnp.asarray(symbols))
        root = np.asarray(params.log_start) + np.asarray(obs[0])
        m = root.max()
        z_ref = m + np.log(np.exp(root - m).sum())
        np.testing.assert_allclose(float(stats.loglik), z_ref, rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(gamma).sum(), 1.0, atol=1e-5
        )


class TestCfgEmCli:
    def test_train_cfgem_eval_pipeline(self, tmp_path, rng):
        """--cfg --cfgEm: supervised init -> inside-outside refinement
        -> decode round trip; learned per-state log_match persisted."""
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.cli import eval as cli_eval
        from tehmm_tpu.io import write_bed_intervals, read_bed_intervals
        from tehmm_tpu.models.hmm import MultitrackHmm

        L = 200
        truth = [("chr1", 0, 80, "BG"), ("chr1", 80, 120, "TE"),
                 ("chr1", 120, 200, "BG")]
        rows = []
        for c, s, e, n in truth:
            for i in range(s, e, 10):
                val = "X" if n == "TE" else "Y"
                rows.append((c, i, min(i + 10, e), val))
        bed = str(tmp_path / "a.bed")
        write_bed_intervals(rows, bed)
        xml = tmp_path / "t.xml"
        xml.write_text(
            f'<teModelConfig><track name="a" path="{bed}"/>'
            "</teModelConfig>"
        )
        truth_bed = str(tmp_path / "truth.bed")
        write_bed_intervals(truth, truth_bed)
        regions = str(tmp_path / "r.bed")
        write_bed_intervals([("chr1", 0, L)], regions)
        model = str(tmp_path / "m.npz")
        rc = cli_train.main(
            [str(xml), truth_bed, model, "--supervised", "--cfg",
             "--pairStates", "TE", "--cfgEm", "3", "--maxSpan", "128"]
        )
        assert rc == 0
        loaded = MultitrackHmm.load(model)
        meta = loaded.extra["cfg"]
        assert "log_match" in meta
        assert len(meta["log_match"]) == loaded.num_states
        out = str(tmp_path / "p.bed")
        rc = cli_eval.main([str(xml), model, regions, "--bed", out])
        assert rc == 0
        pred = read_bed_intervals(out, ncol=4)
        assert len(pred) >= 1
        assert {p[3] for p in pred} <= {"BG", "TE"}

    def test_cfgem_rejects_segment(self, tmp_path):
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.cli import segment_tracks as seg_cli
        from tehmm_tpu.io import write_bed_intervals
        import pytest

        bed = str(tmp_path / "a.bed")
        write_bed_intervals(
            [("chr1", i, i + 10, "X" if (i // 10) % 2 else "Y")
             for i in range(0, 100, 10)], bed
        )
        xml = tmp_path / "t.xml"
        xml.write_text(
            f'<teModelConfig><track name="a" path="{bed}"/>'
            "</teModelConfig>"
        )
        regions = str(tmp_path / "r.bed")
        write_bed_intervals([("chr1", 0, 100)], regions)
        segs = str(tmp_path / "segs.bed")
        assert seg_cli.main([str(xml), regions, segs]) == 0
        with pytest.raises(SystemExit, match="segment"):
            cli_train.main(
                [str(xml), segs, str(tmp_path / "m.npz"),
                 "--numStates", "2", "--iter", "2", "--segment",
                 "--cfg", "--pairStates", "0", "--cfgEm", "2"]
            )

    def test_view_shows_cfg_pair_grammar(self, tmp_path, rng, capsys):
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.cli import view as cli_view
        from tehmm_tpu.io import write_bed_intervals

        bed = str(tmp_path / "a.bed")
        write_bed_intervals(
            [("chr1", i, i + 10, "X" if 40 <= i < 60 else "Y")
             for i in range(0, 100, 10)], bed
        )
        xml = tmp_path / "t.xml"
        xml.write_text(
            f'<teModelConfig><track name="a" path="{bed}"/>'
            "</teModelConfig>"
        )
        truth_bed = str(tmp_path / "truth.bed")
        write_bed_intervals(
            [("chr1", 0, 40, "BG"), ("chr1", 40, 60, "TE"),
             ("chr1", 60, 100, "BG")], truth_bed
        )
        model = str(tmp_path / "m.npz")
        assert cli_train.main(
            [str(xml), truth_bed, model, "--supervised", "--cfg",
             "--pairStates", "TE", "--cfgEm", "2", "--maxSpan", "64"]
        ) == 0
        capsys.readouterr()
        assert cli_view.main([model]) == 0
        out = capsys.readouterr().out
        assert "cfg pair grammar" in out
        assert "log_match[TE]" in out


class TestPackedGroupEngine:
    """cfg_em_stats_g (G windows packed into one matmul tile) ==
    vmap(cfg_em_stats): same stats/gamma/bonus counts per window."""

    def test_packed_matches_vmapped(self, rng):
        from tehmm_tpu.models.cfg_em import (
            _cfg_em_stats_batched, cfg_em_stats_g,
        )

        S, T, V, L, G = 3, 2, 5, 12, 4
        params, _ = _random_problem(rng, S, T, V, L, seed=31)
        cfgp = make_cfg_params(
            params, pair_states=[1], match_bonus=0.8, sa_prior=0.6
        )
        sym_g = jnp.asarray(np.stack([
            rng.randint(1, V, size=(L, T)).astype(np.int32)
            for _ in range(G)
        ]))
        obs_g = track_log_likelihoods(params.log_em, sym_g)

        ref_stats, ref_gamma, ref_em, ref_et = _cfg_em_stats_batched(
            cfgp, obs_g, sym_g
        )
        got_stats, got_gamma, got_em, got_et = cfg_em_stats_g(
            cfgp, obs_g, sym_g
        )
        np.testing.assert_allclose(
            np.asarray(got_stats.loglik), np.asarray(ref_stats.loglik),
            rtol=1e-5,
        )
        for name in ("start", "trans", "em"):
            np.testing.assert_allclose(
                np.asarray(getattr(got_stats, name)),
                np.asarray(getattr(ref_stats, name)),
                rtol=1e-4, atol=1e-5, err_msg=name,
            )
        np.testing.assert_allclose(
            np.asarray(got_gamma), np.asarray(ref_gamma),
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(got_em), np.asarray(ref_em), rtol=1e-4,
            atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(got_et), np.asarray(ref_et), rtol=1e-4,
            atol=1e-5,
        )

    def test_packed_with_roots_and_l1(self, rng):
        from tehmm_tpu.models.cfg_em import (
            _cfg_em_stats_rooted, cfg_em_stats_g,
        )

        S, T, V, G = 2, 1, 4, 3
        params, _ = _random_problem(rng, S, T, V, 4, seed=33)
        cfgp = make_cfg_params(params, pair_states=[0], match_bonus=0.3)
        for L in (1, 4, 7):
            sym_g = jnp.asarray(np.stack([
                rng.randint(1, V, size=(L, T)).astype(np.int32)
                for _ in range(G)
            ]))
            obs_g = track_log_likelihoods(params.log_em, sym_g)
            roots = jnp.asarray(
                rng.randn(G, S).astype(np.float32)
            )
            ref = _cfg_em_stats_rooted(cfgp, obs_g, sym_g, roots)
            got = cfg_em_stats_g(cfgp, obs_g, sym_g, roots)
            np.testing.assert_allclose(
                np.asarray(got[0].loglik), np.asarray(ref[0].loglik),
                rtol=1e-5, err_msg=f"L={L}",
            )
            np.testing.assert_allclose(
                np.asarray(got[1]), np.asarray(ref[1]),
                rtol=1e-4, atol=1e-5, err_msg=f"L={L}",
            )
            np.testing.assert_allclose(
                np.asarray(got[0].trans), np.asarray(ref[0].trans),
                rtol=1e-4, atol=1e-5, err_msg=f"L={L}",
            )


class TestMeshParity:
    """CFG EM / decode sharded over the data mesh == single device
    (the SURVEY §2c DP row covers the CFG family too)."""

    def _mesh(self, n=8):
        from tehmm_tpu.parallel.mesh import make_data_mesh

        return make_data_mesh(n)

    def test_cfg_em_run_mesh_equals_single(self, rng):
        S, T, V, L = 3, 2, 5, 16
        params, _ = _random_problem(rng, S, T, V, L, seed=21)
        # 5 windows: forces padding to 8 on the mesh (3 dummy windows)
        syms = [
            rng.randint(1, V, size=(L, T)).astype(np.int32)
            for _ in range(5)
        ]
        cfgp = make_cfg_params(params, pair_states=[1], match_bonus=0.5)
        res_1, _ = cfg_em_run(
            cfgp, syms, [V] * T, iterations=3, update_match=True,
            threshold=0.0,
        )
        res_m, _ = cfg_em_run(
            cfgp, syms, [V] * T, iterations=3, update_match=True,
            threshold=0.0, mesh=self._mesh(),
        )
        np.testing.assert_allclose(
            res_m.logliks, res_1.logliks, rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(res_m.params.hmm.log_trans),
            np.asarray(res_1.params.hmm.log_trans),
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(res_m.params.hmm.log_em),
            np.asarray(res_1.params.hmm.log_em),
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(res_m.params.log_match),
            np.asarray(res_1.params.log_match),
            rtol=1e-4, atol=1e-5,
        )

    def test_cfg_em_run_mesh_with_gauss(self, rng):
        from tehmm_tpu.models.gauss import GaussParams

        S, T, V, L = 2, 1, 4, 12
        params, _ = _random_problem(rng, S, T, V, L, seed=23)
        syms = [
            rng.randint(1, V, size=(L, T)).astype(np.int32)
            for _ in range(3)
        ]
        vals = [
            rng.randn(L, 1).astype(np.float32) + 2.0 for _ in range(3)
        ]
        gp = GaussParams(
            mu=jnp.asarray([[0.0], [3.0]], jnp.float32),
            log_var=jnp.zeros((2, 1), jnp.float32),
        )
        cfgp = make_cfg_params(params, pair_states=[1], match_bonus=0.0)
        kw = dict(iterations=2, update_match=False, threshold=0.0,
                  gauss_params=gp, values_list=vals)
        res_1, g_1 = cfg_em_run(cfgp, syms, [V] * T, **kw)
        res_m, g_m = cfg_em_run(
            cfgp, syms, [V] * T, mesh=self._mesh(), **kw
        )
        np.testing.assert_allclose(
            res_m.logliks, res_1.logliks, rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(g_m.mu), np.asarray(g_1.mu),
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(g_m.log_var), np.asarray(g_1.log_var),
            rtol=1e-4, atol=1e-5,
        )

    def test_chunked_decode_mesh_equals_single(self, rng):
        from tehmm_tpu.models.cfg import cfg_viterbi_decode_chunked
        from tehmm_tpu.models.cfg_em import cfg_posterior_tables

        S, T, V, L = 3, 2, 5, 200
        params, _ = _random_problem(rng, S, T, V, 8, seed=25)
        symbols = rng.randint(1, V, size=(L, T)).astype(np.int32)
        cfgp = make_cfg_params(params, pair_states=[1], match_bonus=0.5)
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(symbols)[None]
        )[0]
        max_span = 64
        path_1, _ = cfg_viterbi_decode_chunked(
            cfgp, obs, jnp.asarray(symbols), max_span
        )
        path_m, _ = cfg_viterbi_decode_chunked(
            cfgp, obs, jnp.asarray(symbols), max_span,
            mesh=self._mesh(),
        )
        np.testing.assert_array_equal(path_m, path_1)

        g_1 = cfg_posterior_tables(
            cfgp, obs, jnp.asarray(symbols), max_span
        )
        g_m = cfg_posterior_tables(
            cfgp, obs, jnp.asarray(symbols), max_span,
            mesh=self._mesh(),
        )
        np.testing.assert_allclose(g_m, g_1, rtol=1e-4, atol=1e-5)


class TestGaussCfgEm:
    def test_gaussian_moments_refit_under_pair_grammar(self, rng):
        """CFG EM refits gaussian means from posterior moments: two
        states separated purely by a gaussian track converge to the
        planted means (no categorical signal at all)."""
        from tehmm_tpu.models.gauss import GaussParams

        S, T, V, L = 2, 1, 3, 20
        params = init_random(S, [V] * T, seed=21)
        syms, vals = [], []
        for _ in range(4):
            states = (np.arange(L) >= L // 2).astype(int)   # half 0, half 1
            x = np.where(states == 0,
                         rng.normal(-2.0, 0.3, L),
                         rng.normal(2.0, 0.3, L))
            syms.append(rng.randint(1, V, size=(L, T)).astype(np.int32))
            vals.append(x.astype(np.float32)[:, None])
        gp = GaussParams(
            mu=jnp.asarray([[-0.5], [0.5]]),
            log_var=jnp.zeros((2, 1)),
        )
        cfgp = make_cfg_params(params, pair_states=[1], match_bonus=0.0)
        res, new_gp = cfg_em_run(
            cfgp, syms, [V] * T, iterations=10, update_match=False,
            threshold=0.0, gauss_params=gp, values_list=vals,
        )
        mu = np.sort(np.asarray(new_gp.mu).ravel())
        assert mu[0] < -1.0 and mu[1] > 1.0, mu
        # loglik still monotone with gaussian refits in the loop
        lls = res.logliks
        for a, b in zip(lls, lls[1:]):
            assert b >= a - 1e-3, lls


class TestCfgPosterior:
    def test_gamma_equals_hmm_posterior_no_pairs(self, rng):
        """No pair states + full-span chart: CFG posteriors are exactly
        the HMM forward-backward posteriors."""
        from tehmm_tpu.models.cfg_em import cfg_posterior_tables
        from tehmm_tpu.ops import dp

        S, T, V, L = 3, 2, 5, 24
        params, symbols = _random_problem(rng, S, T, V, L, seed=31)
        cfgp = make_cfg_params(params, pair_states=[])
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(symbols)[None]
        )[0]
        gamma = cfg_posterior_tables(
            cfgp, obs, jnp.asarray(symbols), max_span=L
        )
        a, _, _ = dp.forward_scaled(
            params.log_start, params.log_trans, obs[None]
        )
        b, _ = dp.backward_scaled(params.log_trans, obs[None])
        ref = np.asarray(dp.posterior_scaled(a, b))[0]
        np.testing.assert_allclose(gamma, ref, atol=1e-4)

    def test_windowed_maxpost_path_matches_monolithic(self, rng):
        """Windowed posterior argmax == monolithic on a decisive model
        (near-deterministic emissions, so window truncation cannot flip
        any position's argmax)."""
        from tehmm_tpu.models.cfg_em import (
            cfg_posterior_decode, cfg_posterior_tables,
        )
        from tehmm_tpu.models.params import HmmParams

        S, V, L = 2, 3, 120
        log_em = np.full((S, 1, V + 1), np.log(0.02), np.float32)
        log_em[0, 0, 1] = np.log(0.96)
        log_em[1, 0, 2] = np.log(0.96)
        log_em[:, 0, 0] = 0.0
        params = HmmParams(
            log_start=jnp.asarray(np.log([0.5, 0.5]).astype(np.float32)),
            log_trans=jnp.asarray(
                np.log([[0.9, 0.1], [0.1, 0.9]]).astype(np.float32)
            ),
            log_em=jnp.asarray(log_em),
        )
        states = (np.arange(L) // 30) % 2
        symbols = (states + 1).astype(np.int32)[:, None]
        cfgp = make_cfg_params(params, pair_states=[])
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(symbols)[None]
        )[0]
        mono = np.argmax(cfg_posterior_tables(
            cfgp, obs, jnp.asarray(symbols), max_span=L
        ), axis=-1)
        path, gamma = cfg_posterior_decode(
            cfgp, obs, jnp.asarray(symbols), max_span=48, halo=12
        )
        np.testing.assert_array_equal(path, mono)
        np.testing.assert_allclose(gamma.sum(axis=1), 1.0, atol=1e-4)

    def test_interior_windows_ignore_log_start(self, rng):
        """Interior windows of a chunked sequence root FLAT: their gamma
        must not depend on log_start at all (a sharply peaked start
        would otherwise bias posteriors near every window edge — round-2
        advisor finding).  Only the first window keeps log_start."""
        import dataclasses

        from tehmm_tpu.models.cfg_em import cfg_posterior_tables

        S, T, V, L = 3, 2, 5, 96
        params, symbols = _random_problem(rng, S, T, V, L, seed=41)
        peaked = np.full(S, -40.0, np.float32)
        peaked[0] = 0.0
        p_peaked = dataclasses.replace(
            params, log_start=jnp.asarray(peaked)
        )
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(symbols)[None]
        )[0]
        kw = dict(max_span=48, halo=8)      # core=32: windows 0/32/64
        g_flat = cfg_posterior_tables(
            make_cfg_params(params, pair_states=[]), obs,
            jnp.asarray(symbols), **kw,
        )
        g_peak = cfg_posterior_tables(
            make_cfg_params(p_peaked, pair_states=[]), obs,
            jnp.asarray(symbols), **kw,
        )
        # interior-window cores: bitwise-identical (log_start unused)
        np.testing.assert_array_equal(g_flat[32:], g_peak[32:])
        # the true sequence start still honors log_start
        assert not np.allclose(g_flat[:8], g_peak[:8])

    def test_match_bonus_chance_skips_massless_tracks(self):
        """Chance agreement averages only over tracks that can
        contribute comparisons; an all-missing (gaussian-style) track
        must not deflate it and inflate the learned bonus (round-2
        advisor finding)."""
        S, T, V = 2, 2, 5
        log_em = np.full((S, T, V), -1e30, np.float32)
        log_em[:, 0, 1:] = np.log(0.25)      # uniform: chance 0.25
        log_em[:, 1, 0] = 0.0                # all mass on missing
        e_match = np.array([0.0, 25.0])
        e_tot = np.array([0.0, 100.0])       # observed rate == chance
        pair_mask = np.array([False, True])
        bonus = match_bonus_from_counts(
            e_match, e_tot, log_em, pair_mask, [V, V]
        )
        assert abs(float(bonus[1])) < 1e-5, bonus
        # no track with categorical mass at all -> bonus stays 0
        log_em_none = np.full((S, T, V), -1e30, np.float32)
        log_em_none[:, :, 0] = 0.0
        bonus2 = match_bonus_from_counts(
            e_match, e_tot, log_em_none, pair_mask, [V, V]
        )
        assert float(bonus2[1]) == 0.0, bonus2

    def test_eval_cli_maxpost_and_pd_on_cfg_model(self, tmp_path, rng):
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.cli import eval as cli_eval
        from tehmm_tpu.io import write_bed_intervals, read_bed_intervals

        L = 200
        truth = [("chr1", 0, 80, "BG"), ("chr1", 80, 120, "TE"),
                 ("chr1", 120, 200, "BG")]
        rows = []
        for c, s, e, n in truth:
            for i in range(s, e, 10):
                val = "X" if n == "TE" else "Y"
                rows.append((c, i, min(i + 10, e), val))
        bed = str(tmp_path / "a.bed")
        write_bed_intervals(rows, bed)
        xml = tmp_path / "t.xml"
        xml.write_text(
            f'<teModelConfig><track name="a" path="{bed}"/>'
            "</teModelConfig>"
        )
        truth_bed = str(tmp_path / "truth.bed")
        write_bed_intervals(truth, truth_bed)
        regions = str(tmp_path / "r.bed")
        write_bed_intervals([("chr1", 0, L)], regions)
        model = str(tmp_path / "m.npz")
        assert cli_train.main(
            [str(xml), truth_bed, model, "--supervised", "--cfg",
             "--pairStates", "TE", "--cfgEm", "2", "--maxSpan", "128"]
        ) == 0
        out = str(tmp_path / "p.bed")
        pd_out = str(tmp_path / "pd.bed")
        assert cli_eval.main(
            [str(xml), model, regions, "--bed", out, "--maxPost",
             "--pd", pd_out]
        ) == 0
        pred = read_bed_intervals(out, ncol=4)
        assert {p[3] for p in pred} <= {"BG", "TE"}
        pd_rows = read_bed_intervals(pd_out, ncol=4)
        assert len(pd_rows) == L
        probs = np.array([
            [float(x) for x in r[3].split(",")] for r in pd_rows
        ])
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-3)
