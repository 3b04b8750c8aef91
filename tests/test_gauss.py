"""Gaussian track emissions (reference: track.py distribution=gaussian
[R?]; real per-state normal emissions learned by EM / supervised counting)."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

from tehmm_tpu.models.gauss import (
    GaussParams,
    gauss_log_likelihoods,
    gauss_m_step,
    gauss_stats,
    init_gauss,
    supervised_gauss,
)
from tehmm_tpu.io import write_bed_intervals, read_bed_intervals


def _mk(mu, var):
    return GaussParams(
        mu=jnp.asarray(mu, jnp.float32),
        log_var=jnp.asarray(np.log(var), jnp.float32),
    )


class TestDensity:
    def test_matches_scipy_formula(self, rng):
        S, G, L = 3, 2, 40
        mu = rng.randn(S, G)
        var = rng.uniform(0.5, 2.0, (S, G))
        gp = _mk(mu, var)
        x = rng.randn(1, L, G).astype(np.float32)
        got = np.asarray(gauss_log_likelihoods(gp, jnp.asarray(x)))[0]
        want = np.zeros((L, S))
        for s in range(S):
            for g in range(G):
                want[:, s] += (
                    -0.5 * np.log(2 * np.pi * var[s, g])
                    - (x[0, :, g] - mu[s, g]) ** 2 / (2 * var[s, g])
                )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_nan_positions_contribute_zero(self, rng):
        gp = _mk([[0.0], [1.0]], [[1.0], [1.0]])
        x = np.full((1, 5, 1), np.nan, np.float32)
        out = np.asarray(gauss_log_likelihoods(gp, jnp.asarray(x)))
        np.testing.assert_array_equal(out, 0.0)


class TestEm:
    def test_m_step_recovers_moments(self, rng):
        """Hard assignment gamma -> exact per-state sample moments."""
        S, G, L = 2, 1, 4000
        states = rng.randint(0, S, L)
        x = np.where(states == 0, rng.normal(-2, 1, L),
                     rng.normal(3, 2, L)).astype(np.float32)
        gamma = np.eye(S, dtype=np.float32)[states][None]
        gn, gx, gx2 = gauss_stats(
            jnp.asarray(gamma), jnp.asarray(x[None, :, None])
        )
        old = _mk(np.zeros((S, G)), np.ones((S, G)))
        new = gauss_m_step(gn, gx, gx2, old)
        for s, (m_want, v_want) in enumerate([(-2, 1), (3, 4)]):
            sel = states == s
            np.testing.assert_allclose(
                float(new.mu[s, 0]), x[sel].mean(), rtol=1e-3
            )
            np.testing.assert_allclose(
                float(jnp.exp(new.log_var[s, 0])), x[sel].var(),
                rtol=1e-2,
            )

    def test_em_separates_states_by_value(self, rng):
        """Full EM on symbols-free data: only the gaussian track can
        separate the two states."""
        from tehmm_tpu.io.trackdata import TrackTable
        from tehmm_tpu.models.hmm import MultitrackHmm
        from tehmm_tpu.models.params import init_flat

        L = 2000
        truth = np.zeros(L, int)
        for s in range(200, L - 200, 500):
            truth[s : s + 200] = 1
        x = np.where(truth == 1, rng.normal(4, 1, L),
                     rng.normal(0, 1, L)).astype(np.float32)
        sym = np.zeros((L, 1), np.uint8)        # all-missing column
        tab = TrackTable("chr1", 0, L, sym, values=x[:, None])

        class _Hmm(MultitrackHmm):
            @property
            def alphabet_sizes(self):
                return [1]

        model = _Hmm(init_flat(2, [1]), None, None, ["0", "1"])
        model.gauss = init_gauss(2, [tab.values], seed=0)
        res = model.fit([tab], max_iterations=30, convergence_tol=1e-4)
        assert res.logliks[-1] > res.logliks[0]
        mus = np.sort(np.asarray(model.gauss.mu[:, 0]))
        np.testing.assert_allclose(mus, [0.0, 4.0], atol=0.3)
        # decode recovers the planted blocks
        paths, _ = model.decode_tables([tab], chunk_len=512, halo=64)
        path = paths[0]
        hi_state = int(np.asarray(model.gauss.mu[:, 0]).argmax())
        acc = ((path == hi_state) == (truth == 1)).mean()
        assert acc > 0.95, acc

    def test_host_streamed_fit_with_gauss_values(self, rng):
        """The host-streamed pass loop must carry gaussian value blocks
        (and refit the moments) identically to resident training —
        the round-4 streaming path's only untested observation kind."""
        from tehmm_tpu.io.trackdata import TrackTable
        from tehmm_tpu.models.hmm import MultitrackHmm
        from tehmm_tpu.models.params import init_flat

        L = 1500
        truth = (np.arange(L) // 300) % 2
        x = np.where(truth == 1, rng.normal(4, 1, L),
                     rng.normal(0, 1, L)).astype(np.float32)
        sym = np.zeros((L, 1), np.uint8)
        tab = TrackTable("chr1", 0, L, sym, values=x[:, None])

        class _Hmm(MultitrackHmm):
            @property
            def alphabet_sizes(self):
                return [1]

        def train(budget):
            m = _Hmm(init_flat(2, [1]), None, None, ["0", "1"])
            m.gauss = init_gauss(2, [tab.values], seed=0)
            res = m.fit(
                [tab], max_iterations=5, convergence_tol=0.0,
                chunk_len=256, max_device_bytes=budget,
            )
            return res.logliks, np.asarray(m.gauss.mu)

        ll_res, mu_res = train(None)
        # half the input forces streaming in >= 2 blocks
        nbytes = tab.symbols.nbytes + tab.values.nbytes
        ll_str, mu_str = train(nbytes // 2)
        np.testing.assert_allclose(ll_str, ll_res, rtol=1e-5)
        np.testing.assert_allclose(mu_str, mu_res, rtol=1e-4, atol=1e-5)

    def test_supervised_gauss_counts(self, rng):
        L = 1000
        states = np.repeat([0, 1], L // 2)
        x = np.where(states == 0, rng.normal(1, 1, L),
                     rng.normal(-1, 0.5, L)).astype(np.float32)
        x[::17] = np.nan
        gp = supervised_gauss(2, [x[:, None]], [states])
        fin = np.isfinite(x)
        for s, lo, hi in [(0, 0, L // 2), (1, L // 2, L)]:
            sel = fin & (states == s)
            np.testing.assert_allclose(
                float(gp.mu[s, 0]), x[sel].mean(), rtol=1e-4
            )


@pytest.fixture
def gauss_fixture(tmp_path):
    """2-state genome where only a numeric score track separates
    the states (distribution=gaussian on valCol=4)."""
    rng = np.random.RandomState(5)
    L = 2000
    truth = np.zeros(L, int)
    for s in range(200, L - 200, 500):
        truth[s : s + 200] = 1
    rows = []
    for i in range(0, L, 10):
        v = rng.normal(4.0 if truth[i] else 0.0, 1.0)
        rows.append(("chr1", i, min(i + 10, L), "x", f"{v:.4f}"))
    bed = str(tmp_path / "g.bed")
    with open(bed, "w") as fh:
        for r in rows:
            fh.write("\t".join(str(v) for v in r) + "\n")
    xml = tmp_path / "t.xml"
    xml.write_text(
        "<teModelConfig>"
        f'<track name="g" path="{bed}" distribution="gaussian" '
        'valCol="4"/>'
        "</teModelConfig>"
    )
    truth_rows = []
    start = 0
    for i in range(1, L + 1):
        if i == L or truth[i] != truth[i - 1]:
            truth_rows.append(
                ("chr1", start, i, "TE" if truth[start] else "BG")
            )
            start = i
    tb = str(tmp_path / "truth.bed")
    write_bed_intervals(truth_rows, tb)
    rb = str(tmp_path / "r.bed")
    write_bed_intervals([("chr1", 0, L)], rb)
    return dict(dir=tmp_path, xml=str(xml), truth=truth,
                truth_bed=tb, regions=rb, L=L)


class TestGaussCli:
    def _accuracy(self, bed, truth, L):
        best = 0.0
        iv = read_bed_intervals(bed, ncol=4)
        names = sorted(set(r[3] for r in iv))
        for perm in range(2):
            m = {n: (i + perm) % 2 for i, n in enumerate(names)}
            p = np.full(L, -1)
            for c, s, e, n in iv:
                p[s:e] = m.get(n, -1)
            best = max(best, (p == truth).mean())
        return best

    def test_em_train_eval_roundtrip(self, gauss_fixture):
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.cli import eval as cli_eval
        from tehmm_tpu.models.hmm import MultitrackHmm

        f = gauss_fixture
        model_path = str(f["dir"] / "m.npz")
        rc = cli_train.main(
            [f["xml"], f["regions"], model_path, "--numStates", "2",
             "--iter", "30", "--seed", "1"]
        )
        assert rc == 0
        m = MultitrackHmm.load(model_path)
        assert m.gauss is not None
        mus = np.sort(np.asarray(m.gauss.mu[:, 0]))
        np.testing.assert_allclose(mus, [0.0, 4.0], atol=0.4)

        out = str(f["dir"] / "p.bed")
        rc = cli_eval.main(
            [f["xml"], model_path, f["regions"], "--bed", out,
             "--chunk", "512", "--halo", "64"]
        )
        assert rc == 0
        acc = self._accuracy(out, f["truth"], f["L"])
        assert acc > 0.95, acc

    def test_supervised_train_eval(self, gauss_fixture):
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.cli import eval as cli_eval

        f = gauss_fixture
        model_path = str(f["dir"] / "ms.npz")
        rc = cli_train.main(
            [f["xml"], f["truth_bed"], model_path, "--supervised"]
        )
        assert rc == 0
        out = str(f["dir"] / "ps.bed")
        rc = cli_eval.main(
            [f["xml"], model_path, f["regions"], "--bed", out]
        )
        assert rc == 0
        acc = self._accuracy(out, f["truth"], f["L"])
        assert acc > 0.95, acc

    def test_view_prints_gaussian_params(self, gauss_fixture, capsys):
        """view on a gaussian model shows per-state mean/sd, not a
        symbol table (reference: teHmmView output [R])."""
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.cli import view as cli_view

        f = gauss_fixture
        model_path = str(f["dir"] / "mv.npz")
        rc = cli_train.main(
            [f["xml"], f["truth_bed"], model_path, "--supervised"]
        )
        assert rc == 0
        capsys.readouterr()
        rc = cli_view.main([model_path])
        assert rc == 0
        out = capsys.readouterr().out
        assert "track g (gaussian)" in out
        means = sorted(
            float(ln.split("mean=")[1].split()[0])
            for ln in out.splitlines() if "mean=" in ln
        )
        assert len(means) == 2
        assert abs(means[0] - 0.0) < 0.5 and abs(means[1] - 4.0) < 0.5
        assert all("sd=" in ln for ln in out.splitlines()
                   if "mean=" in ln)

    def test_maxpost_and_exact_decode(self, gauss_fixture):
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.cli import eval as cli_eval

        f = gauss_fixture
        model_path = str(f["dir"] / "mm.npz")
        cli_train.main(
            [f["xml"], f["truth_bed"], model_path, "--supervised"]
        )
        mp = str(f["dir"] / "mp.bed")
        rc = cli_eval.main(
            [f["xml"], model_path, f["regions"], "--bed", mp,
             "--maxPost", "--chunk", "512"]
        )
        assert rc == 0
        assert self._accuracy(mp, f["truth"], f["L"]) > 0.95
        ex = str(f["dir"] / "ex.bed")
        rc = cli_eval.main(
            [f["xml"], model_path, f["regions"], "--bed", ex,
             "--exact", "--chunk", "512"]
        )
        assert rc == 0
        # exact decode == stitched decode on this fixture
        vit = str(f["dir"] / "v.bed")
        cli_eval.main(
            [f["xml"], model_path, f["regions"], "--bed", vit,
             "--chunk", "512", "--halo", "64"]
        )
        assert read_bed_intervals(ex, ncol=4) == \
            read_bed_intervals(vit, ncol=4)

    def test_reps_batched_restarts(self, gauss_fixture):
        """--reps with gaussian tracks uses the vmapped restart path
        and still recovers the planted means (reference: teHmmTrain
        --reps [R])."""
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.models.hmm import MultitrackHmm

        f = gauss_fixture
        model_path = str(f["dir"] / "mr.npz")
        rc = cli_train.main(
            [f["xml"], f["regions"], model_path, "--numStates", "2",
             "--iter", "25", "--seed", "3", "--reps", "3"]
        )
        assert rc == 0
        m = MultitrackHmm.load(model_path)
        assert m.gauss is not None
        mus = np.sort(np.asarray(m.gauss.mu[:, 0]))
        np.testing.assert_allclose(mus, [0.0, 4.0], atol=0.4)

    def test_cfg_decode_uses_gaussian_emissions(self, gauss_fixture):
        """A --cfg model over a gaussian track decodes with the normal
        densities in its unary terms (pair matching untouched)."""
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.cli import eval as cli_eval

        f = gauss_fixture
        model_path = str(f["dir"] / "mcfg.npz")
        rc = cli_train.main(
            [f["xml"], f["truth_bed"], model_path, "--supervised",
             "--cfg", "--pairStates", "TE", "--maxSpan", "256"]
        )
        assert rc == 0
        out = str(f["dir"] / "pcfg.bed")
        rc = cli_eval.main(
            [f["xml"], model_path, f["regions"], "--bed", out,
             "--maxSpan", "256"]
        )
        assert rc == 0
        acc = self._accuracy(out, f["truth"], f["L"])
        # without the gaussian unary terms the only track is constant-
        # missing, so accuracy would sit at the base-rate (~0.68)
        assert acc > 0.95, acc

    def test_segment_train_eval(self, gauss_fixture):
        """--segment with a gaussian track: one mean-value observation
        per segment, --segLen length scaling (reference: teHmmTrain/
        teHmmEval --segment + track.py distribution=gaussian [R?])."""
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.cli import eval as cli_eval
        from tehmm_tpu.io.segments import load_segment_data
        from tehmm_tpu.io.trackxml import TrackList

        f = gauss_fixture
        # the fixture's 10bp value windows are book-ended: use them as
        # the segment query (the segment-tracks output shape)
        segs = [
            r[:3] for r in read_bed_intervals(
                str(f["dir"] / "g.bed"), ncol=3
            )
        ]
        seg_bed = str(f["dir"] / "segs.bed")
        write_bed_intervals(segs, seg_bed)

        # per-segment values are the (constant) window values
        tl = TrackList(f["xml"])
        _td, seg_tables = load_segment_data(tl, segs)
        assert seg_tables[0].values is not None
        assert seg_tables[0].values.shape == (len(segs), 1)
        assert np.isfinite(seg_tables[0].values).all()

        model_path = str(f["dir"] / "mseg.npz")
        rc = cli_train.main(
            [f["xml"], seg_bed, model_path, "--numStates", "2",
             "--iter", "30", "--seed", "1", "--segment", "--segLen"]
        )
        assert rc == 0
        out = str(f["dir"] / "pseg.bed")
        rc = cli_eval.main(
            [f["xml"], model_path, seg_bed, "--bed", out,
             "--segment", "--segLen"]
        )
        assert rc == 0
        acc = self._accuracy(out, f["truth"], f["L"])
        assert acc > 0.95, acc

    def test_device_loop_matches_host_loop(self, gauss_fixture):
        """--deviceLoop with gaussian tracks == the host-driven loop
        (one on-device while_loop carrying GaussParams)."""
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.models.hmm import MultitrackHmm

        f = gauss_fixture
        paths = {}
        for tag, extra in [("host", []), ("dev", ["--deviceLoop"])]:
            mp = str(f["dir"] / f"dl_{tag}.npz")
            rc = cli_train.main(
                [f["xml"], f["regions"], mp, "--numStates", "2",
                 "--iter", "8", "--seed", "1"] + extra
            )
            assert rc == 0
            paths[tag] = mp
        mh = MultitrackHmm.load(paths["host"])
        md = MultitrackHmm.load(paths["dev"])
        np.testing.assert_allclose(
            np.asarray(md.gauss.mu), np.asarray(mh.gauss.mu),
            rtol=1e-4, atol=1e-4,
        )
        np.testing.assert_allclose(
            np.asarray(md.params.log_trans),
            np.asarray(mh.params.log_trans), rtol=1e-4, atol=1e-4,
        )

    def test_stats_reps_match_loop(self, gauss_fixture, rng):
        """em_stats_reps with a gaussian stack == per-restart
        em_sufficient_stats."""
        import jax
        import jax.numpy as jnp

        from tehmm_tpu.models.gauss import init_gauss
        from tehmm_tpu.models.params import init_random
        from tehmm_tpu.ops import em as em_ops

        S, V, B, L, R = 2, 4, 3, 50, 3
        sym = jnp.asarray(rng.randint(1, V, (B, L, 1)), jnp.int32)
        gv = jnp.asarray(rng.randn(B, L, 1), jnp.float32)
        lens = jnp.asarray([L, L - 7, L - 20], jnp.int32)
        ps = [init_random(S, [V], seed=r) for r in range(R)]
        gs = [
            init_gauss(S, [np.asarray(gv).reshape(-1, 1)], seed=r)
            for r in range(R)
        ]
        stack_p = jax.tree.map(lambda *xs: jnp.stack(xs), *ps)
        stack_g = jax.tree.map(lambda *xs: jnp.stack(xs), *gs)
        got = em_ops.em_stats_reps(
            stack_p, sym, lens,
            gauss_params_stack=stack_g, gauss_values=gv,
        )
        for r in range(R):
            want = em_ops.em_sufficient_stats(
                ps[r], sym, lens, gauss_params=gs[r],
                gauss_values=gv, engine="xla",
            )
            np.testing.assert_allclose(
                float(got.loglik[r]), float(want.loglik), rtol=1e-5
            )
            np.testing.assert_allclose(
                np.asarray(got.gauss_x[r]), np.asarray(want.gauss_x),
                rtol=1e-4, atol=1e-4,
            )

    def test_sharded_em_matches_single(self, gauss_fixture, rng):
        """Gaussian moment stats psum-merge across the data mesh."""
        import jax

        from tehmm_tpu.io import TrackList, load_track_data, \
            read_bed_intervals as rbi
        from tehmm_tpu.models.hmm import MultitrackHmm
        from tehmm_tpu.ops import em as em_ops
        from tehmm_tpu.parallel import make_data_mesh
        from tehmm_tpu.parallel.em_sharded import sharded_em_stats
        from tehmm_tpu.models.gauss import init_gauss
        from tehmm_tpu.models.params import init_flat

        f = gauss_fixture
        tl = TrackList(f["xml"])
        td = load_track_data(tl, rbi(f["regions"], ncol=3))
        tab = td.tables[0]
        B, Lc = 8, 250
        sym = np.asarray(tab.symbols[:B * Lc]).reshape(B, Lc, 1)
        gv = np.asarray(tab.values[:B * Lc]).reshape(B, Lc, 1)
        params = init_flat(2, [1])
        gp = init_gauss(2, [tab.values], seed=0)
        lens = jnp.full((B,), Lc, jnp.int32)
        want = em_ops.em_sufficient_stats(
            params, jnp.asarray(sym.astype(np.int32)), lens,
            gauss_params=gp, gauss_values=jnp.asarray(gv),
            engine="xla",
        )
        mesh = make_data_mesh(4)
        got = sharded_em_stats(
            params, jnp.asarray(sym.astype(np.int32)), lens, mesh,
            obs_weights=None, gauss_params=gp,
            gauss_values=jnp.asarray(gv),
        )
        np.testing.assert_allclose(
            float(got.loglik), float(want.loglik), rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(got.gauss_x), np.asarray(want.gauss_x),
            rtol=1e-4, atol=1e-3,
        )
