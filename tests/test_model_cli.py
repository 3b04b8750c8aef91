"""Model facade + CLI integration tests (SURVEY.md §4: scripts invoked
via their main(argv) on bundled fixture tracks)."""

import numpy as np
import pytest

from tehmm_tpu.io import (
    Track,
    TrackList,
    load_track_data,
    read_bed_intervals,
    write_bed_intervals,
)
from tehmm_tpu.models.hmm import MultitrackHmm
from tehmm_tpu.cli import train as cli_train
from tehmm_tpu.cli import eval as cli_eval
from tehmm_tpu.cli import view as cli_view


@pytest.fixture
def fixture_dir(tmp_path):
    """Small 2-state genome: TE blocks inside background, 2 tracks."""
    rng = np.random.RandomState(42)
    L = 3000
    truth = np.zeros(L, dtype=int)
    # plant TE elements
    for s in range(200, L - 200, 500):
        truth[s : s + 150] = 1

    # track A: noisy indicator BED (value = X inside TE with p=.85)
    rows_a = []
    pos = 0
    while pos < L:
        run = rng.randint(20, 60)
        end = min(pos + run, L)
        is_te = truth[pos:end].mean() > 0.5
        p = 0.85 if is_te else 0.1
        val = "X" if rng.rand() < p else "Y"
        rows_a.append(("chr1", pos, end, val))
        pos = end
    bed_a = str(tmp_path / "a.bed")
    write_bed_intervals(rows_a, bed_a)

    # track B: coverage-ish binary track correlated with TE
    rows_b = [
        ("chr1", i, i + 10, "z")
        for i in range(0, L, 10)
        if truth[i] == 1 and rng.rand() < 0.8
    ]
    bed_b = str(tmp_path / "b.bed")
    write_bed_intervals(rows_b, bed_b)

    xml = tmp_path / "tracks.xml"
    xml.write_text(
        "<teModelConfig>\n"
        f'  <track name="a" path="{bed_a}"/>\n'
        f'  <track name="b" path="{bed_b}" distribution="binary"/>\n'
        "</teModelConfig>\n"
    )

    # truth BED for supervised training
    truth_rows = []
    start = 0
    for i in range(1, L + 1):
        if i == L or truth[i] != truth[i - 1]:
            name = "TE" if truth[start] == 1 else "BG"
            truth_rows.append(("chr1", start, i, name))
            start = i
    truth_bed = str(tmp_path / "truth.bed")
    write_bed_intervals(truth_rows, truth_bed)

    regions_bed = str(tmp_path / "regions.bed")
    write_bed_intervals([("chr1", 0, L)], regions_bed)

    return dict(
        dir=tmp_path, xml=str(xml), truth_bed=truth_bed,
        regions_bed=regions_bed, truth=truth, L=L,
    )


def _accuracy(pred_bed, truth, L, name_map):
    path = np.full(L, -1)
    for chrom, s, e, n in read_bed_intervals(pred_bed, ncol=4):
        path[s:e] = name_map.get(n, -1)
    return (path == truth).mean()


class TestSupervisedPipeline:
    def test_train_eval_roundtrip(self, fixture_dir):
        f = fixture_dir
        model_path = str(f["dir"] / "model.npz")
        rc = cli_train.main(
            [f["xml"], f["truth_bed"], model_path, "--supervised"]
        )
        assert rc == 0

        out_bed = str(f["dir"] / "pred.bed")
        rc = cli_eval.main(
            [f["xml"], model_path, f["regions_bed"], "--bed", out_bed,
             "--chunk", "512", "--halo", "64"]
        )
        assert rc == 0
        acc = _accuracy(out_bed, f["truth"], f["L"], {"BG": 0, "TE": 1})
        assert acc > 0.9, acc

    def test_eval_maxpost(self, fixture_dir):
        f = fixture_dir
        model_path = str(f["dir"] / "model.npz")
        cli_train.main([f["xml"], f["truth_bed"], model_path, "--supervised"])
        out_bed = str(f["dir"] / "mp.bed")
        rc = cli_eval.main(
            [f["xml"], model_path, f["regions_bed"], "--bed", out_bed,
             "--maxPost"]
        )
        assert rc == 0
        acc = _accuracy(out_bed, f["truth"], f["L"], {"BG": 0, "TE": 1})
        assert acc > 0.9, acc

    def test_view_prints_model(self, fixture_dir, capsys):
        f = fixture_dir
        model_path = str(f["dir"] / "model.npz")
        cli_train.main([f["xml"], f["truth_bed"], model_path, "--supervised"])
        rc = cli_view.main([model_path])
        assert rc == 0
        out = capsys.readouterr().out
        assert "BG" in out and "TE" in out
        assert "transition matrix" in out


class TestUnsupervisedPipeline:
    def test_em_training_runs_and_separates(self, fixture_dir):
        f = fixture_dir
        model_path = str(f["dir"] / "um.npz")
        rc = cli_train.main(
            [f["xml"], f["regions_bed"], model_path,
             "--numStates", "2", "--iter", "30", "--seed", "3"]
        )
        assert rc == 0
        out_bed = str(f["dir"] / "upred.bed")
        cli_eval.main(
            [f["xml"], model_path, f["regions_bed"], "--bed", out_bed]
        )
        # label switching: accept either assignment
        acc0 = _accuracy(out_bed, f["truth"], f["L"], {"0": 0, "1": 1})
        acc1 = _accuracy(out_bed, f["truth"], f["L"], {"0": 1, "1": 0})
        assert max(acc0, acc1) > 0.85, (acc0, acc1)

    def test_semi_supervised_priors(self, fixture_dir):
        f = fixture_dir
        trans_prior = f["dir"] / "trans.txt"
        trans_prior.write_text(
            "# semi-supervised prior\n"
            "BG BG 0.98\nBG TE 0.02\nTE TE 0.9\nTE BG 0.1\n"
        )
        model_path = str(f["dir"] / "sm.npz")
        rc = cli_train.main(
            [f["xml"], f["regions_bed"], model_path,
             "--initTransProbs", str(trans_prior), "--fixTrans",
             "--iter", "20", "--seed", "5"]
        )
        assert rc == 0
        model = MultitrackHmm.load(model_path)
        assert model.state_names[:2] == ["BG", "TE"]
        trans = np.exp(np.asarray(model.params.log_trans))
        np.testing.assert_allclose(
            trans, [[0.98, 0.02], [0.1, 0.9]], atol=1e-5
        )

    def test_combined_trans_and_em_priors(self, fixture_dir):
        """--initTransProbs + --initEmProbs together: the emission prior
        must NOT clobber the transition prior (regression: the initEm
        branch used to rebuild the model from scratch, silently training
        --fixTrans runs with flat transitions)."""
        f = fixture_dir
        trans_prior = f["dir"] / "trans2.txt"
        trans_prior.write_text("BG BG 0.9\nBG TE 0.1\nTE TE 0.7\nTE BG 0.3\n")
        em_prior = f["dir"] / "em2.txt"
        em_prior.write_text("TE a X 0.8\nBG a Y 0.6\n")
        model_path = str(f["dir"] / "combo.npz")
        rc = cli_train.main(
            [f["xml"], f["regions_bed"], model_path,
             "--initTransProbs", str(trans_prior), "--fixTrans",
             "--initEmProbs", str(em_prior), "--fixEm",
             "--iter", "3", "--seed", "7"]
        )
        assert rc == 0
        model = MultitrackHmm.load(model_path)
        trans = np.exp(np.asarray(model.params.log_trans))
        bg = model.state_names.index("BG")
        te = model.state_names.index("TE")
        np.testing.assert_allclose(trans[bg, bg], 0.9, atol=1e-5)
        np.testing.assert_allclose(trans[te, te], 0.7, atol=1e-5)
        # emission prior applied too
        a_track = model.track_list.get_track_by_name("a")
        x_sym = model.category_maps["a"].get_map(
            a_track.bin("X"), update=False
        )
        em = np.exp(np.asarray(model.params.log_em))
        np.testing.assert_allclose(
            em[te, a_track.number, x_sym], 0.8, atol=1e-5
        )

    def test_reps_reapply_priors(self, fixture_dir):
        """--reps restarts must re-apply init priors so --fixTrans pins
        the USER's values on every rep (regression: rep>0 used to pin
        whatever the fresh random init produced)."""
        f = fixture_dir
        trans_prior = f["dir"] / "trans3.txt"
        trans_prior.write_text("BG BG 0.95\nBG TE 0.05\nTE TE 0.8\nTE BG 0.2\n")
        model_path = str(f["dir"] / "reps.npz")
        rc = cli_train.main(
            [f["xml"], f["regions_bed"], model_path,
             "--initTransProbs", str(trans_prior), "--fixTrans",
             "--reps", "3", "--iter", "3", "--seed", "11",
             "--emRandRange", "0.2,0.8"]
        )
        assert rc == 0
        model = MultitrackHmm.load(model_path)
        trans = np.exp(np.asarray(model.params.log_trans))
        bg = model.state_names.index("BG")
        te = model.state_names.index("TE")
        np.testing.assert_allclose(
            trans[[bg, te], [bg, te]], [0.95, 0.8], atol=1e-5
        )

    def test_force_trans_probs(self, fixture_dir):
        f = fixture_dir
        force = f["dir"] / "force.txt"
        force.write_text("A B 0.5\n")
        model_path = str(f["dir"] / "fm.npz")
        rc = cli_train.main(
            [f["xml"], f["regions_bed"], model_path,
             "--numStates", "2", "--forceTransProbs", str(force),
             "--iter", "5"]
        )
        assert rc == 0
        model = MultitrackHmm.load(model_path)
        trans = np.exp(np.asarray(model.params.log_trans))
        a = model.state_names.index("A")
        b = model.state_names.index("B")
        np.testing.assert_allclose(trans[a, b], 0.5, atol=1e-5)


class TestModelPersistence:
    def test_save_load_full_fidelity(self, fixture_dir):
        f = fixture_dir
        tl = TrackList(f["xml"])
        td = load_track_data(tl, [("chr1", 0, f["L"])])
        labeled = read_bed_intervals(f["truth_bed"], ncol=4)
        model = MultitrackHmm.supervised(td, labeled)
        p = str(f["dir"] / "m2.npz")
        model.save(p)
        loaded = MultitrackHmm.load(p)
        assert loaded.state_names == model.state_names
        np.testing.assert_array_equal(
            np.asarray(loaded.params.log_trans),
            np.asarray(model.params.log_trans),
        )
        assert [t.name for t in loaded.track_list] == ["a", "b"]
        # maps must behave identically
        cm_a = loaded.category_maps["a"]
        assert cm_a.get_map("X") == model.category_maps["a"].get_map("X")


class TestResume:
    def test_init_model_resumes_em(self, fixture_dir):
        """--initModel continues training from a checkpoint with at least
        the checkpoint's likelihood (SURVEY.md §5 checkpoint/resume)."""
        import json

        f = fixture_dir
        m1 = str(f["dir"] / "stage1.npz")
        log1 = str(f["dir"] / "m1.jsonl")
        cli_train.main(
            [f["xml"], f["regions_bed"], m1, "--numStates", "2",
             "--iter", "3", "--seed", "3", "--logJson", log1]
        )
        m2 = str(f["dir"] / "stage2.npz")
        log2 = str(f["dir"] / "m2.jsonl")
        cli_train.main(
            [f["xml"], f["regions_bed"], m2, "--initModel", m1,
             "--iter", "5", "--logJson", log2]
        )
        ll1 = [json.loads(l)["loglik"] for l in open(log1)]
        ll2 = [json.loads(l)["loglik"] for l in open(log2)]
        assert ll2[0] >= ll1[-1] - 1e-3 * abs(ll1[-1])
        assert ll2[-1] >= ll1[-1] - 1e-3 * abs(ll1[-1])

    def test_checkpoint_file_written(self, fixture_dir):
        f = fixture_dir
        ckpt = str(f["dir"] / "ck.npz")
        cli_train.main(
            [f["xml"], f["regions_bed"], str(f["dir"] / "out.npz"),
             "--numStates", "2", "--iter", "4",
             "--checkpoint", ckpt, "--checkpointEvery", "2"]
        )
        loaded = MultitrackHmm.load(ckpt)
        assert "iteration" in loaded.extra


class TestDeviceLoopCli:
    def test_device_loop_training(self, fixture_dir):
        import json

        f = fixture_dir
        model_path = str(f["dir"] / "dl.npz")
        log = str(f["dir"] / "dl.jsonl")
        rc = cli_train.main(
            [f["xml"], f["regions_bed"], model_path,
             "--numStates", "2", "--iter", "20", "--seed", "3",
             "--deviceLoop", "--logJson", log]
        )
        assert rc == 0
        lls = [json.loads(l)["loglik"] for l in open(log)]
        assert len(lls) >= 2
        for a, b in zip(lls, lls[1:]):
            assert b >= a - 1e-3 * abs(a)
        out_bed = str(f["dir"] / "dl.bed")
        cli_eval.main([f["xml"], model_path, f["regions_bed"],
                       "--bed", out_bed])
        acc0 = _accuracy(out_bed, f["truth"], f["L"], {"0": 0, "1": 1})
        acc1 = _accuracy(out_bed, f["truth"], f["L"], {"0": 1, "1": 0})
        assert max(acc0, acc1) > 0.85


class TestOversizedBatch:
    def test_fit_pass_blocks_match_flat(self, fixture_dir):
        """fit() must give the same training result whether the batch is
        processed flat or in pass-blocks (memory-bounding path)."""
        from tehmm_tpu.io import TrackList, load_track_data
        from tehmm_tpu.models import hmm as hmm_mod
        from tehmm_tpu.models.hmm import MultitrackHmm

        f = fixture_dir
        tl = TrackList(f["xml"])
        td = load_track_data(tl, [("chr1", 0, f["L"])])

        import tehmm_tpu.models.hmm as H

        def train():
            m = MultitrackHmm.initialized(
                2, td, init="random", seed=7
            )
            m.fit(td.tables, max_iterations=5, convergence_tol=0.0,
                  chunk_len=256)  # 12 chunk rows
            return np.asarray(m.params.log_trans)

        flat = train()
        orig = H._MAX_PASS_POSITIONS
        try:
            # 1024 positions per pass -> 4 rows/pass -> 3 passes
            H._MAX_PASS_POSITIONS = 1024
            split = train()
        finally:
            H._MAX_PASS_POSITIONS = orig
        np.testing.assert_allclose(flat, split, rtol=1e-4, atol=1e-5)

    def test_fit_host_streamed_matches_resident(self, fixture_dir):
        """Datasets over the device staging budget train through the
        host-streamed pass loop — equal to
        all-resident training up to f32 stat-summation order (the
        budget may cap the streamed block size below the resident pass
        size, reordering the EmStats accumulation)."""
        from tehmm_tpu.io import TrackList, load_track_data
        from tehmm_tpu.models.hmm import MultitrackHmm

        import tehmm_tpu.models.hmm as H

        f = fixture_dir
        tl = TrackList(f["xml"])
        td = load_track_data(tl, [("chr1", 0, f["L"])])

        def train(max_device_bytes=None):
            m = MultitrackHmm.initialized(
                2, td, init="random", seed=7
            )
            res = m.fit(
                td.tables, max_iterations=5, convergence_tol=0.0,
                chunk_len=256, max_device_bytes=max_device_bytes,
            )
            return np.asarray(m.params.log_trans), res.logliks

        orig = H._MAX_PASS_POSITIONS
        try:
            H._MAX_PASS_POSITIONS = 1024  # several blocks per epoch
            resident, ll_res = train()
            streamed, ll_str = train(max_device_bytes=1)  # force stream
        finally:
            H._MAX_PASS_POSITIONS = orig
        np.testing.assert_allclose(ll_str, ll_res, rtol=1e-5)
        np.testing.assert_allclose(
            streamed, resident, rtol=1e-4, atol=1e-5
        )

    def test_fit_host_streamed_with_segment_weights(self, fixture_dir):
        """obs_weight blocks must ride the host-streamed pass loop
        identically to resident training (segment --segLen mode)."""
        from tehmm_tpu.io import TrackList, load_track_data
        from tehmm_tpu.models.hmm import MultitrackHmm

        f = fixture_dir
        tl = TrackList(f["xml"])
        td = load_track_data(tl, [("chr1", 0, f["L"])])
        rng = np.random.RandomState(5)
        weights = [
            rng.randint(1, 5, size=len(t.symbols)).astype(np.float32)
            for t in td.tables
        ]

        def train(budget):
            m = MultitrackHmm.initialized(2, td, init="random", seed=9)
            res = m.fit(
                td.tables, max_iterations=4, convergence_tol=0.0,
                chunk_len=256, obs_weight_arrays=weights,
                max_device_bytes=budget,
            )
            return res.logliks, np.asarray(m.params.log_em)

        ll_res, em_res = train(None)
        nbytes = sum(t.symbols.nbytes for t in td.tables)
        ll_str, em_str = train(nbytes // 2)
        np.testing.assert_allclose(ll_str, ll_res, rtol=1e-5)
        np.testing.assert_allclose(em_str, em_res, rtol=1e-4, atol=1e-5)


class TestEmissionPriors:
    def test_init_and_force_em_probs(self, fixture_dir):
        """--initEmProbs seeds named states with emission values;
        --forceEmProbs overwrites entries after training
        (reference: teHmmTrain.py semi-supervised emission pinning)."""
        f = fixture_dir
        init_em = f["dir"] / "em_init.txt"
        init_em.write_text(
            "# state track value prob\n"
            "TE a X 0.8\n"
            "TE a Y 0.2\n"
            "BG a X 0.1\n"
            "BG a Y 0.9\n"
        )
        model_path = str(f["dir"] / "emprior.npz")
        rc = cli_train.main(
            [f["xml"], f["regions_bed"], model_path,
             "--initEmProbs", str(init_em), "--fixEm",
             "--iter", "10", "--seed", "1"]
        )
        assert rc == 0
        model = MultitrackHmm.load(model_path)
        assert model.state_names[:2] == ["TE", "BG"]
        cm = model.category_maps["a"]
        x = cm.get_map("X")
        te = model.state_names.index("TE")
        em = np.exp(np.asarray(model.params.log_em))
        # --fixEm froze the seeded values
        np.testing.assert_allclose(em[te, 0, x], 0.8, atol=1e-5)

        force_em = f["dir"] / "em_force.txt"
        force_em.write_text("0 a X 0.5\n")
        m2 = str(f["dir"] / "emforce.npz")
        rc = cli_train.main(
            [f["xml"], f["regions_bed"], m2,
             "--numStates", "2", "--forceEmProbs", str(force_em),
             "--iter", "5", "--seed", "1"]
        )
        assert rc == 0
        model2 = MultitrackHmm.load(m2)
        s0 = model2.state_names.index("0")
        cm2 = model2.category_maps["a"]
        em2 = np.exp(np.asarray(model2.params.log_em))
        np.testing.assert_allclose(
            em2[s0, 0, cm2.get_map("X")], 0.5, atol=1e-4
        )
        # row still sums to 1 over real symbols
        sizes = model2.alphabet_sizes
        np.testing.assert_allclose(
            em2[s0, 0, 1:sizes[0]].sum(), 1.0, atol=1e-4
        )

    def test_init_em_rows_renormalized(self, fixture_dir):
        """Partially-specified --initEmProbs rows must still sum to 1
        over real symbols."""
        f = fixture_dir
        init_em = f["dir"] / "partial.txt"
        init_em.write_text("TE a X 0.7\n")  # Y left free
        model_path = str(f["dir"] / "partial.npz")
        rc = cli_train.main(
            [f["xml"], f["regions_bed"], model_path,
             "--initEmProbs", str(init_em), "--fixEm", "--iter", "2"]
        )
        assert rc == 0
        model = MultitrackHmm.load(model_path)
        te = model.state_names.index("TE")
        sizes = model.alphabet_sizes
        em = np.exp(np.asarray(model.params.log_em))
        cm = model.category_maps["a"]
        np.testing.assert_allclose(
            em[te, 0, cm.get_map("X")], 0.7, atol=1e-5
        )
        np.testing.assert_allclose(
            em[te, 0, 1:sizes[0]].sum(), 1.0, atol=1e-5
        )


class TestEvalSemanticsRegressions:
    """Round-2 CLI review fixes."""

    def test_eval_binning_comes_from_model(self, tmp_path):
        """Eval must bin with the MODEL's saved track attributes even
        when the eval-time XML omits them (only data paths come from
        the eval XML) — divergent binning silently breaks the
        symbols-match-training invariant."""
        import numpy as np

        from tehmm_tpu.cli import eval as cli_eval
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.io.bed import read_bed_intervals

        rng = np.random.RandomState(0)
        L = 400
        truth = (np.arange(L) // 50) % 2
        val_bed = tmp_path / "vals.bed"
        with val_bed.open("w") as f:
            for i in range(L):
                # state 0 -> values ~10, state 1 -> values ~20
                v = 10 + 10 * truth[i]
                f.write(f"chr1\t{i}\t{i + 1}\tx\t{v}\n")
        truth_bed = tmp_path / "truth.bed"
        with truth_bed.open("w") as f:
            s = 0
            for i in range(1, L + 1):
                if i == L or truth[i] != truth[s]:
                    f.write(f"chr1\t{s}\t{i}\tstate{truth[s]}\n")
                    s = i
        regions = tmp_path / "regions.bed"
        regions.write_text(f"chr1\t0\t{L}\n")
        # training XML scales values by 0.1 -> symbols "1"/"2"
        train_xml = tmp_path / "train.xml"
        train_xml.write_text(
            '<teModelConfig>\n'
            f'  <track name="v" path="{val_bed}" valCol="4" '
            'scale="0.1"/>\n'
            "</teModelConfig>\n"
        )
        # eval XML OMITS the scale attribute
        eval_xml = tmp_path / "eval.xml"
        eval_xml.write_text(
            '<teModelConfig>\n'
            f'  <track name="v" path="{val_bed}" valCol="4"/>\n'
            "</teModelConfig>\n"
        )
        model = tmp_path / "m.npz"
        assert cli_train.main(
            [str(train_xml), str(truth_bed), str(model), "--supervised"]
        ) == 0
        out = tmp_path / "p.bed"
        assert cli_eval.main(
            [str(eval_xml), str(model), str(regions), "--bed", str(out)]
        ) == 0
        pred = np.full(L, -1)
        for _c, s, e, n in read_bed_intervals(str(out), ncol=4):
            pred[s:e] = int(n.removeprefix("state"))
        assert (pred == truth).mean() > 0.99

    def test_auto_state_names_skip_prior_numeric_names(self, tmp_path):
        """Numeric state names from a prior file must not collide with
        the auto-generated numeric names."""
        import numpy as np

        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.models.hmm import MultitrackHmm

        bed = tmp_path / "t.bed"
        bed.write_text("chr1\t0\t200\tx\n")
        regions = tmp_path / "regions.bed"
        regions.write_text("chr1\t0\t200\n")
        xml = tmp_path / "tracks.xml"
        xml.write_text(
            '<teModelConfig>\n'
            f'  <track name="t" path="{bed}" distribution="binary"/>\n'
            "</teModelConfig>\n"
        )
        prior = tmp_path / "trans.txt"
        prior.write_text("2\t3\t0.9\n")
        model = tmp_path / "m.npz"
        assert cli_train.main(
            [str(xml), str(regions), str(model), "--numStates", "4",
             "--iter", "2", "--initTransProbs", str(prior)]
        ) == 0
        m = MultitrackHmm.load(str(model))
        assert len(set(m.state_names)) == 4
        assert {"2", "3"} <= set(m.state_names)
