"""Golden-file parity tests against the float64 oracle outputs.

SURVEY.md §4: the parity contract is OUTPUTS — bit-identical Viterbi BED
on the bundled test tracks, tolerance-equal trained parameter tables.
The goldens in tests/data/golden were produced by tools/make_goldens.py
from the float64 NumPy oracle (the reference stand-in while the
reference mount is empty); when the real reference is runnable, re-run
it on tests/data and replace these files.
"""

import json
import os
import shutil

import numpy as np
import pytest

pytestmark = pytest.mark.smoke

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLD = os.path.join(DATA, "golden")


@pytest.fixture
def workdir(tmp_path):
    """Copy fixtures so relative track paths in the XML resolve."""
    for f in os.listdir(DATA):
        src = os.path.join(DATA, f)
        if os.path.isfile(src):
            shutil.copy(src, tmp_path / f)
    return tmp_path


class TestGoldenParity:
    def test_supervised_params_match(self, workdir):
        from tehmm_tpu.cli import train as cli_train
        from tehmm_tpu.models.hmm import MultitrackHmm

        model_path = str(workdir / "model.npz")
        rc = cli_train.main([
            str(workdir / "tracks.xml"), str(workdir / "truth.bed"),
            model_path, "--supervised",
        ])
        assert rc == 0
        model = MultitrackHmm.load(model_path)
        gold = np.load(os.path.join(GOLD, "supervised_params.npz"))
        meta = json.load(open(os.path.join(GOLD, "metrics.json")))
        assert model.state_names == meta["state_names"]
        assert model.alphabet_sizes == meta["alphabet_sizes"]
        np.testing.assert_allclose(
            np.asarray(model.params.log_trans), gold["log_trans"],
            rtol=1e-5, atol=1e-5,
        )
        got_em = np.asarray(model.params.log_em)
        want_em = gold["log_em"]
        np.testing.assert_allclose(
            got_em, want_em[:, :, : got_em.shape[2]],
            rtol=1e-4, atol=1e-4,
        )

    def test_viterbi_bed_bit_exact(self, workdir):
        """The production decode must reproduce the float64 oracle BED
        byte-for-byte (BASELINE.json output-parity contract)."""
        from tehmm_tpu.cli import eval as cli_eval
        from tehmm_tpu.cli import train as cli_train

        model_path = str(workdir / "model.npz")
        cli_train.main([
            str(workdir / "tracks.xml"), str(workdir / "truth.bed"),
            model_path, "--supervised",
        ])
        out_bed = str(workdir / "pred.bed")
        rc = cli_eval.main([
            str(workdir / "tracks.xml"), model_path,
            str(workdir / "regions.bed"), "--bed", out_bed,
        ])
        assert rc == 0
        got = open(out_bed).read()
        want = open(os.path.join(GOLD, "viterbi.bed")).read()
        assert got == want

    def test_loglik_close_to_oracle(self, workdir, capsys):
        from tehmm_tpu.cli import eval as cli_eval
        from tehmm_tpu.cli import train as cli_train

        model_path = str(workdir / "model.npz")
        cli_train.main([
            str(workdir / "tracks.xml"), str(workdir / "truth.bed"),
            model_path, "--supervised",
        ])
        capsys.readouterr()
        cli_eval.main([
            str(workdir / "tracks.xml"), model_path,
            str(workdir / "regions.bed"),
        ])
        got_ll = float(capsys.readouterr().out.strip())
        meta = json.load(open(os.path.join(GOLD, "metrics.json")))
        assert abs(got_ll - meta["loglik"]) < 1e-3 * abs(meta["loglik"])
