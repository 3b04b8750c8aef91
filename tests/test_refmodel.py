"""Reference-pickle import (io/refmodel.py, cli/import_model.py).

A best-effort tolerant unpickler for teHmm model pickles shortens the reference-day gap.  The tests
build a SYNTHETIC reference-style pickle — classes laid out per the
SURVEY.md §2a [R] reconstruction (sklearn-hmm startprob_/transmat_,
IndependentMultinomialEmissionModel.logProbs, stateNameMap, per-track
catMap) registered under fake teHmm module names — then delete the
modules so unpickling must go through the stub substitution path, and
assert the converted .npz round-trips through MultitrackHmm/eval.
"""

import pickle
import sys
import types

import numpy as np
import pytest

from tehmm_tpu.models.hmm import MultitrackHmm


def _make_reference_pickle(path, log_space_em=True, with_maps=True):
    """Pickle an object graph shaped like the [R] reconstruction of a
    teHmm MultitrackHmm, under fake 'teHmm.*' module names."""
    S, T, V = 3, 2, 4
    rng = np.random.RandomState(0)

    mod = types.ModuleType("teHmm_fake")
    sys.modules["teHmm_fake"] = mod

    def cls(_clsname, **attrs):
        c = getattr(mod, _clsname, None)
        if c is None:
            c = type(_clsname, (), {})
            c.__module__ = "teHmm_fake"
            setattr(mod, _clsname, c)
        o = c()
        o.__dict__.update(attrs)
        return o

    start = rng.dirichlet(np.ones(S))
    trans = rng.dirichlet(np.ones(S), size=S)
    em = rng.dirichlet(np.ones(V - 1), size=(S, T))
    log_em = np.full((S, T, V), -1e6)
    log_em[:, :, 1:] = np.log(em)

    catmaps = []
    for t in range(T):
        catmaps.append(cls(
            "CategoryMap",
            catMap={f"val{v}": v for v in range(1, V)},
            catMapBack={v: f"val{v}" for v in range(1, V)},
        ))
    tracks = [
        cls("Track", name=f"trk{t}", catMap=catmaps[t])
        for t in range(T)
    ]
    track_list = cls("TrackList", trackList=tracks)
    emission = cls(
        "IndependentMultinomialEmissionModel",
        logProbs=log_em if log_space_em else np.exp(log_em),
        numStates=S,
    )
    hmm = cls(
        "MultitrackHmm",
        startprob_=start,
        transmat_=trans,
        emissionModel=emission,
        stateNameMap=cls(
            "CategoryMap",
            catMap={"bg": 0, "LTR": 1, "TSD": 2},
        ) if with_maps else None,
        trackList=track_list if with_maps else None,
    )
    with open(path, "wb") as fh:
        pickle.dump(hmm, fh, protocol=2)
    del sys.modules["teHmm_fake"]    # force the stub path at load time
    return start, trans, log_em


class TestReferenceImport:
    def test_convert_roundtrip(self, tmp_path):
        from tehmm_tpu.io.refmodel import convert_reference_model

        mdl = str(tmp_path / "ref.mdl")
        start, trans, log_em = _make_reference_pickle(mdl)
        out = str(tmp_path / "model.npz")
        rep = convert_reference_model(mdl, out)
        assert any("emission" in f for f in rep["found"])
        assert any("transitions" in f for f in rep["found"])
        assert any("start" in f for f in rep["found"])

        model = MultitrackHmm.load(out)
        np.testing.assert_allclose(
            np.exp(np.asarray(model.params.log_start)), start,
            rtol=1e-5,
        )
        np.testing.assert_allclose(
            np.exp(np.asarray(model.params.log_trans)), trans,
            rtol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(model.params.log_em)[:, :, 1:],
            log_em[:, :, 1:], rtol=1e-4,
        )
        assert model.state_names == ["bg", "LTR", "TSD"]
        assert [t.name for t in model.track_list] == ["trk0", "trk1"]
        # category maps recovered: val1 -> 1
        assert model.category_maps["trk0"].get_map("val1") == 1

    def test_prob_space_emissions(self, tmp_path):
        from tehmm_tpu.io.refmodel import convert_reference_model

        mdl = str(tmp_path / "ref.mdl")
        _, _, log_em = _make_reference_pickle(mdl, log_space_em=False)
        out = str(tmp_path / "model.npz")
        convert_reference_model(mdl, out)
        model = MultitrackHmm.load(out)
        np.testing.assert_allclose(
            np.asarray(model.params.log_em)[:, :, 1:],
            log_em[:, :, 1:], rtol=1e-4,
        )

    def test_defaults_when_names_missing(self, tmp_path):
        from tehmm_tpu.io.refmodel import convert_reference_model

        mdl = str(tmp_path / "ref.mdl")
        _make_reference_pickle(mdl, with_maps=False)
        out = str(tmp_path / "model.npz")
        rep = convert_reference_model(mdl, out)
        assert any("state names" in d for d in rep["defaulted"])
        model = MultitrackHmm.load(out)
        assert model.state_names == ["0", "1", "2"]

    def test_unrecoverable_raises(self, tmp_path):
        from tehmm_tpu.io.refmodel import convert_reference_model

        mdl = str(tmp_path / "junk.mdl")
        with open(mdl, "wb") as fh:
            pickle.dump({"nothing": [1, 2, 3]}, fh)
        with pytest.raises(ValueError, match="could not recover"):
            convert_reference_model(mdl, str(tmp_path / "m.npz"))

    def test_cli(self, tmp_path, capsys):
        from tehmm_tpu.cli.import_model import main

        mdl = str(tmp_path / "ref.mdl")
        _make_reference_pickle(mdl)
        out = str(tmp_path / "model.npz")
        assert main([mdl, out]) == 0
        assert "recovered" in capsys.readouterr().out
        MultitrackHmm.load(out)

    def test_debug_nans_flag(self, monkeypatch):
        """TEHMM_DEBUG_NANS dev-mode guard (SURVEY.md §5)."""
        import jax

        from tehmm_tpu.utils.platform import setup_jax

        monkeypatch.setenv("TEHMM_DEBUG_NANS", "1")
        monkeypatch.setenv("TEHMM_COMPILE_CACHE", "0")
        try:
            setup_jax()
            assert jax.config.jax_debug_nans
        finally:
            jax.config.update("jax_debug_nans", False)
