"""Engine parity: every recurrence engine against the float64 oracle.

Each scenario runs through the public entry points (``em_sufficient_stats``,
the row decoders of parallel/stitch, the chunked decoders) on every engine:
the XLA scans and the GPU kernels of ops/gpu_kernels.py in the Pallas
interpreter.  The reference is tehmm_tpu/oracle.py in float64 on the same
observation log-likelihoods (segment weights and gaussian densities
included), so a case passes only if the engine is right, not merely
consistent with another engine.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tehmm_tpu import oracle
from tehmm_tpu.models.emission import track_log_likelihoods
from tehmm_tpu.models.params import HmmParams
from tehmm_tpu.ops import dp, em, gpu_kernels as gk
from tehmm_tpu.parallel import stitch
from tests.conftest import random_hmm

ENGINES = {
    "xla": dict(engine="xla"),
    "kernel": dict(engine="kernel", interpret=True),
}
engines = pytest.mark.parametrize("engine", sorted(ENGINES))


def _params(log_start, log_trans, log_em):
    return HmmParams(
        log_start=jnp.asarray(log_start, jnp.float32),
        log_trans=jnp.asarray(log_trans, jnp.float32),
        log_em=jnp.asarray(log_em, jnp.float32),
    )


def _setup(seed, S, T=2, V=5, B=4, L=37, lengths=None, **hmm_kw):
    rng = np.random.RandomState(seed)
    params = _params(*random_hmm(rng, S, T, V, **hmm_kw))
    symbols = rng.randint(0, V, size=(B, L, T)).astype(np.int32)
    if lengths is None:
        lengths = [L, L - 9, 1, 0][:B]
    return rng, params, symbols, np.asarray(lengths, np.int32)


def _gauss(rng, S, B, L, G=2):
    from tehmm_tpu.models.gauss import GaussParams

    vals = rng.randn(B, L, G).astype(np.float32)
    vals[rng.rand(B, L, G) < 0.1] = np.nan
    gp = GaussParams(
        mu=jnp.asarray(rng.randn(S, G).astype(np.float32)),
        log_var=jnp.asarray(np.log(0.5 + rng.rand(S, G)).astype(np.float32)),
    )
    return gp, vals


def _obs(params, symbols, w=None, gp=None, vals=None):
    """The observation log-likelihoods every engine consumes (f32)."""
    obs = track_log_likelihoods(params.log_em, jnp.asarray(symbols))
    if gp is not None:
        from tehmm_tpu.models.gauss import gauss_log_likelihoods

        obs = obs + gauss_log_likelihoods(gp, jnp.asarray(vals))
    if w is not None:
        obs = obs * jnp.asarray(w)[:, :, None]
    return np.asarray(obs, np.float64)


def _f64(params):
    return (np.asarray(params.log_start, np.float64),
            np.asarray(params.log_trans, np.float64))


def _oracle_gamma(ls, lt, o):
    alpha, ll = oracle.forward(ls, lt, o)
    beta = oracle.backward(lt, o)
    return oracle.posterior(alpha, beta, ll), ll


def _check_estep(engine, params, symbols, lengths, w=None, gp=None,
                 vals=None):
    kw = {}
    if w is not None:
        kw["obs_weights"] = jnp.asarray(w)
    if gp is not None:
        kw.update(gauss_params=gp, gauss_values=jnp.asarray(vals))
    got = em.em_sufficient_stats(
        params, jnp.asarray(symbols), jnp.asarray(lengths), **kw,
        **ENGINES[engine],
    )
    obs = _obs(params, symbols, w, gp, vals)
    ls, lt = _f64(params)
    S, T, V = params.log_em.shape
    start, trans = np.zeros(S), np.zeros((S, S))
    em_c, ll = np.zeros((S, T, V)), 0.0
    gn = gx = gx2 = 0.0
    for b, n in enumerate(lengths):
        if n == 0:
            continue
        o = obs[b, :n]
        s0, tr, _, llb = oracle.baum_welch_counts(
            ls, lt, o, symbols[b, :n], V
        )
        gamma, _ = _oracle_gamma(ls, lt, o)
        if w is not None:
            gamma = gamma * np.asarray(w)[b, :n, None]
        start, trans, ll = start + s0, trans + tr, ll + llb
        for t in range(T):
            np.add.at(em_c, (slice(None), t, symbols[b, :n, t]), gamma.T)
        if gp is not None:
            x = vals[b, :n]
            m = np.isfinite(x)
            x0 = np.where(m, x, 0.0)
            gn = gn + gamma.T @ m
            gx = gx + gamma.T @ x0
            gx2 = gx2 + gamma.T @ (x0 * x0)
    np.testing.assert_allclose(float(got.loglik), ll, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.start), start, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.trans), trans,
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.em), em_c,
                               rtol=1e-3, atol=1e-3)
    assert float(got.n_obs) == float(np.sum(lengths))
    if gp is not None:
        for a, b in ((got.gauss_n, gn), (got.gauss_x, gx),
                     (got.gauss_x2, gx2)):
            np.testing.assert_allclose(np.asarray(a), b,
                                       rtol=1e-3, atol=1e-3)
    return got


def _check_viterbi_rows(engine, params, symbols, lengths, w=None,
                        gp=None, vals=None):
    got = stitch._decode_batch(
        params, symbols, lengths, rows_per_pass=len(lengths), weights=w,
        gauss_params=gp, values=vals, **ENGINES[engine],
    )
    obs = _obs(params, symbols, w, gp, vals)
    ls, lt = _f64(params)
    for b, n in enumerate(lengths):
        if n == 0:
            continue
        want, _ = oracle.viterbi(ls, lt, obs[b, :n])
        np.testing.assert_array_equal(got[b, :n], want, err_msg=f"row {b}")
    return got


def _check_maxpost_rows(engine, params, symbols, lengths, w=None,
                        gp=None, vals=None):
    got = stitch._posterior_batch(
        params, symbols, lengths, rows_per_pass=len(lengths),
        gauss_params=gp, values=vals, weights=w, **ENGINES[engine],
    )
    obs = _obs(params, symbols, w, gp, vals)
    ls, lt = _f64(params)
    for b, n in enumerate(lengths):
        if n == 0:
            continue
        gamma, _ = _oracle_gamma(ls, lt, obs[b, :n])
        top2 = np.sort(gamma, axis=-1)[:, -2:]
        decisive = top2[:, 1] - top2[:, 0] > 1e-4
        np.testing.assert_array_equal(
            got[b, :n][decisive], gamma.argmax(-1)[decisive],
            err_msg=f"row {b}",
        )


# ---------------------------------------------------------------- E-step

@engines
@pytest.mark.parametrize("S", [2, 20, 40])
def test_estep_ragged(engine, S):
    _, params, symbols, lengths = _setup(1, S)
    _check_estep(engine, params, symbols, lengths)


@engines
def test_estep_zero_transitions(engine):
    _, params, symbols, lengths = _setup(2, 5, zero_trans_frac=0.3)
    _check_estep(engine, params, symbols, lengths)


@engines
def test_estep_missing_symbols(engine):
    _, params, symbols, lengths = _setup(3, 3, L=16, B=2, lengths=[16, 16])
    symbols[0, :, 0] = 0                  # a whole track missing
    _check_estep(engine, params, symbols, lengths)


@engines
def test_estep_multi_tile(engine):
    """More rows than one kernel tile, random lengths: results come back
    in the original row order."""
    rng, params, symbols, _ = _setup(4, 3, B=37, L=11)
    lengths = rng.randint(0, 12, size=37).astype(np.int32)
    _check_estep(engine, params, symbols, lengths)


@engines
def test_estep_segment_weights(engine):
    rng, params, symbols, lengths = _setup(5, 5)
    w = rng.randint(1, 9, size=symbols.shape[:2]).astype(np.float32)
    _check_estep(engine, params, symbols, lengths, w=w)


@engines
def test_estep_gauss_tracks(engine):
    rng, params, symbols, lengths = _setup(6, 5, B=3, L=33)
    gp, vals = _gauss(rng, 5, 3, 33)
    _check_estep(engine, params, symbols, lengths, gp=gp, vals=vals)


@engines
def test_m_step_roundtrip(engine):
    """EM iterations on the engine's statistics never lower the
    likelihood (f32 tolerance)."""
    _, params, symbols, _ = _setup(7, 4, B=3, L=50)
    symbols = np.maximum(symbols, 1)
    sizes = jnp.asarray([5, 5])
    lls = []
    for _ in range(4):
        stats = em.em_sufficient_stats(
            params, jnp.asarray(symbols), **ENGINES[engine]
        )
        params = em.em_m_step(stats, params, sizes)
        lls.append(float(stats.loglik))
    assert all(b >= a - 1e-4 * abs(a) for a, b in zip(lls, lls[1:])), lls


# --------------------------------------------------------------- decodes

@engines
@pytest.mark.parametrize("S", [2, 20, 40])
def test_viterbi_rows_ragged(engine, S):
    _, params, symbols, lengths = _setup(8, S, L=41)
    _check_viterbi_rows(engine, params, symbols, lengths)


@engines
def test_viterbi_near_tie(engine):
    """Uniform model: exact ties everywhere — first-hit argmax must pick
    the lowest state both per step and at the end."""
    S, T, V, B, L = 4, 1, 3, 3, 23
    params = _params(
        np.log(np.full(S, 1.0 / S)), np.log(np.full((S, S), 1.0 / S)),
        np.log(np.full((S, T, V), 1.0 / V)),
    )
    rng = np.random.RandomState(9)
    symbols = rng.randint(0, V, size=(B, L, T)).astype(np.int32)
    _check_viterbi_rows(engine, params, symbols, np.asarray([L, L - 5, L]))


@engines
def test_viterbi_zero_transitions(engine):
    _, params, symbols, lengths = _setup(10, 6, zero_trans_frac=0.3)
    _check_viterbi_rows(engine, params, symbols, lengths)


@engines
def test_viterbi_segment_weights(engine):
    rng, params, symbols, lengths = _setup(11, 5)
    w = rng.randint(1, 9, size=symbols.shape[:2]).astype(np.float32)
    _check_viterbi_rows(engine, params, symbols, lengths, w=w)


@engines
def test_viterbi_gauss_tracks(engine):
    rng, params, symbols, lengths = _setup(12, 5, B=3, L=33)
    gp, vals = _gauss(rng, 5, 3, 33)
    _check_viterbi_rows(engine, params, symbols, lengths, gp=gp, vals=vals)


@engines
def test_viterbi_larger_state_count(engine):
    _, params, symbols, lengths = _setup(13, 72, T=1, V=4, B=2, L=9,
                                         lengths=[9, 9])
    _check_viterbi_rows(engine, params, symbols, lengths)


@engines
def test_viterbi_multi_tile(engine):
    rng, params, symbols, _ = _setup(14, 3, B=37, L=11)
    lengths = rng.randint(0, 12, size=37).astype(np.int32)
    _check_viterbi_rows(engine, params, symbols, lengths)


@engines
@pytest.mark.parametrize("S", [2, 20, 40])
def test_maxpost_rows_ragged(engine, S):
    _, params, symbols, lengths = _setup(15, S, L=41)
    _check_maxpost_rows(engine, params, symbols, lengths)


@engines
def test_maxpost_segment_weights(engine):
    rng, params, symbols, lengths = _setup(16, 5)
    w = rng.randint(1, 9, size=symbols.shape[:2]).astype(np.float32)
    _check_maxpost_rows(engine, params, symbols, lengths, w=w)


@engines
def test_maxpost_gauss_tracks(engine):
    rng, params, symbols, lengths = _setup(17, 5, B=3, L=33)
    gp, vals = _gauss(rng, 5, 3, 33)
    _check_maxpost_rows(engine, params, symbols, lengths, gp=gp, vals=vals)


@engines
@pytest.mark.parametrize("mode", ["viterbi", "maxpost"])
def test_chunked_decode_matches_oracle(engine, mode):
    """Halo-stitched whole-table decode (host-batched and resident) on
    the engine equals the monolithic oracle decode."""
    rng, params, _, _ = _setup(18, 4)
    tables = [rng.randint(1, 5, size=(n, 2)).astype(np.uint8)
              for n in (300, 129, 1)]
    ls, lt = _f64(params)
    decode = (stitch.viterbi_chunked if mode == "viterbi"
              else stitch.posterior_chunked)
    for resident in (False, True):
        paths, report = decode(
            params, tables, chunk_len=64, halo=32, rows_per_pass=4,
            resident=resident, **ENGINES[engine],
        )
        assert report.boundaries_ok
        for tab, got in zip(tables, paths):
            o = _obs(params, tab[None].astype(np.int32))[0]
            if mode == "viterbi":
                want, _ = oracle.viterbi(ls, lt, o)
            else:
                want = _oracle_gamma(ls, lt, o)[0].argmax(-1)
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------- kernel wrappers alone

@pytest.mark.parametrize("S", [2, 20, 40])
def test_kernel_recurrences_match_dp(S):
    """The kernels are twins of the dp scans: same outputs, same
    layout (alpha/beta to f32 rounding, paths and scores exact)."""
    rng = np.random.RandomState(19)
    ls, lt, _ = (jnp.asarray(a, jnp.float32)
                 for a in random_hmm(rng, S, 1, 3, zero_trans_frac=0.2))
    obs = jnp.asarray(3 * rng.randn(5, 21, S).astype(np.float32))
    lens = jnp.asarray([21, 20, 7, 1, 0])
    for got, want in zip(
        gk.forward_scaled(ls, lt, obs, lens, interpret=True),
        dp.forward_scaled(ls, lt, obs, lens),
    ):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6, atol=1e-5)
    for got, want in zip(gk.backward_scaled(lt, obs, lens, interpret=True),
                         dp.backward_scaled(lt, obs, lens)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6, atol=1e-5)
    (gp, gs), (wp, ws) = (gk.viterbi(ls, lt, obs, lens, interpret=True),
                          dp.viterbi(ls, lt, obs, lens))
    np.testing.assert_array_equal(np.asarray(gp), np.asarray(wp))
    np.testing.assert_array_equal(np.asarray(gs), np.asarray(ws))


def test_kernel_viterbi_single_position():
    rng = np.random.RandomState(20)
    ls, lt, _ = (jnp.asarray(a, jnp.float32) for a in random_hmm(rng, 3, 1, 3))
    obs = jnp.asarray(rng.randn(2, 1, 3).astype(np.float32))
    lens = jnp.asarray([1, 0])
    got = gk.viterbi(ls, lt, obs, lens, interpret=True)
    want = dp.viterbi(ls, lt, obs, lens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("S,Sp", [(1, 16), (2, 16), (16, 16), (17, 32),
                                  (40, 64), (128, 128), (129, 256)])
def test_padded_states(S, Sp):
    assert gk.padded_states(S) == Sp


def test_block_rows_fit_the_register_budget():
    assert gk.block_rows("estep", 64) == 16       # Triton dot: >= 16 rows
    for sp in (16, 32, 64, 128, 256):
        bt = gk.block_rows("viterbi", sp)
        assert bt >= 1 and bt * sp * sp <= max(8192, sp * sp)
        assert bt & (bt - 1) == 0                # a power of two


# -------------------------------------------------------- engine selector

def test_select_engine_cpu_is_xla():
    assert jax.default_backend() == "cpu"
    assert gk.select_engine("estep", 20) == "xla"
    assert gk.select_engine("viterbi", 20) == "xla"


@pytest.mark.parametrize("kind", ["estep", "viterbi"])
def test_select_engine_gpu_inside_envelope(kind, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert gk.select_engine(kind, 20) == "kernel"
    assert gk.select_engine(kind, gk.MAX_STATES[kind]) == "kernel"
    assert gk.select_engine(kind, gk.MAX_STATES[kind] + 1) == "xla"
    assert gk.select_engine(kind, 20, "xla") == "xla"


def test_explicit_kernel_off_gpu_raises():
    with pytest.raises(ValueError, match="GPU"):
        gk.select_engine("estep", 20, "kernel")
    assert gk.select_engine("estep", 20, "kernel", interpret=True) == "kernel"
    _, params, symbols, lengths = _setup(21, 3)
    with pytest.raises(ValueError, match="GPU"):
        em.em_sufficient_stats(params, jnp.asarray(symbols),
                               engine="kernel")
    with pytest.raises(ValueError, match="GPU"):
        stitch._decode_batch(params, symbols, lengths, 4, engine="kernel")


def test_unknown_engine_or_kind_raises():
    with pytest.raises(ValueError, match="engine"):
        gk.select_engine("estep", 20, "pallas")
    with pytest.raises(ValueError, match="kind"):
        gk.select_engine("forward", 20)


@engines
def test_sharded_estep_matches_single_device(engine):
    """The E-step inside shard_map (train --mesh) on each engine equals
    the single-device E-step."""
    from tehmm_tpu.parallel.em_sharded import sharded_em_stats
    from tehmm_tpu.parallel.mesh import make_data_mesh

    _, params, symbols, lengths = _setup(22, 5, B=4, L=17)
    sym, lens = jnp.asarray(symbols), jnp.asarray(lengths)
    got = sharded_em_stats(params, sym, lens, make_data_mesh(2),
                           **ENGINES[engine])
    want = em.em_sufficient_stats(params, sym, lens, engine="xla")
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-6)
    for f in ("start", "trans", "em"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-4, atol=1e-5)
