"""Test configuration: run everything on a virtual 8-device CPU mesh.

SURVEY.md §4: the rebuild adds what the reference never had — single-process
multi-device tests via ``--xla_force_host_platform_device_count`` so the
data-parallel psum/stitching logic is testable without several cards.  The
platform is forced through jax.config before any backend is initialized.

``TEHMM_TEST_PLATFORM=gpu`` leaves JAX on the GPU instead, for the on-card
tier (tests marked ``gpu``; README "Tests")::

    TEHMM_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu -q
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
# CLI tests call utils.platform.setup_jax in-process, which would enable
# the PERSISTENT compile cache for the whole pytest process.  A test run
# killed mid-compile leaves truncated cache entries whose read then
# segfaults/hangs later runs inside jax's compilation_cache (observed:
# full-suite hang in _compile_and_write_cache, then SIGSEGV in
# get_executable_and_time on the poisoned entry).  Tests never benefit
# from cross-process caching — disable it before anything imports jax.
os.environ["TEHMM_COMPILE_CACHE"] = "0"

import jax

if os.environ.get("TEHMM_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def random_hmm(rng, S, T, V, zero_trans_frac=0.0):
    """Random normalized HMM params as NumPy f64 (symbol 0 = missing)."""
    from tehmm_tpu.utils.common import LOG_ZERO

    start = rng.dirichlet(np.ones(S))
    trans = rng.dirichlet(np.ones(S), size=S)
    if zero_trans_frac > 0:
        mask = rng.rand(S, S) < zero_trans_frac
        np.fill_diagonal(mask, False)  # keep rows viable
        trans = np.where(mask, 0.0, trans)
        trans = trans / trans.sum(axis=1, keepdims=True)
    log_em = np.zeros((S, T, V))
    for t in range(T):
        p = rng.dirichlet(np.ones(V - 1), size=S)  # exclude missing symbol
        log_em[:, t, 1:] = np.log(p)
    log_start = np.where(start > 0, np.log(np.maximum(start, 1e-300)), LOG_ZERO)
    log_trans = np.where(trans > 0, np.log(np.maximum(trans, 1e-300)), LOG_ZERO)
    return log_start, log_trans, log_em


@pytest.fixture
def make_hmm(rng):
    return lambda S, T, V, **kw: random_hmm(rng, S, T, V, **kw)


@pytest.fixture
def gpu():
    """The GPU the on-card tests run on; skips them anywhere else."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with TEHMM_TEST_PLATFORM=gpu "
                    "on the card)")
    return jax.devices()[0]
