"""On-card tier: the GPU kernels compiled by Triton (not interpreted) at
real state widths, against the XLA scans, and the engine gate on a real
GPU.  Every test takes the ``gpu`` fixture and skips without a card; run
them on one with

    TEHMM_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu -q
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("S", [20, 40, 64, 128])
@pytest.mark.parametrize("T", [5, 15])
def test_kernels_match_xla_at_real_width(gpu, S, T):
    from tehmm_tpu.ops import gpu_kernels as gk
    from tehmm_tpu.utils.kernel_bench import (
        TOLERANCES, check_passes, check_shape, make_inputs,
    )

    kinds = tuple(k for k, cap in gk.MAX_STATES.items() if S <= cap)
    params, symbols, lengths = make_inputs(S, T, 8, 512, 1024)
    err = check_shape(params, symbols, lengths, kinds)
    assert check_passes(err), (err, TOLERANCES)


def test_auto_engine_is_the_kernel_on_gpu(gpu):
    from tehmm_tpu.ops import gpu_kernels as gk

    assert gk.select_engine("estep", 40) == "kernel"
    assert gk.select_engine("viterbi", 128) == "kernel"
    assert gk.select_engine("estep", gk.MAX_STATES["estep"] + 1) == "xla"


def test_estep_on_card_matches_oracle(gpu):
    import jax.numpy as jnp

    from tehmm_tpu import oracle
    from tehmm_tpu.ops import em
    from tehmm_tpu.utils.kernel_bench import make_inputs

    params, symbols, _ = make_inputs(40, 15, 8, 4, 4096)
    symbols = symbols[:1]                 # one full-length row
    st = em.em_sufficient_stats(params, jnp.asarray(symbols))
    p = [np.asarray(a, np.float64)
         for a in (params.log_start, params.log_trans, params.log_em)]
    obs = oracle.obs_log_likelihoods(p[2], symbols[0])
    _, want = oracle.forward(p[0], p[1], obs)
    assert abs(float(st.loglik) - want) <= 1e-5 * abs(want)
