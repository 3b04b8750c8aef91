"""Host-side GPU setup: the persistent compile cache and the one-card-
per-worker rule for --numProcesses pools.  Both are decided without a
card, so they are tested here with fake device counts."""

import multiprocessing as mp
import os

import jax
import pytest

from tehmm_tpu.utils import gpu, platform


@pytest.fixture
def config_updates(monkeypatch):
    """Record every jax.config.update setup_jax makes (and apply none)."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    for var in ("TEHMM_COMPILE_CACHE", "JAX_COMPILATION_CACHE_DIR",
                "TEHMM_PLATFORM", "TEHMM_DEBUG_NANS"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_cache_env_dir_is_honoured(config_updates, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(platform, "_gpu_run_expected", lambda jax: True)
    platform.setup_jax()
    assert "jax_compilation_cache_dir" not in config_updates
    assert "jax_enable_compilation_cache" not in config_updates


def test_cache_default_is_the_checkout_path(config_updates, monkeypatch):
    monkeypatch.setattr(platform, "_gpu_run_expected", lambda jax: True)
    platform.setup_jax()
    assert config_updates["jax_compilation_cache_dir"] == \
        platform.DEFAULT_CACHE_DIR
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert platform.DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_cache_default_skipped_off_gpu(config_updates, monkeypatch):
    monkeypatch.setattr(platform, "_gpu_run_expected", lambda jax: False)
    platform.setup_jax()
    assert "jax_compilation_cache_dir" not in config_updates


def test_cache_disabled_by_env(config_updates, monkeypatch, tmp_path):
    monkeypatch.setenv("TEHMM_COMPILE_CACHE", "0")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(platform, "_gpu_run_expected", lambda jax: True)
    platform.setup_jax()
    assert config_updates == {"jax_enable_compilation_cache": False}


def test_cpu_pinned_platform_expects_no_gpu():
    assert jax.config.jax_platforms == "cpu"      # tests/conftest.py
    assert not platform._gpu_run_expected(jax)


def test_worker_k_gets_card_k(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert gpu.worker_cards(3, 4) == ["0", "1", "2"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert gpu.worker_cards(2, 2) == ["3", "5"]


def test_too_many_workers_raise_on_gpu(monkeypatch):
    monkeypatch.setattr(gpu, "visible_gpu_count", lambda: 2)
    ctx = mp.get_context("spawn")
    with pytest.raises(ValueError, match="numProcesses 3"):
        gpu.pool_pinning(ctx, 3, None)


def test_pool_pinning_hands_out_cards(monkeypatch):
    monkeypatch.setattr(gpu, "visible_gpu_count", lambda: 2)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    ctx = mp.get_context("spawn")
    kw = gpu.pool_pinning(ctx, 2, "cuda")
    assert kw["initializer"] is gpu.pin_worker
    (queue,) = kw["initargs"]
    for card in ("0", "1"):
        gpu.pin_worker(queue)
        assert os.environ["CUDA_VISIBLE_DEVICES"] == card
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")


def test_cpu_workers_are_not_pinned(monkeypatch):
    monkeypatch.setattr(gpu, "visible_gpu_count", lambda: 1)
    ctx = mp.get_context("spawn")
    assert gpu.pool_pinning(ctx, 4, "cpu") == {}
    monkeypatch.setattr(gpu, "visible_gpu_count", lambda: 0)
    assert gpu.pool_pinning(ctx, 4, None) == {}


def test_visible_gpu_count_reads_the_env(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2")
    assert gpu.visible_gpu_count() == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert gpu.visible_gpu_count() == 0
