"""JAX platform/compile-cache setup for CLI entry points.

* ``TEHMM_PLATFORM`` env var (or the ``platform`` argument): force the
  JAX backend, e.g. ``cpu`` for host-only runs on a machine with a GPU.
* Persistent XLA compilation cache: CLI tools are separate processes,
  and the cache lets every invocation after the first skip its compiles.
  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
  nothing here sets another directory.  Otherwise the cache lives at the
  fixed in-checkout path ``DEFAULT_CACHE_DIR`` (listed in .gitignore),
  and only when the process will run on a GPU: XLA:CPU cache entries
  record the compiling host's CPU features and must not be served to
  another host.  ``TEHMM_COMPILE_CACHE=0`` disables the cache entirely.
* ``TEHMM_DEBUG_NANS=1``: dev-mode NaN guard (SURVEY.md §5 race-detection
  row) — flips ``jax_debug_nans`` so the first NaN-producing op raises
  with its location instead of silently corrupting downstream scans.
  Development only: it forces per-op sync checks and disqualifies some
  fusions.

Must run before any JAX backend is initialized (CLI mains call it first).
"""

from __future__ import annotations

import importlib.util
import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def _gpu_run_expected(jax) -> bool:
    """True when this process will run on a GPU, decided without
    initializing a backend: the platform is not pinned to the CPU and
    JAX's CUDA plugin is installed."""
    platforms = (jax.config.jax_platforms
                 or os.environ.get("JAX_PLATFORMS") or "")
    if platforms and "cuda" not in platforms and "gpu" not in platforms:
        return False
    for name in ("jax_plugins.xla_cuda12", "jax_plugins.xla_cuda13",
                 "jax_cuda12_plugin", "jax_cuda13_plugin"):
        try:
            if importlib.util.find_spec(name) is not None:
                return True
        except ImportError:
            continue
    return False


def setup_jax(platform: str | None = None) -> None:
    import jax

    platform = platform or os.environ.get("TEHMM_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)

    if os.environ.get("TEHMM_DEBUG_NANS", "").lower() in (
        "1", "on", "true", "yes"
    ):
        jax.config.update("jax_debug_nans", True)

    if os.environ.get("TEHMM_COMPILE_CACHE", "").strip() == "0":
        jax.config.update("jax_enable_compilation_cache", False)
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if _gpu_run_expected(jax):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def compile_cache_dir() -> str | None:
    """The persistent compile-cache directory in effect, or None."""
    import jax

    if not jax.config.jax_enable_compilation_cache:
        return None
    return jax.config.jax_compilation_cache_dir
