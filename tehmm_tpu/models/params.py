"""HMM parameters as a JAX pytree.

The reference keeps parameters as attributes of a mutable ``MultitrackHmm``
object (reference: hmm.py `MultitrackHmm`, basehmm.py `_BaseHMM`; SURVEY.md
§2a).  The rebuild represents them as an immutable pytree of arrays so
the whole EM step is a pure jittable function and the parameters shard /
replicate naturally under ``jax.sharding``.

Conventions
-----------
* All probabilities are stored in natural-log space, float32.
* "log zero" is the finite ``LOG_ZERO`` (see utils.common) — never IEEE -inf.
* ``log_em`` is padded to the maximum alphabet size across tracks; entries
  for symbols ``v >= alphabet_size[t]`` are never selected by any one-hot
  and are stored as ``0.0`` so they are inert inside matmuls.
* Symbol 0 of every track is reserved for *missing data* and always emits
  log-prob 0.0 (probability 1) in every state, reproducing the reference's
  "missing symbol is ignored" semantics (reference: emission.py, SURVEY.md
  §2a "missing-data symbol emits log-prob 0").
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tehmm_tpu.utils.common import LOG_ZERO

# Reserved per-track symbol index for missing/unannotated positions.
MISSING_SYMBOL = 0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HmmParams:
    """Pure-array HMM parameters (the device-side model).

    Attributes:
      log_start: f32[S] log initial state probabilities.
      log_trans: f32[S, S] log transition probabilities, row i -> col j.
      log_em:    f32[S, T, V] per-state per-track categorical log emission
                 probabilities, padded to V = max alphabet size.
    """

    log_start: jax.Array
    log_trans: jax.Array
    log_em: jax.Array

    @property
    def num_states(self) -> int:
        return self.log_start.shape[0]

    @property
    def num_tracks(self) -> int:
        return self.log_em.shape[1]

    @property
    def max_symbols(self) -> int:
        return self.log_em.shape[2]


def _symbol_mask(num_tracks: int, max_symbols: int,
                 alphabet_sizes: Sequence[int]) -> np.ndarray:
    """bool[T, V]: True where symbol v is a *real, non-missing* symbol."""
    mask = np.zeros((num_tracks, max_symbols), dtype=bool)
    for t, size in enumerate(alphabet_sizes):
        mask[t, 1:size] = True  # symbol 0 = missing, excluded
    return mask


def apply_emission_conventions(
    log_em: np.ndarray, alphabet_sizes: Sequence[int]
) -> np.ndarray:
    """Force the missing-symbol and padding conventions onto a log_em table."""
    S, T, V = log_em.shape
    out = np.array(log_em, dtype=np.float32, copy=True)
    mask = _symbol_mask(T, V, alphabet_sizes)
    out[:, :, MISSING_SYMBOL] = 0.0
    out[:, ~mask & (np.arange(V)[None, :] != MISSING_SYMBOL)] = 0.0
    return out


def init_flat(
    num_states: int, alphabet_sizes: Sequence[int]
) -> HmmParams:
    """Uniform (flat) initialization (reference: emission.py initParams(flat),
    basehmm defaults; SURVEY.md §2a)."""
    S = num_states
    T = len(alphabet_sizes)
    V = max(int(v) for v in alphabet_sizes)
    log_start = np.full((S,), -np.log(S), dtype=np.float32)
    log_trans = np.full((S, S), -np.log(S), dtype=np.float32)
    log_em = np.zeros((S, T, V), dtype=np.float32)
    for t, size in enumerate(alphabet_sizes):
        n_real = max(int(size) - 1, 1)  # exclude missing symbol
        log_em[:, t, 1:size] = -np.log(n_real)
    log_em = apply_emission_conventions(log_em, alphabet_sizes)
    return HmmParams(
        log_start=jnp.asarray(log_start),
        log_trans=jnp.asarray(log_trans),
        log_em=jnp.asarray(log_em),
    )


def init_random(
    num_states: int,
    alphabet_sizes: Sequence[int],
    seed: int,
    rand_range: tuple[float, float] = (0.1, 0.9),
) -> HmmParams:
    """Random initialization for EM restarts (reference: teHmmTrain.py
    ``--emRandRange`` + ``--seed``; SURVEY.md §2b).

    Emission weights are drawn uniformly from ``rand_range`` then
    normalized; start/transition start flat (the reference's EM also only
    randomizes emissions by default).
    """
    rng = np.random.RandomState(seed)
    flat = init_flat(num_states, alphabet_sizes)
    S = num_states
    T = len(alphabet_sizes)
    V = max(int(v) for v in alphabet_sizes)
    log_em = np.zeros((S, T, V), dtype=np.float32)
    lo, hi = rand_range
    for t, size in enumerate(alphabet_sizes):
        n_real = int(size) - 1
        if n_real <= 0:
            continue
        w = rng.uniform(lo, hi, size=(S, n_real))
        w = w / w.sum(axis=1, keepdims=True)
        log_em[:, t, 1:size] = np.log(w)
    log_em = apply_emission_conventions(log_em, alphabet_sizes)
    return HmmParams(
        log_start=flat.log_start,
        log_trans=flat.log_trans,
        log_em=jnp.asarray(log_em),
    )


def clamp_log(x: np.ndarray | jax.Array) -> jax.Array:
    """log with zeros mapped to LOG_ZERO instead of -inf."""
    x = jnp.asarray(x)
    return jnp.where(x > 0, jnp.log(jnp.maximum(x, 1e-300)), LOG_ZERO)


# ---------------------------------------------------------------------------
# Persistence.  The reference pickles the whole MultitrackHmm object
# (reference: modelIO.py saveModel/loadModel; SURVEY.md §2a).  The rebuild
# saves arrays as .npz plus a JSON sidecar carrying the host-side metadata
# (state names, track specs, category maps) supplied by the caller, so a
# model file is self-contained for decoding: symbols at eval time MUST come
# from the maps saved at train time (SURVEY.md §3.2 note).
# ---------------------------------------------------------------------------

def save_model(
    path: str, params: HmmParams, meta: dict,
    extra_arrays: dict | None = None,
) -> None:
    """``extra_arrays``: additional named arrays persisted alongside the
    core tables (e.g. gaussian-track means/variances)."""
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        log_start=np.asarray(params.log_start),
        log_trans=np.asarray(params.log_trans),
        log_em=np.asarray(params.log_em),
        meta=np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8
        ),
        **{k: np.asarray(v) for k, v in (extra_arrays or {}).items()},
    )


def load_model(path: str) -> tuple[HmmParams, dict, dict]:
    """Returns (params, meta, extra_arrays)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    core = {"log_start", "log_trans", "log_em", "meta"}
    with np.load(path) as z:
        params = HmmParams(
            log_start=jnp.asarray(z["log_start"]),
            log_trans=jnp.asarray(z["log_trans"]),
            log_em=jnp.asarray(z["log_em"]),
        )
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        extra = {k: z[k] for k in z.files if k not in core}
    return params, meta, extra
