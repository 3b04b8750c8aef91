"""MultitrackHmm: the user-facing model API.

Rebuild of the reference's ``MultitrackHmm`` (reference: hmm.py
`MultitrackHmm(_BaseHMM)`; SURVEY.md §2a): glues the parameter pytree, the
track configuration, the category maps and the state-name table together,
and exposes training (supervised / semi-supervised / unsupervised EM),
decoding (Viterbi and max-posterior), scoring, and persistence.  Unlike
the reference's mutable sklearn-style object, all device math lives in
pure jitted functions (ops/, parallel/); this class is a thin host-side
coordinator.

Training parity notes:
* Each query interval (or chunk) is an independent sequence with fresh
  start probabilities — exactly the reference's semantics (its chunk
  boundaries are interval boundaries, SURVEY.md §5 "Long-context").
* Convergence: |Δ loglik| < threshold, with a tolerance for the tiny
  non-monotonic f32 jitter near convergence (measured ≤ 1e-4·|ll|).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

from tehmm_tpu.io.category import CategoryMap
from tehmm_tpu.io.trackdata import TrackData, TrackTable
from tehmm_tpu.io.trackxml import TrackList
from tehmm_tpu.models import emission as emission_ops
from tehmm_tpu.models.params import (
    HmmParams,
    init_flat,
    init_random,
    load_model,
    save_model,
)
from tehmm_tpu.ops import dp, em as em_ops
from tehmm_tpu.parallel.chunking import (
    batch_chunks,
    pad_batch_rows,
    plan_chunks,
)
from tehmm_tpu.parallel.stitch import viterbi_chunked
from tehmm_tpu.utils.common import EPSILON, JsonlMetrics, logger


# E-step pass budget: positions per device dispatch (bounds the E-step
# working set, ~400 bytes/position at S=20 — obs, alpha and beta are
# [B, L, S] on either engine).  Module-level so tests and
# memory-constrained deployments can tune it.
_MAX_PASS_POSITIONS = 4 << 20


def _env_int(name: str) -> int | None:
    """Integer env var accepting scientific/float forms ('40e9');
    unset/empty -> None; garbage -> a clear error naming the var (a
    tuning typo should not surface as a bare int() traceback mid-fit)."""
    v = os.environ.get(name, "").strip()
    if not v:
        return None
    try:
        return int(float(v))
    except ValueError:
        raise ValueError(
            f"{name}={v!r} is not a number (examples: 8589934592, 40e9)"
        ) from None


def _device_input_budget() -> int:
    """Byte budget for staging the training inputs device-resident.

    ``TEHMM_MAX_DEVICE_BYTES`` overrides; otherwise 40% of the
    accelerator's reported memory (the rest is the E-step working set,
    params, and XLA scratch), falling back to 6 GiB when the backend
    does not report (CPU).  Inputs larger than this train through the
    host-streamed pass loop instead of failing to allocate (a
    whole-genome × 15-track batch is 45-60 GB uint8, close to or beyond
    one card's memory)."""
    env = _env_int("TEHMM_MAX_DEVICE_BYTES")
    if env is not None:
        return env
    try:
        stats = jax.local_devices()[0].memory_stats()
        limit = int(stats["bytes_limit"])
        return int(limit * 0.4)
    except Exception:
        return 6 << 30


def _make_host_passes(symbols, lengths, obs_weights, gauss_values,
                      rows_per_pass):
    """Host-side (NumPy) fixed-shape pass blocks for inputs too large to
    stage on device: every block is ``rows_per_pass`` rows (the last one
    zero-padded so one compiled executable serves all blocks), kept as
    host views/copies and uploaded per pass by the streaming fit loop.

    Returns a list of (sym, len, w|None, gv|None) NumPy tuples.

    The reference never stages data at all — its fit loop walks tables
    one at a time through host RAM (SURVEY.md §3.1 ``for table in
    tables``); this is the accelerator equivalent: bounded device residency with
    upload/compute overlap from JAX's async dispatch."""
    n_rows = symbols.shape[0]
    rows_per_pass = min(rows_per_pass, n_rows)  # don't pad past the data
    P = max(1, -(-n_rows // rows_per_pass))
    blocks = []
    for pi in range(P):
        lo, hi = pi * rows_per_pass, min((pi + 1) * rows_per_pass, n_rows)
        pad = rows_per_pass - (hi - lo)

        def block(a, pad=pad, lo=lo, hi=hi):
            if a is None:
                return None
            if pad == 0:
                return a[lo:hi]
            return np.concatenate(
                [a[lo:hi],
                 np.zeros((pad,) + a.shape[1:], a.dtype)]
            )

        blocks.append((
            block(symbols), block(lengths),
            block(obs_weights), block(gauss_values),
        ))
    return blocks


def _make_passes(symbols, lengths, obs_weights, gauss_values,
                 rows_per_pass):
    """Split the staged observation batch into fixed-shape pass blocks
    of ``rows_per_pass`` rows (zero-padded; padded rows have length 0).
    Returns (sym[P,r,...], len[P,r], w[P,r,L]|None, gv[P,r,L,G]|None) or
    None when one pass suffices."""
    n_rows = symbols.shape[0]
    if n_rows <= rows_per_pass:
        return None
    P = -(-n_rows // rows_per_pass)
    pad = P * rows_per_pass - n_rows
    sym_p = jnp.pad(symbols, ((0, pad), (0, 0), (0, 0)))
    len_p = jnp.pad(lengths, (0, pad))
    return (
        sym_p.reshape(P, rows_per_pass, *symbols.shape[1:]),
        len_p.reshape(P, rows_per_pass),
        None if obs_weights is None else jnp.pad(
            obs_weights, ((0, pad), (0, 0))
        ).reshape(P, rows_per_pass, -1),
        None if gauss_values is None else jnp.pad(
            gauss_values, ((0, pad), (0, 0), (0, 0))
        ).reshape(P, rows_per_pass, *gauss_values.shape[1:]),
    )


@dataclasses.dataclass
class FitResult:
    logliks: list[float]
    iterations: int
    converged: bool
    wall_seconds: float


@dataclasses.dataclass
class _Prestaged:
    """Flat device-resident views handed to the stitched decoders
    (parallel/stitch._ResidentDecoder ``prestaged``)."""

    sym_flat: object            # [rows*Lr, T] device
    val_flat: object | None     # [rows*Lr, G] device
    w_flat: object | None       # [rows*Lr] device
    offsets: tuple              # flat start of each table


@dataclasses.dataclass
class _FitStagingCache:
    """Training batch kept device-resident after fit() so the
    train -> decode pipeline skips re-uploading the same genome
    (250M x 15 = 4 GB; the flat view below is one on-device reshape).
    Invalidated whenever fit() runs again; ``MultitrackHmm.
    release_staging()`` frees the device memory explicitly."""

    mats_ids: tuple             # id() of each table's symbol matrix
    Lr: int                     # chunk row length used at staging
    row_start: tuple            # first chunk-row of each table
    sym_src: object             # [rows, Lr, T] / [P, r, Lr, T] device
    gv_src: object | None
    w_src: object | None
    mats_refs: tuple            # pins the id()s above
    _flat: object = None

    def prestaged_for(self, tables, need_weights, need_values):
        ids = tuple(
            id(getattr(t, "symbols", t)) for t in tables
        )
        if ids != self.mats_ids:
            return None
        if need_values and self.gv_src is None:
            return None
        if need_weights and self.w_src is None:
            return None
        if self._flat is None:
            sym = self.sym_src
            self._flat = _Prestaged(
                sym_flat=sym.reshape(-1, sym.shape[-1]),
                val_flat=(
                    None if self.gv_src is None
                    else self.gv_src.reshape(
                        -1, self.gv_src.shape[-1]
                    )
                ),
                w_flat=(
                    None if self.w_src is None
                    else self.w_src.reshape(-1)
                ),
                offsets=tuple(
                    r * self.Lr for r in self.row_start
                ),
            )
        return self._flat


class MultitrackHmm:
    """Multi-track HMM with independent categorical emissions."""

    def __init__(
        self,
        params: HmmParams,
        track_list: TrackList,
        category_maps: dict[str, CategoryMap],
        state_names: list[str] | None = None,
    ):
        self.params = params
        self.track_list = track_list
        self.category_maps = category_maps
        self.extra: dict = {}  # free-form persisted metadata (e.g. cfg)
        # device-resident training batch retained by fit() for the
        # train -> decode pipeline (_FitStagingCache); never persisted
        self._staging: _FitStagingCache | None = None
        # gaussian-track normal emissions (models/gauss.GaussParams);
        # None when no track declares distribution="gaussian"
        self.gauss = None
        S = params.num_states
        self.state_names = state_names or [str(i) for i in range(S)]
        if len(self.state_names) != S:
            raise ValueError(
                f"{len(self.state_names)} state names for {S} states"
            )

    # ------------------------------------------------------------------
    @property
    def num_states(self) -> int:
        return self.params.num_states

    @property
    def alphabet_sizes(self) -> list[int]:
        return [len(self.category_maps[t.name]) for t in self.track_list]

    def state_index(self, name: str) -> int:
        return self.state_names.index(name)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def initialized(
        cls,
        num_states: int,
        track_data: TrackData,
        init: str = "flat",
        seed: int = 0,
        rand_range: tuple[float, float] = (0.1, 0.9),
        state_names: list[str] | None = None,
    ) -> "MultitrackHmm":
        """Fresh model over loaded track data (reference: teHmmTrain.py
        --flatEm / --emRandRange / --seed init modes)."""
        sizes = track_data.alphabet_sizes
        if init == "flat":
            params = init_flat(num_states, sizes)
        elif init == "random":
            params = init_random(num_states, sizes, seed, rand_range)
        else:
            raise ValueError(f"unknown init {init!r}")
        return cls(
            params, track_data.track_list, track_data.category_maps,
            state_names,
        )

    @classmethod
    def supervised(
        cls,
        track_data: TrackData,
        labeled_intervals: Sequence[Sequence],
        epsilon: float = EPSILON,
    ) -> "MultitrackHmm":
        """Supervised training: state = BED name column (reference:
        teHmmTrain.py --supervised -> hmm.supervisedTrain counting).

        ``labeled_intervals`` are (chrom, start, end, stateName) covering
        the loaded tables; state names are assigned indices in first-seen
        order.
        """
        state_names: list[str] = []
        name_to_idx: dict[str, int] = {}
        for iv in labeled_intervals:
            name = str(iv[3])
            if name not in name_to_idx:
                name_to_idx[name] = len(state_names)
                state_names.append(name)

        states_per_table = label_tables(
            track_data.tables, labeled_intervals, name_to_idx
        )
        S = len(state_names)
        sizes = track_data.alphabet_sizes
        V = max(sizes)
        T = track_data.num_tracks

        # Hard counting is host-side NumPy (like the reference): it is one
        # linear pass with no FLOPs worth shipping to the device, and run
        # lengths are ragged (each would trigger a fresh XLA compile).
        start_c = np.zeros(S, np.float64)
        trans_c = np.zeros((S, S), np.float64)
        em_c = np.zeros((S, T, V), np.float64)
        n_pos = 0
        from tehmm_tpu import native

        for tab, states in zip(track_data.tables, states_per_table):
            # maximal labeled runs: transitions never count across
            # unlabeled gaps (each run is its own sequence)
            for s, e in _labeled_runs(states):
                st = states[s:e]
                sym = tab.symbols[s:e]
                n_pos += e - s
                start_c[st[0]] += 1
                tc = native.count_transitions(st, S)
                ec = native.count_emissions(st, sym, S, V)
                if tc is not None:
                    trans_c += tc
                    em_c += ec
                else:  # NumPy fallback (no compiler available)
                    np.add.at(trans_c, (st[:-1], st[1:]), 1)
                    for t in range(T):
                        np.add.at(
                            em_c, (st, t, sym[:, t].astype(np.int64)), 1
                        )
        if n_pos == 0:
            raise ValueError("no labeled positions found")
        stats = em_ops.EmStats(
            start=jnp.asarray(start_c, jnp.float32),
            trans=jnp.asarray(trans_c, jnp.float32),
            em=jnp.asarray(em_c, jnp.float32),
            loglik=jnp.zeros(()),
            n_obs=jnp.asarray(float(n_pos)),
        )
        params = em_ops.em_m_step(
            stats,
            init_flat(S, sizes),
            jnp.asarray(sizes),
            epsilon=epsilon,
        )
        model = cls(
            params, track_data.track_list, track_data.category_maps,
            state_names,
        )
        if track_data.gauss_track_indices:
            from tehmm_tpu.models.gauss import supervised_gauss

            model.gauss = supervised_gauss(
                S,
                [t.values for t in track_data.tables],
                states_per_table,
            )
        return model

    # ------------------------------------------------------------------
    # unsupervised / semi-supervised EM
    # ------------------------------------------------------------------
    def fit(
        self,
        tables: Sequence[TrackTable],
        max_iterations: int = 100,
        convergence_tol: float = 1e-3,
        masks: em_ops.ParamMasks | None = None,
        epsilon: float = EPSILON,
        chunk_len: int = 1 << 14,
        mesh: jax.sharding.Mesh | None = None,
        metrics: JsonlMetrics | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 10,
        obs_weight_arrays: Sequence[np.ndarray] | None = None,
        device_loop: bool = False,
        max_device_bytes: int | None = None,
        retain_staging: bool = True,
    ) -> FitResult:
        """Baum-Welch EM (reference: basehmm.fit driven by teHmmTrain.py).

        Long tables are cut into independent chunks of ``chunk_len``
        (reference chunking semantics).  With a mesh, chunks shard over
        the data axis and statistics are psum-merged.

        ``obs_weight_arrays``: optional per-table f32[L] emission weights
        (segment mode --segLen: weight = segment length).
        ``device_loop``: run the whole EM loop as one on-device
        ``lax.while_loop`` (fastest; no per-iteration logging or
        checkpointing; single-device only).
        ``max_device_bytes``: staging budget for the training inputs
        (default: ``TEHMM_MAX_DEVICE_BYTES`` env or 40% of device
        memory).  Larger datasets train identically through the
        host-streamed pass loop — nothing requires the data to fit HBM
        (the reference streams per-table through host RAM, SURVEY.md
        §3.1; this is the accelerator equivalent).
        ``retain_staging``: keep the staged device batch alive on the
        model after fit returns so a following decode_tables /
        posterior_decode_tables on the SAME tables skips re-uploading
        the dataset (the train -> decode pipeline).  The
        batch occupies device memory until ``release_staging()``, the
        next fit(), or the model is dropped — pass False (or release)
        when fitting several models on different near-budget datasets
        concurrently.
        """
        from tehmm_tpu.parallel.em_sharded import sharded_em_stats

        from tehmm_tpu.parallel.mesh import stage_batch

        self._staging = None          # fit invalidates any prior cache
        mats = [t.symbols for t in tables]
        chunks = plan_chunks([len(m) for m in mats], chunk_len, halo=0)
        batch = batch_chunks(mats, chunks)
        if mesh is not None:
            batch = pad_batch_rows(batch, int(np.prod(list(mesh.shape.values()))))
        sizes = jnp.asarray(self.alphabet_sizes)
        gv_np = None
        if self.gauss is not None:
            vb = batch_chunks(
                [np.asarray(t.values, np.float32) for t in tables],
                chunks,
            )
            gv_np = vb.symbols
            if gv_np.shape[0] != batch.symbols.shape[0]:  # mesh row pad
                gv_np = np.concatenate([
                    gv_np, np.zeros(
                        (batch.symbols.shape[0] - gv_np.shape[0],)
                        + gv_np.shape[1:], np.float32,
                    ),
                ])
        w_np = None
        if obs_weight_arrays is not None:
            wb = batch_chunks(
                [np.asarray(w, np.float32)[:, None]
                 for w in obs_weight_arrays],
                chunks,
            )
            w_np = wb.symbols[..., 0]
            if w_np.shape[0] != batch.symbols.shape[0]:  # mesh row pad
                w_np = np.concatenate(
                    [w_np, np.zeros(
                        (batch.symbols.shape[0] - w_np.shape[0],
                         w_np.shape[1]),
                        np.float32,
                    )]
                )

        n_positions = int(batch.lengths.sum())
        logliks: list[float] = []
        converged = False
        t0 = time.time()

        Lr = batch.symbols.shape[1]
        pass_positions = (
            _env_int("TEHMM_PASS_POSITIONS") or _MAX_PASS_POSITIONS
        )
        rows_per_pass = max(1, pass_positions // max(Lr, 1))

        # Inputs that don't fit device memory never stage: the fit loop
        # streams fixed-shape host blocks instead, double-buffering the
        # H2D upload against the running E-step (async dispatch).
        staged_bytes = (
            batch.symbols.nbytes
            + (0 if gv_np is None else gv_np.nbytes)
            + (0 if w_np is None else w_np.nbytes)
        )
        budget = (
            max_device_bytes if max_device_bytes is not None
            else _device_input_budget()
        )
        host_passes = None
        if (mesh is None and not device_loop
                and staged_bytes > budget):
            # two blocks live at once (double buffering) — bound each
            # to half the budget
            bytes_per_row = max(1, staged_bytes // max(
                batch.symbols.shape[0], 1))
            rows_per_pass = max(1, min(
                rows_per_pass, int(budget // (2 * bytes_per_row))
            ))
            host_passes = _make_host_passes(
                batch.symbols, batch.lengths, w_np, gv_np,
                rows_per_pass,
            )
            logger.info(
                "training inputs (%.2f GB) exceed the device staging "
                "budget — streaming %d host pass-blocks per iteration",
                staged_bytes / 1e9, len(host_passes),
            )
            symbols = lengths = obs_weights = gauss_values = None
        else:
            symbols = stage_batch(batch.symbols, mesh)
            lengths = stage_batch(batch.lengths, mesh)
            gauss_values = (
                None if gv_np is None else stage_batch(gv_np, mesh)
            )
            obs_weights = (
                None if w_np is None else stage_batch(w_np, mesh)
            )
            # Drain the uploads BEFORE the first E-step dispatch, so
            # the INFO line attributes train-stage wall to the upload
            # and not to the first compile.
            stage_t0 = time.time()
            jax.block_until_ready([
                a for a in (symbols, lengths, obs_weights,
                            gauss_values)
                if a is not None
            ])
            stage_dt = time.time() - stage_t0
            logger.info(
                "staged %.2f GB of training inputs in %.1fs "
                "(%.2f GB/s H2D)",
                staged_bytes / 1e9, stage_dt,
                staged_bytes / 1e9 / max(stage_dt, 1e-9),
            )

        # Oversized device-resident batches are cut into pass-blocks so
        # the E-step's working set (obs/one-hot/alpha/beta, ~400B per
        # position at S=20) stays bounded; a host loop over pass
        # dispatches keeps XLA buffer donation intact (a lax.scan over
        # passes — see em_epoch_scan — loses donation and pays copies
        # per pass).
        passes = None
        if mesh is None and not device_loop and host_passes is None:
            passes = _make_passes(
                symbols, lengths, obs_weights, gauss_values,
                rows_per_pass,
            )
            # Retain the staged (or pass-split padded) batch for the
            # train -> decode pipeline: decode_tables gathers windows
            # straight from this instead of re-uploading the genome.
            # Padded tail rows are position-masked by the decoder.
            first_row: dict[int, int] = {}
            for ci, c in enumerate(chunks):
                first_row.setdefault(c.table_idx, ci)
            if retain_staging:
                self._staging = _FitStagingCache(
                    mats_ids=tuple(id(m) for m in mats),
                    Lr=Lr,
                    row_start=tuple(
                        first_row.get(t, 0) for t in range(len(mats))
                    ),
                    sym_src=(
                        passes[0] if passes is not None else symbols
                    ),
                    gv_src=(
                        passes[3] if passes is not None
                        else gauss_values
                    ),
                    w_src=(
                        passes[2] if passes is not None
                        else obs_weights
                    ),
                    mats_refs=tuple(mats),
                )
        if passes is not None:
            # the un-split staged arrays are unreachable below once the
            # passes exist — drop them so the padded copies don't double
            # device memory in exactly the memory-bounded path
            symbols = lengths = obs_weights = gauss_values = None

        if device_loop:
            if mesh is not None:
                raise ValueError(
                    "device_loop does not support a mesh yet; use the "
                    "host-driven loop for sharded EM"
                )
            out = em_ops.em_run(
                self.params, symbols, sizes, lengths,
                max_iterations=max_iterations,
                convergence_tol=convergence_tol,
                masks=masks, epsilon=epsilon, obs_weights=obs_weights,
                gauss_params=self.gauss, gauss_values=gauss_values,
            )
            new_params, hist, n_it = out[:3]
            if self.gauss is not None:
                self.gauss = out[3]
            self.params = new_params
            n = int(n_it)
            logliks = [float(x) for x in np.asarray(hist)[:n]]
            wall = time.time() - t0
            logger.info(
                "EM device loop: %d iters in %.2fs (%.3g pos/s), final "
                "loglik %.4f", n, wall,
                n * n_positions / max(wall, 1e-9),
                logliks[-1] if logliks else float("nan"),
            )
            if metrics is not None:
                for i, ll in enumerate(logliks):
                    metrics.write(iter=i, loglik=ll)
            if checkpoint_path:
                self.save(checkpoint_path, extra={"iteration": n - 1})
            return FitResult(
                logliks=logliks,
                iterations=n,
                converged=n < max_iterations,
                wall_seconds=wall,
            )

        # Pipelined host sync: fetching a scalar from the device blocks
        # until the queue drains, so iteration i's loglik is read only
        # AFTER iteration i+1 has
        # been dispatched — the transfer overlaps the next E-step and the
        # convergence check trails by one iteration.
        pending = None  # (iter_idx, device_ll, dispatch_time)

        def _drain(_now=None):
            nonlocal converged
            if pending is None:
                return False
            # time from the PENDING iteration's own dispatch — not the
            # caller's current iteration start, which would misattribute
            # interleaved host work (e.g. checkpoint writes) and report
            # a near-zero wall for the final post-loop drain
            it, dev_ll, dispatch_t0 = pending
            ll = float(dev_ll)
            logliks.append(ll)
            wall = time.time() - dispatch_t0
            logger.info(
                "EM iter %d: loglik %.4f (%.2fs, %.3g pos/s)",
                it, ll, wall, n_positions / max(wall, 1e-9),
            )
            if metrics is not None:
                metrics.write(
                    iter=it, loglik=ll, wall=wall,
                    positions_per_sec=n_positions / max(wall, 1e-9),
                )
            if len(logliks) >= 2:
                delta = logliks[-1] - logliks[-2]
                if abs(delta) < convergence_tol:
                    converged = True
            return converged

        def _put_block(blk):
            """Upload one host pass-block; async, so the transfer of
            block i+1 overlaps the E-step of block i."""
            return tuple(
                None if a is None else jax.device_put(a) for a in blk
            )

        for it in range(max_iterations):
            it_t0 = time.time()
            if host_passes is not None:
                stats = None
                dev = _put_block(host_passes[0])
                for pi in range(len(host_passes)):
                    nxt = (
                        _put_block(host_passes[pi + 1])
                        if pi + 1 < len(host_passes) else None
                    )
                    s = em_ops.em_sufficient_stats(
                        self.params, dev[0], dev[1],
                        obs_weights=dev[2],
                        gauss_params=self.gauss, gauss_values=dev[3],
                    )
                    stats = s if stats is None else stats + s
                    dev = nxt
            elif mesh is None and passes is not None:
                stats = None
                for pi in range(passes[0].shape[0]):
                    s = em_ops.em_sufficient_stats(
                        self.params, passes[0][pi], passes[1][pi],
                        obs_weights=(
                            None if passes[2] is None else passes[2][pi]
                        ),
                        gauss_params=self.gauss,
                        gauss_values=(
                            None if passes[3] is None else passes[3][pi]
                        ),
                    )
                    stats = s if stats is None else stats + s
            elif mesh is None:
                stats = em_ops.em_sufficient_stats(
                    self.params, symbols, lengths,
                    obs_weights=obs_weights,
                    gauss_params=self.gauss, gauss_values=gauss_values,
                )
            else:
                stats = sharded_em_stats(
                    self.params, symbols, lengths, mesh,
                    obs_weights=obs_weights,
                    gauss_params=self.gauss, gauss_values=gauss_values,
                )
            new_params = em_ops.em_m_step(
                stats, self.params, sizes, masks, epsilon
            )
            if self.gauss is not None:
                from tehmm_tpu.models.gauss import gauss_m_step

                self.gauss = gauss_m_step(
                    stats.gauss_n, stats.gauss_x, stats.gauss_x2,
                    self.gauss,
                    fix_states=getattr(masks, "fix_em_states", None)
                    if masks is not None else None,
                )
            ll = stats.loglik
            self.params = new_params
            if _drain():  # previous iteration's result
                break
            pending = (it, ll, it_t0)
            if checkpoint_path and (it + 1) % checkpoint_every == 0:
                self.save(checkpoint_path, extra={"iteration": it})
        if not converged:
            _drain()
        return FitResult(
            logliks=logliks,
            iterations=len(logliks),
            converged=converged,
            wall_seconds=time.time() - t0,
        )

    # ------------------------------------------------------------------
    # decoding
    # ------------------------------------------------------------------
    def decode_tables(
        self,
        tables: Sequence[TrackTable],
        chunk_len: int = 4096,
        halo: int = 256,
        rows_per_pass: int = 512,
    ) -> tuple[list[np.ndarray], object]:
        """Viterbi state paths for each table (boundary-exact chunked).

        When these are the tables fit() just trained on, the decode
        gathers windows from the still-device-resident training batch
        (no re-upload; see _FitStagingCache)."""
        paths, report = viterbi_chunked(
            self.params, tables, chunk_len=chunk_len, halo=halo,
            rows_per_pass=rows_per_pass, gauss_params=self.gauss,
            prestaged=self._prestaged_for(tables),
        )
        return paths, report

    def _prestaged_for(self, tables):
        if self._staging is None:
            return None
        return self._staging.prestaged_for(
            tables, need_weights=False,
            need_values=self.gauss is not None,
        )

    def release_staging(self) -> None:
        """Free the device-resident training batch fit() retained for
        the train -> decode pipeline (no-op if absent)."""
        self._staging = None

    def decode_to_bed(
        self,
        tables: Sequence[TrackTable],
        chunk_len: int = 4096,
        halo: int = 256,
    ) -> list[tuple]:
        """Viterbi -> merged (chrom, start, end, stateName) intervals
        (reference: teHmmEval.py --bed output; SURVEY.md §3.2)."""
        paths, _ = self.decode_tables(tables, chunk_len, halo)
        out: list[tuple] = []
        for tab, path in zip(tables, paths):
            out.extend(path_to_intervals(
                tab.chrom, tab.start, path, self.state_names
            ))
        return out

    def posterior_decode_tables(
        self,
        tables: Sequence[TrackTable],
        chunk_len: int = 1 << 14,
        halo: int = 256,
        rows_per_pass: int = 64,
        weight_arrays: Sequence[np.ndarray] | None = None,
    ) -> list[np.ndarray]:
        """Max-posterior (per-position argmax gamma) decoding
        (reference: teHmmEval.py --maxPost).

        Genome-scale safe AND verified: halo chunks with the same
        boundary agreement check + adaptive widening as the Viterbi
        stitcher, falling back to the exact carried-alpha/beta decoder
        (bit-identical to monolithic) when agreement cannot be reached
        (parallel/stitch.posterior_chunked).  ``weight_arrays``: segment
        mode per-position emission weights (--segment --segLen)."""
        from tehmm_tpu.parallel.stitch import posterior_chunked

        paths, _report = posterior_chunked(
            self.params, tables, chunk_len=chunk_len, halo=halo,
            rows_per_pass=rows_per_pass, gauss_params=self.gauss,
            weight_arrays=weight_arrays,
            prestaged=self._prestaged_for(tables),
        )
        return paths

    def posterior_distributions(
        self,
        tables: Sequence[TrackTable],
        chunk_len: int = 1 << 14,
        weight_arrays: Sequence[np.ndarray] | None = None,
    ) -> list[np.ndarray]:
        """Full per-position posterior state distributions
        (reference: teHmmEval.py --pd output [R?]).

        Streams in bounded device memory: the exact carried-alpha/beta
        chunk sweep recomputes gamma one chunk at a time (bit-identical
        to a monolithic pass), so arbitrarily long tables only ever hold
        one [chunk, S] block on device; the host output array is the
        deliverable."""
        from tehmm_tpu.parallel.stitch import posterior_sweep

        S = self.params.num_states
        out = [
            np.zeros((len(tab), S), np.float32) for tab in tables
        ]

        def consume(b, start, gamma):
            out[b][start : start + len(gamma)] = gamma

        posterior_sweep(
            self.params, tables, chunk_len=chunk_len, consume=consume,
            gauss_params=self.gauss, weight_arrays=weight_arrays,
        )
        return out

    def score(
        self, tables: Sequence[TrackTable], chunk_len: int = 1 << 14,
        mesh: jax.sharding.Mesh | None = None,
    ) -> float:
        """Total log-likelihood of the data (reference: basehmm.score).

        Exact for arbitrarily long tables: the forward alpha is carried
        across fixed-size chunks (ops.dp.streaming_loglik), so device
        memory is O(tables × states) and every chunk reuses one compiled
        shape regardless of table lengths.

        ``mesh``: score each table with the EXACT sequence-parallel
        forward instead — the sequence shards over the data axis, every
        device reduces its span to one S×S operator locally, and the
        composition is a single tiny all_gather
        (parallel/seqpar.forward_loglik_seqpar).  Latency scales as
        L/D for the few-long-chromosomes regime where the carried-alpha
        stream is a serial chain; identical loglik within f32
        tolerance."""
        if mesh is not None:
            from tehmm_tpu.parallel.seqpar import score_table_seqpar

            return float(sum(
                score_table_seqpar(
                    self.params, t, mesh, gauss_params=self.gauss
                )
                for t in tables
            ))
        mats = [t.symbols for t in tables]
        true_lens = np.asarray([len(m) for m in mats])
        L = int(true_lens.max())
        if L == 0:
            # every table empty: the loglik of an empty product is 0
            # (streaming_loglik would otherwise next() an exhausted
            # chunk iterator and raise StopIteration)
            return 0.0
        T = mats[0].shape[1]
        n_chunks = -(-L // chunk_len)

        vmats = None
        if self.gauss is not None:
            vmats = [np.asarray(t.values, np.float32) for t in tables]

        def obs_chunks():
            for c in range(n_chunks):
                lo = c * chunk_len
                block = np.zeros(
                    (len(mats), chunk_len, T), dtype=mats[0].dtype
                )
                for b, m in enumerate(mats):
                    piece = m[lo : lo + chunk_len]
                    block[b, : len(piece)] = piece
                obs = emission_ops.track_log_likelihoods(
                    self.params.log_em, jnp.asarray(block)
                )
                if vmats is not None:
                    from tehmm_tpu.models.gauss import (
                        gauss_log_likelihoods,
                    )

                    G = vmats[0].shape[1]
                    vb = np.zeros(
                        (len(mats), chunk_len, G), np.float32
                    )
                    for b, v in enumerate(vmats):
                        piece = v[lo : lo + chunk_len]
                        vb[b, : len(piece)] = piece
                    obs = obs + gauss_log_likelihoods(
                        self.gauss, jnp.asarray(vb)
                    )
                yield obs

        lens = [
            np.clip(true_lens - c * chunk_len, 0, chunk_len)
            for c in range(n_chunks)
        ]
        ll = dp.streaming_loglik(
            self.params.log_start, self.params.log_trans,
            obs_chunks(), lens,
        )
        return float(jnp.sum(ll))

    # ------------------------------------------------------------------
    # persistence (reference: modelIO.py saveModel/loadModel)
    # ------------------------------------------------------------------
    def save(self, path: str, extra: dict | None = None) -> None:
        meta = {
            "state_names": self.state_names,
            "tracks": self.track_list.to_dicts(),
            "category_maps": {
                name: cm.to_dict()
                for name, cm in self.category_maps.items()
            },
        }
        if extra:
            self.extra.update(extra)
        if self.extra:
            meta["extra"] = self.extra
        arrays = None
        if self.gauss is not None:
            arrays = {
                "gauss_mu": self.gauss.mu,
                "gauss_log_var": self.gauss.log_var,
            }
        save_model(path, self.params, meta, extra_arrays=arrays)

    @classmethod
    def load(cls, path: str) -> "MultitrackHmm":
        params, meta, arrays = load_model(path)
        track_list = TrackList.from_dicts(meta["tracks"])
        maps = {
            name: CategoryMap.from_dict(d)
            for name, d in meta["category_maps"].items()
        }
        model = cls(params, track_list, maps, meta["state_names"])
        model.extra = meta.get("extra", {})
        if "gauss_mu" in arrays:
            from tehmm_tpu.models.gauss import GaussParams

            model.gauss = GaussParams(
                mu=jnp.asarray(arrays["gauss_mu"]),
                log_var=jnp.asarray(arrays["gauss_log_var"]),
            )
        return model


def fit_restarts(
    models: "Sequence[MultitrackHmm]",
    tables: Sequence[TrackTable],
    max_iterations: int = 100,
    convergence_tol: float = 1e-3,
    masks: em_ops.ParamMasks | None = None,
    epsilon: float = EPSILON,
    chunk_len: int = 1 << 14,
    metrics: JsonlMetrics | None = None,
    obs_weight_arrays: Sequence[np.ndarray] | None = None,
) -> tuple[int, list[FitResult]]:
    """EM over R random restarts as ONE vmapped device program
    (reference: teHmmTrain.py --reps forks OS processes; --numThreads
    [R?]).  All restarts share the staged observation batch; each
    iteration is a single dispatch computing R E+M steps, so R restarts
    cost barely more wall-clock than one until the chip saturates.

    The winning restart's parameters are written back into its model.
    Returns (best_index, per-restart FitResults)."""
    R = len(models)
    mats = [t.symbols for t in tables]
    chunks = plan_chunks([len(m) for m in mats], chunk_len, halo=0)
    batch = batch_chunks(mats, chunks)
    symbols = jnp.asarray(batch.symbols)
    lengths = jnp.asarray(batch.lengths)
    sizes = jnp.asarray(models[0].alphabet_sizes)
    gauss_stack = None
    gauss_values = None
    if models[0].gauss is not None:
        # gaussian tracks (models/gauss.py): per-restart normal params
        # stack like HmmParams; the value matrix is shared observations
        gauss_stack = jax.tree.map(
            lambda *xs: jnp.stack(xs), *[m.gauss for m in models]
        )
        vb = batch_chunks(
            [np.asarray(t.values, np.float32) for t in tables], chunks
        )
        gauss_values = jnp.asarray(vb.symbols)
    obs_weights = None
    if obs_weight_arrays is not None:
        wb = batch_chunks(
            [np.asarray(w, np.float32)[:, None]
             for w in obs_weight_arrays],
            chunks,
        )
        obs_weights = jnp.asarray(wb.symbols[..., 0])

    params_stack = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[m.params for m in models]
    )

    # pass-blocks: the vmapped E-step working set is R x one restart's
    Lr = symbols.shape[1]
    rows_per_pass = max(1, _MAX_PASS_POSITIONS // max(Lr, 1) // R)
    passes = _make_passes(
        symbols, lengths, obs_weights, gauss_values, rows_per_pass
    )

    t0 = time.time()
    hist: list[np.ndarray] = []          # per-iter f32[R]
    n_positions = int(batch.lengths.sum())
    pending = None

    def _drain():
        if pending is None:
            return False
        it, dev_ll, it_t0 = pending
        ll = np.asarray(dev_ll)
        hist.append(ll)
        wall = time.time() - it_t0
        logger.info(
            "EM[reps=%d] iter %d: best loglik %.4f (%.2fs, %.3g pos/s "
            "aggregate)", R, it, float(ll.max()), wall,
            R * n_positions / max(wall, 1e-9),
        )
        if metrics is not None:
            metrics.write(
                iter=it, logliks=[float(x) for x in ll], wall=wall
            )
        if len(hist) >= 2:
            return bool(
                np.all(np.abs(hist[-1] - hist[-2]) < convergence_tol)
            )
        return False

    converged = False
    for it in range(max_iterations):
        it_t0 = time.time()
        if passes is not None:
            stats = None
            for pi in range(passes[0].shape[0]):
                s = em_ops.em_stats_reps(
                    params_stack, passes[0][pi], passes[1][pi],
                    None if passes[2] is None else passes[2][pi],
                    gauss_params_stack=gauss_stack,
                    gauss_values=(
                        None if passes[3] is None else passes[3][pi]
                    ),
                )
                stats = s if stats is None else stats + s
        else:
            stats = em_ops.em_stats_reps(
                params_stack, symbols, lengths, obs_weights,
                gauss_params_stack=gauss_stack,
                gauss_values=gauss_values,
            )
        params_stack = em_ops.em_m_step_reps(
            stats, params_stack, sizes, masks, epsilon
        )
        if gauss_stack is not None:
            from tehmm_tpu.models.gauss import gauss_m_step

            fix = (getattr(masks, "fix_em_states", None)
                   if masks is not None else None)
            gauss_stack = jax.vmap(
                lambda n, x, x2, g: gauss_m_step(
                    n, x, x2, g, fix_states=fix
                )
            )(
                stats.gauss_n, stats.gauss_x, stats.gauss_x2,
                gauss_stack,
            )
        if _drain():
            converged = True
            break
        pending = (it, stats.loglik, it_t0)
    if not converged and _drain():
        converged = True

    wall = time.time() - t0
    lls = np.stack(hist) if hist else np.zeros((0, R), np.float32)
    best = int(np.argmax(lls[-1])) if len(lls) else 0
    for r, m in enumerate(models):
        m.params = jax.tree.map(lambda x, r=r: x[r], params_stack)
        if gauss_stack is not None:
            m.gauss = jax.tree.map(lambda x, r=r: x[r], gauss_stack)
    results = [
        FitResult(
            logliks=[float(x) for x in lls[:, r]],
            iterations=len(lls),
            converged=converged,
            wall_seconds=wall,
        )
        for r in range(R)
    ]
    return best, results


def path_log_score(
    params: HmmParams, symbols: np.ndarray, path: np.ndarray,
    gauss=None, values: np.ndarray | None = None,
    obs_weights: np.ndarray | None = None,
) -> float:
    """Joint log-probability log P(obs, path) of a decoded state path —
    the quantity the reference's ``decode()`` returns (sklearn-style
    Viterbi logprob [R]).  Pure host gathers, O(L·T): no device pass.

    ``gauss``/``values``: gaussian-track emissions (models/gauss.py) —
    adds each position's normal log-density under its path state.
    ``obs_weights`` (f32[L], segment mode --segLen): scales every
    position's EMISSION log-probability (categorical + gaussian) by its
    weight, exactly like the decode kernels' ``obs * w``; transitions
    are unweighted."""
    log_em = np.asarray(params.log_em, np.float64)
    log_trans = np.asarray(params.log_trans, np.float64)
    log_start = np.asarray(params.log_start, np.float64)
    path = np.asarray(path, np.int64)
    if len(path) == 0:
        return 0.0
    s = float(log_start[path[0]])
    if len(path) > 1:
        s += float(log_trans[path[:-1], path[1:]].sum())
    em_pos = np.zeros(len(path), np.float64)
    for t in range(symbols.shape[1]):
        em_pos += log_em[path, t, symbols[:, t].astype(np.int64)]
    if gauss is not None and values is not None:
        from tehmm_tpu.models.gauss import LOG_2PI

        mu = np.asarray(gauss.mu, np.float64)[path]        # [L, G]
        lv = np.asarray(gauss.log_var, np.float64)[path]
        x = np.asarray(values, np.float64)
        fin = np.isfinite(x)
        ll = -0.5 * (
            (x - mu) ** 2 / np.exp(lv) + lv + LOG_2PI
        )
        em_pos += np.where(fin, ll, 0.0).sum(axis=1)
    if obs_weights is not None:
        em_pos = em_pos * np.asarray(obs_weights, np.float64)
    return s + float(em_pos.sum())


def path_to_intervals(
    chrom: str, origin: int, path: np.ndarray,
    state_names: list[str],
) -> list[tuple]:
    """State path -> merged (chrom, start, end, name) runs.  Uses the
    native run-length encoder when available; genome-scale safe either
    way (no per-position Python objects)."""
    from tehmm_tpu import native

    path = np.ascontiguousarray(path, np.int32)
    if len(path) == 0:
        # zero-length query record: the NumPy fallback's bounds math
        # below would index into an empty array (the native encoder
        # already returns no runs)
        return []
    runs = native.runs_encode(path)
    if runs is None:
        edges = np.flatnonzero(np.diff(path)) + 1
        bounds = np.concatenate([[0], edges, [len(path)]])
        runs = (
            bounds[:-1], bounds[1:],
            path[bounds[:-1]],
        )
    starts, ends, states = runs
    return [
        (chrom, origin + int(s), origin + int(e), state_names[int(v)])
        for s, e, v in zip(starts, ends, states)
    ]


# ----------------------------------------------------------------------
# labeling helpers (supervised mode)
# ----------------------------------------------------------------------

def label_tables(
    tables: Sequence[TrackTable],
    labeled_intervals: Sequence[Sequence],
    name_to_idx: dict[str, int],
) -> list[np.ndarray]:
    """Paint per-position state indices from labeled BED intervals;
    unlabeled positions get -1."""
    out = []
    for tab in tables:
        states = np.full(len(tab), -1, dtype=np.int32)
        for iv in labeled_intervals:
            chrom, start, end, name = iv[0], iv[1], iv[2], str(iv[3])
            if chrom != tab.chrom:
                continue
            s = max(start, tab.start) - tab.start
            e = min(end, tab.end) - tab.start
            if s < e:
                states[s:e] = name_to_idx[name]
        out.append(states)
    return out


def _labeled_runs(states: np.ndarray) -> list[tuple[int, int]]:
    """Maximal [s, e) runs of labeled (>= 0) positions."""
    labeled = states >= 0
    if not labeled.any():
        return []
    edges = np.flatnonzero(np.diff(labeled.astype(np.int8)))
    bounds = np.concatenate([[0], edges + 1, [len(states)]])
    return [
        (int(s), int(e))
        for s, e in zip(bounds[:-1], bounds[1:])
        if labeled[s]
    ]
