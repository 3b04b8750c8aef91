"""Chunked Viterbi / max-posterior decoding with halo stitching.

SURVEY.md §5 "Long-context" and §7 layer 5 / hard part #2: a chromosome is
decoded as parallel fixed-size chunks, each extended by a halo on both
sides.  Each chunk's path is computed independently (massively parallel
on the device); only the core span of each chunk is kept.  Two
neighboring chunks overlap around every boundary, and their independent
decodes are compared on a window centered on the boundary: agreement
means both decodes have "forgotten" their load edges there — a strong
heuristic that the stitched output equals the monolithic decode (tests
assert that equality on every fixture; see _stitched_decode for why it
is a heuristic, not a proof).  Any disagreeing boundary doubles ONLY its
adjacent chunks' halos and re-decodes them (targeted widening), up to
``max_halo``; persistent disagreement falls back to the checkpointed
EXACT decoders (viterbi_exact / posterior_exact), which are bit-equal to
monolithic unconditionally and also available directly (eval --exact).

The reference has no stitching — its chunk boundaries are hard interval
boundaries with fresh start probabilities (SURVEY.md §5), which is also
available here by decoding tables separately with halo=0.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

from tehmm_tpu.models.emission import track_log_likelihoods
from tehmm_tpu.models.params import HmmParams
from tehmm_tpu.ops import dp, gpu_kernels
from tehmm_tpu.parallel.chunking import plan_chunks, batch_chunks
from tehmm_tpu.utils.common import logger


@dataclasses.dataclass
class StitchReport:
    """Diagnostics from a chunked decode."""

    n_chunks: int
    final_halo: int
    retries: int
    boundaries_checked: int
    boundaries_ok: bool



def _weight_batch(weight_arrays, chunks):
    """Per-table f32[L] weights -> the chunk batch's [n, Lc] rows
    (same planning as the symbols, via a single-column round-trip)."""
    wb = batch_chunks(
        [np.asarray(w, np.float32)[:, None] for w in weight_arrays],
        chunks,
    )
    return wb.symbols[..., 0]


def _weight_block(wmats, lo, Lc, B):
    """Ones-padded [B, Lc] weight slice starting at position ``lo``
    (padding value is inert: padded positions are length-masked)."""
    wb = np.ones((B, Lc), np.float32)
    for b, wv in enumerate(wmats):
        piece = wv[lo : lo + Lc]
        wb[b, : len(piece)] = piece
    return wb


# Decode downloads: paths downcast to uint8 on device when the state
# count allows — paths are by far the largest decode download.
#
# row groups kept in flight by the batch decoders: the blocking result
# fetch of group i otherwise serializes against group i+1's upload and
# dispatch.  Device-side cost per in-flight group is one uint8 path
# block (~2 MB) plus its queued inputs.
_DECODE_INFLIGHT = 3


def _pad_rows(pad: int, *arrays):
    """Zero-pad the leading axis of each (optional) array by ``pad``
    rows — the one definition of 'pad the last row group to the
    compiled shape' shared by both batch decoders."""
    out = []
    for a in arrays:
        if a is None or pad == 0:
            out.append(a)
        else:
            out.append(np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)]
            ))
    return out


def _pipelined_groups(n, rows_per_pass, dispatch, consume):
    """Drive ``dispatch(lo, hi)`` over row groups with a bounded number
    of un-fetched device results in flight; ``consume(lo, hi, result)``
    runs in order once each group's result is fetched."""
    from collections import deque

    inflight: deque = deque()
    padded_rows = -(-n // rows_per_pass) * rows_per_pass
    for lo in range(0, padded_rows, rows_per_pass):
        hi = min(lo + rows_per_pass, n)
        inflight.append((lo, hi, dispatch(lo, hi)))
        if len(inflight) >= _DECODE_INFLIGHT:
            l, h, r = inflight.popleft()
            consume(l, h, r)
    while inflight:
        l, h, r = inflight.popleft()
        consume(l, h, r)


# ---------------------------------------------------------------------------
# Run-length path transport.  A decoded state path over a genome is
# ~100x more bytes than its information content (the 250M demo: 250 MB
# of per-base uint8 vs 1.97M intervals), so the decode dispatches pack
# each row's (position, state) change points into fixed uint32 slots ON
# DEVICE and download only those; the per-base block is fetched as a
# fallback only for rows whose run count overflows the slot budget.
# Reference analog: teHmmEval's merge-runs → BED step (SURVEY.md §3.2)
# — the merge now effectively happens on device.

_RLE_OVERFLOW = np.uint32(0xFFFFFFFF)


def _rle_shift(num_states: int) -> int:
    """Bits reserved for the state in a packed (pos << shift | state)."""
    return 8 if num_states <= 255 else 16


def _rle_slots(Lc: int) -> int:
    """Change-point slots per row: Lc/16 caps the packed download at
    ~1/4 of the per-base bytes while making overflow (mean run < 16)
    rare; overflowing rows fall back to the per-base block."""
    return min(Lc, max(64, Lc // 16))


def _rle_supported(num_states: int, Lc: int) -> bool:
    """Position and state must fit one uint32 with room for the unused
    (Lc << shift) and overflow (0xFFFFFFFF) sentinels."""
    if num_states <= 255:
        return Lc < (1 << 24) - 1
    return num_states <= 65535 and Lc < (1 << 16) - 1


@functools.partial(jax.jit, static_argnames=("num_slots", "shift"))
def _rle_pack(paths, lengths, num_slots, shift):
    """Pack each row's run starts into ``num_slots`` uint32 slots:
    ``(pos << shift) | state`` sorted ascending, unused slots holding
    the ``L << shift`` sentinel; rows with more runs than slots become
    all-``_RLE_OVERFLOW``.  Sort-based (no scatter): encoded change
    points order before the sentinel, so one ascending sort per row
    compacts them into the leading slots."""
    n, L = paths.shape
    pos = jnp.arange(L, dtype=jnp.int32)
    valid = pos[None, :] < lengths[:, None]
    prev = jnp.concatenate([paths[:, :1], paths[:, :-1]], axis=1)
    change = ((paths != prev) | (pos == 0)[None, :]) & valid
    counts = change.sum(axis=1).astype(jnp.int32)
    enc = jnp.where(
        change,
        (pos[None, :].astype(jnp.uint32) << shift)
        | paths.astype(jnp.uint32),
        jnp.uint32(L) << shift,
    )
    packed = jnp.sort(enc, axis=1)[:, :num_slots]
    return jnp.where((counts > num_slots)[:, None], _RLE_OVERFLOW, packed)


def _pack_for_transport(paths, lens_dev, num_states, Lc,
                        num_slots=None):
    """Device-side transport prep shared by ALL decode dispatches
    (host-batched and resident): returns (packed | None, per-base
    paths for the overflow fallback, downcast to uint8 when states
    fit).  ``num_slots``: pre-resolved slot budget (resident dispatch
    passes its static value; None resolves from Lc)."""
    paths = paths.astype(jnp.int32)
    fallback = paths if num_states > 255 else paths.astype(jnp.uint8)
    if num_slots is None:
        num_slots = (
            _rle_slots(Lc) if _rle_supported(num_states, Lc) else 0
        )
    if num_slots == 0:
        return None, fallback
    packed = _rle_pack(
        paths, lens_dev, num_slots, _rle_shift(num_states)
    )
    return packed, fallback


def _rle_expand(packed, lengths, shift, full_fetch):
    """Expand packed rows back to int32 per-base path rows (host side,
    vectorized across the block).  ``full_fetch()`` materializes the
    per-base block at most once, for overflowed rows only."""
    n, _K = packed.shape
    lengths = np.asarray(lengths, np.int64)
    starts = (packed >> shift).astype(np.int64)
    states = (packed & ((np.uint32(1) << shift) - np.uint32(1))).astype(
        np.int32
    )
    overflow = packed[:, 0] == _RLE_OVERFLOW
    valid = (starts < lengths[:, None]) & ~overflow[:, None]
    nxt = np.empty_like(starts)
    nxt[:, :-1] = starts[:, 1:]
    nxt[:, -1] = 0
    has_next = np.zeros_like(valid)
    has_next[:, :-1] = valid[:, 1:]
    nxt = np.where(has_next, nxt, lengths[:, None])
    reps = np.where(valid, nxt - starts, 0)
    flat = np.repeat(states[valid], reps[valid])
    bounds = np.concatenate([[0], np.cumsum(reps.sum(axis=1))])
    rows = []
    full = None
    for i in range(n):
        if overflow[i]:
            if full is None:
                full = full_fetch()
            rows.append(
                np.asarray(full[i, : lengths[i]], np.int32)
            )
        else:
            rows.append(
                flat[bounds[i] : bounds[i + 1]].astype(
                    np.int32, copy=False
                )
            )
    return rows


def _fetch_rows(result, lens_np, shift):
    """Fetch one dispatch's decode result as a list of int32 rows
    (len(lens_np) rows, each trimmed to its length)."""
    packed, paths_dev = result
    if packed is None:
        full = np.asarray(paths_dev)
        return [
            full[i, :l].astype(np.int32, copy=False)
            for i, l in enumerate(lens_np)
        ]
    return _rle_expand(
        np.asarray(packed)[: len(lens_np)], lens_np, shift,
        lambda: np.asarray(paths_dev),
    )


def _obs_for(params, gauss_params, sym, w, v):
    """Observation log-likelihood block of every decode dispatch:
    categorical tracks + optional gaussian densities + optional segment
    weights."""
    obs = track_log_likelihoods(params.log_em, sym)
    if v is not None:
        from tehmm_tpu.models.gauss import gauss_log_likelihoods

        obs = obs + gauss_log_likelihoods(gauss_params, v)
    if w is not None:
        obs = obs * w[:, :, None]
    return obs


def _decode_rows(params, obs, lens, mode, engine, interpret):
    """Per-row state paths of one obs block: Viterbi, or the argmax of
    the posteriors ("maxpost"), on the engine ``select_engine``
    resolved."""
    ls, lt = params.log_start, params.log_trans
    if mode == "viterbi":
        if engine == "kernel":
            paths, _ = gpu_kernels.viterbi(
                ls, lt, obs, lens, interpret=interpret
            )
        else:
            paths, _ = dp.viterbi(ls, lt, obs, lens)
        return paths
    if engine == "kernel":
        ah, _, _ = gpu_kernels.forward_scaled(
            ls, lt, obs, lens, interpret=interpret
        )
        bh, _ = gpu_kernels.backward_scaled(
            lt, obs, lens, interpret=interpret
        )
    else:
        ah, _, _ = dp.forward_scaled(ls, lt, obs, lens)
        bh, _ = dp.backward_scaled(lt, obs, lens)
    return jnp.argmax(dp.posterior_scaled(ah, bh), axis=-1)


def _resolve_engine(mode, num_states, engine, interpret):
    return gpu_kernels.select_engine(
        "viterbi" if mode == "viterbi" else "estep",
        num_states, engine, interpret,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mode", "Lc", "num_slots", "engine", "interpret"),
)
def _resident_dispatch(params, gauss_params, sym_dev, w_dev, v_dev,
                       starts, lens, *, mode, Lc, num_slots,
                       engine, interpret=False):
    """One resident-decode dispatch: gather the row group's halo
    windows from the device-resident table, decode, and run-length-pack
    the paths.  Host inputs are two tiny int32 vectors; the download is
    the packed runs (plus the per-base block only on slot overflow).
    Padding matches batch_chunks exactly (zeros beyond each row's
    length) so results are bit-identical to the host-batched path."""
    idx = starts[:, None] + jnp.arange(Lc, dtype=jnp.int32)[None, :]
    idxc = jnp.clip(idx, 0, sym_dev.shape[0] - 1)
    mask = jnp.arange(Lc, dtype=jnp.int32)[None, :] < lens[:, None]
    sym = jnp.where(mask[:, :, None], sym_dev[idxc], 0)
    w = None if w_dev is None else jnp.where(mask, w_dev[idxc], 0.0)
    v = (
        None if v_dev is None
        else jnp.where(mask[:, :, None], v_dev[idxc], 0.0)
    )
    S = params.log_em.shape[0]
    obs = _obs_for(params, gauss_params, sym, w, v)
    paths = _decode_rows(params, obs, lens, mode, engine, interpret)
    return _pack_for_transport(paths, lens, S, Lc, num_slots)


def _next_pow2(n: int) -> int:
    return 1 << max(12, (n - 1).bit_length())


class _ResidentDecoder:
    """Chunk decoding against device-resident tables.

    Re-uploading every row group's halo windows and downloading
    per-base paths makes a genome-scale decode transfer-bound.  This
    decoder uploads every table ONCE, back-to-back, before any compute;
    each dispatch then sends only chunk offsets, gathers the windows on
    device, and downloads run-length-packed change points.  Tables are
    padded to power-of-two lengths so differently-sized tables share
    compiled dispatch shapes.

    ``prestaged``: when the caller already holds the tables on device —
    models/hmm.fit keeps its staged training batch for exactly this
    (the train → decode pipeline) — skip the upload entirely and gather
    windows from the flat staged sequence at each table's offset."""

    def __init__(self, params, mats, value_arrays, weight_arrays,
                 gauss_params, rows_per_pass, mode, prestaged=None,
                 engine="xla", interpret=False):
        self.params = params
        self.gauss = gauss_params
        self.rows_per_pass = rows_per_pass
        self.mode = mode
        self.engine = engine
        self.interpret = interpret
        self.S = int(params.log_em.shape[0])

        def _put(m, dtype=None):
            m = np.asarray(m) if dtype is None else np.asarray(m, dtype)
            Lp = _next_pow2(len(m))
            if Lp > len(m):
                m = np.concatenate(
                    [m, np.zeros((Lp - len(m),) + m.shape[1:], m.dtype)]
                )
            return jax.device_put(np.ascontiguousarray(m))

        if prestaged is not None:
            self.off = list(prestaged.offsets)
            self.sym_dev = [prestaged.sym_flat] * len(mats)
            self.val_dev = (
                None if (prestaged.val_flat is None
                         or gauss_params is None)
                else [prestaged.val_flat] * len(mats)
            )
            # decode-time weights never come from the cache (gate in
            # _make_decoder_factory); training weights stay unused here
            self.w_dev = None
            jax.block_until_ready(self.sym_dev[0])
            return

        self.off = [0] * len(mats)
        self.sym_dev = [_put(m) for m in mats]
        self.val_dev = (
            None if value_arrays is None
            else [_put(v, np.float32) for v in value_arrays]
        )
        self.w_dev = (
            None if weight_arrays is None
            else [_put(w, np.float32) for w in weight_arrays]
        )
        jax.block_until_ready(self.sym_dev)

    def decode(self, chunk_list):
        out = [None] * len(chunk_list)
        groups: dict[int, list[int]] = {}
        for k, c in enumerate(chunk_list):
            groups.setdefault(c.table_idx, []).append(k)
        for ti, idxs in groups.items():
            rows = self._decode_table(ti, [chunk_list[k] for k in idxs])
            for k, r in zip(idxs, rows):
                out[k] = r
        return out

    def _decode_table(self, ti, chunks):
        n = len(chunks)
        starts = np.asarray(
            [c.load_start for c in chunks], np.int32
        ) + np.int32(self.off[ti])
        lens = np.asarray([c.load_len for c in chunks], np.int32)
        # round the window up so widened retries bucket into few
        # compiled shapes (masked tail positions are inert)
        Lc = -(-int(lens.max()) // 512) * 512
        num_slots = (
            _rle_slots(Lc) if _rle_supported(self.S, Lc) else 0
        )
        shift = _rle_shift(self.S)
        # Every dispatch costs a fixed D2H round trip.  Grow the row
        # group geometrically until the whole table fits ~16 dispatches,
        # bounded by a window-buffer budget so the gathered [rpp, Lc, T]
        # block and its obs f32[rpp, Lc, S] stay modest.
        rpp = self.rows_per_pass
        sym = self.sym_dev[ti]
        row_bytes = Lc * int(np.prod(sym.shape[1:])) * sym.dtype.itemsize
        row_bytes += Lc * self.S * 4
        if self.val_dev is not None:
            row_bytes += Lc * int(
                np.prod(self.val_dev[ti].shape[1:])
            ) * 4
        while rpp * 2 * row_bytes <= (384 << 20) and n > 16 * rpp:
            rpp *= 2
        rows_out = [None] * n

        def dispatch(lo, hi):
            s, l = _pad_rows(rpp - (hi - lo), starts[lo:hi], lens[lo:hi])
            return _resident_dispatch(
                self.params, self.gauss, self.sym_dev[ti],
                None if self.w_dev is None else self.w_dev[ti],
                None if self.val_dev is None else self.val_dev[ti],
                jnp.asarray(s), jnp.asarray(l),
                mode=self.mode, Lc=Lc, num_slots=num_slots,
                engine=self.engine, interpret=self.interpret,
            )

        def consume(lo, hi, result):
            for k, r in enumerate(
                _fetch_rows(result, lens[lo:hi], shift)
            ):
                rows_out[lo + k] = r

        _pipelined_groups(n, rpp, dispatch, consume)
        return rows_out


def _make_decoder_factory(params, gauss_params, weight_arrays,
                          rows_per_pass, mode, resident,
                          prestaged=None, engine="xla", interpret=False):
    """Resolve whether this decode runs device-resident.  ``resident``:
    True/False force; None = auto — on unless TEHMM_DECODE_RESIDENT
    disables it or the tables exceed the device staging budget
    (models/hmm._device_input_budget), in which case the host-batched
    streaming path is used unchanged.  ``prestaged`` (models/hmm fit
    staging cache): decode against the already-device-resident
    sequence, skipping both the budget gate and the upload — used only
    if it also carries whatever weight/value streams this decode
    needs."""
    if resident is False:
        return None

    # prestaged covers a weightless decode only: decode-time weight
    # arrays are caller inputs that need not equal the cached training
    # weights, so any weighted decode takes the upload path.  The
    # TEHMM_DECODE_RESIDENT=off kill switch applies here too — it must
    # disable EVERY resident path, cached or uploaded.
    if prestaged is not None and weight_arrays is None and (
        gauss_params is None or prestaged.val_flat is not None
    ) and os.environ.get(
        "TEHMM_DECODE_RESIDENT", "auto"
    ).lower() not in ("0", "off", "false"):
        def prestaged_factory(mats, value_arrays):
            return _ResidentDecoder(
                params, mats, value_arrays, weight_arrays,
                gauss_params, rows_per_pass, mode,
                prestaged=prestaged, engine=engine, interpret=interpret,
            ).decode

        return prestaged_factory

    def factory(mats, value_arrays):
        use = resident
        if use is None:
            env = os.environ.get(
                "TEHMM_DECODE_RESIDENT", "auto"
            ).lower()
            if env in ("0", "off", "false"):
                return None

            # EXACT device footprint after _ResidentDecoder's pow2
            # padding (a 2x worst-case bound here kept genome-scale
            # decodes — 250M x 15 = 3.75 GB, padded 4.02 GB — on the
            # 100x-slower host-batched path; round-5)
            def _padded(m, itemsize):
                return _next_pow2(len(m)) * itemsize

            total = sum(
                _padded(m, m.nbytes // max(len(m), 1)) for m in mats
            )
            if value_arrays is not None:
                total += sum(
                    _padded(v, v.nbytes // max(len(v), 1))
                    for v in value_arrays
                )
            if weight_arrays is not None:
                total += sum(_padded(w, 4) for w in weight_arrays)
            from tehmm_tpu.models.hmm import _device_input_budget

            use = total <= _device_input_budget()
        if not use:
            return None
        return _ResidentDecoder(
            params, mats, value_arrays, weight_arrays, gauss_params,
            rows_per_pass, mode, engine=engine, interpret=interpret,
        ).decode

    return factory


def _rows_batch(
    params: HmmParams,
    symbols: np.ndarray,
    lengths: np.ndarray,
    rows_per_pass: int,
    mode: str,
    weights: np.ndarray | None,
    gauss_params,
    values: np.ndarray | None,
    engine: str,
    interpret: bool,
) -> np.ndarray:
    """Per-row paths over a chunk batch, in row groups of fixed compiled
    shape; a bounded number of groups stays in flight so result fetches
    overlap the next groups' upload + compute (_pipelined_groups), and
    paths download run-length-packed (_rle_pack)."""
    n, L, _T = symbols.shape
    out = np.zeros((n, L), dtype=np.int32)
    S = params.log_em.shape[0]
    engine = _resolve_engine(mode, S, engine, interpret)

    def dispatch(lo, hi):
        sym, lens, w, v = _pad_rows(
            rows_per_pass - (hi - lo),
            symbols[lo:hi], lengths[lo:hi],
            None if weights is None else weights[lo:hi],
            None if values is None else values[lo:hi],
        )
        jlens = jnp.asarray(lens)
        obs = _obs_for(
            params, gauss_params, jnp.asarray(sym),
            None if w is None else jnp.asarray(w),
            None if v is None else jnp.asarray(v),
        )
        paths = _decode_rows(params, obs, jlens, mode, engine, interpret)
        return _pack_for_transport(paths, jlens, S, L)

    def consume(lo, hi, result):
        for k, r in enumerate(
            _fetch_rows(result, lengths[lo:hi], _rle_shift(S))
        ):
            out[lo + k, : len(r)] = r

    _pipelined_groups(n, rows_per_pass, dispatch, consume)
    return out


def _decode_batch(params, symbols, lengths, rows_per_pass, weights=None,
                  gauss_params=None, values=None, engine="auto",
                  interpret=False) -> np.ndarray:
    """Viterbi paths over a chunk batch (see _rows_batch)."""
    return _rows_batch(
        params, symbols, lengths, rows_per_pass, "viterbi", weights,
        gauss_params, values, engine, interpret,
    )


def _posterior_batch(params, symbols, lengths, rows_per_pass,
                     gauss_params=None, values=None, weights=None,
                     engine="auto", interpret=False) -> np.ndarray:
    """argmax-gamma paths over a chunk batch (see _rows_batch)."""
    return _rows_batch(
        params, symbols, lengths, rows_per_pass, "maxpost", weights,
        gauss_params, values, engine, interpret,
    )


def _stitched_decode(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int,
    halo: int,
    max_halo: int,
    agree_frac: float,
    decode_rows,          # (symbols, lengths) chunk batch -> int32 rows
    exact_fn,             # exact whole-input fallback
    name: str,
    weight_arrays,
    gauss_params,
    decoder_factory=None,
) -> tuple[list[np.ndarray], StitchReport]:
    """Shared halo-stitching driver for Viterbi and max-posterior decode.

    Chunk CORES are fixed by ``chunk_len`` (plan_chunks: halo only widens
    the loads), so widening is TARGETED: after the initial full decode,
    every internal boundary is checked, and each retry re-decodes ONLY
    the chunks adjacent to still-disagreeing boundaries at their doubled
    halo — one genome-scale pass total plus O(halo) work per bad
    boundary, instead of a whole re-decode per retry.  Boundaries
    touching a re-decoded chunk are re-checked (a new core can flip a
    previously-agreeing neighbor).

    Guarantee note (honest contract): boundary agreement is a STRONG
    HEURISTIC for monolithic equality — two truncated decodes that agree
    around a boundary have almost certainly forgotten their load edges,
    but agreement between neighbors does not PROVE either equals the
    monolithic decode (they share most context and can resolve a near-
    tie identically yet differently from the full-context decode).
    Fixtures assert equality against monolithic decodes, disagreement
    triggers widening, and persistent disagreement falls back to the
    exact decoder; callers needing the unconditional guarantee use
    viterbi_exact / posterior_exact (eval --exact) directly.
    """
    mats = [getattr(t, "symbols", t) for t in tables]
    value_arrays = None
    if gauss_params is not None:
        value_arrays = [
            np.asarray(t.values, np.float32) for t in tables
        ]
    lengths = [len(m) for m in mats]

    resident_decode = (
        decoder_factory(mats, value_arrays)
        if decoder_factory is not None else None
    )

    def decode_at(chunk_list):
        if resident_decode is not None:
            return resident_decode(chunk_list)
        batch = batch_chunks(mats, chunk_list)
        wb = (None if weight_arrays is None
              else _weight_batch(weight_arrays, chunk_list))
        vb = (None if value_arrays is None
              else batch_chunks(value_arrays, chunk_list).symbols)
        return decode_rows(batch.symbols, batch.lengths, wb, vb)

    base = plan_chunks(lengths, chunk_len, 0)     # halo-free cores
    h0 = min(halo, max_halo)

    def with_halo(c, h):
        L = lengths[c.table_idx]
        return dataclasses.replace(
            c,
            load_start=max(0, c.core_start - h),
            load_end=min(L, c.core_end + h),
        )

    chunk_halo = [h0] * len(base)
    chunks = [with_halo(c, h0) for c in base]
    rows = list(decode_at(chunks))                # per-chunk decoded row

    # internal boundaries: (left chunk idx, right chunk idx)
    bounds = [
        (i, i + 1)
        for i in range(len(base) - 1)
        if base[i].table_idx == base[i + 1].table_idx
    ]

    def agree(i, j):
        a, b = chunks[i], chunks[j]
        x = a.core_end                 # == b.core_start
        w = max(1, int(min(chunk_halo[i], chunk_halo[j]) * agree_frac))
        lo = max(x - w, a.load_start, b.load_start)
        hi = min(x + w, a.load_end, b.load_end)
        if lo >= hi:
            return True
        seg_a = rows[i][lo - a.load_start : hi - a.load_start]
        seg_b = rows[j][lo - b.load_start : hi - b.load_start]
        return np.array_equal(seg_a, seg_b)

    failing = {bd for bd in bounds if not agree(*bd)}
    retries = 0
    while failing and any(
        min(chunk_halo[i], chunk_halo[j]) < max_halo for i, j in failing
    ):
        retries += 1
        affected = sorted({
            i for bd in failing for i in bd
            if chunk_halo[i] < max_halo      # capped: same decode again
        })
        for i in affected:
            chunk_halo[i] = min(chunk_halo[i] * 2, max_halo)
            chunks[i] = with_halo(base[i], chunk_halo[i])
        logger.info(
            "%s: re-decoding %d chunk(s) around %d disagreeing "
            "boundary(ies) at halo<=%d (retry %d)",
            name, len(affected), len(failing),
            max(chunk_halo[i] for i in affected), retries,
        )
        fresh = decode_at([chunks[i] for i in affected])
        for k, i in enumerate(affected):
            rows[i] = fresh[k]
        # update membership ONLY for boundaries whose rows changed;
        # untouched failing boundaries (e.g. both chunks capped) must
        # STAY failing — recomputing `failing` from the recheck set
        # alone would silently drop them and skip the exact fallback
        recheck = {
            bd for bd in bounds
            if bd[0] in set(affected) or bd[1] in set(affected)
        }
        for bd in recheck:
            if agree(*bd):
                failing.discard(bd)
            else:
                failing.add(bd)

    ok = not failing
    if ok:
        paths = [np.zeros(L, dtype=np.int32) for L in lengths]
        for c, row in zip(chunks, rows):
            paths[c.table_idx][c.core_start : c.core_end] = \
                row[c.core_offset : c.core_offset + c.core_len]
    else:
        # halo forgetting never kicked in (adversarial/near-tie model):
        # fall back to the EXACT decoder — sequential over chunks but
        # guaranteed == monolithic
        logger.warning(
            "%s: boundary disagreement persists at max_halo=%d; "
            "falling back to the exact decoder", name, max_halo,
        )
        paths = exact_fn(
            params, tables, chunk_len,
            gauss_params=gauss_params,
            weight_arrays=weight_arrays,
        )
        ok = True     # the exact decoder's output is unconditional —
        # boundaries_ok reports whether the FINAL paths carry the
        # guarantee, not whether stitching alone sufficed (retries +
        # final_halo tell that story); consumers (run_milestones,
        # eval's report line) treat ok=False as a failed decode
    return paths, StitchReport(
        n_chunks=len(chunks),
        final_halo=max(chunk_halo, default=h0),
        retries=retries,
        boundaries_checked=len(bounds),
        boundaries_ok=ok,
    )


def viterbi_chunked(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int = 4096,
    halo: int = 256,
    max_halo: int = 1 << 14,
    agree_frac: float = 0.5,
    rows_per_pass: int = 512,
    strict: bool = False,
    weight_arrays: Sequence[np.ndarray] | None = None,
    gauss_params=None,
    resident: bool | None = None,
    prestaged=None,
    engine: str = "auto",
    interpret: bool = False,
) -> tuple[list[np.ndarray], StitchReport]:
    """Decode each table's full span via halo chunks (see
    _stitched_decode for the stitching/widening/guarantee contract).

    Args:
      tables: TrackTables (or raw [L, T] symbol arrays).
      chunk_len: core window size per chunk.
      halo: initial halo width; doubled per disagreeing boundary up to
        max_halo (targeted: only adjacent chunks re-decode).
      agree_frac: fraction of the halo used as the agreement window.
      rows_per_pass: chunks decoded per device dispatch (fixed shape).
      strict: accepted for API compatibility; since the exact
        checkpointed fallback covers every input (including segment
        weights), persistent disagreement can no longer produce
        unchecked output, so there is nothing to raise on.
      weight_arrays: optional per-table f32[L] emission weights
        (segment mode --segLen).
      gauss_params: gaussian-track emissions (models/gauss.py); values
        come from each table's ``.values`` matrix and chunk with the
        symbols.
      resident: device-resident decode (_ResidentDecoder): True/False
        force, None = auto (on when the tables fit the staging budget;
        TEHMM_DECODE_RESIDENT=off disables).  Results are identical
        either way.
      engine / interpret: the decode recurrence's implementation
        (ops/gpu_kernels.select_engine).

    Returns:
      (paths, report): one int32[L] state path per input table.
    """
    engine = _resolve_engine("viterbi", params.num_states, engine,
                             interpret)

    def decode_rows(symbols, lens, wbatch, vbatch):
        return _decode_batch(
            params, symbols, lens, rows_per_pass, wbatch,
            gauss_params, vbatch, engine, interpret,
        )

    return _stitched_decode(
        params, tables, chunk_len, halo, max_halo, agree_frac,
        decode_rows, viterbi_exact, "viterbi_chunked",
        weight_arrays, gauss_params,
        decoder_factory=_make_decoder_factory(
            params, gauss_params, weight_arrays, rows_per_pass,
            "viterbi", resident, prestaged, engine, interpret,
        ),
    )


def posterior_chunked(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int = 1 << 14,
    halo: int = 256,
    max_halo: int = 1 << 14,
    agree_frac: float = 0.5,
    rows_per_pass: int = 64,
    strict: bool = False,
    gauss_params=None,
    weight_arrays: Sequence[np.ndarray] | None = None,
    resident: bool | None = None,
    prestaged=None,
    engine: str = "auto",
    interpret: bool = False,
) -> tuple[list[np.ndarray], StitchReport]:
    """Max-posterior decoding with the same stitching contract as
    viterbi_chunked (see _stitched_decode): halo chunks, all-boundary
    agreement check, targeted halo widening, and an EXACT carried-
    alpha/beta fallback when agreement cannot be reached (reference:
    teHmmEval.py --maxPost; SURVEY.md §2b).  Returns one int32[L]
    argmax-gamma path per table."""
    engine = _resolve_engine("maxpost", params.num_states, engine,
                             interpret)

    def decode_rows(symbols, lens, wbatch, vbatch):
        return _posterior_batch(
            params, symbols, lens, rows_per_pass,
            gauss_params, vbatch, wbatch, engine, interpret,
        )

    return _stitched_decode(
        params, tables, chunk_len, halo, max_halo, agree_frac,
        decode_rows, posterior_exact, "posterior_chunked",
        weight_arrays, gauss_params,
        decoder_factory=_make_decoder_factory(
            params, gauss_params, weight_arrays, rows_per_pass,
            "maxpost", resident, prestaged, engine, interpret,
        ),
    )


def _first_rows(arrays, width, dtype):
    """Row 0 of every array, with an all-zero stand-in for EMPTY tables
    (length-0 query records are legal BED; every consumer masks them
    via true_lens > 0, so the stand-in value never escapes)."""
    return np.stack([
        a[0] if len(a) else np.zeros(width, dtype) for a in arrays
    ])


def posterior_sweep(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int = 1 << 14,
    consume=None,
    gauss_params=None,
    weight_arrays: Sequence[np.ndarray] | None = None,
) -> list[np.ndarray]:
    """EXACT chunked posterior machinery (carried alpha forward sweep +
    carried beta backward sweep, per-chunk recompute; SURVEY.md §7 hard
    part #3).  Device memory is bounded by one chunk; the op sequence
    matches the monolithic scans so gamma — and its argmax — is
    bit-identical to a whole-table pass.

    ``consume(table_idx, start, gamma_chunk)`` is called for every chunk
    in REVERSE time order with gamma f32[valid, S]; the default consumer
    collects argmax paths.  Returns the argmax paths list."""
    mats = [np.ascontiguousarray(getattr(t, "symbols", t)) for t in tables]
    vmats = None
    if gauss_params is not None:
        vmats = [np.asarray(t.values, np.float32) for t in tables]
    wmats = None
    if weight_arrays is not None:
        wmats = [np.asarray(w, np.float32) for w in weight_arrays]
    B = len(mats)
    true_lens = np.asarray([len(m) for m in mats], np.int64)
    T = mats[0].shape[1]
    Lb = int(true_lens.max()) - 1          # body = positions 1..L-1
    Lc = min(chunk_len, max(Lb, 1))
    n_chunks = max(0, -(-Lb // Lc))

    def _gauss_block(lo):
        if vmats is None:
            return None
        G = vmats[0].shape[1]
        vb = np.zeros((B, Lc, G), np.float32)
        for b, v in enumerate(vmats):
            piece = v[lo : lo + Lc]
            vb[b, : len(piece)] = piece
        return vb

    def obs_chunk(c):
        lo = 1 + c * Lc
        block = np.zeros((B, Lc, T), dtype=mats[0].dtype)
        for b, m in enumerate(mats):
            piece = m[lo : lo + Lc]
            block[b, : len(piece)] = piece
        obs = track_log_likelihoods(params.log_em, jnp.asarray(block))
        vb = _gauss_block(lo)
        if vb is not None:
            from tehmm_tpu.models.gauss import gauss_log_likelihoods

            obs = obs + gauss_log_likelihoods(
                gauss_params, jnp.asarray(vb)
            )
        if wmats is not None:
            obs = obs * jnp.asarray(
                _weight_block(wmats, lo, Lc, B)
            )[:, :, None]
        lens = jnp.asarray(np.clip(true_lens - lo, 0, Lc))
        return obs, lens

    # position 0 values (empty tables get inert zero rows — their
    # outputs are masked by true_lens > 0 everywhere below)
    block0 = _first_rows(mats, T, mats[0].dtype)
    obs0 = track_log_likelihoods(
        params.log_em, jnp.asarray(block0[:, None, :])
    )[:, 0, :]
    if vmats is not None:
        from tehmm_tpu.models.gauss import gauss_log_likelihoods

        v0 = _first_rows(vmats, vmats[0].shape[1], np.float32)
        obs0 = obs0 + gauss_log_likelihoods(
            gauss_params, jnp.asarray(v0[:, None, :])
        )[:, 0, :]
    if wmats is not None:
        w0 = np.stack([
            wv[0] if len(wv) else np.float32(1.0) for wv in wmats
        ])
        obs0 = obs0 * jnp.asarray(w0)[:, None]
    a0 = params.log_start[None, :] + obs0
    m0 = jnp.maximum(jnp.max(a0, axis=-1, keepdims=True), -1e30)
    carry = a0 - m0

    # ---- forward sweep: store the carry entering each chunk ----
    entry_carries = []
    for c in range(n_chunks):
        entry_carries.append(carry)
        obs, lens = obs_chunk(c)
        _, carry = dp.forward_chunk_values(
            params.log_trans, obs, carry, lens
        )

    paths = [np.zeros(L, np.int32) for L in map(int, true_lens)]

    def default_consume(b, start, gamma):
        paths[b][start : start + len(gamma)] = np.argmax(gamma, axis=-1)

    consume = consume or default_consume

    # ---- backward sweep with per-chunk gamma ----
    S = params.num_states
    x_carry = jnp.zeros((B, S), jnp.float32)
    for c in reversed(range(n_chunks)):
        obs, lens = obs_chunk(c)
        lo = 1 + c * Lc
        continuing = jnp.asarray(true_lens > lo + Lc)
        a_hats, _ = dp.forward_chunk_values(
            params.log_trans, obs, entry_carries[c], lens
        )
        b_hats, x_carry = dp.backward_chunk_values(
            params.log_trans, obs, x_carry, continuing, lens
        )
        gamma = np.asarray(dp.posterior_scaled(a_hats, b_hats))
        lens_np = np.asarray(lens)
        for b in range(B):
            n_valid = int(lens_np[b])
            if n_valid > 0:
                consume(b, lo, gamma[b, :n_valid])

    # ---- position 0: gamma from a0 and the final x_carry ----
    # beta at position 0 = logdot(x_carry, T^T) for rows longer than 1
    beta0 = dp.backward_chunk_values(
        params.log_trans,
        jnp.asarray(obs0[:, None, :]) * 0.0,  # obs row unused at Lc=1
        x_carry,
        jnp.asarray(true_lens > 1),
        jnp.asarray(np.ones(B, np.int64)),
    )[0][:, 0, :]
    gamma0 = np.asarray(dp.posterior_scaled(a0 - m0, beta0))
    for b in range(B):
        if true_lens[b] > 0:
            consume(b, 0, gamma0[b : b + 1])
    return paths


def posterior_exact(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int = 1 << 14,
    gauss_params=None,
    weight_arrays: Sequence[np.ndarray] | None = None,
) -> list[np.ndarray]:
    """Exact max-posterior paths (argmax of the bit-exact chunked gamma)."""
    return posterior_sweep(
        params, tables, chunk_len, gauss_params=gauss_params,
        weight_arrays=weight_arrays,
    )


def viterbi_exact(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int = 1 << 14,
    gauss_params=None,
    weight_arrays: Sequence[np.ndarray] | None = None,
) -> list[np.ndarray]:
    """EXACT chunked Viterbi via checkpointed carries (SURVEY.md §7 hard
    part #3): a cheap forward sweep stores only the O(S) carry at every
    chunk boundary; the backtrace sweep recomputes each chunk's value
    rows from its stored carry and walks the optimal path backwards
    through it.  Bit-identical to the monolithic decode for ANY model
    (no halo/forgetting assumption), with device memory bounded by one
    chunk.  Sequential over chunks within a sequence, batched across
    sequences; used as the fallback when halo stitching cannot reach
    agreement, and directly for adversarial models.
    """
    mats = [np.ascontiguousarray(getattr(t, "symbols", t)) for t in tables]
    vmats = None
    if gauss_params is not None:
        vmats = [np.asarray(t.values, np.float32) for t in tables]
    wmats = None
    if weight_arrays is not None:
        wmats = [np.asarray(w, np.float32) for w in weight_arrays]
    B = len(mats)
    true_lens = np.asarray([len(m) for m in mats], np.int64)
    T = mats[0].shape[1]
    Lb = int(true_lens.max()) - 1          # body = positions 1..L-1
    Lc = min(chunk_len, max(Lb, 1))
    n_chunks = max(0, -(-Lb // Lc))

    def obs_chunk(c):
        """obs for body positions [1 + c*Lc, 1 + (c+1)*Lc) padded."""
        lo = 1 + c * Lc
        block = np.zeros((B, Lc, T), dtype=mats[0].dtype)
        for b, m in enumerate(mats):
            piece = m[lo : lo + Lc]
            block[b, : len(piece)] = piece
        obs = track_log_likelihoods(
            params.log_em, jnp.asarray(block)
        )
        if vmats is not None:
            from tehmm_tpu.models.gauss import gauss_log_likelihoods

            G = vmats[0].shape[1]
            vb = np.zeros((B, Lc, G), np.float32)
            for b, v in enumerate(vmats):
                piece = v[lo : lo + Lc]
                vb[b, : len(piece)] = piece
            obs = obs + gauss_log_likelihoods(
                gauss_params, jnp.asarray(vb)
            )
        if wmats is not None:
            obs = obs * jnp.asarray(
                _weight_block(wmats, lo, Lc, B)
            )[:, :, None]
        lens = jnp.asarray(np.clip(true_lens - lo, 0, Lc))
        return obs, lens

    # position 0 values (empty tables get inert zero rows — masked by
    # true_lens > 0 in the assembly below)
    block0 = _first_rows(mats, T, mats[0].dtype)
    obs0 = track_log_likelihoods(
        params.log_em, jnp.asarray(block0[:, None, :])
    )[:, 0, :]
    if vmats is not None:
        from tehmm_tpu.models.gauss import gauss_log_likelihoods

        vv0 = _first_rows(vmats, vmats[0].shape[1], np.float32)
        obs0 = obs0 + gauss_log_likelihoods(
            gauss_params, jnp.asarray(vv0[:, None, :])
        )[:, 0, :]
    if wmats is not None:
        w0 = np.stack([
            wv[0] if len(wv) else np.float32(1.0) for wv in wmats
        ])
        obs0 = obs0 * jnp.asarray(w0)[:, None]
    v0 = params.log_start[None, :] + obs0
    m0 = jnp.maximum(jnp.max(v0, axis=-1, keepdims=True), -1e30)
    carry = v0 - m0

    # ---- forward sweep: store the carry entering each chunk ----
    entry_carries = []
    for c in range(n_chunks):
        entry_carries.append(carry)
        obs, lens = obs_chunk(c)
        carry = dp.viterbi_carry(params.log_trans, obs, carry, lens)

    # ---- backtrace sweep ----
    end_state = jnp.argmax(carry, axis=-1).astype(jnp.int32)
    max_len = int(true_lens.max())
    if max_len == 0:                  # every table empty
        return [np.zeros(0, np.int32) for _ in range(B)]
    paths = np.zeros((B, max_len), np.int32)
    for c in reversed(range(n_chunks)):
        obs, lens = obs_chunk(c)
        v_hats = dp.viterbi_chunk_values(
            params.log_trans, obs, entry_carries[c], lens
        )
        chunk_path, end_state = dp.viterbi_backtrace_chunk(
            params.log_trans, v_hats, entry_carries[c], end_state, lens
        )
        lo = 1 + c * Lc
        cp = np.asarray(chunk_path)
        for b in range(B):
            hi = min(lo + Lc, int(true_lens[b]))
            if hi > lo:
                paths[b, lo:hi] = cp[b, : hi - lo]
    paths[:, 0] = np.asarray(end_state)
    return [paths[b, : int(true_lens[b])].copy() for b in range(B)]
