"""tehmm-eval: decode query regions with a trained model
(reference: teHmmEval.py; SURVEY.md §2b, §3.2).

Usage:
  python -m tehmm_tpu.cli.eval tracks.xml model.npz query.bed --bed out.bed

Prints total log-likelihood to stdout (reference behavior).  Category
maps come FROM THE MODEL so symbols match training (SURVEY.md §3.2 ★).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tehmm_tpu.io import (
    TrackList,
    load_track_data,
    read_bed_intervals,
    write_bed_intervals,
)
from tehmm_tpu.models.hmm import MultitrackHmm
from tehmm_tpu.utils.common import (
    add_logging_options,
    logger,
    set_logging_from_options,
)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tehmm-eval",
        description="Viterbi/posterior decoding of genomic regions",
    )
    p.add_argument("tracksInfo", help="tracks XML config file")
    p.add_argument("inputModel", help="trained model (.npz)")
    p.add_argument("bedRegions", help="query regions BED")
    p.add_argument("--bed", default=None,
                   help="write Viterbi annotations to this BED file")
    p.add_argument("--maxPost", action="store_true",
                   help="max-posterior decoding instead of Viterbi")
    p.add_argument("--pd", default=None,
                   help="write per-position posterior distribution BED")
    p.add_argument("--chunk", type=int, default=4096,
                   help="decode chunk length (wider batches of shorter "
                        "chunks keep the scan kernels full; measured "
                        "best at 4096 x 512 rows per pass)")
    p.add_argument("--halo", type=int, default=256,
                   help="stitching halo width")
    p.add_argument("--maxSpan", type=int, default=None,
                   help="CFG models: CYK chart budget per window "
                        "(default: the model's training --maxSpan); "
                        "longer regions decode via halo-stitched "
                        "windows")
    p.add_argument("--exact", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="use the exact checkpointed chunked decoder "
                        "instead of halo stitching (always equals the "
                        "monolithic decode; sequential over chunks). "
                        "Default: AUTO — exact when the input is small "
                        "enough that sequential decoding costs nothing "
                        "(<= 256K positions), stitched beyond; "
                        "--no-exact forces stitching")
    p.add_argument("--segment", action="store_true",
                   help="query BED contains segment-tracks output: one "
                        "observation per segment (reference: teHmmEval "
                        "--segment)")
    p.add_argument("--segLen", action="store_true",
                   help="with --segment: length-weighted emissions "
                        "(must match training)")
    p.add_argument("--mesh", type=int, default=0,
                   help="decode/score over an N-device data mesh "
                        "(0 = single device).  CFG models: shards CYK "
                        "Viterbi and --maxPost/--pd inside-outside "
                        "windows.  HMM models: the printed forward "
                        "log-likelihood (non-Viterbi modes) uses the "
                        "exact sequence-parallel forward "
                        "(parallel/seqpar) — each region's time axis "
                        "shards over the devices")
    add_logging_options(p)
    return p


def main(argv=None) -> int:
    from tehmm_tpu.utils.platform import setup_jax

    setup_jax()
    opts = make_parser().parse_args(argv)
    set_logging_from_options(opts)

    try:
        model = MultitrackHmm.load(opts.inputModel)
    except FileNotFoundError:
        raise SystemExit(
            f"model file not found: {opts.inputModel}"
        )
    # The eval-time XML supplies DATA PATHS only; every semantic
    # attribute (distribution, scale/logScale/shift, valCol, default)
    # comes from the MODEL's saved track list — the "symbols match
    # training" invariant (module header) breaks silently if eval-time
    # binning diverges from training-time binning
    track_list = TrackList(opts.tracksInfo)
    for t in model.track_list:
        if track_list.get_track_by_name(t.name) is None:
            raise SystemExit(
                f"track {t.name!r} required by the model is missing from "
                f"{opts.tracksInfo}"
            )
    # order/selection comes from the model
    eval_list = TrackList()
    for t in model.track_list:
        src = track_list.get_track_by_name(t.name)
        import dataclasses as _dc

        clone = _dc.replace(t, path=src.path, number=-1)
        eval_list.add(clone)

    regions = read_bed_intervals(opts.bedRegions, ncol=3)
    cfg_meta = model.extra.get("cfg") if model.extra else None
    if opts.segment:
        from tehmm_tpu.io.segments import load_segment_data

        if cfg_meta:
            raise SystemExit(
                "--segment with a CFG model is not supported: the "
                "pair-grammar spans are defined over base positions, "
                "not segments (decode without --segment)"
            )
        track_data, seg_tables = load_segment_data(
            eval_list, regions, category_maps=model.category_maps
        )
        _resolve_exact(opts, seg_tables)
        return _eval_segments(opts, model, seg_tables)
    track_data = load_track_data(
        eval_list, regions, category_maps=model.category_maps
    )
    if cfg_meta:
        # CFG decode is always halo-stitched CYK / windowed
        # inside-outside; --exact does not apply (and the auto log
        # line would claim a guarantee the path doesn't provide)
        opts.exact = False
    else:
        _resolve_exact(opts, track_data.tables)

    viterbi_like = not (cfg_meta or opts.maxPost)
    paths = None
    cfg_gammas = None
    if opts.bed:
        if cfg_meta:
            paths, cfg_gammas = _cfg_decode(
                model, cfg_meta, track_data.tables, opts.maxSpan,
                max_post=opts.maxPost, halo=opts.halo,
                mesh_size=opts.mesh,
            )
        elif opts.maxPost:
            if opts.exact:
                from tehmm_tpu.parallel.stitch import posterior_exact

                paths = posterior_exact(
                    model.params, track_data.tables,
                    chunk_len=opts.chunk, gauss_params=model.gauss,
                )
            else:
                paths = model.posterior_decode_tables(
                    track_data.tables, chunk_len=opts.chunk,
                    halo=opts.halo,
                )
        elif opts.exact:
            from tehmm_tpu.parallel.stitch import viterbi_exact

            paths = viterbi_exact(
                model.params, track_data.tables, chunk_len=opts.chunk,
                gauss_params=model.gauss,
            )
        else:
            paths, report = model.decode_tables(
                track_data.tables, chunk_len=opts.chunk, halo=opts.halo
            )
            logger.info(
                "decoded %d chunks (halo %d, retries %d, "
                "boundaries ok=%s)",
                report.n_chunks, report.final_halo, report.retries,
                report.boundaries_ok,
            )

    # Printed score (reference: teHmmEval prints the log probability from
    # hmm.decode [R] — i.e. the VITERBI path's joint log-prob when Viterbi
    # decoding).  Deriving it from the decoded path costs O(L·T) on the
    # host instead of a second full forward pass over the device
    # (round-1 review: eval paid ~2x device work just for this print).
    # Posterior/CFG modes (and plain scoring without --bed) print the
    # forward log-likelihood.
    if viterbi_like and paths is not None:
        from tehmm_tpu.models.hmm import path_log_score

        total_ll = sum(
            path_log_score(
                model.params, tab.symbols, p,
                gauss=model.gauss, values=tab.values,
            )
            for tab, p in zip(track_data.tables, paths)
        )
    else:
        mesh = None
        if opts.mesh and not cfg_meta:
            from tehmm_tpu.parallel import make_data_mesh

            mesh = make_data_mesh(opts.mesh)
        total_ll = model.score(
            track_data.tables, chunk_len=opts.chunk, mesh=mesh
        )
    print(f"{total_ll}")

    if opts.bed:
        from tehmm_tpu.models.hmm import path_to_intervals

        out = []
        for tab, path in zip(track_data.tables, paths):
            out.extend(path_to_intervals(
                tab.chrom, tab.start, np.asarray(path),
                model.state_names,
            ))
        write_bed_intervals(out, opts.bed)
        logger.info("wrote %d intervals to %s", len(out), opts.bed)

    if opts.pd:
        if cfg_meta:
            # pair-grammar posteriors (inside-outside gamma), not the
            # HMM approximation; reuse the decode pass's gammas if
            # --maxPost already computed them (bounded-span premise
            # keeps these window-sized — no genome-scale table here)
            if cfg_gammas is None:
                _, cfg_gammas = _cfg_decode(
                    model, cfg_meta, track_data.tables, opts.maxSpan,
                    max_post=True, halo=opts.halo,
                    mesh_size=opts.mesh,
                )
            rows = []
            for tab, pd in zip(track_data.tables, cfg_gammas):
                for i in range(len(tab)):
                    probs = ",".join(f"{p:.6g}" for p in pd[i])
                    rows.append((
                        tab.chrom, tab.start + i, tab.start + i + 1,
                        probs,
                    ))
            write_bed_intervals(rows, opts.pd)
        else:
            _write_pd_streaming(opts, model, track_data.tables)

    return 0


def _write_pd_streaming(opts, model, tables) -> None:
    """--pd at base resolution in BOUNDED host memory: gamma chunks
    stream straight out of the exact carried-alpha/beta sweep (which
    visits them in REVERSE time order) into per-chunk spool files,
    concatenated ascending at the end.  The previous implementation
    materialized every table's full [L, S] float32 gamma PLUS one
    Python tuple per genomic base before writing — tens of GB for a
    chromosome-scale --pd."""
    import os
    import shutil
    import tempfile

    from tehmm_tpu.parallel.stitch import posterior_sweep

    tmpdir = tempfile.mkdtemp(prefix="tehmm_pd_")
    spool: dict[tuple[int, int], str] = {}
    try:
        def consume(b, start, gamma):
            tab = tables[b]
            fn = os.path.join(tmpdir, f"{b}_{start}.part")
            base = tab.start + start
            with open(fn, "w") as fh:
                for i in range(len(gamma)):
                    probs = ",".join(f"{p:.6g}" for p in gamma[i])
                    fh.write(
                        f"{tab.chrom}\t{base + i}\t{base + i + 1}"
                        f"\t{probs}\n"
                    )
            spool[(b, start)] = fn

        posterior_sweep(
            model.params, tables, chunk_len=opts.chunk,
            consume=consume, gauss_params=model.gauss,
        )
        with open(opts.pd, "w") as out_fh:
            for key in sorted(spool):
                with open(spool[key]) as fh:
                    shutil.copyfileobj(fh, out_fh)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


# below this many total positions the sequential exact decoder is
# effectively free — make its unconditional bit-exactness the DEFAULT
# (the stitching heuristic's guarantee rests on "all boundaries agreed
# this time"; small inputs shouldn't rest on it)
_EXACT_AUTO_LIMIT = 1 << 18


def _resolve_exact(opts, tables) -> None:
    if opts.exact is None:
        total = sum(len(t.symbols) for t in tables)
        opts.exact = total <= _EXACT_AUTO_LIMIT
        if opts.exact:
            logger.info(
                "input is small (%d positions) — using the exact "
                "chunked decoder (--no-exact restores stitching)",
                total,
            )


def _eval_segments(opts, model, seg_tables) -> int:
    """Segment-resolution decode: Viterbi (default), max-posterior
    (--maxPost), or posterior distributions (--pd) over per-segment
    observations, expanded back to base-space BED (reference:
    teHmmEval --segment)."""
    from tehmm_tpu.io.segments import expand_path
    from tehmm_tpu.parallel.stitch import viterbi_chunked

    weights = None
    if opts.segLen:
        weights = [t.lengths.astype("float32") for t in seg_tables]
    dists = None
    if opts.pd:
        dists = model.posterior_distributions(
            seg_tables, chunk_len=opts.chunk, weight_arrays=weights,
        )
    viterbi_like = bool(opts.bed) and not opts.maxPost
    if not opts.bed:
        pass          # only --pd/score output requested: skip decoding
    elif opts.maxPost:
        if dists is not None:
            # --pd already computed the exact posteriors; the maxPost
            # path is their argmax — skip the second full pass
            paths = [
                np.argmax(d, axis=-1).astype(np.int32) for d in dists
            ]
        elif opts.exact:
            from tehmm_tpu.parallel.stitch import posterior_exact

            paths = posterior_exact(
                model.params, seg_tables, chunk_len=opts.chunk,
                gauss_params=model.gauss, weight_arrays=weights,
            )
        else:
            paths = model.posterior_decode_tables(
                seg_tables, chunk_len=opts.chunk, halo=opts.halo,
                weight_arrays=weights,
            )
    elif opts.exact:
        # --segment previously ignored --exact and silently used the
        # heuristic stitcher; honor the unconditional-guarantee request
        from tehmm_tpu.parallel.stitch import viterbi_exact

        paths = viterbi_exact(
            model.params, seg_tables, chunk_len=opts.chunk,
            gauss_params=model.gauss, weight_arrays=weights,
        )
    else:
        paths, report = viterbi_chunked(
            model.params, seg_tables, chunk_len=opts.chunk,
            halo=opts.halo, weight_arrays=weights,
            gauss_params=model.gauss,
        )
        logger.info(
            "segment decode: %d chunks, boundaries ok=%s",
            report.n_chunks, report.boundaries_ok,
        )
    if dists is not None:
        rows = []
        for tab, pd in zip(seg_tables, dists):
            for i in range(len(tab)):
                probs = ",".join(f"{p:.6g}" for p in pd[i])
                rows.append((
                    tab.chrom,
                    int(tab.seg_bounds[i]),
                    int(tab.seg_bounds[i + 1]),
                    probs,
                ))
        write_bed_intervals(rows, opts.pd)
    if opts.bed:
        out = []
        for tab, path in zip(seg_tables, paths):
            out.extend(expand_path(tab, path, model.state_names))
        write_bed_intervals(out, opts.bed)
        logger.info("wrote %d intervals to %s", len(out), opts.bed)
    # printed score: same semantics as base-resolution eval (main) —
    # Viterbi decodes print the PATH's joint log-prob (reference:
    # hmm.decode's logprob), posterior/score-only modes print the
    # forward log-likelihood.  (Previously this always printed the
    # forward total, so --segment runs were incommensurable with
    # base-resolution runs under the same flags.)
    if viterbi_like and paths is not None:
        from tehmm_tpu.models.hmm import path_log_score

        total = sum(
            path_log_score(
                model.params, tab.symbols, p,
                gauss=model.gauss, values=tab.values,
                obs_weights=None if weights is None else weights[i],
            )
            for i, (tab, p) in enumerate(zip(seg_tables, paths))
        )
    else:
        import jax.numpy as jnp

        from tehmm_tpu.models.emission import track_log_likelihoods
        from tehmm_tpu.ops import dp as _dp

        total = 0.0
        for i, tab in enumerate(seg_tables):
            obs = track_log_likelihoods(
                model.params.log_em, jnp.asarray(tab.symbols[None])
            )
            if model.gauss is not None and tab.values is not None:
                from tehmm_tpu.models.gauss import gauss_log_likelihoods

                obs = obs + gauss_log_likelihoods(
                    model.gauss, jnp.asarray(tab.values[None])
                )
            if weights is not None:
                obs = obs * jnp.asarray(weights[i])[None, :, None]
            _, _, ll = _dp.forward_scaled(
                model.params.log_start, model.params.log_trans, obs
            )
            total += float(ll[0])
    print(f"{total}")
    return 0


def _cfg_decode(model, cfg_meta, tables, max_span=None,
                max_post=False, halo=128, mesh_size=0):
    """Pair-grammar decode (reference: teHmmEval on a --cfg model).
    Tables longer than the chart budget (``max_span``, from the model's
    training meta or --maxSpan) decode via halo-stitched CYK windows
    (models/cfg.cfg_viterbi_decode_chunked).  With ``max_post`` the path
    is the argmax of the inside-outside posterior instead of the CYK
    Viterbi parse (models/cfg_em.cfg_posterior_decode) and the per-table
    gammas are returned for --pd.

    Returns (paths, gammas) — gammas is None unless max_post."""
    import jax.numpy as jnp
    import numpy as np

    from tehmm_tpu.models.cfg import (
        cfg_viterbi_decode_chunked, make_cfg_params,
    )
    from tehmm_tpu.models.cfg_em import cfg_posterior_decode
    from tehmm_tpu.models.emission import track_log_likelihoods

    pair_idx = [
        model.state_index(n) for n in cfg_meta.get("pair_states", [])
    ]
    log_match = cfg_meta.get("log_match")
    sa_prior = cfg_meta.get("sa_prior")
    cfg = make_cfg_params(
        model.params, pair_idx,
        float(cfg_meta.get("match_bonus", 0.0)),
        log_match=None if log_match is None
        else np.asarray(log_match, np.float32),
        sa_prior=None if sa_prior is None else float(sa_prior),
    )
    if max_span is None:
        max_span = int(cfg_meta.get("max_span", 4096))
    mesh = None
    if mesh_size:
        from tehmm_tpu.parallel import make_data_mesh

        mesh = make_data_mesh(mesh_size)
    paths = []
    gammas = [] if max_post else None
    for tab in tables:
        sym = jnp.asarray(tab.symbols)
        obs = track_log_likelihoods(model.params.log_em, sym)
        if model.gauss is not None and tab.values is not None:
            from tehmm_tpu.models.gauss import gauss_log_likelihoods

            # gaussian tracks contribute to the unary terms only: their
            # symbol columns are constant-missing, so pair matching is
            # untouched (models/gauss.py)
            obs = obs + gauss_log_likelihoods(
                model.gauss, jnp.asarray(tab.values)
            )
        if max_post:
            path, gamma = cfg_posterior_decode(
                cfg, obs, sym, max_span, halo=halo, mesh=mesh
            )
            gammas.append(gamma)
        else:
            path, _score = cfg_viterbi_decode_chunked(
                cfg, obs, sym, max_span, mesh=mesh
            )
        paths.append(path)
    return paths, gammas


if __name__ == "__main__":
    sys.exit(main())
