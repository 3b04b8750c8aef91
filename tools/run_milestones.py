"""Run the BASELINE.json milestone configurations end-to-end.

Configs (BASELINE.json):
  1. 2-state / 1 binary track, small chunk — CPU-runnable parity
  2. 10-state / 5 tracks, supervised Viterbi decode of one chromosome
  3. 20-state unsupervised EM to convergence, single chip
  4. 40-state / 15 tracks, chunked decode + EM psum across 8 devices
     (virtual CPU mesh without cards; real GPUs where present)
  5. 64-state / 20 tracks, multi-host — dry-run compiled via
     __graft_entry__.dryrun_multichip (no pod in this environment)

Emits a JSON summary and a markdown table on stdout.

Run:  python tools/run_milestones.py [--out milestones.json]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _planted_dataset(rng, n_states, n_tracks, alphabet, length):
    """Sticky planted HMM data with recoverable structure."""
    true = np.zeros(length, np.int64)
    s = 0
    jumps = rng.rand(length) < 0.02
    draws = rng.randint(0, n_states, length)
    for i in range(length):
        if jumps[i]:
            s = draws[i]
        true[i] = s
    sym = np.zeros((length, n_tracks), np.uint8)
    # per-track coprime moduli so the track-symbol VECTOR identifies the
    # state (a single shared modulus aliases states s and s+m)
    moduli = [7, 5, 3, 7, 5, 3, 7, 5][: n_tracks]
    for t in range(n_tracks):
        m = min(moduli[t % len(moduli)], alphabet - 1)
        correct = (true % m) + 1
        noise = rng.randint(1, alphabet, length)
        take = rng.rand(length) < 0.7
        sym[:, t] = np.where(take, correct, noise)
    return sym, true


def config1():
    """2-state, 1 track, bit parity vs the float64 oracle (runs on the
    default backend — CPU and GPU must both reproduce the oracle)."""
    import jax.numpy as jnp

    from tehmm_tpu import oracle
    from tehmm_tpu.models.emission import track_log_likelihoods
    from tehmm_tpu.models.params import HmmParams
    from tehmm_tpu.ops import dp

    rng = np.random.RandomState(0)
    L = 5000
    log_start = np.log([0.6, 0.4])
    log_trans = np.log([[0.97, 0.03], [0.05, 0.95]])
    log_em = np.zeros((2, 1, 3))
    log_em[:, 0, 1:] = np.log([[0.8, 0.2], [0.3, 0.7]])
    sym = rng.randint(1, 3, (L, 1))
    obs64 = oracle.obs_log_likelihoods(log_em, sym)
    want_path, _ = oracle.viterbi(log_start, log_trans, obs64)
    params = HmmParams(
        log_start=jnp.asarray(log_start, jnp.float32),
        log_trans=jnp.asarray(log_trans, jnp.float32),
        log_em=jnp.asarray(log_em, jnp.float32),
    )
    obs = track_log_likelihoods(params.log_em, jnp.asarray(sym))[None]
    t0 = time.perf_counter()
    path, _ = dp.viterbi(params.log_start, params.log_trans, obs)
    exact = bool((np.asarray(path[0]) == want_path).all())
    return {
        "name": "1: 2-state/1-track CPU parity",
        "bit_exact_vs_f64_oracle": exact,
        "positions": L,
        "seconds": round(time.perf_counter() - t0, 3),
        "ok": exact,
    }


def _device_configs(out):
    """Configs 2-4 on the default (accelerator) backend."""
    import jax
    import jax.numpy as jnp

    from tehmm_tpu.models.params import init_random
    from tehmm_tpu.models.emission import track_log_likelihoods
    from tehmm_tpu.ops import dp, em as em_ops

    dev = str(jax.devices()[0])
    rng = np.random.RandomState(1)

    # ---- config 2: 10 states, 5 tracks, supervised viterbi, 1 "chrom"
    S, T, V, N = 10, 5, 8, 4_194_304
    sym, true = _planted_dataset(rng, S, T, V, N)
    # supervised params through the PRODUCTION path (ops/em
    # supervised_train — the teHmmTrain --supervised recipe); a private
    # re-count here could drift from the shipped semantics
    from tehmm_tpu.ops.em import supervised_train

    params = supervised_train(
        S, [V] * T,
        jnp.asarray(sym[None]),
        jnp.asarray(true[None].astype(np.int32)),
    )
    B, L = 2048, 1024
    per = B * L
    n_pass = N // per
    t0 = time.perf_counter()
    correct = total = 0
    for p in range(n_pass):
        blk = jnp.asarray(sym[p * per : (p + 1) * per].reshape(B, L, T))
        obs = track_log_likelihoods(params.log_em, blk)
        paths, _ = dp.viterbi(
            params.log_start, params.log_trans, obs,
            jnp.full((B,), L, jnp.int32),
        )
        got = np.asarray(paths).ravel()
        want = true[p * per : (p + 1) * per]
        correct += int((got == want).sum())
        total += per
    dt = time.perf_counter() - t0
    acc = correct / total
    out.append({
        "name": f"2: 10-state/5-track supervised Viterbi "
                f"({total/1e6:.1f}M positions)",
        "device": dev,
        "positions_per_sec": round(total / dt, 0),
        "accuracy_vs_planted": round(acc, 4),
        "seconds": round(dt, 2),
        "ok": acc > 0.8,
    })

    # ---- config 3: 20-state unsupervised EM to convergence, 1 chip
    S3, T3, V3, N3 = 20, 5, 8, 4_000_000
    sym3, _ = _planted_dataset(rng, S3, T3, V3, N3)
    params3 = init_random(S3, [V3] * T3, seed=2)
    B3, L3 = 4096, N3 // 4096
    blk = jnp.asarray(sym3[: B3 * L3].reshape(B3, L3, T3))
    lens3 = jnp.full((B3,), L3, jnp.int32)
    sizes3 = jnp.asarray([V3] * T3)
    t0 = time.perf_counter()
    prev = None
    iters = 0
    lls = []
    for it in range(100):
        stats = em_ops.em_sufficient_stats(params3, blk, lens3)
        params3 = em_ops.em_m_step(stats, params3, sizes3)
        ll = float(stats.loglik)
        lls.append(ll)
        iters += 1
        if prev is not None and abs(ll - prev) < 1e-3 * abs(ll) * 0.01:
            break
        prev = ll
    dt = time.perf_counter() - t0
    monotone = all(
        b >= a - 1e-4 * abs(a) for a, b in zip(lls, lls[1:])
    )
    out.append({
        "name": "3: 20-state unsupervised EM to convergence (4M positions)",
        "device": dev,
        "iterations": iters,
        "em_iters_per_sec": round(iters / dt, 2),
        "positions_per_sec": round(iters * B3 * L3 / dt, 0),
        "monotone": monotone,
        "seconds": round(dt, 2),
        "ok": monotone,
    })
    return out


def config4and5():
    """8-device psum EM (virtual CPU mesh) + multi-host dry run."""
    import subprocess

    code = (
        "import os;"
        "os.environ['XLA_FLAGS']='--xla_force_host_platform_device_count=8';"
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import numpy as np, jax.numpy as jnp, time, json;"
        "from tehmm_tpu.models.params import init_random;"
        "from tehmm_tpu.parallel import make_data_mesh, sharded_em_step;"
        "from tehmm_tpu.parallel.stitch import viterbi_chunked;"
        "S,T,V=40,15,8; rng=np.random.RandomState(3);"
        "params=init_random(S,[V]*T,seed=3);"
        "sym=jnp.asarray(rng.randint(1,V,size=(64,512,T)));"
        "lens=jnp.full((64,),512,jnp.int32); mesh=make_data_mesh(8);"
        "sizes=jnp.asarray([V]*T); t0=time.time();"
        "p,ll=sharded_em_step(params,sym,lens,sizes,mesh);"
        "ll=float(ll);"
        "paths,rep=viterbi_chunked(params,"
        "[np.asarray(sym[0])],chunk_len=128,halo=32,rows_per_pass=4);"
        "print(json.dumps({'name':'4: 40-state/15-track psum EM + chunked "
        "decode (8 virtual devices)','loglik_finite':bool(np.isfinite(ll)),"
        "'decode_ok':bool(rep.boundaries_ok),'seconds':round(time.time()-t0,2),"
        "'ok':bool(np.isfinite(ll)) and bool(rep.boundaries_ok)}));"
        "import __graft_entry__ as g; t0=time.time();"
        "g.dryrun_multichip(8);"
        "print(json.dumps({'name':'5: 64-state multi-host path (dry-run, "
        "8 virtual devices)','seconds':round(time.time()-t0,2),'ok':True}))"
    )
    env = dict(os.environ)
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
    )
    rows = []
    for line in r.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            rows.append(json.loads(line))
    if r.returncode != 0:
        # a crash AFTER milestone 4's print must not drop milestone 5
        # silently and exit green
        rows.append({
            "name": f"4/5 (subprocess rc={r.returncode})", "ok": False,
            "error": r.stderr[-500:],
        })
    elif not rows:
        rows.append({"name": "4/5", "ok": False,
                     "error": r.stderr[-500:]})
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from tehmm_tpu.utils.platform import setup_jax

    setup_jax()
    results = []
    results.extend(config4and5())          # subprocess (CPU mesh)
    results.append(config1())              # forces CPU in-process? no —
    # config1 runs before device work would matter; platform already set
    _device_configs(results)

    print("\n| config | result | key metrics |")
    print("|---|---|---|")
    for r in results:
        status = "PASS" if r.get("ok") else "FAIL"
        metrics = ", ".join(
            f"{k}={v}" for k, v in r.items()
            if k not in ("name", "ok")
        )
        print(f"| {r['name']} | {status} | {metrics} |")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    sys.exit(0 if all(r.get("ok") for r in results) else 1)


if __name__ == "__main__":
    main()
