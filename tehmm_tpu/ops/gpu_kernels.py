"""GPU kernels for the HMM time recurrences (Pallas, Triton route).

The scaled forward, scaled backward and Viterbi recurrences of ops/dp.py
are chains of L dependent steps.  Each step is a ``[B,S] @ [S,S]``
product (or its max-plus analogue) plus exp/log/max/mask on a few hundred
kilobytes.  XLA compiles a ``lax.scan`` into a device-side loop that
launches several small kernels per step, so at the shapes this program
runs the launch chain, not arithmetic or memory traffic, is the cost.

Each kernel here runs the whole time loop inside one program per tile of
``Bt`` batch rows:

* the carry (``alpha_hat``, ``beta_hat`` or the Viterbi scores) stays in
  registers for all L steps;
* the transition matrix (``exp(log_trans)`` or ``log_trans``) is loaded
  once per program;
* observations arrive time-major ``[L, B, Sp]``, so one step's tile is
  contiguous;
* the Viterbi kernel writes int8/int16 back-pointers and runs the
  backtrace in the same program, so no XLA scan remains.

Everything around the recurrences (observation log-likelihoods, the E-step
contractions, the maxPost argmax) stays in XLA.  The wrappers take and
return exactly what ``dp.forward_scaled`` / ``dp.backward_scaled`` /
``dp.viterbi`` take and return.

Padding: S is padded to a power of two (>= 16, the Triton dot's minimum).
Padded states carry ``LOG_ZERO`` observations, start and transition
entries, so they never win a max and add exact zeros to every sum.  Rows
are padded to a multiple of ``Bt`` with length 0.

Numerics: the per-step product is full float32 (``Precision.HIGHEST``
lowers to Triton's IEEE input precision, not TF32).  The max-plus step
performs dp._maxplus_step's adds in the same order and breaks argmax ties
to the lowest index, so Viterbi paths are identical to ``dp.viterbi``.

``select_engine`` is the one place that decides between these kernels
and the XLA scans.  Measurements and the envelope: PERF.md, "Kernel
decisions on the H100".
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from tehmm_tpu.ops import dp
from tehmm_tpu.utils.common import LOG_ZERO

# Largest state count at which each kernel compiles and beats the XLA scan
# end to end on the H100 (PERF.md "Kernel decisions on the H100"); beyond
# it the selector returns the XLA path.  At S=128 (Sp=128) the forward
# kernel ran 163 ms against XLA's 14 ms, so the forward/backward pair
# stops at Sp=64; the max-plus kernel still won at Sp=128.
MAX_STATES = {"estep": 64, "viterbi": 128}

# Max-plus tile budget: elements of the [Bt, Sp, Sp] block a Viterbi
# step holds in registers.
VITERBI_TILE_ELEMS = 8192

_ENGINES = ("auto", "xla", "kernel")


def select_engine(kind: str, num_states: int, engine: str = "auto",
                  interpret: bool = False) -> str:
    """Resolve which implementation runs a recurrence: ``"kernel"`` or
    ``"xla"``.

    ``kind`` is ``"estep"`` (forward + backward: the E-step and the
    maxPost decode) or ``"viterbi"``.  ``"auto"`` picks the kernel only
    on a GPU backend and only inside its measured state envelope.  An
    explicit ``"kernel"`` off the GPU raises unless ``interpret`` asks
    for the Pallas interpreter (tests): nothing falls back silently.
    """
    if kind not in MAX_STATES:
        raise ValueError(f"unknown recurrence kind {kind!r}")
    if engine not in _ENGINES:
        raise ValueError(
            f"unknown engine {engine!r} (expected one of {_ENGINES})"
        )
    on_gpu = jax.default_backend() == "gpu"
    if engine == "auto":
        return (
            "kernel" if on_gpu and num_states <= MAX_STATES[kind]
            else "xla"
        )
    if engine == "kernel" and not on_gpu and not interpret:
        raise ValueError(
            "engine='kernel' needs a GPU backend (found "
            f"{jax.default_backend()!r}); pass interpret=True to run the "
            "Pallas interpreter"
        )
    return engine


def padded_states(num_states: int) -> int:
    """State axis width inside the kernels: a power of two >= 16."""
    return max(16, 1 << (num_states - 1).bit_length())


def block_rows(kind: str, sp: int) -> int:
    """Batch rows per program.  The forward/backward step is a Triton dot
    whose row count must be >= 16; the max-plus step materializes a
    ``[Bt, Sp, Sp]`` block in registers, so its tile shrinks with Sp."""
    if kind == "estep":
        return 16
    return max(1, min(16, VITERBI_TILE_ELEMS // (sp * sp)))


def _renorm(x):
    m = jnp.maximum(jnp.max(x, axis=-1), LOG_ZERO)
    return x - m[:, None], m


def _time_major(obs, sp, bp):
    """[B, L, S] -> [L, Bp, Sp], padding states and rows with LOG_ZERO."""
    B, _L, S = obs.shape
    x = jnp.moveaxis(obs.astype(jnp.float32), 1, 0)
    return jnp.pad(
        x, ((0, 0), (0, bp - B), (0, sp - S)), constant_values=LOG_ZERO
    )


def _pad_vec(v, n, fill):
    return jnp.pad(v, (0, n - v.shape[0]), constant_values=fill)


def _pad_mat(m, n, fill):
    return jnp.pad(
        m, ((0, n - m.shape[0]), (0, n - m.shape[1])), constant_values=fill
    )


def _call(kernel, grid, outs, args, interpret, name):
    """Run ``kernel`` over ``grid`` on ``args``; ``outs`` lists the
    (shape, dtype) of each output.  Inside ``shard_map`` the caller sets
    ``check_vma=False`` (parallel/em_sharded.py): ``pallas_call`` does
    not type its outputs' variance over mesh axes."""
    return pl.pallas_call(
        kernel,
        grid=grid,
        out_shape=tuple(jax.ShapeDtypeStruct(shape, dtype)
                        for shape, dtype in outs),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name=name,
    )(*args)


def _fwd_kernel(ls_ref, texp_ref, obs_ref, len_ref, ahat_ref, dm_ref, *,
                L, bt):
    rows = pl.ds(pl.program_id(0) * bt, bt)
    lens = len_ref[rows]
    texp = texp_ref[...]
    a0 = ls_ref[...][None, :] + obs_ref[0, rows, :]
    a0 = jnp.where((lens > 0)[:, None], a0, LOG_ZERO)
    a_hat, c0 = _renorm(a0)
    ahat_ref[0, rows, :] = a_hat
    dm_ref[0, rows] = c0

    def step(t, a_hat):
        s = jnp.dot(
            jnp.exp(a_hat), texp, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        new = jnp.where(s > 0, jnp.log(s), LOG_ZERO) + obs_ref[t, rows, :]
        new_hat, dm = _renorm(new)
        valid = t < lens
        new_hat = jnp.where(valid[:, None], new_hat, a_hat)
        ahat_ref[t, rows, :] = new_hat
        dm_ref[t, rows] = jnp.where(valid, dm, 0.0)
        return new_hat

    jax.lax.fori_loop(1, L, step, a_hat)


def _bwd_kernel(texp_t_ref, obs_ref, len_ref, bhat_ref, dm_ref, *, L, bt):
    rows = pl.ds(pl.program_id(0) * bt, bt)
    lens = len_ref[rows]
    texp_t = texp_t_ref[...]
    b_last = jnp.zeros((bt, texp_t.shape[0]), jnp.float32)
    bhat_ref[L - 1, rows, :] = b_last
    dm_ref[L - 1, rows] = jnp.zeros((bt,), jnp.float32)

    def step(k, b_hat):
        t = L - 1 - k                       # position t+1 of dp._bwd_step
        x_hat, xm = _renorm(obs_ref[t, rows, :] + b_hat)
        s = jnp.dot(
            jnp.exp(x_hat), texp_t, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        new_hat, nm = _renorm(jnp.where(s > 0, jnp.log(s), LOG_ZERO))
        valid = t < lens
        new_hat = jnp.where(valid[:, None], new_hat, b_hat)
        bhat_ref[t - 1, rows, :] = new_hat
        dm_ref[t - 1, rows] = jnp.where(valid, xm + nm, 0.0)
        return new_hat

    jax.lax.fori_loop(0, L - 1, step, b_last)


def _viterbi_kernel(ls_ref, lt_ref, obs_ref, len_ref, path_ref, score_ref,
                    ptr_ref, *, L, bt, barrier):
    rows = pl.ds(pl.program_id(0) * bt, bt)
    lens = len_ref[rows]
    lt = lt_ref[...]
    sp = lt.shape[0]
    ids = jax.lax.broadcasted_iota(jnp.int32, (bt, sp), 1)
    v_hat, m = _renorm(ls_ref[...][None, :] + obs_ref[0, rows, :])

    def step(t, carry):
        v_hat, m = carry
        y = v_hat[:, :, None] + lt[None, :, :]
        best = jnp.max(y, axis=1)
        arg = jnp.argmax(y, axis=1).astype(jnp.int32)
        new_hat, dm = _renorm(best + obs_ref[t, rows, :])
        valid = t < lens
        # positions past a row's length point every state at itself, so
        # the backtrace carries the final state through them unchanged
        ptr_ref[t, rows, :] = jnp.where(
            valid[:, None], arg, ids
        ).astype(ptr_ref.dtype)
        new_hat = jnp.where(valid[:, None], new_hat, v_hat)
        return new_hat, jnp.where(valid, m + dm, m)

    v_fin, m = jax.lax.fori_loop(1, L, step, (v_hat, m))
    score_ref[rows] = jnp.where(lens > 0, jnp.max(v_fin, axis=-1) + m, 0.0)
    state = jnp.argmax(v_fin, axis=-1).astype(jnp.int32)
    if barrier:
        # back-pointers written by other threads of this program
        plt.debug_barrier()

    def back(k, state):
        t = L - 1 - k
        path_ref[t, rows] = state
        ptr = ptr_ref[t, rows, :].astype(jnp.int32)
        return jnp.sum(jnp.where(ids == state[:, None], ptr, 0), axis=1)

    state = jax.lax.fori_loop(0, L - 1, back, state)
    path_ref[0, rows] = state


def _geometry(kind, obs, lengths):
    B, L, S = obs.shape
    sp = padded_states(S)
    bt = block_rows(kind, sp)
    bp = -(-B // bt) * bt
    lengths = jnp.full((B,), L, jnp.int32) if lengths is None \
        else lengths.astype(jnp.int32)
    lens = _pad_vec(lengths, bp, 0)
    return B, L, S, sp, bt, bp, lengths, lens


@partial(jax.jit, static_argnames=("interpret",))
def forward_scaled(log_start, log_trans, obs, lengths=None, *,
                   interpret=False):
    """Kernel twin of ``dp.forward_scaled``: returns
    (alpha_hat[B,L,S], log_c[B,L], loglik[B])."""
    B, L, S, sp, bt, bp, lengths, lens = _geometry("estep", obs, lengths)
    texp = _pad_mat(jnp.exp(log_trans), sp, 0.0)
    ahat, incs = _call(
        partial(_fwd_kernel, L=L, bt=bt), (bp // bt,),
        [((L, bp, sp), jnp.float32), ((L, bp), jnp.float32)],
        (_pad_vec(log_start, sp, LOG_ZERO), texp,
         _time_major(obs, sp, bp), lens),
        interpret, "hmm_forward_scaled",
    )
    ahat, incs = ahat[:, :B, :S], incs[:, :B]
    log_c = jnp.cumsum(incs, axis=0)
    loglik = (
        jnp.log(jnp.sum(jnp.exp(ahat[-1]), axis=-1)) + jnp.sum(incs, axis=0)
    )
    loglik = jnp.where(lengths > 0, loglik, 0.0)
    return jnp.moveaxis(ahat, 0, 1), jnp.moveaxis(log_c, 0, 1), loglik


@partial(jax.jit, static_argnames=("interpret",))
def backward_scaled(log_trans, obs, lengths=None, *, interpret=False):
    """Kernel twin of ``dp.backward_scaled``: returns
    (beta_hat[B,L,S], log_d[B,L])."""
    B, L, S, sp, bt, bp, lengths, lens = _geometry("estep", obs, lengths)
    texp_t = _pad_mat(jnp.exp(log_trans).T, sp, 0.0)
    bhat, incs = _call(
        partial(_bwd_kernel, L=L, bt=bt), (bp // bt,),
        [((L, bp, sp), jnp.float32), ((L, bp), jnp.float32)],
        (texp_t, _time_major(obs, sp, bp), lens),
        interpret, "hmm_backward_scaled",
    )
    bhat, incs = bhat[:, :B, :S], incs[:, :B]
    log_d = jnp.cumsum(incs[::-1], axis=0)[::-1]
    return jnp.moveaxis(bhat, 0, 1), jnp.moveaxis(log_d, 0, 1)


@partial(jax.jit, static_argnames=("interpret",))
def viterbi(log_start, log_trans, obs, lengths=None, *, interpret=False):
    """Kernel twin of ``dp.viterbi``: returns (path int32[B,L],
    score f32[B]), paths identical to the XLA decoder's."""
    B, L, S, sp, bt, bp, lengths, lens = _geometry("viterbi", obs, lengths)
    if L == 1:
        # no transitions: nothing for the loop to do (and dp takes the
        # argmax of the un-normalized scores here)
        return dp.viterbi(log_start, log_trans, obs, lengths)
    ptr_dtype = jnp.int8 if sp <= 128 else jnp.int16
    path, score, _ = _call(
        partial(_viterbi_kernel, L=L, bt=bt, barrier=not interpret),
        (bp // bt,),
        [((L, bp), jnp.int32), ((bp,), jnp.float32),
         ((L, bp, sp), ptr_dtype)],
        (_pad_vec(log_start, sp, LOG_ZERO),
         _pad_mat(log_trans.astype(jnp.float32), sp, LOG_ZERO),
         _time_major(obs, sp, bp), lens),
        interpret, "hmm_viterbi",
    )
    path = jnp.where((lengths > 0)[:, None], path[:, :B].T, 0)
    return path, score[:B]
