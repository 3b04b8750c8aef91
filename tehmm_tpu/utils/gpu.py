"""GPU host helpers that never touch JAX.

* ``card_info``: the card's name and power limit as ``nvidia-smi``
  reports them — printed beside every measurement, because a card set
  below its maximum power runs slower under load.
* ``visible_gpu_count`` / ``pin_worker``: one JAX process per card.  A
  JAX process reserves most of a card's memory when it first uses it,
  so process-pool workers each get a card of their own through
  ``CUDA_VISIBLE_DEVICES``, set before the worker imports JAX.
"""

from __future__ import annotations

import os
import subprocess

QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"]


def card_info() -> str:
    """``name, power.limit`` of every visible card (one per line), or
    ``"not available"`` where ``nvidia-smi`` cannot be run."""
    try:
        out = subprocess.run(
            QUERY, capture_output=True, text=True, timeout=30, check=True
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out or "not available"


def visible_gpu_count() -> int:
    """Number of cards this process may use, read without JAX:
    ``CUDA_VISIBLE_DEVICES`` when set, else ``nvidia-smi -L``."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return len([d for d in env.split(",") if d.strip()])
    try:
        out = subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True, text=True,
            timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


def worker_cards(num_workers: int, num_cards: int) -> list[str]:
    """Card id for each of ``num_workers`` pool workers: worker k gets
    card k.  More workers than cards would put two JAX processes on one
    card, where the second fails for want of memory — refused here."""
    if num_workers > num_cards:
        raise ValueError(
            f"--numProcesses {num_workers} exceeds the {num_cards} "
            "visible GPU(s): each worker needs a card of its own"
        )
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = (
        [d.strip() for d in visible.split(",") if d.strip()]
        if visible is not None else [str(k) for k in range(num_cards)]
    )
    return ids[:num_workers]


def pin_worker(card_queue) -> None:
    """Process-pool initializer: take the next card id from the queue
    and make it the only card this worker sees.  Runs before the worker
    imports JAX (spawn context)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = card_queue.get()


def pool_pinning(ctx, num_workers: int, platform: str | None) -> dict:
    """``ProcessPoolExecutor`` keyword arguments that give each worker a
    card of its own (``initializer``/``initargs``), or ``{}`` where the
    workers run on the CPU: a platform other than the GPU was forced,
    or no card is visible."""
    if platform and platform not in ("gpu", "cuda"):
        return {}
    n = visible_gpu_count()
    if n == 0:
        return {}
    queue = ctx.Queue()
    for card in worker_cards(num_workers, n):
        queue.put(card)
    return {"initializer": pin_worker, "initargs": (queue,)}
