"""Run a function on a world of ranks, one process each.

:func:`run_ranks` is how the tests and ``chip_smoke.py`` make a world:

- the ``spawn`` start method (the caller may own threads, and may have
  imported JAX, so nothing is forked);
- a ``FileStore`` in a fresh temporary directory as the meeting point (no
  port is opened, so parallel test workers cannot collide);
- ``torch.set_num_threads(1)`` in every rank (the ranks share the host's
  cores);
- one deadline for the whole world: when it passes, or when any rank fails,
  every rank still running is killed and the call raises with the failed
  rank's traceback.

``fn(*args)`` runs in every rank once the process group is up; the ranks'
results come back in rank order (through ``torch.save`` files in the
temporary directory, so a result may hold tensors).

A user launches the trainer or the serving CLIs with ``torchrun`` instead;
:func:`launched_world` and :func:`init_world` are how those entry points
join the world it launched.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch


def _rank_main(fn: Callable, args: tuple, rank: int, world: int, backend: str, store_path: str, out_dir: str,
               threads: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world)
        try:
            result = fn(*args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:  # noqa: BLE001 — reported to the parent, then the rank exits non-zero
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world: int, *args, timeout: float = 120.0, backend: str = "gloo",
              threads: int = 1) -> List[Any]:
    """``fn(*args)`` in ``world`` spawned ranks of one process group; returns
    their results in rank order.  ``fn`` and ``args`` must pickle (a
    module-level function)."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="omchat_ranks_")
    procs = []
    try:
        for rank in range(world):
            p = ctx.Process(target=_rank_main, name=f"rank{rank}",
                            args=(fn, args, rank, world, backend, os.path.join(tmp, "store"), tmp, threads))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout
        while any(p.exitcode is None for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                time.sleep(1.0)  # the others' tracebacks: the first to exit may be one that lost its peer
                _raise_failed(procs, tmp)
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world} ranks ran past its {timeout:.0f} s deadline "
                                   f"(ranks still running: {[r for r, p in enumerate(procs) if p.exitcode is None]})")
            time.sleep(0.02)
        _raise_failed(procs, tmp)
        import torch

        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def _raise_failed(procs, tmp: str) -> None:
    """Raise with the traceback of every rank that has failed so far."""
    failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
    if failed:
        texts = "\n".join(f"--- rank {r} (exit code {procs[r].exitcode}):\n{_error_text(tmp, r)}" for r in failed)
        raise RuntimeError(f"ranks {failed} of {len(procs)} failed:\n{texts}")


def _error_text(tmp: str, rank: int) -> str:
    path = os.path.join(tmp, f"rank{rank}.err")
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return "(no traceback: the process died before it could write one)"


def launched_world() -> int:
    """The world size of a launched run: the live process group's, or
    ``torchrun``'s ``WORLD_SIZE``; 1 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_world(device: torch.device, logger, timeout: Optional[datetime.timedelta] = None) -> tuple:
    """Join the launched world: (this rank's device, whether this call
    created the process group).  Each rank takes
    ``cuda:LOCAL_RANK`` over NCCL when every local rank has a card, else
    ``cuda:0`` shared over gloo; the CPU takes gloo.  ``timeout``: the
    collectives' (torch's default without it)."""
    import torch.distributed as dist

    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if device.type == "cuda":
        own = torch.cuda.device_count() >= local_world
        device = torch.device("cuda", local_rank if own else 0)
        torch.cuda.set_device(device)
        backend = "nccl" if own else "gloo"
    else:
        backend = "gloo"
    created = not dist.is_initialized()
    if created:
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        backend = dist.get_backend()
    logger.info(f"rank {dist.get_rank()} of {dist.get_world_size()}: device {device}, backend {backend}")
    return device, created
