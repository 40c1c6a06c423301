"""Start the ranks of an SPMD run (no counterpart in the JAX package: one GSPMD controller
needs no launcher).

    results = spawn(fn, world, device="cpu", backend="gloo", args=(...))

runs fn(device, *args) in `world` processes, one rank each, every one in a process group
that a FileStore in a temporary directory rendezvouses (no TCP port, so concurrent runs
cannot collide), and returns the ranks' results in rank order. Rank r runs on
cuda:(r % device_count) for device "cuda" (ranks share cards when there are fewer cards than
ranks) and on the CPU, with one torch thread, for device "cpu".

The backend is the caller's choice and nothing changes it: NCCL needs a card per rank and
raises when there are fewer; gloo runs ranks that share a card or run on the CPU. Every
collective of this layer is a sum all_reduce or a broadcast, which both backends do on
CUDA tensors. The process group gets a timeout, so ranks that diverge fail instead of
hanging, and a rank that raises fails the whole run (torch.multiprocessing.spawn ends the
others and raises).

Under torchrun (RANK and WORLD_SIZE set) the process is one rank already: spawn
initialises the group from the environment, runs fn in this process and returns a list with
this rank's result at its index and None elsewhere.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from .._device import resolve_device

TIMEOUT_S = 600.0  # longest a rank waits in one collective


def _rank_device(device_type: str, rank: int) -> torch.device:
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    torch.set_num_threads(1)
    return torch.device("cpu")


def _check(world: int, device_type: str, backend: str) -> None:
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if device_type == "cpu" and backend == "nccl":
        raise ValueError("NCCL runs on cards only; use backend='gloo' on the CPU")
    if device_type == "cuda" and backend == "nccl" and torch.cuda.device_count() < world:
        raise ValueError(f"NCCL needs a card per rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards (gloo shares a card)")


def _run_rank(rank, fn, world, device_type, backend, store_dir, args):
    dev = _rank_device(device_type, rank)
    dist.init_process_group(backend, init_method=f"file://{store_dir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(dev, *args)
    finally:
        dist.destroy_process_group()
    tmp = Path(store_dir) / f"rank{rank}.tmp"
    tmp.write_bytes(pickle.dumps(out))
    os.replace(tmp, Path(store_dir) / f"rank{rank}.pkl")


def spawn(fn, world: int, *, device, backend: str, args=(), workdir=None):
    """Run fn(rank_device, *args) on `world` ranks and return their results in rank order.
    `fn` must be importable by name (a module-level function) and return something that
    pickles; it may use torch.distributed's default group, which every rank has joined.
    The FileStore and the ranks' result files go to a fresh temporary directory, or to the
    empty directory `workdir`."""
    device_type = resolve_device(device).type
    _check(world, device_type, backend)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} ranks, not {world}")
        dev = _rank_device(device_type, int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            results = [None] * world
            results[rank] = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        return results
    if device_type == "cuda":
        from .._build import load_kernels

        load_kernels()  # build once here; every rank then loads the same library
    with contextlib.ExitStack() as stack:
        store_dir = str(workdir) if workdir is not None else stack.enter_context(
            tempfile.TemporaryDirectory(prefix="mesheditor_spawn_"))
        torch.multiprocessing.spawn(
            _run_rank, args=(fn, world, device_type, backend, store_dir, tuple(args)),
            nprocs=world, join=True)
        return [pickle.loads((Path(store_dir) / f"rank{r}.pkl").read_bytes())
                for r in range(world)]
