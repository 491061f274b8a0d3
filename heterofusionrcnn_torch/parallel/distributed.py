"""Starting and joining the data-parallel group (PyTorch port of
heterofusionrcnn_tpu/parallel/distributed.py, the reference's MPI launch,
mpi_run_training.sh:16-19).

Each rank is one process driving one device: NCCL on the card, one rank a
card; gloo on the CPU (a caller may also name gloo on the card, where two
ranks can share one card). A run forms its group in one of two ways:

  - started by `torchrun --nproc_per_node N ...`, every rank reads its
    rank, world size and rendezvous from the environment torchrun sets
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
  - one command starts its N ranks itself (`spawn_ranks`), with a file
    rendezvous it makes.

The input pipeline is sharded by rank (`shard_dataset_for_host`): each rank
loads its own rows of every global batch from its own part of the samples.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from heterofusionrcnn_torch.parallel.mesh import rank_and_size

# A collective that waits longer than this fails instead of hanging: a dead
# rank fails the others. It covers a first step that builds the kernels.
COLLECTIVE_TIMEOUT_S = 300.0
# After one rank fails, the others get this long to exit on their own.
FAILURE_GRACE_S = 10.0


def initialize_distributed(rank: Optional[int] = None, world_size: Optional[int] = None,
                           init_method: Optional[str] = None, device: str = "cuda",
                           backend: Optional[str] = None) -> dict:
    """Joins the data-parallel group; a no-op at one process.

    Args:
      rank, world_size: this process's rank and the number of ranks;
        default: the environment's RANK and WORLD_SIZE (torchrun), else 0
        and 1.
      init_method: the rendezvous (`file://...` or `tcp://host:port`);
        default "env://" (MASTER_ADDR and MASTER_PORT).
      device: "cuda" or "cpu", the device each rank trains on.
      backend: default NCCL on "cuda" (the rank's card is LOCAL_RANK, else
        the rank, made the current device), gloo on "cpu".
    Returns:
      {"process_index", "process_count", "local_device_count",
       "global_device_count"} as the JAX function returns them, and
      "group": the process group, None at one process.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    group = None
    if world_size > 1:
        if dist.is_initialized():
            raise RuntimeError("a process group is already initialised in this process")
        backend = backend or ("nccl" if device == "cuda" else "gloo")
        device_id = None
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local)
            device_id = torch.device("cuda", local)
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
                                device_id=device_id)
        group = dist.group.WORLD
    return {
        "process_index": rank,
        "process_count": world_size,
        "local_device_count": 1,
        "global_device_count": world_size,
        "group": group,
    }


def shutdown_distributed() -> None:
    """Leaves the group this process joined, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_dataset_for_host(dataset, group: Optional[dist.ProcessGroup]) -> None:
    """Deterministic per-rank input sharding: rank r of W keeps samples
    r, r + W, ... (`KittiDataset.shard`); a no-op without a group."""
    rank, world = rank_and_size(group)
    if world > 1:
        dataset.shard(rank, world)


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (),
                timeout_s: Optional[float] = None,
                rendezvous_dir: Optional[str] = None) -> None:
    """Runs `fn(rank, world_size, init_method, *args)` in `world_size`
    processes started by `spawn` (each imports `fn`'s module afresh), the
    rendezvous a file store in `rendezvous_dir` (default: a temporary
    directory, removed after). Returns when every rank has returned.

    Raises the first failing rank's error with its traceback
    (`torch.multiprocessing.ProcessRaisedException`), or
    `ProcessExitedException` for a rank that exited with a code or a
    signal (`exit_code`); then, and after `timeout_s` (TimeoutError), every
    rank still running is stopped."""
    own_dir = rendezvous_dir is None
    rdzv = tempfile.mkdtemp(prefix="hfr_rendezvous_") if own_dir else rendezvous_dir
    init_method = "file://" + os.path.join(os.path.abspath(rdzv), "store")
    ctx = mp.start_processes(fn, args=(world_size, init_method, *args), nprocs=world_size,
                             join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while True:
            wait = 1.0 if deadline is None else max(0.0, min(1.0, deadline - time.monotonic()))
            if ctx.join(timeout=wait, grace_period=FAILURE_GRACE_S):
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks did not finish within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        if own_dir:
            shutil.rmtree(rdzv, ignore_errors=True)
