"""The process group of multi-card training and evaluation.

One process a card, started by ``torchrun`` or given the JAX tools'
``--coordinator host:port --num-processes N --process-id i``; NCCL where
the ranks run on CUDA devices, gloo on the CPU. The train step reduces
over the group explicitly, after its one backward (``train/step.py``):
the JAX step's loss divides by the global positive count, known only
after every rank's forwards, so torch's ``DistributedDataParallel``,
which reduces inside the backward of each forward, does not fit it.

Each function takes the group; without one (None) it is the identity,
so one process without a group runs the single-process code path.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device


@contextlib.contextmanager
def process_group(device="cuda", coordinator: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None
                  ) -> Iterator[Tuple[torch.device, Any]]:
    """Join the default process group; yield (this rank's device, the
    group) and leave the group on exit if this call created it.

    The rank and the world size come from ``coordinator`` (``host:port``
    of rank 0's store), ``num_processes`` and ``process_id`` where given,
    else from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT). A group a caller in the same process already
    initialized is used as it is. On CUDA a rank runs on
    ``cuda:LOCAL_RANK`` (the rank modulo the card count where LOCAL_RANK
    is not set) over NCCL, on the CPU over gloo; like
    ``device.resolve_device`` this raises where CUDA is asked for and
    absent."""
    dev = resolve_device(device)
    created = not dist.is_initialized()
    if created:
        if coordinator is not None:
            if num_processes is None or process_id is None:
                raise ValueError("--coordinator needs --num-processes and "
                                 "--process-id")
            init = dict(init_method=f"tcp://{coordinator}",
                        world_size=num_processes, rank=process_id)
            my_rank = process_id
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init = dict(init_method="env://")
            my_rank = int(os.environ["RANK"])
        else:
            raise RuntimeError(
                "--distributed needs torchrun's environment (RANK, "
                "WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or --coordinator, "
                "--num-processes and --process-id")
    else:
        my_rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", my_rank % torch.cuda.device_count())))
        torch.cuda.set_device(dev)
    if created:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                **init)
    try:
        yield dev, dist.group.WORLD
    finally:
        if created:
            dist.destroy_process_group()


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 without one)."""
    return 0 if group is None else dist.get_rank(group)


def world(group=None) -> int:
    """The ranks in ``group`` (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def barrier(group=None) -> None:
    """Wait for every rank of ``group``."""
    if group is not None:
        dist.barrier(group)


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks of ``group``, in
    place: the tensors of a dtype are copied into one flat buffer in the
    order given (the same on every rank), summed by one all-reduce and
    divided by the world size, so every rank gets the same bits."""
    if group is None:
        return
    n = dist.get_world_size(group)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= n
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def gather_to_rank0(obj, group=None) -> Optional[List]:
    """Every rank's picklable ``obj``, in rank order, on rank 0 (None on
    the others); ``[obj]`` without a group."""
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group) if rank(group) == 0 else None
    dist.gather_object(obj, out, dst=0, group=group)
    return out
