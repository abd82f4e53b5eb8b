"""Process group set-up and the collectives of data-parallel training
(counterpart of `zeggs_tpu/parallel/distributed.py`).

Every process runs the same program over a shared filesystem. `initialize`
joins the group; without arguments it reads torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``)
when it is set, and is otherwise a no-op: one process, no group. The
backend is NCCL for a card and gloo for the CPU unless the caller names
one; it is never swapped for another. Collectives time out after
``DEFAULT_TIMEOUT_S`` instead of hanging.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

#: seconds a collective, or the wait at a barrier, may take before it fails;
#: rank 0 checkpoints and synthesises samples while the others wait
DEFAULT_TIMEOUT_S = 1800


def initialize(coordinator_address=None, num_processes=None, process_id=None, backend=None,
               device="cuda"):
    """Join the process group: ``coordinator_address`` ("host:port" of rank
    0), ``num_processes`` and ``process_id`` given together, or torchrun's
    environment, or neither (a no-op). ``backend`` defaults to "nccl" when
    ``device`` is a card and "gloo" on the CPU; with NCCL this process's
    card becomes the current device first. A group that already exists is
    kept. Returns whether this call made the group."""
    if dist.is_initialized():
        return False
    flags = (coordinator_address, num_processes, process_id)
    if all(f is None for f in flags):
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False  # one process
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif any(f is None for f in flags):
        raise ValueError("--coordinator-address, --num-processes and --process-id go together")
    else:
        init_method, world, rank = f"tcp://{coordinator_address}", int(num_processes), int(process_id)
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA device; none is available")
        torch.cuda.set_device(local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return True


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank(rank=None):
    """This process's index on its host: torchrun's ``LOCAL_RANK``, else its
    global rank (one host, or hosts of equal size with consecutive ranks)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index() if rank is None else rank


def process_device(device="cuda"):
    """The device of this process: "cuda" becomes its own card,
    ``cuda:(local_rank % device_count)``; an explicit index or the CPU is
    kept."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


def local_batch_slice(global_batch_size):
    """This process's [start, end) rows of the global batch."""
    per = global_batch_size // process_count()
    i = process_index()
    return i * per, (i + 1) * per


def host_shard(array_like):
    """This process's rows of a global batch held on the host."""
    s, e = local_batch_slice(len(array_like))
    return array_like[s:e]


def clip_shard(items):
    """A strided share of a work list (the corpus pipeline's clips)."""
    return list(items)[process_index() :: process_count()]


def barrier():
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _unflat(flat, tensors):
    o = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[o : o + n].view_as(t))
        o += n


@torch.no_grad()
def average_(tensors):
    """Replace each tensor by its mean over the processes, in place (one
    all-reduce over all of them, in float32)."""
    if process_count() == 1 or not tensors:
        return
    flat = _flat(tensors)
    dist.all_reduce(flat)
    flat /= process_count()
    _unflat(flat, tensors)


@torch.no_grad()
def make_replicated(tensors):
    """Broadcast rank 0's values of ``tensors`` (parameters, optimizer
    moments) to every process, in place, and raise on every process if any
    process held other values: every process must start from the same state
    (the same seed, or the same checkpoint)."""
    if process_count() == 1 or not tensors:
        return
    local = _flat(tensors)
    shared = local.clone()
    dist.broadcast(shared, src=0)
    differs = torch.tensor([float(not torch.equal(local, shared))], device=local.device)
    dist.all_reduce(differs, op=dist.ReduceOp.MAX)
    _unflat(shared, tensors)
    if differs.item():
        raise RuntimeError("the processes started from different parameters or optimizer state")
