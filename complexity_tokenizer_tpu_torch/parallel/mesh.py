"""Process groups for the device trainer, over ``torch.distributed``.

The JAX package shards the corpus over a ``jax.sharding.Mesh`` with a
``data`` axis and reduces with ``psum`` over it (``parallel/mesh.py``).
Here each process of a ``torch.distributed`` group holds one card and a
share of the corpus's rows, and ``reduce_sum`` is the ``psum``.  A process
with no group is a world of one.  Nothing is read from the network or the
environment: the caller gives the group its backend, address, size and
rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "rank_and_world", "reduce_sum"]


def initialize_distributed(backend: str, init_method: str, world_size: int, rank: int) -> None:
    """Join the process group (``"nccl"`` on cards, ``"gloo"`` on the CPU;
    ``init_method`` as ``"tcp://localhost:<port>"`` or ``"file://<path>"``).
    Does nothing when this process has joined one already."""
    if dist.is_available() and dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) with no process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over every process, in place (the JAX
    package's ``psum`` over the data axis); the tensor itself at world
    size 1."""
    if rank_and_world()[1] > 1:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor
