"""Device meshes for the sharded encode, and process groups for the device
trainer, over ``torch.distributed``.

The JAX package's ``data_mesh`` is a ``jax.sharding.Mesh`` with one
``data`` axis, and ``batch_sharding`` splits the leading (batch) axis over
it (``parallel/mesh.py``).  Here a mesh is an ordered tuple of
``torch.device``s in one process (:func:`data_mesh`), and a
:class:`BatchSharding` splits the rows of a batch into equal contiguous
blocks, one a device, in device order.  A device may appear more than
once: two blocks on one card then run on two streams.  The sharded encode
(``parallel/encode.py``) needs no collective.

The trainers shard the corpus over processes instead: each process of a
``torch.distributed`` group holds one card and a share of the corpus's
rows, and ``reduce_sum`` is the JAX ``psum``.  A process with no group is
a world of one.  Nothing is read from the network or the environment: the
caller gives the group its backend, address, size and rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = [
    "BatchSharding",
    "batch_sharding",
    "data_mesh",
    "initialize_distributed",
    "rank_and_world",
    "reduce_sum",
]


def _mesh_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def data_mesh(n_devices: int | None = None, devices=None) -> tuple[torch.device, ...]:
    """A one-axis mesh: the ordered devices a batch is split over.

    With no ``devices``, every card of this process (``cuda:0`` ...), or
    the first ``n_devices`` of them; raises when there is no card.  Else
    the devices given (``torch.device`` or strings, ``"cpu"`` included;
    ``"cuda"`` means ``cuda:0``), in their order, repeats allowed, and
    ``n_devices`` is not read, as in the JAX package."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for the mesh; pass devices=['cpu', ...] "
                "to split the batch on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    mesh = tuple(_mesh_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


@dataclass(frozen=True)
class BatchSharding:
    """The leading (batch) axis split over ``mesh``: equal contiguous row
    blocks, one a device, in device order (the JAX package's
    ``NamedSharding(mesh, PartitionSpec("data"))``)."""

    mesh: tuple

    @property
    def n_devices(self) -> int:
        return len(self.mesh)

    def blocks(self, n_rows: int) -> list[tuple[torch.device, slice]]:
        """(device, rows) of each block of a batch of ``n_rows`` rows, which
        must be a multiple of the devices."""
        n = self.n_devices
        if n_rows % n:
            raise ValueError(f"{n_rows} rows do not split into {n} equal blocks")
        size = n_rows // n
        return [(dev, slice(k * size, (k + 1) * size)) for k, dev in enumerate(self.mesh)]


def batch_sharding(mesh) -> BatchSharding:
    """Split the leading (batch) axis over the devices of ``mesh``."""
    return BatchSharding(tuple(_mesh_device(d) for d in mesh))


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
