"""The data × ray plan on ``torch.distributed`` (port of ``avr_tpu/parallel/mesh.py``).

JAX lays a 2-D device mesh ('data', 'ray') under one program and lets GSPMD
insert the collectives. Here every rank is a process with one device, and
the plan writes the collectives out. Rank r sits at (data r // n_ray,
ray r % n_ray), as JAX's grid ``devices.reshape(n_data, n_ray)`` does:

  * the batch: every rank holds the same global batch (the samplers share
    their seed) and renders its rows, ``shard_batch``;
  * the rays: every rank draws the same [R, 3] directions, pads R to a
    multiple of ``n_ray`` with zero-weight copies of the first ray (JAX's
    ``pad_rays``, avr_tpu/train/state.py:196-216) and renders its slice,
    ``shard_rays``;
  * the prediction: ``assemble_prediction`` writes the rank's partial ray
    sum into its rows of a zero [bs, F, 2] buffer and all-reduces it over
    the world, which sums the rays and gathers the rows at once. Its
    backward returns the rank's rows of the incoming gradient and runs no
    collective: every rank evaluates the same criterion on the same global
    prediction, so that gradient is already the same on every rank;
  * the parameter gradients: each rank's are its share of the global
    loss's, so ``all_reduce_sum`` SUMS them (never averages), in a few flat
    buckets;
  * the state: ``broadcast`` copies rank 0's tensors onto every rank (the
    trainer's ``broadcast_state``, in place of JAX's ``shard_state``). After
    that the optimizer runs on every rank on the same bytes, so the
    replicated state stays bit-identical.

Every collective is an ``all_reduce``, a ``broadcast`` or a ``barrier``:
gloo implements those three for CUDA tensors (not ``all_gather``), so one
code path serves NCCL and gloo, also several gloo ranks on one card. No
collective runs inside the renderer's checkpointed chunks, whose
recomputation would run it again.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from avr_torch.device import resolve_device

# Flat buffers of the gradient all-reduce and the state broadcast.
BUCKET_BYTES = 1 << 27
# What torchrun sets for every rank, all needed to join the process group.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class MeshPlan:
    """A rank's place in the (data, ray) grid of the world."""

    n_data: int
    n_ray: int
    rank: int

    @property
    def data_index(self) -> int:
        return self.rank // self.n_ray

    @property
    def ray_index(self) -> int:
        return self.rank % self.n_ray

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size``."""
        if batch_size % self.n_data:
            raise ValueError(f"batch of {batch_size} rows does not split over data={self.n_data}")
        per = batch_size // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def shard_batch(self, batch):
        """This rank's rows of every tensor of a global batch."""
        rows = self.rows(batch["pos_rx"].shape[0])
        return {k: v[rows] for k, v in batch.items()}

    def shard_rays(self, dirs: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """This rank's slice of the directions [R, 3], R padded to a multiple
        of ``n_ray`` with copies of the first ray, and the slice's ray weights
        (0 on the padding; None where R needed no padding)."""
        if self.n_ray == 1:
            return dirs, None
        R = dirs.shape[0]
        pad = (-R) % self.n_ray
        per = (R + pad) // self.n_ray
        part = slice(self.ray_index * per, (self.ray_index + 1) * per)
        if pad == 0:
            return dirs[part], None
        dirs = torch.cat([dirs, dirs[:1].expand(pad, 3)])
        weights = torch.cat([dirs.new_ones(R), dirs.new_zeros(pad)])
        return dirs[part], weights[part]


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise sums of ``tensors`` over the world (new tensors of the
    same shapes), all-reduced in flat buckets of at most BUCKET_BYTES."""
    return _bucketed(tensors, lambda buf: dist.all_reduce(buf, op=dist.ReduceOp.SUM))


def broadcast(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Rank 0's ``tensors`` on every rank (new tensors of the same shapes),
    broadcast in flat buckets of at most BUCKET_BYTES."""
    return _bucketed(tensors, lambda buf: dist.broadcast(buf, src=0))


def _bucketed(tensors: Sequence[torch.Tensor], collective) -> List[torch.Tensor]:
    """Run ``collective`` in place on flat buffers that hold ``tensors``
    (grouped by dtype and device, each buffer at most BUCKET_BYTES unless one
    tensor is larger) and return the results in the tensors' shapes."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        bucket, size = [], 0
        for i in idx + [None]:
            nbytes = 0 if i is None else tensors[i].numel() * tensors[i].element_size()
            if bucket and (i is None or size + nbytes > BUCKET_BYTES):
                buf = torch.cat([tensors[j].reshape(-1) for j in bucket])
                collective(buf)
                start = 0
                for j in bucket:
                    n = tensors[j].numel()
                    out[j] = buf[start:start + n].view(tensors[j].shape)
                    start += n
                bucket, size = [], 0
            if i is not None:
                bucket.append(i)
                size += nbytes
    return out


class _AssemblePrediction(torch.autograd.Function):
    """Partial ray sums of a rank's rows → the global prediction (see the
    module docstring): forward one all-reduce, backward none."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, rows: slice, batch_size: int) -> torch.Tensor:
        out = local.new_zeros((batch_size, *local.shape[1:]))
        out[rows] = local
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        ctx.rows = rows
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[ctx.rows], None, None


def assemble_prediction(local: torch.Tensor, plan: MeshPlan, batch_size: int) -> torch.Tensor:
    """The global prediction [batch_size, ...] from every rank's partial sum
    over its rays of its rows ``local`` [batch_size / n_data, ...]."""
    return _AssemblePrediction.apply(local, plan.rows(batch_size), batch_size)


def make_mesh_plan(
    world: Optional[int] = None,
    batch_size: Optional[int] = None,
    data_parallel: Optional[int] = None,
    rank: Optional[int] = None,
) -> MeshPlan:
    """Factor the world into (data, ray) axes, as JAX's ``make_mesh_plan``.

    By default the data axis gets the largest power of two that divides both
    the world size and the batch size, and the rest goes to rays. ``world``
    and ``rank`` default to the initialised process group's.
    """
    if world is None or rank is None:
        if not dist.is_initialized():
            raise RuntimeError("make_mesh_plan: no process group; pass world and rank, or join one first")
        world = dist.get_world_size() if world is None else world
        rank = dist.get_rank() if rank is None else rank
    if data_parallel is None:
        data_parallel = 1
        if batch_size:
            while (
                data_parallel * 2 <= world
                and world % (data_parallel * 2) == 0
                and batch_size % (data_parallel * 2) == 0
            ):
                data_parallel *= 2
    if world % data_parallel:
        raise ValueError(f"{world} ranks not divisible by data_parallel={data_parallel}")
    return MeshPlan(n_data=data_parallel, n_ray=world // data_parallel, rank=rank)


def initialize_multihost(device="cuda", backend: Optional[str] = None) -> torch.device:
    """Join the process group from the torchrun environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this rank's device. An incomplete environment raises: unlike
    JAX's single-host fallback, it is a misconfigured launch here.

    ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on the CPU. Under
    NCCL each rank owns the device ``cuda:{LOCAL_RANK}`` and ``device`` may
    name no other. Gloo on CUDA lets several ranks share a device: a bare
    ``cuda`` deals the local ranks round the host's devices,
    ``cuda:{LOCAL_RANK % device_count}`` (all on ``cuda:0`` with one card),
    and ``cuda:i`` is taken as given.
    """
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"initialize_multihost: the torchrun environment lacks {missing}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        n_dev = torch.cuda.device_count()
        if backend == "gloo" and torch.device(device).index is None:
            dev = torch.device("cuda", local_rank % n_dev)
        if backend == "nccl" and (dev.index != local_rank or local_rank >= n_dev):
            raise RuntimeError(
                f"initialize_multihost: NCCL rank {rank} (local rank {local_rank}) needs its own "
                f"device cuda:{local_rank}, got {str(dev)!r} of {n_dev}; "
                "use --dist_backend gloo to share a device"
            )
        if dev.index >= n_dev:
            raise RuntimeError(f"initialize_multihost: rank {rank} asks for {str(dev)!r}, the host has {n_dev}")
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise RuntimeError(f"initialize_multihost: NCCL needs CUDA devices, got {str(dev)!r}")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return dev
