"""Process groups, the device mesh and batch placement on torch.distributed.

Port of radarml_tpu/parallel/mesh.py. The JAX package runs one
controller over many devices and lets XLA insert the collectives; this
package runs one process per rank, as PyTorch does, and the call sites
that take `mesh=` issue the collectives themselves through the `Mesh`
below:

* `init_distributed` joins this process to the group (`tcp://` given an
  address, else `env://` as `python -m torch.distributed.run` sets it
  up) and picks the backend once, from the layout: NCCL where every rank
  owns a card, gloo on the CPU and where ranks share a card (NCCL refuses
  two ranks on one device). Rank r computes on `cuda:(local_rank %
  device_count)`, or on the CPU where the caller asks for it.
* `close_distributed` leaves the group: a barrier, so that no rank tears
  its connections down while a peer still uses them, then
  `destroy_process_group`, which joins the backend's threads before the
  interpreter exits. A rank program calls it at its end;
  `init_distributed` also registers it to run at exit, where it skips
  the barrier if the program is ending on an uncaught exception (its
  peers may never reach one).
* `make_mesh` arranges the group's ranks in a named
  `torch.distributed.device_mesh.DeviceMesh` ("data", optionally
  "model"). `make_mesh(1)`, or `make_mesh()` with no group, is a one-rank
  mesh on the caller's device whose collectives are identities; it
  starts no process group.
* A batch "sharded over data" is held as each rank's contiguous slice of
  it (`shard_batch`, `local_to_global`); `gather_batch` brings the
  slices back to every rank, in rank order. `replicate` broadcasts a
  tree of tensors from rank 0.

Where ranks share a card under gloo, each collective stages its tensors
through host memory: compute stays on the card, and this is the one
code path of that layout.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import sys
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from radarml_tpu_torch.core.device import resolve_device

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "all_reduce_sum",
    "batch_sharding",
    "check_mesh",
    "close_distributed",
    "gather_batch",
    "init_distributed",
    "local_mesh",
    "local_to_global",
    "make_mesh",
    "replicate",
    "replicated",
    "shard_batch",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

# This rank's device, as init_distributed chose it.
_LAYOUT: dict = {}


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
) -> None:
    """Join this process to the group; idempotent.

    With nothing given, the environment of `python -m
    torch.distributed.run` (MASTER_ADDR, WORLD_SIZE, RANK, LOCAL_RANK)
    describes the group; otherwise give rank 0's "host:port", the world
    size and this process's rank. `device="cpu"` computes on the CPU
    (gloo); the default is this rank's card, NCCL where each rank owns
    one and gloo where ranks share one.
    """
    if dist.is_initialized():
        return
    if coordinator_address is not None:
        addr = coordinator_address
        init = addr if "://" in addr else f"tcp://{addr}"
        world, rank = int(num_processes), int(process_id)
        local_rank, local_world = rank, world
    else:
        init, world, rank = "env://", None, None
        local_rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ.get("WORLD_SIZE", 1)))
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ranks run on the card by default; pass "
                "device='cpu' (--platform cpu) to run them on the CPU")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= n_cards else "gloo"
    kw = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(backend, init_method=init, **kw)
    _LAYOUT["device"] = dev
    if not _LAYOUT.get("at_exit"):
        atexit.register(_close_at_exit)
        _LAYOUT["at_exit"] = True


def close_distributed(barrier: bool = True) -> None:
    """Leave the group: wait for every rank (`barrier`), then destroy the
    process group. Idempotent; does nothing where no group exists."""
    if not dist.is_initialized():
        return
    if barrier:
        dist.barrier()
    dist.destroy_process_group()
    _LAYOUT.pop("device", None)


def _close_at_exit() -> None:
    # An uncaught exception has been printed by now (sys.last_value): a
    # barrier would wait for peers that may never come, so only destroy.
    close_distributed(barrier=getattr(sys, "last_value", None) is None)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named arrangement of ranks and this rank's place in it.

    `device_mesh` is None for the one-rank mesh, whose collectives are
    identities. Batches shard over the "data" axis: `data_rank` of
    `data_size` slices; ranks that differ only on other axes hold the
    same slice.
    """

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    backend: str  # "nccl", "gloo", or "local" for the one-rank mesh
    device_mesh: Any = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def rank(self) -> int:
        return 0 if self.device_mesh is None else dist.get_rank()

    @property
    def _data_dim(self) -> int:
        if DATA_AXIS not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {DATA_AXIS!r} axis")
        return self.axis_names.index(DATA_AXIS)

    @property
    def data_size(self) -> int:
        return self.shape[self._data_dim] if self.device_mesh is not None else 1

    @property
    def data_rank(self) -> int:
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_coordinate()[self._data_dim]

    def rows(self, n: int, what: str = "batch") -> slice:
        """This rank's contiguous slice of `n` rows sharded over data."""
        d = self.data_size
        if n % d:
            raise ValueError(f"a {what} of {n} rows is not divisible by the "
                             f"mesh's {d} data ranks")
        per = n // d
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def padded_rows(self, n: int) -> np.ndarray:
        """This rank's indices into `n` items sharded over data, the last
        item repeated up to a multiple of the data ranks (the caller drops
        the copies after gathering)."""
        per = -(-n // self.data_size)
        return np.minimum(np.arange(self.data_rank * per, (self.data_rank + 1) * per), n - 1)

    # -- collectives (identities on the one-rank mesh) ----------------------
    def _data_group(self):
        """The data axis's process group (the whole group on a 1-D mesh)."""
        if len(self.shape) > 1:
            return self.device_mesh.get_group(DATA_AXIS)
        return dist.group.WORLD

    def _staged(self, t: torch.Tensor, op) -> torch.Tensor:
        """Run `op` on `t` in place, through host memory where gloo serves a
        card; returns `t`."""
        if self.backend == "gloo" and t.device.type != "cpu":
            host = t.cpu()
            op(host)
            t.copy_(host)
        else:
            op(t)
        return t

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce `t` in place over the data axis."""
        if self.device_mesh is None:
            return t
        g = self._data_group()
        return self._staged(t, lambda x: dist.all_reduce(x, op=op, group=g))

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Overwrite `t` with the mesh's first rank's, in place."""
        if self.device_mesh is None:
            return t
        # a mesh of several ranks spans the whole group
        return self._staged(t, lambda x: dist.broadcast(x, src=0))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's `t`, concatenated on axis 0 in rank order."""
        if self.device_mesh is None:
            return t
        g = self._data_group()
        t = t.contiguous()
        staged = self.backend == "gloo" and t.device.type != "cpu"
        src = t.cpu() if staged else t
        parts = [torch.empty_like(src) for _ in range(self.data_size)]
        dist.all_gather(parts, src, group=g)
        return torch.cat(parts).to(t.device)


def check_mesh(mesh):
    """`mesh` itself where it is None or a Mesh; TypeError otherwise."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a radarml_tpu_torch.parallel.mesh.Mesh "
                        f"(from make_mesh), not {type(mesh).__name__}")
    return mesh


def local_mesh(mesh, device) -> Mesh:
    """`mesh` itself, or a one-rank mesh on `device` where it is None."""
    if check_mesh(mesh) is not None:
        return mesh
    return Mesh((1,), (DATA_AXIS,), torch.device(device), "local")


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    device: Optional[str] = None,
) -> Mesh:
    """A mesh over `n_devices` ranks (default: the whole group, or one
    rank where there is no group).

    With `shape`, ranks arrange row-major as (data, model, ...); missing
    axis names pad as axis{i}. A mesh of several ranks spans the whole
    group (one process per rank). One rank is a local mesh on `device`
    (default: this rank's device, or the card where there is no group).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, only {world} available")
    if shape is None:
        shape = (n_devices,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {shape} != {n_devices} devices")
    if len(axis_names) != len(shape):
        axis_names = tuple(axis_names) + tuple(
            f"axis{i}" for i in range(len(axis_names), len(shape)))
    axis_names = tuple(axis_names)
    if device is not None:
        dev = torch.device(device)
    elif dist.is_initialized():
        dev = _LAYOUT.get("device") or resolve_device(None)
    else:
        dev = resolve_device(None)
    if not dist.is_initialized() or (n_devices == 1 and world > 1):
        return Mesh(shape, axis_names, dev, "local")
    if n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} ranks needs a group of {n_devices} ranks, "
            f"not {world}: launch with python -m torch.distributed.run "
            f"--nproc-per-node {n_devices}")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)
    return Mesh(shape, axis_names, dev, dist.get_backend(), dm)


def _as_device_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return torch.as_tensor(a).to(device)


def _one_or_tuple(out: tuple):
    return out if len(out) > 1 else out[0]


def batch_sharding(mesh: Mesh):
    """The data-parallel placement: axis 0 split over "data", replicated
    over every other mesh axis (DTensor placements, one per mesh axis)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == DATA_AXIS else Replicate()
                 for name in mesh.axis_names)


def replicated(mesh: Mesh):
    """The replicated placement: every rank holds the whole tensor."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.axis_names)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's contiguous slice (axis 0) of each global array, on the
    mesh's device. Raises ValueError unless the rows divide evenly."""
    out = tuple(_as_device_tensor(a[mesh.rows(len(a))], mesh.device) for a in arrays)
    return _one_or_tuple(out)


def local_to_global(mesh: Mesh, *arrays):
    """Each rank passes its own contiguous slice of a global batch; the
    result is that slice on the mesh's device, the port's form of a
    batch sharded over "data". Every data rank must pass the same number
    of rows (ValueError otherwise)."""
    out = []
    for a in arrays:
        t = _as_device_tensor(a, mesh.device)
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=mesh.device)
        sizes = mesh.all_gather(n)
        if bool((sizes != sizes[0]).any()):
            raise ValueError(f"local slices differ in length: {sizes.tolist()}")
        out.append(t)
    return _one_or_tuple(tuple(out))


def gather_batch(mesh: Mesh, *tensors):
    """The global batch from each rank's slice, on every rank."""
    return _one_or_tuple(tuple(mesh.all_gather(t) for t in tensors))


def replicate(mesh: Mesh, tree):
    """A copy of a tree (dict / list / tuple) of tensors or arrays on the
    mesh's device, holding the first rank's values on every rank."""
    if isinstance(tree, dict):
        return type(tree)((k, replicate(mesh, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        items = [replicate(mesh, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return mesh.broadcast_(_as_device_tensor(tree, mesh.device).clone())


class _AllReduceSum(torch.autograd.Function):
    """Σ over data ranks whose backward is Σ over data ranks as well: the
    gradient of every rank's loss reaches every rank's input."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone()), None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of `x` over the mesh's data ranks."""
    return _AllReduceSum.apply(x, mesh)
