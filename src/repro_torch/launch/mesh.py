"""Meshes (twin of ``repro/launch/mesh.py``): the production meshes as
shapes, a host mesh over the ranks of a process group, and the shard
mesh of the sharded datapath.

``make_production_mesh`` / ``make_mesh_spec`` give the reference's
production meshes, (16, 16) ``data`` / ``model`` and (2, 16, 16)
``pod`` / ``data`` / ``model``, as ``LogicalMesh``es: axis names and
sizes, no devices.  The dry run reads them for its per-device shapes
and, over a fake process group of as many ranks, for its collectives.
``make_host_mesh`` is a ``DeviceMesh`` over the ranks of the default
process group (``torch.distributed``: ``gloo`` processes on the CPU,
``nccl`` on the cards), which a ``MeshSpec`` places tensors on.

The reference drives its shard mesh from one program (``shard_map``):
one controller runs every shard and the collectives are ``all_gather``,
``psum`` and ``all_to_all`` inside that program.  The port has two shard
meshes with one interface, so that ``kernels/shard_admit.py`` has one
body for both:

* ``ShardMesh``: one process drives all M shards on one device, and the
  collectives are plain functions over the M per-shard values;
* ``RankShardMesh``: one rank of a process group a shard (PyTorch's
  idiom, one process a device), each on its own device, and the
  collectives are the group's (``gloo`` on the CPU or where ranks share
  a card, NCCL where each rank has its own).

A mesh names the shards this process holds (``held``: all M, or the
rank's own).  Per-shard values are stacked on a leading axis of those
shards, as one tensor or a list: ``all_gather`` turns (L, ...) into
(M, ...), ``psum`` into (...), and ``all_to_all`` exchanges (L, M_dst,
...) for (L, M_src, ...).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.specs import LogicalMesh, MeshSpec


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The reference's target: 16×16 (256 chips) per pod; 2 pods = 512.

    Axes: "pod" (slow inter-pod hop), "data" (DP/FSDP), "model"
    (TP/EP/SP)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def make_mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    return MeshSpec(make_production_mesh(multi_pod=multi_pod))


def make_host_mesh(data: int = 1, model: int = 1):
    """A (data, model) ``DeviceMesh`` over the first ``data * model``
    ranks of the default process group (which the caller initialises),
    on "cuda" where the group is NCCL's, else on "cpu".  Raises
    ``ValueError`` when ``data * model`` exceeds the world size, as the
    reference asserts against its device count."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    if data * model > n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, the process group has {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def _stacked(xs) -> torch.Tensor:
    return xs if isinstance(xs, torch.Tensor) else torch.stack(list(xs))


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A 1-D mesh: ``shape[axis] == M`` shards, all on ``device``, all
    held by this process."""

    shape: dict
    device: torch.device

    @property
    def held(self) -> tuple:
        """The shards this process holds: every one."""
        return tuple(range(next(iter(self.shape.values()))))

    @staticmethod
    def all_gather(xs) -> torch.Tensor:
        """Every shard's value, stacked: (M, ...)."""
        return _stacked(xs)

    @staticmethod
    def psum(xs) -> torch.Tensor:
        """The sum over the shards, in the values' own dtype (an int32 sum
        wraps as the reference's does)."""
        x = _stacked(xs)
        return x.sum(dim=0, dtype=x.dtype)

    @staticmethod
    def all_to_all(xs) -> torch.Tensor:
        """``jax.lax.all_to_all(x, split_axis=0, concat_axis=0,
        tiled=False)``: shard m's value is (M, ...), its chunk j goes to
        shard j, and shard j stacks what it receives by source.  Returns
        the received values (M, M, ...), ``out[j][m] = xs[m][j]``."""
        return _stacked(xs).transpose(0, 1)

    @staticmethod
    def agree(key, value: int) -> int:
        """``value``: one process decides for every shard."""
        return value


#: how long a rank waits in a collective before the group fails it
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(eq=False)
class RankShardMesh:
    """A 1-D mesh over the ``shape[axis] == M`` ranks of a process group:
    rank m holds shard m on its own ``device``.  Every rank must call each
    collective, in the same order, with operands of the same shape.  The
    operands stay on ``device``: NCCL and ``gloo`` both take CUDA tensors
    for the three collectives (``gloo`` copies them through the host
    itself)."""

    shape: dict
    device: torch.device
    rank: int
    group: Any = None           # None: the default group
    _agreed: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def held(self) -> tuple:
        return (self.rank,)

    def _one(self, xs) -> torch.Tensor:
        x = _stacked(xs)
        if x.shape[0] != 1:
            raise ValueError(f"a rank holds one shard, got {x.shape[0]}")
        return x[0]

    def all_gather(self, xs) -> torch.Tensor:
        """This rank's value (1, ...) gathered: (M, ...) in rank order."""
        import torch.distributed as dist
        x = self._one(xs)
        M = next(iter(self.shape.values()))
        out = x.new_empty((M * x.numel(),))
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, x.reshape(-1), group=self.group)
        return out.reshape(M, *x.shape)

    def psum(self, xs) -> torch.Tensor:
        """The sum of every rank's value (1, ...), in its own dtype (an
        int32 sum wraps as the reference's does)."""
        import torch.distributed as dist
        buf = self._one(xs).clone()
        dist.all_reduce(buf, group=self.group)
        return buf

    def all_to_all(self, xs) -> torch.Tensor:
        """This rank's (1, M, ...) split by destination: chunk j goes to
        rank j, which gets (1, M, ...) stacked by source."""
        import torch.distributed as dist
        x = self._one(xs).contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out[None]

    def agree(self, key, value: int) -> int:
        """Rank 0's ``value`` for ``key``, on every rank: one collective
        the first time every rank asks for ``key``, remembered after (a
        kernel plan a rank swept on its own device must not differ from
        its neighbours')."""
        if key not in self._agreed:
            mine = value if self.rank == 0 else 0
            self._agreed[key] = int(self.psum(torch.tensor(
                [mine], dtype=torch.int64, device=self.device)[None])[0])
        return self._agreed[key]


def make_shard_mesh(shards: int, axis: str = "shard", device="cuda",
                    group=None):
    """A ``shards``-way mesh over axis ``axis`` for the sharded admission
    datapath (``ops.admit_commit_sharded``, ``ops.complete_sharded``).

    With a process group (``group``, or the default group when it is
    initialised with ``shards`` ranks): a
    ``RankShardMesh``, this rank's shard on ``device``.  Otherwise a
    ``ShardMesh``: every shard on the one ``device`` (``"cuda"`` by
    default, ``"cpu"`` for the plain versions); a sequence of devices, one
    per shard as ``jax.devices()`` gives them, must name only one."""
    import torch.distributed as dist
    if shards < 1:
        raise ValueError(f"a shard mesh needs at least one shard, "
                         f"got {shards}")
    devs = {_indexed(d) for d in (device if isinstance(device, (list, tuple))
                                  else [device])}
    if len(devs) != 1:
        raise ValueError(
            f"a shard mesh over {len(devs)} devices in one process: one "
            "process drives its shards on one device; for one device a "
            "shard, run one rank a shard under a process group "
            "(torch.distributed) and give each rank its own device "
            "(launch/mesh.py::RankShardMesh)")
    dev = devs.pop()
    if group is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == shards:
        group = dist.group.WORLD
    if group is None:
        return ShardMesh({axis: shards}, dev)
    n = dist.get_world_size(group)
    if n != shards:
        raise ValueError(f"a {shards}-way shard mesh over a process group "
                         f"of {n} ranks")
    return RankShardMesh({axis: shards}, dev, dist.get_rank(group), group)


def init_shard_group(backend: str, *, rank: int | None = None,
                     world_size: int | None = None, store=None):
    """Initialise the default process group for a rank shard mesh, with
    ``GROUP_TIMEOUT``: a lost collective fails instead of hanging.
    Without ``store`` the rank, size and rendezvous come from the
    environment (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``)."""
    import torch.distributed as dist
    kw = {} if store is None else dict(store=store, rank=rank,
                                       world_size=world_size)
    dist.init_process_group(backend, timeout=GROUP_TIMEOUT, **kw)


def _indexed(device) -> torch.device:
    """``device`` resolved, a CUDA device with its index, so that it
    compares equal to the device of a tensor on it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
