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

The reference drives its mesh from one program (``shard_map``): one
controller runs every shard and the collectives are ``all_gather``,
``psum`` and ``all_to_all`` inside that program.  The port does the same
from one process: a ``ShardMesh`` names the axis and its width M, the one
device every shard lives on, and the three collectives as plain functions
over the M per-shard values.  Per-shard values are a list of M tensors, or
one tensor whose leading dimension is the shard axis.

The shard mesh over several devices (the sharded admission datapath
across processes, run only by ``benchmarks/shard_bench.py``) is
ROADMAP.md item 5's first part; a shard mesh over more than one device
raises.
"""

from __future__ import annotations

import dataclasses

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
    """A 1-D mesh: ``shape[axis] == M`` shards, all on ``device``."""

    shape: dict
    device: torch.device

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


def make_shard_mesh(shards: int, axis: str = "shard",
                    device="cuda") -> ShardMesh:
    """A ``shards``-way mesh over axis ``axis`` for the sharded admission
    datapath (``ops.admit_commit_sharded``, ``ops.complete_sharded``).

    ``device`` is the one device of every shard (``"cuda"`` by default,
    ``"cpu"`` for the plain versions); a sequence of devices, one per
    shard as ``jax.devices()`` gives them, must name only one."""
    if shards < 1:
        raise ValueError(f"a shard mesh needs at least one shard, "
                         f"got {shards}")
    devs = {_indexed(d) for d in (device if isinstance(device, (list, tuple))
                                  else [device])}
    if len(devs) != 1:
        raise ValueError(
            f"a shard mesh over {len(devs)} devices: the port drives every "
            "shard on one device (the sharded datapath over several GPUs "
            "is ROADMAP.md item 5)")
    return ShardMesh({axis: shards}, devs.pop())


def _indexed(device) -> torch.device:
    """``device`` resolved, a CUDA device with its index, so that it
    compares equal to the device of a tensor on it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
