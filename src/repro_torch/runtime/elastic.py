"""Elastic scaling of a serving fleet through the ControlPlane (twin of
``repro/runtime/elastic.py``, its ``scale_fleet``).

``scale_fleet`` is the serving-side elastic event of the live-ops
scenarios: grow or shrink one cluster to a target endpoint count in a
single ControlPlane transaction.  Scale-up revives draining endpoints
before allocating fresh instance lanes; scale-down drains gracefully (the
reaper removes the rows once their in-flight load clears).

``validate_divisibility`` is the pre-flight check of a mesh change, pure
shape logic over a ``sharding/specs.py::MeshSpec``.  ``reshard_params``
and ``reshard_tree`` move a live tree between DP/FSDP/TP meshes: each
leaf goes to the placement the new ``MeshSpec`` (over a ``DeviceMesh``)
gives it, a DTensor by ``redistribute`` (or, onto another mesh, through
its full value), a plain tensor (the same on every rank) by
``distribute_tensor``.  Checkpoints are mesh-agnostic and the data
pipeline step-indexed, so this is all a mesh change needs.
"""

from __future__ import annotations

from typing import Any

from repro_torch.tree import map_tree


def _place(t, sh):
    """``t`` at ``sh`` (a ``specs.Placed``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(t, DTensor):
        if t.device_mesh == sh.mesh:
            return t.redistribute(sh.mesh, sh.placements)
        t = t.full_tensor()
    return distribute_tensor(t.detach(), sh.mesh, sh.placements)


def reshard_params(params: Any, new_ms) -> Any:
    """``params`` placed by ``new_ms.params_shardings``."""
    return reshard_tree(params, new_ms.params_shardings(params))


def reshard_tree(tree: Any, shardings: Any) -> Any:
    """Every leaf of ``tree`` at its ``Placed`` in ``shardings`` (a tree
    of the same structure)."""
    return map_tree(_place, tree, shardings)


def scale_fleet(cp, cluster: str, target: int, *, max_instances: int,
                weight: float = 1.0) -> list[tuple]:
    """Scale ``cluster`` to ``target`` serving endpoints in ONE transaction.

    Scale-up first lifts pending drains (a just-scaled-down instance comes
    back without a table splice), then adds endpoints on unused instance
    lanes — never past ``max_instances``, the engine pool's lane capacity.
    Scale-down drains the highest-numbered serving instances (graceful:
    weight 0 + drained bit now, row reaped when its load clears).  Returns
    the action list [("undrain"|"add"|"drain", instance), ...]."""
    if not 1 <= target <= max_instances:
        raise ValueError(f"target {target} outside [1, {max_instances}] "
                         f"(pool instance-lane capacity)")
    acts: list[tuple] = []
    with cp.transaction():
        members = cp.cluster_members(cluster)
        draining = sorted(i for _, i in members
                          if cp.drain_reason(cluster, i) is not None)
        serving = sorted(i for _, i in members if i not in draining)
        if target > len(serving):
            need = target - len(serving)
            for i in draining[:need]:
                cp.undrain_endpoint(cluster, i, weight=weight)
                acts.append(("undrain", i))
            need -= len(acts)
            used = {i for _, i in members}
            fresh = [i for i in range(max_instances) if i not in used]
            if need > len(fresh):
                raise ValueError(
                    f"cannot scale {cluster!r} to {target}: only "
                    f"{len(fresh)} free instance lanes of {max_instances}")
            for i in fresh[:need]:
                cp.add_endpoint(cluster, i, weight=weight)
                acts.append(("add", i))
        elif target < len(serving):
            for i in serving[target - len(serving):]:
                cp.drain_endpoint(cluster, i)
                acts.append(("drain", i))
    return acts


def validate_divisibility(cfg, ms, global_batch: int) -> list[str]:
    """Pre-flight checks when the mesh changes shape (elastic event)."""
    problems = []
    dp = 1
    for a in ms.dp:
        dp *= ms.mesh.shape[a]
    if global_batch % dp:
        problems.append(f"global_batch {global_batch} % dp {dp} != 0")
    if cfg.moe.enabled and cfg.moe.n_experts % ms.mesh.shape["model"]:
        problems.append(
            f"n_experts {cfg.moe.n_experts} not divisible by model axis "
            f"{ms.mesh.shape['model']} — EP relay needs even ownership")
    return problems
