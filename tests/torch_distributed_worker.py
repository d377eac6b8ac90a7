"""One rank of ``tests/test_torch_distributed.py``'s four-process run:
``python tests/torch_distributed_worker.py RANK WORLD DIR``.

It joins a ``gloo`` group through a ``FileStore`` in DIR, reads the
weights and inputs the test wrote there (``inputs.pkl``: numpy trees, no
JAX), runs the port's multi-device paths on a (2, 2) ``data`` x
``model`` mesh and, on rank 0, writes what they gave to ``rank0.pkl``:

* ``ep``: ``moe_ffn`` with the expert-parallel relay (``ep``), the rows
  gathered back, and its loads;
* ``loss``: deepseek's ``loss_fn`` on params and batch placed by
  ``MeshSpec``, ``RunCtx(shard=ms.constrain, tp_size=2)``, and the
  gradient of every leaf; ``loss_ep`` the same with the expert-parallel
  relay (``ep=(mesh, ("data", "model"))``);
* ``logits``: chameleon's forward under ``RunCtx(shard=ms.constrain,
  tp_size=2, q_chunk=16)``;
* ``reshard``: the deepseek params moved from the (2, 2) mesh to a
  (4, 1) one by ``elastic.reshard_params``, gathered back;
* ``pod``: ``compression.cross_pod_allreduce`` over the ``pod`` axis of a
  (2, 2) ``pod`` x ``data`` mesh, each rank's gradients its own, and
  every rank's result.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as TM
from repro_torch.models import moe
from repro_torch.models.transformer import RunCtx
from repro_torch.optim import compression
from repro_torch.runtime.elastic import reshard_params, reshard_tree
from repro_torch.sharding.specs import MeshSpec
from repro_torch.tree import items, leaves

CPU = torch.device("cpu")


def _full(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach() \
        .numpy()


def main(rank: int, world: int, where: Path) -> None:
    store = dist.FileStore(str(where / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        inp = pickle.loads((where / "inputs.pkl").read_bytes())
        out = run(inp)
        if rank == 0:
            (where / "rank0.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def run(inp: dict) -> dict:
    mesh = make_host_mesh(2, 2)
    ms = MeshSpec(mesh)
    out = {}

    # 1) EP relay: plain tensors, the same on every rank
    cfg = smoke_config(get_config("deepseek-v2-236b"))
    p = convert.params_from_jax(inp["moe_params"], CPU)
    y, m = moe.moe_ffn(cfg, p, torch.from_numpy(inp["moe_x"]),
                       ep=(mesh, ("data", "model")))
    out["ep"] = {"out": _full(y), "load": _full(m.load),
                 "overflow": float(_full(m.overflow_frac))}

    # 2) sharded loss and its gradients
    params = convert.params_from_jax(inp["ds_params"], CPU)
    pd = reshard_params(params, ms)
    batch = {k: torch.from_numpy(v) for k, v in inp["ds_batch"].items()}
    bd = reshard_tree(batch, ms.batch_shardings(batch))
    for t in leaves(pd):
        t.requires_grad_(True)
    ctx = RunCtx(shard=ms.constrain, tp_size=2)
    with TM.on_mesh(pd):
        loss, _ = TM.loss_fn(cfg, pd, bd, ctx=ctx)
        grads = torch.autograd.grad(loss, leaves(pd))
    out["loss"] = {"loss": float(_full(loss)),
                   "grads": {k: _full(g) for (k, _), g in
                             zip(items(pd), grads)}}
    # ... and with the expert-parallel relay in its MoE layer
    ctx_ep = RunCtx(shard=ms.constrain, tp_size=2,
                    ep=(mesh, ("data", "model")))
    with TM.on_mesh(pd):
        loss, _ = TM.loss_fn(cfg, pd, bd, ctx=ctx_ep)
        grads = torch.autograd.grad(loss, leaves(pd))
    out["loss_ep"] = {"loss": float(_full(loss)),
                      "grads": {k: _full(g) for (k, _), g in
                                zip(items(pd), grads)}}

    # 3) chameleon: GQA expanded for tp 2, query chunks of 16
    cfg2 = smoke_config(get_config("chameleon-34b"))
    p2 = reshard_params(convert.params_from_jax(inp["ch_params"], CPU), ms)
    ctx2 = RunCtx(shard=ms.constrain, tp_size=2, q_chunk=16)
    with torch.no_grad():
        logits, _ = TM.forward(cfg2, p2, torch.from_numpy(inp["ch_tokens"]),
                               ctx=ctx2)
    out["logits"] = _full(logits)

    # 4) elastic: (2, 2) → (4, 1)
    moved = reshard_params(pd, MeshSpec(make_host_mesh(4, 1)))
    out["reshard"] = {k: _full(t) for k, t in items(moved)}

    # 5) the int8 all-reduce over the pod axis
    pods = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    g = {k: torch.from_numpy(v[dist.get_rank()])
         for k, v in inp["pod_grads"].items()}
    red, ef = compression.cross_pod_allreduce(g, compression.init(g),
                                              group=pods)
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, ({k: v.numpy() for k, v in red.items()},
                                 {k: v.numpy()
                                  for k, v in ef.residual.items()}))
    out["pod"] = got
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
