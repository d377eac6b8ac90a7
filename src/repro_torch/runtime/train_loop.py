"""Fault-tolerant training loop (twin of ``repro/runtime/train_loop.py``).

  * Checkpoint and restart: asynchronous atomic checkpoints every
    ``ckpt_every`` steps; when a step fails the loop restores the last
    checkpoint and replays, the step-indexed pipeline giving the same
    batches again.
  * Straggler watchdog: a step slower than ``straggler_factor`` x the
    median of the last 20 is reported (on a fleet it would evict the slow
    host; one process here logs it and goes on).
  * The MoE router's least-request bias is updated outside autodiff each
    step from the expert loads.  As in the reference, ``loss_fn`` does not
    pass it to the router, so it does not steer training (ROADMAP.md §3).
  * Optional gradient accumulation over microbatches, into f32.

``run`` steps through ``runtime/graphs.py::StaticTrainStep``, the
counterpart of the reference's ``jax.jit(step_fn, donate_argnums=(0, 1,
2))``: on the card the first step runs eagerly (the warm-up), then the
whole step (forward, backward, clipping, AdamW, the router bias) is
captured as one CUDA graph and every later step replays it; on the CPU
the same static-buffer step runs without a graph.  Parameters that are
DTensors on a mesh take the eager step.  In the forward B7 and B8 (and
B5 in the MoE dispatch) launch on the card; the backward recomputes the
plain attention and scan (``kernels/ops.py``).  ``make_train_step``
returns the eager step.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.transformer import RunCtx
from repro_torch.optim import adamw, schedules
from repro_torch.runtime.checkpoint import Checkpointer
from repro_torch.runtime.graphs import CaptureError, StaticTrainStep
from repro_torch.sharding.specs import is_dtensor
from repro_torch.tree import leaves, map_tree, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch-ckpt")
    microbatch: int = 0              # 0 = no accumulation
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    warmup: int = 20
    straggler_factor: float = 3.0
    log_every: int = 10


def _grads(cfg: ModelConfig, ctx: RunCtx, params, batch):
    """(loss, the loss_fn metrics, gradients in the params' layout and
    dtypes) of one batch.  A DTensor gradient is laid out as its
    parameter here, so that a partial sum is reduced once, not again
    by each optimizer op that reads it."""
    for p in leaves(params):
        p.requires_grad_(True)
    with M.on_mesh(params):
        loss, aux = M.loss_fn(cfg, params, batch, ctx=ctx)
        grads = torch.autograd.grad(loss, leaves(params))
    grads = [g.redistribute(p.device_mesh, p.placements) if is_dtensor(g)
             else g for p, g in zip(leaves(params), grads)]
    return loss.detach(), aux, unflatten(params, grads)


def make_train_step(cfg: ModelConfig, ctx: RunCtx, tcfg: TrainConfig):
    """The train step under ``ctx`` (``RunCtx``: remat, MoE method,
    sharding hooks): forward + backward (accumulated over
    ``tcfg.microbatch`` slices of the batch into f32 where > 1), the
    warmup-cosine scale at the step before the increment, AdamW (in place)
    and the router bias.  ``step(params, opt_state, router_bias, batch)``
    → (params, opt_state, router_bias, metrics)."""

    def step_fn(params, opt_state, router_bias, batch):
        if tcfg.microbatch > 1:
            n = tcfg.microbatch
            B = next(iter(batch.values())).shape[0]
            grads = map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lval = 0.0
            for i in range(n):
                mb = {k: v[i * (B // n):(i + 1) * (B // n)]
                      for k, v in batch.items()}
                loss, aux, g = _grads(cfg, ctx, params, mb)
                grads = map_tree(torch.add, grads, g)
                lval = lval + loss
            grads = map_tree(lambda g: g / n, grads)
            lval = lval / n
        else:
            lval, aux, grads = _grads(cfg, ctx, params, batch)
        lr_scale = schedules.warmup_cosine(opt_state.step,
                                           warmup=tcfg.warmup,
                                           total=tcfg.steps)
        params, opt_state, stats = adamw.apply(params, grads, opt_state,
                                               tcfg.opt, lr_scale)
        router_bias = adamw.update_router_bias(router_bias,
                                               aux["expert_load"])
        metrics = {"loss": lval, **stats,
                   "overflow": aux["overflow"].detach()}
        return params, opt_state, router_bias, metrics

    return step_fn


def _on(device, batch: dict) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def run(cfg: ModelConfig, pipeline, tcfg: TrainConfig,
        ctx: RunCtx | None = None, *, params=None, seed: int = 0,
        device="cuda",
        fail_injector: Optional[Callable[[int], None]] = None) -> dict:
    """The driver loop with checkpoint / restart and the straggler
    watchdog, each step under ``ctx`` (``RunCtx()`` where None), captured
    (``StaticTrainStep``) unless the parameters are DTensors.
    ``params`` None: the seeded init (a generator on
    ``device`` seeded with ``seed``); a failure before the first
    checkpoint starts over from that init.  A checkpoint already in
    ``tcfg.ckpt_dir`` is restored first.  ``fail_injector(step)`` may
    raise to simulate a node failure (tests use it): the loop restores and
    replays; a step that cannot be captured raises ``CaptureError``.  On
    the card unless ``device="cpu"``.  Returns {"history":
    one dict a step run (replays included), "state", "restarts",
    "train_step"}: the state is the static one, overwritten by a further
    call of ``train_step``."""
    device = resolve_device(device)

    def fresh():
        return M.init_params(cfg, torch.Generator(device).manual_seed(seed),
                             None, device)

    params = fresh() if params is None else params
    router_bias = torch.zeros((max(cfg.moe.n_experts, 1),),
                              dtype=torch.float32, device=device)
    ckpt = Checkpointer(tcfg.ckpt_dir)
    train_step = make_train_step(cfg, ctx or RunCtx(), tcfg)
    if not any(map(is_dtensor, leaves(params))):
        train_step = StaticTrainStep(train_step, device)

    state = {"params": params, "opt": adamw.init(params),
             "bias": router_bias}
    start = 0
    if ckpt.latest_step() is not None:
        state, start = ckpt.restore(state)
        print(f"[train] restored checkpoint step={start}")

    history, durations = [], []
    step, restarts = start, 0
    while step < tcfg.steps:
        try:
            batch = pipeline.batch_at(step)
            if not isinstance(train_step, StaticTrainStep):
                batch = _on(device, batch)
            t0 = time.perf_counter()
            if fail_injector is not None:
                fail_injector(step)
            p, o, b, metrics = train_step(state["params"], state["opt"],
                                          state["bias"], batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            state = {"params": p, "opt": o, "bias": b}
            durations.append(dt)
            med = statistics.median(durations[-20:])
            if len(durations) > 5 and dt > tcfg.straggler_factor * med:
                print(f"[train] straggler: step {step} took {dt:.3f}s "
                      f"(median {med:.3f}s) — would evict/reschedule host")
            history.append({"step": step, **metrics, "wall_s": dt})
            if step % tcfg.log_every == 0:
                print(f"[train] step {step} loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms")
            step += 1
            if step % tcfg.ckpt_every == 0 or step == tcfg.steps:
                ckpt.save(step, state)
        except (KeyboardInterrupt, CaptureError):
            raise
        except Exception as e:       # a node failure: restore and replay
            restarts += 1
            print(f"[train] step {step} failed ({type(e).__name__}: {e}); "
                  f"restoring last checkpoint")
            if restarts > 10:
                raise
            ckpt.wait()
            if ckpt.latest_step() is None:
                params = fresh()
                state = {"params": params, "opt": adamw.init(params),
                         "bias": torch.zeros_like(router_bias)}
                step = 0
            else:
                state, step = ckpt.restore(state)
    ckpt.wait()
    return {"history": history, "state": state, "restarts": restarts,
            "train_step": train_step}
