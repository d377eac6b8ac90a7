"""End-to-end training driver on the PyTorch port: a ~100M-parameter MoE
for a few hundred steps.

Exercises the training path: deterministic pipeline → forward / backward
with the XLB expert relay (token → expert load balancing: the relay
kernel gives each routed row its slot; attention through the flash
kernel, whose backward recomputes the plain attention) → AdamW →
asynchronous checkpoints → restart on failure.  On the card
``train_loop.run`` captures the whole step as one CUDA graph at the
first step and replays it after.

Run:  PYTHONPATH=src python examples/torch/train_moe.py [--steps 300]
      [--device cpu]
Checkpoints go to ``--ckpt-dir`` (default ``build/train-moe`` in the
checkout); one already there is resumed.
"""

import argparse
from pathlib import Path

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.transformer import RunCtx
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop

# ~100M-param MoE in the deepseek-v2 family shape (shared + routed experts)
CFG = ModelConfig(
    name="deepseek-mini-100m", family="moe",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=8192, head_dim=64, ffn_act="swiglu",
    moe=MoEConfig(n_experts=16, top_k=2, n_shared_experts=1,
                  d_ff_expert=512, first_dense=1),
)
CKPT_DIR = Path(__file__).resolve().parents[2] / "build" / "train-moe"


def main(argv=None) -> dict:
    """Runs the example and returns what it prints: ``losses`` (one a step
    run), ``restarts``, ``params`` / ``active`` (counts), ``ckpt_dir``,
    the loop's ``out`` and ``lines``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    lines = [f"model: {CFG.name}  params≈{CFG.param_count()/1e6:.1f}M "
             f"(active {CFG.active_param_count()/1e6:.1f}M)"]
    print(lines[0])
    pipe = Pipeline(DataConfig(vocab=CFG.vocab, seq_len=args.seq,
                               global_batch=args.batch))
    tcfg = train_loop.TrainConfig(
        steps=args.steps, ckpt_every=100, ckpt_dir=args.ckpt_dir,
        opt=adamw.AdamWConfig(lr=1e-3), warmup=30, log_every=20)
    out = train_loop.run(CFG, pipe, tcfg, RunCtx(), device=args.device)
    losses = [h["loss"] for h in out["history"]]
    lines.append(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over "
                 f"{len(losses)} steps; restarts={out['restarts']}")
    print(lines[-1])
    return {"losses": losses, "restarts": out["restarts"],
            "params": CFG.param_count(), "active": CFG.active_param_count(),
            "ckpt_dir": args.ckpt_dir, "out": out, "lines": lines}


if __name__ == "__main__":
    main()
