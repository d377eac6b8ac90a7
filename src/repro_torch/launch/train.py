"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--steps N] [--global-batch B] [--seq S] [--lr LR] [--ckpt-dir DIR]
[--microbatch M] [--full] [--device cuda|cpu]`` (twin of
``repro/launch/train.py``, with the reference's flags).

It trains the reduced (smoke) config of the architecture, in the
config's dtype, unless ``--full``; whisper-large-v3 at ``--full`` (1.6 B
parameters, 8 x 448 tokens and 1500 frames) fits one H100.  The batches
come from the step-indexed synthetic pipeline (whisper's with encoder
frames), the weights from a seeded init.  A checkpoint already in
``--ckpt-dir`` (default: under the temporary directory, one per arch) is
resumed.  Runs on the card unless ``--device cpu``; there each step after
the first replays one captured CUDA graph (``train_loop.run``'s
``StaticTrainStep``).
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ASSIGNED_ARCHS, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.transformer import RunCtx
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ASSIGNED_ARCHS
                    + ["xlb-service-model"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the full config (one card holds whisper's)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = smoke_config(cfg)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params on "
          f"{args.device}")
    pipe = Pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.global_batch,
        enc_frames=cfg.enc_frames if cfg.is_encdec else 0,
        d_model=cfg.d_model))
    tcfg = train_loop.TrainConfig(
        steps=args.steps, ckpt_every=max(args.steps // 4, 10),
        ckpt_dir=args.ckpt_dir or os.path.join(
            tempfile.gettempdir(), f"repro_torch-{cfg.name}"),
        microbatch=args.microbatch,
        opt=adamw.AdamWConfig(lr=args.lr), log_every=10)
    out = train_loop.run(cfg, pipe, tcfg, RunCtx(), device=args.device)
    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return out


if __name__ == "__main__":
    main()
