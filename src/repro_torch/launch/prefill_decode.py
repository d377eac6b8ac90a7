"""Prefill-then-decode launcher for the model stack: ``python -m
repro_torch.launch.prefill_decode --arch minitron-4b --batch 2 --prompt
4096 --steps 32 [--device cuda|cpu] [--smoke]``; ``--arch`` is one of
``ARCHS`` (the dense, vlm, ssm, moe, hybrid and audio families).
whisper-large-v3 encodes ``--batch`` x 1500 frames drawn from ``--seed``
(its conv frontend is a stub: precomputed frame embeddings) before the
prompt, which its 448-token text context bounds.  arctic-480b,
deepseek-v2-236b and jamba-v0.1-52b pass one card at full depth (arctic
alone is 477 B parameters): run them with ``--smoke``, or call ``run``
with a config whose depth is cut.

The port's counterpart of ``launch/dryrun.py::build_prefill_step`` and
``build_decode_step`` in the reference, run for real: it builds the
architecture at full width and depth (or its reduced config with
``--smoke``) with random weights from ``--seed``, prefills ``--batch``
random prompts of ``--prompt`` tokens, then runs ``--steps`` decode steps
on the argmax tokens, and prints the prefill time, the time per decode
step and the decode tokens/s.  The prefill is eager (one call a batch);
the decode step is ``runtime/graphs.py::StaticModelDecode``, on the card
one CUDA graph captured at the first step and replayed (the reference
jits ``build_decode_step`` with the cache donated); ``decode_eager`` is
the same loop op by op.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.runtime.graphs import StaticModelDecode


#: the architectures the launcher builds (the families the port runs)
ARCHS = ("minitron-4b", "mamba2-2.7b", "xlb-service-model", "granite-20b",
         "internlm2-20b", "yi-34b", "chameleon-34b", "arctic-480b",
         "deepseek-v2-236b", "jamba-v0.1-52b", "whisper-large-v3")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill(cfg, params, tokens, steps: int, enc_frames=None) -> tuple:
    """``tokens`` (B, S) prefilled into a fresh cache of S + ``steps``
    positions (whisper: after encoding ``enc_frames`` (B, F, D)); returns
    (the last logits, the cache, the merged ``MoEMetrics`` or None)."""
    batch, prompt = tokens.shape
    cache = M.init_cache(cfg, batch, prompt + steps, params["embed"].dtype,
                         tokens.device)
    return M.prefill(cfg, params, tokens, cache, enc_frames=enc_frames,
                     return_metrics=True)


def decode(cfg, params, logits, cache, prompt: int, steps: int,
           decoder: StaticModelDecode | None = None) -> tuple:
    """``steps`` greedy steps from the prefill's last ``logits``, the
    first writing at ``prompt``, through ``decoder`` (a new
    ``StaticModelDecode`` where None): on the card one captured step
    replayed.  Returns (the tokens (B, steps) int32, the last logits)."""
    device = logits.device
    dec = decoder or StaticModelDecode(cfg, device)
    dec.load(cache, logits, torch.full((logits.shape[0],), prompt,
                                       dtype=torch.int32, device=device))
    out = torch.empty((logits.shape[0], steps), dtype=torch.int32,
                      device=device)
    for i in range(steps):
        out[:, i:i + 1].copy_(dec.step(params, cache))
    return out, dec.logits(cache).clone()


def decode_eager(cfg, params, logits, cache, prompt: int,
                 steps: int) -> tuple:
    """``decode`` op by op, without a captured program (the A/B's other
    side)."""
    lengths = torch.full((logits.shape[0],), prompt, dtype=torch.int32,
                         device=logits.device)
    out = []
    for _ in range(steps):
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        out.append(tok)
        logits, cache = M.decode_step(cfg, params, tok, lengths, cache)
        lengths = lengths + 1
    return (torch.cat(out, 1) if out else torch.empty(
        (logits.shape[0], 0), dtype=torch.int32, device=logits.device),
        logits)


def run(cfg, params, tokens, steps: int, enc_frames=None) -> dict:
    """``prefill``, then ``steps`` greedy steps through ``decode``;
    returns the generated tokens (B, steps), the last logits, the
    prefill's merged ``MoEMetrics`` (None without MoE layers), the
    host-clock seconds of each part (synchronised on the card) and the
    decode's warm-up and capture seconds (``setup_s``, inside
    ``decode_s``)."""
    device = tokens.device
    _sync(device)
    t0 = time.perf_counter()
    logits, cache, metrics = prefill(cfg, params, tokens, steps, enc_frames)
    _sync(device)
    t1 = time.perf_counter()
    dec = StaticModelDecode(cfg, device)
    out, logits = decode(cfg, params, logits, cache, tokens.shape[1], steps,
                         dec)
    _sync(device)
    t2 = time.perf_counter()
    return {"logits": logits, "tokens": out, "metrics": metrics,
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "setup_s": dec.graphs.setup_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's reduced config (f32)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    dtype = None
    if args.smoke:
        cfg, dtype = smoke_config(cfg), torch.float32
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen, dtype, device)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                           generator=gen, device=device, dtype=torch.int32)
    frames = None
    if cfg.is_encdec:
        frames = torch.randn((args.batch, cfg.enc_frames, cfg.d_model),
                             generator=gen, device=device).to(
                                 params["embed"].dtype)
    res = run(cfg, params, tokens, args.steps, frames)
    n = args.batch * args.steps
    per_step = res["decode_s"] / max(args.steps, 1)
    print(f"{cfg.name} [{device}]: prefill {args.batch} x {args.prompt} "
          f"tokens {1e3 * res['prefill_s']:.2f} ms; {args.steps} decode "
          f"steps {1e3 * per_step:.2f} ms per step (with the "
          f"{1e3 * res['setup_s']:.2f}-ms warm-up and capture), "
          f"{n / res['decode_s'] if res['decode_s'] else 0.0:.1f} tokens/s; "
          f"logits finite: {bool(torch.isfinite(res['logits']).all())}")
    return res


if __name__ == "__main__":
    main()
