"""How ``correct`` is decided: what the timed path produced, judged by the
plain reference (``reference/``), which reads the program's outputs only
to judge them.

Three numbers, each beside its limit:

- ``ingress_mismatches``: rows of admission batches whose order (every
  tick) or hashed features (the sampled ticks) differ from the
  reference's ingress; limit 0;
- ``datapath_mismatches``: every tick's active count, the whole pool's
  request ids on the sampled ticks, each request's admission tick,
  completion tick, retries and drop, and the state after the last tick
  (pool, loads, cursors, health EWMAs, affinity cache, counters), each
  against the reference's replay of the same submissions and draws;
  limit 0;
- ``token_gap``: over a sample of finished calls drawn from the seed, the
  widest gap by which a served token's logit lies below the best logit of
  the reference model run over the call's prompt and served tokens; the
  limit is the configuration file's ``token_gap_limit``, set from the
  readings in PERF.md.
"""

from __future__ import annotations

import numpy as np
import torch

from xlbench import seeded
from xlbench.reference import model as ref_model
from xlbench.reference.datapath import Datapath
from xlbench.reference.fnv import features

#: rows of calls the reference model runs at once
TOKEN_BLOCK = 8


def replay(run, got: dict) -> tuple[dict, list]:
    """The reference's replay of the run's submissions and draws: the
    mismatch counts and the per-tick work."""
    sl, e = run.cfg["serve_loop"], run.cfg["engine"]
    dp = Datapath(run.lay, slots=e["slots"], max_len=e["max_len"],
                  eos=e["eos"], admit_batch=sl["admit_batch"],
                  max_retries=sl["max_retries"],
                  backoff_base=sl["backoff_base"],
                  backoff_cap=sl["backoff_cap"],
                  backoff_seed=run.backoff_seed, sizes=run.sizes)
    draws = seeded.Draws(run.seed, run.device)

    def next_draws():
        rnd, gum = draws(sl["admit_batch"])
        return rnd.cpu().numpy(), gum.cpu().numpy()

    by_tick: dict = {}
    for rid, tick in enumerate(run.traffic.sent_tick):
        by_tick.setdefault(tick, []).append(rid)
    bad_ingress = bad_path = 0
    works = []
    for t in range(run.n_ticks):
        for rid in by_tick.get(t, ()):
            dp.submit(rid, *run.sent(rid))
        shown = dp.tick(next_draws)
        works.append(shown["work"])
        mine = np.asarray(shown["batch"], np.int64)
        theirs = run.batches.get(t, np.zeros(0, np.int64)).astype(np.int64)
        if mine.shape != theirs.shape:
            bad_ingress += max(len(mine), len(theirs))
        else:
            bad_ingress += int((mine != theirs).sum())
        if t in run.feats:
            want = np.stack([features(run.sent(int(r))[1]) for r in theirs]) \
                if len(theirs) else np.zeros((0, 8), np.int64)
            bad_ingress += int((run.feats[t].astype(np.int64) != want)
                               .any(axis=1).sum())
        if shown["active"] != run.active[t]:
            bad_path += 1
        if t in run.grids:
            bad_path += int((run.grids[t].astype(np.int64)
                             != shown["ids"].reshape(-1)).sum())
    for rid, r in dp.reqs.items():
        p = run.requests[rid]
        bad_path += int(p.admit_tick != r.admit_tick) \
            + int(p.done_tick != r.done_tick) + int(p.retries != r.retries) \
            + int((rid in run.dropped) != r.dropped)
    want = dp.final_state()
    for k, v in want.items():
        g = got[k]
        v = np.asarray(v)
        if g.shape != v.shape:
            bad_path += max(g.size, v.size)
        else:
            bad_path += int((g.astype(v.dtype) != v).sum())
    # untouched by these policies: the affinity cache stays empty, the
    # version at its boot value
    bad_path += int((got["routing.aff_key"] != -1).sum()) \
        + int((got["routing.aff_ep"] != -1).sum()) \
        + int(got["routing.version"] != 0)
    return {"ingress_mismatches": bad_ingress,
            "datapath_mismatches": bad_path}, works


def token_sample(run) -> list:
    """The finished calls whose tokens are judged, drawn from the seed."""
    done = sorted(rid for rid, r in run.requests.items()
                  if r.done_tick >= 0 and len(r.tokens) > 0)
    k = min(run.spec["check"]["token_calls"], len(done))
    g = seeded.rng(run.seed, seeded.SAMPLE)
    pick = g.choice(len(done), size=k, replace=False) if k else []
    return [done[i] for i in sorted(pick)]


def token_gaps(m: dict, params: dict, calls: list, device,
               tf32_argmax: bool = False) -> float:
    """The widest gap, over every served position of ``calls`` ((prompt
    token, served tokens) pairs of one length), between the reference's
    best logit and its logit of the served token; with ``tf32_argmax``
    (the control) the token is the one the reference in TF32 puts
    first."""
    widest = 0.0
    for i in range(0, len(calls), TOKEN_BLOCK):
        block = calls[i:i + TOKEN_BLOCK]
        seq = torch.tensor([[p] + t[:-1] for p, t in block],
                           dtype=torch.int64, device=device)
        served = torch.tensor([t for _, t in block], dtype=torch.int64,
                              device=device)
        with torch.no_grad():
            with ref_model.matmul_precision(False):
                logits = ref_model.forward(m, params, seq)
            if tf32_argmax:
                with ref_model.matmul_precision(True):
                    served = ref_model.forward(m, params, seq).argmax(-1)
        best = logits.max(dim=-1).values
        mine = logits.gather(-1, served[..., None])[..., 0]
        widest = max(widest, float((best - mine).max()))
        del logits
    return widest


def judge(run, got: dict) -> tuple[bool, dict, list]:
    """(correct, {name: (value, limit)}, the replay's per-tick work)."""
    counts, works = replay(run, got)
    calls = [(run.requests[r].prompt_token, list(run.requests[r].tokens))
             for r in token_sample(run)]
    gap = token_gaps(run.m, run.params, calls, run.device) if calls \
        else float("inf")
    checks = {"ingress_mismatches": (counts["ingress_mismatches"], 0),
              "datapath_mismatches": (counts["datapath_mismatches"], 0),
              "token_gap": (gap, run.cfg["token_gap_limit"])}
    correct = all(v <= lim for v, lim in checks.values())
    return correct, checks, works
