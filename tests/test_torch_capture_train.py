"""The training step and the model launcher's decode step as captured
programs (``runtime/graphs.py``: ``StaticTrainStep``,
``StaticModelDecode``), on the CPU, where the same bodies run without a
graph.

* No host sync in the bodies a capture records, under the dispatch mode
  of ``test_torch_capture.py`` (which first must see a sync planted in a
  backward, and an RNG state read): the training step (forward,
  backward, clipping, AdamW, the router bias) at the smoke configs of a
  dense, an SSM, a MoE, a hybrid and the encoder-decoder arch, with
  remat none and block, one and two microbatches; the launcher's decode
  step for every arch of ``prefill_decode.ARCHS``.
* The static plumbing: the step counter and the router bias written
  back (``lr`` follows ``warmup_cosine`` step by step), the static path
  bit-equal to the eager step, a restore copied into the same static
  tensors, a foreign state of another shape refused; the captured decode
  bit-equal to ``decode_eager`` in tokens, logits and cache.

Tolerance: bit-exact (both sides run the same ops on the CPU)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import pipeline as TP
from repro_torch.launch import prefill_decode as PDL
from repro_torch.models import model as TM
from repro_torch.models.transformer import RunCtx
from repro_torch.optim import adamw as TA
from repro_torch.optim import schedules
from repro_torch.runtime import graphs
from repro_torch.runtime import train_loop as TT
from repro_torch.runtime.checkpoint import Checkpointer
from repro_torch.tree import leaves, map_tree
from test_torch_capture import HostSync, no_host_sync
from test_torch_capture import checked_bodies  # noqa: F401  (the fixture)

CPU = torch.device("cpu")
TRAIN_ARCHS = ["minitron-4b", "mamba2-2.7b", "arctic-480b",
               "jamba-v0.1-52b", "whisper-large-v3"]


class _PlantedSync(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        g.sum().item()
        return g * 2


def test_no_host_sync_sees_the_backward_and_rng_reads():
    x = torch.ones(3, requires_grad=True)
    y = _PlantedSync.apply(x).sum()
    with pytest.raises(HostSync), no_host_sync():
        torch.autograd.grad(y, [x])
    with pytest.raises(HostSync), no_host_sync():
        torch.utils.checkpoint.checkpoint(torch.sin, x, use_reentrant=False)
    with no_host_sync():
        z = torch.utils.checkpoint.checkpoint(
            torch.sin, x, use_reentrant=False, preserve_rng_state=False)
        torch.autograd.grad(z.sum(), [x])


def _setup(arch, seq=16, batch=2, **tkw):
    cfg = smoke_config(get_config(arch))
    pipe = TP.Pipeline(TP.DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch,
        enc_frames=cfg.enc_frames if cfg.is_encdec else 0,
        d_model=cfg.d_model))
    tcfg = TT.TrainConfig(**{"steps": 6, "warmup": 2,
                             "opt": TA.AdamWConfig(lr=1e-2), **tkw})
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    bias = torch.zeros((max(cfg.moe.n_experts, 1),), dtype=torch.float32)
    return cfg, pipe, tcfg, params, bias


@pytest.mark.parametrize("microbatch", [0, 2])
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_bodies_issue_no_host_sync(checked_bodies, arch, remat,
                                              microbatch):
    cfg, pipe, tcfg, params, bias = _setup(arch, microbatch=microbatch)
    step = graphs.StaticTrainStep(
        TT.make_train_step(cfg, RunCtx(remat=remat), tcfg), CPU)
    opt = TA.init(params)
    for i in range(2):
        params, opt, bias, m = step(params, opt, bias, pipe.batch_at(i))
        assert all(bool(torch.isfinite(v)) for v in m.values())
    assert len(checked_bodies) == 2 and len(set(checked_bodies)) == 1
    assert int(opt.step) == 2 and step.copied_in == 0


@pytest.mark.parametrize("arch", PDL.ARCHS)
def test_launcher_decode_bodies_issue_no_host_sync_and_equal_eager(
        checked_bodies, arch):
    """The captured decode against ``decode_eager`` from one prefill:
    the same tokens, last logits and cache."""
    cfg = smoke_config(get_config(arch))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=g,
                           dtype=torch.int32)
    frames = torch.randn((2, cfg.enc_frames, cfg.d_model), generator=g) \
        if cfg.is_encdec else None
    logits, cache, _ = PDL.prefill(cfg, params, tokens, 3, frames)
    twin = map_tree(torch.clone, cache)
    dec = graphs.StaticModelDecode(cfg, CPU)
    got, glog = PDL.decode(cfg, params, logits, cache, 32, 3, dec)
    want, wlog = PDL.decode_eager(cfg, params, logits, twin, 32, 3)
    assert torch.equal(got, want) and torch.equal(glog, wlog)
    for a, b in zip(leaves(cache), leaves(twin)):
        assert torch.equal(a, b)
    assert len(checked_bodies) == 3 and len(set(checked_bodies)) == 1
    assert got.dtype == torch.int32 and got.shape == (2, 3)
    with pytest.raises(ValueError, match="fixed shapes"):
        dec.load(cache, logits[:1], torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("arch", ["arctic-480b", "jamba-v0.1-52b",
                                  "xlb-service-model"])
def test_static_step_equals_the_eager_step(arch):
    """Four steps through ``StaticTrainStep`` and through the eager
    step from the same init: every loss, metric, parameter, moment, the
    step counter and the router bias bit-equal; the static state is one
    set of tensors, written in place."""
    cfg, pipe, tcfg, params, bias = _setup(arch)
    eager = TT.make_train_step(cfg, RunCtx(), tcfg)
    static = graphs.StaticTrainStep(eager, CPU)
    ep, eo, eb = map_tree(torch.clone, params), TA.init(params), bias
    sp, so, sb = params, TA.init(params), bias
    first = None
    for i in range(4):
        batch = pipe.batch_at(i)
        ep, eo, eb, em = eager(ep, eo, eb, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        sp, so, sb, sm = static(sp, so, sb, batch)
        for k in em:
            assert torch.equal(sm[k], em[k]), (i, k)
        ids = [id(t) for t in leaves((sp, so, sb, sm))]
        assert first is None or ids == first
        first = ids
    for a, b in zip(leaves((sp, so, sb)), leaves((ep, eo, eb))):
        assert torch.equal(a, b)
    assert int(so.step) == 4
    if cfg.moe.enabled:
        assert bool((sb != 0).any())          # the bias moved
    assert bias.abs().sum() == 0              # the caller's is untouched


def test_run_counts_steps_and_follows_warmup_cosine(tmp_path):
    """``train_loop.run`` through the static step: after N steps the
    static counter reads N, and the lr of step i is ``lr x
    warmup_cosine(i)``."""
    cfg, pipe, _, _, _ = _setup("xlb-service-model")
    tcfg = TT.TrainConfig(steps=7, ckpt_every=100, warmup=3,
                          ckpt_dir=str(tmp_path), log_every=100,
                          opt=TA.AdamWConfig(lr=1e-2))
    out = TT.run(cfg, pipe, tcfg, device="cpu")
    step = out["train_step"]
    assert isinstance(step, graphs.StaticTrainStep)
    assert out["state"]["opt"].step is step.state[1].step
    assert int(out["state"]["opt"].step) == 7
    for i, h in enumerate(out["history"]):
        want = 1e-2 * schedules.warmup_cosine(
            torch.tensor(i, dtype=torch.int32), warmup=3, total=7)
        assert h["lr"] == float(want.to(torch.float32)), i
    lrs = [h["lr"] for h in out["history"]]
    assert lrs[0] == 0.0 and max(lrs) == lrs[3] and lrs[-1] < lrs[3]


def test_restore_copies_into_the_static_tensors(tmp_path):
    """A checkpoint restored mid-run is copied into the static tensors
    (the same objects, holding the checkpoint's values); the steps after
    it replay the first pass bit for bit."""
    cfg, pipe, tcfg, params, bias = _setup("arctic-480b")
    step = graphs.StaticTrainStep(TT.make_train_step(cfg, RunCtx(), tcfg),
                                  CPU)
    ck = Checkpointer(str(tmp_path))
    state = (params, TA.init(params), bias)
    losses = []
    for i in range(4):
        *state, m = step(*state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
        if i == 1:
            ck.save(2, {"params": state[0], "opt": state[1],
                        "bias": state[2]}, blocking=True)
    static = leaves(step.state)
    tree, at = ck.restore({"params": state[0], "opt": state[1],
                           "bias": state[2]})
    assert at == 2 and not any(a is b for a, b in zip(leaves(tree), static))
    step._adopt(tree["params"], tree["opt"], tree["bias"])
    assert step.copied_in == len(static)
    assert all(a is b for a, b in zip(leaves(step.state), static))
    for a, b in zip(static, leaves(tree)):
        assert torch.equal(a, b)
    assert int(step.state[1].step) == 2
    state = step.state
    for i in (2, 3):
        *state, m = step(*state, pipe.batch_at(i))
        assert float(m["loss"]) == losses[i], i


def test_static_step_refuses_another_layout_of_state():
    cfg, pipe, tcfg, params, bias = _setup("xlb-service-model")
    step = graphs.StaticTrainStep(TT.make_train_step(cfg, RunCtx(), tcfg),
                                  CPU)
    opt = TA.init(params)
    params, opt, bias, _ = step(params, opt, bias, pipe.batch_at(0))
    with pytest.raises(ValueError, match="fixed shapes"):
        step(params, opt, torch.zeros(3), pipe.batch_at(1))
    # another batch shape is another program, the state carried over
    other = TP.Pipeline(TP.DataConfig(vocab=cfg.vocab, seq_len=8,
                                      global_batch=2))
    step(params, opt, bias, other.batch_at(0))
    assert len(step._batches) == 2 and int(step.state[1].step) == 2
    np.testing.assert_array_equal(
        step._batches[next(reversed(step._batches))][0]["tokens"].numpy(),
        other.batch_at(0)["tokens"])


def test_run_raises_a_failed_capture_without_retrying(tmp_path, monkeypatch):
    """A step that cannot be captured fails the same way every time: the
    loop raises ``CaptureError`` at once, where a node failure would be
    restored and replayed."""
    cfg, pipe, _, _, _ = _setup("xlb-service-model")
    calls = []

    def refuse(self, key, body, keep=()):
        calls.append(key)
        raise graphs.CaptureError("the capture failed: planted")

    monkeypatch.setattr(graphs.Graphs, "run", refuse)
    tcfg = TT.TrainConfig(steps=3, ckpt_every=100, ckpt_dir=str(tmp_path),
                          log_every=100)
    with pytest.raises(graphs.CaptureError, match="planted"):
        TT.run(cfg, pipe, tcfg, device="cpu")
    assert len(calls) == 1
