"""The port's training runtime against the JAX reference: the data
pipeline byte for byte (whisper's encoder frames and host slices too),
the checkpointer's contract (atomic visibility, ``keep``, a torn write,
asynchronous saves, bf16 leaves bit for bit, restore by key path), the
loop's restore-and-replay after an injected failure, four steps of
``train_loop.run`` against the reference's from the same weights (losses
within 1e-4 relative, f32), and ``launch.train`` on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke
from repro.data import pipeline as JP
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.runtime import train_loop as JT
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import pipeline as TP
from repro_torch.optim import adamw as TA
from repro_torch.runtime import train_loop as TT
from repro_torch.runtime.checkpoint import Checkpointer
from repro_torch.tree import items, leaves

CPU = torch.device("cpu")


@pytest.mark.parametrize("kw,hosts", [
    (dict(vocab=256, seq_len=32, global_batch=4), 1),
    (dict(vocab=51866, seq_len=16, global_batch=6, seed=3), 3),
    (dict(vocab=256, seq_len=8, global_batch=4, enc_frames=16, d_model=64,
          seed=7), 2)])
def test_pipeline_batches_are_byte_identical(kw, hosts):
    for host in range(hosts):
        jp = JP.Pipeline(JP.DataConfig(**kw), host, hosts)
        tp = TP.Pipeline(TP.DataConfig(**kw), host, hosts)
        for step in (0, 1, 5):
            want, got = jp.batch_at(step), tp.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert got[k].tobytes() == want[k].tobytes(), (k, step)


def test_pipeline_prefetch_resumes_at_a_step():
    tp = TP.Pipeline(TP.DataConfig(vocab=100, seq_len=8, global_batch=2))
    it = tp.iterate(start_step=3)
    for step in (3, 4, 5):
        assert next(it)["tokens"].tobytes() == \
            tp.batch_at(step)["tokens"].tobytes()
    it.close()
    with pytest.raises(ValueError, match="does not split"):
        TP.Pipeline(TP.DataConfig(vocab=10, seq_len=4, global_batch=3), 0, 2)


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    p = {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
         "blocks": {"a": torch.randn(2, 5, generator=g)},
         "first": [torch.randn(3, generator=g)]}
    return {"params": p, "opt": TA.init(p),
            "bias": torch.arange(4, dtype=torch.float32)}


def test_checkpoint_round_trip_keep_torn_and_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(_state(0))
    states = {s: _state(s) for s in (1, 2, 3)}
    for s, st in states.items():
        ck.save(s, st)               # asynchronous; one write outstanding
    ck.wait()
    assert ck.list_steps() == [2, 3]           # keep=2 dropped step 1
    os.makedirs(tmp_path / ".tmp-9-torn")      # a write killed mid-way
    (tmp_path / ".tmp-9-torn" / "arrays.npz").write_bytes(b"\0" * 10)
    os.makedirs(tmp_path / "step-000000010")   # renamed without manifest
    assert ck.latest_step() == 3 and ck.list_steps() == [2, 3]
    target = _state(0)
    got, step = ck.restore(target)
    assert step == 3
    want = items(states[3])
    assert [k for k, _ in items(got)] == [k for k, _ in want]
    for (k, g), (_, w) in zip(items(got), want):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16
                           else g, w.view(torch.int16)
                           if w.dtype == torch.bfloat16 else w), k
    assert isinstance(got["opt"], TA.AdamWState)
    manifest = json.loads((tmp_path / "step-000000003" /
                           "manifest.json").read_text())
    assert manifest["dtypes"]["params/w"] == "bfloat16"
    assert manifest["dtypes"]["opt/step"] == "int32"
    older, step = ck.restore(target, step=2)
    assert step == 2 and torch.equal(older["bias"], states[2]["bias"])
    bad = _state(0)
    bad["bias"] = torch.zeros(5)
    with pytest.raises(ValueError, match="bias"):
        ck.restore(bad)


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """The tree may change right after ``save`` returns (in-place AdamW):
    the checkpoint holds the values at the call."""
    ck = Checkpointer(str(tmp_path))
    st = _state(4)
    want = st["params"]["blocks"]["a"].clone()
    ck.save(1, st)
    st["params"]["blocks"]["a"].add_(1.0)
    ck.wait()
    got, _ = ck.restore(_state(0))
    assert torch.equal(got["params"]["blocks"]["a"], want)


def _smoke(arch):
    return jsmoke(jget_config(arch)), smoke_config(get_config(arch))


def test_run_restores_and_replays_after_a_failure(tmp_path, capsys):
    _, cfg = _smoke("xlb-service-model")
    pipe = TP.Pipeline(TP.DataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=2))
    tcfg = TT.TrainConfig(steps=6, ckpt_every=2, ckpt_dir=str(tmp_path),
                          warmup=1, opt=TA.AdamWConfig(lr=1e-2))
    failed = []

    def fail_once(step):
        if step == 3 and not failed:
            failed.append(step)
            raise RuntimeError("injected node failure")

    out = TT.run(cfg, pipe, tcfg, device="cpu", fail_injector=fail_once)
    steps = [h["step"] for h in out["history"]]
    assert out["restarts"] == 1 and steps == [0, 1, 2, 2, 3, 4, 5]
    first, replay = (h for h in out["history"] if h["step"] == 2)
    assert first["loss"] == replay["loss"]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in out["history"])
    assert "injected node failure" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).latest_step() == 6
    assert int(out["state"]["opt"].step) == 6


@pytest.mark.parametrize("arch,microbatch", [("xlb-service-model", 0),
                                             ("whisper-large-v3", 2)])
def test_run_matches_reference_loop(arch, microbatch, tmp_path):
    """Four steps of the port's loop against the reference's, f32, from
    the reference's weights: the same batches, warmup, AdamW and router
    bias; whisper with two microbatches accumulated into f32."""
    jcfg, tcfg = _smoke(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    dk = dict(vocab=jcfg.vocab, seq_len=16, global_batch=4,
              enc_frames=jcfg.enc_frames if jcfg.is_encdec else 0,
              d_model=jcfg.d_model)
    common = dict(steps=4, ckpt_every=100, warmup=2, microbatch=microbatch,
                  log_every=100)
    want = JT.run(jcfg, JP.Pipeline(JP.DataConfig(**dk)),
                  JT.TrainConfig(ckpt_dir=str(tmp_path / "j"),
                                 opt=JA.AdamWConfig(lr=1e-3), **common),
                  params=jp)
    got = TT.run(tcfg, TP.Pipeline(TP.DataConfig(**dk)),
                 TT.TrainConfig(ckpt_dir=str(tmp_path / "t"),
                                opt=TA.AdamWConfig(lr=1e-3), **common),
                 params=convert.params_from_jax(
                     jax.tree.map(np.asarray, jp), CPU), device="cpu")
    for w, g in zip(want["history"], got["history"]):
        assert w["step"] == g["step"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-3)
    assert len(got["history"]) == 4
    opt = convert.params_from_jax(
        jax.tree.map(np.asarray, want["state"]["opt"]), CPU)
    assert isinstance(opt, TA.AdamWState) and int(opt.step) == 4
    for w, g in zip(leaves(opt.v), leaves(got["state"]["opt"].v)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-2,
                                   atol=1e-3 * float(w.abs().max()))


@pytest.mark.parametrize("arch", ["whisper-large-v3", "jamba-v0.1-52b"])
def test_launch_train_on_the_cpu(arch, tmp_path, capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", arch, "--steps", "2", "--global-batch", "2",
                      "--seq", "32", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path)])
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    text = capsys.readouterr().out
    assert f"training {arch}-smoke" in text and "done: loss" in text
    assert Checkpointer(str(tmp_path)).latest_step() == 2
