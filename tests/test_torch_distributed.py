"""The port's multi-device paths over four ``gloo`` CPU processes: twins
of the three checks of ``tests/test_distributed.py`` on a (2, 2)
``data`` x ``model`` mesh, each against the reference's UNSHARDED output
on the same weights, computed here with JAX:

1. the expert-parallel relay (``moe_ffn(ep=...)``: B5 per rank, two
   ``all_to_all`` over ``model``) against the reference's one-device sort
   dispatch: 2e-4, the loads' sums equal;
2. deepseek's ``loss_fn`` on params and batch placed by ``MeshSpec``
   under ``RunCtx(shard=ms.constrain, tp_size=2)``, with and without the
   expert-parallel relay: rtol 2e-4 (and every gradient leaf within 1e-3
   of its largest |g|);
3. chameleon's forward under ``RunCtx(shard=ms.constrain, tp_size=2,
   q_chunk=16)`` (GQA expanded to a head count tp divides): 5e-4.

Also ``elastic.reshard_params`` from the (2, 2) mesh to a (4, 1) one
(every leaf equal) and ``compression.cross_pod_allreduce`` over the
``pod`` axis against numpy (the int8 sum exact).

The four ranks are processes of ``tests/torch_distributed_worker.py``
(one run for every test of this file), joined through a ``FileStore`` in
a temporary directory; they import no JAX.  The run takes about a
minute."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config, smoke_config
from repro.models import model as JM
from repro.models import moe as JMoE

WORKER = Path(__file__).with_name("torch_distributed_worker.py")
SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _by_path(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(a) for kp, a in flat}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's unsharded results, and rank 0's of the port's
    four-process run on the same inputs."""
    where = tmp_path_factory.mktemp("gloo")
    cfg = smoke_config(get_config("deepseek-v2-236b"))
    p = JMoE.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model))
    local_out, local_m = JMoE.moe_ffn(cfg, p, x, method="sort")

    params = JM.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    tok = jax.random.randint(jax.random.PRNGKey(3), (4, 32), 0, cfg.vocab)
    batch = {"tokens": tok, "labels": jnp.roll(tok, -1, 1)}
    (loss, _), grads = jax.value_and_grad(
        lambda q: JM.loss_fn(cfg, q, batch), has_aux=True)(params)

    cfg2 = smoke_config(get_config("chameleon-34b"))
    params2 = JM.init_params(cfg2, jax.random.PRNGKey(4), dtype=jnp.float32)
    tok2 = jax.random.randint(jax.random.PRNGKey(5), (4, 32), 0, cfg2.vocab)
    logits, _ = JM.forward(cfg2, params2, tok2)

    rng = np.random.RandomState(7)
    pod_grads = {"w": rng.randn(WORLD, 3, 5).astype(np.float32),
                 "b": (rng.randn(WORLD, 7) * 1e-3).astype(np.float32)}
    (where / "inputs.pkl").write_bytes(pickle.dumps({
        "moe_params": _np(p), "moe_x": np.asarray(x),
        "ds_params": _np(params),
        "ds_batch": {k: np.asarray(v) for k, v in batch.items()},
        "ch_params": _np(params2), "ch_tokens": np.asarray(tok2),
        "pod_grads": pod_grads}))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(WORLD), str(where)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=400)[0])
    finally:
        for pr in procs:
            pr.kill()
    assert all(pr.returncode == 0 for pr in procs), "\n".join(
        log[-3000:] for log in logs)
    got = pickle.loads((where / "rank0.pkl").read_bytes())
    return {"got": got, "local_out": np.asarray(local_out),
            "local_load": np.asarray(local_m.load), "loss": float(loss),
            "grads": _by_path(grads), "logits": np.asarray(logits),
            "params": _by_path(params), "pod_grads": pod_grads}


@pytest.mark.timeout(600)
def test_ep_relay_matches_local_dispatch(run):
    ep = run["got"]["ep"]
    np.testing.assert_allclose(ep["out"], run["local_out"], rtol=2e-4,
                               atol=2e-4)
    assert int(ep["load"].sum()) == int(run["local_load"].sum())
    np.testing.assert_array_equal(ep["load"], run["local_load"])


@pytest.mark.parametrize("key", ["loss", "loss_ep"])
@pytest.mark.timeout(600)
def test_sharded_loss_matches_single_device_loss(run, key):
    """``loss``: the MoE layer's one-device dispatch on the mesh;
    ``loss_ep``: the expert-parallel relay, its backward through the two
    ``all_to_all``s (no row dropped at the smoke config's capacity
    factor 8, so the per-rank pools hold what the one-device pools
    hold)."""
    got = run["got"][key]
    np.testing.assert_allclose(got["loss"], run["loss"], rtol=2e-4)
    assert set(got["grads"]) == set(run["grads"])
    for k, want in run["grads"].items():
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got["grads"][k], want, rtol=0,
                                   atol=1e-3 * scale, err_msg=k)


@pytest.mark.timeout(600)
def test_sharded_chunked_forward_matches_unsharded(run):
    np.testing.assert_allclose(run["got"]["logits"], run["logits"],
                               rtol=5e-4, atol=5e-4)


@pytest.mark.timeout(600)
def test_reshard_params_onto_another_mesh_keeps_every_leaf(run):
    moved = run["got"]["reshard"]
    assert set(moved) == set(run["params"])
    for k, want in run["params"].items():
        np.testing.assert_array_equal(moved[k], want, err_msg=k)


@pytest.mark.timeout(600)
def test_cross_pod_allreduce_int8_sum_matches_numpy(run):
    """Ranks r and r + 2 share a ``pod`` group (mesh (pod, data) = (2, 2)):
    the int8 values summed exactly, times the group's largest scale, over
    the group's size; each rank's residual its own rounding error."""
    g = run["pod_grads"]
    for r, (red, res) in enumerate(run["got"]["pod"]):
        group = (r % 2, r % 2 + 2)
        for k, v in g.items():
            qs, ss = [], []
            for i in group:
                x = v[i]
                s = np.float32(max(np.abs(x).max(), np.float32(1e-12))) \
                    / np.float32(127.0)
                qs.append(np.clip(np.round(x / s), -127, 127)
                          .astype(np.int32))
                ss.append(s)
                if i == r:
                    np.testing.assert_allclose(
                        res[k], x - qs[-1].astype(np.float32) * s,
                        rtol=0, atol=1e-7 * np.abs(x).max())
            want = (qs[0] + qs[1]).astype(np.float32) * max(ss) / 2
            np.testing.assert_allclose(red[k], want, rtol=1e-6, atol=0)
