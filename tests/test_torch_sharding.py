"""The port's sharding rules (``repro_torch/sharding/specs.py``) against
the reference's (``repro/sharding/specs.py``), twin of
``tests/test_sharding.py``.

The reference's ``MeshSpec`` runs over its ``StubMesh`` (a mesh as axis
names and sizes, as its own tests build it); the port's over a
``LogicalMesh`` of the same shape.  For every assigned arch, the full-
width parameter tree (the port's on the meta device, the reference's
from ``jax.eval_shape``) gets the same spec at every path, on the
(16, 16) and (2, 16, 16) meshes, with ``params_tp_only`` on and off; the
caches at ``decode_32k`` and ``long_500k`` likewise; ``fit_spec``'s
cases, ``batch_spec``, ``local_shape`` and ``validate_divisibility``'s
messages.  Tolerance: exact.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.runtime import elastic as JE
from repro.sharding.specs import MeshSpec as JMeshSpec
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.configs import shape_applicable
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as M
from repro_torch.runtime import elastic
from repro_torch.sharding.specs import LogicalMesh, MeshSpec, fit_spec
from repro_torch.tree import items, map_tree

META = torch.device("meta")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _stub(mesh, params_tp_only=False) -> JMeshSpec:
    shape, names = MESHES[mesh] if isinstance(mesh, str) else mesh

    class StubMesh:
        axis_names = names

    StubMesh.shape = dict(zip(names, shape))
    obj = object.__new__(JMeshSpec)
    object.__setattr__(obj, "mesh", StubMesh())
    object.__setattr__(obj, "params_tp_only", params_tp_only)
    return obj


def _ms(mesh, params_tp_only=False) -> MeshSpec:
    shape, names = MESHES[mesh] if isinstance(mesh, str) else mesh
    return MeshSpec(LogicalMesh(shape, names), params_tp_only)


def _jpath(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k))))
                    for k in kp)


@functools.lru_cache(maxsize=None)
def _j_params(arch):
    cfg = j_get_config(arch)
    tree = jax.eval_shape(lambda: JM.init_params(cfg,
                                                 jax.random.PRNGKey(0)))
    return {_jpath(kp): leaf for kp, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _t_params(arch):
    return M.init_params(get_config(arch), torch.Generator(), None, META)


def _t_specs(tree, specs) -> dict:
    out = []
    map_tree(lambda t, s: out.append(s), tree, specs)
    return dict(zip([p for p, _ in items(tree)], out))


def test_fit_spec_divisibility():
    mesh = LogicalMesh((16, 16))
    assert fit_spec(mesh, (64, 128), [("data",), ("model",)]) == \
        ("data", "model")
    # 56 doesn't divide 16 → replicated
    assert fit_spec(mesh, (56, 128), [("model",), ()]) == ()
    # tuple axes: 512 % (16*16) == 0
    assert fit_spec(mesh, (512,), [(("data", "model"),)]) == \
        (("data", "model"),)
    # axis used once only
    assert fit_spec(mesh, (32, 32), [("model",), ("model",)]) == ("model",)
    # fallback order: first candidate that divides wins
    assert fit_spec(mesh, (8, 32), [("model", "data"), ()]) == ()
    assert fit_spec(mesh, (32, 8), [("model",), ("data",)]) == ("model",)


def test_logical_mesh_and_production_meshes():
    assert LogicalMesh((1, 1)).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        LogicalMesh((2, 16, 16))
    for multi_pod, key in ((False, "16x16"), (True, "2x16x16")):
        mesh = TMESH.make_production_mesh(multi_pod=multi_pod)
        shape, names = MESHES[key]
        assert mesh.axis_names == names
        assert tuple(mesh.shape.values()) == shape
        ms = TMESH.make_mesh_spec(multi_pod=multi_pod)
        assert ms.mesh == mesh and not ms.params_tp_only
        assert ms.dp == _stub(key).dp and ms.tp == "model"


@pytest.mark.parametrize("tp_only", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, tp_only):
    want = {path: tuple(_stub(mesh, tp_only).param_spec(path, leaf.shape))
            for path, leaf in _j_params(arch).items()}
    params = _t_params(arch)
    ms = _ms(mesh, tp_only)
    got = _t_specs(params, ms.param_specs(params))
    assert got == want
    shapes = {p: tuple(t.shape) for p, t in items(params)}
    assert shapes == {p: tuple(leaf.shape)
                      for p, leaf in _j_params(arch).items()}
    for path, t in items(params):       # every sharded dim divides
        spec = got[path]
        local = ms.local_shape(t.shape, spec)
        for d, loc, axes in zip(t.shape, local, spec + (None,) * 8):
            n = 1 if axes is None else int(np.prod(
                [ms.mesh.shape[a] for a in (axes if isinstance(axes, tuple)
                                            else (axes,))]))
            assert d % n == 0 and loc * n == d, (path, t.shape, spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ASSIGNED_ARCHS for s in ("decode_32k", "long_500k")
    if shape_applicable(get_config(a), SHAPES[s])[0]])
def test_cache_specs_equal_the_reference(arch, shape, mesh):
    cfg, sh = get_config(arch), SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    jcfg = j_get_config(arch)
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, S))
    jspecs = _stub(mesh).cache_pspecs(jcfg, jcache)
    want = {_jpath(kp): tuple(s) for kp, s in
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, P))[0]}
    cache = M.init_cache(cfg, B, S, device=META)
    got = _t_specs(cache, _ms(mesh).cache_pspecs(cfg, cache))
    assert got == want
    jshapes = {_jpath(kp): tuple(leaf.shape) for kp, leaf in
               jax.tree_util.tree_flatten_with_path(jcache)[0]}
    assert {p: tuple(t.shape) for p, t in items(cache)} == jshapes


def test_batch_spec_and_local_shape():
    for mesh in MESHES:
        ms, js = _ms(mesh), _stub(mesh)
        for name, shape in (("tokens", (256, 4096)), ("token", (128, 1)),
                            ("lengths", (128,)), ("tokens", (1, 524288)),
                            ("enc_frames", (256, 1500, 1280)),
                            ("tokens", (8, 448))):
            assert ms.batch_spec(name, shape) == \
                tuple(js.batch_spec(name, shape)), (mesh, name, shape)
    ms = _ms("2x16x16")
    assert ms.batch_spec("tokens", (256, 4096)) == (("pod", "data"),)
    assert ms.local_shape((256, 4096), (("pod", "data"),)) == (8, 4096)
    assert ms.local_shape((64, 160, 5120), (None, "model", "data")) == \
        (64, 10, 320)
    assert ms.local_shape((7, 3), ()) == (7, 3)


def test_tp_only_variant_drops_dp():
    spec = _ms("16x16", True).param_spec("blocks/ffn/w_in",
                                         (52, 6144, 24576))
    assert "data" not in str(spec)
    spec = _ms("16x16").param_spec("blocks/ffn/w_in", (52, 6144, 24576))
    assert "data" in str(spec)


def test_expert_weight_specs():
    ms = _ms("16x16")
    assert ms.param_spec("blocks/moe/w_in", (59, 160, 5120, 1536)) == \
        (None, "model", "data")
    assert ms.param_spec("blocks/moe/w_out", (59, 160, 1536, 5120)) == \
        (None, "model", None, "data")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_validate_divisibility_messages(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for mesh in (MESHES["16x16"], ((3, 12), ("data", "model")),
                 ((2, 5, 7), ("pod", "data", "model"))):
        for batch in (256, 100, 1, 30):
            assert elastic.validate_divisibility(cfg, _ms(mesh), batch) \
                == JE.validate_divisibility(jcfg, _stub(mesh), batch)
    assert elastic.validate_divisibility(cfg, _ms("16x16"), 100) == \
        ["global_batch 100 % dp 16 != 0"]


# --------------------------------------------------------------------------- #
# Placements over a DeviceMesh (a fake process group of 512 ranks)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def fake_meshes():
    """The production meshes as ``DeviceMesh``es over a fake process group
    of 512 ranks (this process rank 0), made and torn down here."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield {name: DeviceMesh("cpu", torch.arange(
            int(np.prod(shape))).reshape(shape), mesh_dim_names=names)
               for name, (shape, names) in MESHES.items()}
    finally:
        dist.destroy_process_group()


def _local(shape, mesh, placements, coord):
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    return _compute_local_shape_and_global_offset(
        shape, tuple(mesh.shape), list(coord), placements)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_placements_give_the_local_shapes_of_the_specs(fake_meshes, arch,
                                                       mesh):
    """``MeshSpec`` over a ``DeviceMesh``: ``named(spec)`` of every
    parameter and cache leaf gives, on rank 0 and on the last rank, the
    local shape ``local_shape`` computes from the same spec, and the
    ``*_shardings`` trees hold those placements."""
    dm = fake_meshes[mesh]
    ms = MeshSpec(dm)
    assert ms.device_mesh is dm and ms.mesh == _ms(mesh).mesh
    cfg = get_config(arch)
    params = _t_params(arch)
    specs = ms.param_specs(params)
    shardings = ms.params_shardings(params)
    last = [s - 1 for s in dm.shape]
    pairs = []
    map_tree(lambda t, s, sh: pairs.append((t, s, sh)), params, specs,
             shardings)
    sh = SHAPES["decode_32k"]
    if shape_applicable(cfg, sh)[0]:
        cache = M.init_cache(cfg, sh.global_batch, sh.seq_len, device=META)
        map_tree(lambda t, s, pl: pairs.append((t, s, pl)), cache,
                 ms.cache_pspecs(cfg, cache), ms.cache_shardings(cfg, cache))
    for t, spec, placed in pairs:
        assert placed.mesh is dm and placed.placements == \
            ms.placements(spec)
        want = ms.local_shape(t.shape, spec)
        for coord in ([0] * dm.ndim, last):
            got, _ = _local(tuple(t.shape), dm, placed.placements, coord)
            assert tuple(got) == want, (spec, coord)


def test_two_axes_on_one_dim_split_major_to_minor(fake_meshes):
    """``("pod", "data")`` on a dim: rank (p, d, m) holds block p * 16 + d
    of 32, as JAX lays out ``P(("pod", "data"))``; ``("data", "model")``
    likewise d * 16 + m; an order against the mesh's is refused."""
    dm = fake_meshes["2x16x16"]
    ms = MeshSpec(dm)
    batch = {"tokens": torch.empty((256, 4096), device=META)}
    placed = ms.batch_shardings(batch)["tokens"]
    assert ms.batch_spec("tokens", (256, 4096)) == (("pod", "data"),)
    for p in range(2):
        for d in range(16):
            shape, off = _local((256, 4096), dm, placed.placements,
                                [p, d, 5])
            assert shape == (8, 4096) and off == ((p * 16 + d) * 8, 0)
    pl = ms.placements((None, ("data", "model")))
    for d, m in ((0, 1), (3, 7), (15, 15)):
        shape, off = _local((4, 32768), dm, pl, [1, d, m])
        assert shape == (4, 128) and off == (0, (d * 16 + m) * 128)
    with pytest.raises(ValueError, match="mesh's order"):
        ms.placements((("model", "data"),))


def test_constrain_redistributes_dtensors_and_passes_the_rest(fake_meshes):
    """``constrain(x, kind)`` moves a DTensor to the rule's layout and
    returns a plain tensor, or a kind no rule names, unchanged."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dm = fake_meshes["16x16"]
    ms = MeshSpec(dm)
    x = torch.empty((32, 64, 48), device=META)
    assert ms.constrain(x, "resid") is x
    dx = DTensor.from_local(torch.empty((32, 64, 48), device=META), dm,
                            [Replicate(), Replicate()], run_check=False)
    assert ms.constrain(dx, "resid").placements == (Shard(0), Shard(1))
    assert ms.constrain(dx, "logits").placements == (Shard(0), Shard(2))
    assert ms.constrain(dx, "no such rule") is dx
    assert ms.activation_spec("resid", (32, 1, 48)) == ("data", None,
                                                        "model")
    with pytest.raises(ValueError, match="DeviceMesh"):
        _ms("16x16").named(("data",))


def test_reshape_replicates_only_the_views_dtensor_refuses(fake_meshes):
    """``layers.reshape`` on a DTensor: a view its layout keeps (448
    heads over 16 ranks) is DTensor's own and gathers nothing; one it
    cannot (56 heads over 16) is replicated over ``model`` first, the
    batch kept sharded, and counted in ``RESHAPE_GATHERS``; any other
    error (a size that does not match) is raised as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models import layers as L
    dm = fake_meshes["16x16"]
    x = DTensor.from_local(torch.empty((1, 8, 448), device=META), dm,
                           [Shard(0), Shard(2)], run_check=False)
    L.RESHAPE_GATHERS.clear()
    kept = L.reshape(x, 16, 8, 448, 16)
    assert kept.placements == (Shard(0), Shard(2))
    assert not L.RESHAPE_GATHERS
    heads = L.reshape(x, 16, 8, 56, 128)
    assert heads.shape == (16, 8, 56, 128)
    assert heads.placements == (Shard(0), Replicate())
    assert L.RESHAPE_GATHERS == {
        "(16, 8, 7168) -> (16, 8, 56, 128)": 1}
    with pytest.raises(RuntimeError, match="invalid for input of size"):
        L.reshape(x, 16, 8, 57, 128)
    assert sum(L.RESHAPE_GATHERS.values()) == 1
