"""repro_torch's partition specs, their resolution and the MoE capacity
buffer against the JAX reference, in one process on the CPU.

* ``model_pspecs``: the spec tree equals the reference's path for path,
  for every arch of ``configs``, full and reduced, and the ``meta``
  parameters' shapes and dtypes equal the reference's ``eval_shape``.
* ``resolve``: ``resolve_spec`` / ``resolve_spec_for`` / ``spec_tree`` /
  ``resolve_tree(_for)`` equal the reference's exactly on abstract (2, 4),
  (16, 16) and (2, 16, 16) meshes ("batch" expansion, absent axes dropped,
  indivisible dimensions replicated: whisper's 51,865 vocab), for single
  specs and for whole models; ``to_placements`` as ``DTensor`` lays them.
* ``adamw_pspecs`` and ``decode_state_pspecs`` equal the reference's.
* ``_moe_local`` without a mesh (all experts, and one model rank's half)
  against the reference's in float32: ``y`` within 1e-5 of its largest
  magnitude, ``load`` within 1e-6, ``dropped`` equal, at capacity factor 8
  (nothing dropped) and at one small enough that tokens drop.
* ``MeshPlan.build`` on a one-rank gloo group refuses a plan larger than
  the world.
* a checkpointed block's recomputation, run on another thread as the
  card's autograd runs it, sees the mesh of its forward.
"""
import dataclasses
import math
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw_pspecs as jadamw_pspecs  # noqa: E402
from repro.parallel import resolve as jresolve  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.fusion import MeshPlan  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw_pspecs  # noqa: E402
from repro_torch.parallel import resolve, shardctx  # noqa: E402
from repro_torch.parallel.shardctx import P  # noqa: E402

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
SPECS = [P("batch"), P("batch", None), P("batch", None, "model", None),
         P("batch", "model", None, None), P("data", "model"),
         P("model", "data"), P("model", "data", None),
         P("model", None, "data"), P(None, "model"), P(("data", "model")),
         P(("pod", "data"), None), P("pod", "model"), P(None), P()]
SHAPES = [(32, 5120), (51865, 512), (1, 2304, 8, 128), (64, 256, 8, 128),
          (40, 5120, 17408), (12, 51865), (3,)]


def _flat(tree):
    """The reference's spec tree by the checkpoint's path strings."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP) or x is None)[0]:
        if leaf is None:
            continue
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = tuple(leaf)
    return out


def _port_flat(tree):
    return {k: tuple(v) for k, v in pytree.flatten_with_paths(tree).items()}


def _meshes(shape, axes):
    return JMesh(shape, axes), resolve.AbstractMesh(shape, axes)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_pspecs_match_reference(arch, reduced):
    jshapes, jspecs = JT.model_pspecs(jget_config(arch, reduced=reduced))
    params, specs = T.model_pspecs(get_config(arch, reduced=reduced))
    want, got = _flat(jspecs), _port_flat(specs)
    assert got == want
    shapes = pytree.flatten_with_paths(params)
    for k, s in jax.tree_util.tree_flatten_with_path(jshapes)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in k)
        assert shapes[key].device.type == "meta"
        assert tuple(shapes[key].shape) == tuple(s.shape), key
        assert str(shapes[key].dtype).replace("torch.", "") == str(s.dtype)
    # the whole model resolved on each mesh, shape-aware and not
    for mshape, axes in MESHES:
        jm, m = _meshes(mshape, axes)
        assert _port_flat(resolve.spec_tree(specs, m)) == \
            _flat(jresolve.spec_tree(jspecs, jm))
        got = pytree.flatten_with_paths(resolve.resolve_tree_for(
            params, specs, m))
        want = jresolve.resolve_tree_for(jshapes, jspecs, jm)
        for k, ns in jax.tree_util.tree_flatten_with_path(want)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in k)
            assert tuple(got[key].spec) == tuple(ns.spec), key


@pytest.mark.parametrize("mshape,axes", MESHES)
def test_resolve_spec_matches_reference(mshape, axes):
    jm, m = _meshes(mshape, axes)
    for spec in SPECS:
        jspec = JP(*spec)
        for bs in (None, 1, 2, 8, 32, 64):
            assert tuple(resolve.resolve_spec(spec, m, bs)) == \
                tuple(jresolve.resolve_spec(jspec, jm, bs)), (spec, bs)
            for shape in SHAPES:
                got = resolve.resolve_spec_for(shape, spec, m, bs)
                want = jresolve.resolve_spec_for(shape, jspec, jm, bs)
                assert tuple(got) == tuple(want), (spec, bs, shape)
    tree = {"a": P("batch", None), "b": (P("model", "data"), P(None))}
    jtree = {"a": JP("batch", None), "b": (JP("model", "data"), JP(None))}
    got = resolve.resolve_tree(tree, m, 8)
    want = jresolve.resolve_tree(jtree, jm, 8)
    assert tuple(got["a"].spec) == tuple(want["a"].spec)
    assert [tuple(x.spec) for x in got["b"]] == \
        [tuple(x.spec) for x in want["b"]]


def test_placements_follow_the_resolved_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = resolve.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    spec = resolve.resolve_spec(P("batch", None, "model"), m)
    assert tuple(spec) == (("pod", "data"), None, "model")
    assert resolve.to_placements(spec, m) == [Shard(0), Shard(0), Shard(2)]
    m2 = resolve.AbstractMesh((2, 4), ("data", "model"))
    assert resolve.to_placements(P("model", None, "data"), m2) == \
        [Shard(2), Shard(0)]
    assert resolve.to_placements(P(None), m2) == [Replicate(), Replicate()]
    with pytest.raises(ValueError):
        resolve.to_placements(P("data", "data"), m2)


@pytest.mark.parametrize("arch", ["qwen3-14b", "whisper-base",
                                  "falcon-mamba-7b", "recurrentgemma-9b"])
def test_adamw_and_decode_state_pspecs_match_reference(arch):
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch,
                                                            reduced=True)
    _, specs = T.model_pspecs(cfg)
    _, jspecs = JT.model_pspecs(jcfg)
    assert _port_flat(adamw_pspecs(specs)) == _flat(jadamw_pspecs(jspecs))
    for quant in (False, True):
        assert _port_flat(T.decode_state_pspecs(cfg, quant)) == \
            _flat(JT.decode_state_pspecs(jcfg, quant))


def test_hint_and_mesh_context_without_a_mesh():
    x = torch.ones(2, 3)
    assert shardctx.current_mesh() is None
    assert shardctx.hint(x, "batch", None) is x
    assert shardctx.named_sharding("batch") is None
    assert shardctx.batch_axes() == () and shardctx.model_axes() == ()
    assert shardctx.gather(x) is x and shardctx.batch_shard(x) is x
    with shardctx.use_mesh(resolve.AbstractMesh((2, 4), ("data", "model"))):
        assert shardctx.batch_axes() == ("data",)
        assert shardctx.model_axes() == ("model",)
        assert shardctx.named_sharding("batch", None).spec == \
            P(("data",), None)
        with pytest.raises(ValueError):
            shardctx.hint(x, "pod", None)
    assert shardctx.current_mesh() is None


def _moe_case(cf):
    jcfg = jget_config("deepseek-moe-16b", reduced=True).replace(
        dtype="float32")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=cf))
    cfg = get_config("deepseek-moe-16b", reduced=True).replace(
        dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(4), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(5).standard_normal(
        (64, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, tp, x


@pytest.mark.parametrize("cf", [8.0, 0.25])
@pytest.mark.parametrize("half", [False, True])
def test_moe_local_matches_reference(cf, half):
    jcfg, cfg, jp, tp, x = _moe_case(cf)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = int(math.ceil(x.shape[0] * k / E * cf))
    e_start, e_local = (E // 2, E // 2) if half else (0, E)
    jbank = {n: w[e_start:e_start + e_local]
             for n, w in jp["experts"].items()}
    tbank = {n: w[e_start:e_start + e_local]
             for n, w in tp["experts"].items()}
    jy, jaux = jmoe._moe_local(dict(jp, experts=jbank), jnp.asarray(x), jcfg,
                               e_start, e_local, cap, None, None)
    ty, taux = moe._moe_local(dict(tp, experts=tbank), torch.from_numpy(x),
                              cfg, e_start, e_local, cap)
    jy = np.asarray(jy)
    scale = float(np.max(np.abs(jy)))
    assert float(np.max(np.abs(ty.numpy() - jy))) <= 1e-5 * scale
    np.testing.assert_allclose(taux.load.numpy(), np.asarray(jaux.load),
                               atol=1e-6)
    assert float(taux.dropped) == float(jaux.dropped)
    assert abs(float(taux.aux_loss) - float(jaux.aux_loss)) < 1e-5
    if cf < 1:
        assert float(taux.dropped) > 0.0
    elif not half:
        assert float(taux.dropped) == 0.0


def test_mesh_plan_build_refuses_a_plan_larger_than_the_world():
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{port}")
    try:
        with pytest.raises(ValueError):
            MeshPlan("base", data=2, model=2).build()
        mesh = MeshPlan("one", data=1, model=1).build("cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        t = shardctx.layout(torch.arange(6.).reshape(2, 3), mesh,
                            P("data", "model"))
        assert torch.equal(shardctx.full(t), torch.arange(6.).reshape(2, 3))
    finally:
        dist.destroy_process_group()


def test_remat_recompute_reinstalls_the_mesh_on_another_thread():
    """On the card autograd runs the backward, and so a checkpoint's
    recomputation, on its device thread, where the thread-local mesh is
    unset: ``_remat`` reinstalls the mesh current at the call."""
    import threading
    mesh = resolve.AbstractMesh((2, 2), ("data", "model"))
    seen = []

    def f(x):
        seen.append(shardctx.current_mesh())
        return (x * x).sum()                 # saves x: recomputed

    x = torch.ones(3, requires_grad=True)
    with shardctx.use_mesh(mesh):
        y = T._remat(f, x)
    t = threading.Thread(target=y.backward)
    t.start()
    t.join()
    assert seen == [mesh, mesh]
    assert torch.equal(x.grad, 2 * torch.ones(3))
