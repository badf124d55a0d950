"""The port's sharded paths on a gloo mesh of 4 CPU processes, against the
JAX reference on one device.

The legs of tests/test_multidevice.py, through ``repro_torch`` on a
``DeviceMesh`` (data 2, model 2) of 4 processes joined by gloo, each with
one torch thread.  The children start once for the whole file (``python -c``,
never fork: this process holds JAX), join through
``launch.mesh.init_distributed`` from torchrun's environment on a port
bound here first, run every leg and write their results; each asserts that
``jax`` is not in ``sys.modules``.  The oracles are the reference's
single-device values, computed in this process meanwhile, from the same
weights (``bridge``) and inputs:

* the MoE loss under ``production=True`` (``moe_sharded``: experts over
  'model', FSDP over 'data', capacity factor 8) against the reference's
  dense loss: < 2e-3, no token dropped;
* the decode logits after a prefill on the sequence-sharded ring (32
  slots, 16 a model rank), bf16-free float32, plain and int8 caches,
  against the reference's unsharded decode: < 2e-3;
* the trainer's 3 losses on the mesh against the reference's single-device
  ``Trainer``: < 2e-3, once with ``seq_shard`` (the residual stream
  S-sharded over 'model') and once with int8 gradient compression on the
  global leaves' rows;
* ``compressed_psum_mean`` over 'data' within ``max|g| / 127 * 1.5`` of the
  true mean, as the reference's test bounds it;
* ``compression.round_trip_sharded_`` on ``DTensor`` leaves equal, shard
  for shard, to ``round_trip_`` on the whole leaves, where the rank's
  block is whole rows and where it would cut one;
* the elastic restore: the compressed trainer's final state saved on the
  (2, 2) plan restores onto the fused (1, 4) and scale_out (4, 1) plans,
  every leaf equal.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402

WORLD = 4
TOL = 2e-3
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

CHILD = r"""
import dataclasses, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import pytree
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.fusion import MeshPlan, plan_family
from repro_torch.launch import mesh as meshlib
from repro_torch.models import transformer as T
from repro_torch.parallel import compression as C
from repro_torch.parallel import shardctx
from repro_torch.train import Trainer

D = os.environ["DIST_DIR"]
assert meshlib.init_distributed() == "gloo"
rank = torch.distributed.get_rank()
base = MeshPlan("base", data=2, model=2)
mesh = base.build()
out = {"data": mesh.get_local_rank("data"),
       "model": mesh.get_local_rank("model")}


def load(like, name):
    with np.load(os.path.join(D, name + ".npz")) as z:
        return pytree.unflatten(like, iter(
            torch.from_numpy(z[k].copy())
            for k in pytree.flatten_with_paths(like)))


def on_mesh(cfg, params):
    return shardctx.layout_tree(params, T.model_pspecs(cfg)[1], mesh)


# MoE: moe_sharded under production
cfg = get_config("deepseek-moe-16b", reduced=True).replace(dtype="float32")
cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
moe_params = on_mesh(cfg, load(T.init_model(cfg, torch.Generator(), "meta"),
                               "moe"))
tokens = torch.from_numpy(np.load(os.path.join(D, "moe_tokens.npy"))).long()
with torch.no_grad(), shardctx.use_mesh(mesh):
    loss, met = T.loss_fn(moe_params, {"tokens": shardctx.batch_shard(tokens)},
                          cfg, T.Runtime(production=True, remat=False))
out["moe"] = {"loss": float(loss), "dropped": float(met["dropped_frac"]),
              "load": met["expert_load"].tolist()}

# decode on the sequence-sharded ring
cfg2 = get_config("qwen3-14b", reduced=True).replace(dtype="float32")
like2 = T.init_model(cfg2, torch.Generator(), "meta")
dense = on_mesh(cfg2, load(like2, "dense"))
toks = shardctx.batch_shard(torch.from_numpy(
    np.load(os.path.join(D, "dec_tokens.npy"))).long(), mesh)
for quant in (False, True):
    rt = T.Runtime(production=True, remat=False, kv_quant=quant)
    with torch.no_grad(), shardctx.use_mesh(mesh):
        _, st = T.prefill(dense, {"tokens": toks}, cfg2, rt, window=32)
        k0 = st.reps[0]["self"].k
        out["ring"] = [k0.shape[2], shardctx.local(k0).shape[2]]
        lg1, _ = T.decode_step(dense, st, toks[:, :1], cfg2, rt)
    out[f"decode_q{int(quant)}"] = lg1.tolist()

# the trainer on the mesh, from the reference's initial state
shape = ShapeConfig("t", 32, 4, "train")
for name, comp, seq in (("plain", False, True), ("compress", True, False)):
    tcfg = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=1e-3,
                       grad_compression=comp)
    tr = Trainer(cfg2, shape, tcfg, mesh=mesh, device="cpu",
                 rt=T.Runtime(production=True, remat=True, seq_shard=seq))
    state = tr.place_state(load(tr._restore_template(), "state_" + name))
    res = tr.train(3, state=state)
    out["train_" + name] = [[m.loss, m.grad_norm] for m in res["history"]]

# the elastic restore of the last state onto the other plans
state = res["state"]
ckpt = CheckpointManager(os.path.join(D, "ckpt"))
ckpt.save(3, state, blocking=True)
ckpt.wait()
saved = {k: shardctx.full(v) for k, v in
         pytree.flatten_with_paths(state).items()}
out["restore"] = {}
for plan_name in ("fused", "scale_out"):
    plan = plan_family(base)[plan_name]
    m2 = plan.build()
    t2 = Trainer(cfg2, shape, tcfg, mesh=m2, device="cpu")
    got = pytree.flatten_with_paths(t2._restore(ckpt))
    shapes = sorted({str(list(shardctx.local(v).shape)) for v in got.values()
                     if shardctx.is_dtensor(v)})
    equal = sorted(k for k, v in got.items()
                   if torch.equal(shardctx.full(v), saved[k]))
    out["restore"][plan_name] = {"mesh": list(plan.shape), "leaves": len(got),
                                 "equal": len(equal), "local_shapes": shapes}

# the sharded round trip against the whole leaf's, bit for bit: row-
# aligned blocks (one gather), and leaves whose blocks would cut a row
# (gathered whole)
rng = np.random.default_rng(12)
out["sharded_round_trip"] = []
for shape, spec in (((2, 16, 3072), (None, "data", "model")),
                    ((8, 1536), ("data", "model")),
                    ((6, 700), ("model", "data")),
                    ((4, 50), ("data", "model")),
                    ((2, 4, 2048), (None, "model", "data"))):
    gw = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    rw = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) / 9
    g_, r_ = (shardctx.layout(t, mesh, shardctx.P(*spec)) for t in (gw, rw))
    C.round_trip_sharded_(g_, r_)
    C.round_trip_(gw, rw)
    out["sharded_round_trip"].append(all(
        torch.equal(shardctx.local(t), shardctx.shard_of(w, mesh,
                                                         t.placements))
        for t, w in ((g_, gw), (r_, rw))))

# the int8 all-reduce over 'data'
g = np.load(os.path.join(D, "grad.npy"))
d = out["data"]
with shardctx.use_mesh(mesh):
    mean, res_ = C.compressed_psum_mean(
        {"g": torch.from_numpy(g[4 * d:4 * d + 4].copy())}, "data")
out["compress"] = mean["g"].tolist()

out["jax_imported"] = "jax" in sys.modules
assert not out["jax_imported"]
with open(os.path.join(D, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _save(path, tree):
    np.savez(path, **{k: v.numpy() for k, v in
                      pytree.flatten_with_paths(tree).items()})


def _ref_train(cfg, comp):
    tcfg = JTrain(total_steps=3, warmup_steps=1, learning_rate=1e-3,
                  grad_compression=comp)
    tr = JTrainer(cfg, JShape("t", 32, 4, "train"), tcfg,
                  rt=JT.Runtime(production=False, remat=True))
    state = tr.init_state(tcfg.seed)
    host = bridge.train_state_from_numpy(jax.tree.map(np.asarray, state),
                                         device="cpu")
    return tr, state, host


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
    # weights and inputs, the reference's, for the children
    mcfg = jget_config("deepseek-moe-16b", reduced=True).replace(
        dtype="float32")
    mcfg = mcfg.replace(moe=dataclasses.replace(mcfg.moe,
                                                capacity_factor=8.0))
    mp, _ = JT.init_model(jax.random.PRNGKey(0), mcfg)
    _save(os.path.join(d, "moe"), bridge.params_from_numpy(
        jax.tree.map(np.asarray, mp), device="cpu"))
    mtok = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0,
                                         mcfg.vocab_size))
    np.save(os.path.join(d, "moe_tokens.npy"), mtok)
    dcfg = jget_config("qwen3-14b", reduced=True).replace(dtype="float32")
    dp, _ = JT.init_model(jax.random.PRNGKey(0), dcfg)
    _save(os.path.join(d, "dense"), bridge.params_from_numpy(
        jax.tree.map(np.asarray, dp), device="cpu"))
    dtok = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (4, 24), 0,
                                         dcfg.vocab_size))
    np.save(os.path.join(d, "dec_tokens.npy"), dtok)
    trainers = {}
    for name, comp in (("plain", False), ("compress", True)):
        trainers[name] = _ref_train(dcfg, comp)
        _save(os.path.join(d, "state_" + name), trainers[name][2])
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (8, 16, 64)))
    np.save(os.path.join(d, "grad.npy"), g)

    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, PYTHONPATH=SRC, DIST_DIR=d, RANK=str(r),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env.pop("LOCAL_RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    # the oracles, while the children run
    rt = JT.Runtime(production=False, remat=False)
    oracle = {"moe": float(JT.loss_fn(mp, {"tokens": mtok}, mcfg, rt)[0])}
    for quant in (False, True):
        r = rt._replace(kv_quant=quant)
        _, st = JT.prefill(dp, {"tokens": dtok}, dcfg, r, window=32)
        lg1, _ = JT.decode_step(dp, st, dtok[:, :1], dcfg, r)
        oracle[f"decode_q{int(quant)}"] = np.asarray(lg1)
    for name, (tr, state, _) in trainers.items():
        hist = tr.train(3, state=state)["history"]
        oracle["train_" + name] = [[m.loss, m.grad_norm] for m in hist]
    oracle["grad"] = g

    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-6000:]}"
    outs = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return oracle, outs


def test_children_never_import_jax(run):
    _, outs = run
    assert [o["jax_imported"] for o in outs] == [False] * WORLD
    assert sorted((o["data"], o["model"]) for o in outs) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_moe_sharded_loss_matches_dense(run):
    oracle, outs = run
    for o in outs:
        assert abs(o["moe"]["loss"] - oracle["moe"]) < TOL, \
            (o["moe"]["loss"], oracle["moe"])
        assert o["moe"]["dropped"] == 0.0
        assert abs(sum(o["moe"]["load"]) - 1.0) < 1e-5
        assert o["moe"]["load"] == outs[0]["moe"]["load"]


@pytest.mark.parametrize("quant", [0, 1])
def test_seq_sharded_decode_matches_unsharded(run, quant):
    oracle, outs = run
    want = oracle[f"decode_q{quant}"]
    for o in outs:
        assert o["ring"] == [32, 16], o["ring"]     # slots: ring, shard
        got = np.asarray(o[f"decode_q{quant}"])
        rows = want[2 * o["data"]:2 * o["data"] + 2]
        err = float(np.max(np.abs(got - rows)))
        assert err < TOL, (o["data"], o["model"], err)


@pytest.mark.parametrize("name", ["plain", "compress"])
def test_trainer_on_mesh_matches_single_device(run, name):
    oracle, outs = run
    want = oracle["train_" + name]
    for o in outs:
        got = o["train_" + name]
        assert len(got) == len(want) == 3
        for (gl, gn), (wl, wn) in zip(got, want):
            assert abs(gl - wl) < TOL, (name, got, want)
            assert abs(gn - wn) < TOL * max(1.0, wn), (name, got, want)


def test_sharded_round_trip_equals_the_whole_leaf(run):
    _, outs = run
    for o in outs:
        assert o["sharded_round_trip"] == [True] * 5, o["sharded_round_trip"]


def test_compressed_mean_within_bound(run):
    oracle, outs = run
    g = oracle["grad"]
    true = g.reshape(2, 4, 16, 64).mean(axis=0)
    bound = float(np.max(np.abs(g))) / 127.0 * 1.5
    for o in outs:
        err = float(np.max(np.abs(np.asarray(o["compress"]) - true)))
        assert err <= bound, (err, bound)
    # the mean is the same on every rank of the axis
    assert all(o["compress"] == outs[0]["compress"] for o in outs)


def test_elastic_restore_onto_other_plans(run):
    _, outs = run
    for o in outs:
        for plan, want_mesh in (("fused", [1, 4]), ("scale_out", [4, 1])):
            r = o["restore"][plan]
            assert r["mesh"] == want_mesh
            assert r["equal"] == r["leaves"] > 0, r
            assert len(r["local_shapes"]) > 1, r
