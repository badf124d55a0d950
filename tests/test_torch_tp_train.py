"""The tensor-parallel training path on gloo meshes of 4 CPU processes,
against the JAX reference on one device and its compiled sharded program.

Under a mesh whose 'model' axis has more than one rank, ``loss_fn`` and
``logits_fn`` (and so the sharded ``Trainer``) compute the self-attention,
the dense MLP, the MoE's shared experts, the embedding lookup and the LM
head on each rank's 'model' shard of the weights, as the reference's specs
divide them, and the LM loss is vocab-parallel.  Four children (``python
-c``, gloo, one torch thread each, ``jax`` never imported) run on a (data
2, model 2) and a (data 1, model 4) mesh.  Their results are held to the
reference's single-device values from the same weights (``bridge``) and
tokens, computed in this process meanwhile:

* the loss and every leaf's gradient through ``Trainer.loss_and_grads``
  (remat on, 4 loss chunks): reduced float32 qwen3-14b as it is (2 KV
  heads: ``wk`` / ``wv`` replicated) and with 8 / 4 heads (split), on both
  meshes; on (2, 2) also deepseek-moe-16b (``moe_sharded``, capacity factor
  8, its 2 shared experts on shards), falcon-mamba-7b (the tied table: a
  row-parallel head, then the vocab-parallel loss; SSM mixers on shards),
  whisper-base (encoder and decoder self-attention and the
  cross-attention on shards; its vocabulary made odd, 515, as the full
  51,865 is, so the model axis does not divide V and the loss runs on
  whole logits) and recurrentgemma-9b (MQA attention, its one KV head
  replicated, beside RG-LRU mixers on shards).
  Each rank's gradient shard is held to the same slice of ``jax.grad`` of
  the reference's ``loss_fn`` (for the MoE: of its mean over the two data
  shards' rows, whose routing aux terms are per shard as in the
  reference's ``moe_sharded``; the whole batch's aux moves deepseek's
  gradients by up to ~4e-4 of a leaf's largest).  The loss, against the
  reference's on the whole batch, within 2e-3 (as
  ``tests/test_multidevice.py``), each gradient within 1e-4 of its leaf's
  largest magnitude (the single-device training tolerance of
  ``tests/test_torch_train.py``);
* ``logits_fn`` on (2, 2), both qwen3 configs: the rank's rows, within 2e-3;
* the vocab-parallel NLL of one chunk (``transformer._vocab_parallel_nll``
  on the rank's V / n columns of the same logits) against the reference's
  whole-logits NLL, with targets spread over every rank's range and with
  every target in rank 0's range (none in any other's), some positions
  masked out.

Rank 0's counted FLOPs (``core.step_count`` on a ``fake`` (2, 2) group, a
fifth child) of one reduced qwen3-14b train step are held within 5 % (the
train tolerance of ``tests/test_torch_dryrun.py``) of the reference's
``hlo_analysis`` of the same step compiled for a (2, 2) mesh of 4 host
devices (a sixth child).  Both children are ``tests/test_torch_tp.py``'s,
run for the train cell.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from test_torch_tp import _free_port, _save, start_counts  # noqa: E402

WORLD = 4
LOSS_TOL = 2e-3
GRAD_REL = 1e-4
LOGITS_TOL = 2e-3
NLL_TOL = 1e-4
FLOPS_REL = 0.05
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S, CHUNK = 4, 32, 8              # 31 targets in 4 chunks (one padded)
QWEN = ("replicated_kv", "split_kv")
FAMILIES = ("deepseek-moe-16b", "falcon-mamba-7b", "whisper-base",
            "recurrentgemma-9b")
LEGS = [("2x2", c) for c in QWEN + FAMILIES] + [("1x4", c) for c in QWEN]
# the vocab-parallel NLL's logits: (B, c, V), V split 2 and 4 ways
NLL_SHAPE = (3, 5, 64)
# whisper-base's V (51,865) is odd; the reduced 512 would divide
WHISPER_V = 515


def _cfg(get, name):
    """The reduced float32 configs, by the same rules in both packages."""
    if name in QWEN:
        cfg = get("qwen3-14b", reduced=True).replace(dtype="float32")
        return cfg if name == "replicated_kv" else cfg.replace(
            num_heads=8, num_kv_heads=4)
    cfg = get(name, reduced=True).replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    if cfg.encoder_layers:
        cfg = cfg.replace(vocab_size=WHISPER_V)
    return cfg


CHILD = r"""
import dataclasses, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.fusion import MeshPlan
from repro_torch.launch import mesh as meshlib
from repro_torch.models import transformer as T
from repro_torch.parallel import shardctx
from repro_torch.train import Trainer

D = os.environ["TP_DIR"]
QWEN = ("replicated_kv", "split_kv")
LEGS = json.loads(os.environ["TP_LEGS"])
B, S, CHUNK = 4, 32, 8
WHISPER_V = 515
assert meshlib.init_distributed() == "gloo"
rank = torch.distributed.get_rank()


def cfg_of(name):
    if name in QWEN:
        cfg = get_config("qwen3-14b", reduced=True).replace(dtype="float32")
        return cfg if name == "replicated_kv" else cfg.replace(
            num_heads=8, num_kv_heads=4)
    cfg = get_config(name, reduced=True).replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    if cfg.encoder_layers:
        cfg = cfg.replace(vocab_size=WHISPER_V)
    return cfg


def load(like, name):
    with np.load(os.path.join(D, name + ".npz")) as z:
        return pytree.unflatten(like, iter(
            torch.from_numpy(z[k].copy())
            for k in pytree.flatten_with_paths(like)))


def arr(name):
    return torch.from_numpy(np.load(os.path.join(D, name + ".npy")))


def wait_for(path):
    # the parent writes each reference gradient while the children run
    import time
    t0 = time.time()
    while not os.path.exists(path):
        assert time.time() - t0 < 500, path
        time.sleep(0.1)


out = {"jax": False}
meshes = {"2x2": (2, 2), "1x4": (1, 4)}
for mesh_name, shape in meshes.items():
    mesh = MeshPlan("base", data=shape[0], model=shape[1]).build()
    rows = shardctx.batch_shard(torch.arange(B), mesh).tolist()
    res = out[mesh_name] = {"data": mesh.get_local_rank("data"),
                            "model": mesh.get_local_rank("model"),
                            "rows": rows}
    tokens = shardctx.batch_shard(arr("tokens").long(), mesh)
    audio = shardctx.batch_shard(arr("audio"), mesh)
    for leg_mesh, name in LEGS:
        if leg_mesh != mesh_name:
            continue
        cfg = cfg_of(name)
        tr = Trainer(cfg, ShapeConfig("t", S, B, "train"), TrainConfig(),
                     mesh=mesh, device="cpu",
                     rt=T.Runtime(production=True, remat=True,
                                  loss_chunk=CHUNK))
        whole = load(T.init_model(cfg, torch.Generator(), "meta"), name)
        params = shardctx.layout_tree(whole, tr.state_pspecs().params, mesh)
        batch = {"tokens": tokens}
        if cfg.encoder_layers:
            batch["audio_embeds"] = audio
        r = res[name] = {}
        with shardctx.use_mesh(mesh):
            r["tp"] = {kind: T._tp_block_params(
                T._index(params["reps"][i], 0), cfg, kind)[1]
                for i, kind in enumerate(T._pattern(cfg))}
            key = "table" if cfg.tie_embeddings else "out"
            r["head_split"] = T._table_shard(params, cfg, key)[1]
        loss, _, grads = tr.loss_and_grads(params, batch)
        r["loss"] = float(loss)
        # each leaf: the rank's shard against the same slice of the
        # reference's gradient, and that gradient's largest magnitude
        r["grads"] = {}
        wait_for(os.path.join(D, name + "_grad.npz"))
        with np.load(os.path.join(D, name + "_grad.npz")) as z:
            for k, g in pytree.flatten_with_paths(grads).items():
                ref = torch.from_numpy(z[k].copy())
                want = shardctx.shard_of(ref, mesh, g.placements) \
                    if shardctx.is_dtensor(g) else ref
                got = shardctx.local(g)
                assert got.shape == want.shape, (k, got.shape, want.shape)
                r["grads"][k] = [float((got - want).abs().max()),
                                 float(ref.abs().max()),
                                 got.numel() < ref.numel()]
        if mesh_name == "2x2" and name in QWEN:
            with torch.no_grad(), shardctx.use_mesh(mesh):
                lg, _ = T.logits_fn(params, {"tokens": tokens}, cfg,
                                    tr.rt)
            r["logits"] = lg.tolist()
    # the vocab-parallel NLL of one chunk on the rank's V / n columns
    lg_all = arr("nll_logits")
    n = shape[1]
    V = lg_all.shape[-1]
    m = mesh.get_local_rank("model")
    res["nll"] = {}
    for case in ("spread", "rank0"):
        with torch.no_grad(), shardctx.use_mesh(mesh):
            res["nll"][case] = float(T._vocab_parallel_nll(
                lg_all[..., m * V // n:(m + 1) * V // n].contiguous(),
                arr("nll_targets_" + case).long(), arr("nll_valid")))

out["jax"] = "jax" in sys.modules
assert not out["jax"]
with open(os.path.join(D, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
torch.distributed.destroy_process_group()
"""


def _nll(lg, tg, vc) -> float:
    """The reference's chunk NLL (``_chunked_lm_loss``'s ``chunk_nll``) on
    whole logits."""
    lg = jnp.asarray(lg, jnp.float32)
    logz = jax.scipy.special.logsumexp(lg, axis=-1)
    picked = jnp.take_along_axis(lg, jnp.asarray(tg)[..., None],
                                 axis=-1)[..., 0]
    return float(jnp.sum((logz - picked) * jnp.asarray(vc)[None, :]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_train"))
    rng = np.random.default_rng(25)
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    audio = rng.standard_normal((B, S, 128)).astype(np.float32)
    np.save(os.path.join(d, "tokens.npy"), tokens)
    np.save(os.path.join(d, "audio.npy"), audio)
    Bn, c, V = NLL_SHAPE
    np.save(os.path.join(d, "nll_logits.npy"),
            (3.0 * rng.standard_normal(NLL_SHAPE)).astype(np.float32))
    # targets over the whole vocabulary (every rank's range on 2 and 4
    # ranks), and all in the first quarter (rank 0's on both meshes)
    spread = (np.arange(Bn * c).reshape(Bn, c) * 7 + 3) % V
    nll_cases = {"spread": spread.astype(np.int64),
                 "rank0": rng.integers(0, V // 4, (Bn, c)).astype(np.int64)}
    valid = np.ones(c, np.float32)
    valid[-1] = 0.0                   # a padded position, as the last chunk
    np.save(os.path.join(d, "nll_valid.npy"), valid)
    for case, tg in nll_cases.items():
        np.save(os.path.join(d, f"nll_targets_{case}.npy"), tg)
    ref = {}
    for name in QWEN + FAMILIES:
        cfg = _cfg(jget_config, name)
        jp, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
        ref[name] = (cfg, jp)
        _save(os.path.join(d, name), bridge.params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        e = dict(env, TP_DIR=d, TP_LEGS=json.dumps(LEGS), RANK=str(r),
                 WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port))
        e.pop("LOCAL_RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD], env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    # the reduced qwen3-14b train cell (B 4, S 64)
    fake, compiled = start_counts(env, "qwen3-14b", ("train",))

    # the oracles, while the children run; the gradients are written for
    # the children, who wait for each file as they reach its leg
    oracle = {}
    rt = JT.Runtime(production=False, remat=True, loss_chunk=CHUNK)
    for name in QWEN + FAMILIES:
        cfg, jp = ref[name]
        batch = {"tokens": jnp.asarray(tokens)}
        if cfg.encoder_layers:
            batch["audio_embeds"] = jnp.asarray(audio)
        # the MoE's routing aux terms are the data shards' mean, as the
        # reference's moe_sharded takes them under a mesh: its loss is the
        # mean of loss_fn over the 2 data shards' rows (for a dense model
        # that mean is the whole batch's loss)
        shards = 2 if cfg.moe is not None else 1
        parts = [{k: v[i * B // shards:(i + 1) * B // shards]
                  for k, v in batch.items()} for i in range(shards)]
        grads = jax.grad(lambda p: sum(
            JT.loss_fn(p, part, cfg, rt)[0] for part in parts) / shards)(jp)
        oracle[name] = {"loss": float(JT.loss_fn(jp, batch, cfg, rt)[0])}
        tmp = os.path.join(d, name + "_grad.tmp.npz")
        _save(tmp, bridge.params_from_numpy(
            jax.tree.map(np.asarray, grads), device="cpu"))
        os.replace(tmp, os.path.join(d, name + "_grad.npz"))
        if name in QWEN:
            oracle[name]["logits"] = np.asarray(
                JT.logits_fn(jp, batch, cfg, rt)[0])
    oracle["nll"] = {case: _nll(np.load(os.path.join(d, "nll_logits.npy")),
                                tg, valid) for case, tg in nll_cases.items()}

    logs = []
    children = procs + [fake, compiled]
    for p in children:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in children:
                q.kill()
            raise
    for r, p in enumerate(children):
        assert p.returncode == 0, f"child {r}:\n{logs[r][-6000:]}"
    oracle["fake_count"] = json.loads(
        logs[WORLD].strip().splitlines()[-1])["train"]
    oracle["compiled"] = json.loads(
        logs[WORLD + 1].strip().splitlines()[-1])["train"]
    outs = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return oracle, outs


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def test_children_never_import_jax(run):
    _, outs = run
    assert [o["jax"] for o in outs] == [False] * WORLD
    assert sorted((o["2x2"]["data"], o["2x2"]["model"]) for o in outs) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert sorted(o["1x4"]["model"] for o in outs) == [0, 1, 2, 3]


# the sublayers each leg's blocks compute on 'model' shards, by block kind:
# the mixer (attention, SSM or RG-LRU), the MLP (the MoE's shared experts
# for deepseek) and whisper's cross-attention; falcon-mamba has no FFN.
# Every leg's LM head is split but whisper's, whose V the model axis does
# not divide.
ON_SHARDS = {"mixer": True, "ffn": True, "cross": False}
TP = {"replicated_kv": {"attn": ON_SHARDS},
      "split_kv": {"attn": ON_SHARDS},
      "deepseek-moe-16b": {"attn": ON_SHARDS},
      "falcon-mamba-7b": {"ssm": {"mixer": True, "ffn": False,
                                  "cross": False}},
      "whisper-base": {"attn": dict(ON_SHARDS, cross=True)},
      "recurrentgemma-9b": {"rglru": ON_SHARDS, "attn": ON_SHARDS}}
HEAD_SPLIT = {cfg: cfg != "whisper-base" for cfg in TP}


@pytest.mark.parametrize("mesh,cfg", LEGS)
def test_loss_matches_reference(run, mesh, cfg):
    oracle, outs = run
    want = oracle[cfg]["loss"]
    for o in outs:
        r = o[mesh][cfg]
        assert r["tp"] == TP[cfg], r["tp"]
        assert r["head_split"] == HEAD_SPLIT[cfg], cfg
        assert abs(r["loss"] - want) < LOSS_TOL, (mesh, cfg, r["loss"], want)


@pytest.mark.parametrize("mesh,cfg", LEGS)
def test_every_gradient_shard_matches_reference(run, mesh, cfg):
    """Each rank's shard of every leaf against the same slice of the
    reference's gradient, within 1e-4 of that leaf's largest magnitude."""
    _, outs = run
    for o in outs:
        grads = o[mesh][cfg]["grads"]
        assert grads
        bad = {k: (err, top) for k, (err, top, _) in grads.items()
               if not err <= GRAD_REL * top}
        assert not bad, (mesh, cfg, o[mesh]["data"], o[mesh]["model"], bad)
        # the model's weights are held as shards: some leaf is split
        assert any(split for _, _, split in grads.values()), cfg


@pytest.mark.parametrize("cfg", QWEN)
def test_logits_fn_matches_reference(run, cfg):
    oracle, outs = run
    want = oracle[cfg]["logits"]
    for o in outs:
        rows = o["2x2"]["rows"]
        assert _err(o["2x2"][cfg]["logits"], want[rows]) < LOGITS_TOL, cfg


@pytest.mark.parametrize("case", ["spread", "rank0"])
@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_vocab_parallel_nll_matches_whole_logits(run, mesh, case):
    oracle, outs = run
    want = oracle["nll"][case]
    for o in outs:
        assert abs(o[mesh]["nll"][case] - want) < NLL_TOL * abs(want), \
            (mesh, case, o[mesh]["nll"][case], want)


def test_counted_train_flops_match_compiled_program(run):
    oracle, _ = run
    ref = oracle["compiled"]
    assert ref["unresolved"] == 0 and ref["flops"] > 0
    got = oracle["fake_count"]
    assert got["flops"] == pytest.approx(ref["flops"], rel=FLOPS_REL), \
        (got["flops"], ref["flops"])
    assert got["coll"]["all-reduce"] > 0 and got["coll"]["all-gather"] > 0
