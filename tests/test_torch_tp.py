"""The tensor-parallel serving path on gloo meshes of 4 CPU processes,
against the JAX reference on one device and its compiled sharded program.

Under a mesh whose 'model' axis has more than one rank, ``prefill`` and
``decode_step`` compute the self-attention, the dense MLP and the LM head on
each rank's 'model' shard of the weights, as the reference's specs divide
them (GSPMD's layout).  Four children (``python -c``, gloo, one torch
thread each, ``jax`` never imported) run on a (data 2, model 2) and a
(data 1, model 4) mesh, two configs each: reduced qwen3-14b as it is (4
heads, 2 KV heads: ``wk`` / ``wv`` replicated) and with 8 heads and 4 KV
heads (``wk`` / ``wv`` split).  Their results are held to the reference's
single-device values from the same weights (``bridge``), computed in this
process meanwhile, within 2e-3 (as ``tests/test_multidevice.py``):

* each leaf on layer 0's weights: the MLP, the prefill attention, the
  prefill cache (plain and int8; each rank's ring slots), the decode
  attention against that cache, the LM head;
* each rank's weights per tensor-parallel leaf and both embedding tables:
  the spec's share (``d / n_model`` of a split leaf, a replicated leaf
  whole);
* the slice: ``prefill`` then 4 greedy ``decode_step``s, plain and int8
  caches, float32: logits within 2e-3, tokens equal;
* ``seq_shard`` on (1, 4): the same prefill;
* the other families on (2, 2): whisper-base (encoder and decoder
  self-attention and the cross-attention on shards), recurrentgemma-9b (MQA
  beside RG-LRU mixers on shards), falcon-mamba-7b (SSM mixers on shards,
  the tied LM head row-parallel), deepseek-moe-16b (``moe_sharded`` beside
  the attention);
* heads the model axis does not divide (6 heads on (1, 4): 2, 2, 2, 0 a
  rank), and q heads that read replicated KV heads in unequal groups (12
  heads, 6 KV heads on (1, 4)), on shards: prefill and 2 greedy decode
  steps;
* split KV heads the model axis does not divide: reduced qwen2-vl-7b with
  28 heads and 4 KV heads on a (1, 8) mesh of 8 more children (4 heads a
  rank, none on rank 7; half a KV head of ``wk`` / ``wv`` a rank):
  prefill, 2 greedy decode steps, and the loss and every gradient shard
  of ``Trainer.loss_and_grads`` against ``jax.grad``.

Rank 0's counted FLOPs (``core.step_count`` on a ``fake`` group, as
``test_torch_dryrun.py`` builds one) are held within 2 % of the
reference's ``hlo_analysis`` of the same program compiled for as many host
devices: a reduced qwen3-14b prefill and decode step on (2, 2), and the
prefill on (1, n) with 6 / 2 heads on 4 ranks, 28 / 4 on 8, 32 / 8 and
40 / 8 on 16.  The prefill's named terms are added (:func:`_prefill_terms`).
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
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402

WORLD = 4
TOL = 2e-3
FLOPS_REL = 0.02
GRAD_REL = 1e-4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = ("2x2", "1x4")
CFGS = ("replicated_kv", "split_kv")
B, S, W, STEPS = 4, 24, 32, 4
FAMILIES = ("whisper-base", "recurrentgemma-9b", "falcon-mamba-7b",
            "deepseek-moe-16b")
LEAVES = ("mlp", "attention", "cache", "cache_int8", "decode_attention",
          "lm_head")
# reduced configs with other head counts, by name: (arch, heads, KV heads).
# On (1, 4): 6 heads (2, 2, 2, 0 a rank; wk / wv replicated), and 12 heads
# reading 6 replicated KV heads in unequal groups (rank 0: 0, 0, 1).  On
# (1, 8): qwen2-vl-7b's 28 / 4 (4 heads a rank, none on rank 7; half a KV
# head of the split wk / wv a rank)
HEADS = {"replicated_kv": ("qwen3-14b", 4, 2), "split_kv": ("qwen3-14b", 8, 4),
         "heads6": ("qwen3-14b", 6, 2), "heads12_kv6": ("qwen3-14b", 12, 6),
         "heads28_kv4": ("qwen2-vl-7b", 28, 4)}
UNEVEN = ("heads6", "heads12_kv6")
WIDE, WIDE_WORLD = "heads28_kv4", 8
UNEVEN_STEPS, LOSS_CHUNK = 2, 8
# the counted prefill cells on (1, n), by name: (heads, KV heads, n)
COUNT_ROWS = {"6/2 on 4": (6, 2, 4), "28/4 on 8": (28, 4, 8),
              "32/8 on 16": (32, 8, 16), "40/8 on 16": (40, 8, 16)}


def _cfg(get, name):
    """The reduced float32 configs, by the same rules in both packages."""
    if name in HEADS:
        arch, h, kv = HEADS[name]
        return get(arch, reduced=True).replace(
            dtype="float32", num_heads=h, num_kv_heads=kv)
    cfg = get(name, reduced=True).replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    return cfg


# what both meshes' children share: the configs, the saved weights and
# inputs, the greedy slice
COMMON = r"""
import dataclasses, json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.core.fusion import MeshPlan
from repro_torch.launch import mesh as meshlib
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import shardctx

D = os.environ["TP_DIR"]
CFGS = ("replicated_kv", "split_kv")
HEADS = json.loads(os.environ["TP_HEADS"])
UNEVEN = ("heads6", "heads12_kv6")
UNEVEN_STEPS, LOSS_CHUNK = 2, 8
B, S, W, STEPS = 4, 24, 32, 4
assert meshlib.init_distributed() == "gloo"
rank = torch.distributed.get_rank()


def cfg_of(name):
    if name in HEADS:
        arch, h, kv = HEADS[name]
        return get_config(arch, reduced=True).replace(
            dtype="float32", num_heads=h, num_kv_heads=kv)
    cfg = get_config(name, reduced=True).replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    return cfg


def load(like, name):
    with np.load(os.path.join(D, name + ".npz")) as z:
        return pytree.unflatten(like, iter(
            torch.from_numpy(z[k].copy())
            for k in pytree.flatten_with_paths(like)))


def arr(name):
    return torch.from_numpy(np.load(os.path.join(D, name + ".npy")))


def lst(t):
    return shardctx.local(t).tolist()


def slice_run(params, cfg, batch, rt, rows, steps=STEPS):
    # prefill then greedy decode steps, each rank feeding its own argmax
    with torch.no_grad():
        lg, st = T.prefill(params, batch, cfg, rt, window=W)
        logits, toks = [lg], [lg.argmax(-1)]
        for _ in range(steps):
            lg, st = T.decode_step(params, st, toks[-1][:, None], cfg, rt)
            logits.append(lg)
            toks.append(lg.argmax(-1))
    return {"logits": [x.tolist() for x in logits],
            "tokens": [x.tolist() for x in toks], "rows": rows}


def finish(out, name):
    out["jax"] = "jax" in sys.modules
    assert not out["jax"]
    with open(os.path.join(D, name), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
"""

CHILD = COMMON + r"""
FAMILIES = json.loads(os.environ["TP_FAMILIES"])
out = {"jax": False}
for mesh_name, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
    mesh = MeshPlan("base", data=shape[0], model=shape[1]).build()
    rows = shardctx.batch_shard(torch.arange(B), mesh).tolist()
    res = out[mesh_name] = {"data": mesh.get_local_rank("data"),
                            "model": mesh.get_local_rank("model"),
                            "rows": rows}
    for name in CFGS:
        cfg = cfg_of(name)
        whole = load(T.init_model(cfg, torch.Generator(), "meta"), name)
        params = shardctx.layout_tree(whole, T.model_pspecs(cfg)[1], mesh)
        r = res[name] = {}
        x = shardctx.batch_shard(arr("x"), mesh)
        xn = shardctx.batch_shard(arr("x_new"), mesh)
        pos = torch.arange(S)[None].expand(x.shape[0], S)
        new_pos = torch.full((x.shape[0],), S, dtype=torch.long)
        toks = shardctx.batch_shard(arr("tokens").long(), mesh)
        with torch.no_grad(), shardctx.use_mesh(mesh):
            w, tp = T._tp_block_params(T._index(params["reps"][0], 0), cfg,
                                       "attn")
            r["tp"] = tp
            # each rank's weights per leaf, and the whole leaf's size
            r["bytes"] = {f"{sub}/{k}": [v.numel(), int(np.prod(
                T._index(params["reps"][0], 0)[sub][k].shape))]
                for sub in ("mixer", "ffn") for k, v in w[sub].items()}
            for k in ("table", "out"):
                r["bytes"]["embed/" + k] = [
                    T._table_shard(params, cfg, k)[0].numel(),
                    params["embed"][k].numel()]
            r["mlp"] = L.mlp(w["ffn"], x, cfg.activation, tp=tp["ffn"])
            r["attention"] = A.full_attention(w["mixer"], x, pos, cfg,
                                              tp=tp["mixer"])
            for quant in (False, True):
                c = A.prefill_cache(w["mixer"], x, pos, cfg,
                                    window_override=W, quant=quant,
                                    tp=tp["mixer"])
                key = "cache_int8" if quant else "cache"
                r[key] = {f: lst(getattr(c, f)) for f in c._fields
                          if getattr(c, f) is not None}
                r[key + "_slots"] = [shardctx.axis_index("model") * (
                    W // shardctx.axis_size("model")), shardctx.local(
                    c.k).shape[1]]
                if not quant:
                    o, _ = A.decode_attention(w["mixer"], c, xn, new_pos,
                                              cfg, tp=tp["mixer"])
                    r["decode_attention"] = o
            r["lm_head"] = T._lm_logits(params, x[:, -1:], cfg)
            for k in ("mlp", "attention", "decode_attention", "lm_head"):
                r[k] = r[k].tolist()
            for quant in (False, True):
                rt = T.Runtime(remat=False, kv_quant=quant)
                r[f"slice_q{int(quant)}"] = slice_run(
                    params, cfg, {"tokens": toks}, rt, rows)
            if mesh_name == "1x4":
                rt = T.Runtime(remat=False, seq_shard=True)
                lg, _ = T.prefill(params, {"tokens": toks}, cfg, rt,
                                  window=W)
                r["seq_shard"] = lg.tolist()
    if mesh_name != "2x2":
        # heads the model axis does not divide, and q heads that read
        # replicated KV heads in unequal groups
        for name in UNEVEN:
            cfg = cfg_of(name)
            whole = load(T.init_model(cfg, torch.Generator(), "meta"), name)
            params = shardctx.layout_tree(whole, T.model_pspecs(cfg)[1],
                                          mesh)
            with shardctx.use_mesh(mesh):
                res[name] = slice_run(params, cfg, {"tokens": toks},
                                      T.Runtime(remat=False), rows,
                                      UNEVEN_STEPS)
                res[name]["tp"] = T._tp_block_params(
                    T._index(params["reps"][0], 0), cfg, "attn")[1]
        continue
    for arch in FAMILIES:
        cfg = cfg_of(arch)
        whole = load(T.init_model(cfg, torch.Generator(), "meta"), arch)
        params = shardctx.layout_tree(whole, T.model_pspecs(cfg)[1], mesh)
        batch = {"tokens": shardctx.batch_shard(arr("tokens").long(), mesh)}
        if cfg.encoder_layers:
            batch["audio_embeds"] = shardctx.batch_shard(arr("audio"), mesh)
        with shardctx.use_mesh(mesh):
            res[arch] = slice_run(params, cfg, batch,
                                  T.Runtime(remat=False), rows)

finish(out, f"rank{rank}.json")
"""

# the (1, 8) mesh: 28 heads and 4 split KV heads on 8 ranks, prefill and
# greedy decode steps, then the loss and gradients (the reference's are
# written while the children run)
WIDE_CHILD = COMMON + r"""
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.train import Trainer
name = "heads28_kv4"
mesh = MeshPlan("base", data=1, model=8).build()
cfg = cfg_of(name)
whole = load(T.init_model(cfg, torch.Generator(), "meta"), name)
params = shardctx.layout_tree(whole, T.model_pspecs(cfg)[1], mesh)
toks = arr("tokens").long()
out = {"model": mesh.get_local_rank("model")}
with shardctx.use_mesh(mesh):
    out["tp"] = T._tp_block_params(T._index(params["reps"][0], 0), cfg,
                                   "attn")[1]
    out["slice"] = slice_run(params, cfg, {"tokens": toks},
                             T.Runtime(remat=False), list(range(B)),
                             UNEVEN_STEPS)
tr = Trainer(cfg, ShapeConfig("t", S, B, "train"), TrainConfig(), mesh=mesh,
             device="cpu", rt=T.Runtime(production=True, remat=True,
                                        loss_chunk=LOSS_CHUNK))
params = shardctx.layout_tree(whole, tr.state_pspecs().params, mesh)
loss, _, grads = tr.loss_and_grads(params, {"tokens": toks})
out["loss"] = float(loss)
path = os.path.join(D, name + "_grad.npz")
t0 = time.time()
while not os.path.exists(path):
    assert time.time() - t0 < 500, path
    time.sleep(0.1)
out["grads"] = {}
with np.load(path) as z:
    for k, g in pytree.flatten_with_paths(grads).items():
        ref = torch.from_numpy(z[k].copy())
        want = shardctx.shard_of(ref, mesh, g.placements) \
            if shardctx.is_dtensor(g) else ref
        got = shardctx.local(g)
        assert got.shape == want.shape, (k, got.shape, want.shape)
        out["grads"][k] = [float((got - want).abs().max()),
                           float(ref.abs().max())]
finish(out, f"wide{rank}.json")
"""


# rank 0's count of reduced cells (B 4, S 64) on fake groups, on the meta
# device; the argument is a list of [label, arch, kind, head overrides,
# [data, model]]
FAKE_CHILD = r"""
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.fusion import MeshPlan
from repro_torch.core.step_count import StepCounter
from repro_torch.launch import dryrun
out = {}
for label, arch, kind, heads, (data, model) in json.loads(sys.argv[1]):
    cfg = get_config(arch, reduced=True).replace(dtype="float32", **heads)
    mesh = dryrun._join_fake_group(MeshPlan("base", data=data, model=model))
    try:
        fn, args = dryrun.build_cell(cfg, ShapeConfig(kind, 64, 4, kind),
                                     mesh)
        with StepCounter(args) as sc:
            fn(*args)
    finally:
        dist.destroy_process_group()
    out[label] = {"flops": sc.flops, "coll": sc.coll_breakdown}
assert "jax" not in sys.modules
print(json.dumps(out))
"""

# the reference's same cells, compiled for a mesh of as many host devices,
# every cell on one mesh shape (Auto axes: jax 0.9.0's default Explicit
# axes trip its shardctx.hint)
REF_CHILD = r"""
import json, os, sys
cells = json.loads(sys.argv[1])
data, model = cells[0][4]
assert os.environ["XLA_FLAGS"] == \
    f"--xla_force_host_platform_device_count={data * model}"
import jax
assert len(jax.devices()) == data * model
from repro.launch import dryrun as JD    # its own XLA_FLAGS comes too late
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.core import hlo_analysis as JH
from repro.parallel import shardctx
mesh = jax.make_mesh((data, model), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for label, arch, kind, heads, shape in cells:
    assert list(shape) == [data, model], cells
    cfg = get_config(arch, reduced=True).replace(dtype="float32", **heads)
    with shardctx.use_mesh(mesh):
        fn, args = JD.build_cell(cfg, ShapeConfig(kind, 64, 4, kind), mesh,
                                 "base")
        cost = JH.analyze(fn.lower(*args).compile().as_text())
    out[label] = {"flops": cost.flops, "unresolved": cost.unresolved_loops}
print(json.dumps(out))
"""


def _count_children(env, cells):
    """Rank 0's count of ``cells`` on fake groups (one child) and the
    reference's compiled programs (one child a mesh shape); each child
    prints a dict by label."""
    procs = [subprocess.Popen([sys.executable, "-c", FAKE_CHILD,
                               json.dumps(cells)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    for shape in sorted({tuple(c[4]) for c in cells}):
        ref_env = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            f"--xla_force_host_platform_device_count={shape[0] * shape[1]}"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_CHILD,
             json.dumps([c for c in cells if tuple(c[4]) == shape])],
            env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def start_counts(env, arch, kinds):
    """The two counting children for reduced ``arch``'s ``kinds`` cells:
    rank 0's count on a fake (2, 2) group and the reference's program
    compiled for 4 host devices."""
    return _count_children(env, [[k, arch, k, {}, [2, 2]] for k in kinds])


def _row_cells():
    """:data:`COUNT_ROWS` as counting cells: reduced qwen3-14b prefills on
    (1, n) with the row's head counts."""
    return [[row, "qwen3-14b", "prefill",
             {"num_heads": h, "num_kv_heads": kv}, [1, n]]
            for row, (h, kv, n) in COUNT_ROWS.items()]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _save(path, tree):
    np.savez(path, **{k: v.numpy() for k, v in
                      pytree.flatten_with_paths(tree).items()})


def _greedy(params, batch, cfg, rt, steps=STEPS):
    lg, st = JT.prefill(params, batch, cfg, rt, window=W)
    logits, toks = [np.asarray(lg)], [np.asarray(jnp.argmax(lg, -1))]
    for _ in range(steps):
        lg, st = JT.decode_step(params, st, jnp.asarray(toks[-1])[:, None],
                                cfg, rt)
        logits.append(np.asarray(lg))
        toks.append(np.asarray(jnp.argmax(lg, -1)))
    return {"logits": logits, "tokens": toks}


def _gloo_children(script, world, env, d):
    port = _free_port()
    procs = []
    for r in range(world):
        e = dict(env, TP_DIR=d, RANK=str(r), WORLD_SIZE=str(world),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        e.pop("LOCAL_RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _last_json(log):
    return json.loads(log.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp"))
    rng = np.random.default_rng(24)
    x = rng.standard_normal((B, S, 128)).astype(np.float32)
    x_new = rng.standard_normal((B, 1, 128)).astype(np.float32)
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    audio = rng.standard_normal((B, S, 128)).astype(np.float32)
    for name, a in (("x", x), ("x_new", x_new), ("tokens", tokens),
                    ("audio", audio)):
        np.save(os.path.join(d, name + ".npy"), a)
    ref_params = {}
    for name in CFGS + UNEVEN + (WIDE,) + FAMILIES:
        cfg = _cfg(jget_config, name)
        jp, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
        ref_params[name] = (cfg, jp)
        _save(os.path.join(d, name), bridge.params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))

    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               TP_HEADS=json.dumps(HEADS), TP_FAMILIES=json.dumps(FAMILIES))
    procs = _gloo_children(CHILD, WORLD, env, d)
    wide = _gloo_children(WIDE_CHILD, WIDE_WORLD, env, d)
    pair = start_counts(env, "qwen3-14b", ("prefill", "decode"))
    rows = _count_children(env, _row_cells())

    # the oracles, while the children run
    oracle = {}
    rt = JT.Runtime(production=False, remat=False)
    cfg, jp = ref_params[WIDE]
    wide_batch = {"tokens": jnp.asarray(tokens)}
    trt = JT.Runtime(production=False, remat=True, loss_chunk=LOSS_CHUNK)
    loss, grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, wide_batch, cfg, trt)[0])(jp)
    tmp = os.path.join(d, WIDE + "_grad.tmp.npz")
    _save(tmp, bridge.params_from_numpy(jax.tree.map(np.asarray, grads),
                                        device="cpu"))
    os.replace(tmp, os.path.join(d, WIDE + "_grad.npz"))
    oracle[WIDE] = dict(_greedy(jp, wide_batch, cfg, rt, UNEVEN_STEPS),
                        loss=float(loss))
    xs, xn = jnp.asarray(x), jnp.asarray(x_new)
    positions = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    for name in CFGS:
        cfg, jp = ref_params[name]
        blk = jax.tree.map(lambda a: a[0], jp["reps"][0])
        o = oracle[name] = {}
        o["mlp"] = np.asarray(JL.mlp(blk["ffn"], xs, cfg.activation))
        o["attention"] = np.asarray(JA.full_attention(blk["mixer"], xs,
                                                      positions, cfg))
        for quant in (False, True):
            c = JA.prefill_cache(blk["mixer"], xs, positions, cfg,
                                 window_override=W, quant=quant)
            o["cache_int8" if quant else "cache"] = {
                f: np.asarray(getattr(c, f)) for f in c._fields
                if getattr(c, f) is not None}
            if not quant:
                o["decode_attention"] = np.asarray(JA.decode_attention(
                    blk["mixer"], c, xn, jnp.full((B,), S, jnp.int32),
                    cfg)[0])
        o["lm_head"] = np.asarray(JL.unembed(jp["embed"], xs[:, -1:], False))
        for quant in (False, True):
            o[f"slice_q{int(quant)}"] = _greedy(
                jp, {"tokens": jnp.asarray(tokens)}, cfg,
                rt._replace(kv_quant=quant))
    for name in UNEVEN:
        cfg, jp = ref_params[name]
        oracle[name] = _greedy(jp, {"tokens": jnp.asarray(tokens)}, cfg, rt,
                               UNEVEN_STEPS)
    for arch in FAMILIES:
        cfg, jp = ref_params[arch]
        batch = {"tokens": jnp.asarray(tokens)}
        if cfg.encoder_layers:
            batch["audio_embeds"] = jnp.asarray(audio)
        oracle[arch] = _greedy(jp, batch, cfg, rt)

    children = procs + wide + pair + rows
    logs = []
    for p in children:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in children:
                q.kill()
            raise
    for r, p in enumerate(children):
        assert p.returncode == 0, f"child {r}:\n{logs[r][-6000:]}"
    n0 = len(procs) + len(wide)
    oracle["fake_count"], oracle["compiled"] = (
        _last_json(x) for x in logs[n0:n0 + 2])
    row_logs = [_last_json(x) for x in logs[n0 + 2:]]
    oracle["rows"] = {"fake": row_logs[0], "compiled": {
        k: v for c in row_logs[1:] for k, v in c.items()}}
    outs = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    oracle["wide"] = []
    for r in range(WIDE_WORLD):
        with open(os.path.join(d, f"wide{r}.json")) as f:
            oracle["wide"].append(json.load(f))
    return oracle, outs


def _kv_split(cfg, model) -> bool:
    """Whether the resolved spec splits ``wk`` / ``wv`` over 'model': a
    multiple of 4 KV heads (``attention_pspecs``) whose columns the axis
    divides."""
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    return cfg.num_kv_heads % 4 == 0 and kv % model == 0


def _reprojection_flops(cfg, Bp=4, Sp=64, data=2, model=2) -> float:
    """Rank 0's FLOPs of the second projection ``prefill_cache`` makes in
    each attention layer of a prefill cell, which XLA's CSE folds: k and v
    on the rank's batch rows, of the rank's columns where ``wk`` / ``wv``
    are split (then all-gathered) or every KV head where they are
    replicated; and q on the rank's heads where the model axis divides
    them (elsewhere the port projects k and v alone)."""
    hd = cfg.resolved_head_dim
    width = 2 * cfg.num_kv_heads * hd // (model if _kv_split(cfg, model)
                                          else 1)
    if cfg.num_heads % model == 0:
        width += cfg.num_heads * hd // model
    n_attn = sum(k == "attn" for k in cfg.layer_kinds)
    return n_attn * 2.0 * (Bp // data) * Sp * cfg.d_model * width


def _ring_flops(cfg, Bp=4, Sp=64, data=2, model=2) -> float:
    """Rank 0's FLOPs of XLA's projection, for the ring it lays out over
    'model', of every KV head on the rank's S / n positions: v alone where
    ``wk`` / ``wv`` are split (its ring k is the attention's, gathered), k
    and v where they are replicated (the attention projected only the KV
    heads the rank reads)."""
    hd = cfg.resolved_head_dim
    n_attn = sum(k == "attn" for k in cfg.layer_kinds)
    per = 1 if _kv_split(cfg, model) else 2
    return n_attn * per * 2.0 * (Bp // data) * (Sp // model) * \
        cfg.d_model * cfg.num_kv_heads * hd


def _unread_kv_flops(cfg, Bp=4, Sp=64, data=2, model=2) -> float:
    """Rank 0's FLOPs of the attention's k / v projection of the KV heads
    its heads do not read, where ``wk`` / ``wv`` are replicated: the port
    projects every KV head and takes those its ``ceil(H / n)`` heads read
    (``h // (H / KV)``), XLA projects only those."""
    if _kv_split(cfg, model):
        return 0.0
    c = -(-cfg.num_heads // model)
    read = -(-c // (cfg.num_heads // cfg.num_kv_heads))
    n_attn = sum(k == "attn" for k in cfg.layer_kinds)
    return n_attn * 2 * 2.0 * (Bp // data) * Sp * cfg.d_model * (
        cfg.num_kv_heads - read) * cfg.resolved_head_dim


def _prefill_terms(cfg, data, model) -> float:
    """What rank 0's count of a prefill cell adds to the compiled
    reference's: the port's second projection and its projection of the
    unread replicated KV heads, less XLA's ring projection.  Nothing else
    differs: q, k, v and wo at the spec's share (where the model axis does
    not divide the heads, the port gathers the projections as XLA does),
    the attention on the rank's ceil(H / n) heads."""
    kw = dict(data=data, model=model)
    return (_reprojection_flops(cfg, **kw) + _unread_kv_flops(cfg, **kw)
            - _ring_flops(cfg, **kw))


def _rows(o, mesh):
    return o[mesh]["rows"]


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def test_children_never_import_jax(run):
    _, outs = run
    assert [o["jax"] for o in outs] == [False] * WORLD
    assert sorted((o["2x2"]["data"], o["2x2"]["model"]) for o in outs) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert sorted(o["1x4"]["model"] for o in outs) == [0, 1, 2, 3]


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_leaf_matches_reference(run, mesh, cfg, leaf):
    oracle, outs = run
    want = oracle[cfg][leaf]
    for o in outs:
        r = o[mesh][cfg]
        assert r["tp"] == {"mixer": True, "ffn": True, "cross": False}, \
            r["tp"]
        rows = _rows(o, mesh)
        if leaf.startswith("cache"):
            lo, n = r[leaf + "_slots"]
            assert n == W // (2 if mesh == "2x2" else 4)
            for f in ("k", "v"):
                # int8 codes compare as the values they stand for
                got, w = (np.asarray(c[f], np.float64) * np.asarray(
                    c.get(f + "_scale", 1.0)) for c in (r[leaf], want))
                assert got.shape[1] == n
                assert _err(got, w[rows][:, lo:lo + n]) < TOL, \
                    (mesh, cfg, leaf, f)
        else:
            assert _err(r[leaf], want[rows]) < TOL, (mesh, cfg, leaf)


# the leaves the reference's specs split over 'model' (resolved on these
# shapes): everything but the norms, and wk / wv only with 4 KV heads
SPLIT = {"replicated_kv": {"mixer/wq", "mixer/wo", "ffn/wi_gate",
                           "ffn/wi_up", "ffn/wo", "embed/table",
                           "embed/out"}}
SPLIT["split_kv"] = SPLIT["replicated_kv"] | {"mixer/wk", "mixer/wv"}


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("mesh", MESHES)
def test_gathered_weights_at_spec_share(run, mesh, cfg):
    _, outs = run
    n = 2 if mesh == "2x2" else 4
    for o in outs:
        got = o[mesh][cfg]["bytes"]
        assert {k for k, (mine, whole) in got.items() if mine < whole} \
            == SPLIT[cfg], got
        for k, (mine, whole) in got.items():
            assert mine * (n if k in SPLIT[cfg] else 1) == whole, (k, got)


@pytest.mark.parametrize("quant", [0, 1])
@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("mesh", MESHES)
def test_slice_logits_and_greedy_tokens(run, mesh, cfg, quant):
    oracle, outs = run
    want = oracle[cfg][f"slice_q{quant}"]
    for o in outs:
        got = o[mesh][cfg][f"slice_q{quant}"]
        rows = got["rows"]
        for i in range(STEPS + 1):
            assert got["tokens"][i] == want["tokens"][i][rows].tolist(), i
            assert _err(got["logits"][i], want["logits"][i][rows]) < TOL, i


@pytest.mark.parametrize("cfg", CFGS)
def test_seq_shard_prefill(run, cfg):
    oracle, outs = run
    want = oracle[cfg]["slice_q0"]["logits"][0]
    for o in outs:
        assert _err(o["1x4"][cfg]["seq_shard"], want) < TOL


@pytest.mark.parametrize("arch", FAMILIES)
def test_other_families_slice(run, arch):
    oracle, outs = run
    want = oracle[arch]
    for o in outs:
        got = o["2x2"][arch]
        rows = got["rows"]
        for i in range(STEPS + 1):
            assert got["tokens"][i] == want["tokens"][i][rows].tolist(), i
            assert _err(got["logits"][i], want["logits"][i][rows]) < TOL, i


@pytest.mark.parametrize("cfg", UNEVEN)
def test_uneven_heads_compute_whole_or_raise(run, cfg):
    """Heads the model axis does not divide (6 on 4 model ranks: 2, 2, 2,
    0) and q heads that read replicated KV heads in unequal groups (12 / 6
    heads: rank 0's heads 0-2 read KV heads 0, 0, 1) compute on 'model'
    shards, neither whole nor raising: prefill and 2 greedy decode steps
    against the reference, logits within 2e-3, tokens equal."""
    oracle, outs = run
    want = oracle[cfg]
    for o in outs:
        got = o["1x4"][cfg]
        assert got["tp"] == {"mixer": True, "ffn": True, "cross": False}
        rows = got["rows"]
        for i in range(UNEVEN_STEPS + 1):
            assert got["tokens"][i] == want["tokens"][i][rows].tolist(), i
            assert _err(got["logits"][i], want["logits"][i][rows]) < TOL, i


@pytest.mark.parametrize("part", ["slice", "loss", "gradients"])
def test_split_kv_heads_undivided_on_eight_ranks(run, part):
    """28 heads, 4 split KV heads on a (1, 8) mesh (4 heads a rank, none
    on rank 7; half a KV head of wk / wv a rank): prefill and 2 greedy
    decode steps (logits within 2e-3, tokens equal), the loss within 1e-5
    of the reference's, each rank's gradient shard within 1e-4 of its
    leaf's largest."""
    oracle, _ = run
    want = oracle[WIDE]
    assert sorted(o["model"] for o in oracle["wide"]) == \
        list(range(WIDE_WORLD))
    for o in oracle["wide"]:
        assert o["jax"] is False
        assert o["tp"] == {"mixer": True, "ffn": True, "cross": False}
        if part == "slice":
            for i in range(UNEVEN_STEPS + 1):
                assert o["slice"]["tokens"][i] == want["tokens"][i].tolist()
                assert _err(o["slice"]["logits"][i], want["logits"][i]) \
                    < TOL, i
        elif part == "loss":
            assert abs(o["loss"] - want["loss"]) < 1e-5 * abs(want["loss"])
        else:
            bad = {k: (err, top) for k, (err, top) in o["grads"].items()
                   if not err <= GRAD_REL * top}
            assert o["grads"] and not bad, (o["model"], bad)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_counted_flops_match_compiled_program(run, kind):
    oracle, _ = run
    ref = oracle["compiled"][kind]
    assert ref["unresolved"] == 0 and ref["flops"] > 0
    want = ref["flops"]
    if kind == "prefill":
        want += _prefill_terms(_cfg(jget_config, "replicated_kv"), 2, 2)
    got = oracle["fake_count"][kind]["flops"]
    assert got == pytest.approx(want, rel=FLOPS_REL), (kind, got, want)
    assert oracle["fake_count"][kind]["coll"]["all-reduce"] > 0


@pytest.mark.parametrize("row", COUNT_ROWS)
def test_uneven_heads_prefill_flops_match_compiled_program(run, row):
    """Rank 0's prefill on (1, n) where the model axis does not divide the
    heads or the split KV heads, against the program compiled for n host
    devices plus the named terms (:func:`_prefill_terms`)."""
    oracle, _ = run
    h, kv, n = COUNT_ROWS[row]
    ref = oracle["rows"]["compiled"][row]
    assert ref["unresolved"] == 0 and ref["flops"] > 0
    cfg = jget_config("qwen3-14b", reduced=True).replace(
        dtype="float32", num_heads=h, num_kv_heads=kv)
    want = ref["flops"] + _prefill_terms(cfg, 1, n)
    got = oracle["rows"]["fake"][row]["flops"]
    assert got == pytest.approx(want, rel=FLOPS_REL), (row, got, want)
