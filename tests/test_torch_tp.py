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
* heads the model axis does not divide compute whole, and q heads that read
  their KV heads in unequal groups raise.

Rank 0's counted FLOPs (``core.step_count`` on a ``fake`` (2, 2) group, a
fifth child, as ``test_torch_dryrun.py`` builds one) of a reduced qwen3-14b
prefill and decode step are held within 2 % of the reference's
``hlo_analysis`` of its program compiled for a (2, 2) mesh of 4 host
devices (a sixth child): the prefill with the second q/k/v projection of
``attention.prefill_cache`` added, divided as the first.
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
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = ("2x2", "1x4")
CFGS = ("replicated_kv", "split_kv")
B, S, W, STEPS = 4, 24, 32, 4
FAMILIES = ("whisper-base", "recurrentgemma-9b", "falcon-mamba-7b",
            "deepseek-moe-16b")
LEAVES = ("mlp", "attention", "cache", "cache_int8", "decode_attention",
          "lm_head")


def _cfg(get, name):
    """The reduced float32 configs, by the same rules in both packages."""
    if name in CFGS:
        cfg = get("qwen3-14b", reduced=True).replace(dtype="float32")
        return cfg if name == "replicated_kv" else cfg.replace(
            num_heads=8, num_kv_heads=4)
    cfg = get(name, reduced=True).replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    return cfg


CHILD = r"""
import dataclasses, json, os, sys
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
FAMILIES = json.loads(os.environ["TP_FAMILIES"])
B, S, W, STEPS = 4, 24, 32, 4
assert meshlib.init_distributed() == "gloo"
rank = torch.distributed.get_rank()


def cfg_of(name):
    if name in CFGS:
        cfg = get_config("qwen3-14b", reduced=True).replace(dtype="float32")
        return cfg if name == "replicated_kv" else cfg.replace(
            num_heads=8, num_kv_heads=4)
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


def slice_run(params, cfg, batch, rt, rows):
    # prefill then greedy decode steps, each rank feeding its own argmax
    with torch.no_grad():
        lg, st = T.prefill(params, batch, cfg, rt, window=W)
        logits, toks = [lg], [lg.argmax(-1)]
        for _ in range(STEPS):
            lg, st = T.decode_step(params, st, toks[-1][:, None], cfg, rt)
            logits.append(lg)
            toks.append(lg.argmax(-1))
    return {"logits": [x.tolist() for x in logits],
            "tokens": [x.tolist() for x in toks], "rows": rows}


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
        # heads the model axis does not divide compute whole; q heads that
        # read KV heads in unequal groups raise
        base = cfg_of("replicated_kv")
        checks = res["uneven"] = {}
        for label, cfg in (("whole", base.replace(num_heads=6)),
                           ("raises", base.replace(num_heads=12,
                                                   num_kv_heads=6))):
            p = T.init_model(cfg, torch.Generator().manual_seed(5), "cpu")
            want = None
            with torch.no_grad():
                want = T.prefill(p, {"tokens": toks}, cfg,
                                 T.Runtime(remat=False), window=W)[0]
            pm = shardctx.layout_tree(p, T.model_pspecs(cfg)[1], mesh)
            try:
                with torch.no_grad(), shardctx.use_mesh(mesh):
                    got = T.prefill(pm, {"tokens": toks}, cfg,
                                    T.Runtime(remat=False), window=W)[0]
                    tp = T._tp_block_params(T._index(pm["reps"][0], 0),
                                            cfg, "attn")[1]
                checks[label] = {"error": None, "tp": tp,
                                 "diff": float((got - want).abs().max())}
            except ValueError as e:
                checks[label] = {"error": str(e)}
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

out["jax"] = "jax" in sys.modules
assert not out["jax"]
with open(os.path.join(D, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
torch.distributed.destroy_process_group()
"""


# rank 0's count of a reduced config's cells (B 4, S 64) on a fake (2, 2)
# group, on the meta device; the cell argument is [arch, [kind, ...]]
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
arch, kinds = json.loads(sys.argv[1])
cfg = get_config(arch, reduced=True).replace(dtype="float32")
out = {}
for kind in kinds:
    mesh = dryrun._join_fake_group(MeshPlan("base", data=2, model=2))
    try:
        fn, args = dryrun.build_cell(cfg, ShapeConfig(kind, 64, 4, kind),
                                     mesh)
        with StepCounter(args) as sc:
            fn(*args)
    finally:
        dist.destroy_process_group()
    out[kind] = {"flops": sc.flops, "coll": sc.coll_breakdown}
assert "jax" not in sys.modules
print(json.dumps(out))
"""

# the reference's same cells, compiled for a (2, 2) mesh of 4 host devices
# (Auto axes: jax 0.9.0's default Explicit axes trip its shardctx.hint)
REF_CHILD = r"""
import json, os, sys
assert os.environ["XLA_FLAGS"] == "--xla_force_host_platform_device_count=4"
import jax
assert len(jax.devices()) == 4
from repro.launch import dryrun as JD    # its own XLA_FLAGS comes too late
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.core import hlo_analysis as JH
from repro.parallel import shardctx
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
arch, kinds = json.loads(sys.argv[1])
cfg = get_config(arch, reduced=True).replace(dtype="float32")
out = {}
for kind in kinds:
    with shardctx.use_mesh(mesh):
        fn, args = JD.build_cell(cfg, ShapeConfig(kind, 64, 4, kind), mesh,
                                 "base")
        cost = JH.analyze(fn.lower(*args).compile().as_text())
    out[kind] = {"flops": cost.flops, "unresolved": cost.unresolved_loops}
print(json.dumps(out))
"""


def start_counts(env, arch, kinds):
    """The two counting children for reduced ``arch``'s ``kinds`` cells:
    rank 0's count on a fake (2, 2) group and the reference's program
    compiled for 4 host devices."""
    cell = json.dumps([arch, list(kinds)])
    fake = subprocess.Popen([sys.executable, "-c", FAKE_CHILD, cell],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
    compiled = subprocess.Popen([sys.executable, "-c", REF_CHILD, cell],
                                env=ref_env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    return fake, compiled


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _save(path, tree):
    np.savez(path, **{k: v.numpy() for k, v in
                      pytree.flatten_with_paths(tree).items()})


def _greedy(params, batch, cfg, rt):
    lg, st = JT.prefill(params, batch, cfg, rt, window=W)
    logits, toks = [np.asarray(lg)], [np.asarray(jnp.argmax(lg, -1))]
    for _ in range(STEPS):
        lg, st = JT.decode_step(params, st, jnp.asarray(toks[-1])[:, None],
                                cfg, rt)
        logits.append(np.asarray(lg))
        toks.append(np.asarray(jnp.argmax(lg, -1)))
    return {"logits": logits, "tokens": toks}


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
    for name in CFGS + FAMILIES:
        cfg = _cfg(jget_config, name)
        jp, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
        ref_params[name] = (cfg, jp)
        _save(os.path.join(d, name), bridge.params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        e = dict(env, TP_DIR=d, TP_FAMILIES=json.dumps(FAMILIES),
                 RANK=str(r), WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port))
        e.pop("LOCAL_RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD], env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fake, compiled = start_counts(env, "qwen3-14b", ("prefill", "decode"))

    # the oracles, while the children run
    oracle = {}
    rt = JT.Runtime(production=False, remat=False)
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
    for arch in FAMILIES:
        cfg, jp = ref_params[arch]
        batch = {"tokens": jnp.asarray(tokens)}
        if cfg.encoder_layers:
            batch["audio_embeds"] = jnp.asarray(audio)
        oracle[arch] = _greedy(jp, batch, cfg, rt)

    logs = []
    for p in procs + [fake, compiled]:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs + [fake, compiled]:
                q.kill()
            raise
    for r, p in enumerate(procs + [fake, compiled]):
        assert p.returncode == 0, f"child {r}:\n{logs[r][-6000:]}"
    oracle["fake_count"] = json.loads(logs[WORLD].strip().splitlines()[-1])
    oracle["compiled"] = json.loads(logs[WORLD + 1].strip().splitlines()[-1])
    oracle["reprojection"] = _reprojection_flops(ref_params["replicated_kv"]
                                                 [0])
    outs = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return oracle, outs


def _reprojection_flops(cfg, Bp=4, Sp=64, data=2, model=2) -> float:
    """Rank 0's FLOPs of the second q/k/v projection ``prefill_cache`` makes
    in each attention layer of the (2, 2) prefill cell, divided as the
    first: the rank's batch rows and q heads, and every KV head (reduced
    qwen3-14b's 2 KV heads: ``wk`` / ``wv`` replicated)."""
    hd = cfg.resolved_head_dim
    width = cfg.num_heads * hd // model + 2 * cfg.num_kv_heads * hd
    n_attn = sum(k == "attn" for k in cfg.layer_kinds)
    return n_attn * 2.0 * (Bp // data) * Sp * cfg.d_model * width


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


def test_uneven_heads_compute_whole_or_raise(run):
    _, outs = run
    for o in outs:
        u = o["1x4"]["uneven"]
        # 6 heads on 4 model ranks: the attention whole, the MLP on shards
        assert u["whole"]["error"] is None
        assert u["whole"]["tp"] == {"mixer": False, "ffn": True,
                                    "cross": False}
        assert u["whole"]["diff"] < TOL
        # 12 heads, 6 KV heads (replicated): rank 0's q heads 0-2 read KV
        # heads 0, 0, 1
        assert "in equal groups" in u["raises"]["error"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_counted_flops_match_compiled_program(run, kind):
    oracle, _ = run
    ref = oracle["compiled"][kind]
    assert ref["unresolved"] == 0 and ref["flops"] > 0
    want = ref["flops"]
    if kind == "prefill":
        want += oracle["reprojection"]
    got = oracle["fake_count"][kind]["flops"]
    assert got == pytest.approx(want, rel=FLOPS_REL), (kind, got, want)
    assert oracle["fake_count"][kind]["coll"]["all-reduce"] > 0
