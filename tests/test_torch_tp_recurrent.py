"""The SSM and RG-LRU mixers and whisper's cross-attention on 'model'
shards, on gloo meshes of 4 CPU processes, against the JAX reference on one
device and its compiled sharded program.

Under a mesh whose 'model' axis has more than one rank, each of these
layers computes on the rank's 'model' shard of its weights, as the
reference's specs divide them (``ssm_pspecs``, ``rglru_pspecs``,
``attention_pspecs``), and the decode state is laid out as the reference's
specs lay it out: each SSM and RG-LRU state holds the rank's channels, and
whisper's cross cache the rank's run of encoder positions.  Four children
(``python -c``, gloo, one torch thread each, ``jax`` never imported) run on
a (data 2, model 2) and a (data 1, model 4) mesh.  Reduced float32
falcon-mamba-7b, recurrentgemma-9b and whisper-base, their weights carried
across by ``bridge`` and their inputs made from a numpy seed, are held to
the reference's single-device values, computed in this process meanwhile,
within 2e-3 (as ``tests/test_multidevice.py``):

* each layer on layer 0's weights: ``ssm_forward`` and ``ssm_step``,
  ``rglru_forward`` and ``rglru_step``, each with the state it leaves (the
  rank's shard against the same channel slice of the reference's state),
  and the cross-attention forward, its cache (the rank's slots) and its
  decode step;
* each rank's weights as the path takes them: the spec's share of every
  leaf, and ``in_proj``'s two column ranges by value;
* the slice: ``prefill`` and 3 greedy ``decode_step``s (logits, tokens
  equal, and every decode-state shard after the prefill and after the last
  step against the reference's state);
* where the model axis does not divide: whisper with 6 heads (4 model
  ranks), recurrentgemma with an RG-LRU width of 130 (4 model ranks) and
  whisper on 25 encoder frames (neither mesh) compute those layers (or
  that cache) whole and give the same values.

Rank 0's counted FLOPs (``core.step_count`` on a ``fake`` (2, 2) group) of
the reduced falcon-mamba-7b and recurrentgemma-9b prefill and decode cells
are held within 2 % of the reference's ``hlo_analysis`` of the programs
compiled for a (2, 2) mesh of 4 host devices, ``tests/test_torch_tp.py``'s
counting children run for these cells.  The terms by which XLA's program
differs are named and added (:func:`_xla_terms`).
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
from repro.models import attention as JA  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from test_torch_tp import (_free_port, _reprojection_flops,  # noqa: E402
                           _save, start_counts)

WORLD = 4
TOL = 2e-3
FLOPS_REL = 0.02
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, S, W, STEPS = 4, 24, 32, 3
ODD_FRAMES = 25                      # encoder frames neither mesh divides
ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b", "whisper-base")
# the cases the model axis does not divide (on (1, 4); the odd frames on
# both meshes), by name: (config, encoder frames)
UNEVEN = {"whisper-6-heads": ("whisper-6-heads", S),
          "rglru-width-130": ("rglru-width-130", S),
          "whisper-25-frames": ("whisper-base", ODD_FRAMES)}
SLICES = {**{a: (a, S) for a in ARCHS}, **UNEVEN}
CONFIGS = ARCHS + ("whisper-6-heads", "rglru-width-130")
# layer 0's checks, by arch
LAYER_LEAVES = {
    "falcon-mamba-7b": ("ssm_forward", "ssm_state", "ssm_step",
                        "ssm_step_state"),
    "recurrentgemma-9b": ("rglru_forward", "rglru_state", "rglru_step",
                          "rglru_step_state"),
    "whisper-base": ("cross_forward", "cross_cache", "cross_decode")}
LAYER_CASES = [(a, leaf) for a, leaves in LAYER_LEAVES.items()
               for leaf in leaves]


def _cfg(get, name):
    """The reduced float32 configs, by the same rules in both packages."""
    base = {"whisper-6-heads": "whisper-base",
            "rglru-width-130": "recurrentgemma-9b"}.get(name, name)
    cfg = get(base, reduced=True).replace(dtype="float32")
    if name == "whisper-6-heads":
        cfg = cfg.replace(num_heads=6)
    if name == "rglru-width-130":
        cfg = cfg.replace(rglru=dataclasses.replace(cfg.rglru,
                                                    lru_width=130))
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
from repro_torch.models import rglru as R
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as T
from repro_torch.parallel import shardctx

D = os.environ["TP_DIR"]
SLICES = json.loads(os.environ["TP_SLICES"])
ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b", "whisper-base")
B, S, W, STEPS = 4, 24, 32, 3
assert meshlib.init_distributed() == "gloo"
rank = torch.distributed.get_rank()


def cfg_of(name):
    base = {"whisper-6-heads": "whisper-base",
            "rglru-width-130": "recurrentgemma-9b"}.get(name, name)
    cfg = get_config(base, reduced=True).replace(dtype="float32")
    if name == "whisper-6-heads":
        cfg = cfg.replace(num_heads=6)
    if name == "rglru-width-130":
        cfg = cfg.replace(rglru=dataclasses.replace(cfg.rglru,
                                                    lru_width=130))
    return cfg


def load(like, name):
    with np.load(os.path.join(D, name + ".npz")) as z:
        return pytree.unflatten(like, iter(
            torch.from_numpy(z[k].copy())
            for k in pytree.flatten_with_paths(like)))


def arr(name):
    return torch.from_numpy(np.load(os.path.join(D, name + ".npy")))


def shard(t):
    # a state leaf as this rank holds it: its local values and the
    # dimension (from the end) split over 'model', None when whole
    dim = None
    if shardctx.is_dtensor(t):
        (p,) = t.placements
        dim = p.dim - t.dim()
    return {"value": shardctx.local(t).tolist(), "dim": dim}


def states(reps):
    return {f"{i}/{key}/{f}": shard(getattr(nt, f))
            for i, part in enumerate(reps) for key, nt in part.items()
            for f in nt._fields if getattr(nt, f) is not None}


def params_of(name, mesh):
    cfg = cfg_of(name)
    whole = load(T.init_model(cfg, torch.Generator(), "meta"), name)
    return cfg, shardctx.layout_tree(whole, T.model_pspecs(cfg)[1], mesh)


out = {"jax": False}
for mesh_name, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
    mesh = MeshPlan("base", data=shape[0], model=shape[1]).build()
    res = out[mesh_name] = {
        "data": mesh.get_local_rank("data"),
        "model": mesh.get_local_rank("model"),
        "rows": shardctx.batch_shard(torch.arange(B), mesh).tolist()}
    x = shardctx.batch_shard(arr("x"), mesh)
    xn = shardctx.batch_shard(arr("x_new"), mesh)
    enc = shardctx.batch_shard(arr("audio"), mesh)
    # layer 0 of each arch: the mixer (whisper: the cross-attention) on the
    # weights as the tensor-parallel path takes them
    layer = res["layer"] = {}
    for arch in ARCHS:
        cfg, params = params_of(arch, mesh)
        kind = T._pattern(cfg)[0]
        blk = T._index(params["reps"][0], 0)
        r = layer[arch] = {}
        with torch.no_grad(), shardctx.use_mesh(mesh):
            w, tp = T._tp_block_params(blk, cfg, kind)
            r["tp"] = tp
            sub = "cross_attn" if cfg.cross_attention else "mixer"
            r["bytes"] = {k: [shardctx.local(v).numel(),
                              int(np.prod(blk[sub][k].shape))]
                          for k, v in w[sub].items()}
            if kind == "ssm":
                r["in_proj"] = w["mixer"]["in_proj"].tolist()
            if kind in ("ssm", "rglru"):
                fwd, step = ((SM.ssm_forward, SM.ssm_step) if kind == "ssm"
                             else (R.rglru_forward, R.rglru_step))
                y, st = fwd(w["mixer"], x, cfg, return_state=True,
                            tp=tp["mixer"])
                r[kind + "_forward"] = y.tolist()
                r[kind + "_state"] = {f: shard(getattr(st, f))
                                      for f in st._fields}
                y, st = step(w["mixer"], st, xn, cfg, tp=tp["mixer"])
                r[kind + "_step"] = y.tolist()
                r[kind + "_step_state"] = {f: shard(getattr(st, f))
                                           for f in st._fields}
            else:
                r["cross_forward"] = A.full_attention(
                    w["cross_attn"], x, None, cfg, causal=False,
                    encoder_out=enc, tp=tp["cross"]).tolist()
                c = A.build_cross_cache(w["cross_attn"], enc, cfg,
                                        tp=tp["cross"])
                r["cross_cache"] = {"k": shard(c.k), "v": shard(c.v)}
                pos = torch.full((x.shape[0],), enc.shape[1],
                                 dtype=torch.long)
                y, _ = A.decode_attention(w["cross_attn"], c, xn, pos, cfg,
                                          update=False, cross=True,
                                          tp=tp["cross"])
                r["cross_decode"] = y.tolist()
    # the slices: prefill then greedy decode steps, each rank feeding its
    # own argmax, and the decode state after the prefill and the last step
    for case, (name, frames) in SLICES.items():
        cfg, params = params_of(name, mesh)
        batch = {"tokens": shardctx.batch_shard(arr("tokens").long(), mesh)}
        if cfg.encoder_layers:
            batch["audio_embeds"] = shardctx.batch_shard(
                arr("audio" if frames == S else "audio_odd"), mesh)
        rt = T.Runtime(remat=False)
        with torch.no_grad(), shardctx.use_mesh(mesh):
            tp = {kind: T._tp_block_params(T._index(params["reps"][i], 0),
                                           cfg, kind)[1]
                  for i, kind in enumerate(T._pattern(cfg))}
            lg, st = T.prefill(params, batch, cfg, rt, window=W)
            prefilled = states(st.reps)
            logits, toks = [lg.tolist()], [lg.argmax(-1).tolist()]
            for _ in range(STEPS):
                lg, st = T.decode_step(params, st,
                                       torch.tensor(toks[-1])[:, None], cfg,
                                       rt)
                logits.append(lg.tolist())
                toks.append(lg.argmax(-1).tolist())
        res[case] = {"tp": tp, "logits": logits, "tokens": toks,
                     "prefill_state": prefilled, "state": states(st.reps)}

out["jax"] = "jax" in sys.modules
assert not out["jax"]
with open(os.path.join(D, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
torch.distributed.destroy_process_group()
"""


def _numpy_state(reps):
    """{path: array} of a reference ``DecodeState.reps``, as the children
    key theirs."""
    return {f"{i}/{key}/{f}": np.asarray(getattr(nt, f))
            for i, part in enumerate(reps) for key, nt in part.items()
            for f in nt._fields if getattr(nt, f) is not None}


def _greedy(params, batch, cfg, rt):
    lg, st = JT.prefill(params, batch, cfg, rt, window=W)
    prefilled = _numpy_state(st.reps)
    logits, toks = [np.asarray(lg)], [np.asarray(jnp.argmax(lg, -1))]
    for _ in range(STEPS):
        lg, st = JT.decode_step(params, st, jnp.asarray(toks[-1])[:, None],
                                cfg, rt)
        logits.append(np.asarray(lg))
        toks.append(np.asarray(jnp.argmax(lg, -1)))
    return {"logits": logits, "tokens": toks, "prefill_state": prefilled,
            "state": _numpy_state(st.reps)}


def _layer_oracle(cfg, jp, x, xn, enc):
    blk = jax.tree.map(lambda a: a[0], jp["reps"][0])
    o = {}
    if cfg.ssm is not None or cfg.rglru is not None:
        kind, mod = (("ssm", JS) if cfg.ssm is not None else ("rglru", JR))
        fwd, step = getattr(mod, kind + "_forward"), getattr(mod, kind +
                                                             "_step")
        y, st = fwd(blk["mixer"], x, cfg, return_state=True)
        o[kind + "_forward"] = np.asarray(y)
        o[kind + "_state"] = {f: np.asarray(getattr(st, f))
                              for f in st._fields}
        y, st = step(blk["mixer"], st, xn, cfg)
        o[kind + "_step"] = np.asarray(y)
        o[kind + "_step_state"] = {f: np.asarray(getattr(st, f))
                                   for f in st._fields}
        o["in_proj"] = np.asarray(blk["mixer"]["in_proj"]) \
            if kind == "ssm" else None
        return o
    o["cross_forward"] = np.asarray(JA.full_attention(
        blk["cross_attn"], x, None, cfg, causal=False, encoder_out=enc))
    c = JA.build_cross_cache(blk["cross_attn"], enc, cfg)
    o["cross_cache"] = {"k": np.asarray(c.k), "v": np.asarray(c.v)}
    o["cross_decode"] = np.asarray(JA.decode_attention(
        blk["cross_attn"], c, xn, jnp.full((B,), enc.shape[1], jnp.int32),
        cfg, update=False, cross=True)[0])
    return o


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_recurrent"))
    rng = np.random.default_rng(26)
    data = {"x": rng.standard_normal((B, S, 128)),
            "x_new": rng.standard_normal((B, 1, 128)),
            "audio": rng.standard_normal((B, S, 128)),
            "audio_odd": rng.standard_normal((B, ODD_FRAMES, 128))}
    data = {k: v.astype(np.float32) for k, v in data.items()}
    data["tokens"] = rng.integers(0, 512, (B, S)).astype(np.int32)
    for name, a in data.items():
        np.save(os.path.join(d, name + ".npy"), a)
    ref = {}
    for name in CONFIGS:
        cfg = _cfg(jget_config, name)
        jp, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
        ref[name] = (cfg, jp)
        _save(os.path.join(d, name), bridge.params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        e = dict(env, TP_DIR=d, TP_SLICES=json.dumps(SLICES), RANK=str(r),
                 WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port))
        e.pop("LOCAL_RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD], env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    counts = {arch: start_counts(env, arch, ("prefill", "decode"))
              for arch in ARCHS[:2]}

    # the oracles, while the children run
    oracle = {"layer": {}}
    x, xn, enc = (jnp.asarray(data[k]) for k in ("x", "x_new", "audio"))
    for arch in ARCHS:
        oracle["layer"][arch] = _layer_oracle(*ref[arch], x, xn, enc)
    rt = JT.Runtime(production=False, remat=False)
    for case, (name, frames) in SLICES.items():
        cfg, jp = ref[name]
        batch = {"tokens": jnp.asarray(data["tokens"])}
        if cfg.encoder_layers:
            batch["audio_embeds"] = jnp.asarray(
                data["audio"] if frames == S else data["audio_odd"])
        oracle[case] = _greedy(jp, batch, cfg, rt)

    children = procs + [p for pair in counts.values() for p in pair]
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
    oracle["counts"] = {}
    for i, arch in enumerate(ARCHS[:2]):
        fake, compiled = (json.loads(logs[WORLD + 2 * i + j].strip()
                                     .splitlines()[-1]) for j in (0, 1))
        oracle["counts"][arch] = {"fake": fake, "compiled": compiled,
                                  "cfg": ref[arch][0]}
    outs = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return oracle, outs


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _n(mesh) -> int:
    return MESHES[mesh][1]


# the dimension (from the end) the reference's specs split over 'model':
# the SSM's ``h`` by channel (B, di, N), the conv tails and the RG-LRU's
# ``h`` by their last (channel) dimension, the rings and cross caches
# (B, positions, KV, hd) by position
STATE_DIM = {("ssm", "h"): -2, ("ssm", "conv"): -1, ("rglru", "h"): -1,
             ("rglru", "conv"): -1, ("attn", "k"): -3, ("attn", "v"): -3}


def _check_state(got, want, rows, n, m, kinds, whole):
    """Every leaf of a stacked state (R, B, ...): the rank's shard against
    the reference's rows and, split over 'model' by the spec's dimension
    unless its path is in ``whole``, its chunk ``m`` of ``n``."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for path, leaf in got.items():
        i, _, field = path.split("/")
        dim = None if path in whole else STATE_DIM[(kinds[int(i)], field)]
        assert leaf["dim"] == dim, (path, leaf["dim"], dim)
        w = want[path][:, rows]
        if dim is not None:
            w = np.split(w, n, axis=dim)[m]
        assert np.shape(leaf["value"]) == w.shape, (path, w.shape)
        assert _err(leaf["value"], w) < TOL, path


def test_children_never_import_jax(run):
    _, outs = run
    assert [o["jax"] for o in outs] == [False] * WORLD
    assert sorted((o["2x2"]["data"], o["2x2"]["model"]) for o in outs) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert sorted(o["1x4"]["model"] for o in outs) == [0, 1, 2, 3]


@pytest.mark.parametrize("arch,leaf", LAYER_CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_layer_matches_reference(run, mesh, arch, leaf):
    """Layer 0's mixer (whisper: cross-attention) on the rank's shards, its
    output on the rank's rows and its state's shard, within 2e-3."""
    oracle, outs = run
    want = oracle["layer"][arch][leaf]
    n = _n(mesh)
    for o in outs:
        r = o[mesh]["layer"][arch]
        rows, m = o[mesh]["rows"], o[mesh]["model"]
        sub = "cross" if arch == "whisper-base" else "mixer"
        assert r["tp"][sub] is True, r["tp"]
        got = r[leaf]
        if not isinstance(got, dict):
            assert _err(got, want[rows]) < TOL, (mesh, arch, leaf)
            continue
        for f, g in got.items():
            kind = ("attn" if arch == "whisper-base" else
                    leaf.split("_")[0])
            dim = STATE_DIM[(kind, f)]
            assert g["dim"] == dim, (leaf, f, g["dim"])
            w = np.split(want[f][rows], n, axis=dim)[m]
            assert np.shape(g["value"]) == w.shape, (leaf, f, w.shape)
            assert _err(g["value"], w) < TOL, (mesh, arch, leaf, f)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_weights_at_spec_share(run, mesh, arch):
    """Every leaf of the layer at the spec's share: the mixers' leaves all
    split over 'model' (d_inner or W), the cross-attention's but ``wk`` /
    ``wv``, which the spec replicates for 2 KV heads; ``in_proj``'s two
    column ranges by value."""
    oracle, outs = run
    n = _n(mesh)
    for o in outs:
        r = o[mesh]["layer"][arch]
        for k, (mine, whole) in r["bytes"].items():
            split = arch != "whisper-base" or k in ("wq", "wo")
            assert mine * (n if split else 1) == whole, (mesh, arch, k)
        if arch != "falcon-mamba-7b":
            continue
        w = oracle["layer"][arch]["in_proj"]
        di = w.shape[1] // 2
        c, m = di // n, o[mesh]["model"]
        want = np.concatenate([w[:, m * c:(m + 1) * c],
                               w[:, di + m * c:di + (m + 1) * c]], axis=1)
        assert np.array_equal(np.asarray(r["in_proj"], np.float32), want)


def _expected_tp(case, mesh):
    """Which sublayers of each block kind compute on shards, by case."""
    on = {"mixer": True, "ffn": True, "cross": False}
    four = mesh == "1x4"
    if case == "falcon-mamba-7b":
        return {"ssm": {"mixer": True, "ffn": False, "cross": False}}
    if case in ("recurrentgemma-9b", "rglru-width-130"):
        # 130 channels on 4 model ranks: the RG-LRU mixer whole
        rg = dict(on, mixer=not (four and case == "rglru-width-130"))
        return {"rglru": rg, "attn": on}
    # whisper: 6 heads on 4 model ranks, self- and cross-attention whole
    split = not (four and case == "whisper-6-heads")
    return {"attn": dict(on, mixer=split, cross=split)}


@pytest.mark.parametrize("case", list(SLICES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_slice_tokens_logits_and_states(run, mesh, case):
    """prefill + 3 greedy steps: tokens equal, logits within 2e-3, and each
    rank's decode-state shards (after the prefill and after the last step)
    against the reference state's slices.  Where the model axis does not
    divide, the layer computes whole (or the cross cache stays whole)."""
    oracle, outs = run
    want = oracle[case]
    cfg = _cfg(jget_config, SLICES[case][0])
    kinds = JT._pattern(cfg)
    n = _n(mesh)
    expected = _expected_tp(case, mesh)
    whole = set()
    for i, kind in enumerate(kinds):
        if kind != "attn" and not expected[kind]["mixer"]:
            whole |= {f"{i}/self/conv", f"{i}/self/h"}
    if SLICES[case][1] % n:
        whole |= {f"{i}/cross/k" for i in range(len(kinds))}
        whole |= {f"{i}/cross/v" for i in range(len(kinds))}
    for o in outs:
        got = o[mesh][case]
        rows, m = o[mesh]["rows"], o[mesh]["model"]
        assert got["tp"] == expected, (mesh, case, got["tp"])
        for i in range(STEPS + 1):
            assert got["tokens"][i] == want["tokens"][i][rows].tolist(), i
            assert _err(got["logits"][i], want["logits"][i][rows]) < TOL, i
        for key in ("prefill_state", "state"):
            _check_state(got[key], want[key], rows, n, m, kinds, whole)


def _xla_terms(cfg, kind, Bp=4, Sp=64, data=2, model=2) -> float:
    """What the port's count of a reduced (2, 2) cell adds to the compiled
    reference's (negative where XLA computes more), term by term:

    * the port's second q/k/v projection in ``prefill_cache``, which XLA's
      CSE folds (``_reprojection_flops``);
    * XLA's k / v projection, for the ring it lays out over 'model', of the
      rank's S / n positions, every (replicated) KV head, again;
    * XLA's tied LM head on the prefill's last position: all Bp batch rows
      against V / n columns of the gathered table, where the port's
      row-parallel head contracts its D / n on its Bp / data rows.
    """
    if kind != "prefill":
        return 0.0
    hd, d = cfg.resolved_head_dim, cfg.d_model
    n_attn = sum(k == "attn" for k in cfg.layer_kinds)
    ring = n_attn * 2.0 * (Bp // data) * (Sp // model) * d * (
        2 * cfg.num_kv_heads * hd)
    head = 0.0
    if cfg.tie_embeddings:
        V = cfg.vocab_size
        head = 2.0 * Bp * d * (V // model) - 2.0 * (Bp // data) * (
            d // model) * V
    return _reprojection_flops(cfg, Bp, Sp, data, model) - ring - head


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS[:2])
def test_counted_flops_match_compiled_program(run, arch, kind):
    oracle, _ = run
    c = oracle["counts"][arch]
    ref = c["compiled"][kind]
    assert ref["unresolved"] == 0 and ref["flops"] > 0
    want = ref["flops"] + _xla_terms(c["cfg"], kind)
    got = c["fake"][kind]["flops"]
    assert got == pytest.approx(want, rel=FLOPS_REL), (arch, kind, got, want)
    assert c["fake"][kind]["coll"]["all-reduce"] > 0
