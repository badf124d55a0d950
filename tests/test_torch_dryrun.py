"""The port's HLO analyzer, step counter and dry-run against the reference.

* ``hlo_analysis.analyze`` gives equal ``HLOCost``s from both packages on
  the reference's compiled HLO of a reduced qwen3-14b prefill (its layer
  scan and attention loops are ``while`` loops) and on a small module
  written here, each collective in a ``while`` body of constant trip count.
* ``make_batch_specs``: the reference's keys, shapes and dtypes, on ``meta``.
* ``core.step_count``: its FLOPs against the reference's ``hlo_analysis``
  FLOPs of the same reduced float32 programs on the same weights
  (``bridge``): a decode step within 2 %, a training step within 5 %.  The
  port's prefill builds each attention layer's cache by projecting q, k
  and v a second time (``attention.prefill_cache``), which XLA's CSE folds
  into the first projection; the prefill case holds the count to the
  compiled program's FLOPs plus exactly those projections (2 %), and
  asserts that they are the whole gap.
* The counts of a step on ``meta`` equal the same step's on real CPU
  tensors, exactly.
* One child process (``python -c``, never ``jax``) joins a ``fake`` group of
  4 and runs ``dryrun.build_cell`` on a (data 2, model 2) mesh for reduced
  train, prefill and decode cells, then ``run_cell`` on the 16x16 mesh for
  whisper-base's full ``decode_32k`` (the reference's artifact schema) and
  a ``long_500k`` cell ``shape_applicable`` skips; and a reduced whisper
  train step on (data 1, model 8), whose 1500 audio frames the model axis
  does not divide: under ``seq_shard`` the encoder's stream stays whole.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.core import hlo_analysis as JH  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.core import hlo_analysis as PH  # noqa: E402
from repro_torch.core.step_count import StepCounter  # noqa: E402
from repro_torch.data import pipeline as PD  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("qwen3-14b", "deepseek-moe-16b")
B, S = 2, 64                       # prefill / decode
TRAIN_SHAPE = (32, 4)              # seq, batch
Q_BLOCK, KV_BLOCK, LOSS_CHUNK = 16, 32, 8
FLOPS_REL = {"prefill": 0.02, "decode": 0.02, "train": 0.05}


def _compiled_hlo(fn, *args) -> str:
    return jax.jit(fn).lower(*args).compile().as_text()


@pytest.fixture(scope="module")
def programs():
    """Per arch: the reference's compiled HLO of a reduced float32 prefill,
    decode step and training step, and the port's inputs on the same
    weights and state."""
    out = {}
    for arch in ARCHS:
        jc = jget_config(arch, reduced=True).replace(dtype="float32")
        pc = get_config(arch, reduced=True).replace(dtype="float32")
        jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
        pp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        toks = np.random.default_rng(3).integers(
            0, jc.vocab_size, (B, S)).astype(np.int32)
        jrt = JT.Runtime(use_kernels=False, remat=False, q_block=Q_BLOCK,
                         kv_block=KV_BLOCK)
        prt = T.Runtime(use_kernels=False, remat=False, q_block=Q_BLOCK,
                        kv_block=KV_BLOCK)
        hlo = {
            "prefill": _compiled_hlo(
                lambda p, b: JT.prefill(p, b, jc, jrt), jp,
                {"tokens": jnp.asarray(toks)}),
            "decode": _compiled_hlo(
                lambda p, s, t: JT.decode_step(p, s, t, jc, jrt), jp,
                JT.init_decode_state(jc, B, S), jnp.asarray(toks[:, :1])),
        }
        seq, batch = TRAIN_SHAPE
        trt = dict(use_kernels=False, remat=True, q_block=Q_BLOCK,
                   kv_block=KV_BLOCK, loss_chunk=LOSS_CHUNK)
        jtr = JTrainer(jc, JShape("t", seq, batch, "train"), JTrain(),
                       rt=JT.Runtime(**trt))
        jstate = jtr.init_state(0)
        hlo["train"] = _compiled_hlo(jtr.make_step_body(), jstate,
                                     jtr.place_batch(jtr.data.batch_at(0)))
        ptr = Trainer(pc, ShapeConfig("t", seq, batch, "train"),
                      TrainConfig(), rt=T.Runtime(**trt), device="cpu")
        out[arch] = dict(
            cfg=pc, params=pp, tokens=torch.from_numpy(toks).long(), rt=prt,
            hlo=hlo, trainer=ptr,
            state=bridge.train_state_from_numpy(
                jax.tree.map(np.asarray, jstate), "cpu"))
    return out


def _count(fn, args) -> StepCounter:
    with StepCounter(args) as sc:
        fn(*args)
    return sc


def _port_step(prog, kind: str, device: str):
    """(fn, args) of the port's ``kind`` step on ``device``: the bridged
    weights and state on the CPU, their layouts on ``meta``."""
    cfg, rt = prog["cfg"], prog["rt"]
    meta = device == "meta"

    def on(tree):
        from repro_torch import pytree
        return pytree.map_(
            lambda t: torch.empty_like(t, device="meta") if meta else t,
            tree)

    if kind == "train":
        tr = prog["trainer"]
        batch = tr.place_batch(tr.data.batch_at(0))
        state = on(prog["state"]) if meta else \
            tr.place_state(_clone(prog["state"]))
        return tr.step, (state, on(batch))
    params = on(prog["params"])
    if kind == "prefill":
        def prefill(p, b):
            with torch.no_grad():
                return T.prefill(p, b, cfg, rt)
        return prefill, (params, {"tokens": on(prog["tokens"])})
    state = T.init_decode_state(cfg, B, S, device=device)

    def decode(p, s, t):
        with torch.no_grad():
            return T.decode_step(p, s, t, cfg, rt)
    return decode, (params, state, on(prog["tokens"][:, :1].clone()))


def _clone(tree):
    from repro_torch import pytree
    return pytree.map_(lambda t: t.clone(), tree)


def _reprojection_flops(cfg) -> float:
    """FLOPs of the second q/k/v projection ``prefill_cache`` makes in each
    attention layer of the port's prefill."""
    n_attn = sum(k == "attn" for k in cfg.layer_kinds)
    width = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.resolved_head_dim
    return n_attn * 2.0 * B * S * cfg.d_model * width


# ---------------------------------------------------------------------------
# hlo_analysis
# ---------------------------------------------------------------------------

LOOP_HLO = """HloModule collectives_in_a_loop

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

%cond (p: (s32[], f32[8,16])) -> pred[] {
  %p = (s32[], f32[8,16]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(6)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

%body (q: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {
  %q = (s32[], f32[8,16]) parameter(0)
  %j = s32[] get-tuple-element(%q), index=0
  %x = f32[8,16]{1,0} get-tuple-element(%q), index=1
  %w = f32[16,16]{1,0} constant({...})
  %d = f32[8,16]{1,0} dot(%x, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ag = f32[32,16]{1,0} all-gather(%d), dimensions={0}, replica_groups={{0,1,2,3}}
  %ar = f32[32,16]{1,0} all-reduce(%ag), replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = f32[8,16]{1,0} reduce-scatter(%ar), dimensions={0}, replica_groups={{0,1,2,3}}, to_apply=%add
  %aa = bf16[8,16]{1,0} all-to-all(%rs), dimensions={0}, replica_groups={{0,1,2,3}}
  %cp = f32[8,16]{1,0} collective-permute(%rs), source_target_pairs={{0,1},{1,2},{2,3},{3,0}}
  %one = s32[] constant(1)
  %k = s32[] add(%j, %one)
  ROOT %t = (s32[], f32[8,16]) tuple(%k, %cp)
}

ENTRY %main (x0: f32[8,16]) -> f32[8,16] {
  %x0 = f32[8,16]{1,0} parameter(0)
  %zero = s32[] constant(0)
  %init = (s32[], f32[8,16]) tuple(%zero, %x0)
  %loop = (s32[], f32[8,16]) while(%init), condition=%cond, body=%body
  ROOT %out = f32[8,16]{1,0} get-tuple-element(%loop), index=1
}
"""


def _cost_fields(c) -> dict:
    return {"flops": c.flops, "coll_bytes": c.coll_bytes,
            "coll_breakdown": dict(c.coll_breakdown),
            "hbm_bytes": c.hbm_bytes,
            "unresolved_loops": c.unresolved_loops,
            "loops": [tuple(x) for x in c.loops],
            "top_collectives": [tuple(x) for x in c.top_collectives]}


def test_hlo_analysis_equal_on_the_reference_prefill(programs):
    text = programs["qwen3-14b"]["hlo"]["prefill"]
    a, b = JH.analyze(text), PH.analyze(text)
    assert _cost_fields(a) == _cost_fields(b)
    assert a.flops > 0 and len(a.loops) >= 2 and a.unresolved_loops == 0
    ca, ea = JH.parse_module(text)
    cb, eb = PH.parse_module(text)
    assert ea == eb and sorted(ca) == sorted(cb)


def test_hlo_analysis_equal_on_collectives_in_a_loop():
    a, b = JH.analyze(LOOP_HLO), PH.analyze(LOOP_HLO)
    assert _cost_fields(a) == _cost_fields(b)
    assert a.loops == [("loop", 6)] and a.unresolved_loops == 0
    assert a.flops == 6 * 2.0 * 8 * 16 * 16
    assert a.coll_breakdown == {
        "all-gather": 6 * 32 * 16 * 4.0, "all-reduce": 6 * 32 * 16 * 4.0,
        "reduce-scatter": 6 * 8 * 16 * 4.0, "all-to-all": 6 * 8 * 16 * 2.0,
        "collective-permute": 6 * 8 * 16 * 4.0}
    assert PH.COLLECTIVE_OPS == JH.COLLECTIVE_OPS


# ---------------------------------------------------------------------------
# make_batch_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-14b", "whisper-base", "qwen2-vl-7b"])
def test_make_batch_specs_equal(arch):
    shape = SHAPES["train_4k"]
    want = JD.make_batch_specs(jget_config(arch), shape)
    got = PD.make_batch_specs(get_config(arch), shape)
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(v.dtype), k
        assert got[k].is_meta


# ---------------------------------------------------------------------------
# step_count against hlo_analysis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_count_flops_match_hlo(programs, arch, kind):
    prog = programs[arch]
    ref = JH.analyze(prog["hlo"][kind])
    assert ref.unresolved_loops <= 1 and ref.flops > 0
    got = _count(*_port_step(prog, kind, "cpu")).flops
    want = ref.flops
    if kind == "prefill":
        extra = _reprojection_flops(prog["cfg"])
        assert got - ref.flops == extra
        want = ref.flops + extra
    assert got == pytest.approx(want, rel=FLOPS_REL[kind]), (got, want)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_count_meta_equals_cpu(programs, arch, kind):
    prog = programs[arch]
    a = _count(*_port_step(prog, kind, "meta"))
    b = _count(*_port_step(prog, kind, "cpu"))
    for f in ("flops", "hbm_bytes", "coll_bytes", "coll_breakdown",
              "peak_bytes", "arg_bytes", "ops", "flops_by_op"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.flops > 0 and a.peak_bytes > a.arg_bytes > 0


# ---------------------------------------------------------------------------
# the dry-run on a fake group, in a child
# ---------------------------------------------------------------------------

CHILD = r"""
import json, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.fusion import MeshPlan
from repro_torch.core.step_count import StepCounter
from repro_torch.launch import dryrun

out = {}
cells = [("qwen3-14b", ShapeConfig("t", 32, 4, "train")),
         ("deepseek-moe-16b", ShapeConfig("p", 64, 4, "prefill")),
         ("qwen3-14b", ShapeConfig("d", 64, 4, "decode"))]
for arch, shape in cells:
    cfg = get_config(arch, reduced=True)
    mesh = dryrun._join_fake_group(MeshPlan("base", data=2, model=2))
    try:
        fn, args = dryrun.build_cell(cfg, shape, mesh)
        with StepCounter(args) as sc:
            fn(*args)
    finally:
        dist.destroy_process_group()
    out[shape.kind] = {"flops": sc.flops, "hbm": sc.hbm_bytes,
                       "coll": sc.coll_breakdown, "peak": sc.peak_bytes,
                       "args": sc.arg_bytes}
# whisper's 1500 frames on 8 model ranks: the encoder's stream stays whole
# under seq_shard, and the step counts the FLOPs it counts without it
from repro_torch.data.pipeline import make_batch_specs
cfg = get_config("whisper-base", reduced=True)
shape = ShapeConfig("t", 32, 2, "train")
mesh = dryrun._join_fake_group(MeshPlan("base", data=1, model=8))
try:
    flops = []
    for seq in (True, False):
        tr = dryrun.cell_trainer(cfg, shape, mesh)
        tr.rt = tr.rt._replace(seq_shard=seq)
        state = tr.place_state(tr._restore_template())
        batch = dryrun._rows(make_batch_specs(cfg, shape), cfg, mesh)
        with StepCounter((state, batch)) as sc:
            tr.step(state, batch)
        flops.append(sc.flops)
finally:
    dist.destroy_process_group()
out["uneven_frames"] = flops
art = dryrun.run_cell("whisper-base", "decode_32k",
                      out_dir=os.environ["DRYRUN_OUT"], verbose=False)
skip = dryrun.run_cell("qwen3-14b", "long_500k",
                       out_dir=os.environ["DRYRUN_OUT"], verbose=False)
out["skipped"] = skip
out["artifact"] = sorted(art)
out["files"] = sorted(os.listdir(os.environ["DRYRUN_OUT"]))
out["group_left"] = dist.is_initialized()
out["jax"] = "jax" in sys.modules
print(json.dumps(out))
"""

ART_KEYS = sorted([
    "arch", "shape", "mesh", "plan", "kind", "chips", "skipped",
    "flops_per_device", "hbm_bytes_per_device",
    "collective_bytes_per_device", "collective_breakdown", "model_flops",
    "per_chip_batch", "peak_bytes_per_device", "argument_size_in_bytes",
    "trace_s", "roofline", "raw"])


def test_build_cell_on_a_fake_group(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, DRYRUN_OUT=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", CHILD], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert not out["jax"] and not out["group_left"]
    for kind in ("train", "prefill", "decode"):
        c = out[kind]
        assert c["flops"] > 0 and c["peak"] > c["args"] > 0, (kind, c)
    # FSDP gathers and the gradient all-reduce; the sequence-sharded
    # prefill's gathers; the decode's log-sum-exp over the model ranks
    assert out["train"]["coll"]["all-gather"] > 0
    assert out["train"]["coll"]["all-reduce"] > 0
    assert out["prefill"]["coll"]["all-gather"] > 0
    assert out["decode"]["coll"]["all-reduce"] > 0
    seq, whole = out["uneven_frames"]
    assert seq == whole > 0
    assert out["artifact"] == ART_KEYS
    assert out["files"] == ["whisper-base__decode_32k__16x16.json"]
    assert out["skipped"]["skipped"] and out["skipped"]["arch"] == "qwen3-14b"
    with open(tmp_path / out["files"][0]) as f:
        art = json.load(f)
    assert art["chips"] == 256 and art["mesh"] == "16x16"
    assert art["kind"] == "decode" and art["flops_per_device"] > 0
    assert set(art["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                    "bottleneck"}
    assert set(art["raw"]) >= {"ops", "top_collectives", "arg_bytes"}
