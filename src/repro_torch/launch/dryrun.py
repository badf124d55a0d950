"""Multi-pod dry-run: count every (arch x shape x mesh) cell on one host.

Counterpart of ``repro/launch/dryrun.py``.  For each cell this builds the
real program of the phase — the full training step (loss + grad + AdamW)
for train shapes, ``prefill`` for prefill shapes, one-token
``decode_step`` against the full-length KV/state cache for decode shapes —
with parameters, optimizer state and caches laid out by their resolved
specs (``parallel/resolve.py``) on the 16x16 single-pod mesh, the 2x16x16
multi-pod mesh, or a named AMOEBA plan, and runs it once on rank 0 of that
mesh under :class:`~repro_torch.core.step_count.StepCounter`.

Nothing is allocated, as the reference allocates nothing:

* **The mesh.**  Where the reference forces 512 placeholder host devices,
  this joins a ``fake`` process group of exactly the mesh's size in this
  process and builds the plan's ``DeviceMesh`` on it
  (``MeshPlan.build(device_type="cpu")``).  Its collectives move nothing
  and are counted all the same.  The group is torn down after each cell.
* **The state.**  Parameters, optimizer state, caches and inputs live on
  the ``meta`` device (``T.model_pspecs``, ``Trainer._restore_template``,
  ``make_batch_specs``); each rank's share is laid out as the port lays it
  out, so the step runs the ops rank 0 would run.
* **The runtime.**  ``use_kernels=False``, as the reference's ``_rt``: on
  ``meta`` the kernel wrappers take their plain versions anyway.

The reference's choices are kept: ``_rt``, ``_micro_steps``,
``state_dtype="bfloat16"`` above 5e10 parameters, ``ENC_FRAMES``,
``shape_applicable``'s skips and ``model_flops``.

Each cell writes the reference's JSON artifact, with the keys that name
XLA artifacts replaced: ``lower_s`` and ``compile_s`` by ``trace_s`` (the
counted run's wall time); ``argument_size_in_bytes`` is the arguments'
bytes as there, and ``peak_bytes_per_device`` (the counted live peak)
stands in for ``memory_analysis()``'s temp and output sizes;
``generated_code_size_in_bytes`` and the ``cost_analysis_*`` raw fields
are dropped.  ``raw`` holds the counts by aten op and the largest
collectives.  The roofline terms are against the port's ``H100``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k [--multi-pod] [--plan fused] \\
        [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, LM_SHAPES, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.fusion import MeshPlan
from repro_torch.core.step_count import profile_from_step
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import mesh as meshlib
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.parallel import shardctx
from repro_torch.train.trainer import Trainer

ENC_FRAMES = 1500
META = torch.device("meta")


def nonembed_params(cfg: ModelConfig) -> int:
    """Active parameters outside the embedding and unembedding tables."""
    n = cfg.active_param_count()
    emb = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        emb *= 2
    return n - emb


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful FLOPs of the whole step: 6*N*D train, 2*N*D forward."""
    n = nonembed_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: 1 token/seq


def _rt(shape: ShapeConfig) -> T.Runtime:
    """Production runtime: SP on for full-sequence phases."""
    return T.Runtime(production=True, remat=True, use_kernels=False,
                     q_block=512, kv_block=1024, loss_chunk=512,
                     seq_shard=shape.kind != "decode")


def _micro_steps(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Grad-accumulation heuristic: cap the saved-residual footprint.

    est = L x B_loc x (S / TP) x D bytes; keep it under ~4 GB/device.
    The reference's exemptions are kept (MoE, and models up to 5e10
    parameters, train un-accumulated), so every cell counts the step the
    reference compiles.
    """
    if shape.kind != "train":
        return 1
    if cfg.moe is not None:
        return 1
    if cfg.param_count() <= 5e10:
        return 1
    b_loc = max(shape.global_batch // 16, 1)
    est = cfg.num_layers * b_loc * (shape.seq_len / 16) * cfg.d_model * 4
    k = 1
    while est / k > 4e9 and k < 16 \
            and (shape.global_batch // 16) % (2 * k) == 0:
        k *= 2
    return k


def _rows(batch: Dict[str, torch.Tensor], cfg: ModelConfig, mesh):
    """This rank's rows of a global batch, typed as ``Trainer.place_batch``
    types them: int64 tokens, floating inputs in the model's dtype."""
    dtype = getattr(torch, cfg.dtype)
    return {k: shardctx.batch_shard(
        v.long() if k == "tokens" else v.to(dtype), mesh)
        for k, v in batch.items()}


def _rank_decode_state(cfg: ModelConfig, B: int, S: int, enc_len: int,
                       mesh) -> T.DecodeState:
    """The decode state rank 0 holds after the port's prefill under
    ``mesh``: its batch rows, each attention ring sequence-sharded over
    'model' where the model axis divides it (``attention._seq_shard_cache``,
    layer by layer, stacked as ``forward_hidden`` stacks them), the
    recurrent states and whisper's cross caches whole."""
    b = shardctx.batch_shard(torch.empty((B,), device=META), mesh).shape[0]
    st = T.init_decode_state(cfg, b, S, enc_len, device=META)

    def ring(part, stacked):
        if not isinstance(part.get("self"), attention.KVCache):
            return part
        cache = part["self"]
        if stacked:
            layers = [attention._seq_shard_cache(attention.KVCache(
                *(None if t is None else t[r] for t in cache)))
                for r in range(cache.k.shape[0])]
            cache = T._stack(layers)
        else:
            cache = attention._seq_shard_cache(cache)
        return dict(part, self=cache)

    with shardctx.use_mesh(mesh):
        return st._replace(reps=tuple(ring(p, True) for p in st.reps),
                           rest=tuple(ring(p, False) for p in st.rest))


def cell_trainer(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 device=META) -> Trainer:
    """The trainer of a train cell: the reference's ``TrainConfig`` and
    state dtype, ``_rt``'s runtime (on another device, the same step on
    real tensors)."""
    tcfg = TrainConfig(remat="full", micro_steps=_micro_steps(cfg, shape))
    return Trainer(cfg, shape, tcfg, rt=_rt(shape), mesh=mesh,
                   state_dtype="bfloat16"
                   if cfg.param_count() > 5e10 else None, device=device)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Returns (fn, args): ``fn(*args)`` runs rank 0's step of the cell on
    the ``meta`` device under ``mesh``."""
    rt = _rt(shape)
    B = shape.global_batch

    if shape.kind == "train":
        trainer = cell_trainer(cfg, shape, mesh, META)
        state = trainer.place_state(trainer._restore_template())
        batch = _rows(make_batch_specs(cfg, shape), cfg, mesh)
        return trainer.step, (state, batch)

    # serving paths need the parameter tree + decode state shapes
    params_shapes, pspecs = T.model_pspecs(cfg)
    params = shardctx.layout_tree(params_shapes, pspecs, mesh)

    if shape.kind == "prefill":
        batch = _rows(make_batch_specs(cfg, shape), cfg, mesh)

        def prefill_fn(params, batch):
            with torch.no_grad(), shardctx.use_mesh(mesh):
                return T.prefill(params, batch, cfg, rt)

        return prefill_fn, (params, batch)

    # decode: one new token against a seq_len-deep cache
    enc_len = ENC_FRAMES if cfg.encoder_layers else 0
    state = _rank_decode_state(cfg, B, shape.seq_len, enc_len, mesh)
    tokens = shardctx.batch_shard(
        torch.empty((B, 1), dtype=torch.long, device=META), mesh)

    def decode_fn(params, state, tokens):
        with torch.no_grad(), shardctx.use_mesh(mesh):
            return T.decode_step(params, state, tokens, cfg, rt)

    return decode_fn, (params, state, tokens)


def _cell_plan(multi_pod: bool, plan_name: str):
    if multi_pod:
        return meshlib.multi_pod_plan(), "pod2x16x16"
    if plan_name != "base":
        plan = meshlib.single_pod_plan(plan_name)
        return plan, f"{plan.data}x{plan.model}_{plan_name}"
    return meshlib.single_pod_plan(), "16x16"


def _join_fake_group(plan: MeshPlan):
    """Rank 0 of a ``fake`` process group of exactly the plan's size, and
    the plan's mesh on it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already joined; the "
                           "dry-run needs a fake group of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=plan.num_devices)
    return plan.build(device_type="cpu")


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             plan_name: str = "base",
             out_dir: str = "experiments/dryrun_torch",
             verbose: bool = True) -> Dict:
    """Count one cell and write its artifact into ``out_dir``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "quadratic attention at 500k (DESIGN.md §4)"}
    plan, mesh_name = _cell_plan(multi_pod, plan_name)
    mesh = _join_fake_group(plan)
    chips = plan.num_devices
    try:
        fn, args = build_cell(cfg, shape, mesh)
        prof = profile_from_step(
            f"{arch}/{shape_name}/{mesh_name}", fn, *args, chips=chips,
            model_flops=model_flops(cfg, shape),
            per_chip_batch=shape.global_batch * shape.seq_len / chips
            if shape.kind != "decode" else shape.global_batch / chips)
        del fn, args
    finally:
        dist.destroy_process_group()
    trace_s = prof.raw["trace_s"]

    art = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "plan": plan_name, "kind": shape.kind, "chips": chips,
        "skipped": False,
        "flops_per_device": prof.flops,
        "hbm_bytes_per_device": prof.hbm_bytes,
        "collective_bytes_per_device": prof.coll_bytes,
        "collective_breakdown": prof.coll_breakdown,
        "model_flops": prof.model_flops,
        "per_chip_batch": prof.per_chip_batch,
        "peak_bytes_per_device": prof.peak_memory,
        "argument_size_in_bytes": prof.raw["arg_bytes"],
        "trace_s": round(trace_s, 2),
        "roofline": prof.roofline(),
        "raw": prof.raw,
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if plan_name == "base" else f"__{plan_name}"
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    if verbose:
        r = art["roofline"]
        print(f"[dryrun] {arch} {shape_name} {mesh_name}: "
              f"compute={r['compute_s']:.4g}s memory={r['memory_s']:.4g}s "
              f"coll={r['collective_s']:.4g}s -> {r['bottleneck']} "
              f"peak={prof.peak_memory / 1e9:.2f}GB (trace {trace_s:.1f}s)",
              flush=True)
    return art


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in LM_SHAPES] + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--plan", default="base",
                    choices=["base", "fused", "scale_out"])
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell on the chosen mesh")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args()

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for s in LM_SHAPES:
                cells.append((arch, s.name))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    failures = []
    t0 = time.perf_counter()
    for arch, shape_name in cells:
        try:
            run_cell(arch, shape_name, multi_pod=args.multi_pod,
                     plan_name=args.plan, out_dir=args.out)
        except Exception:
            traceback.print_exc()
            failures.append((arch, shape_name))
    if failures:
        print(f"FAILED cells: {failures}")
        raise SystemExit(1)
    print(f"dry-run OK: {len(cells)} cells in "
          f"{time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
