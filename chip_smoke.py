#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA GPU: kernels, serving, parity,
training.

    python3 chip_smoke.py            # from the repository root, one card

Phases (every failure exits nonzero; no phase's failure is caught):

1. build   — compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
             (one process per source, started together) into ``build/``.
2. kernels — each hand-written kernel against its plain PyTorch version
             on the card, at the main paths' shapes, with its time (CUDA
             events, median), the plain version's time, one PyTorch
             library call's time where one computes the same function (a
             yardstick the port never calls) and the least time the card
             could take (``configs.base.H100``).  The int8 quantize kernel
             is timed at its three entries (rows, the decode-step KV store,
             the prefill KV store), each held bit-exact to its plain
             version, with the kernel's own ``device_ms``, the wrapper's
             host µs a call and, for the stores, ``unfused_ms``: the ops
             the path ran before the store was fused.  The rows entry is
             also timed at the training path's gradient rows: qwen3-14b's
             embedding leaf, (759,680, 1,024) fp32, and short leaves of
             one row.
3. serve   — the main paths, each through ``ServeEngine`` in bf16 at full
             width and depth, random weights from a seeded generator:
             qwen3-14b (40 layers, 16 requests), falcon-mamba-7b (64
             layers, 12 requests), recurrentgemma-9b (38 layers = 12
             repetitions + 2 remainder layers, 12 requests, prompts past
             its 2048-token attention window), deepseek-moe-16b (28 MoE
             layers, 64 routed experts top-6 + 2 shared, every expert on
             every token as the reference's ``moe_dense``; 12 requests)
             and qwen2-vl-7b (28 layers, M-RoPE, text prompts; 12
             requests).  Kernel launch counters are zeroed just before
             each run and read just after; every kernel of the model's
             path must have launched, once per layer of its kind per
             prefill call, and the engine's books must balance.  Each
             model's B4 S2048 prefill call is profiled (deepseek's with
             its MoE FFNs' share of the device time), and qwen3-14b's and
             deepseek-moe-16b's batch-8 decode call.  qwen2-vl-7b then
             runs its vision path, which the engine cannot feed: one B2
             S1536 prefill with 1024 patch embeddings and 16 decode steps
             at ``pos + rope_offset``; flash must launch 28 times.
   whisper — whisper-base at full width and depth (6 encoder + 6 decoder
             layers) through ``prefill`` and ``decode_step``: B8, 1500
             audio frames, 64-token prompts, window 448, 64 decode steps;
             flash launches 12 times for the prefill (6 bidirectional,
             6 causal) and the cross caches hold all 1500 frames; the
             prefill's median and least seconds over 20 more calls.
4. fleet   — the fleet path: ``FleetEngine`` with 4 reconfigurable groups
             of capacity 8 serving full-width qwen3-14b (40 layers) with
             an int8 KV cache, sticky routing onto a hot shard, work
             stealing, KV-costed live migration priced on the int8 wire
             layout, and slack leases.  Every K/V vector written goes
             through the int8 quantize kernel's KV stores, K and V in one
             launch: 1 launch per layer per prefill and decode call.  At
             least one steal and one live migration must run, and the
             books must balance.
5. cluster — the cluster path, on the fleet phase's weights:
             ``ClusterEngine`` with 2 chips x 2 groups of capacity 8
             serving full-width qwen3-14b with an int8 KV cache, on the
             tiered mesh (``ClusterConfig``'s NoC, link and network
             prices): chip-first stealing, cross-chip steals in flight,
             live migration priced by tier on the int8 wire layout, region
             gathers, leases, ``obs="full"``.  The books must balance,
             decode logits be finite, flash launch 40 times per prefill
             call and the quantize kernel 40 times per prefill and decode
             call; the run's summary (its cluster and migration blocks
             included) and event stream must equal those of the vec
             engine's replay of the same configuration without a model;
             the stream, exported to ``build/`` as JSONL, must read back
             equal, and its Chrome trace hold one process per chip.
6. parity  — full width, bf16, reduced depth (qwen3-14b, falcon-mamba-7b,
             deepseek-moe-16b and qwen2-vl-7b with 128 vision patches at 2
             layers, recurrentgemma-9b at 5, qwen3-14b with the int8 KV
             cache; whisper-base at its full depth over 1500 frames):
             prefill and 8 decode-step logits with ``use_kernels=True``
             against ``use_kernels=False``, and every int8 KV store of the
             kernel path against the plain store on clones of the same
             caches, exactly.  deepseek's plain path takes the kernel
             path's expert choices (``PinnedRoutes``), and the rows whose
             own top-k differed are counted.  Then one
             full-width falcon-mamba SSM block and one recurrentgemma
             RG-LRU block in float32 at B1 S2048, ``use_kernel=True``
             against the chunked torch scan, on the output and the final
             state; and the peak memory one full-width SSM block adds at
             B4 S2048 through the fused scan, which must stay below one
             fp32 (4, 2048, 8192, 16) tensor.
7. train   — the training stack (``train.Trainer``: autograd through
             ``loss_fn`` with activation checkpointing, AdamW, the int8
             gradient compression, checkpoints), random bf16 weights from
             a seeded generator, ``SyntheticLM(seed=0)`` data.  qwen3-14b
             at full width and 8 of 40 layers, B4 S2048, 6 steps with
             gradient compression: loss and grad norm finite, the quantize
             kernel launched once per parameter leaf per step, and on one
             step's gradients ``compress_leaf`` with the kernel equal to
             its plain version exactly, every leaf; step seconds, tok/s,
             model TFLOP/s (active parameters, causal attention; with
             its reckoning) and its share of the
             card's peak, the compression's and AdamW's seconds by CUDA
             events, peak GB.  deepseek-moe-16b at full width and 4 of 28
             layers, B4 S2048, 4 steps with the AMOEBA controller fed each
             step's expert-load divergence.  whisper-base at full width and
             depth, 10 steps straight through and again with failures
             injected before steps 5 and 8, resuming from checkpoints
             under ``build/``: every step's loss equal to the
             uninterrupted run's exactly (under
             ``torch.use_deterministic_algorithms``), and the last
             checkpoint restoring key for key into a fresh state.  Before
             the qwen3-14b and deepseek-moe-16b runs, one step of the same
             configuration is counted on the ``meta`` device
             (``core.step_count``: nothing allocated); each run's first
             step is counted on the card by the same mode.  The FLOPs must
             be equal, and within 2 % of ``train_flops``' executed
             reckoning; the meta peak within 15 % of the run's
             ``torch.cuda.max_memory_allocated()``.
8. gpusim  — the paper's simulator (``core.gpusim``, host numpy, no
             device work): every scheme of ``SCHEMES`` over the 12
             workloads; the Fig 12 speedups over ``baseline`` (SM, MUM,
             the ``warp_regroup`` geomean, AMOEBA over DWS, the static
             choice for CP and 3MM) held to tests/test_gpusim.py's ranges.
9. dryrun  — ``launch.dryrun``'s mesh cells on ``fake`` process groups in
             a child process, started before the build (it needs only
             the host; no card is visible to it) and read here:
             qwen3-14b ``train_4k`` under the base, fused and scale_out
             plans (256 ranks), deepseek-moe-16b ``decode_32k`` (256),
             qwen3-14b ``prefill_32k`` on the 2x16x16 mesh (512),
             falcon-mamba-7b ``prefill_32k`` and recurrentgemma-9b
             ``train_4k`` (256 each, their mixers on 'model' shards).  Each
             cell's roofline terms; the three qwen3 train profiles go to
             ``AmoebaController.choose_plan``, which prints its plan.  Every
             cell but whisper's prints its per-device FLOPs beside the
             count before its entry point was tensor-parallel
             (``DRYRUN_BEFORE_TP``), which it must fall below.
10. dist   — the sharded paths (``repro_torch.parallel``): 4 ranks on the
             one card, started with ``torch.multiprocessing`` in the spawn
             mode, joined by gloo (NCCL refuses two ranks on one device;
             every collective crosses host memory), mesh (data 2, model 2).
             Each leg's unsharded path runs first in this process and is
             freed before the ranks start.  ``dist:moe``: deepseek-moe-16b
             at full width, 2 layers, B4 S512, ``loss_fn`` under
             ``production`` (``moe_sharded``: experts over 'model', FSDP
             over 'data', capacity factor 8) with the kernels, against
             ``moe_dense`` on one rank: the loss within the path-parity
             bound, no token dropped, the loads within 1e-3.
             ``dist:decode`` (mesh (2, 2)) and ``dist:decode_fused`` ((1,
             4)): the tensor-parallel serving path, qwen3-14b at full
             width, 4 layers, B8, 512-token prompts, weights laid out over
             'model' by their specs (each data rank a replica), a 2304-slot
             ring S-sharded over 'model' (1152 / 576 slots a rank), bf16
             and int8 caches, prefill and 8 decode steps fed the unsharded
             run's greedy tokens: every step's logits within the
             path-parity bound; the int8 store is the kernel on each shard
             (one launch a layer a call), flash runs on the rank's heads
             (20 / 4 and 10 / 2).  Then one prefill and decode step on the
             plain path is counted (``core.step_count``) on every rank:
             its matmul FLOPs a quarter of the unsharded whole batch's
             (counted on ``meta``) within 2 %, its collective bytes by
             kind; layer 0's weights and both tables as the path takes
             them at the spec's share (``d / n_model`` of each split
             leaf), the resident bytes at the spec share.  ``dist:train``
             (mesh (2, 2)) and ``dist:train_fused`` ((1, 4)): the
             tensor-parallel trainer, qwen3-14b at full width, 2 layers, B4
             S512, 2 steps with remat and int8 gradient compression on the
             global leaves' rows (weights and state by their specs, FSDP
             over 'data'), against ``Trainer()`` on one rank: losses within
             0.02, grad norms within 1 %; the first step counted on every
             rank: its matmul FLOPs a quarter of the unsharded whole
             batch's step (counted on ``meta``) within 2 %, its collective
             bytes by kind; layer 0's weights and both tables as the path
             takes them at the spec's share, the parameters' bytes at
             their specs' share.  ``dist:ssm`` (falcon-mamba-7b, 4 of 64
             layers), ``dist:rglru`` (recurrentgemma-9b, 3 of 38: rglru,
             rglru, attn) and ``dist:whisper`` (whisper-base, full depth,
             1500 frames) on mesh (2, 2), full width, B8, with the
             kernels: the tensor-parallel mixers and cross-attention,
             prefill and 8 decode steps fed the unsharded run's greedy
             tokens, every step's logits within the path-parity bound;
             ``selective_scan`` / ``rglru_scan`` launched once a recurrent
             layer a prefill on the rank's ``d_inner / 2`` / ``W / 2``
             channels; each rank's recurrent states (and whisper's cross
             caches, 750 of 1500 frames) the spec's shard; the counted
             matmul FLOPs of a prefill and a decode step a quarter of the
             unsharded whole batch's within 2 % (whisper: a quarter of all
             but the LM head, which 2 does not divide, and half of that);
             layer 0's weights at the spec's share.  ``dist:compress``: ``compressed_psum_mean``
             over 'data' on a (5120, 17408) fp32 leaf, within max|g| / 127
             x 1.5 of the true mean.  ``dist:restore``: the train leg's
             two layers (their stacked parameters) saved on the (2, 2)
             plan restore onto the fused (1, 4) and scale_out (4, 1)
             plans, every rank's every shard equal to the array written.
             Per leg: the largest difference
             and its limit, each rank's resident device bytes against its
             spec share, the wall seconds (gloo through host memory, no
             rate claimed) and the launches per kernel.
11. uneven — ``dist:uneven``: attention on 'model' shards where the
             model axis divides neither the heads nor the split KV heads.
             qwen2-vl-7b at full width (28 heads, 4 KV heads), 2 layers,
             on a (1, 8) mesh of 8 gloo ranks on cuda:0: 4 heads a rank,
             none on rank 7, half a KV head of ``wk`` / ``wv`` a rank.
             Prefill (B8, 512-token text prompts, a 520-slot ring) and 8
             decode steps fed the unsharded run's greedy tokens, every
             step's logits within the path-parity bound; one train step's
             loss within 0.02 and gradient norm within 1 % of the one-rank
             step's; each rank's counted FLOPs of a prefill and a decode
             step at its share (its heads' share of the prefill attention,
             1 / 8 of the rest but the second q projection, which it leaves
             out) within 2 %; flash launched once a layer for each run of
             the rank's heads that read one KV head (2 or 1), never on
             rank 7.  The kernel phase holds that grouped call, rank 1's
             heads 4-7 at B8 S512, to the plain version.
12. launch — the four serving launchers of ``repro_torch.launch``
             (``quickstart``, ``control_plane``, ``hetero_topology``,
             ``work_stealing``) from their ``main`` at their examples'
             small settings, on the card: each one's wall seconds and
             kernel launches (flash and rmsnorm by every one), every fleet
             draining its trace.

The line before the last is the card's name and power limit, the one
before that the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
# float32 math outside the tensor cores, NVIDIA H100 SXM data sheet
FP32_PEAK = 67e12
# the SFU's ex2 (one a fp32 exp): 16 a clock an SM for compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput), 132
# SMs at the H100 SXM's 1.98 GHz boost clock
SFU_RATE = 16 * 132 * 1.98e9
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
NORM_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# scans against their step-by-step plain versions, relative and absolute,
# as tests/test_kernels.py: the selective scans' h matches to rounding and
# y's sum over N runs in another order; the RG-LRU kernel's chunk carries
# reassociate the recurrence
SCAN_TOL = {"rglru_scan": 1e-5, "ssm_scan": 1e-4}
# one full-width recurrent block in float32, kernel vs the chunked torch
# scan, relative to each compared tensor's largest magnitude: the matmuls
# are the same on both sides, only the scans' orders of operations differ
BLOCK_TOL = 1e-4
# prefill/decode logits, kernels vs plain, bf16 at full width: the two
# paths round at different points (the flash kernel rounds its tile of P to
# bf16 and sums in another order than chunked attention; rmsnorm sums in
# another order).
# qwen3-14b's logits are O(1-4); a reduced-width CPU run of the same
# comparison gave max |diff| 1.6e-2, so 0.1 leaves room for 40x wider
# matmuls.  falcon-mamba-7b ties its unembedding to an N(0, 1) table, so
# its logits reach the hundreds, where one bf16 ulp is 0.5-1: there the
# bound is 3e-2 of the largest logit magnitude (tests/test_torch_recurrent's
# bf16 bound), and 0.1 where that is smaller.  The final hidden states
# (RMS 1 after the final norm) are held to the same rule.
PARITY_TOL = 0.1
PARITY_REL = 3e-2
# the int8 quantizer and its KV stores have no library yardstick
QUANT_LIBRARY = ("none: no single PyTorch call computes the scales and the "
                 "codes")
# the serve phases' control plane (dynamic warp_regroup)
AMOEBA = dict(split_threshold=0.3, fuse_threshold=0.05, min_phase_steps=2)


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 15, flush=None) -> float:
    """Median of ``reps`` CUDA-event timings; L2 flushed before each."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, key: str, n: int = 10) -> float:
    """The kernel's own device time a call (torch.profiler, kernels whose
    name holds ``key``), over ``n`` calls enqueued back to back: the CUDA
    events of ``time_ms`` around one call also hold whatever part of the
    wrapper's host time the card waits out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a session now and then records no device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in kern if key in e.key)
        if us > 0:
            return us / 1e3 / n
        log("device_ms: no kernel named", key, "among",
            [(e.key[:50], e.count) for e in kern])
    return "not measured"


def host_us(fn, n: int = 200) -> float:
    """The host's time a call in µs: ``n`` calls enqueued back to back,
    the clock read before the card is waited for."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return us


def bound(flops: float, nbytes: float, peak: float, hw, exps: float = 0):
    """(bound_ms, bound_by): the larger of operations/peak (``exps`` fp32
    exponentials at the SFU's rate, if that is longer) and bytes/rate."""
    t_ops = max(flops / peak, exps / SFU_RATE)
    t_bytes = nbytes / hw.hbm_bandwidth
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

KERNEL_NAMES = ("flash_fwd_wgmma", "flash_fwd_kernel", "rmsnorm_kernel",
                "selective_scan_kernel", "ssm_scan_kernel",
                "rglru_scan_lookback", "quantize_int8")


def _demangle(cufilt, names):
    """Readable kernel names, through the toolkit's ``cu++filt``, without
    namespaces' noise, casts or the parameter list:
    ``rmsnorm_kernel<__nv_bfloat16, float, 128, 5>``."""
    import re
    out = subprocess.run([str(cufilt)], input="\n".join(names),
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.splitlines()

    def short(d):
        d = re.sub(r"\((?:unsigned )?int\)|<unnamed>::|"
                   r"\(anonymous namespace\)::", "", d.strip())
        if d.endswith(")"):                   # cut the parameter list
            depth = 0
            for i in range(len(d) - 1, -1, -1):
                depth += {")": 1, "(": -1}.get(d[i], 0)
                if depth == 0:
                    d = d[:i]
                    break
        return d.removeprefix("void ")
    return {m: short(d) for m, d in zip(names, out)}


def build_report(_build, name):
    """One source's build: its nvcc wall time, each kernel's registers,
    spills and shared memory from ``-Xptxas -v``, and its tensor-core and
    TMA instructions counted in the SASS (``cuobjdump -sass``).  The bf16
    flash kernel must hold HGMMA instructions: it runs on the tensor
    cores."""
    import re
    text = _build.build_log(name)
    secs = re.search(r"build_seconds ([0-9.]+)", text)
    kernels, cur = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            cur = re.search(r"function '([^']+)", ln).group(1)
            kernels[cur] = [None, 0, 0]          # registers, smem, spills
        elif cur and re.search(r"Used \d+ registers", ln):
            regs = re.search(r"Used (\d+) registers", ln)
            smem = re.search(r"(\d+) bytes smem", ln)
            kernels[cur][:2] = [int(regs.group(1)),
                                int(smem.group(1)) if smem else 0]
        elif cur and "spill stores" in ln:
            kernels[cur][2] = int(re.search(r"(\d+) bytes spill stores",
                                            ln).group(1))
    nvcc = Path(_build._nvcc())
    sass = subprocess.run([str(nvcc.with_name("cuobjdump")), "-sass",
                           str(_build.lib_path(name))], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    ops = {op: len(re.findall(rf"\b{op}\b", sass))
           for op in ("HGMMA", "HMMA", "UTMALDG", "FFMA")}
    if name == "flash_attention":
        assert ops["HGMMA"] > 0 and ops["UTMALDG"] > 0, ops
    label = _demangle(nvcc.with_name("cu++filt"), list(kernels))
    return dict(build_s=float(secs.group(1)) if secs else None,
                kernels=len(kernels), sass=ops,
                regs_smem_spills={label[k]: v for k, v in kernels.items()})


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_case(B, H, KV, S, hd, dtype, causal, window, hw, flush):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, S, hd, device="cuda", dtype=dt, generator=g)
    k = torch.randn(B, KV, S, hd, device="cuda", dtype=dt, generator=g)
    v = torch.randn(B, KV, S, hd, device="cuda", dtype=dt, generator=g)
    got = FA.flash_attention_hm_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = FA.flash_attention_hm_plain(q, k, v, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    tol = FLASH_TOL[dtype]
    rel = float(((got.float() - want.float()).abs()
                 / (tol + tol * want.float().abs())).max())
    assert math.isfinite(err) and rel <= 1.0, \
        f"flash kernel disagrees: max_abs_err {err} (tol {tol})"

    qpos = torch.arange(S, device="cuda")[:, None]
    kpos = torch.arange(S, device="cuda")[None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device="cuda")
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    pairs = int(mask.sum())           # (q, k) pairs this run's masks keep
    ms = time_ms(lambda: FA.flash_attention_hm_cuda(
        q, k, v, causal=causal, window=window), flush=flush)
    plain_ms = time_ms(lambda: FA.flash_attention_hm_plain(
        q, k, v, causal=causal, window=window), flush=flush)
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True)
    library_ms = time_ms(lib, flush=flush)
    esz = q.element_size()
    nbytes = esz * (2 * q.numel() + k.numel() + v.numel())
    flops = 4.0 * B * H * hd * pairs
    peak = hw.peak_flops if dtype == "bfloat16" else FP32_PEAK
    bound_ms, bound_by = bound(flops, nbytes, peak, hw)
    rec = dict(shape=f"B{B} H{H} KV{KV} S{S} hd{hd} {dtype} causal={causal} "
               f"window={window}", max_abs_err=err, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, tflops=flops / ms / 1e9,
               bound_share=bound_ms / ms, library_tflops=flops / library_ms / 1e9)
    log("flash_attention", json.dumps(rec))
    return rec


def flash_grouped_case(hw, flush):
    """The kernel on a tensor-parallel rank's chunk of heads that read KV
    heads in unequal groups: ``dist:uneven``'s shape, qwen2-vl-7b's 28
    heads and 4 KV heads on 8 model ranks, rank 1's heads 4-7 reading KV
    heads 0, 0, 0, 1 (B8 S512 hd128, causal).  ``grouped_attention``
    launches once per run of heads that read one KV head, K / V never
    expanded; held to the plain version on the expanded heads."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models.attention import grouped_attention, head_runs
    B, S, hd, first, G = UNEVEN[1], UNEVEN[2], 128, 4, 7
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(B, S, 4, hd, device="cuda", dtype=torch.bfloat16,
                    generator=g)
    k = torch.randn(B, S, 2, hd, device="cuda", dtype=torch.bfloat16,
                    generator=g)
    v = torch.randn_like(k)
    reads = [(first + i) // G - first // G for i in range(4)]
    assert len(head_runs(first, 4, G)) == 2

    def run():
        return grouped_attention(ops.flash_attention, q, k, v, first, G,
                                 causal=True, window=None)

    ops.reset_launches()
    got = run()
    torch.cuda.synchronize()
    launches = ops.launches["flash_attention"]
    assert launches == 2, launches
    hm = lambda t: t.transpose(1, 2).contiguous()  # noqa: E731
    plain = lambda: FA.flash_attention_hm_plain(  # noqa: E731
        hm(q), hm(k[:, :, reads]), hm(v[:, :, reads]), causal=True,
        window=None)
    want = plain().transpose(1, 2)
    err = float((got.float() - want.float()).abs().max())
    tol = FLASH_TOL["bfloat16"]
    rel = float(((got.float() - want.float()).abs()
                 / (tol + tol * want.float().abs())).max())
    assert math.isfinite(err) and rel <= 1.0, \
        f"grouped flash disagrees: max_abs_err {err} (tol {tol})"
    pairs = S * (S + 1) // 2
    flops = 4.0 * B * 4 * hd * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound_ms, bound_by = bound(flops, nbytes, hw.peak_flops, hw)
    ms = time_ms(run, flush=flush)
    rec = dict(shape=f"B{B} S{S} heads 4-7 of 28 reading KV heads {reads} "
               f"hd{hd} bfloat16 causal", launches=launches,
               max_abs_err=err, tol=tol, ms=ms,
               plain_ms=time_ms(plain, flush=flush), bound_ms=bound_ms,
               bound_by=bound_by, bound_share=bound_ms / ms)
    log("flash_attention:grouped", json.dumps(rec))
    return rec


def norm_case(T_, D, dtype, hw, flush):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as RN
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dt = getattr(torch, dtype)
    x = torch.randn(T_, D, device="cuda", dtype=dt, generator=g)
    sc = (1.0 + 0.1 * torch.randn(D, device="cuda", generator=g)).to(dt)
    got = RN.rmsnorm_cuda(x, sc, 1e-6)
    torch.cuda.synchronize()
    want = RN.rmsnorm_plain(x, sc, 1e-6)
    err = float((got.float() - want.float()).abs().max())
    tol = NORM_TOL[dtype]
    rel = float(((got.float() - want.float()).abs()
                 / (tol + tol * want.float().abs())).max())
    assert math.isfinite(err) and rel <= 1.0, \
        f"rmsnorm kernel disagrees: max_abs_err {err} (tol {tol})"
    ms = time_ms(lambda: RN.rmsnorm_cuda(x, sc, 1e-6), flush=flush)
    plain_ms = time_ms(lambda: RN.rmsnorm_plain(x, sc, 1e-6), flush=flush)
    library_ms = time_ms(lambda: F.rms_norm(x, (D,), weight=sc, eps=1e-6),
                         flush=flush)
    esz = x.element_size()
    nbytes = esz * (2 * x.numel() + sc.numel())
    flops = 4.0 * x.numel()           # square, sum, scale, weight (fp32)
    bound_ms, bound_by = bound(flops, nbytes, FP32_PEAK, hw)
    rec = dict(shape=f"T{T_} D{D} {dtype}", max_abs_err=err, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, gbps=nbytes / ms / 1e6,
               bound_share=bound_ms / ms)
    log("rmsnorm", json.dumps(rec))
    return rec


def _scan_check(name, got, want):
    tol = SCAN_TOL[name]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float(((g - w).abs() / (tol + tol * w.abs())).max())
              for g, w in zip(got, want))
    assert math.isfinite(err) and rel <= 1.0, \
        f"{name} kernel disagrees: max_abs_err {err} (tol {tol})"
    return err, tol


def rglru_case(B, S, W, hw, flush):
    """RG-LRU scan: no single PyTorch call computes a linear recurrence,
    so there is no library time.  The timed call includes the wrapper's
    zeroed flags (one small memset)."""
    import torch
    from repro_torch.kernels import linear_scan as LS
    g = torch.Generator(device="cuda").manual_seed(SEED)
    a = 0.4 + 0.599 * torch.rand(B, S, W, device="cuda", generator=g)
    b = torch.randn(B, S, W, device="cuda", generator=g)
    got = LS.rglru_scan_cuda(a, b)
    torch.cuda.synchronize()
    err, tol = _scan_check("rglru_scan", [got], [LS.rglru_scan_plain(a, b)])
    ms = time_ms(lambda: LS.rglru_scan_cuda(a, b), flush=flush)
    dev_ms = device_ms(lambda: LS.rglru_scan_cuda(a, b), "rglru_scan")
    plain_ms = time_ms(lambda: LS.rglru_scan_plain(a, b), flush=flush)
    nbytes = 4 * 3 * a.numel()            # read a, b; write h
    flops = 2.0 * a.numel()               # one multiply, one add
    bound_ms, bound_by = bound(flops, nbytes, FP32_PEAK, hw)
    rec = dict(shape=f"B{B} S{S} W{W} float32", max_abs_err=err, tol=tol,
               ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by, gbps=nbytes / ms / 1e6)
    log("rglru_scan", json.dumps(rec))
    return rec


def ssm_case(B, S, D, N, hw, flush):
    """Selective scan with its C-contraction, on the model layout."""
    import torch
    from repro_torch.kernels import linear_scan as LS
    g = torch.Generator(device="cuda").manual_seed(SEED)
    a = 0.4 + 0.599 * torch.rand(B, S, D, N, device="cuda", generator=g)
    b = 0.1 * torch.randn(B, S, D, N, device="cuda", generator=g)
    c = torch.randn(B, S, N, device="cuda", generator=g)
    got = LS.ssm_scan_cuda(a, b, c)
    torch.cuda.synchronize()
    err, tol = _scan_check("ssm_scan", got, LS.ssm_scan_plain(a, b, c))
    ms = time_ms(lambda: LS.ssm_scan_cuda(a, b, c), flush=flush)
    plain_ms = time_ms(lambda: LS.ssm_scan_plain(a, b, c), flush=flush)
    # read a, b, c; write y and h_last
    nbytes = 4 * (2 * a.numel() + c.numel() + B * S * D + B * D * N)
    flops = 4.0 * a.numel()               # recurrence + contraction
    bound_ms, bound_by = bound(flops, nbytes, FP32_PEAK, hw)
    rec = dict(shape=f"B{B} S{S} D{D} N{N} float32", max_abs_err=err,
               tol=tol, ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by,
               gbps=nbytes / ms / 1e6)
    log("ssm_scan", json.dumps(rec))
    del a, b, c, got
    return rec


def selective_case(B, S, D, N, dtype, hw, flush):
    """The fused selective scan (discretization inside the kernel) against
    its plain version, and ``unfused_ms``: the same function as the path
    ran it before, the torch discretization into fp32 (B, S, D, N) a and b
    followed by the (a, b, c) kernel.  No PyTorch call computes it."""
    import torch
    from repro_torch.kernels import linear_scan as LS
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dt_ = getattr(torch, dtype)
    dt = (1e-3 + 0.199 * torch.rand(B, S, D, device="cuda", generator=g)
          ).to(dt_)                       # softplus's range on the path
    x = torch.randn(B, S, D, device="cuda", generator=g).to(dt_)
    A = -torch.exp(torch.log(torch.arange(1, N + 1, device="cuda",
                                          dtype=torch.float32))
                   + 0.1 * torch.randn(D, N, device="cuda", generator=g))
    Bm = torch.randn(B, S, N, device="cuda", generator=g).to(dt_)
    Cm = torch.randn(B, S, N, device="cuda", generator=g).to(dt_)
    got = LS.selective_scan_cuda(dt, x, A, Bm, Cm)
    torch.cuda.synchronize()
    want = LS.selective_scan_plain(dt, x, A, Bm, Cm)
    err, tol = _scan_check("ssm_scan", got, want)
    h_exact = bool(torch.equal(got[1], want[1]))
    del got, want
    ms = time_ms(lambda: LS.selective_scan_cuda(dt, x, A, Bm, Cm),
                 flush=flush)
    dev_ms = device_ms(lambda: LS.selective_scan_cuda(dt, x, A, Bm, Cm),
                       "selective_scan")
    big = B * S * D * N > 2**28
    plain_ms = time_ms(lambda: LS.selective_scan_plain(dt, x, A, Bm, Cm),
                       reps=5 if big else 15, flush=flush)

    def unfused():
        dtf = dt.float()
        a = (dtf[..., None] * A).exp_()
        bx = (dtf * x.float())[..., None] * Bm.float()[:, :, None, :]
        return LS.ssm_scan_cuda(a, bx, Cm.float())
    unfused_ms = time_ms(unfused, reps=5 if big else 15, flush=flush)
    esz = dt.element_size()
    # read dt, x, B, C and A; write y and h_last
    nbytes = (esz * (2 * dt.numel() + 2 * Bm.numel()) + 4 * A.numel()
              + 4 * (B * S * D + B * D * N))
    elems = B * S * D * N
    # dt*A, dx*B, a*h, +b, h*c, +y per element; dt*x per channel
    flops = 6.0 * elems + B * S * D
    bound_ms, bound_by = bound(flops, nbytes, FP32_PEAK, hw, exps=elems)
    rec = dict(shape=f"B{B} S{S} D{D} N{N} {dtype}", max_abs_err=err,
               tol=tol, h_bit_exact=h_exact, ms=ms, device_ms=dev_ms,
               plain_ms=plain_ms,
               unfused_ms=unfused_ms, library_ms=None,
               library="none: no PyTorch call computes a linear recurrence",
               bound_ms=bound_ms, bound_by=bound_by,
               bound_parts_ms=dict(bytes=nbytes / hw.hbm_bandwidth * 1e3,
                                   fp32=flops / FP32_PEAK * 1e3,
                                   sfu_exp=elems / SFU_RATE * 1e3),
               bound_share=bound_ms / ms, gbps=nbytes / ms / 1e6)
    log("selective_scan", json.dumps(rec))
    del dt, x, A, Bm, Cm
    torch.cuda.empty_cache()
    return rec


def quant_case(T_, D, dtype, floor, hw, flush):
    """Row-wise int8 quantizer.  The kernel does the plain version's IEEE
    operations, so codes and scales must be equal exactly.  No single
    PyTorch call computes this function (``torch.quantize_per_channel``
    needs its scales given), so there is no library time."""
    import torch
    from repro_torch.kernels import quantize as QZ
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = 3.0 * torch.randn(T_, D, device="cuda", generator=g)
    x[1] = 0.0                            # the floor alone sets the scale
    x[2] *= 1e-9 / x[2].abs().max()       # amax between 1e-12 and 1e-8
    x = x.to(getattr(torch, dtype))
    q, s = QZ.quantize_int8_cuda(x, floor)
    torch.cuda.synchronize()
    wq, ws = QZ.quantize_int8_plain(x, floor)
    dq = (q.int() - wq.int()).abs()
    code_diff, n_diff = int(dq.max()), int((dq != 0).sum())
    scale_err = float((s - ws).abs().max())
    assert code_diff == 0 and torch.equal(s, ws), \
        f"quantize_int8 kernel disagrees: {n_diff} codes differ (max " \
        f"{code_diff}), scales by {scale_err}"
    kernel = lambda: QZ.quantize_int8_cuda(x, floor)  # noqa: E731
    ms = time_ms(kernel, flush=flush)
    plain_ms = time_ms(lambda: QZ.quantize_int8_plain(x, floor), flush=flush)
    nbytes = x.numel() * x.element_size() + q.numel() + 4 * s.numel()
    flops = 4.0 * x.numel()           # |x|, max, divide, round (fp32)
    bound_ms, bound_by = bound(flops, nbytes, FP32_PEAK, hw)
    rec = dict(shape=f"T{T_} D{D} {dtype} floor {floor:g}",
               max_abs_err=max(float(code_diff), scale_err),
               max_code_diff=code_diff, codes_differing=n_diff,
               max_scale_diff=scale_err, tol=0.0, ms=ms,
               device_ms=device_ms(kernel, "quantize_int8"),
               host_us=host_us(kernel), plain_ms=plain_ms,
               library_ms=None, library=QUANT_LIBRARY, bound_ms=bound_ms,
               bound_by=bound_by, gbps=nbytes / ms / 1e6,
               bound_share=bound_ms / ms)
    log("quantize_int8", json.dumps(rec))
    return rec



def _equal_all(got, want, what):
    """Each tensor of ``got`` equal to ``want``'s in dtype, shape and bits."""
    import torch
    diff = {i: (g.dtype, tuple(g.shape), w.dtype, tuple(w.shape))
            if (g.dtype, g.shape) != (w.dtype, w.shape)
            else int((g != w).sum())
            for i, (g, w) in enumerate(zip(got, want))
            if (g.dtype, g.shape) != (w.dtype, w.shape)
            or not torch.equal(g, w)}
    assert not diff, f"{what} differs from its plain version: {diff}"


def store_decode_case(B, KV, hd, W, dtype, hw, flush, offset=0, s_loc=None):
    """One decode step's int8 KV store (K and V in one launch, the slot
    from pos on the device) against its plain version on clones of the
    same caches, exactly: written slots and the sentinels of every other.
    ``unfused_ms`` times the ops the path ran before the store was fused:
    the slot arithmetic (7 launches), two quantize launches and four
    ``write_slot_`` (3 launches each), 21 launches."""
    import torch
    from repro_torch.kernels import quantize as QZ
    s_loc = W if s_loc is None else s_loc
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dt = getattr(torch, dtype)
    nk, nv = (3.0 * torch.randn(B, KV, hd, device="cuda", generator=g)
              ).to(dt), (3.0 * torch.randn(B, KV, hd, device="cuda",
                                           generator=g)).to(dt)
    caches = [torch.randint(-127, 128, (B, s_loc, KV, hd), device="cuda",
                            generator=g, dtype=torch.int8) for _ in "kv"]
    caches += [5 + torch.rand(B, s_loc, KV, 1, device="cuda", generator=g)
               for _ in "kv"]
    pos = torch.randint(0, 3 * W, (B,), device="cuda", generator=g)
    want = [c.clone() for c in caches]
    QZ.quantize_kv_store_cuda_(nk, nv, *caches, pos, W, offset, 1e-8)
    torch.cuda.synchronize()
    QZ.quantize_kv_store_plain_(nk, nv, *want, pos, W, offset, 1e-8)
    _equal_all(caches, want, "decode KV store")
    rec = dict(shape=f"B{B} KV{KV} hd{hd} {dtype} W{W} offset {offset} "
               f"s_loc {s_loc}", max_abs_err=0.0, tol=0.0)
    if offset or s_loc != W:               # an exactness check only
        log("quantize_kv_store", json.dumps(rec))
        return rec

    def kernel():
        QZ.quantize_kv_store_cuda_(nk, nv, *caches, pos, W, offset, 1e-8)

    def unfused():
        slot = torch.remainder(pos, W) - offset
        in_range = (slot >= 0) & (slot < s_loc)
        clamped = torch.clamp(slot, 0, s_loc - 1)
        bidx = torch.arange(B, device="cuda")
        for new, c, s in ((nk, caches[0], caches[2]),
                          (nv, caches[1], caches[3])):
            q, sc = QZ.quantize_int8_cuda(new.reshape(-1, hd), 1e-8)
            QZ.write_slot_(c, q.reshape(new.shape), bidx, clamped, in_range)
            QZ.write_slot_(s, sc.reshape(new.shape[:-1] + (1,)), bidx,
                           clamped, in_range)
    unfused()
    torch.cuda.synchronize()
    _equal_all(caches, want, "the unfused decode KV write")
    nbytes = (2 * nk.numel() * nk.element_size() + pos.numel() * 8
              + 2 * nk.numel() + 2 * 4 * B * KV)
    bound_ms, bound_by = bound(4.0 * 2 * nk.numel(), nbytes, FP32_PEAK, hw)
    rec.update(ms=time_ms(kernel, flush=flush),
               device_ms=device_ms(kernel, "quantize_int8"),
               host_us=host_us(kernel),
               plain_ms=time_ms(lambda: QZ.quantize_kv_store_plain_(
                   nk, nv, *caches, pos, W, offset, 1e-8), flush=flush),
               unfused_ms=time_ms(unfused, flush=flush),
               unfused_host_us=host_us(unfused), unfused_launches=21,
               library_ms=None, library=QUANT_LIBRARY, bound_ms=bound_ms,
               bound_by=bound_by)
    log("quantize_kv_store", json.dumps(rec))
    return rec


def store_prefill_case(B, S, KV, hd, W, dtype, hw, flush):
    """Prefill's int8 KV store (the ring layout and the quantizer in one
    launch) against its plain version, exactly; ``unfused_ms`` times the
    path before the fusion: the reference's slice/roll or zero pad, then
    one quantize launch each for K and V."""
    import torch
    from repro_torch.kernels import quantize as QZ
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dt = getattr(torch, dtype)
    k, v = ((3.0 * torch.randn(B, S, KV, hd, device="cuda", generator=g)
             ).to(dt) for _ in "kv")
    got = QZ.quantize_kv_prefill_cuda(k, v, W, 1e-8)
    torch.cuda.synchronize()
    _equal_all(got, QZ.quantize_kv_prefill_plain(k, v, W, 1e-8),
               "prefill KV store")
    kernel = lambda: QZ.quantize_kv_prefill_cuda(k, v, W, 1e-8)  # noqa: E731

    def unfused():
        return [QZ.quantize_int8_cuda(QZ.ring_layout(x, W).reshape(-1, hd),
                                      1e-8) for x in (k, v)]
    # the kernel reads only the last min(S, W) positions of K and V and
    # writes whole rings (the pad as code 0 and the floor's scale)
    read = 2 * B * min(S, W) * KV * hd
    nbytes = read * k.element_size() + 2 * B * W * KV * (hd + 4)
    bound_ms, bound_by = bound(4.0 * read, nbytes, FP32_PEAK, hw)
    ms = time_ms(kernel, flush=flush)
    rec = dict(shape=f"B{B} S{S} KV{KV} hd{hd} {dtype} W{W}", max_abs_err=0.0,
               tol=0.0, ms=ms, device_ms=device_ms(kernel, "quantize_int8"),
               host_us=host_us(kernel, n=50),
               plain_ms=time_ms(lambda: QZ.quantize_kv_prefill_plain(
                   k, v, W, 1e-8), flush=flush),
               unfused_ms=time_ms(unfused, flush=flush), library_ms=None,
               library=QUANT_LIBRARY, bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / ms, gbps=nbytes / ms / 1e6)
    log("quantize_kv_prefill", json.dumps(rec))
    return rec


def kernel_phase(hw):
    """The record of each kernel at its main path's headline shape."""
    import torch
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flash = {}
    for S in (512, 2048):
        for dtype in ("bfloat16", "float32"):
            flash[(S, dtype)] = flash_case(1, 40, 8, S, 128, dtype, True,
                                           None, hw, flush)
    # the qwen3-14b prefill call's own shape (B4 S2048)
    flash_case(4, 40, 8, 2048, 128, "bfloat16", True, None, hw, flush)
    flash_case(1, 40, 8, 2048, 128, "bfloat16", True, 512, hw, flush)
    flash_case(1, 40, 8, 333, 128, "bfloat16", True, None, hw, flush)
    flash_case(2, 4, 2, 512, 32, "bfloat16", True, None, hw, flush)
    flash_case(2, 4, 2, 333, 32, "float32", False, 48, hw, flush)
    # recurrentgemma-9b's attention: MQA, hd 256, past its 2048 window
    flash_case(1, 16, 1, 3072, 256, "bfloat16", True, 2048, hw, flush)
    flash_case(2, 4, 1, 333, 256, "float32", True, 48, hw, flush)
    norm = norm_case(4096, 5120, "bfloat16", hw, flush)
    norm_case(4096 * 40, 128, "bfloat16", hw, flush)
    # the recurrent models' block norms, D 4096: falcon-mamba-7b's B4 S2048
    # and recurrentgemma-9b's B2 S3072 prefill rows
    norm_case(4 * 2048, 4096, "bfloat16", hw, flush)
    norm_case(2 * 3072, 4096, "bfloat16", hw, flush)
    norm_case(37, 256, "float32", hw, flush)
    # falcon-mamba: the fused scan at one row and at the prefill call's own
    # shape (B4 S2048), ragged f32 cases; then the (a, b, c) entry
    sel = selective_case(1, 2048, 8192, 16, "bfloat16", hw, flush)
    selective_case(4, 2048, 8192, 16, "bfloat16", hw, flush)
    selective_case(2, 333, 4100, 16, "float32", hw, flush)
    selective_case(1, 77, 96, 8, "float32", hw, flush)
    ssm = ssm_case(1, 2048, 8192, 16, hw, flush)    # falcon-mamba, one row
    ssm_case(2, 333, 4100, 16, hw, flush)
    ssm_case(1, 77, 96, 8, hw, flush)
    # recurrentgemma: one row, the B2 S3072 prefill call, the kernel's
    # 64-step chunk boundaries, ragged W
    rglru = rglru_case(1, 2048, 4096, hw, flush)
    rglru_case(2, 3072, 4096, hw, flush)
    for S in (63, 64, 65):
        rglru_case(2, S, 4100, hw, flush)
    rglru_case(2, 333, 4100, hw, flush)
    # the int8 quantizer's rows entry at qwen3-14b's KV rows: prefill's K
    # or V at B4, window 2304, 8 kv heads (floor 1e-8), and one decode
    # step's at B8; then the TPU kernel's own sweep at its 1e-12 floor
    quant = quant_case(4 * 2304 * 8, 128, "bfloat16", 1e-8, hw, flush)
    quant_case(8 * 8, 128, "bfloat16", 1e-8, hw, flush)
    quant_case(128, 1024, "float32", 1e-12, hw, flush)
    quant_case(33, 257, "float32", 1e-12, hw, flush)
    # the training path's gradient rows: qwen3-14b's embedding leaf as
    # compress_leaf hands it over, 151,936 x 5,120 fp32 values in rows of
    # 1,024, floor 1e-12; then short leaves (one row of the leaf's size)
    grad_rows = quant_case(151936 * 5120 // 1024, 1024, "float32", 1e-12, hw,
                           flush)
    for D in (1, 7, 128, 1000, 1023):
        quant_case(3, D, "float32", 1e-12, hw, flush)
    # the KV stores the int8 path runs: a batch-8 decode step into a 2304
    # ring, a window of the ring that leaves rows out of range (checked
    # only), the B4 S2048 prefill into a 2304 ring, and a prompt past the
    # ring (slice and roll)
    store = store_decode_case(8, 8, 128, 2304, "bfloat16", hw, flush)
    store_decode_case(8, 8, 128, 2304, "bfloat16", hw, flush, offset=1152,
                      s_loc=576)
    prefill = store_prefill_case(4, 2048, 8, 128, 2304, "bfloat16", hw,
                                 flush)
    store_prefill_case(2, 2500, 8, 128, 2304, "bfloat16", hw, flush)
    # the cluster path's own shapes: prefill calls of 8- and 16-token
    # prompts (at most a group's 8 rows), the norms of their rows, and the
    # int8 stores into its 256-slot rings
    flash_case(8, 40, 8, 16, 128, "bfloat16", True, None, hw, flush)
    flash_case(3, 40, 8, 8, 128, "bfloat16", True, None, hw, flush)
    norm_case(8 * 16, 5120, "bfloat16", hw, flush)
    norm_case(8 * 16 * 40, 128, "bfloat16", hw, flush)
    store_decode_case(8, 8, 128, CLUSTER_WINDOW, "bfloat16", hw, flush)
    store_prefill_case(8, 16, 8, 128, CLUSTER_WINDOW, "bfloat16", hw, flush)
    # the other families' shapes: whisper-base's bidirectional encoder over
    # 1500 frames (30 s of audio; not a multiple of the kernel's tiles) and
    # its 448-token decoder context at hd 64, qwen2-vl-7b's GQA groups of 7
    # and deepseek-moe-16b's MHA at hd 128; their block norms at D 512,
    # 3584 and 2048
    flash_case(8, 8, 8, 1500, 64, "bfloat16", False, None, hw, flush)
    flash_case(8, 8, 8, 448, 64, "bfloat16", True, None, hw, flush)
    flash_case(1, 28, 4, 2048, 128, "bfloat16", True, None, hw, flush)
    flash_case(1, 16, 16, 2048, 128, "bfloat16", True, None, hw, flush)
    grouped = flash_grouped_case(hw, flush)
    norm_case(8 * 1500, 512, "bfloat16", hw, flush)
    norm_case(4 * 2048, 3584, "bfloat16", hw, flush)
    norm_case(4 * 2048, 2048, "bfloat16", hw, flush)
    del flush
    torch.cuda.empty_cache()
    return {"flash_attention": dict(flash[(2048, "bfloat16")],
                                    grouped_entry=grouped),
            "rmsnorm": norm,
            "ssm_scan": dict(sel, abc_entry=dict(
                ssm, source="src/repro_torch/kernels/csrc/linear_scan.cu")),
            "rglru_scan": rglru,
            # the decode store makes most of the path's launches; the rows
            # entry (the TPU kernel's interface) is off the path
            "quantize_int8": dict(store, rows_entry=quant,
                                  prefill_store=prefill,
                                  grad_rows_entry=grad_rows)}


# ---------------------------------------------------------------------------
# Phase 3: the main path — ServeEngine on full-width qwen3-14b
# ---------------------------------------------------------------------------

def check_books(requests, stats):
    """tests/test_serve_fleet.py::_check_books, on the port's engine."""
    assert stats.completed == len(requests), (stats.completed, len(requests))
    assert all(r.done for r in requests)
    assert stats.useful_tokens == sum(len(r.generated) for r in requests)
    assert all(len(r.generated) == r.max_new_tokens for r in requests)
    assert stats.prefill_tokens == sum(len(r.prompt) for r in requests)
    for r in requests:
        assert r.finish is not None and r.finish >= r.arrival


# (arch, requests, prompt lengths, engine window): the main paths.  Each
# model runs at full width and depth; max_new_tokens come from {8, 16, 64}
SERVES = [("qwen3-14b", 16, (512, 1024, 2048), 2304),
          ("falcon-mamba-7b", 12, (512, 1024, 2048), 2304),
          ("recurrentgemma-9b", 12, (512, 1024, 3072), 3200),
          ("deepseek-moe-16b", 12, (512, 1024, 2048), 2304),
          ("qwen2-vl-7b", 12, (512, 1024, 2048), 2304)]
# the kernel each block kind's prefill launches once per layer
KIND_KERNEL = {"attn": "flash_attention", "ssm": "ssm_scan",
               "rglru": "rglru_scan"}


def timed(fn, spans):
    """``fn`` with CUDA events recorded around each call, appended to
    ``spans`` as (start, end), with no added synchronization."""
    import torch

    def run(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn(*a, **kw)
        e.record()
        spans.append((s, e))
        return out
    return run


class PathSpans:
    """CUDA events around groups' own prefill waves and decode closures
    (the ``decode_fn`` hook), recorded on the stream with no added
    synchronization; the count of prefill calls (one per prompt length
    in a wave); non-finite decode logits raise a device flag."""

    def __init__(self, cfg):
        import torch
        self.cfg = cfg
        self.spans = {"prefill": [], "decode": []}
        self.prefill_calls = 0
        self.nonfinite = torch.zeros((), dtype=torch.bool, device="cuda")

    def hook(self, grp):
        import torch
        wave = timed(grp._prefill_wave, self.spans["prefill"])
        decode = timed(grp._decode, self.spans["decode"])
        vocab = self.cfg.vocab_size

        def prefill_wave(*a, **kw):
            g = wave(*a, **kw)
            if g is not None:                      # one prefill per length
                self.prefill_calls += len({len(r.prompt) for r in g.requests})
            return g

        def decode_fn(p, s, t):
            logits, st = decode(p, s, t)
            assert logits.shape == (t.shape[0], vocab), logits.shape
            self.nonfinite.logical_or_(~torch.isfinite(logits).all())
            return logits, st

        grp._prefill_wave, grp._decode = prefill_wave, decode_fn

    def seconds(self):
        return {k: sum(s.elapsed_time(e) for s, e in v) / 1e3
                for k, v in self.spans.items()}


def serve_phase(arch, n_requests, prompts, window, smi):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import AmoebaConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(arch)                         # full width, bf16
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                          "cuda")
    torch.cuda.synchronize()
    log(f"serve: {arch} {cfg.num_layers} layers d_model {cfg.d_model} "
        f"params {T.count_params(params) / 1e9:.3f} B bf16, init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card")

    rng = np.random.default_rng(SEED)
    reqs = [Request(i, list(map(int, rng.integers(
        0, cfg.vocab_size, int(rng.choice(prompts))))),
        int(rng.choice([8, 16, 64]))) for i in range(n_requests)]

    eng = ServeEngine(cfg, params, rt=T.Runtime(use_kernels=True),
                      amoeba=AmoebaConfig(**AMOEBA), capacity=8,
                      window=window)
    paths = PathSpans(cfg)
    paths.hook(eng.group)
    torch.cuda.reset_peak_memory_stats()
    eng.submit(reqs)
    ops.reset_launches()                           # zero just before the run
    t = time.perf_counter()
    st = eng.run(dynamic=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(ops.launches)                  # read just after

    assert not bool(paths.nonfinite), f"serve {arch}: non-finite logits"
    check_books(reqs, st)
    secs = paths.seconds()
    prefill_batches = paths.prefill_calls
    assert launches["rmsnorm"] > 0, launches
    assert launches["quantize_int8"] == 0, launches     # bf16 KV cache
    per_call = {KIND_KERNEL[k]: cfg.layer_kinds.count(k)
                for k in set(cfg.layer_kinds)}
    for name in ("flash_attention", "ssm_scan", "rglru_scan"):
        want = per_call.get(name, 0) * prefill_batches
        assert launches[name] == want, (arch, name, launches, want)
        assert launches[name] > 0 or name not in per_call, (arch, launches)
    decode_tokens = st.useful_tokens - len(reqs)   # first tokens: prefill
    summary = dict(
        arch=arch, layers=cfg.num_layers, requests=len(reqs),
        ticks=st.ticks, splits=st.splits, fuses=st.fuses,
        completed=st.completed, useful_tokens=st.useful_tokens,
        slot_steps=st.slot_steps, efficiency=st.efficiency,
        prefill_tokens=st.prefill_tokens, prefill_calls=prefill_batches,
        prefill_waves=len(paths.spans["prefill"]),
        decode_calls=len(paths.spans["decode"]),
        prefill_tok_s=st.prefill_tokens / secs["prefill"],
        decode_tok_s=decode_tokens / secs["decode"],
        prefill_s=secs["prefill"], decode_s=secs["decode"],
        wall_s=wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches,
        launches_per_prefill_call=per_call,
        card=smi)
    log("serve", json.dumps(summary))
    # the timing hooks and the group refer to each other: drop both and
    # collect the cycle, so this model's weights are freed before the next
    # phase loads its own
    del eng, paths
    by_path = {arch: launches}
    rt = T.Runtime(use_kernels=True)
    if arch == "qwen3-14b" or cfg.moe is not None:
        decode_profile(cfg, params, rt)
    prefill_profile(cfg, params, rt, 4 * 2048 // max(prompts), max(prompts),
                    window)
    if cfg.vision_stub:
        by_path[f"vision:{arch}"] = vision_phase(cfg, params, rt, smi)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < 1e9, torch.cuda.memory_allocated()
    return by_path


def decode_profile(cfg, params, rt, B=8, S=512, steps=4):
    """Where a full-width decode step's time goes: host wall per call
    (unprofiled) against the device time torch.profiler records."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T

    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    logits, st = T.prefill(params, {"tokens": toks}, cfg, rt, window=2304)
    nxt = torch.argmax(logits, dim=-1)[:, None]

    def run(n):
        nonlocal st
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            _, st = T.decode_step(params, st, nxt, cfg, rt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    from repro_torch.kernels import ops
    run(2)
    ops.reset_launches()
    wall_ms = run(steps)
    ours = {k: v / steps for k, v in ops.launches.items() if v}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    rec = dict(batch=B, cache_len=2304, kv_quant=rt.kv_quant,
               wall_ms_per_call=wall_ms,
               device_ms_per_call=dev_ms if dev_ms > 0 else "not measured",
               device_busy_share=dev_ms / wall_ms if dev_ms > 0
               else "not measured",
               kernels_per_call=sum(e.count for e in kern) / steps,
               hand_written_launches_per_call=ours,
               top=[(e.key[:60], round(e.self_device_time_total / 1e3 / steps,
                                       4), e.count // steps) for e in top])
    log("decode_profile", json.dumps(rec))


def prefill_profile(cfg, params, rt, B, S, window):
    """Where one full-width prefill call's time goes: host wall
    (unprofiled; the serve phase has warmed every kernel) against the
    device time torch.profiler records, the top kernels, and the share of
    the hand-written kernels."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T

    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        T.prefill(params, {"tokens": toks}, cfg, rt, window=window)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    wall_ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    ours = {name: sum(e.self_device_time_total for e in kern
                      if name in e.key) / 1e3
            for name in KERNEL_NAMES}
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    rec = dict(arch=cfg.name, batch=B, prompt=S, wall_ms=wall_ms,
               device_ms=dev_ms if dev_ms > 0 else "not measured",
               device_busy_share=dev_ms / wall_ms if dev_ms > 0
               else "not measured",
               kernels=sum(e.count for e in kern),
               hand_written_ms={k: v for k, v in ours.items() if v > 0},
               top=[(e.key[:60], round(e.self_device_time_total / 1e3, 4),
                     e.count) for e in top])
    if cfg.moe is not None:
        # the MoE FFNs' share: CUDA events around every moe_forward call of
        # one more (unprofiled) call; the card is busy through a prefill
        # call (busy share ~1), so the spans hold the FFNs' device time
        from repro_torch.models import moe as M
        spans = []
        with call_spans(M, "moe_forward", spans):
            run()
        moe_ms = sum(s.elapsed_time(e) for s, e in spans)
        rec.update(moe_calls=len(spans), moe_ms=moe_ms,
                   moe_share_of_device=moe_ms / dev_ms if dev_ms > 0
                   else "not measured")
    log("prefill_profile", json.dumps(rec))


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` is ``fn`` while active."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def call_spans(module, name, spans):
    """``timed`` around every call of ``module.name`` while active."""
    with patched(module, name, timed(getattr(module, name), spans)):
        yield spans


def greedy_decode(params, logits, st, cfg, rt, steps):
    """``steps`` greedy decode steps from a prefill's (logits, state), on
    the host's clock; -> (logits, state, seconds, any logits non-finite)."""
    import torch
    from repro_torch.models import transformer as T
    nonfinite = ~torch.isfinite(logits).all()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        nxt = torch.argmax(logits, dim=-1)[:, None]
        logits, st = T.decode_step(params, st, nxt, cfg, rt)
        nonfinite.logical_or_(~torch.isfinite(logits).all())
    torch.cuda.synchronize()
    return logits, st, time.perf_counter() - t, bool(nonfinite)


def vision_phase(cfg, params, rt, smi, B=2, S=1536, window=1600, steps=16):
    """qwen2-vl-7b's vision path, which the engine (token prompts only)
    cannot drive: one prefill with ``max_vision_tokens`` patch embeddings
    merged in front of the text (the vision stub's M-RoPE grid), then
    greedy decode steps at ``pos + rope_offset``, ``rope_offset = side -
    V``.  Launch counters are zeroed just before and read just after."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    V = cfg.max_vision_tokens
    side = math.ceil(math.sqrt(V))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     device="cuda", generator=g),
             "vision_embeds": torch.randn(B, V, cfg.d_model, device="cuda",
                                          dtype=torch.bfloat16, generator=g)}
    torch.cuda.synchronize()
    ops.reset_launches()                           # zero just before the run
    t = time.perf_counter()
    logits, st = T.prefill(params, batch, cfg, rt, window=window)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_launches = dict(ops.launches)
    assert bool((st.rope_offset == side - V).all()), st.rope_offset
    logits, st, decode_s, nonfinite = greedy_decode(params, logits, st, cfg,
                                                    rt, steps)
    launches = dict(ops.launches)                  # read just after
    assert not nonfinite, "vision: non-finite logits"
    assert bool((st.pos == S + steps).all()), st.pos
    assert prefill_launches["flash_attention"] == cfg.num_layers, \
        prefill_launches
    assert launches["flash_attention"] == cfg.num_layers, launches
    assert launches["rmsnorm"] > 0 and launches["quantize_int8"] == 0, \
        launches
    rec = dict(arch=cfg.name, batch=B, prompt=S, vision_tokens=V,
               window=window, rope_offset=side - V, decode_steps=steps,
               prefill_s=prefill_s, decode_s=decode_s,
               prefill_tok_s=B * S / prefill_s,
               decode_tok_s=B * steps / decode_s,
               decode_ms_per_call=decode_s / steps * 1e3,
               prefill_launches=prefill_launches, launches=launches, card=smi)
    log("vision", json.dumps(rec))
    return launches


# (batch, audio frames, decoder prompt, window, decode steps): 1500 frames
# are whisper's 30 s of audio, 448 its decoder context (Radford et al.
# 2022, arXiv:2212.04356)
WHISPER = (8, 1500, 64, 448, 64)
WHISPER_PREFILL_REPS = 20          # timed prefill calls after the counted one


def whisper_phase(smi):
    """whisper-base at full width and depth (6 encoder + 6 decoder layers)
    through the model's own entry points, ``prefill`` and ``decode_step``:
    the engine prefills from token prompts alone, as the reference's
    does.  One prefill, then greedy decode steps; flash must launch once
    per encoder layer (bidirectional) and once per decoder layer (causal)
    for the prefill, and the decoder's cross caches hold every frame."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    B, frames, prompt, window, steps = WHISPER
    cfg = get_config("whisper-base")               # full width, bf16
    params = T.init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                          "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, prompt),
                                     device="cuda", generator=g),
             "audio_embeds": torch.randn(B, frames, cfg.d_model,
                                         device="cuda", dtype=torch.bfloat16,
                                         generator=g)}
    rt = T.Runtime(use_kernels=True)
    T.prefill(params, batch, cfg, rt, window=window)   # warm: cuBLAS picks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                           # zero just before the run
    t = time.perf_counter()
    logits, st = T.prefill(params, batch, cfg, rt, window=window)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_launches = dict(ops.launches)
    logits, st, decode_s, nonfinite = greedy_decode(params, logits, st, cfg,
                                                    rt, steps)
    launches = dict(ops.launches)                  # read just after
    assert not nonfinite, "whisper: non-finite logits"
    assert logits.shape == (B, cfg.vocab_size), logits.shape
    cross = st.reps[0]["cross"]
    assert tuple(cross.k.shape) == (cfg.num_layers, B, frames,
                                    cfg.num_kv_heads, cfg.resolved_head_dim)
    assert bool((st.pos == prompt + steps).all()), st.pos
    per_prefill = cfg.num_layers + cfg.encoder_layers
    assert prefill_launches["flash_attention"] == per_prefill, \
        prefill_launches
    assert launches["flash_attention"] == per_prefill, launches
    assert launches["rmsnorm"] > 0 and launches["quantize_int8"] == 0, \
        launches
    peak = torch.cuda.max_memory_allocated()
    # one call's wall time is at the host's mercy: the median and least of
    # more calls (after the counts were read, so not on the counted path)
    reps = []
    for _ in range(WHISPER_PREFILL_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        T.prefill(params, batch, cfg, rt, window=window)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t)
    prefill_med = statistics.median(reps)
    rec = dict(arch=cfg.name, layers=cfg.num_layers,
               encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
               params_b=T.count_params(params) / 1e9, batch=B,
               audio_frames=frames, prompt=prompt, window=window,
               decode_steps=steps, cross_cache=list(cross.k.shape),
               prefill_s=prefill_s, decode_s=decode_s,
               prefill_tok_s=B * prompt / prefill_s,
               prefill_frames_s=B * frames / prefill_s,
               prefill_s_median=prefill_med, prefill_s_min=min(reps),
               prefill_tok_s_median=B * prompt / prefill_med,
               decode_tok_s=B * steps / decode_s,
               decode_ms_per_call=decode_s / steps * 1e3,
               prefill_launches=prefill_launches, launches=launches,
               peak_gb=peak / 1e9, card=smi)
    log("whisper", json.dumps(rec))
    del params, st, logits
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 4: the fleet path — FleetEngine, int8 KV cache, steals, live moves
# ---------------------------------------------------------------------------

FLEET_GROUPS, FLEET_CAPACITY, FLEET_WINDOW = 4, 8, 2304
# KV bytes per wall tick over the inter-group link.  KVTransferCost prices
# a 2048-token request at 168.4 MB in int8 (2 stall ticks) and 335.5 MB in
# bf16 (4 ticks); on this trace the planner's one live move amortizes on
# the int8 wire layout and is vetoed on the bf16 one (the vec replay in
# fleet_phase shows both)
FLEET_LINK = 1e8


def fleet_trace(F, vocab):
    """A hot shard pinned to group 0 (0.9 arrivals a tick) and three
    warm ones (0.3: live moves need a split group with an idle part to
    land on), prompts from {512, 1024, 2048}, bimodal outputs (8 or 64,
    30 % long), 16 ticks of arrivals: 36 requests."""
    profs = [F.TenantProfile(
        f"shard{s}", rate=0.9 if s == 0 else 0.3, length_dist="bimodal",
        short_tokens=8, long_tokens=64, p_long=0.3,
        prompt_lengths=(512, 1024, 2048), shard=s)
        for s in range(FLEET_GROUPS)]
    return F.make_trace(profs, 16, vocab, seed=1)


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def qwen_weights():
    """Full-width bf16 qwen3-14b on the card, shared by the fleet and
    cluster phases; returns (cfg, params, bytes the weights hold)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-14b")                 # full width, bf16
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                          "cuda")
    torch.cuda.synchronize()
    log(f"fleet: {cfg.name} {cfg.num_layers} layers, init "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params, sum(t.numel() * t.element_size()
                            for t in _tensors(params))


def hook_moves(grp, moves, cost, cfg, window):
    """Record every live migration's moved KV rows (int8 codes and fp32
    scales) next to what ``cost`` prices them at."""
    import torch
    extract = grp.extract_live

    def run(req):
        out = extract(req)
        if out is not None:
            seq = len(req.prompt) + len(req.generated)
            kv = [t for t in _tensors(out[0]) if t.dim() >= 4]
            assert {t.dtype for t in kv} == {torch.int8, torch.float32}
            row = sum(t.numel() * t.element_size() for t in kv)
            moves.append(dict(
                rid=req.rid, seq_len=seq,
                priced_bytes=cost.kv_bytes(seq, cfg, window),
                row_bytes=row,
                row_bytes_live=row * min(seq, window) // window))
        return out
    grp.extract_live = run


def released(weight_bytes):
    """Drop what a phase left behind; only the shared weights may stay."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < weight_bytes + 1e9, \
        (torch.cuda.memory_allocated(), weight_bytes)


def fleet_phase(cfg, params, weight_bytes, smi):
    import torch
    from repro_torch import fleet as F
    from repro_torch.configs.base import (AmoebaConfig, FleetConfig,
                                          LeaseConfig, MigrationConfig)
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    rt = T.Runtime(use_kernels=True, kv_quant=True)

    def fleet_cfg(quantized, engine="object"):
        return FleetConfig(
            num_groups=FLEET_GROUPS, capacity=FLEET_CAPACITY,
            window=FLEET_WINDOW, mode="dynamic", router="sticky",
            engine=engine, amoeba=AmoebaConfig(**AMOEBA),
            migrate=MigrationConfig(enabled=True, quantized_kv=quantized,
                                    link_bandwidth=FLEET_LINK),
            lease=LeaseConfig(enabled=True))

    eng = F.FleetEngine(cfg, params, rt=rt, fleet=fleet_cfg(True))
    paths = PathSpans(cfg)
    moves = []
    for grp in eng.groups:
        paths.hook(grp)
        hook_moves(grp, moves, eng.planner.cost, cfg, FLEET_WINDOW)
    trace = fleet_trace(F, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    eng.submit(trace)
    ops.reset_launches()                           # zero just before the run
    t = time.perf_counter()
    s = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(ops.launches)                  # read just after

    assert not bool(paths.nonfinite), "fleet: non-finite decode logits"
    assert eng.completed == len(trace) == s["completed"], s["completed"]
    assert all(r.done for r in trace)
    assert all(len(r.generated) == r.max_new_tokens for r in trace)
    assert eng.useful_tokens == sum(len(r.generated) for r in trace)
    assert sum(g.stats.prefill_tokens for g in eng.groups) == \
        sum(len(r.prompt) for r in trace)
    assert all(r.finish is not None and r.finish >= r.arrival for r in trace)
    mig = s["migration"]
    assert mig["steals"] >= 1 and mig["live_migrations"] >= 1, mig
    assert len(moves) == mig["live_migrations"], moves
    n_prefill, n_decode = paths.prefill_calls, len(paths.spans["decode"])
    layers = cfg.num_layers
    # K and V in one store launch a layer, at prefill and at each decode
    assert launches["quantize_int8"] == layers * (n_prefill + n_decode), \
        (launches, n_prefill, n_decode)
    assert launches["flash_attention"] == layers * n_prefill, launches
    assert launches["rmsnorm"] > 0, launches
    secs = paths.seconds()
    # the same control plane without the model (vec engine): the plans it
    # makes pricing the int8 cache, and pricing the bf16 one
    veto = {}
    for q in (True, False):
        v = F.FleetEngine(cfg, None, fleet=fleet_cfg(q, "vec"))
        v.submit(fleet_trace(F, cfg.vocab_size))
        vm = v.run()["migration"]
        veto["int8" if q else "bf16"] = dict(
            live_migrations=vm["live_migrations"],
            rejected_amortization=vm["rejected_amortization"],
            stall_ticks_charged=vm["stall_ticks_charged"])
    assert veto["int8"]["live_migrations"] == mig["live_migrations"], veto
    groups = s["groups"]
    summary = dict(
        arch=cfg.name, layers=layers, groups=FLEET_GROUPS,
        capacity=FLEET_CAPACITY, window=FLEET_WINDOW, kv_quant=True,
        link_bandwidth=FLEET_LINK, requests=len(trace),
        prompt_tokens=sum(len(r.prompt) for r in trace),
        ticks=s["wall_ticks"], splits=sum(g["splits"] for g in groups),
        fuses=sum(g["fuses"] for g in groups), efficiency=s["efficiency"],
        latency_p50=s["latency"]["p50"], latency_p99=s["latency"]["p99"],
        steals=mig["steals"], live_migrations=mig["live_migrations"],
        stall_ticks_charged=mig["stall_ticks_charged"], lease=s["lease"],
        prefill_calls=n_prefill, decode_calls=n_decode,
        prefill_tok_s=sum(len(r.prompt) for r in trace) / secs["prefill"],
        decode_tok_s=(eng.useful_tokens - len(trace)) / secs["decode"],
        prefill_s=secs["prefill"], decode_s=secs["decode"], wall_s=wall,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, moves=moves, planner_by_wire=veto, card=smi)
    log("fleet", json.dumps(summary))
    del eng, grp, paths                    # hooks and groups form a cycle
    decode_profile(cfg, params, rt)        # launches per int8 decode call
    released(weight_bytes)
    return launches


# ---------------------------------------------------------------------------
# Phase 5: the cluster path — ClusterEngine on a tiered 2-chip mesh
# ---------------------------------------------------------------------------

CLUSTER_CHIPS, CLUSTER_GROUPS_PER_CHIP, CLUSTER_CAPACITY = 2, 2, 8
CLUSTER_WINDOW = 256
# multichip_imbalanced_trace over 24 ticks, seed 19: 71 requests from 4
# shards (chip 0's first group hot and bursty, its chipmate warm, chip 1
# trickling), prompts of 8 or 16 tokens, outputs of 3 to 48.  The vec
# engine's replay of this configuration (tests/test_torch_cluster.py)
# steals on chip and across chips, live-migrates once within a chip and
# once across, gathers regions and grants leases
CLUSTER_HORIZON, CLUSTER_SEED = 24, 19


def cluster_cfg(engine):
    from repro_torch.configs.base import (AmoebaConfig, ClusterConfig,
                                          FleetConfig, LeaseConfig,
                                          MigrationConfig)
    return FleetConfig(
        num_groups=CLUSTER_CHIPS * CLUSTER_GROUPS_PER_CHIP,
        capacity=CLUSTER_CAPACITY, window=CLUSTER_WINDOW, mode="dynamic",
        router="sticky", engine=engine, rebalance_every=4,
        amoeba=AmoebaConfig(**AMOEBA),
        migrate=MigrationConfig(enabled=True, live=True, quantized_kv=True),
        lease=LeaseConfig(enabled=True),
        cluster=ClusterConfig(groups_per_chip=CLUSTER_GROUPS_PER_CHIP),
        obs="full")


def cluster_trace(F, vocab):
    return F.multichip_imbalanced_trace(
        CLUSTER_HORIZON, vocab, seed=CLUSTER_SEED, chips=CLUSTER_CHIPS,
        groups_per_chip=CLUSTER_GROUPS_PER_CHIP)


def _scrub(summary):
    return {k: v for k, v in summary.items()
            if k not in ("wall_s", "ticks_per_sec")}


def cluster_phase(cfg, params, weight_bytes, smi):
    import torch
    from repro_torch import fleet as F
    from repro_torch.cluster import ClusterEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.obs import read_jsonl, write_chrome_trace, write_jsonl

    rt = T.Runtime(use_kernels=True, kv_quant=True)
    eng = ClusterEngine(cfg, params, rt=rt, fleet=cluster_cfg("object"))
    paths = PathSpans(cfg)
    moves = []
    for grp in eng.groups:
        paths.hook(grp)
        hook_moves(grp, moves, eng.planner.true_cost, cfg, CLUSTER_WINDOW)
    trace = cluster_trace(F, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    eng.submit(trace)
    ops.reset_launches()                           # zero just before the run
    t = time.perf_counter()
    s = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(ops.launches)                  # read just after

    assert not bool(paths.nonfinite), "cluster: non-finite decode logits"
    assert eng.completed == len(trace) == s["completed"], s["completed"]
    assert all(r.done for r in trace)
    assert all(len(r.generated) == r.max_new_tokens for r in trace)
    assert eng.useful_tokens == sum(len(r.generated) for r in trace)
    assert sum(g.stats.prefill_tokens for g in eng.groups) == \
        sum(len(r.prompt) for r in trace)
    assert all(r.finish is not None and r.finish >= r.arrival for r in trace)
    assert eng.planner.in_flight_requests() == []  # nothing left in the air
    n_prefill, n_decode = paths.prefill_calls, len(paths.spans["decode"])
    layers = cfg.num_layers
    assert launches["flash_attention"] == layers * n_prefill, launches
    assert launches["quantize_int8"] == layers * (n_prefill + n_decode), \
        (launches, n_prefill, n_decode)
    assert launches["rmsnorm"] > 0, launches
    mig, cl = s["migration"], s["cluster"]
    assert len(moves) == mig["live_migrations"], moves
    # the same control plane without the model: the vec engine plans from
    # counts alone, so the card's run must equal it exactly
    vec = ClusterEngine(cfg, None, fleet=cluster_cfg("vec"))
    vec.submit(cluster_trace(F, cfg.vocab_size))
    vs = vec.run()
    for block in ("cluster", "migration"):
        assert s[block] == vs[block], (block, s[block], vs[block])
    assert _scrub(s) == _scrub(vs)
    events = [e.as_dict() for e in eng.obs.events()]
    assert events == [e.as_dict() for e in vec.obs.events()]
    # the event stream through the exporters
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    jsonl, chrome = out / "cluster_trace.jsonl", out / "cluster_trace.json"
    n = write_jsonl(str(jsonl), eng.obs.events(), meta=eng.obs.meta)
    meta, back = read_jsonl(str(jsonl))
    assert n == len(events) and back == events and meta == eng.obs.meta
    write_chrome_trace(str(chrome), eng.obs.events(), meta=eng.obs.meta)
    with open(chrome) as f:
        trace_events = json.load(f)["traceEvents"]
    procs = sorted(e["args"]["name"] for e in trace_events
                   if e.get("name") == "process_name")
    assert procs == [f"chip {c}" for c in range(CLUSTER_CHIPS)], procs

    secs = paths.seconds()
    in_flight = [e for e in events
                 if e["kind"] == "steal" and e["payload"].get("in_flight")]
    summary = dict(
        arch=cfg.name, layers=layers, chips=CLUSTER_CHIPS,
        groups_per_chip=CLUSTER_GROUPS_PER_CHIP, capacity=CLUSTER_CAPACITY,
        window=CLUSTER_WINDOW, kv_quant=True, requests=len(trace),
        prompt_tokens=sum(len(r.prompt) for r in trace),
        ticks=s["wall_ticks"], efficiency=s["efficiency"],
        latency_p50=s["latency"]["p50"], latency_p99=s["latency"]["p99"],
        steals_by_tier={"noc": mig["intra_chip_steals"],
                        "cross_chip": mig["cross_chip_steals"]},
        cross_chip_steals_in_flight=len(in_flight),
        vetoed_cross_chip=mig["vetoed_cross_chip"],
        live_migrations={"noc": mig["intra_chip_live"],
                         "cross_chip": mig["cross_chip_live"]},
        regions={k: cl["regions"][k] for k in ("gathered", "released")},
        tier_bytes=cl["tier_bytes"], tier_stall_ticks=cl["tier_stall_ticks"],
        lease_grants=s["lease"]["grants"], events=len(events),
        prefill_calls=n_prefill, decode_calls=n_decode,
        prefill_tok_s=sum(len(r.prompt) for r in trace) / secs["prefill"],
        decode_tok_s=(eng.useful_tokens - len(trace)) / secs["decode"],
        prefill_s=secs["prefill"], decode_s=secs["decode"], wall_s=wall,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, moves=moves, card=smi)
    log("cluster", json.dumps(summary))
    del eng, vec, grp, paths               # hooks and groups form a cycle
    released(weight_bytes)
    return launches


# ---------------------------------------------------------------------------
# Phase 6: path parity — kernels vs plain at full width, 2 layers
# ---------------------------------------------------------------------------

# (arch, layers, batch, prompt length, engine window, int8 KV cache, the
# stub input and its rows); recurrentgemma-9b's 5 layers are one repetition
# and the two remainder layers, and its prompt runs past the 2048-token
# attention window; qwen2-vl-7b takes 128 vision patches; whisper-base runs
# at full depth (6 decoder layers over 6 encoder layers) over 1500 frames
PARITY = [("qwen3-14b", 2, 2, 256, 264, False, None),
          ("falcon-mamba-7b", 2, 2, 256, 264, False, None),
          ("recurrentgemma-9b", 5, 2, 2100, 2108, False, None),
          ("qwen3-14b", 2, 2, 256, 264, True, None),
          ("deepseek-moe-16b", 2, 2, 256, 264, False, None),
          ("qwen2-vl-7b", 2, 2, 256, 264, False, ("vision_embeds", 128)),
          ("whisper-base", 6, 2, 64, 72, False, ("audio_embeds", 1500))]


class PinnedRoutes:
    """The kernel path's expert choices, replayed on the plain path.

    Top-k routing is a discrete choice.  The two paths round in bf16 at
    other points upstream of each router (flash against chunked attention),
    so where a token's k-th and (k+1)-th expert probabilities nearly tie the
    paths can pick different experts, and one swapped expert moves that
    token's output by far more than a rounding.  So the kernel path (run
    first) records each router call's ids; the plain path's router runs on
    its own inputs, counts the token rows whose top-k set differs, and
    returns the recorded ids with its own renormalised probabilities.
    """

    def __init__(self, module):
        self.module, self.route = module, module._route
        self.ids, self.replay = [], False
        self.rows = self.swapped = 0

    def __call__(self, params, x2d, cfg):
        import torch
        ids, w, aux, load = self.route(params, x2d, cfg)
        if not self.replay:
            self.ids.append(ids)
            return ids, w, aux, load
        want = self.ids.pop(0)
        self.rows += ids.shape[0]
        self.swapped += int((ids.sort(-1).values != want.sort(-1).values)
                            .any(-1).sum())
        probs = torch.softmax(x2d.float() @ params["router"], dim=-1)
        top_p = probs.gather(1, want)
        return (want, top_p / torch.clamp(top_p.sum(-1, keepdim=True),
                                           min=1e-9), aux, load)

    def __enter__(self):
        self.module._route = self
        return self

    def __exit__(self, *exc):
        self.module._route = self.route


def _int8_caches(state):
    """(codes, scales) of every int8 KV cache in a decode state."""
    import torch
    ts = _tensors(state)
    return ([t for t in ts if t.dtype == torch.int8],
            [t for t in ts if t.dtype == torch.float32 and t.dim() >= 4])


def _cache_diff(a, b):
    """How far the two paths' int8 caches are apart: their K/V inputs
    differ by bf16 roundings upstream (the rmsnorm kernel and flash
    attention round at other points than the plain ops)."""
    (qa, sa), (qb, sb) = _int8_caches(a), _int8_caches(b)
    dq = [(x.int() - y.int()).abs() for x, y in zip(qa, qb)]
    return dict(max_code_diff=max(int(d.max()) for d in dq),
                codes_differing=sum(int((d != 0).sum()) for d in dq),
                codes=sum(d.numel() for d in dq),
                max_scale_rel_diff=max(float(((x - y).abs() / y).max())
                                       for x, y in zip(sa, sb)))


def parity_phase(arch, layers, B, S, window, kv_quant, extra):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as QZ
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = get_config(arch).replace(num_layers=layers)
    g = torch.Generator(device="cuda").manual_seed(1)
    params = T.init_model(cfg, g, "cuda")
    batch = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")}
    if extra is not None:
        key, rows = extra
        batch[key] = torch.randn(B, rows, cfg.d_model, device="cuda",
                                 dtype=torch.bfloat16, generator=g)
    rts = [T.Runtime(use_kernels=k, kv_quant=kv_quant) for k in (True, False)]
    pin = PinnedRoutes(M) if cfg.moe is not None else None

    def on(i):
        """Path i (0 kernels, 1 plain) runs next."""
        if pin is not None:
            pin.replay = i == 1
    # every int8 KV store of the kernel path, held to the plain store on
    # clones of the same caches and inputs: codes and scales equal exactly
    store, prefill_store = ops.quantize_kv_store_, ops.quantize_kv_prefill
    checked = {"calls": 0, "rows": 0}

    def checked_store(new_k, new_v, k, v, k_scale, v_scale, pos, W,
                      offset=0, floor=1e-8):
        want = [t.clone() for t in (k, v, k_scale, v_scale)]
        store(new_k, new_v, k, v, k_scale, v_scale, pos, W, offset, floor)
        QZ.quantize_kv_store_plain_(new_k, new_v, *want, pos, W, offset,
                                    floor)
        _equal_all((k, v, k_scale, v_scale), want, "an int8 KV decode store")
        checked["calls"] += 1
        checked["rows"] += 2 * new_k.shape[0] * new_k.shape[1]

    def checked_prefill(k, v, W, floor=1e-8):
        out = prefill_store(k, v, W, floor)
        _equal_all(out, QZ.quantize_kv_prefill_plain(k, v, W, floor),
                   "an int8 KV prefill store")
        checked["calls"] += 1
        checked["rows"] += 2 * k.shape[0] * W * k.shape[2]
        return out

    ops.quantize_kv_store_, ops.quantize_kv_prefill = (checked_store,
                                                       checked_prefill)
    with pin if pin is not None else contextlib.nullcontext():
        # the final hidden states too: at 2 layers falcon-mamba's tied
        # logits are dominated by each token's own embedding (|logit| ~
        # d_model), where a bf16 ulp hides what the blocks did
        hid = []
        for i, rt in enumerate(rts):
            on(i)
            hid.append(T.forward_hidden(
                params, *T.embed_inputs(params, batch, cfg, rt), cfg,
                rt)[0].float())
        hid_err = float((hid[0] - hid[1]).abs().max())
        hid_tol = max(PARITY_TOL, PARITY_REL * float(hid[1].abs().max()))
        del hid
        outs = []
        for i, rt in enumerate(rts):
            on(i)
            outs.append(T.prefill(params, batch, cfg, rt, window=window))
        errs = [float((outs[0][0].float() - outs[1][0].float()).abs().max())]
        absmax = float(outs[1][0].float().abs().max())
        states = [o[1] for o in outs]
        caches = {"prefill": _cache_diff(*states)} if kv_quant else {}
        nxt = torch.argmax(outs[0][0], dim=-1)[:, None]
        for _ in range(8):
            lg = []
            for i, rt in enumerate(rts):
                on(i)
                logits, states[i] = T.decode_step(params, states[i], nxt, cfg,
                                                  rt)
                assert bool(torch.isfinite(logits).all())
                lg.append(logits.float())
            errs.append(float((lg[0] - lg[1]).abs().max()))
            absmax = max(absmax, float(lg[1].abs().max()))
            nxt = torch.argmax(lg[0], dim=-1)[:, None]   # same tokens to both
    ops.quantize_kv_store_, ops.quantize_kv_prefill = store, prefill_store
    if kv_quant:
        caches["decode_8"] = _cache_diff(*states)
        # K and V of each layer, at prefill and at each of the 8 steps: one
        # store a layer and call
        assert checked["calls"] == layers * 9, checked
    tol = PARITY_TOL if arch == "qwen3-14b" else max(PARITY_TOL,
                                                     PARITY_REL * absmax)
    rec = dict(arch=arch, layers=layers, batch=B, prompt=S,
               kv_quant=kv_quant, stub_input=extra,
               routes_replayed=None if pin is None else dict(
                   rows=pin.rows, swapped=pin.swapped, left=len(pin.ids)),
               max_abs_err_prefill=errs[0], max_abs_err_decode=max(errs[1:]),
               tol=tol, logit_absmax=absmax, max_abs_err_hidden=hid_err,
               hidden_tol=hid_tol, int8_writes_checked=checked,
               int8_cache_kernel_vs_plain_path=caches)
    log("parity", json.dumps(rec))
    assert max(errs) <= tol and hid_err <= hid_tol, rec
    assert pin is None or (pin.rows > 0 and not pin.ids), rec
    del params, outs, states
    torch.cuda.empty_cache()


def block_parity(kind):
    """One full-width recurrent block in float32 at B1 S2048, the kernel
    scan against the chunked torch scan (``use_kernel=False``), on the
    block's output and its final state."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import rglru as RG, ssm as SM
    arch, init, fwd = {
        "ssm": ("falcon-mamba-7b", SM.init_ssm, SM.ssm_forward),
        "rglru": ("recurrentgemma-9b", RG.init_rglru, RG.rglru_forward)}[kind]
    cfg = get_config(arch).replace(dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = init(cfg, "cuda", g)
    x = torch.randn(1, 2048, cfg.d_model, device="cuda", generator=g)
    outs = [fwd(params, x, cfg, use_kernel=k, return_state=True)
            for k in (True, False)]
    rec = dict(block=kind, arch=arch, batch=1, prompt=2048, dtype="float32")
    for name, got, want in (("out", outs[0][0], outs[1][0]),
                            ("h_last", outs[0][1].h, outs[1][1].h)):
        err = float((got - want).abs().max())
        tol = BLOCK_TOL * float(want.abs().max())
        rec[name] = dict(max_abs_err=err, tol=tol, absmax=tol / BLOCK_TOL)
    log("block_parity", json.dumps(rec))
    assert all(rec[k]["max_abs_err"] <= rec[k]["tol"]
               for k in ("out", "h_last")), rec
    del params, outs
    torch.cuda.empty_cache()


def block_peak(B=4, S=2048):
    """The device memory one full-width falcon-mamba SSM block adds to the
    peak at the prefill call's shape, through the fused scan and through
    the plain path; the fused one must stay below one fp32 (B, S, d_inner,
    d_state) tensor, so no such tensor can have existed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as SM
    cfg = get_config("falcon-mamba-7b")                # bf16, full width
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = SM.init_ssm(cfg, "cuda", g)
    x = torch.randn(B, S, cfg.d_model, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    di = cfg.ssm.expand * cfg.d_model
    limit = 4 * B * S * di * cfg.ssm.d_state
    added = {}
    for k in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = SM.ssm_forward(params, x, cfg, use_kernel=k)
        torch.cuda.synchronize()
        added["kernel" if k else "plain"] = \
            torch.cuda.max_memory_allocated() - base
        del out
    rec = dict(batch=B, prompt=S, d_inner=di, d_state=cfg.ssm.d_state,
               added_gb=added["kernel"] / 1e9,
               plain_path_added_gb=added["plain"] / 1e9,
               limit_gb=limit / 1e9)
    log("block_peak", json.dumps(rec))
    assert added["kernel"] < limit, rec
    del params, x
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 7: train — the training stack at full width
# ---------------------------------------------------------------------------

# qwen3-14b at full width, its depth cut from 40 layers: all 40 need 14.77
# B parameters x 8 bytes (bf16 params, grads, m, v) = 118 GB against the
# card's 80; at 8 layers 4.198 B parameters hold 33.6 GB, plus 16.8 GB of
# fp32 compression residuals
TRAIN_QWEN_LAYERS = 8
# deepseek-moe-16b at full width, 4 of 28 layers (2.77 B parameters, 22 GB
# with moments; every expert runs on every token)
TRAIN_DEEPSEEK_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
# whisper-base at full width and depth: B8, its 448-token decoder context,
# 1500 audio frames; failures injected before steps 5 and 8
TRAIN_WHISPER = (8, 448, 10)
TRAIN_FAILS = (5, 8)


def _tail_projection(keys):
    """The key suffix of the last matmul a block's forward runs: the FFN's
    down projection; with MoE, that of the dense residual or the shared
    experts, which ``moe_dense`` adds after the routed experts."""
    for tail in ("/ffn/dense/wo", "/ffn/shared/wo", "/ffn/wo"):
        if any(k.endswith(tail) for k in keys):
            return tail
    return None


def train_flops(cfg, params, B, S):
    """(model FLOPs of one training step, FLOPs executed, the reckoning).

    Model: 6·N·T for the N active parameters that multiply (all but the
    embedding table, a lookup; the router and the unembedding included; of
    a routed expert bank only top_k/E, the experts a token is sent to)
    plus causal attention's scores and P·V over the half of S² a token
    attends, 2·B·S²·H·hd a layer forward, 3x with the backward.  Executed
    counts what runs: every expert on every token (``moe_dense``), the full
    S² the chunked attention computes (4·B·S²·H·hd a layer forward), and
    what activation checkpointing recomputes: each block's forward (2·N·T
    of the blocks' parameters and attention's forward once more) and each
    loss chunk's unembedding (2·N·T of it).  torch's checkpoint stops
    recomputing once the tensors the backward saved are back, so the
    block's last matmul, whose output no backward reads (the FFN's down
    projection: ``_tail_projection``), is not recomputed."""
    from repro_torch import pytree
    T_ = B * S
    blocks = [params[k] for k in ("reps", "rest") if k in params]
    flat = pytree.flatten_with_paths(blocks)
    tail = _tail_projection(flat)
    n_blocks = n_routed = n_tail = 0
    for key, leaf in flat.items():
        n_blocks += leaf.numel()
        if "/experts/" in key:
            n_routed += leaf.numel()
        if tail is not None and key.endswith(tail):
            n_tail += leaf.numel()
    share = cfg.moe.top_k / cfg.moe.num_experts if cfg.moe else 1.0
    n_active = n_blocks - n_routed + share * n_routed
    emb = params["embed"]
    n_out = (emb["out"] if "out" in emb else emb["table"]).numel()
    n_mm = n_active + n_out
    attn_full = 4.0 * B * S * S * cfg.num_heads * cfg.resolved_head_dim * \
        sum(k == "attn" for k in cfg.layer_kinds)
    model = 6.0 * n_mm * T_ + 3.0 * attn_full / 2
    executed = (6.0 * (n_blocks + n_out) * T_ + 3.0 * attn_full
                + 2.0 * (n_blocks - n_tail) * T_ + attn_full
                + 2.0 * n_out * T_)
    how = (f"6·N·T = 6 x {n_mm:,.0f} x {T_:,} = {6.0 * n_mm * T_ / 1e12:.2f} "
           f"TFLOP (N: active block parameters {n_active:,.0f}"
           + (f", of which routed experts {share * n_routed:,.0f} = top_k/E "
              f"of {n_routed:,}" if n_routed else "")
           + f", + unembedding {n_out:,}; the embedding table is a lookup) "
           f"+ causal attention 3 x 2·B·S²·H·hd·L = {1.5 * attn_full / 1e12:.2f}"
           f" TFLOP; executed: all {n_blocks:,} block parameters, the full "
           f"S² attention, the recomputed blocks 2·(N_blocks - N_tail)·T "
           f"(N_tail: the {n_tail:,} parameters of the blocks' last matmul "
           f"{tail}, which the checkpoint does not recompute) + attention "
           f"forward and the loss chunks' unembedding 2·N_out·T = "
           f"{executed / 1e12:.2f} TFLOP")
    return model, executed, how


def check_compress_exact(tr, params):
    """One step's gradients through ``compress_leaf`` with the kernel and
    with its plain version on the card: codes and scales equal exactly,
    every leaf.  -> (leaves, distinct (rows, D) shapes)."""
    import torch
    from repro_torch import pytree
    from repro_torch.kernels import quantize as QZ
    from repro_torch.parallel import compression as C
    batch = tr.place_batch(tr.data.batch_at(0))
    _, _, grads = tr.loss_and_grads(params, batch)
    shapes, bad = set(), {}
    for key, g in pytree.flatten_with_paths(grads).items():
        q, s, _ = C.compress_leaf(g)
        with patched(C, "_quant",
                     lambda x: QZ.quantize_int8_plain(x, C.FLOOR)):
            wq, ws, _ = C.compress_leaf(g)
        shapes.add(tuple(q.shape))
        if not (torch.equal(q, wq) and torch.equal(s, ws)):
            bad[key] = (int((q != wq).sum()), int((s != ws).sum()))
        del q, s, wq, ws
    assert not bad, f"compress_leaf: kernel differs from plain: {bad}"
    return len(pytree.leaves(grads)), sorted(shapes)


def train_qwen_setup():
    """(config, shape, TrainConfig) of the qwen3-14b train phase."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    cfg = get_config("qwen3-14b").replace(num_layers=TRAIN_QWEN_LAYERS)
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=1, total_steps=6,
                       remat="full", grad_compression=True)
    return cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), tcfg


def train_deepseek_setup():
    """(config, shape, TrainConfig) of the deepseek-moe-16b train phase."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    cfg = get_config("deepseek-moe-16b").replace(
        num_layers=TRAIN_DEEPSEEK_LAYERS)
    return (cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
            TrainConfig(total_steps=4, warmup_steps=1))


def train_qwen_phase(smi, hw, predicted):
    """qwen3-14b at full width (8 of 40 layers), B4 S2048, 6 steps with
    gradient compression: the quantize kernel's rows entry launches once
    per parameter leaf per step, and equals its plain version exactly on
    one step's gradients.  Its first step is counted and held to
    ``predicted``, the same step counted on ``meta``."""
    import torch
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as A
    from repro_torch.parallel import compression as C
    from repro_torch.train import Trainer

    full = get_config("qwen3-14b")                 # full width, bf16
    cfg, shape, tcfg = train_qwen_setup()
    B, S, steps = TRAIN_BATCH, TRAIN_SEQ, tcfg.total_steps
    tr = Trainer(cfg, shape, tcfg, device="cuda")
    assert tr.rt.remat and tr.rt.loss_chunk == 512 and not tr.rt.use_kernels
    t0 = time.perf_counter()
    state = tr.init_state(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_leaves = len(pytree.leaves(state.params))
    n_params = T.count_params(state.params)
    model_flops, executed_flops, how = train_flops(cfg, state.params, B, S)
    resident = torch.cuda.memory_allocated()
    spans = {"compress": [], "adamw": []}
    counted = count_first_step(tr)
    torch.cuda.reset_peak_memory_stats()
    with call_spans(C, "round_trip_", spans["compress"]), \
            call_spans(A, "adamw_update", spans["adamw"]):
        ops.reset_launches()                       # zero just before the run
        out = tr.train(steps, state=state)
        launches = dict(ops.launches)              # read just after
    peak = torch.cuda.max_memory_allocated()
    pred = check_prediction("qwen3-14b", *predicted, counted["sc"],
                            executed_flops, peak, smi)
    hist = out["history"]
    assert [m.step for m in hist] == list(range(steps)), hist
    for m in hist:
        assert math.isfinite(m.loss) and math.isfinite(m.grad_norm), m
    assert launches["quantize_int8"] == n_leaves * steps, (launches, n_leaves)
    assert sum(launches.values()) == launches["quantize_int8"], launches
    per = [spans["compress"][i * n_leaves:(i + 1) * n_leaves]
           for i in range(steps)]
    compress_s = [sum(s.elapsed_time(e) for s, e in p) / 1e3 for p in per]
    adamw_s = [s.elapsed_time(e) / 1e3 for s, e in spans["adamw"]]
    params = out["state"].params
    state = out = None                             # drop moments, residuals
    gc.collect()
    torch.cuda.empty_cache()
    leaves, shapes = check_compress_exact(tr, params)
    step_s = statistics.median(m.dt for m in hist[2:])
    rec = dict(
        arch=cfg.name, layers=cfg.num_layers, of_layers=full.num_layers,
        reduced=f"depth {full.num_layers} -> {cfg.num_layers} layers: "
        f"{full.num_layers} need {full.param_count() * 8 / 1e9:.0f} GB of "
        f"bf16 params, grads and moments",
        d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        params=n_params, batch=B, seq=S, tokens_per_step=B * S, steps=steps,
        loss=[m.loss for m in hist], grad_norm=[m.grad_norm for m in hist],
        lr=[m.lr for m in hist], step_s=[m.dt for m in hist],
        step_s_median_3_6=step_s, tok_s=B * S / step_s,
        model_tflop=model_flops / 1e12, executed_tflop=executed_flops / 1e12,
        reckoning=how, model_tflop_s=model_flops / step_s / 1e12,
        peak_share=model_flops / step_s / hw.peak_flops,
        compress_s=compress_s,
        compress_s_median_3_6=statistics.median(compress_s[2:]),
        adamw_s=adamw_s, adamw_s_median_3_6=statistics.median(adamw_s[2:]),
        param_leaves=n_leaves, quantize_launches=launches["quantize_int8"],
        compress_exact_leaves=leaves, compress_row_shapes=shapes,
        init_s=init_s, resident_gb=resident / 1e9, peak_gb=peak / 1e9,
        predicted_peak_gb=pred["meta_peak_gb"],
        counted_tflop=pred["card_tflop"], card=smi)
    log("train:qwen3-14b", json.dumps(rec))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_deepseek_phase(smi, hw, predicted):
    """deepseek-moe-16b at full width (4 of 28 layers), B4 S2048, 4 steps
    with the AMOEBA controller fed each step's expert-load divergence
    (tests/test_runtime.py::test_moe_divergence_telemetry at full width).
    Its first step is counted and held to ``predicted``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import AmoebaConfig
    from repro_torch.core.controller import AmoebaController
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.train import Trainer

    full = get_config("deepseek-moe-16b")
    cfg, shape, tcfg = train_deepseek_setup()
    B, S, steps = TRAIN_BATCH, TRAIN_SEQ, tcfg.total_steps
    ctl = AmoebaController(AmoebaConfig(min_phase_steps=1))
    tr = Trainer(cfg, shape, tcfg, controller=ctl, device="cuda")
    state = tr.init_state(SEED)
    n_params = T.count_params(state.params)
    model_flops, executed_flops, how = train_flops(cfg, state.params, B, S)
    loads = []
    counted = count_first_step(tr)
    step = tr.step

    def recording(st, batch):
        st, out = step(st, batch)
        loads.append(out["expert_load"])
        return st, out

    tr.step = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                           # zero just before the run
    out = tr.train(steps, state=state)
    launches = dict(ops.launches)                  # read just after
    peak = torch.cuda.max_memory_allocated()
    pred = check_prediction("deepseek-moe-16b", *predicted, counted["sc"],
                            executed_flops, peak, smi)
    hist = out["history"]
    assert [m.step for m in hist] == list(range(steps)), hist
    assert all(math.isfinite(m.loss) for m in hist), hist
    assert all(m.divergence > 0 for m in hist), hist
    assert len(ctl.split_state.history) == steps, ctl.split_state
    sums = [float(x.sum()) for x in loads]
    assert all(bool(torch.isfinite(x).all()) for x in loads)
    # each MoE layer's load fractions sum to 1; expert_load is their mean
    assert all(abs(v - 1.0) < 1e-5 for v in sums), sums
    step_s = statistics.median(m.dt for m in hist[1:])
    rec = dict(
        arch=cfg.name, layers=cfg.num_layers, of_layers=full.num_layers,
        experts=cfg.moe.num_experts, top_k=cfg.moe.top_k, params=n_params,
        batch=B, seq=S, steps=steps, loss=[m.loss for m in hist],
        divergence=[m.divergence for m in hist],
        split=[h[1] for h in ctl.split_state.history],
        expert_load_sums=sums, step_s=[m.dt for m in hist],
        step_s_median_2_4=step_s, tok_s=B * S / step_s,
        model_tflop=model_flops / 1e12, executed_tflop=executed_flops / 1e12,
        reckoning=how, model_tflop_s=model_flops / step_s / 1e12,
        peak_share=model_flops / step_s / hw.peak_flops,
        peak_gb=peak / 1e9, predicted_peak_gb=pred["meta_peak_gb"],
        counted_tflop=pred["card_tflop"], card=smi)
    log("train:deepseek-moe-16b", json.dumps(rec))
    del state, out, loads
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_whisper_phase(smi):
    """whisper-base at full width and depth, 10 steps, once straight
    through and once with failures injected before steps 5 and 8, resuming
    from ``build/ckpt_train`` (every 4 steps, 2 kept): every step's loss
    must equal the uninterrupted run's exactly
    (tests/test_runtime.py::test_failure_resume_is_exact on the card), and
    the last checkpoint restore key for key into a fresh ``TrainState``.
    Runs under ``torch.use_deterministic_algorithms``: the embedding's
    backward accumulates with ``index_put_``, whose default CUDA form adds
    in whatever order the atomics land."""
    import shutil
    import torch
    from repro_torch import pytree
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data import DataConfig
    from repro_torch.kernels import ops
    from repro_torch.train import Trainer

    cfg = get_config("whisper-base")               # full width and depth
    B, S, steps = TRAIN_WHISPER
    tcfg = TrainConfig(total_steps=steps, warmup_steps=2, learning_rate=1e-3,
                       checkpoint_every=4)

    def trainer():
        return Trainer(cfg, ShapeConfig("train", S, B, "train"), tcfg,
                       device="cuda")

    torch.use_deterministic_algorithms(True)
    try:
        base = trainer().train(steps)["history"]
        losses = [m.loss for m in base]
        d = ROOT / "build" / "ckpt_train"
        shutil.rmtree(d, ignore_errors=True)
        ck = CheckpointManager(str(d), keep=2)
        fails = set(TRAIN_FAILS)

        def inject(k):
            if k in fails:
                fails.discard(k)
                return True
            return False

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()                       # zero just before the run
        t0 = time.perf_counter()
        out = trainer().train(steps, ckpt=ck, failure_injector=inject)
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)              # read just after
        peak = torch.cuda.max_memory_allocated()
    finally:
        torch.use_deterministic_algorithms(False)
    hist = out["history"]
    assert out["resumes"] == 2, out["resumes"]
    assert [m.step for m in hist] == [0, 1, 2, 3, 4, 4, 5, 6, 7, 8, 9], hist
    diff = max(abs(m.loss - losses[m.step]) for m in hist)
    assert diff == 0.0, [(m.step, m.loss, losses[m.step]) for m in hist]
    assert all(math.isfinite(x) for x in losses), losses
    fresh = trainer().init_state(SEED + 1)
    step, got, extra = ck.restore(like=fresh, device="cuda")
    want = pytree.flatten_with_paths(out["state"])
    got = pytree.flatten_with_paths(got)
    assert step == steps and extra == {"k": steps}, (step, extra)
    assert set(got) == set(want) == set(pytree.flatten_with_paths(fresh))
    differ = [k for k in want if not (got[k].dtype == want[k].dtype
                                      and torch.equal(got[k], want[k]))]
    assert not differ, differ
    step_s = statistics.median(m.dt for m in base[2:])
    rec = dict(arch=cfg.name, layers=cfg.num_layers,
               encoder_layers=cfg.encoder_layers, batch=B, seq=S,
               audio_frames=DataConfig().enc_frames, steps=steps, loss=losses,
               resumed_steps=[m.step for m in hist], resumes=out["resumes"],
               max_loss_diff=diff, restored_keys=len(got),
               step_s=[m.dt for m in base], step_s_median_3_10=step_s,
               tok_s=B * S / step_s, resumed_run_wall_s=wall,
               peak_gb=peak / 1e9, card=smi)
    log("train:whisper-base", json.dumps(rec))
    del out, got, fresh
    gc.collect()
    torch.cuda.empty_cache()
    return launches



# ---------------------------------------------------------------------------
# the step counter's prediction of the train phases (dryrun, part b)
# ---------------------------------------------------------------------------

STEP_PEAK_REL = 0.15               # meta peak against max_memory_allocated
STEP_FLOPS_REL = 0.02              # counted FLOPs against train_flops


def predict_train_step(cfg, shape, tcfg):
    """One step of the train phase's configuration counted on the ``meta``
    device (``core.step_count``): nothing allocated, no card."""
    import torch
    from repro_torch.core.step_count import StepCounter
    from repro_torch.train import Trainer
    tr = Trainer(cfg, shape, tcfg, device="meta")
    state = tr._restore_template()
    batch = {"tokens": torch.empty((shape.global_batch, shape.seq_len),
                                   dtype=torch.long, device="meta")}
    t0 = time.perf_counter()
    with StepCounter((state, batch)) as sc:
        tr.step(state, batch)
    return sc, time.perf_counter() - t0


def count_first_step(tr):
    """Wrap ``tr.step`` so that its first call runs under a
    ``StepCounter``; -> a dict that holds the counter after that call."""
    from repro_torch.core.step_count import StepCounter
    step, box = tr.step, {}

    def first(st, batch):
        if "sc" in box:
            return step(st, batch)
        with StepCounter((st, batch)) as sc:
            out = step(st, batch)
        box["sc"] = sc
        return out

    tr.step = first
    return box


def check_prediction(name, meta, meta_s, card, executed, peak, smi):
    """The meta count against the card's count of the same step (FLOPs
    equal), ``train_flops``' executed reckoning (2 %) and the card's
    ``max_memory_allocated`` (15 %)."""
    rec = dict(
        meta_tflop=meta.flops / 1e12, card_tflop=card.flops / 1e12,
        executed_tflop=executed / 1e12,
        flops_rel=meta.flops / executed - 1.0,
        meta_peak_gb=meta.peak_bytes / 1e9, card_peak_gb=peak / 1e9,
        peak_rel=meta.peak_bytes / peak - 1.0,
        card_counted_peak_gb=card.peak_bytes / 1e9,
        meta_arg_gb=meta.arg_bytes / 1e9,
        meta_hbm_gb=meta.hbm_bytes / 1e9, card_hbm_gb=card.hbm_bytes / 1e9,
        meta_trace_s=meta_s, card=smi)
    log(f"dryrun:predict:{name}", json.dumps(rec))
    assert meta.flops == card.flops, (name, meta.flops, card.flops)
    assert abs(rec["flops_rel"]) <= STEP_FLOPS_REL, (name, rec)
    assert abs(rec["peak_rel"]) <= STEP_PEAK_REL, (name, rec)
    return rec


# ---------------------------------------------------------------------------
# gpusim: the paper's simulator (host numpy, no device work)
# ---------------------------------------------------------------------------

def _geomean(xs) -> float:
    return float(math.exp(statistics.fmean(math.log(x) for x in xs)))


def gpusim_phase():
    """Every scheme of ``SCHEMES`` over the 12 workloads through the port's
    gpusim; the Fig 12 speedups over ``baseline`` held to
    tests/test_gpusim.py's ranges."""
    from repro_torch.core.gpusim import SCHEMES, WORKLOADS, run_all
    from repro_torch.core.gpusim.sim import FUSED, QSPLIT
    t0 = time.perf_counter()
    res = {s: run_all(s) for s in SCHEMES}
    wall = time.perf_counter() - t0
    base = res["baseline"]

    def speedups(scheme):
        return {n: res[scheme][n].ipc / base[n].ipc for n in WORKLOADS}

    sp = {s: speedups(s) for s in SCHEMES if s != "baseline"}
    wr, dws, su, st = (sp["warp_regroup"], sp["dws"], sp["scale_up"],
                       sp["static_fuse"])
    geo = {s: _geomean(v.values()) for s, v in sp.items()}
    over_dws = _geomean(wr[n] / dws[n] for n in WORKLOADS)
    tr = res["warp_regroup"]["RAY"].trace
    both = float(((tr == FUSED).any(axis=1)
                  & (tr == QSPLIT).any(axis=1)).mean())
    rec = dict(
        sm=wr["SM"], mum=wr["MUM"], geomean=geo,
        amoeba_over_dws=over_dws, sm_over_dws=wr["SM"] / dws["SM"],
        static_choice={n: {"scale_up": su[n], "static_fuse": st[n]}
                       for n in ("CP", "3MM")},
        ray_both_states_share=both, wall_s=wall)
    log("gpusim (host numpy, no device work)", json.dumps(rec))
    assert 3.8 <= wr["SM"] <= 4.8, wr["SM"]
    assert 1.8 <= wr["MUM"] <= 2.5, wr["MUM"]
    assert 1.30 <= geo["warp_regroup"] <= 1.60, geo
    assert geo["warp_regroup"] >= geo["direct_split"] \
        >= geo["static_fuse"] - 1e-9, geo
    assert geo["warp_regroup"] > geo["dws"], geo
    assert over_dws > 1.2 and wr["SM"] / dws["SM"] > 3.5, rec
    for n in ("CP", "3MM"):
        assert su[n] < 1.0 and st[n] >= su[n], (n, su[n], st[n])
    for n in ("FWT", "KM"):
        assert abs(wr[n] - 1.0) < 0.1, (n, wr[n])
    assert both > 0.2, both
    assert res["warp_regroup"]["SM"].l1d_miss < 0.5 * base["SM"].l1d_miss
    for n in ("SM", "MUM"):
        assert res["warp_regroup"][n].actual_mem_rate < \
            base[n].actual_mem_rate, n
    return rec


# ---------------------------------------------------------------------------
# dryrun, part a: mesh cells on fake groups, in a child process
# ---------------------------------------------------------------------------

# (arch, shape, multi-pod, plan): qwen3-14b's train step under the three
# plans of the 16x16 family, deepseek's decode, qwen3's 32k prefill on the
# 2x16x16 mesh (512 ranks)
DRYRUN_CELLS = (("qwen3-14b", "train_4k", False, "base"),
                ("qwen3-14b", "train_4k", False, "fused"),
                ("qwen3-14b", "train_4k", False, "scale_out"),
                ("deepseek-moe-16b", "decode_32k", False, "base"),
                ("qwen3-14b", "prefill_32k", True, "base"),
                ("falcon-mamba-7b", "prefill_32k", False, "base"),
                ("recurrentgemma-9b", "train_4k", False, "base"))
# each cell's per-device TFLOP on the tree before its entry point was
# tensor-parallel (each rank computed whole layers on its rows), by (arch,
# shape, plan): ``launch/dryrun.py`` counting the same cells on a CPU (the
# count depends on shapes alone), the serving cells on the tree before the
# tensor-parallel serving path, the train cells on the one before the
# tensor-parallel trainer, the falcon-mamba and recurrentgemma cells on the
# one before their mixers were (SSM and RG-LRU mixers whole on every model
# rank)
DRYRUN_BEFORE_TP = {
    ("deepseek-moe-16b", "decode_32k", "base"): 0.024377294848,
    ("falcon-mamba-7b", "prefill_32k", "base"): 882.907903688704,
    ("recurrentgemma-9b", "train_4k", "base"): 1389.782697508864,
    ("qwen3-14b", "prefill_32k", "base"): 1841.68353234944,
    ("qwen3-14b", "train_4k", "base"): 7747.09020983296,
    ("qwen3-14b", "train_4k", "fused"): 15494.18041966592,
    ("qwen3-14b", "train_4k", "scale_out"): 3873.54510491648}
# the train cells' peak GB a device on that tree, which they must fall below
DRYRUN_PEAK_BEFORE_TP = {
    ("qwen3-14b", "train_4k", "base"): 168.141707284,
    ("qwen3-14b", "train_4k", "fused"): 333.229512724,
    ("qwen3-14b", "train_4k", "scale_out"): 85.597804564}
DRYRUN_CHILD = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
t0 = time.perf_counter()
for arch, shape, multi_pod, plan in json.loads(sys.argv[1]):
    art = dryrun.run_cell(arch, shape, multi_pod=multi_pod, plan_name=plan,
                          out_dir=sys.argv[2], verbose=False)
    print("CELL " + json.dumps(art), flush=True)
assert "jax" not in sys.modules and not torch.cuda.is_initialized()
print("WALL %r" % (time.perf_counter() - t0), flush=True)
"""


def start_dryrun_cells():
    """Start the mesh cells' child now: its ``fake`` process group must
    not share a process with the dist phase's gloo groups, and it needs
    only the host, so it runs while the card works.  No card is visible
    to it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHILD, json.dumps(DRYRUN_CELLS),
         str(ROOT / "build" / "dryrun_torch")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def dryrun_cells_phase(proc, smi):
    """Read the mesh cells' artifacts, print each profile's roofline
    terms, and feed the three qwen3-14b train profiles to
    ``AmoebaController.choose_plan`` as benchmarks/mesh_amoeba.py feeds the
    reference's artifacts."""
    from repro_torch.configs.base import AmoebaConfig
    from repro_torch.core.controller import AmoebaController
    from repro_torch.core.metrics import StepProfile
    t0 = time.perf_counter()
    out, _ = proc.communicate(timeout=900)
    waited = time.perf_counter() - t0
    assert proc.returncode == 0, out[-6000:]
    lines = out.splitlines()
    arts = [json.loads(x[5:]) for x in lines if x.startswith("CELL ")]
    child_s = [float(x[5:]) for x in lines if x.startswith("WALL ")]
    assert len(arts) == len(DRYRUN_CELLS) and len(child_s) == 1, out[-6000:]
    for a, (arch, shape, multi_pod, plan) in zip(arts, DRYRUN_CELLS):
        assert (a["arch"], a["shape"], a["plan"]) == (arch, shape, plan), a
        assert a["chips"] == (512 if multi_pod else 256), a
        assert a["flops_per_device"] > 0 and a["hbm_bytes_per_device"] > 0
        assert a["collective_bytes_per_device"] > 0, a["collective_breakdown"]
        assert a["peak_bytes_per_device"] > a["argument_size_in_bytes"] > 0
        r = a["roofline"]
        log(f"dryrun:{arch}:{shape}:{a['mesh']}", json.dumps(dict(
            plan=plan, chips=a["chips"], kind=a["kind"],
            tflop_per_device=a["flops_per_device"] / 1e12,
            hbm_gb_per_device=a["hbm_bytes_per_device"] / 1e9,
            coll_gb_per_device=a["collective_bytes_per_device"] / 1e9,
            coll_gb={k: v / 1e9 for k, v in a["collective_breakdown"].items()},
            peak_gb_per_device=a["peak_bytes_per_device"] / 1e9,
            compute_s=r["compute_s"], memory_s=r["memory_s"],
            collective_s=r["collective_s"], bottleneck=r["bottleneck"],
            trace_s=a["trace_s"])))
        before = DRYRUN_BEFORE_TP.get((arch, shape, plan))
        if before is not None:
            # every cell's entry point is tensor-parallel now
            now = a["flops_per_device"] / 1e12
            peak = a["peak_bytes_per_device"] / 1e9
            peak_before = DRYRUN_PEAK_BEFORE_TP.get((arch, shape, plan))
            log(f"dryrun:tp:{arch}:{shape}:{plan}", json.dumps(dict(
                tflop_per_device=now, before_tp_tflop=before,
                change=now / before - 1, peak_gb_per_device=peak,
                before_tp_peak_gb=peak_before, card=smi)))
            assert now < before, (arch, shape, plan, now, before)
            assert peak_before is None or peak < peak_before, (
                arch, shape, plan, peak, peak_before)
    profiles = {a["plan"]: StepProfile(
        name=f"{a['arch']}/{a['shape']}", flops=a["flops_per_device"],
        hbm_bytes=a["hbm_bytes_per_device"],
        coll_bytes=a["collective_bytes_per_device"], chips=a["chips"],
        model_flops=a["model_flops"])
        for a in arts if (a["arch"], a["shape"]) == ("qwen3-14b", "train_4k")}
    assert sorted(profiles) == ["base", "fused", "scale_out"], profiles
    d = AmoebaController(AmoebaConfig()).choose_plan(
        profiles, param_bytes_per_chip=1e8, steps_remaining=1e5)
    steps = {k: p.roofline()["step_s"] for k, p in profiles.items()}
    log("dryrun:plan:qwen3-14b:train_4k", json.dumps(dict(
        chosen=d.plan, reason=d.reason, step_s=steps,
        speedup=steps["base"] / steps[d.plan], child_wall_s=child_s[0],
        waited_s=waited, card=smi)))
    assert d.plan in profiles
    return d


# ---------------------------------------------------------------------------
# dist: the sharded paths, 4 ranks on the one card
# ---------------------------------------------------------------------------

DIST_MESH = (2, 2)                 # (data, model): 4 ranks, gloo, cuda:0
DIST_RANKS = DIST_MESH[0] * DIST_MESH[1]
DIST_MOE = (2, 4, 512)             # deepseek-moe-16b: layers, B, S
DIST_DECODE = (4, 8, 512, 2304, 8)  # qwen3-14b: layers, B, prompt, window,
#                                     decode steps
# the tensor-parallel serving legs: the decode leg's run on each (data,
# model) mesh, by leg name
DIST_TP = (("decode", (2, 2)), ("decode_fused", (1, 4)))
# every TP leaf's FLOPs on a rank: the whole batch's over data x model
TP_FLOPS_REL = 0.02
# the leaves the specs split over 'model' on 2 and 4 model ranks, by their
# path in layer 0 and the tables: qwen3-14b's (8 KV heads: wk / wv too),
# falcon-mamba's SSM mixer, recurrentgemma's RG-LRU mixer and whisper's
# cross-attention (8 KV heads).  whisper's ``embed/out`` stays whole: 2
# does not divide its 51,865 entries (``TP_WHOLE``)
TP_SPLIT = ("mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo", "ffn/wi_gate",
            "ffn/wi_up", "ffn/wo", "embed/table", "embed/out",
            "mixer/in_proj", "mixer/conv_w", "mixer/x_proj", "mixer/dt_proj",
            "mixer/dt_bias", "mixer/A_log", "mixer/D", "mixer/out_proj",
            "mixer/in_x", "mixer/in_gate", "mixer/wa", "mixer/wx",
            "mixer/ba", "mixer/lam", "mixer/out",
            "cross_attn/wq", "cross_attn/wk", "cross_attn/wv",
            "cross_attn/wo")
TP_WHOLE = {"whisper": ("embed/out",)}
# the tensor-parallel serving legs of the recurrent mixers and whisper's
# cross-attention, on DIST_MESH, each held to its unsharded run: arch,
# layers (None: all), B, prompt, window, decode steps, encoder frames
DIST_FAMILIES = {
    "ssm": ("falcon-mamba-7b", 4, 8, 512, 520, 8, 0),
    "rglru": ("recurrentgemma-9b", 3, 8, 512, 520, 8, 0),
    "whisper": ("whisper-base", None, 8, 64, 448, 8, 1500)}
# each leg's kernel launches a rank makes in its run (one prefill)
FAMILY_LAUNCHES = {"ssm": {"ssm_scan": 4, "flash_attention": 0},
                   "rglru": {"rglru_scan": 2, "flash_attention": 1},
                   "whisper": {"flash_attention": 12}}
# qwen3-14b: layers, B, S, steps (2, not 3: a step moves ~14 GB a rank
# through host memory, ~30 s on this layout)
DIST_TRAIN = (2, 4, 512, 2)
# the tensor-parallel train legs: the train leg's run on each (data, model)
# mesh, by leg name (the first is the restore leg's source)
DIST_TRAIN_TP = (("train", (2, 2)), ("train_fused", (1, 4)))
DIST_COMPRESS = (5120, 17408)      # one full-width qwen3-14b MLP gradient
# dist:train, losses on the mesh against Trainer() on one rank.  The first
# step's loss is a forward pass over the same bf16 weights, its rows split
# over two data ranks (other GEMM shapes, ~1e-3); the next follows an AdamW
# update whose gradients were summed across ranks in bf16 instead of
# accumulated in one backward.  0.02 (0.16 % of the ~12.3 loss) holds those,
# and the grad norm within 1 % catches a gradient summed once too often or
# too few times, which AdamW's scale invariance would hide in the losses.
DIST_TRAIN_TOL = 0.02
DIST_NORM_REL = 1e-2
# dist:moe, the per-expert load fractions (averaged over 2 layers) against
# moe_dense's: each is a count over 4 x 512 x 6 = 12,288 assignments, one
# flipped top-6 choice moves it by 8e-5; 1e-3 admits a dozen per expert
DIST_LOAD_TOL = 1e-3


def _parity_limit(ref) -> float:
    """The path-parity bound: the larger of 0.1 and 3e-2 of the largest
    reference magnitude (PERF.md §6)."""
    return max(PARITY_TOL, PARITY_REL * float(ref.abs().max()))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_cfgs():
    import dataclasses
    from repro_torch.configs import get_config
    L, _, _ = DIST_MOE
    moe = get_config("deepseek-moe-16b")           # full width, bf16
    moe = moe.replace(num_layers=L, moe=dataclasses.replace(
        moe.moe, capacity_factor=8.0))
    dec = get_config("qwen3-14b").replace(num_layers=DIST_DECODE[0])
    tr = get_config("qwen3-14b").replace(num_layers=DIST_TRAIN[0])
    return moe, dec, tr


def _family_cfg(leg):
    """A ``DIST_FAMILIES`` leg's config: full width, bf16, its depth cut."""
    from repro_torch.configs import get_config
    arch, layers = DIST_FAMILIES[leg][:2]
    cfg = get_config(arch)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def _family_batch(cfg, leg, seed=9):
    """A ``DIST_FAMILIES`` leg's prefill batch on the host: the prompts,
    and whisper's frame embeddings."""
    import torch
    _, _, B, S, _, _, frames = DIST_FAMILIES[leg]
    batch = {"tokens": _dist_tokens(cfg, B, S, seed)}
    if frames:
        g = torch.Generator().manual_seed(seed + 1)
        batch["audio_embeds"] = torch.randn(
            B, frames, cfg.d_model, generator=g).to(torch.bfloat16)
    return batch


def _dist_train_setup(cfg):
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    _, B, S, steps = DIST_TRAIN
    return (ShapeConfig("dist", S, B, "train"),
            TrainConfig(learning_rate=1e-4, warmup_steps=1,
                        total_steps=steps, remat="full",
                        grad_compression=True))


def _dist_tokens(cfg, B, S, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g)


def dist_references(d):
    """Each leg's unsharded path on this process's card, saved under ``d``
    for the ranks; every tensor freed before they start."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.train import Trainer

    moe_cfg, dec_cfg, tr_cfg = _dist_cfgs()
    ref = {}
    t0 = time.perf_counter()
    _, B, S = DIST_MOE
    params = T.init_model(moe_cfg, torch.Generator("cuda").manual_seed(SEED),
                          "cuda")
    with torch.no_grad():
        loss, met = T.loss_fn(
            params, {"tokens": _dist_tokens(moe_cfg, B, S, 7).cuda()},
            moe_cfg, T.Runtime(use_kernels=True, remat=False))
    ref["moe"] = dict(loss=float(loss), load=met["expert_load"].cpu(),
                      dropped=float(met["dropped_frac"]))
    del params
    L, B, S, W, steps = DIST_DECODE
    # the unsharded whole batch's count of the TP legs' counted call
    # (prefill + one decode step, plain path), on ``meta``
    ref["decode_count"] = _tp_count(
        T.init_model(dec_cfg, torch.Generator(), "meta"),
        torch.empty((B, S), dtype=torch.long, device="meta"), dec_cfg)
    params = T.init_model(dec_cfg, torch.Generator("cuda").manual_seed(SEED),
                          "cuda")
    prompts = _dist_tokens(dec_cfg, B, S, 8).cuda()
    for quant in (False, True):
        rt = T.Runtime(use_kernels=True, kv_quant=quant)
        with torch.no_grad():
            logits, st = T.prefill(params, {"tokens": prompts}, dec_cfg, rt,
                                   window=W)
            seen, fed = [logits.float().cpu()], []
            for _ in range(steps):
                tok = logits.argmax(-1, keepdim=True)
                fed.append(tok.cpu())
                logits, st = T.decode_step(params, st, tok, dec_cfg, rt)
                seen.append(logits.float().cpu())
        ref[f"decode_q{int(quant)}"] = dict(logits=seen, tokens=fed)
        del st, logits
    del params
    for leg in DIST_FAMILIES:
        cfg = _family_cfg(leg)
        W, steps = DIST_FAMILIES[leg][4:6]
        batch = _family_batch(cfg, leg)
        ref[leg + "_count"] = _tp_count(
            T.init_model(cfg, torch.Generator(), "meta"),
            {k: torch.empty_like(v, device="meta") for k, v in batch.items()},
            cfg, W)
        params = T.init_model(cfg, torch.Generator("cuda").manual_seed(SEED),
                              "cuda")
        rt = T.Runtime(use_kernels=True)
        with torch.no_grad():
            logits, st = T.prefill(params, {k: v.cuda() for k, v in
                                            batch.items()}, cfg, rt, window=W)
            seen, fed = [logits.float().cpu()], []
            for _ in range(steps):
                tok = logits.argmax(-1, keepdim=True)
                fed.append(tok.cpu())
                logits, st = T.decode_step(params, st, tok, cfg, rt)
                seen.append(logits.float().cpu())
        ref[leg] = dict(logits=seen, tokens=fed)
        del params, st, logits
    shape, tcfg = _dist_train_setup(tr_cfg)
    # the unsharded whole batch's count of one step, on ``meta``
    sc, _ = predict_train_step(tr_cfg, shape, tcfg)
    ref["train_count"] = dict(flops=sc.flops, by_op=dict(sc.flops_by_op))
    hist = Trainer(tr_cfg, shape, tcfg, device="cuda").train(
        DIST_TRAIN[3])["history"]
    ref["train"] = [(m.loss, m.grad_norm) for m in hist]
    ref["ref_s"] = time.perf_counter() - t0
    torch.save(ref, d / "ref.pt")
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def _tp_count(params, batch, cfg, window=DIST_DECODE[3]) -> dict:
    """``core.step_count`` of one prefill and one decode step of a TP
    leg's configuration on the plain path (chunked attention and the scans
    are torch ops; the kernels are no aten ops and would not count), under
    the current mesh, if any: matmul FLOPs, collective bytes by kind, FLOPs
    by aten op.  ``batch``: the prompts, or the prefill's batch dict."""
    import torch
    from repro_torch.core.step_count import StepCounter
    from repro_torch.models import transformer as T
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    rt = T.Runtime(use_kernels=False)
    with torch.no_grad(), StepCounter((params, batch)) as sc:
        logits, st = T.prefill(params, batch, cfg, rt, window=window)
        T.decode_step(params, st, logits.argmax(-1, keepdim=True), cfg, rt)
    return dict(flops=sc.flops, coll=dict(sc.coll_breakdown),
                by_op=dict(sc.flops_by_op))


def _tp_weights(params, cfg, mesh) -> dict:
    """Each TP leaf's bytes as layer 0's tensor-parallel serving path takes
    them on this rank (``_tp_block_params``, ``_table_shard``), beside the
    whole leaf's: {path: [mine, whole]}.  Layer 0's mixer, and each other
    sublayer on shards, must be on shards."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import shardctx
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    with shardctx.use_mesh(mesh):
        blk = T._index(params["reps"][0], 0)
        w, tp = T._tp_block_params(blk, cfg, T._pattern(cfg)[0])
        want = {"mixer": True, "ffn": "ffn" in blk,
                "cross": "cross_attn" in blk}
        assert tp == want, (tp, want)
        out = {f"{sub}/{k}": [nbytes(v), nbytes(blk[sub][k])]
               for sub, key in (("mixer", "mixer"), ("ffn", "ffn"),
                                ("cross_attn", "cross")) if tp[key]
               for k, v in w[sub].items()}
        for k in params["embed"]:
            out["embed/" + k] = [nbytes(T._table_shard(params, cfg, k)[0]),
                                 nbytes(params["embed"][k])]
    return out


def _model_only(specs):
    """The specs with 'data' dropped: weights split over 'model' as the
    reference's specs split them, each data rank a whole replica."""
    from repro_torch import pytree
    from repro_torch.parallel.shardctx import P
    return pytree.map_(lambda s: P(*(None if e == "data" else e
                                     for e in s)), specs)


def _share(tree) -> int:
    """Bytes of a tree's local tensors on this rank."""
    from repro_torch import pytree
    from repro_torch.parallel import shardctx
    return sum(shardctx.local(t).numel() * shardctx.local(t).element_size()
               for t in pytree.leaves(tree))


def _leg(name, fn, res):
    """Run one leg: its launches (zeroed just before, read just after), its
    wall seconds (gloo-through-host), this rank's device bytes and its
    process's peak host memory so far."""
    import resource
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                           # zero just before the leg
    t0 = time.perf_counter()
    rec = fn()
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = dict(ops.launches)           # read just after
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["host_peak_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6          # kB on Linux
    res[name] = rec
    gc.collect()
    torch.cuda.empty_cache()


def dist_rank(rank, port, d, q):
    """One rank of the dist phase: joins the gloo group from torchrun's
    environment, builds the (data 2, model 2) mesh and runs every leg."""
    import traceback
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DIST_RANKS),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    res = {"rank": rank}
    try:
        _dist_rank(Path(d), res)
    except BaseException:
        res["error"] = traceback.format_exc()
    q.put(res)


def _dist_rank(d, res):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import pytree
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.fusion import MeshPlan, plan_family
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import transformer as T
    from torch.distributed.tensor import Shard
    from repro_torch.optim.adamw import BLOCK
    from repro_torch.parallel import compression as C
    from repro_torch.parallel import resolve, shardctx
    from repro_torch.train import Trainer

    # 4 ranks on one card: NCCL refuses two ranks on one device, so gloo
    res["backend"] = meshlib.init_distributed()
    assert res["backend"] == "gloo", res["backend"]
    base = MeshPlan("base", *DIST_MESH)
    mesh = base.build("cuda")
    res["data"], res["model"] = (mesh.get_local_rank("data"),
                                 mesh.get_local_rank("model"))
    ref = torch.load(d / "ref.pt")
    moe_cfg, dec_cfg, tr_cfg = _dist_cfgs()
    gen = lambda: torch.Generator("cuda").manual_seed(SEED)  # noqa: E731

    def moe_leg():
        _, B, S = DIST_MOE
        whole = T.init_model(moe_cfg, gen(), "cuda")
        params = shardctx.layout_tree(whole, T.model_pspecs(moe_cfg)[1],
                                      mesh)
        whole_b = _share(whole)
        del whole
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        share = _share(params)
        tokens = shardctx.batch_shard(_dist_tokens(moe_cfg, B, S, 7),
                                      mesh).cuda()
        with torch.no_grad(), shardctx.use_mesh(mesh):
            loss, met = T.loss_fn(params, {"tokens": tokens}, moe_cfg,
                                  T.Runtime(use_kernels=True,
                                            production=True, remat=False))
        r = ref["moe"]
        return dict(loss=float(loss), ref_loss=r["loss"],
                    diff=abs(float(loss) - r["loss"]),
                    limit=max(PARITY_TOL, PARITY_REL * abs(r["loss"])),
                    dropped=float(met["dropped_frac"]),
                    load_diff=float((met["expert_load"].cpu()
                                     - r["load"]).abs().max()),
                    resident_bytes=resident, share_bytes=share,
                    whole_bytes=whole_b)

    def decode_leg(shape):
        """The tensor-parallel serving path on a (data, model) mesh: the
        weights laid out over 'model' by their specs (each data rank a
        replica: an FSDP gather over 'data' would move every layer through
        gloo's host staging each call), prefill and greedy decode held to
        the unsharded run, then one prefill and decode step counted."""
        L, B, S, W, steps = DIST_DECODE
        m = (mesh if shape == DIST_MESH else
             MeshPlan("tp", data=shape[0], model=shape[1]).build("cuda"))
        n = shape[1]
        d = m.get_local_rank("data")
        shapes, specs = T.model_pspecs(dec_cfg)
        specs = _model_only(specs)
        flat = pytree.flatten_with_paths(specs)
        with shardctx.use_mesh(m):
            spec_share = sum(
                _share(v) // (1 if shardctx.model_dim(v, flat[k]) is None
                              else n)
                for k, v in pytree.flatten_with_paths(shapes).items())
        whole = T.init_model(dec_cfg, gen(), "cuda")
        params = shardctx.layout_tree(whole, specs, m)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        rows = slice(d * B // shape[0], (d + 1) * B // shape[0])
        prompts = shardctx.batch_shard(_dist_tokens(dec_cfg, B, S, 8),
                                       m).cuda()
        out = dict(mesh=list(shape))
        t0 = time.perf_counter()
        for quant in (False, True):
            r = ref[f"decode_q{int(quant)}"]
            rt = T.Runtime(use_kernels=True, kv_quant=quant)
            diffs, limits = [], []
            with torch.no_grad(), shardctx.use_mesh(m):
                logits, st = T.prefill(params, {"tokens": prompts}, dec_cfg,
                                       rt, window=W)
                k0 = st.reps[0]["self"].k
                ring = (k0.shape[2], shardctx.local(k0).shape[2])
                cache_b = _share(st.reps)
                for i in range(steps + 1):
                    want = r["logits"][i][rows]
                    diffs.append(float((logits.float().cpu() - want)
                                       .abs().max()))
                    limits.append(_parity_limit(want))
                    if i < steps:
                        logits, st = T.decode_step(
                            params, st, r["tokens"][i][rows].cuda(),
                            dec_cfg, rt)
            del st
            out[f"q{int(quant)}"] = dict(diff=diffs, limit=limits,
                                         ring_slots=ring, cache_bytes=cache_b)
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        with shardctx.use_mesh(m):
            out["count"] = _tp_count(params, prompts, dec_cfg)
        out["weights"] = _tp_weights(params, dec_cfg, m)
        out["resident_bytes"] = resident
        out["share_bytes"] = _share(params)
        out["spec_share_bytes"] = spec_share
        return out

    def family_leg(leg):
        """The SSM / RG-LRU mixers' or whisper's cross-attention's
        tensor-parallel serving path on DIST_MESH, weights over 'model'
        only as the decode legs' (each data rank a replica), held to the
        unsharded run; then one prefill and decode step counted.  The
        scans' channel counts are read off their wrappers' inputs."""
        from repro_torch.kernels import ops
        _, _, B, S, W, steps, _ = DIST_FAMILIES[leg]
        cfg = _family_cfg(leg)
        whole = T.init_model(cfg, gen(), "cuda")
        params = shardctx.layout_tree(
            whole, _model_only(T.model_pspecs(cfg)[1]), mesh)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        batch = {k: shardctx.batch_shard(v, mesh).cuda()
                 for k, v in _family_batch(cfg, leg).items()}
        d = res["data"]
        rows = slice(d * B // DIST_MESH[0], (d + 1) * B // DIST_MESH[0])
        r = ref[leg]
        channels = []

        def on_channels(fn):
            def wrapped(*a):
                channels.append(a[0].shape[-1])    # dt or a: (B, S, C)
                return fn(*a)
            return wrapped

        rt = T.Runtime(use_kernels=True)
        diffs, limits = [], []
        t0 = time.perf_counter()
        with torch.no_grad(), shardctx.use_mesh(mesh), \
                patched(ops, "selective_scan",
                        on_channels(ops.selective_scan)), \
                patched(ops, "rglru_scan", on_channels(ops.rglru_scan)):
            logits, st = T.prefill(params, batch, cfg, rt, window=W)
            # each state leaf: its global and local shapes and the
            # dimension (from the end) split over 'model'
            state = {}
            for i, part in enumerate(st.reps):
                for key, nt in part.items():
                    for f in nt._fields:
                        t = getattr(nt, f)
                        if t is None:
                            continue
                        split = [p.dim - t.dim() for p in getattr(
                            t, "placements", ()) if hasattr(p, "dim")]
                        state[f"{i}/{key}/{f}"] = [
                            list(t.shape), list(shardctx.local(t).shape),
                            split[0] if split else None]
            for i in range(steps + 1):
                want = r["logits"][i][rows]
                diffs.append(float((logits.float().cpu() - want)
                                   .abs().max()))
                limits.append(_parity_limit(want))
                if i < steps:
                    logits, st = T.decode_step(
                        params, st, r["tokens"][i][rows].cuda(), cfg, rt)
        del st
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        with shardctx.use_mesh(mesh):
            count = _tp_count(params, batch, cfg, W)
        return dict(diff=diffs, limit=limits, channels=channels,
                    state=state, count=count, run_s=run_s,
                    weights=_tp_weights(params, cfg, mesh))

    def train_leg(shape):
        """The tensor-parallel trainer on a (data, model) mesh (weights and
        state laid out by their specs, FSDP over 'data'), held to the
        one-rank ``Trainer``; its first step counted on every rank."""
        m = (mesh if shape == DIST_MESH else
             MeshPlan("tp", data=shape[0], model=shape[1]).build("cuda"))
        tshape, tcfg = _dist_train_setup(tr_cfg)
        tr = Trainer(tr_cfg, tshape, tcfg, mesh=m, device="cuda")
        state = tr.init_state(SEED)
        # the round trip's kernel launches: one per BLOCK of each leaf's
        # block (row-aligned: the leaf over the axes that split its first
        # sharded dimension; else the whole leaf)
        pieces = 0
        for p in pytree.leaves(state.params):
            dims = sorted(q.dim for q in p.placements
                          if isinstance(q, Shard))
            n = p.numel()
            if dims and C._row_aligned(tuple(p.shape), tuple(p.placements),
                                       m, dims[0]):
                n = shardctx.local(p).shape[dims[0]] * n // p.shape[dims[0]]
            pieces += -(-n // BLOCK)
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        share = _share(state)
        # the parameters' share by their resolved specs, from the shapes
        shapes, specs = T.model_pspecs(tr_cfg)
        flat = pytree.flatten_with_paths(specs)
        spec_share = 0
        for k, v in pytree.flatten_with_paths(shapes).items():
            rs = resolve.resolve_spec_for(tuple(v.shape), flat[k], m)
            split = math.prod(shardctx.axis_size(a, m) for e in rs
                              for a in ((e,) if isinstance(e, str) else
                                        (e or ())))
            spec_share += v.numel() * v.element_size() // split
        counted = count_first_step(tr)
        out = tr.train(DIST_TRAIN[3], state=state)
        sc = counted["sc"]
        hist = out["history"]
        got = [(x.loss, x.grad_norm) for x in hist]
        if shape == DIST_MESH:
            res["_params"] = out["state"].params     # for the restore leg
        params = out["state"].params
        out = state = None
        return dict(mesh=list(shape),
                    count=dict(flops=sc.flops, coll=dict(sc.coll_breakdown),
                               by_op=dict(sc.flops_by_op)),
                    weights=_tp_weights(params, tr_cfg, m),
                    param_bytes=_share(params), spec_share_bytes=spec_share,
                    loss=[g[0] for g in got], ref_loss=[w[0] for w in
                                                        ref["train"]],
                    grad_norm=[g[1] for g in got],
                    ref_grad_norm=[w[1] for w in ref["train"]],
                    diff=max(abs(g[0] - w[0]) for g, w in
                             zip(got, ref["train"])),
                    norm_rel=max(abs(g[1] - w[1]) / w[1] for g, w in
                                 zip(got, ref["train"])),
                    limit=DIST_TRAIN_TOL, norm_limit=DIST_NORM_REL,
                    step_s=[x.dt for x in hist],
                    quantize_expected=pieces * DIST_TRAIN[3],
                    resident_bytes=resident, share_bytes=share)

    def compress_leg():
        R, Cn = DIST_COMPRESS
        leaves = []
        for i in range(DIST_MESH[0]):
            g = torch.Generator("cuda").manual_seed(100 + i)
            leaves.append(torch.randn((R, Cn), generator=g, device="cuda"))
        true = sum(leaves) / len(leaves)
        bound = float(max(x.abs().max() for x in leaves)) / 127.0 * 1.5
        mine = leaves[res["data"]]
        del leaves
        with shardctx.use_mesh(mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, resid = C.compressed_psum_mean({"g": mine}, "data")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        err = float((mean["g"] - true).abs().max())
        return dict(diff=err, limit=bound, call_s=dt,
                    resid_max=float(resid["g"].abs().max()))

    def restore_leg():
        import numpy as np
        from repro_torch.ckpt.manager import _from_host
        # the two full-width layers' stack (12 leaves, 1.3 GB): the layouts
        # the (1, 4) and (4, 1) plans change, without the 3.1 GB of
        # embedding tables whose save through host memory takes ~20 s here
        params = {"reps": res.pop("_params")["reps"]}
        t0 = time.perf_counter()
        ck = CheckpointManager(str(d / "ckpt"))
        ck.save(DIST_TRAIN[3], params, blocking=True)
        ck.wait()
        out = dict(save_s=time.perf_counter() - t0)
        meta, specs = ({"reps": t["reps"]} for t in T.model_pspecs(tr_cfg))
        trees = {"base": (params, mesh)}
        for name in ("fused", "scale_out"):
            m2 = plan_family(base)[name].build("cuda")
            t0 = time.perf_counter()
            trees[name] = (ck.restore(like=meta, pspecs=specs, mesh=m2,
                                      device="cuda")[1], m2)
            out[name] = dict(mesh=list(m2.shape),
                             restore_s=time.perf_counter() - t0,
                             share_bytes=_share(trees[name][0]))
        # each rank's every shard, on the three plans, against the array
        # written, one leaf in host memory at a time
        written = d / "ckpt" / f"step_{DIST_TRAIN[3]}"
        names = json.loads((written / "manifest.json").read_text())["dtypes"]
        flat = {n: pytree.flatten_with_paths(t) for n, (t, _) in
                trees.items()}
        equal = dict.fromkeys(trees, 0)
        with np.load(written / "arrays.npz") as z:
            for k in flat["base"]:
                host = _from_host(z[k], names.get(k))
                for n, (_, m) in trees.items():
                    v = flat[n][k]
                    equal[n] += bool(torch.equal(
                        shardctx.local(v).cpu(),
                        shardctx.shard_of(host, m, v.placements)))
        out["leaves"] = len(flat["base"])
        out["source_equal"] = equal.pop("base")
        for n, e in equal.items():
            out[n].update(equal=e, leaves=out["leaves"])
        return out

    legs = [("moe", moe_leg)]
    legs += [(name, lambda shape=shape: decode_leg(shape))
             for name, shape in DIST_TP]
    legs += [(leg, lambda leg=leg: family_leg(leg)) for leg in DIST_FAMILIES]
    legs += [(name, lambda shape=shape: train_leg(shape))
             for name, shape in DIST_TRAIN_TP]
    legs += [("compress", compress_leg), ("restore", restore_leg)]
    for name, fn in legs:
        _leg(name, fn, res)
    dist.barrier()
    dist.destroy_process_group()


def dist_phase(smi):
    """The sharded paths (``repro_torch.parallel``): 4 ranks on the one
    card, joined by gloo (NCCL refuses two ranks on one device), mesh (data
    2, model 2), started with ``torch.multiprocessing`` in the spawn mode.
    Each leg is held to the unsharded path on the same card, computed
    first in this process and freed before the ranks start."""
    import shutil
    import torch.multiprocessing as mp
    d = ROOT / "build" / "dist"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    ref = dist_references(d)
    whole = ref["decode_count"]     # the TP legs' unsharded count
    whole_train = ref["train_count"]
    whole_family = {leg: ref[leg + "_count"] for leg in DIST_FAMILIES}
    del ref
    released(0)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=dist_rank, args=(r, port, str(d), q))
             for r in range(DIST_RANKS)]
    for p in procs:
        p.start()
    outs = []
    try:
        for _ in procs:
            outs.append(q.get(timeout=900))
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    errors = [o for o in outs if "error" in o]
    assert not errors, "\n".join(o["error"] for o in errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    outs.sort(key=lambda o: o["rank"])
    by_path, recs = {}, {}
    tp_legs = [name for name, _ in DIST_TP]
    train_legs = [name for name, _ in DIST_TRAIN_TP]
    for leg in (["moe"] + tp_legs + list(DIST_FAMILIES) + train_legs
                + ["compress", "restore"]):
        per = [o[leg] for o in outs]
        by_path[f"dist:{leg}"] = {k: sum(p["launches"][k] for p in per)
                                  for k in per[0]["launches"]}
        recs[leg] = per
    moe, cmp_, rst = (recs[k] for k in ("moe", "compress", "restore"))
    tr = [p for k in train_legs for p in recs[k]]
    for p in moe:
        assert p["diff"] <= p["limit"], p
        assert p["dropped"] == 0.0 and p["load_diff"] <= DIST_LOAD_TOL, p
    tp_lines = {}
    for (leg, shape), dec in zip(DIST_TP, (recs[k] for k in tp_legs)):
        n = shape[1]
        for p in dec:
            for q_ in ("q0", "q1"):
                assert all(a <= b for a, b in zip(p[q_]["diff"],
                                                   p[q_]["limit"])), p
                assert p[q_]["ring_slots"] == (DIST_DECODE[3],
                                               DIST_DECODE[3] // n), p
            # each rank computes a quarter of the whole batch's matmuls:
            # its rows (1 / data) of its heads, columns and vocabulary
            # (1 / model)
            ratio = p["count"]["flops"] / whole["flops"]
            assert abs(ratio * DIST_RANKS - 1) <= TP_FLOPS_REL, (leg, ratio)
            for k, (mine, full) in p["weights"].items():
                assert mine * (n if k in TP_SPLIT else 1) == full, (leg, k)
            assert p["share_bytes"] == p["spec_share_bytes"], p
        tp_lines[leg] = dict(
            mesh=list(shape), rank_flops=[p["count"]["flops"] for p in dec],
            whole_batch_flops=whole["flops"],
            ratio=[p["count"]["flops"] / whole["flops"] for p in dec],
            rank_flops_by_op=dec[0]["count"]["by_op"],
            whole_flops_by_op=whole["by_op"],
            coll_bytes=[p["count"]["coll"] for p in dec],
            gathered_bytes=[sum(m for m, _ in p["weights"].values())
                            for p in dec],
            gathered_whole_bytes=sum(f for _, f in
                                     dec[0]["weights"].values()),
            gathered_by_leaf=dec[0]["weights"],
            resident_bytes=[p["resident_bytes"] for p in dec],
            share_bytes=[p["share_bytes"] for p in dec],
            spec_share_bytes=[p["spec_share_bytes"] for p in dec],
            max_diff={q_: max(max(p[q_]["diff"]) for p in dec)
                      for q_ in ("q0", "q1")},
            min_limit={q_: min(min(p[q_]["limit"]) for p in dec)
                       for q_ in ("q0", "q1")},
            run_s=[p["run_s"] for p in dec], card=smi)
        log(f"dist:{leg}:tp", json.dumps(tp_lines[leg]))
    from repro_torch.models.attention import attention_pspecs
    for leg, per in ((k, recs[k]) for k in DIST_FAMILIES):
        cfg = _family_cfg(leg)
        B, S = DIST_FAMILIES[leg][2:4]
        n = DIST_MESH[1]
        counted = whole_family[leg]
        # each rank computes a quarter of the whole batch's matmuls: its
        # rows (1 / data) of its channels, heads and vocabulary (1 /
        # model).  Two terms only on its rows (1 / data): whisper's LM head
        # (a prefill's last position and a decode step), 2 not dividing
        # its 51,865 columns, and the prefill's two k / v projections
        # (the attention's and the ring's) where the specs replicate wk /
        # wv (recurrentgemma's one KV head)
        head = (2 * 2.0 * B * cfg.d_model * cfg.vocab_size
                if leg == "whisper" else 0.0)
        kv = 0.0
        if "model" not in tuple(attention_pspecs(cfg)["wk"]):
            kv = (sum(k == "attn" for k in cfg.layer_kinds) * 2 * 2 * 2.0
                  * B * S * cfg.d_model * cfg.num_kv_heads
                  * cfg.resolved_head_dim)
        share = ((counted["flops"] - head - kv) / DIST_RANKS
                 + (head + kv) / DIST_MESH[0])
        split = set(TP_SPLIT) - set(TP_WHOLE.get(leg, ()))
        scans = {k: v for k, v in FAMILY_LAUNCHES[leg].items()
                 if k != "flash_attention"}
        width = {"ssm": lambda c: c.ssm.expand * c.d_model,
                 "rglru": lambda c: c.rglru.lru_width}.get(leg)
        for p in per:
            assert all(a <= b for a, b in zip(p["diff"], p["limit"])), \
                (leg, p["diff"], p["limit"])
            assert abs(p["count"]["flops"] / share - 1) <= TP_FLOPS_REL, \
                (leg, p["count"]["flops"], share)
            for k, (mine, full) in p["weights"].items():
                assert mine * (n if k in split else 1) == full, (leg, k)
            # the scan kernels ran on the rank's channels, once a
            # recurrent layer a prefill
            assert len(p["channels"]) == sum(scans.values()), p["channels"]
            assert all(c * n == width(cfg) for c in p["channels"]), (
                leg, p["channels"])
            # every state leaf the spec's shard: recurrent states by
            # channel, rings and cross caches by position
            for path, (glob, loc, dim) in p["state"].items():
                assert dim is not None and loc[dim] * n == glob[dim], (
                    leg, path, glob, loc, dim)
        tp_lines[leg] = dict(
            arch=cfg.name, layers=cfg.num_layers, mesh=list(DIST_MESH),
            batch=B, prompt=DIST_FAMILIES[leg][3],
            window=DIST_FAMILIES[leg][4], steps=DIST_FAMILIES[leg][5],
            frames=DIST_FAMILIES[leg][6],
            rank_flops=[p["count"]["flops"] for p in per],
            whole_batch_flops=counted["flops"], head_flops=head,
            replicated_kv_flops=kv, share_flops=share,
            ratio=[p["count"]["flops"] / counted["flops"] for p in per],
            rank_flops_by_op=per[0]["count"]["by_op"],
            whole_flops_by_op=counted["by_op"],
            coll_bytes=[p["count"]["coll"] for p in per],
            scan_channels=[p["channels"] for p in per],
            state_shapes=per[0]["state"],
            gathered_bytes=[sum(m for m, _ in p["weights"].values())
                            for p in per],
            gathered_whole_bytes=sum(f for _, f in
                                     per[0]["weights"].values()),
            gathered_by_leaf=per[0]["weights"],
            max_diff=max(max(p["diff"]) for p in per),
            min_limit=min(min(p["limit"]) for p in per),
            run_s=[p["run_s"] for p in per],
            wall_s=[p["wall_s"] for p in per],
            peak_gb=[p["peak_gb"] for p in per], card=smi)
        log(f"dist:{leg}:tp", json.dumps(tp_lines[leg]))
    for (leg, shape), per in zip(DIST_TRAIN_TP,
                                 (recs[k] for k in train_legs)):
        n = shape[1]
        for p in per:
            assert p["diff"] <= p["limit"], (leg, p["loss"], p["ref_loss"])
            assert p["norm_rel"] <= p["norm_limit"], (
                leg, p["grad_norm"], p["ref_grad_norm"])
            # each rank computes a quarter of the whole batch's step: its
            # rows (1 / data) of its heads, columns and vocabulary (1 /
            # model), forward, recomputation and backward
            ratio = p["count"]["flops"] / whole_train["flops"]
            assert abs(ratio * DIST_RANKS - 1) <= TP_FLOPS_REL, (leg, ratio)
            for k, (mine, full) in p["weights"].items():
                assert mine * (n if k in TP_SPLIT else 1) == full, (leg, k)
            assert p["param_bytes"] == p["spec_share_bytes"], (leg, p)
        tp_lines[leg] = dict(
            mesh=list(shape), rank_flops=[p["count"]["flops"] for p in per],
            whole_batch_flops=whole_train["flops"],
            ratio=[p["count"]["flops"] / whole_train["flops"] for p in per],
            rank_flops_by_op=per[0]["count"]["by_op"],
            whole_flops_by_op=whole_train["by_op"],
            coll_bytes=[p["count"]["coll"] for p in per],
            gathered_bytes=[sum(m for m, _ in p["weights"].values())
                            for p in per],
            gathered_whole_bytes=sum(f for _, f in
                                     per[0]["weights"].values()),
            gathered_by_leaf=per[0]["weights"],
            param_bytes=[p["param_bytes"] for p in per],
            spec_share_bytes=[p["spec_share_bytes"] for p in per],
            resident_bytes=[p["resident_bytes"] for p in per],
            state_bytes=[p["share_bytes"] for p in per],
            loss=per[0]["loss"], ref_loss=per[0]["ref_loss"],
            grad_norm=per[0]["grad_norm"],
            ref_grad_norm=per[0]["ref_grad_norm"],
            max_diff=max(p["diff"] for p in per),
            max_norm_rel=max(p["norm_rel"] for p in per),
            step_s=[p["step_s"] for p in per],
            wall_s=[p["wall_s"] for p in per],
            peak_gb=[p["peak_gb"] for p in per], card=smi)
        log(f"dist:{leg}:tp", json.dumps(tp_lines[leg]))
    for p in cmp_:
        assert p["diff"] <= p["limit"], p
    for p in rst:
        assert p["source_equal"] == p["leaves"] > 0, p
        for name in ("fused", "scale_out"):
            assert p[name]["equal"] == p[name]["leaves"] == p["leaves"], p
    L = DIST_DECODE[0]
    # every kernel of each leg's path launched, on every rank
    dec = [p for k in tp_legs for p in recs[k]]
    assert all(p["launches"]["flash_attention"] == DIST_MOE[0] for p in moe)
    assert all(p["launches"]["rmsnorm"] > 0 for p in moe + dec)
    assert all(p["launches"]["quantize_int8"] == L * (1 + DIST_DECODE[4])
               for p in dec), [p["launches"] for p in dec]
    assert all(p["launches"]["flash_attention"] == 2 * L for p in dec)
    for leg, want in FAMILY_LAUNCHES.items():
        for p in recs[leg]:
            assert all(p["launches"][k] == v for k, v in want.items()), (
                leg, p["launches"])
            assert p["launches"]["rmsnorm"] > 0, (leg, p["launches"])
    assert all(p["launches"]["quantize_int8"] == p["quantize_expected"]
               for p in tr), [(p["launches"], p["quantize_expected"])
                              for p in tr]
    summary = dict(
        ranks=DIST_RANKS, mesh=dict(data=DIST_MESH[0], model=DIST_MESH[1]),
        backend="gloo on one card (collectives through host memory)",
        phase_wall_s=wall, card=smi,
        moe=dict(arch="deepseek-moe-16b", layers=DIST_MOE[0],
                 batch=DIST_MOE[1], seq=DIST_MOE[2], capacity_factor=8.0,
                 loss=[p["loss"] for p in moe], ref_loss=moe[0]["ref_loss"],
                 max_diff=max(p["diff"] for p in moe), limit=moe[0]["limit"],
                 dropped=[p["dropped"] for p in moe],
                 max_load_diff=max(p["load_diff"] for p in moe),
                 resident_bytes=[p["resident_bytes"] for p in moe],
                 share_bytes=[p["share_bytes"] for p in moe],
                 whole_bytes=moe[0]["whole_bytes"],
                 wall_s=[p["wall_s"] for p in moe],
                 peak_gb=[p["peak_gb"] for p in moe]),
        decode_run=dict(arch="qwen3-14b", layers=L, batch=DIST_DECODE[1],
                        prompt=DIST_DECODE[2], window=DIST_DECODE[3],
                        steps=DIST_DECODE[4]),
        **{leg: dict(
            mesh=list(shape),
            **{q_: dict(max_diff=max(max(p[q_]["diff"]) for p in recs[leg]),
                        min_limit=min(min(p[q_]["limit"])
                                      for p in recs[leg]),
                        ring_slots=recs[leg][0][q_]["ring_slots"],
                        cache_bytes=[p[q_]["cache_bytes"]
                                     for p in recs[leg]])
               for q_ in ("q0", "q1")},
            wall_s=[p["wall_s"] for p in recs[leg]],
            peak_gb=[p["peak_gb"] for p in recs[leg]])
           for leg, shape in DIST_TP},
        tensor_parallel=tp_lines,
        train_run=dict(arch="qwen3-14b", layers=DIST_TRAIN[0],
                       batch=DIST_TRAIN[1], seq=DIST_TRAIN[2],
                       steps=DIST_TRAIN[3], limit=DIST_TRAIN_TOL,
                       norm_limit=DIST_NORM_REL),
        compress=dict(leaf=list(DIST_COMPRESS),
                      max_diff=max(p["diff"] for p in cmp_),
                      limit=cmp_[0]["limit"],
                      call_s=[p["call_s"] for p in cmp_],
                      wall_s=[p["wall_s"] for p in cmp_]),
        restore=dict(leaves=rst[0]["leaves"],
                     source_equal=[p["source_equal"] for p in rst],
                     save_s=[p["save_s"] for p in rst],
                     **{k: [p[k] for p in rst] for k in ("fused",
                                                         "scale_out")}),
        restore_wall_s=[p["wall_s"] for p in rst],
        host_peak_gb={leg: [p["host_peak_gb"] for p in per]
                      for leg, per in recs.items()},
        launches=by_path)
    log("dist", json.dumps(summary))
    return by_path


# ---------------------------------------------------------------------------
# dist:uneven: attention on 'model' shards where the model axis divides
# neither the heads nor the split KV heads, 8 ranks on the one card
# ---------------------------------------------------------------------------

UNEVEN_MESH = (1, 8)               # (data, model): 8 ranks, gloo, cuda:0
UNEVEN_RANKS = UNEVEN_MESH[0] * UNEVEN_MESH[1]
# qwen2-vl-7b at full width (28 heads, 4 KV heads, hd 128, d_model 3584),
# text-only prompts: layers, B, prompt, window, decode steps
UNEVEN = (2, 8, 512, 520, 8)
# the train step's runtime: the trainer's plain path, remat, one loss chunk
UNEVEN_TRAIN_RT = dict(use_kernels=False, remat=True, loss_chunk=512)


def _uneven_cfg():
    from repro_torch.configs import get_config
    return get_config("qwen2-vl-7b").replace(num_layers=UNEVEN[0])


def _uneven_heads(rank: int):
    """Rank ``rank``'s q heads (``attention.head_range``'s ceil(H / n)
    chunk) and its flash launches a layer (``attention.head_runs``)."""
    from repro_torch.models.attention import head_runs
    cfg = _uneven_cfg()
    H, G = cfg.num_heads, cfg.num_heads // cfg.num_kv_heads
    c = -(-H // UNEVEN_MESH[1])
    heads = list(range(min(H, rank * c), min(H, (rank + 1) * c)))
    return heads, len(head_runs(rank * c, len(heads), G))


def uneven_references(d):
    """The leg's unsharded path on this process's card, saved under ``d``
    for the ranks: its count on ``meta``, prefill and greedy decode with
    the kernels, and the train step's loss and gradient norm."""
    import torch
    from repro_torch.models import transformer as T
    cfg = _uneven_cfg()
    L, B, S, W, steps = UNEVEN
    t0 = time.perf_counter()
    ref = {"count": _tp_count(T.init_model(cfg, torch.Generator(), "meta"),
                              torch.empty((B, S), dtype=torch.long,
                                          device="meta"), cfg, W)}
    params = T.init_model(cfg, torch.Generator("cuda").manual_seed(SEED),
                          "cuda")
    prompts = _dist_tokens(cfg, B, S, 11).cuda()
    rt = T.Runtime(use_kernels=True)
    with torch.no_grad():
        logits, st = T.prefill(params, {"tokens": prompts}, cfg, rt,
                               window=W)
        seen, fed = [logits.float().cpu()], []
        for _ in range(steps):
            tok = logits.argmax(-1, keepdim=True)
            fed.append(tok.cpu())
            logits, st = T.decode_step(params, st, tok, cfg, rt)
            seen.append(logits.float().cpu())
    ref.update(logits=seen, tokens=fed)
    del st, logits
    leaves = [p.requires_grad_(True) for p in _tensors(params)]
    loss, _ = T.loss_fn(params, {"tokens": _dist_tokens(cfg, B, S, 12)
                                 .cuda()}, cfg,
                        T.Runtime(**UNEVEN_TRAIN_RT))
    grads = torch.autograd.grad(loss, leaves)
    ref["loss"] = float(loss.detach())
    ref["grad_norm"] = float(torch.sqrt(sum((g.float() ** 2).sum()
                                            for g in grads)))
    ref["ref_s"] = time.perf_counter() - t0
    del params, leaves, grads, loss
    torch.save(ref, d / "ref.pt")
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def uneven_rank(rank, port, d, q):
    """One rank of ``dist:uneven``: joins the gloo group of 8 and runs the
    leg on the (1, 8) mesh."""
    import traceback
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(UNEVEN_RANKS),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    res = {"rank": rank}
    try:
        _uneven_rank(Path(d), res)
    except BaseException:
        res["error"] = traceback.format_exc()
    q.put(res)


def _uneven_rank(d, res):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core.fusion import MeshPlan
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import transformer as T
    from repro_torch.parallel import collectives, shardctx
    from repro_torch.train import Trainer

    res["backend"] = meshlib.init_distributed()
    assert res["backend"] == "gloo", res["backend"]
    m = MeshPlan("tp", data=UNEVEN_MESH[0], model=UNEVEN_MESH[1]).build(
        "cuda")
    res["model"] = m.get_local_rank("model")
    ref = torch.load(d / "ref.pt")
    cfg = _uneven_cfg()
    L, B, S, W, steps = UNEVEN

    def leg():
        whole = T.init_model(cfg, torch.Generator("cuda").manual_seed(SEED),
                             "cuda")
        params = shardctx.layout_tree(
            whole, _model_only(T.model_pspecs(cfg)[1]), m)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        prompts = _dist_tokens(cfg, B, S, 11).cuda()
        rt = T.Runtime(use_kernels=True)
        diffs, limits = [], []
        t0 = time.perf_counter()
        with torch.no_grad(), shardctx.use_mesh(m):
            logits, st = T.prefill(params, {"tokens": prompts}, cfg, rt,
                                   window=W)
            k0 = st.reps[0]["self"].k
            ring = (k0.shape[2], shardctx.local(k0).shape[2])
            for i in range(steps + 1):
                want = ref["logits"][i]
                diffs.append(float((logits.float().cpu() - want)
                                   .abs().max()))
                limits.append(_parity_limit(want))
                if i < steps:
                    logits, st = T.decode_step(params, st,
                                               ref["tokens"][i].cuda(),
                                               cfg, rt)
        del st
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        with shardctx.use_mesh(m):
            count = _tp_count(params, prompts, cfg, W)
        tr = Trainer(cfg, ShapeConfig("uneven", S, B, "train"),
                     TrainConfig(), rt=T.Runtime(**UNEVEN_TRAIN_RT), mesh=m,
                     device="cuda")
        t0 = time.perf_counter()
        loss, _, grads = tr.loss_and_grads(
            params, {"tokens": _dist_tokens(cfg, B, S, 12).cuda()})
        # the global gradient norm: each leaf's local squares, replicated
        # leaves counted once
        sq = sum(float((shardctx.local(g).float() ** 2).sum())
                 / shardctx.replication(g) for g in _tensors(grads))
        with shardctx.use_mesh(m):
            sq = collectives.psum(torch.tensor([sq], dtype=torch.float64),
                                  "model")
        torch.cuda.synchronize()
        return dict(diff=diffs, limit=limits, ring_slots=ring, run_s=run_s,
                    count=count, weights=_tp_weights(params, cfg, m),
                    loss=float(loss), ref_loss=ref["loss"],
                    grad_norm=float(sq.sqrt()), ref_grad_norm=ref["grad_norm"],
                    train_s=time.perf_counter() - t0)

    _leg("uneven", leg, res)
    dist.barrier()
    dist.destroy_process_group()


def uneven_phase(smi):
    """``dist:uneven``: qwen2-vl-7b at full width on a (1, 8) mesh of 8
    gloo ranks on cuda:0 (28 heads: 4 a rank, none on rank 7; the split
    ``wk`` / ``wv`` half a KV head a rank).  Prefill and 8 decode steps fed
    the unsharded run's greedy tokens, every step's logits within the
    path-parity bound; one train step's loss within 0.02 and its gradient
    norm within 1 % of the unsharded step's; each rank's counted FLOPs of
    a prefill and decode step at its share (its heads' share of the
    prefill attention, 1 / 8 of the rest, which the whole path computes
    but for its second q projection); flash launched once a run of the
    rank's heads that read one KV head a layer, never on rank 7."""
    import shutil
    import torch.multiprocessing as mp
    d = ROOT / "build" / "uneven"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    ref = uneven_references(d)
    whole, ref_s = ref["count"], ref["ref_s"]
    del ref
    released(0)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=uneven_rank, args=(r, port, str(d), q))
             for r in range(UNEVEN_RANKS)]
    for p in procs:
        p.start()
    outs = []
    try:
        for _ in procs:
            outs.append(q.get(timeout=600))
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    errors = [o for o in outs if "error" in o]
    assert not errors, "\n".join(o["error"] for o in errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    per = [o["uneven"] for o in sorted(outs, key=lambda o: o["model"])]
    cfg = _uneven_cfg()
    L, B, S, W, _ = UNEVEN
    H, hd, D, n = (cfg.num_heads, cfg.resolved_head_dim, cfg.d_model,
                   UNEVEN_MESH[1])
    # the whole count's prefill attention (chunked: every (q, k) pair of
    # the one block, two einsums a layer) and its second q projection
    # (prefill_cache's, which a rank whose columns are not whole heads
    # leaves out)
    core = L * 2 * 2.0 * B * S * S * H * hd
    q2 = L * 2.0 * B * S * D * H * hd
    shares, launches = [], []
    for r, p in enumerate(per):
        heads, runs = _uneven_heads(r)
        share = (whole["flops"] - core - q2) / n + core * len(heads) / H
        shares.append(share)
        launches.append(L * runs)
        assert all(a <= b for a, b in zip(p["diff"], p["limit"])), \
            (r, p["diff"], p["limit"])
        assert abs(p["loss"] - p["ref_loss"]) <= DIST_TRAIN_TOL, p
        assert abs(p["grad_norm"] / p["ref_grad_norm"] - 1) <= \
            DIST_NORM_REL, p
        assert abs(p["count"]["flops"] / share - 1) <= TP_FLOPS_REL, \
            (r, p["count"]["flops"], share)
        assert p["ring_slots"] == (W, W // n), p["ring_slots"]
        for k, (mine, full) in p["weights"].items():
            assert mine * (n if k in TP_SPLIT else 1) == full, (r, k)
        assert p["launches"]["flash_attention"] == L * runs, \
            (r, p["launches"])
        assert p["launches"]["rmsnorm"] > 0, (r, p["launches"])
    assert launches[-1] == 0 and all(x > 0 for x in launches[:-1])
    log("dist:uneven:tp", json.dumps(dict(
        arch=cfg.name, layers=L, mesh=list(UNEVEN_MESH), batch=B, prompt=S,
        window=W, steps=UNEVEN[4],
        heads=[_uneven_heads(r)[0] for r in range(n)],
        rank_flops=[p["count"]["flops"] for p in per],
        whole_batch_flops=whole["flops"], prefill_attention_flops=core,
        second_q_flops=q2, share_flops=shares,
        ratio=[p["count"]["flops"] / x for p, x in zip(per, shares)],
        rank_flops_by_op=[p["count"]["by_op"] for p in per],
        coll_bytes=[p["count"]["coll"] for p in per],
        gathered_bytes=[sum(a for a, _ in p["weights"].values())
                        for p in per],
        max_diff=max(max(p["diff"]) for p in per),
        min_limit=min(min(p["limit"]) for p in per),
        loss=[p["loss"] for p in per], ref_loss=per[0]["ref_loss"],
        grad_norm=[p["grad_norm"] for p in per],
        ref_grad_norm=per[0]["ref_grad_norm"],
        flash_launches=[p["launches"]["flash_attention"] for p in per],
        run_s=[p["run_s"] for p in per], train_s=[p["train_s"] for p in per],
        wall_s=[p["wall_s"] for p in per],
        peak_gb=[p["peak_gb"] for p in per],
        host_peak_gb=[p["host_peak_gb"] for p in per],
        ref_s=ref_s, phase_wall_s=wall, card=smi)))
    return {"dist:uneven": {k: sum(p["launches"][k] for p in per)
                            for k in per[0]["launches"]}}


# ---------------------------------------------------------------------------
# launch: the example launchers on the card
# ---------------------------------------------------------------------------

# the serving launchers at their examples' smallest settings
LAUNCHES = (("quickstart", []),
            ("control_plane", ["--groups", "2", "--capacity", "4",
                               "--horizon", "40", "--variants", "1"]),
            ("hetero_topology", ["--groups", "2", "--capacity", "4",
                                 "--horizon", "40"]),
            ("work_stealing", ["--groups", "2", "--capacity", "4",
                               "--horizon", "40"]))


def launch_phase(smi):
    """The four serving launchers of ``repro_torch.launch`` on the card,
    each from its ``main`` as a user calls it: their wall seconds and
    kernel launches (zeroed just before each, read just after), flash and
    rmsnorm launched by every one; each fleet drains its trace."""
    import importlib
    import io
    from repro_torch.kernels import ops
    by_path = {}
    for name, args in LAUNCHES:
        mod = importlib.import_module(f"repro_torch.launch.{name}")
        buf = io.StringIO()
        ops.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main(args)
        wall = time.perf_counter() - t0
        got = dict(ops.launches)
        assert got["flash_attention"] > 0 and got["rmsnorm"] > 0, (name, got)
        fleets = out.get("fleet", {})
        fleets = [fleets] if "completed" in fleets else list(fleets.values())
        for f in fleets:
            assert f["completed"] == f["submitted"] > 0, (name, f)
        if name == "quickstart":
            assert out["serve"]["completed"] == 12, out["serve"]
        by_path[f"launch:{name}"] = got
        log(f"launch:{name}", json.dumps(dict(
            args=args, wall_s=wall, launches=got,
            completed=[f["completed"] for f in fleets],
            wall_ticks=[f["wall_ticks"] for f in fleets],
            printed=buf.getvalue().splitlines()[-4:], card=smi)))
    return by_path


def main() -> int:
    # cuBLAS's deterministic workspace, read when CUDA starts: the whisper
    # train phase runs under torch.use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    smi = smi_line()
    log("card:", smi, "| torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cells = start_dryrun_cells()
    try:
        return run_phases(torch, smi, cells)
    finally:
        if cells.poll() is None:
            cells.kill()
            cells.wait()


def run_phases(torch, smi, cells) -> int:
    from repro_torch.configs.base import H100
    from repro_torch.kernels import _build

    t = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t:.1f} s")
    for name in _build.sources():
        log(f"build {name}:", json.dumps(build_report(_build, name)))

    t = time.perf_counter()
    recs = kernel_phase(H100)
    log(f"kernels: {time.perf_counter() - t:.1f} s")
    by_phase = {}
    for arch, n, prompts, window in SERVES:
        t = time.perf_counter()
        by_phase.update(serve_phase(arch, n, prompts, window, smi))
        log(f"serve {arch}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    by_phase["whisper-base"] = whisper_phase(smi)
    log(f"whisper: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params, weight_bytes = qwen_weights()
    by_phase["fleet:qwen3-14b"] = fleet_phase(cfg, params, weight_bytes, smi)
    log(f"fleet: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    by_phase["cluster:qwen3-14b"] = cluster_phase(cfg, params, weight_bytes,
                                                  smi)
    log(f"cluster: {time.perf_counter() - t:.1f} s")
    del params
    released(0)
    t = time.perf_counter()
    for case in PARITY:
        parity_phase(*case)
    for kind in ("ssm", "rglru"):
        block_parity(kind)
    block_peak()
    log(f"parity: {time.perf_counter() - t:.1f} s")
    released(0)
    t = time.perf_counter()
    by_phase["train:qwen3-14b"] = train_qwen_phase(
        smi, H100, predict_train_step(*train_qwen_setup()))
    by_phase["train:deepseek-moe-16b"] = train_deepseek_phase(
        smi, H100, predict_train_step(*train_deepseek_setup()))
    by_phase["train:whisper-base"] = train_whisper_phase(smi)
    log(f"train: {time.perf_counter() - t:.1f} s")
    released(0)
    t = time.perf_counter()
    gpusim_phase()
    log(f"gpusim: {time.perf_counter() - t:.1f} s (host)")
    t = time.perf_counter()
    dryrun_cells_phase(cells, smi)
    log(f"dryrun: {time.perf_counter() - t:.1f} s (waiting for the child)")
    t = time.perf_counter()
    by_phase.update(dist_phase(smi))
    log(f"dist: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    by_phase.update(uneven_phase(smi))
    log(f"dist:uneven: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    by_phase.update(launch_phase(smi))
    log(f"launch: {time.perf_counter() - t:.1f} s")

    kernels = []
    for name, src, tpu in [
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:119"),
            ("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:34"),
            ("ssm_scan", "selective_scan.cu",
             "src/repro/kernels/linear_scan.py:122"),
            ("rglru_scan", "linear_scan.cu",
             "src/repro/kernels/linear_scan.py:61"),
            ("quantize_int8", "quantize.cu",
             "src/repro/kernels/quantize.py:45")]:
        rec = recs[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=tpu,
            launches=sum(v[name] for v in by_phase.values()),
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            shape=rec["shape"],
            launches_by_path={a: v[name] for a, v in by_phase.items()},
            **{k: rec[k] for k in ("device_ms", "unfused_ms", "abc_entry",
                                   "rows_entry", "prefill_store",
                                   "grad_rows_entry", "grouped_entry")
               if k in rec}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
