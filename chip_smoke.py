#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA GPU: kernels, serving, parity.

    python3 chip_smoke.py            # from the repository root, one card

Phases (every failure exits nonzero; no phase's failure is caught):

1. build   — compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
             (one process per source, started together) into ``build/``.
2. kernels — each hand-written kernel against its plain PyTorch version
             on the card, at the main paths' shapes, with its time (CUDA
             events, median), the plain version's time, one PyTorch
             library call's time where one computes the same function (a
             yardstick the port never calls) and the least time the card
             could take (``configs.base.H100``).
3. serve   — the main paths, each through ``ServeEngine`` in bf16 at full
             width and depth, random weights from a seeded generator:
             qwen3-14b (40 layers, 16 requests), falcon-mamba-7b (64
             layers, 12 requests) and recurrentgemma-9b (38 layers = 12
             repetitions + 2 remainder layers, 12 requests, prompts past
             its 2048-token attention window).  Kernel launch counters are
             zeroed just before each run and read just after; every
             kernel of the model's path must have launched, once per
             layer of its kind per prefill call, and the engine's books
             must balance.
4. fleet   — the fleet path: ``FleetEngine`` with 4 reconfigurable groups
             of capacity 8 serving full-width qwen3-14b (40 layers) with
             an int8 KV cache, sticky routing onto a hot shard, work
             stealing, KV-costed live migration priced on the int8 wire
             layout, and slack leases.  Every K/V vector written goes
             through the int8 quantize kernel: 2 launches per layer per
             prefill and decode call.  At least one steal and one live
             migration must run, and the books must balance.
5. parity  — full width, bf16, reduced depth (qwen3-14b and falcon-mamba-7b
             at 2 layers, recurrentgemma-9b at 5, qwen3-14b with the int8
             KV cache): prefill and 8 decode-step logits with
             ``use_kernels=True`` against ``use_kernels=False``.

The line before the last is the card's name and power limit, the one
before that the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
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
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
NORM_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# scans against their step-by-step plain versions, relative and absolute,
# as tests/test_kernels.py: h matches to rounding; y's sum over N runs in
# another order
SCAN_TOL = {"rglru_scan": 1e-5, "ssm_scan": 1e-4}
# prefill/decode logits, kernels vs plain, bf16 at full width: the two
# paths round at different points (the flash kernel keeps P in fp32 where
# chunked attention casts it to bf16; rmsnorm sums in another order).
# qwen3-14b's logits are O(1-4); a reduced-width CPU run of the same
# comparison gave max |diff| 1.6e-2, so 0.1 leaves room for 40x wider
# matmuls.  falcon-mamba-7b ties its unembedding to an N(0, 1) table, so
# its logits reach the hundreds, where one bf16 ulp is 0.5-1: there the
# bound is 3e-2 of the largest logit magnitude (tests/test_torch_recurrent's
# bf16 bound), and 0.1 where that is smaller.  The final hidden states
# (RMS 1 after the final norm) are held to the same rule.
PARITY_TOL = 0.1
PARITY_REL = 3e-2
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


def bound(flops: float, nbytes: float, peak: float, hw):
    """(bound_ms, bound_by): the larger of operations/peak and bytes/rate."""
    t_ops, t_bytes = flops / peak, nbytes / hw.hbm_bandwidth
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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
               bound_by=bound_by, tflops=flops / ms / 1e9)
    log("flash_attention", json.dumps(rec))
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
               bound_by=bound_by, gbps=nbytes / ms / 1e6)
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
    so there is no library time."""
    import torch
    from repro_torch.kernels import linear_scan as LS
    g = torch.Generator(device="cuda").manual_seed(SEED)
    a = 0.4 + 0.599 * torch.rand(B, S, W, device="cuda", generator=g)
    b = torch.randn(B, S, W, device="cuda", generator=g)
    got = LS.rglru_scan_cuda(a, b)
    torch.cuda.synchronize()
    err, tol = _scan_check("rglru_scan", [got], [LS.rglru_scan_plain(a, b)])
    ms = time_ms(lambda: LS.rglru_scan_cuda(a, b), flush=flush)
    plain_ms = time_ms(lambda: LS.rglru_scan_plain(a, b), flush=flush)
    nbytes = 4 * 3 * a.numel()            # read a, b; write h
    flops = 2.0 * a.numel()               # one multiply, one add
    bound_ms, bound_by = bound(flops, nbytes, FP32_PEAK, hw)
    rec = dict(shape=f"B{B} S{S} W{W} float32", max_abs_err=err, tol=tol,
               ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
               bound_by=bound_by, gbps=nbytes / ms / 1e6)
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
    ms = time_ms(lambda: QZ.quantize_int8_cuda(x, floor), flush=flush)
    plain_ms = time_ms(lambda: QZ.quantize_int8_plain(x, floor), flush=flush)
    nbytes = x.numel() * x.element_size() + q.numel() + 4 * s.numel()
    flops = 4.0 * x.numel()           # |x|, max, divide, round (fp32)
    bound_ms, bound_by = bound(flops, nbytes, FP32_PEAK, hw)
    rec = dict(shape=f"T{T_} D{D} {dtype} floor {floor:g}",
               max_abs_err=max(float(code_diff), scale_err),
               max_code_diff=code_diff, codes_differing=n_diff,
               max_scale_diff=scale_err, tol=0.0, ms=ms, plain_ms=plain_ms,
               library_ms=None, library="none: no single PyTorch call "
               "computes the scales and the codes", bound_ms=bound_ms,
               bound_by=bound_by, gbps=nbytes / ms / 1e6)
    log("quantize_int8", json.dumps(rec))
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
    flash_case(1, 40, 8, 2048, 128, "bfloat16", True, 512, hw, flush)
    flash_case(1, 40, 8, 333, 128, "bfloat16", True, None, hw, flush)
    flash_case(2, 4, 2, 512, 32, "bfloat16", True, None, hw, flush)
    flash_case(2, 4, 2, 333, 32, "float32", False, 48, hw, flush)
    # recurrentgemma-9b's attention: MQA, hd 256, past its 2048 window
    flash_case(1, 16, 1, 3072, 256, "bfloat16", True, 2048, hw, flush)
    flash_case(2, 4, 1, 333, 256, "float32", True, 48, hw, flush)
    norm = norm_case(4096, 5120, "bfloat16", hw, flush)
    norm_case(4096 * 40, 128, "bfloat16", hw, flush)
    norm_case(37, 256, "float32", hw, flush)
    ssm = ssm_case(1, 2048, 8192, 16, hw, flush)    # falcon-mamba, one row
    ssm_case(2, 333, 4100, 16, hw, flush)
    ssm_case(1, 77, 96, 8, hw, flush)
    rglru = rglru_case(1, 2048, 4096, hw, flush)    # recurrentgemma
    rglru_case(2, 333, 4100, hw, flush)
    # qwen3-14b's int8 KV writes: prefill_cache's K or V at B4, window
    # 2304, 8 kv heads (floor 1e-8), and one decode step's at B8; then the
    # TPU kernel's own sweep at its 1e-12 floor
    quant = quant_case(4 * 2304 * 8, 128, "bfloat16", 1e-8, hw, flush)
    quant_case(8 * 8, 128, "bfloat16", 1e-8, hw, flush)
    quant_case(128, 1024, "float32", 1e-12, hw, flush)
    quant_case(33, 257, "float32", 1e-12, hw, flush)
    del flush
    torch.cuda.empty_cache()
    return {"flash_attention": flash[(2048, "bfloat16")], "rmsnorm": norm,
            "ssm_scan": ssm, "rglru_scan": rglru, "quantize_int8": quant}


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
          ("recurrentgemma-9b", 12, (512, 1024, 3072), 3200)]
# the kernel each block kind's prefill launches once per layer
KIND_KERNEL = {"attn": "flash_attention", "ssm": "ssm_scan",
               "rglru": "rglru_scan"}


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

    def _span(self, name, fn):
        import torch

        def run(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            self.spans[name].append((s, e))
            return out
        return run

    def hook(self, grp):
        import torch
        wave = self._span("prefill", grp._prefill_wave)
        decode = self._span("decode", grp._decode)
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
    rt = T.Runtime(use_kernels=True)
    if arch == "qwen3-14b":
        decode_profile(cfg, params, rt)
    prefill_profile(cfg, params, rt, 4 * 2048 // max(prompts), max(prompts),
                    window)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < 1e9, torch.cuda.memory_allocated()
    return launches


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

    run(2)
    wall_ms = run(steps)
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
            for name in ("flash_fwd_kernel", "rmsnorm_kernel",
                         "ssm_scan_kernel", "rglru_scan_kernel")}
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    rec = dict(arch=cfg.name, batch=B, prompt=S, wall_ms=wall_ms,
               device_ms=dev_ms if dev_ms > 0 else "not measured",
               device_busy_share=dev_ms / wall_ms if dev_ms > 0
               else "not measured",
               kernels=sum(e.count for e in kern),
               hand_written_ms={k: v for k, v in ours.items() if v > 0},
               top=[(e.key[:60], round(e.self_device_time_total / 1e3, 4),
                     e.count) for e in top])
    log("prefill_profile", json.dumps(rec))


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


def fleet_phase(smi):
    import torch
    from repro_torch import fleet as F
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (AmoebaConfig, FleetConfig,
                                          LeaseConfig, MigrationConfig)
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-14b")                 # full width, bf16
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                          "cuda")
    torch.cuda.synchronize()
    log(f"fleet: {cfg.name} {cfg.num_layers} layers, init "
        f"{time.perf_counter() - t0:.1f} s")
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

    def record_moves(grp):
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
                    priced_bytes=eng.planner.cost.kv_bytes(
                        seq, cfg, FLEET_WINDOW),
                    row_bytes=row,
                    row_bytes_live=row * min(seq, FLEET_WINDOW)
                    // FLEET_WINDOW))
            return out
        grp.extract_live = run

    for grp in eng.groups:
        paths.hook(grp)
        record_moves(grp)
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
    assert launches["quantize_int8"] == 2 * layers * (n_prefill + n_decode), \
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
    del eng, grp, paths, record_moves      # hooks and groups form a cycle
    decode_profile(cfg, params, rt)        # launches per int8 decode call
    del params
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < 1e9, torch.cuda.memory_allocated()
    return launches


# ---------------------------------------------------------------------------
# Phase 5: path parity — kernels vs plain at full width, 2 layers
# ---------------------------------------------------------------------------

# (arch, layers, batch, prompt length, engine window, int8 KV cache);
# recurrentgemma-9b's 5 layers are one repetition and the two remainder
# layers, and its prompt runs past the 2048-token attention window
PARITY = [("qwen3-14b", 2, 2, 256, 264, False),
          ("falcon-mamba-7b", 2, 2, 256, 264, False),
          ("recurrentgemma-9b", 5, 2, 2100, 2108, False),
          ("qwen3-14b", 2, 2, 256, 264, True)]


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


def parity_phase(arch, layers, B, S, window, kv_quant):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as QZ
    from repro_torch.models import transformer as T

    cfg = get_config(arch).replace(num_layers=layers)
    params = T.init_model(cfg, torch.Generator(device="cuda").manual_seed(1),
                          "cuda")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    rts = [T.Runtime(use_kernels=k, kv_quant=kv_quant) for k in (True, False)]
    # every int8 KV write of the kernel path, held to the plain quantizer
    # on the same K/V rows: codes and scales equal exactly
    quantize, checked = ops.quantize_int8, {"calls": 0, "rows": 0}

    def checked_quantize(x, floor=1e-12):
        q, s = quantize(x, floor)
        wq, ws = QZ.quantize_int8_plain(x, floor)
        assert torch.equal(q, wq) and torch.equal(s, ws), \
            f"int8 KV write differs from the plain quantizer at {x.shape}"
        checked["calls"] += 1
        checked["rows"] += x.shape[0]
        return q, s

    ops.quantize_int8 = checked_quantize
    # the final hidden states too: at 2 layers falcon-mamba's tied logits
    # are dominated by each token's own embedding (|logit| ~ d_model), where
    # a bf16 ulp hides what the blocks did
    hid = [T.forward_hidden(params, *T.embed_inputs(params, {"tokens": toks},
                                                    cfg), cfg, rt)[0].float()
           for rt in rts]
    hid_err = float((hid[0] - hid[1]).abs().max())
    hid_tol = max(PARITY_TOL, PARITY_REL * float(hid[1].abs().max()))
    del hid
    outs = [T.prefill(params, {"tokens": toks}, cfg, rt, window=window)
            for rt in rts]
    errs = [float((outs[0][0].float() - outs[1][0].float()).abs().max())]
    absmax = float(outs[1][0].float().abs().max())
    states = [o[1] for o in outs]
    caches = {"prefill": _cache_diff(*states)} if kv_quant else {}
    nxt = torch.argmax(outs[0][0], dim=-1)[:, None]
    for _ in range(8):
        lg = []
        for i, rt in enumerate(rts):
            logits, states[i] = T.decode_step(params, states[i], nxt, cfg, rt)
            assert bool(torch.isfinite(logits).all())
            lg.append(logits.float())
        errs.append(float((lg[0] - lg[1]).abs().max()))
        absmax = max(absmax, float(lg[1].abs().max()))
        nxt = torch.argmax(lg[0], dim=-1)[:, None]   # same tokens to both
    ops.quantize_int8 = quantize
    if kv_quant:
        caches["decode_8"] = _cache_diff(*states)
        # K and V of each layer, at prefill and at each of the 8 steps
        assert checked["calls"] == 2 * layers * 9, checked
    tol = PARITY_TOL if arch == "qwen3-14b" else max(PARITY_TOL,
                                                     PARITY_REL * absmax)
    rec = dict(arch=arch, layers=layers, batch=B, prompt=S,
               kv_quant=kv_quant,
               max_abs_err_prefill=errs[0], max_abs_err_decode=max(errs[1:]),
               tol=tol, logit_absmax=absmax, max_abs_err_hidden=hid_err,
               hidden_tol=hid_tol, int8_writes_checked=checked,
               int8_cache_kernel_vs_plain_path=caches)
    log("parity", json.dumps(rec))
    assert max(errs) <= tol and hid_err <= hid_tol, rec
    del params, outs, states
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.base import H100
    from repro_torch.kernels import _build

    smi = smi_line()
    log("card:", smi, "| torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t:.1f} s")
    for name in _build.sources():
        regs = [ln.strip() for ln in _build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"build {name}:", " | ".join(sorted(set(regs))))

    t = time.perf_counter()
    recs = kernel_phase(H100)
    log(f"kernels: {time.perf_counter() - t:.1f} s")
    by_phase = {}
    for arch, n, prompts, window in SERVES:
        t = time.perf_counter()
        by_phase[arch] = serve_phase(arch, n, prompts, window, smi)
        log(f"serve {arch}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    by_phase["fleet:qwen3-14b"] = fleet_phase(smi)
    log(f"fleet: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    for case in PARITY:
        parity_phase(*case)
    log(f"parity: {time.perf_counter() - t:.1f} s")

    kernels = []
    for name, src, tpu in [
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:119"),
            ("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:34"),
            ("ssm_scan", "linear_scan.cu",
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
            launches_by_path={a: v[name] for a, v in by_phase.items()}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
