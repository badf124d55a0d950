#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA GPU: kernels, serving, parity.

    python3 chip_smoke.py            # from the repository root, one card

Phases (every failure exits nonzero; no phase's failure is caught):

1. build   — compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
             (one process per source, started together) into ``build/``.
2. kernels — each hand-written kernel against its plain PyTorch version
             on the card, at the main path's shapes, with its time (CUDA
             events, median), the plain version's time, one PyTorch
             library call's time (a yardstick the port never calls) and
             the least time the card could take (``configs.base.H100``).
3. serve   — the main path: ``ServeEngine`` on full-width qwen3-14b in
             bf16, all 40 layers, random weights from a seeded generator,
             16 requests; kernel launch counters are zeroed just before
             and read just after, and the engine's books must balance.
4. parity  — full width, 2 layers, bf16: prefill and 8 decode-step logits
             with ``use_kernels=True`` against ``use_kernels=False``.

The line before the last is the card's name and power limit, the one
before that the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
# prefill/decode logits, kernels vs plain, bf16 at full width: the two
# paths round at different points (the flash kernel keeps P in fp32 where
# chunked attention casts it to bf16; rmsnorm sums in another order).
# Logits are O(1-4); a reduced-width CPU run of the same comparison gave
# max |diff| 1.6e-2, so 0.1 leaves room for 40x wider matmuls.
PARITY_TOL = 0.1


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


def kernel_phase(hw):
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
    norm = norm_case(4096, 5120, "bfloat16", hw, flush)
    norm_case(4096 * 40, 128, "bfloat16", hw, flush)
    norm_case(37, 256, "float32", hw, flush)
    del flush
    return flash[(2048, "bfloat16")], norm


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


def serve_phase(smi):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import AmoebaConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("qwen3-14b")                  # full width, bf16, 40 L
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                          "cuda")
    torch.cuda.synchronize()
    log(f"serve: qwen3-14b {cfg.num_layers} layers d_model {cfg.d_model} "
        f"params {T.count_params(params) / 1e9:.3f} B bf16, init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card")

    rng = np.random.default_rng(SEED)
    reqs = [Request(i, list(map(int, rng.integers(
        0, cfg.vocab_size, int(rng.choice([512, 1024, 2048]))))),
        int(rng.choice([8, 16, 64]))) for i in range(16)]

    eng = ServeEngine(cfg, params, rt=T.Runtime(use_kernels=True),
                      amoeba=AmoebaConfig(split_threshold=0.3,
                                          fuse_threshold=0.05,
                                          min_phase_steps=2),
                      capacity=8, window=2304)
    # CUDA events around the group's own prefill waves and its decode
    # closure (the ``decode_fn`` hook), recorded on the stream with no
    # added synchronization; non-finite decode logits raise a device flag
    grp = eng.group
    spans = {"prefill": [], "decode": []}
    prefill_batches = 0
    nonfinite = torch.zeros((), dtype=torch.bool, device="cuda")

    def span(name, fn):
        def run(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans[name].append((s, e))
            return out
        return run

    wave, decode = span("prefill", grp._prefill_wave), span("decode",
                                                           grp._decode)

    def prefill_wave(*a, **kw):
        nonlocal prefill_batches
        g = wave(*a, **kw)
        if g is not None:                          # one prefill per length
            prefill_batches += len({len(r.prompt) for r in g.requests})
        return g

    def decode_fn(p, s, t):
        logits, st = decode(p, s, t)
        assert logits.shape == (t.shape[0], cfg.vocab_size), logits.shape
        nonfinite.logical_or_(~torch.isfinite(logits).all())
        return logits, st

    grp._prefill_wave, grp._decode = prefill_wave, decode_fn
    torch.cuda.reset_peak_memory_stats()
    eng.submit(reqs)
    ops.reset_launches()                           # zero just before the run
    t = time.perf_counter()
    st = eng.run(dynamic=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(ops.launches)                  # read just after

    assert not bool(nonfinite), "serve: non-finite decode logits"
    check_books(reqs, st)
    secs = {k: sum(s.elapsed_time(e) for s, e in v) / 1e3
            for k, v in spans.items()}
    assert launches["flash_attention"] > 0 and launches["rmsnorm"] > 0, launches
    assert launches["flash_attention"] == cfg.num_layers * prefill_batches, \
        (launches, prefill_batches)
    decode_tokens = st.useful_tokens - len(reqs)   # first tokens: prefill
    summary = dict(
        ticks=st.ticks, splits=st.splits, fuses=st.fuses,
        completed=st.completed, useful_tokens=st.useful_tokens,
        slot_steps=st.slot_steps, efficiency=st.efficiency,
        prefill_tokens=st.prefill_tokens, prefill_calls=prefill_batches,
        prefill_waves=len(spans["prefill"]),
        decode_calls=len(spans["decode"]),
        prefill_tok_s=st.prefill_tokens / secs["prefill"],
        decode_tok_s=decode_tokens / secs["decode"],
        prefill_s=secs["prefill"], decode_s=secs["decode"],
        wall_s=wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, card=smi)
    log("serve", json.dumps(summary))
    del eng, grp
    decode_profile(cfg, params, T.Runtime(use_kernels=True))
    del params
    torch.cuda.empty_cache()
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
    rec = dict(batch=B, cache_len=2304, wall_ms_per_call=wall_ms,
               device_ms_per_call=dev_ms if dev_ms > 0 else "not measured",
               device_busy_share=dev_ms / wall_ms if dev_ms > 0
               else "not measured",
               kernels_per_call=sum(e.count for e in kern) / steps,
               top=[(e.key[:60], round(e.self_device_time_total / 1e3 / steps,
                                       4), e.count // steps) for e in top])
    log("decode_profile", json.dumps(rec))


# ---------------------------------------------------------------------------
# Phase 4: path parity — kernels vs plain at full width, 2 layers
# ---------------------------------------------------------------------------

def parity_phase():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-14b").replace(num_layers=2)
    params = T.init_model(cfg, torch.Generator(device="cuda").manual_seed(1),
                          "cuda")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 256)), device="cuda")
    rts = [T.Runtime(use_kernels=k) for k in (True, False)]
    outs = [T.prefill(params, {"tokens": toks}, cfg, rt, window=264)
            for rt in rts]
    errs = [float((outs[0][0].float() - outs[1][0].float()).abs().max())]
    states = [o[1] for o in outs]
    nxt = torch.argmax(outs[0][0], dim=-1)[:, None]
    for _ in range(8):
        lg = []
        for i, rt in enumerate(rts):
            logits, states[i] = T.decode_step(params, states[i], nxt, cfg, rt)
            assert bool(torch.isfinite(logits).all())
            lg.append(logits.float())
        errs.append(float((lg[0] - lg[1]).abs().max()))
        nxt = torch.argmax(lg[0], dim=-1)[:, None]   # same tokens to both
    rec = dict(max_abs_err_prefill=errs[0], max_abs_err_decode=max(errs[1:]),
               tol=PARITY_TOL, logit_absmax=float(outs[1][0].float().abs().max()))
    log("parity", json.dumps(rec))
    assert max(errs) <= PARITY_TOL, rec
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

    flash, norm = kernel_phase(H100)
    launches = serve_phase(smi)
    parity_phase()

    kernels = []
    for name, rec, src, tpu in [
            ("flash_attention", flash,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:119"),
            ("rmsnorm", norm, "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:34")]:
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=tpu,
            launches=launches[name], max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            shape=rec["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
