"""The flash-attention kernel's share of its roofline, in %.

Over the profiler's sub-windows: the sum, over the prefill calls they
hold and the attention layers of each, of the least time a causal call
could take, max(4.B.H.hd.S^2/2 / 989 TFLOP/s, bytes / 3.35 TB/s) with
q, k, v read once and o written once (bf16), over the device time of the
kernels named ``flash_fwd*`` in them.
"""
from port_bench.harness import flops, peaks, trace

LAYER = "kernels"
UNIT = "%"
MOVES = "prompt_tok_s"


def read(rec):
    secs = trace.kernel_seconds(rec.subwindows, "flash_fwd")
    m = rec.model
    n_attn = sum(k == "attn" for k in flops.layer_kinds(m))
    calls = [p for p in rec.prefills if p["profiled"]]
    if secs <= 0 or not calls or not n_attn:
        return None
    bound = sum(n_attn * flops.bound_s(*flops.flash_cost(
        p["batch"], m["num_heads"], flops.head_dim(m), p["seq"]),
        peaks.BF16_FLOPS) for p in calls)
    return 100.0 * bound / secs
