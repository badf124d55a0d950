"""The whole step's share of the chip's bf16 peak, in %.

Model FLOPs (``flops``: 2 x the weights a token multiplies, with a MoE's
top-k routed and its shared experts, plus attention over the token's
context and a Mamba layer's conv and scan; a prefill's LM head at its
last position) of every prompt token whose request got its first token in
the window and every generated token stamped in it, over the window's
length times 989 TFLOP/s.
"""
from port_bench.harness import flops, peaks

LAYER = "whole step"
UNIT = "%"
MOVES = {"chat": "output_tok_s", "docs": "prompt_tok_s"}


def read(rec):
    m = rec.model
    total = 0.0
    for r in rec.requests:
        if r.first is None or r.first > rec.close_t:
            continue
        S = r.prompt_len
        total += flops.prefill_flops(m, 1, S)
        for j in range(2, r.n_in + 1):
            total += flops.decode_flops(m, S + j - 1)
    if total <= 0:
        return None
    return 100.0 * total / (rec.seconds * peaks.BF16_FLOPS)
