"""The MoE FFN's share of prefill device time, in %: CUDA events around
every ``moe.moe_forward`` call made inside a prefill call, over the CUDA
events around the prefill calls."""
LAYER = "MoE FFN"
UNIT = "%"
MOVES = "prompt_tok_s"
WRAP = [("repro_torch.models.moe", "moe_forward")]


def read(rec):
    spans = rec.wrapped.get("repro_torch.models.moe.moe_forward", [])
    moe = sum(s["device_ms"] for s in spans
              if s["phase"] == "prefill" and s["start"] < rec.close_t)
    pre = sum(p["device_ms"] for p in rec.prefills
              if p["start"] < rec.close_t and p["device_ms"] is not None)
    if not spans or pre <= 0:
        return None
    return 100.0 * moe / pre
