"""The selective-scan kernel's share of its roofline, in %.

Over the profiler's sub-windows: the sum, over the prefill calls they
hold and the Mamba layers of each, of max(scan operations / 67 TFLOP/s,
bytes / 3.35 TB/s) (``flops.scan_cost``: each exp one operation, the fp32
rate outside the tensor cores; inputs read once, outputs written once),
over the device time of the kernels named ``selective_scan_kernel``.
"""
from port_bench.harness import flops, peaks, trace

LAYER = "kernels"
UNIT = "%"
MOVES = "prompt_tok_s"


def read(rec):
    secs = trace.kernel_seconds(rec.subwindows, "selective_scan_kernel")
    m = rec.model
    n_ssm = sum(k == "ssm" for k in flops.layer_kinds(m))
    calls = [p for p in rec.prefills if p["profiled"]]
    if secs <= 0 or not calls or not n_ssm:
        return None
    bound = sum(n_ssm * flops.bound_s(*flops.scan_cost(
        p["batch"], p["seq"], m), peaks.FP32_FLOPS) for p in calls)
    return 100.0 * bound / secs
