"""The metric arithmetic: tails with censored requests, rates over the
whole window, and each per-layer reader on a made-up record."""
import numpy as np
import pytest

from port_bench.harness import manifest, stats
from port_bench.harness.serve import Rec, Record, end_to_end


class _Req:
    def __init__(self, prompt_len, generated=()):
        self.prompt = [0] * prompt_len
        self.generated = list(generated)


def _rec(root, cell="fmamba7b-rag", requests=(), **kw):
    c = manifest.load_cell(root, cell)
    kw.setdefault("counters", {"useful_tokens": 0, "slot_steps": 0})
    return Record(cell=c, model=c.config["model"], seconds=20.0, open_t=100.0,
                  close_t=120.0, requests=list(requests), **kw)


def test_percentile_is_numpys_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100):
        v = rng.random(n).tolist()
        for q in (50, 90, 95):
            assert stats.percentile(v, q) == pytest.approx(
                np.percentile(v, q))
    assert stats.percentile([], 90) is None


def test_ttft_tail_counts_requests_without_a_first_token(root):
    # due at 100..109; nine answered 1 s after due, one never answered
    recs = [Rec(req=_Req(10), due=100.0 + i, first=101.0 + i)
            for i in range(9)]
    recs.append(Rec(req=_Req(10), due=109.0))
    recs.append(Rec(req=_Req(10), due=121.0))         # due after the close
    out = end_to_end(_rec(root, requests=recs), {"ttft_p90_s"})
    ages = [1.0] * 9 + [120.0 - 109.0]
    assert out["ttft_p90_s"] == pytest.approx(np.percentile(ages, 90))
    # a first token after the close is censored at the close too
    recs[0].first = 125.0
    out = end_to_end(_rec(root, requests=recs), {"ttft_p90_s"})
    ages[0] = 20.0
    assert out["ttft_p90_s"] == pytest.approx(np.percentile(ages, 90))


def test_itl_is_mean_gap_of_requests_with_two_tokens(root):
    recs = [Rec(req=_Req(10), due=100.0, first_in=101.0, last_in=101.5,
                n_in=6),
            Rec(req=_Req(10), due=100.0, first_in=101.0, last_in=101.0,
                n_in=1)]
    out = end_to_end(_rec(root, requests=recs), {"itl_p90_ms"})
    assert out["itl_p90_ms"] == pytest.approx(100.0)


def test_output_rate_counts_every_token_in_the_window(root):
    recs = [Rec(req=_Req(10), due=100.0, n_in=12),
            Rec(req=_Req(10), due=110.0, n_in=3),
            Rec(req=_Req(10), due=119.0)]
    out = end_to_end(_rec(root, requests=recs), {"output_tok_s"})
    assert out["output_tok_s"] == pytest.approx(15 / 20.0)


def test_prompt_rate_is_over_the_whole_window(root):
    recs = [Rec(req=_Req(1024), due=100.0, first=101.0, first_call=100.5),
            Rec(req=_Req(2048), due=100.0, first=119.9, first_call=119.0),
            Rec(req=_Req(4096), due=100.0, first=120.5,      # after close,
                first_call=119.5),                           # half before
            Rec(req=_Req(8192), due=100.0, first=121.0,      # call started
                first_call=120.2),                           # after close
            Rec(req=_Req(512), due=100.0)]                   # never
    out = end_to_end(_rec(root, "dsmoe16b-docs", requests=recs),
                     {"prompt_tok_s"})
    assert out["prompt_tok_s"] == pytest.approx(
        (1024 + 2048 + 4096 * 0.5) / 20.0)


def _reader(root, name):
    return manifest.readers(root, [{"name": name}])[name]


def test_tail_readers_are_the_window_arithmetic(root):
    recs = [Rec(req=_Req(8), due=100.0 + i, first=101.0 + 2 * i,
                first_in=101.0 + 2 * i, last_in=102.0 + 2 * i, n_in=3)
            for i in range(5)]
    r = _rec(root, requests=recs)
    want = end_to_end(r, {"ttft_p90_s", "itl_p90_ms"})
    assert _reader(root, "ttft_p90_s.chat").read(r) == want["ttft_p90_s"]
    assert _reader(root, "itl_p90_ms.chat").read(r) == want["itl_p90_ms"]
    assert want["itl_p90_ms"] == pytest.approx(500.0)


def test_slot_efficiency_and_queue_wait(root):
    r = _rec(root, counters={"useful_tokens": 30, "slot_steps": 120},
             requests=[Rec(req=_Req(8), due=100.0, first=103.0,
                           first_tick=102.0),
                       Rec(req=_Req(8), due=110.0, first=111.0,
                           first_tick=110.5),
                       Rec(req=_Req(8), due=115.0)])
    assert _reader(root, "slot_efficiency.chat").read(r) == 25.0
    assert _reader(root, "queue_wait_p50_s.chat").read(r) == 2.0


def test_decode_and_prefill_spans(root):
    r = _rec(root, decodes=[dict(start=101.0, host_s=0.09, device_ms=40.0),
                            dict(start=102.0, host_s=0.11, device_ms=60.0),
                            dict(start=121.0, host_s=9.0, device_ms=9.0)],
             prefills=[dict(start=101.0, batch=2, seq=1024, device_ms=100.0,
                            profiled=False),
                       dict(start=105.0, batch=1, seq=2048, device_ms=100.0,
                            profiled=False)])
    assert _reader(root, "decode_host_ms.chat").read(r) == \
        pytest.approx(100.0)
    assert _reader(root, "decode_device_ms.chat").read(r) == \
        pytest.approx(50.0)
    assert _reader(root, "prefill_ms_per_ktok.docs").read(r) == \
        pytest.approx(200.0 / 4.096)


def test_moe_share_counts_prefill_phase_only(root):
    spans = [dict(start=101.0, device_ms=30.0, phase="prefill"),
             dict(start=101.0, device_ms=50.0, phase="decode")]
    r = _rec(root, prefills=[dict(start=101.0, batch=1, seq=8,
                                  device_ms=60.0, profiled=False)],
             wrapped={"repro_torch.models.moe.moe_forward": spans})
    assert _reader(root, "moe_share.docs").read(r) == pytest.approx(50.0)
    assert _reader(root, "moe_share.docs").read(_rec(root)) is None


def test_idle_share_and_rooflines_from_subwindows(root):
    sub = {"start_us": 0.0, "end_us": 40.0, "spans": [],
           "kernels": [("flash_fwd_wgmma<...>", 0.0, 10.0),
                       ("gemm", 5.0, 20.0)]}
    r = _rec(root, "dsmoe16b-docs", subwindows=[sub],
             prefills=[dict(start=101.0, batch=1, seq=1024, device_ms=1.0,
                            profiled=True)])
    assert _reader(root, "device_idle_share.docs").read(r) == \
        pytest.approx(50.0)
    from port_bench.harness import flops, peaks
    m = r.model
    bound = 28 * max(4 * 16 * 128 * 1024 ** 2 / 2 / peaks.BF16_FLOPS,
                     4 * 1024 * 16 * 128 * 2 / peaks.HBM_BYTES_S)
    assert _reader(root, "flash_roofline.docs").read(r) == \
        pytest.approx(100.0 * bound / 10e-6)
    assert flops.layer_kinds(m).count("attn") == 28
    # no kernel of its name, or no prefill in a sub-window: no reading
    r.subwindows[0]["kernels"] = [("gemm", 0.0, 1.0)]
    assert _reader(root, "flash_roofline.docs").read(r) is None
    assert _reader(root, "ssm_scan_roofline.docs").read(r) is None


def test_mfu_counts_model_flops_of_tokens_in_the_window(root):
    from port_bench.harness import flops, peaks
    r = _rec(root, requests=[Rec(req=_Req(128), due=100.0, first=101.0,
                                 n_in=3),
                             Rec(req=_Req(256), due=119.0, first=121.0)])
    m = r.model
    want = (flops.prefill_flops(m, 1, 128) + flops.decode_flops(m, 129)
            + flops.decode_flops(m, 130))
    assert _reader(root, "mfu.chat").read(r) == pytest.approx(
        100.0 * want / (20.0 * peaks.BF16_FLOPS))
