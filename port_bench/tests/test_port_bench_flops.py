"""FLOP and byte counts against values worked by hand."""
import pytest

from port_bench.harness import flops, manifest, peaks


@pytest.fixture
def deepseek(root):
    return manifest.load_json(root / "port_bench" / "configs"
                              / "deepseek-moe-16b.json")["model"]


@pytest.fixture
def falcon(root):
    return manifest.load_json(root / "port_bench" / "configs"
                              / "falcon-mamba-7b.json")["model"]


def test_deepseek_active_weights(deepseek):
    # a layer: q, k, v, o 4 x 2048 x 2048; router 2048 x 64; 6 routed and
    # 2 shared experts of 3 x 2048 x 1408 -- never all 64
    layer = 4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1408
    assert layer == 86_114_304
    p = flops.matmul_params(deepseek)
    assert p["blocks"] == 28 * layer == 2_411_200_512
    assert p["head"] == 2048 * 102_400
    assert p["blocks"] + p["head"] == 2_620_915_712


def test_falcon_active_weights(falcon):
    # in_proj 4096 x 16384, x_proj 8192 x (256 + 32), dt_proj 256 x 8192,
    # out_proj 8192 x 4096; the tied table is the LM head
    layer = 4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096
    assert layer == 105_119_744
    p = flops.matmul_params(falcon)
    assert p["blocks"] == 64 * layer
    assert p["head"] == 4096 * 65_024


def test_flash_cost_by_hand():
    # B 1, H 1, hd 2, S 2: 4 * 2 * 4 / 2 = 16 operations; q, k, v, o of
    # 2 x 2 bf16 values: 4 * 4 * 2 = 32 bytes
    assert flops.flash_cost(1, 1, 2, 2) == (16.0, 32.0)
    ops, nb = flops.flash_cost(4, 16, 128, 2048)
    assert ops == 4 * 4 * 16 * 128 * 2048 ** 2 / 2
    assert nb == 4 * 4 * 2048 * 16 * 128 * 2


def test_scan_cost_by_hand(falcon):
    ops, nb = flops.scan_cost(1, 2, falcon)
    assert ops == 2 * 8192 * (7 * 16 + 1) == 1_851_392
    # dt, x bf16 (2 x 2 x 8192 x 2), A (8192 x 16 x 4), B, C fp32
    # (2 x 2 x 16 x 4), y fp32 (2 x 8192 x 4), last state (8192 x 16 x 4)
    assert nb == 65_536 + 524_288 + 256 + 65_536 + 524_288


def test_prefill_is_the_sum_of_its_tokens(deepseek, falcon):
    for m in (deepseek, falcon):
        p = flops.matmul_params(m)
        S = 37
        by_token = sum(2 * p["blocks"] + flops.attn_extra(m, k)
                       + flops.ssm_extra(m) for k in range(1, S + 1))
        assert flops.prefill_flops(m, 3, S) == pytest.approx(
            3 * (by_token + 2 * p["head"]))
        assert flops.decode_flops(m, 100) == pytest.approx(
            2 * (p["blocks"] + p["head"]) + flops.attn_extra(m, 100)
            + flops.ssm_extra(m))


def test_attention_and_scan_terms(deepseek, falcon):
    assert flops.attn_extra(deepseek, 10) == 4 * 16 * 128 * 10 * 28
    assert flops.attn_extra(falcon, 10) == 0
    assert flops.ssm_extra(falcon) == 64 * (2 * 4 * 8192 + 8192 * 113)
    assert flops.ssm_extra(deepseek) == 0


def test_bound_takes_the_larger_term():
    assert flops.bound_s(989e12, 0, peaks.BF16_FLOPS) == pytest.approx(1.0)
    assert flops.bound_s(0, 3.35e12, peaks.BF16_FLOPS) == pytest.approx(1.0)
    assert flops.bound_s(989e12, 2 * 3.35e12, peaks.BF16_FLOPS) == \
        pytest.approx(2.0)
