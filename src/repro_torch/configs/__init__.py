"""Architecture registry: dashed public ids -> ModelConfig.

Usage::

    from repro_torch.configs import get_config, ARCH_IDS
    cfg = get_config("deepseek-moe-16b")
    small = get_config("qwen3-14b", reduced=True)   # smoke-test scale
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    LM_SHAPES,
    SHAPES,
    H100,
    V5E,
    AmoebaConfig,
    HardwareConfig,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    shape_applicable,
)

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "arctic-480b": "arctic_480b",
    "nemotron-4-340b": "nemotron_4_340b",
    "granite-20b": "granite_20b",
    "qwen3-14b": "qwen3_14b",
    "starcoder2-15b": "starcoder2_15b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-base": "whisper_base",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg: ModelConfig = mod.CONFIG
    return reduce_config(cfg) if reduced else cfg


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same family/topology at smoke-test scale (CPU-runnable)."""
    updates = dict(
        num_layers=min(cfg.num_layers, 3 * max(
            1, len(cfg.block_pattern) if cfg.block_pattern else 1)),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        attn_window=min(cfg.attn_window, 64) if cfg.attn_window else None,
        max_vision_tokens=16,
    )
    if cfg.mrope:
        # keep section proportions but fit the reduced head_dim (32 -> half 16)
        half = 32 // 2
        total = sum(cfg.mrope_sections)
        secs = [max(1, s * half // total) for s in cfg.mrope_sections]
        secs[0] += half - sum(secs)
        updates["mrope_sections"] = tuple(secs)
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64)
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(cfg.ssm, d_state=8)
    if cfg.rglru is not None:
        updates["rglru"] = dataclasses.replace(cfg.rglru, lru_width=128)
    if cfg.encoder_layers:
        updates["encoder_layers"] = 2
    return cfg.replace(**updates)


def arch_shapes(arch: str) -> List[ShapeConfig]:
    """The assigned shape set for this arch (all LM shapes)."""
    return list(LM_SHAPES)


def all_cells() -> List[tuple]:
    """All 40 assigned (arch, shape) cells, with applicability flag."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in arch_shapes(arch):
            cells.append((arch, shape.name, shape_applicable(cfg, shape)))
    return cells


__all__ = [
    "ARCH_IDS", "get_config", "reduce_config", "arch_shapes", "all_cells",
    "ModelConfig", "MoEConfig", "SSMConfig", "RGLRUConfig", "ShapeConfig",
    "SHAPES", "LM_SHAPES", "shape_applicable", "HardwareConfig", "V5E", "H100",
    "AmoebaConfig", "TrainConfig", "MeshConfig",
]
