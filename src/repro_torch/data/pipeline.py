"""Deterministic synthetic data pipeline.

Counterpart of ``repro/data/pipeline.py``, in numpy and with the
reference's draws in the reference's order, so both packages see the same
batches byte for byte.  A reproducible Markov-ish token stream (the LM loss
can decrease: there is learnable structure) plus the per-family stub
inputs: precomputed audio-frame embeddings for whisper and patch
embeddings for the VLM.  The iterator state is one integer, so
checkpoint/restore is exact: restoring step k regenerates batch k
bit-identically on any host count (each host slices its own rows from the
global batch by index).  ``make_batch_specs`` gives the dry-run's
inputs as ``meta`` tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # Markov chain sparsity: each token has this many likely successors
    branching: int = 8
    enc_frames: int = 1500        # whisper stub frame count
    vision_tokens: int = 64       # vlm stub patch count


class SyntheticLM:
    """Deterministic, seekable synthetic LM batches."""

    def __init__(self, model: ModelConfig, shape: ShapeConfig,
                 cfg: DataConfig = DataConfig(),
                 host_index: int = 0, host_count: int = 1):
        self.model = model
        self.shape = shape
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        if not (shape.global_batch % host_count == 0 or host_count == 1):
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {host_count} hosts")
        self.local_batch = max(shape.global_batch // host_count, 1)
        rng = np.random.default_rng(cfg.seed)
        v = model.vocab_size
        # sparse successor table: token t -> branching candidates
        self._succ = rng.integers(0, v, size=(v, cfg.branching),
                                  dtype=np.int64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Global-step-indexed batch (deterministic, O(1) seek)."""
        B, S = self.local_batch, self.shape.seq_len
        seed = (self.cfg.seed * 1_000_003 + step) * 131 + self.host_index
        rng = np.random.default_rng(seed)
        toks = np.empty((B, S), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.model.vocab_size, size=B)
        choices = rng.integers(0, self.cfg.branching, size=(B, S))
        for t in range(1, S):
            toks[:, t] = self._succ[toks[:, t - 1], choices[:, t]]
        out: Dict[str, np.ndarray] = {"tokens": toks.astype(np.int32)}
        if self.model.encoder_layers:
            out["audio_embeds"] = rng.standard_normal(
                (B, self.cfg.enc_frames, self.model.d_model),
                dtype=np.float32)
        if self.model.vision_stub:
            n_vis = min(self.cfg.vision_tokens, S)
            out["vision_embeds"] = rng.standard_normal(
                (B, n_vis, self.model.d_model), dtype=np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_specs(model: ModelConfig, shape: ShapeConfig,
                     cfg: DataConfig = DataConfig(),
                     dtype: str = "bfloat16") -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input (dry-run path): the
    reference's keys, shapes and dtypes, nothing allocated."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32, device=meta)}
    if model.encoder_layers:
        specs["audio_embeds"] = torch.empty(
            (B, cfg.enc_frames, model.d_model), dtype=getattr(torch, dtype),
            device=meta)
    if model.vision_stub:
        n_vis = min(model.max_vision_tokens, S)
        specs["vision_embeds"] = torch.empty(
            (B, n_vis, model.d_model), dtype=getattr(torch, dtype),
            device=meta)
    return specs
