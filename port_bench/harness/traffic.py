"""The one traffic generator: every mix is a data file this module reads.

A traffic file (``port_bench/traffic/<name>.json``) holds::

    {"loop": "open" | "closed",
     "prompt": [{"weight": w, "lo": a, "hi": b}, ...],
     "output": [{"weight": w, "lo": a, "hi": b}, ...]}

``prompt`` and ``output`` are mixtures of uniform integer ranges (``lo ==
hi`` for a fixed length).  The cell file gives the load: ``rate_per_s``
for an open loop, ``clients`` for a closed one.

Everything is drawn from the seed in stratified blocks, so that every
seed gets the same amount of work in another order:

* lengths come in blocks of the smallest size that holds each component's
  weight a whole number of times; inside a block each component's values
  are a stratified sample of its range, and the block is shuffled;
* open-loop arrivals are a Poisson process whose gaps come in blocks of
  20, each block a stratified sample of the exponential distribution,
  shuffled.

Request ``i``'s prompt tokens are drawn uniformly from the vocabulary by
a generator seeded with ``(seed, i)``, so they can be made when the
request is sent.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Sequence, Tuple

import numpy as np

GAP_BLOCK = 20
MAX_BLOCK = 1000


def block_size(weights: Sequence[float]) -> int:
    """The smallest n for which every weight times n is a whole number."""
    fr = [Fraction(w).limit_denominator(MAX_BLOCK) for w in weights]
    if sum(fr) != 1:
        raise ValueError(f"weights {list(weights)} do not add up to 1")
    n = 1
    for f in fr:
        n = n * f.denominator // math.gcd(n, f.denominator)
    return n


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, *stream])


class LengthStream:
    """Lengths drawn from a mixture of uniform ranges, block by block."""

    def __init__(self, components: List[dict], seed: int, stream: int):
        self.components = components
        self.n = block_size([c["weight"] for c in components])
        self.counts = [round(c["weight"] * self.n) for c in components]
        self.seed, self.stream = seed, stream
        self._blocks = {}

    def _block(self, j: int) -> np.ndarray:
        blk = self._blocks.get(j)
        if blk is None:
            rng = _rng(self.seed, self.stream, j)
            vals = []
            for c, k in zip(self.components, self.counts):
                span = int(c["hi"]) - int(c["lo"]) + 1
                u = rng.random(k)
                vals.extend(int(c["lo"]) + np.floor(
                    (np.arange(k) + u) * span / k).astype(np.int64))
            blk = np.array(vals, dtype=np.int64)
            rng.shuffle(blk)
            self._blocks[j] = blk
        return blk

    def __getitem__(self, i: int) -> int:
        return int(self._block(i // self.n)[i % self.n])


class Mix:
    """Request ``i``'s sizes and tokens, and the open loop's due times."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        if traffic["loop"] not in ("open", "closed"):
            raise ValueError(f"loop {traffic['loop']!r}: open or closed")
        self.traffic = traffic
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.prompts = LengthStream(traffic["prompt"], seed, 1)
        self.outputs = LengthStream(traffic["output"], seed, 2)

    @property
    def loop(self) -> str:
        return self.traffic["loop"]

    def size(self, i: int) -> Tuple[int, int]:
        """(prompt length, output length) of request ``i``."""
        return self.prompts[i], self.outputs[i]

    def tokens(self, i: int) -> List[int]:
        return _rng(self.seed, 3, i).integers(
            0, self.vocab, self.prompts[i]).tolist()

    def prompt_lengths(self) -> List[int]:
        """Every prompt length the mix can send (the shapes to warm)."""
        out = set()
        for c in self.traffic["prompt"]:
            out.update(range(int(c["lo"]), int(c["hi"]) + 1))
        return sorted(out)

    def due_times(self, rate: float, horizon_s: float) -> np.ndarray:
        """Open loop: due offsets in seconds from the first, which is 0,
        up to ``horizon_s``."""
        return arrivals(rate, horizon_s, self.seed)


def unit_epochs(n: int, seed: int) -> np.ndarray:
    """n epochs of a unit-rate Poisson process from 0, gaps stratified."""
    gaps = []
    j = 0
    while len(gaps) < n - 1:
        rng = _rng(seed, 4, j)
        q = (np.arange(GAP_BLOCK) + rng.random(GAP_BLOCK)) / GAP_BLOCK
        g = -np.log1p(-q)
        rng.shuffle(g)
        gaps.extend(g.tolist())
        j += 1
    return np.concatenate([[0.0], np.cumsum(gaps[:n - 1])])


def arrivals(rate: float, horizon_s: float, seed: int) -> np.ndarray:
    if rate <= 0:
        raise ValueError(f"rate {rate} must be positive")
    n = int(math.ceil(rate * horizon_s * 1.5)) + GAP_BLOCK
    while True:
        t = unit_epochs(n, seed) / rate
        if t[-1] > horizon_s:
            return t[t <= horizon_s]
        n *= 2
