"""Seeded weights, made on the device, and the reference's view of them.

The port's ``init_model`` on the ``meta`` device gives the parameter
tree's structure (names, shapes, dtypes) and nothing else.  Every leaf is
then a view into one flat buffer per dtype, filled by one ``normal_``
call of a generator seeded with the run's seed on the device, and scaled
in place by a rule on its name and shape:

* norm scales: ``1 + 0.05 z``;
* a Mamba mixer's ``A_log``: ``log(1..N) + 0.05 z`` (N the state size),
  ``D``: ``1 + 0.1 z``, ``dt_bias``: the inverse softplus of
  ``dt = 0.01 exp(0.8 z)`` (clipped to [1e-4, 0.3]);
* the embedding table (V, D): ``z / sqrt(D)``, so that a token's own
  embedding does not outweigh the blocks in the residual stream (with
  ``z`` a tied LM head ranks the input token first whatever the blocks
  compute);
* every other leaf of two or more dimensions (projections, expert banks,
  the router, the LM head, the depthwise conv): ``z / sqrt(fan_in)``,
  ``fan_in`` its second-to-last dimension;
* any other 1-D leaf: ``0.02 z``.

Leaves start at 256-byte offsets, so each is aligned as a fresh
allocation would be.  The same tensors go to the program and to the
reference (:func:`reference_view`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch

ALIGN = 256          # bytes between leaf starts


def leaves(tree, path=()) -> List[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree) for x in leaves(t, path + (i,))]
    return [(path, tree)]


def rebuild(tree, fn: Callable, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(rebuild(v, fn, path + (i,)) for i, v in enumerate(tree))
    if isinstance(tree, list):
        return [rebuild(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _init_leaf(name: str, t: torch.Tensor) -> None:
    """Scale the standard normal values in ``t`` in place by its rule."""
    if name == "scale" or name.endswith("norm"):
        t.mul_(0.05).add_(1.0)
    elif name == "A_log":
        n = t.shape[-1]
        base = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=t.device))
        t.mul_(0.05).add_(base.to(t.dtype))
    elif name == "D":
        t.mul_(0.1).add_(1.0)
    elif name == "dt_bias":
        dt = (math.log(1e-2) + 0.8 * t.float()).exp_().clamp_(1e-4, 0.3)
        t.copy_(torch.log(torch.expm1(dt)))
    elif name == "table":
        t.mul_(1.0 / math.sqrt(t.shape[-1]))
    elif t.dim() >= 2:
        t.mul_(1.0 / math.sqrt(t.shape[-2]))
    else:
        t.mul_(0.02)


def make(meta_tree, seed: int, device) -> Any:
    """The tree of ``meta_tree``'s structure, filled from ``seed``."""
    flat = leaves(meta_tree)
    sizes: Dict[torch.dtype, int] = {}
    offset: Dict[tuple, int] = {}
    for path, m in flat:
        step = max(1, ALIGN // m.element_size())
        at = -(-sizes.get(m.dtype, 0) // step) * step
        offset[path] = at
        sizes[m.dtype] = at + m.numel()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    buffers = {}
    for dt in sorted(sizes, key=str):
        buffers[dt] = torch.empty(sizes[dt], dtype=dt, device=device)
        buffers[dt].normal_(generator=gen)

    def fill(path, m):
        at = offset[path]
        t = buffers[m.dtype][at:at + m.numel()].view(m.shape)
        _init_leaf(path[-1], t)
        return t

    return rebuild(meta_tree, fill)


def _flat_names(tree, prefix="") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat_names(v, name + "."))
        else:
            out[name] = v
    return out


def reference_view(params, pattern_len: int) -> Dict[str, Any]:
    """The port's tree as the reference reads it: ``embed`` (V, D),
    ``unembed`` (D, V) or None when tied, ``final_norm`` (D,), and
    ``layers``, one dict a layer in the order the port runs them, of
    dotted names (``mixer.wq``, ``ffn.experts.wi_up``, ...) to that
    layer's tensors.  The tensors are the program's, not copies."""
    layers: List[Dict[str, torch.Tensor]] = []
    reps = params.get("reps", ())
    if reps:
        R = reps[0]["norm1"]["scale"].shape[0]
        for r in range(R):
            for i in range(pattern_len):
                layers.append({k: v[r] for k, v in
                               _flat_names(reps[i]).items()})
    for blk in params.get("rest", ()):
        layers.append(_flat_names(blk))
    emb = params["embed"]
    return {"embed": emb["table"], "unembed": emb.get("out"),
            "final_norm": params["final_norm"]["scale"], "layers": layers}
