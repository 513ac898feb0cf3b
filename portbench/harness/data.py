"""Inputs made from ``--seed`` (weights, token batches) and the bitwise
fingerprints that the save and restore checks compare.

The weights and every token batch come from generators on the run's
device, seeded from ``--seed`` through ``numpy.random.SeedSequence`` (any
whole number, however large). The same seed gives the same inputs, to the
program and to the reference alike.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from .arch import INITS, Leaf

WEIGHTS, TOKENS, TRAIN_RNG = 0, 1, 2  # streams drawn from one --seed


def stream_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([int(seed) & (2**128 - 1), stream]).generate_state(1, np.uint64)[0])


def make_weights(leaves: Mapping[str, Leaf], dtype: str, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every leaf as ``leaf_shapes`` gives it: ``ones``, ``zeros``, or
    ``normal`` N(0, 1/fan_in), fan_in its second-to-last dimension. One draw
    of standard normals in ``dtype`` on the device for all ``normal``
    leaves, in their order, cut and scaled; a leaf of another dtype is
    cast from its cut."""
    state_dtype = getattr(torch, dtype)
    for name, leaf in leaves.items():
        if leaf.init not in INITS:
            raise ValueError(f"leaf {name!r}: init {leaf.init!r} is not one of {INITS}")
    total = sum(math.prod(leaf.shape) for leaf in leaves.values() if leaf.init == "normal")
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHTS))
    flat = torch.empty(total, dtype=state_dtype, device=device).normal_(generator=g)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, leaf in leaves.items():
        want = getattr(torch, leaf.dtype) if leaf.dtype else state_dtype
        if leaf.init == "normal":
            n = math.prod(leaf.shape)
            out[name] = flat[offset:offset + n].view(leaf.shape).mul(1.0 / math.sqrt(leaf.shape[-2])).to(want)
            offset += n
        else:
            out[name] = (torch.ones if leaf.init == "ones" else torch.zeros)(leaf.shape, dtype=want, device=device)
    return out


class TokenFeed:
    """Each step's (batch, seq) token ids over the vocabulary, drawn on the
    device (``d``: an adapter's dims)."""

    def __init__(self, d: Any, seed: int, device: torch.device) -> None:
        self.d = d
        self.g = torch.Generator(device=device).manual_seed(stream_seed(seed, TOKENS))
        self.device = device

    def next(self) -> torch.Tensor:
        return torch.randint(
            0, self.d.vocab, (self.d.batch, self.d.seq), generator=self.g, device=self.device
        )


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves of nested dicts and lists by ``a/b/0/c`` path, as the
    snapshot manifest names them. Tuples and other values are leaves."""
    if isinstance(tree, Mapping):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


# Weight of word i: i * _MUL + _ADD, odd for every i, so that a change of
# any one word changes the sum modulo 2**64.
_MUL, _ADD = 0x9E3779B97F4A7C16 - 2**64, 0x632BE59BD9B4E019  # as signed int64


def _word_sum(t: torch.Tensor) -> torch.Tensor:
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    n = raw.numel()
    words = raw.view(torch.int32) if n % 4 == 0 else raw.view(torch.int16) if n % 2 == 0 else raw
    idx = torch.arange(words.numel(), dtype=torch.int64, device=t.device)
    weight = idx.mul_(_MUL).add_(_ADD)
    return words.to(torch.int64).mul_(weight).sum()


def fingerprints(leaves: Mapping[str, Any]) -> Dict[str, Tuple]:
    """Each leaf's signature: a tensor's dtype, shape and the weighted sum of
    its words modulo 2**64 (one host read for all of them); any other value
    by its ``repr``."""
    sums: List[torch.Tensor] = []
    names: List[str] = []
    out: Dict[str, Tuple] = {}
    for name, v in leaves.items():
        if isinstance(v, torch.Tensor):
            names.append(name)
            sums.append(_word_sum(v).cpu() if v.device.type != "cpu" else _word_sum(v))
        else:
            out[name] = ("value", repr(v))
    values = torch.stack(sums).tolist() if sums else []
    for name, s in zip(names, values):
        v = leaves[name]
        out[name] = ("tensor", str(v.dtype), tuple(v.shape), s)
    return dict(sorted(out.items()))
