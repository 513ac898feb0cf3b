"""The port's transformer with soft-routed MoE blocks
(``TransformerConfig(n_experts, moe_every)``): every ``moe_every``-th block
holds a ``router`` (d, e) and expert stacks ``w_in`` (e, d, f) and
``w_out`` (e, f, d), every expert on every token. The dense keys as
``archs/dense.py`` reads them, and ``num_local_experts``, ``moe_every``.
A test copies this file to ``archs/soft_moe.py`` of a tiny benchmark."""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Tuple

from harness import arith
from harness.arch import Kernel, Leaf
from harness.data import flatten
from harness.spec import load_arch

reference = "soft_moe"
# The dense adapter of the same benchmark: its attention kernels and tiny cut.
dense = load_arch(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), {})


@dataclass(frozen=True)
class Dims:
    vocab: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    n_experts: int
    moe_every: int
    batch: int
    seq: int
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def is_moe(self, i: int) -> bool:
        return i % self.moe_every == self.moe_every - 1


def dims(config: Mapping[str, Any]) -> Dims:
    d = dense.dims(config)
    return Dims(
        vocab=d.vocab, d_model=d.d_model, n_heads=d.n_heads, n_layers=d.n_layers, d_ff=d.d_ff,
        n_experts=int(config["num_local_experts"]), moe_every=int(config["moe_every"]),
        batch=d.batch, seq=d.seq, dtype=d.dtype,
    )


def leaf_shapes(d: Dims) -> Dict[str, Leaf]:
    m, f, e = d.d_model, d.d_ff, d.n_experts
    shapes: Dict[str, Leaf] = {"embed": Leaf((d.vocab, m), "normal")}
    for i in range(d.n_layers):
        p = f"layers/{i}/"
        shapes.update({
            p + "ln1_scale": Leaf((m,), "ones"), p + "ln2_scale": Leaf((m,), "ones"),
            p + "wqkv": Leaf((m, 3 * m), "normal"), p + "wo": Leaf((m, m), "normal"),
        })
        if d.is_moe(i):
            shapes.update({
                p + "router": Leaf((m, e), "normal"),
                p + "w_in": Leaf((e, m, f), "normal"), p + "w_out": Leaf((e, f, m), "normal"),
            })
        else:
            shapes.update({p + "w_in": Leaf((m, f), "normal"), p + "w_out": Leaf((f, m), "normal")})
    shapes["ln_f_scale"] = Leaf((m,), "ones")
    shapes["unembed"] = Leaf((m, d.vocab), "normal")
    return shapes


def build(d: Dims, run: Mapping[str, Any], seed: int, device: Any) -> Tuple[Any, Callable, Callable]:
    import torch
    from torchsnapshot_tpu_torch.models.transformer import (
        TransformerConfig, init_train_state, make_train_step, params_tree,
    )

    cfg = TransformerConfig(
        vocab_size=d.vocab, d_model=d.d_model, n_heads=d.n_heads, n_layers=d.n_layers, d_ff=d.d_ff,
        n_experts=d.n_experts, moe_every=d.moe_every, dtype=getattr(torch, d.dtype),
        learning_rate=run["adamw"]["lr"], attn_impl=run["attn_impl"],
    )
    state = init_train_state(cfg, seed=seed, device=device)
    return state, make_train_step(cfg), lambda s: flatten(params_tree(s.model))


def param_count(d: Dims) -> int:
    return sum(math.prod(leaf.shape) for leaf in leaf_shapes(d).values())


def leaf_count(d: Dims) -> int:
    return 3 * len(leaf_shapes(d))


def state_bytes(d: Dims) -> int:
    return 3 * param_count(d) * arith.BYTES_PER_ELEMENT[d.dtype]


def step_flops(d: Dims) -> float:
    """6 x the parameters of every product (every expert runs on every
    token; the router counts, the gate-weighted sum does not) x tokens,
    plus causal attention's forward and backward."""
    matmul = sum(math.prod(leaf.shape) for k, leaf in leaf_shapes(d).items() if len(leaf.shape) > 1 and k != "embed")
    attn = 3 * arith.attention_flops_fwd(d.batch, d.n_heads, d.seq, d.head_dim) * d.n_layers
    return 6.0 * matmul * d.batch * d.seq + attn


def kernels(d: Dims) -> List[Kernel]:
    return dense.kernels(d)


def tiny(config: Mapping[str, Any]) -> Dict[str, Any]:
    return dense.tiny(config)
