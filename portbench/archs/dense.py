"""The port's dense transformer (``torchsnapshot_tpu_torch/models/transformer.py``)
at a configuration's published keys: ``hidden_size``, ``num_attention_heads``,
``num_hidden_layers``, ``intermediate_size``, ``vocab_size``. Its plain
reference is ``reference/model.py``. What an adapter gives: ``harness/arch.py``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Tuple

from harness import arith
from harness.arch import Kernel, Leaf
from harness.data import flatten

reference = "model"

# The chunk kernel is flash_wgmma_kernel<Config, CAUSAL, FUSED> with FUSED
# false (csrc/flash_attention.cu); the fused forward has FUSED true.
FLASH_CHUNK = r"flash_wgmma_kernel<(?:(?!>\().)*,\s*false\s*>?(?=>\(|$)"
# ts_flash_bwd: a stats pre-pass, then the dK/dV and the dQ kernels, one
# dK/dV launch a call.
FLASH_BWD = ("flash_bwd_stats_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
# The CPU tests' size: two blocks of width 64, a vocabulary of 512, two
# sequences of 128 tokens.
TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 256, "vocab_size": 512}


@dataclass(frozen=True)
class Dims:
    """The widths a training step runs at, as the configuration states them."""

    vocab: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    batch: int
    seq: int
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq


def dims(config: Mapping[str, Any]) -> Dims:
    c, run = config, config["run"]
    return Dims(
        vocab=int(c["vocab_size"]), d_model=int(c["hidden_size"]),
        n_heads=int(c["num_attention_heads"]), n_layers=int(c["num_hidden_layers"]),
        d_ff=int(c["intermediate_size"]), batch=int(run["micro_batch"]),
        seq=int(run["seq_len"]), dtype=run["dtype"],
    )


def leaf_shapes(d: Dims) -> Dict[str, Leaf]:
    """The parameters by path, in the order the train state lists them:
    norm scales at one, every matrix drawn."""
    shapes: Dict[str, Leaf] = {"embed": Leaf((d.vocab, d.d_model), "normal")}
    for i in range(d.n_layers):
        p = f"layers/{i}/"
        shapes.update({
            p + "ln1_scale": Leaf((d.d_model,), "ones"), p + "ln2_scale": Leaf((d.d_model,), "ones"),
            p + "wqkv": Leaf((d.d_model, 3 * d.d_model), "normal"), p + "wo": Leaf((d.d_model, d.d_model), "normal"),
            p + "w_in": Leaf((d.d_model, d.d_ff), "normal"), p + "w_out": Leaf((d.d_ff, d.d_model), "normal"),
        })
    shapes["ln_f_scale"] = Leaf((d.d_model,), "ones")
    shapes["unembed"] = Leaf((d.d_model, d.vocab), "normal")
    return shapes


def build(d: Dims, run: Mapping[str, Any], seed: int, device: Any) -> Tuple[Any, Callable, Callable]:
    """The program's ``init_train_state`` and ``make_train_step``, as the
    configuration states them."""
    import torch
    from torchsnapshot_tpu_torch.models.transformer import (
        TransformerConfig, init_train_state, make_train_step, params_tree,
    )

    cfg = TransformerConfig(
        vocab_size=d.vocab, d_model=d.d_model, n_heads=d.n_heads, n_layers=d.n_layers,
        d_ff=d.d_ff, dtype=getattr(torch, d.dtype), learning_rate=run["adamw"]["lr"],
        attn_impl=run["attn_impl"],
    )
    state = init_train_state(cfg, seed=seed, device=device)
    return state, make_train_step(cfg), lambda s: flatten(params_tree(s.model))


def layer_matmul_params(d: Dims) -> int:
    """``wqkv`` (d, 3d), ``wo`` (d, d), ``w_in`` (d, f), ``w_out`` (f, d)."""
    return 4 * d.d_model * d.d_model + 2 * d.d_model * d.d_ff


def matmul_params(d: Dims) -> int:
    """Parameters that enter a matrix product: every block's projections
    and the unembedding. The embedding is a gather and the norm scales are
    elementwise, so neither counts."""
    return d.n_layers * layer_matmul_params(d) + d.d_model * d.vocab


def param_count(d: Dims) -> int:
    """Every parameter of the train state: the embedding and unembedding,
    each block's projections and two norm scales, and the final norm."""
    return 2 * d.vocab * d.d_model + d.n_layers * (layer_matmul_params(d) + 2 * d.d_model) + d.d_model


def leaf_count(d: Dims) -> int:
    """Tensors on the card: each parameter and its two AdamW moments."""
    return 3 * (3 + 6 * d.n_layers)


def state_bytes(d: Dims) -> int:
    """Parameters and both AdamW moments, all in the parameter dtype."""
    return 3 * param_count(d) * arith.BYTES_PER_ELEMENT[d.dtype]


def step_flops(d: Dims) -> float:
    """Model FLOPs of one training step, with no recompute: 6 x matmul
    parameters x tokens, plus causal attention's forward and backward,
    3 x 2 b s^2 d_model a layer."""
    attn = 3 * arith.attention_flops_fwd(d.batch, d.n_heads, d.seq, d.head_dim) * d.n_layers
    return 6.0 * matmul_params(d) * d.tokens_per_step + attn


def kernels(d: Dims) -> List[Kernel]:
    """Every layer's attention: the chunk kernel forward, ``ts_flash_bwd`` backward."""
    b, s, h, hd = d.batch, d.seq, d.n_heads, d.head_dim
    return [
        Kernel("flash_chunk", (FLASH_CHUNK,), FLASH_CHUNK, arith.flash_chunk_bound_s(b, s, h, hd)),
        Kernel("flash_bwd", FLASH_BWD, "flash_bwd_dkv_kernel", arith.flash_bwd_bound_s(b, s, h, hd)),
    ]


def tiny(config: Mapping[str, Any]) -> Dict[str, Any]:
    cfg = copy.deepcopy(dict(config))
    cfg.update(TINY)
    cfg["run"]["micro_batch"], cfg["run"]["seq_len"] = 2, 128
    return cfg
