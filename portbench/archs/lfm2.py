"""The port's LFM2-MoE (``torchsnapshot_tpu_torch/models/lfm2.py``) at a
configuration's published keys: ``hidden_size``, ``num_attention_heads``,
``num_key_value_heads``, ``layer_types`` (its length is
``num_hidden_layers``), ``intermediate_size`` (the dense layers' SwiGLU),
``num_dense_layers``, ``moe_intermediate_size``, ``num_experts_per_tok``,
``conv_L_cache``, ``rope_theta``, ``norm_eps``, ``vocab_size``. Experts are a
chip's share: ``num_experts`` is how many this chip holds, from
``experts_first``, of the router's ``published["num_experts"]``. Its plain
reference is ``reference/lfm2.py``. What an adapter gives: ``harness/arch.py``.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Tuple

from harness import arith
from harness.arch import Kernel, Leaf
from harness.data import flatten

reference = "lfm2"

# The attention kernels, as archs/dense.py names them: the forward's chunk
# kernel (FUSED false) and ts_flash_bwd's stats, dK/dV and dQ kernels.
FLASH_CHUNK = r"flash_wgmma_kernel<(?:(?!>\().)*,\s*false\s*>?(?=>\(|$)"
FLASH_BWD = ("flash_bwd_stats_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
# csrc/short_conv.cu: the forward, and the backward with its tap-gradient
# reduction; one forward launch a call.
SHORT_CONV = ("short_conv_fwd_kernel", "short_conv_bwd_kernel", "short_conv_dw_reduce_kernel")
# The CPU tests' size: width 64, 4 query and 2 KV heads of 16, one dense
# and three sparse layers (conv, attention, conv, conv), 4 of 8 experts
# held, top-2, a vocabulary of 512, two sequences of 128 tokens.
TINY = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 4,
    "layer_types": ["conv", "full_attention", "conv", "conv"], "intermediate_size": 128,
    "num_dense_layers": 1, "moe_intermediate_size": 32, "num_experts": 4, "num_experts_per_tok": 2,
    "vocab_size": 512,
}


@dataclass(frozen=True)
class Dims:
    """The widths a training step runs at, as the configuration states them."""

    vocab: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    layer_types: Tuple[str, ...]
    d_ff: int
    n_dense: int
    moe_d_ff: int
    n_experts: int  # the router's outputs
    experts_first: int
    experts_held: int
    top_k: int
    conv_kernel: int
    rope_theta: float
    norm_eps: float
    batch: int
    seq: int
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return len(self.layer_types)

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq


def dims(config: Mapping[str, Any]) -> Dims:
    c, run = config, config["run"]
    layer_types = tuple(c["layer_types"])
    if len(layer_types) != int(c["num_hidden_layers"]):
        raise ValueError(f"layer_types has {len(layer_types)} entries, num_hidden_layers {c['num_hidden_layers']}")
    return Dims(
        vocab=int(c["vocab_size"]), d_model=int(c["hidden_size"]), n_heads=int(c["num_attention_heads"]),
        n_kv_heads=int(c["num_key_value_heads"]), layer_types=layer_types,
        d_ff=int(c["intermediate_size"]), n_dense=int(c["num_dense_layers"]),
        moe_d_ff=int(c["moe_intermediate_size"]), n_experts=int(c["published"]["num_experts"]),
        experts_first=int(c["experts_first"]), experts_held=int(c["num_experts"]),
        top_k=int(c["num_experts_per_tok"]), conv_kernel=int(c["conv_L_cache"]),
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["norm_eps"]),
        batch=int(run["micro_batch"]), seq=int(run["seq_len"]), dtype=run["dtype"],
    )


def leaf_shapes(d: Dims) -> Dict[str, Leaf]:
    """The parameters by path, in the order the train state lists them:
    norm scales at one, ``expert_bias`` (float32, not trained) at zero,
    every matrix, expert stack and conv tap drawn."""
    m, hd = d.d_model, d.head_dim
    shapes: Dict[str, Leaf] = {"embed": Leaf((d.vocab, m), "normal")}
    for i, kind in enumerate(d.layer_types):
        p = f"layers/{i}/"
        shapes[p + "operator_norm"] = Leaf((m,), "ones")
        if kind == "conv":
            shapes.update({
                p + "in_proj": Leaf((m, 3 * m), "normal"), p + "conv": Leaf((d.conv_kernel, m), "normal"),
                p + "out_proj": Leaf((m, m), "normal"),
            })
        else:
            shapes.update({
                p + "q": Leaf((m, d.n_heads * hd), "normal"), p + "k": Leaf((m, d.n_kv_heads * hd), "normal"),
                p + "v": Leaf((m, d.n_kv_heads * hd), "normal"), p + "o": Leaf((d.n_heads * hd, m), "normal"),
                p + "q_norm": Leaf((hd,), "ones"), p + "k_norm": Leaf((hd,), "ones"),
            })
        shapes[p + "ffn_norm"] = Leaf((m,), "ones")
        if i >= d.n_dense:
            e, f = d.experts_held, d.moe_d_ff
            shapes.update({
                p + "router": Leaf((m, d.n_experts), "normal"),
                p + "expert_bias": Leaf((d.n_experts,), "zeros", trained=False, dtype="float32"),
                p + "w1": Leaf((e, m, f), "normal"), p + "w3": Leaf((e, m, f), "normal"),
                p + "w2": Leaf((e, f, m), "normal"),
            })
        else:
            shapes.update({
                p + "w1": Leaf((m, d.d_ff), "normal"), p + "w3": Leaf((m, d.d_ff), "normal"),
                p + "w2": Leaf((d.d_ff, m), "normal"),
            })
    shapes["final_norm"] = Leaf((m,), "ones")
    return shapes


def build(d: Dims, run: Mapping[str, Any], seed: int, device: Any) -> Tuple[Any, Callable, Callable]:
    """The program's ``init_train_state`` and ``make_train_step``, as the
    configuration states them."""
    import torch
    from torchsnapshot_tpu_torch.models.lfm2 import Lfm2Config, init_train_state, make_train_step, params_tree

    if run["attn_impl"] != "flash":
        raise ValueError(f"the LFM2 model's attention is the flash kernels; the configuration asks {run['attn_impl']!r}")
    cfg = Lfm2Config(
        vocab_size=d.vocab, d_model=d.d_model, n_heads=d.n_heads, n_kv_heads=d.n_kv_heads,
        layer_types=d.layer_types, d_ff=d.d_ff, n_dense_layers=d.n_dense, moe_d_ff=d.moe_d_ff,
        n_experts=d.n_experts, top_k=d.top_k,
        experts_held=range(d.experts_first, d.experts_first + d.experts_held),
        conv_kernel=d.conv_kernel, rope_theta=d.rope_theta, norm_eps=d.norm_eps,
        dtype=getattr(torch, d.dtype), learning_rate=run["adamw"]["lr"],
    )
    state = init_train_state(cfg, seed=seed, device=device)
    return state, make_train_step(cfg), lambda s: flatten(params_tree(s.model))


def _numel(leaves: Mapping[str, Leaf], trained: bool) -> int:
    return sum(math.prod(leaf.shape) for leaf in leaves.values() if leaf.trained is trained)


def param_count(d: Dims) -> int:
    """The parameters AdamW trains; the frozen ``expert_bias`` buffers are
    state (``state_bytes``) but not parameters."""
    return _numel(leaf_shapes(d), True)


def leaf_count(d: Dims) -> int:
    """Tensors on the card: each trained parameter and its two AdamW
    moments, and each frozen buffer once."""
    leaves = leaf_shapes(d)
    trained = sum(leaf.trained for leaf in leaves.values())
    return 3 * trained + len(leaves) - trained


def state_bytes(d: Dims) -> int:
    """Trained parameters and both moments in the parameter dtype, and the
    float32 buffers once."""
    leaves = leaf_shapes(d)
    return 3 * _numel(leaves, True) * arith.BYTES_PER_ELEMENT[d.dtype] + 4 * _numel(leaves, False)


def matmul_params_per_token(d: Dims) -> float:
    """Parameters a token meets in a matrix product: every projection, the
    dense SwiGLUs, each sparse layer's router and its expected held
    experts (top_k x held / router outputs of one expert's three
    matrices: the tokens x 4 x 8 / 32 assignments a step that land here,
    where routing is even), and the tied head. The embedding is a gather,
    the conv taps depthwise (3 multiply-adds a channel) and the norms
    elementwise, so none counts."""
    m, hd = d.d_model, d.head_dim
    total = float(m * d.vocab)
    for i, kind in enumerate(d.layer_types):
        if kind == "conv":
            total += 4 * m * m
        else:
            total += 2 * m * (d.n_heads + d.n_kv_heads) * hd
        if i >= d.n_dense:
            total += m * d.n_experts + d.top_k * d.experts_held / d.n_experts * 3 * m * d.moe_d_ff
        else:
            total += 3 * m * d.d_ff
    return total


def step_flops(d: Dims) -> float:
    """Model FLOPs of one training step, with no recompute: 6 x the matmul
    parameters a token meets x tokens, plus causal attention's forward
    and backward (3 x 2 b s^2 heads x head_dim a layer, at every query head)."""
    n_attn = sum(kind != "conv" for kind in d.layer_types)
    attn = 3 * arith.attention_flops_fwd(d.batch, d.n_heads, d.seq, d.head_dim) * n_attn
    return 6.0 * matmul_params_per_token(d) * d.tokens_per_step + attn


def short_conv_bytes(tokens: int, d_model: int, itemsize: int = 2) -> int:
    """One layer's short convolution, forward and backward: P (3d) read and
    y (d) written; P and dy read and dP written (7d), a token."""
    return 11 * tokens * d_model * itemsize


def short_conv_bound_s(tokens: int, d_model: int, itemsize: int = 2) -> float:
    """The least time a call (forward and backward) could take: its bytes
    over HBM bandwidth (its arithmetic is a few FMAs an element)."""
    return short_conv_bytes(tokens, d_model, itemsize) / arith.HBM_BYTES_PER_S


def kernels(d: Dims) -> List[Kernel]:
    """Each attention layer's chunk kernel forward and ``ts_flash_bwd``
    backward at every query head (K and V repeated), and each conv layer's
    short convolution."""
    b, s, h, hd = d.batch, d.seq, d.n_heads, d.head_dim
    return [
        Kernel("flash_chunk", (FLASH_CHUNK,), FLASH_CHUNK, arith.flash_chunk_bound_s(b, s, h, hd)),
        Kernel("flash_bwd", FLASH_BWD, "flash_bwd_dkv_kernel", arith.flash_bwd_bound_s(b, s, h, hd)),
        Kernel("short_conv", SHORT_CONV, "short_conv_fwd_kernel", short_conv_bound_s(b * s, d.d_model)),
    ]


def tiny(config: Mapping[str, Any]) -> Dict[str, Any]:
    cfg = copy.deepcopy(dict(config))
    cfg.update(copy.deepcopy(TINY))
    cfg["published"] = dict(cfg["published"], num_experts=2 * TINY["num_experts"])
    cfg["experts_first"] = 0
    cfg["run"]["micro_batch"], cfg["run"]["seq_len"] = 2, 128
    return cfg
