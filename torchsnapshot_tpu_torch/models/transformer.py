"""The workload the benchmarks checkpoint: a decoder-only transformer LM.

Counterpart of ``torchsnapshot_tpu/models/transformer.py`` for one device:
the same parameters under the same names and layouts (``wqkv`` is
``(d_model, 3 * d_model)``, ``y = x @ W``, never ``nn.Linear``'s
transposed weight), so manifest paths and shapes of the two packages
compare entry by entry. The numerics follow the JAX module: RMSNorm's
rsqrt in f32 cast to the activation dtype before the products, tanh GELU
(``jax.nn.gelu``'s default), the mean integer-label cross-entropy over
``tokens[:, 1:]`` computed in f32 (:mod:`..ops.cross_entropy`: on the card
from the bf16 logits, with no f32 copy of them), and AdamW with optax's defaults
(``weight_decay=1e-4``, ``eps=1e-8``, betas ``(0.9, 0.999)``), its moments
kept in the parameter dtype as ``optax.adamw`` keeps them.

With ``n_experts > 0`` every ``moe_every``-th block is a soft-routed MoE
block, as in the JAX module: a ``router`` ``(d_model, n_experts)`` and
expert-stacked ``w_in`` ``(n_experts, d_model, d_ff)`` and ``w_out``
``(n_experts, d_ff, d_model)``; every expert runs on every token and the
f32 softmax of the router's logits combines their outputs. Those products
are plain einsums here as there (no kernel of the JAX package computes
them).

Sequence parallel (``attn_impl="ring"`` or ``"ring_flash"``, the JAX
module's ``forward`` with a mesh): given a ``DeviceMesh`` with an ``sp``
dimension, each rank embeds and runs its own block of the sequence;
attention is the ring (:mod:`..ops.ring_attention`), everything else is
position-local (the model has no position embedding). :func:`loss_fn`
scores each rank's block against the next tokens, normalized by the
global count, and the step sums the loss and the replicated gradients
over ``sp`` in rank order before AdamW, so that every rank's state stays
bit-identical. Without a mesh, ``ring`` and ``ring_flash`` run the dense
attention, as in the JAX module. The JAX module's GSPMD layouts over
``dp`` and ``tp`` are not ported: the port's other layouts are ``DTensor``
trees built by the caller (expert parallel: the expert-stacked leaves
``Shard(0)``) or :mod:`..parallel.pipeline`'s stage stacks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import causal_attention
from ..ops.cross_entropy import cross_entropy
from ..ops.flash_attention import flash_causal_attention
from ..ops.ring_attention import ring_causal_attention, sp_size
from ..serialization import tensor_from_numpy
from ..state_dict import load_tree_into
from ..utils.device import Device, resolve_device  # noqa: F401 - re-export


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    n_experts: int = 0  # 0 = dense MLP in every block
    moe_every: int = 2  # every k-th block is MoE (when n_experts > 0)
    dtype: torch.dtype = torch.bfloat16
    learning_rate: float = 1e-3
    # "ulysses": the dense einsum attention (ops/attention.py); "flash": the
    # flash kernels (ops/flash_attention.py; needs seq % 128 == 0); "ring" /
    # "ring_flash": the ring over a mesh's sp dimension, each step einsums
    # or the chunk kernel (ops/ring_attention.py; ring_flash needs
    # seq_local % 64 == 0); without a mesh, the dense attention.
    attn_impl: str = "ulysses"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale


def is_moe_layer(cfg: TransformerConfig, i: int) -> bool:
    return cfg.n_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1


DENSE_NAMES = ("ln1_scale", "ln2_scale", "wqkv", "wo", "w_in", "w_out")
MOE_NAMES = ("ln1_scale", "ln2_scale", "wqkv", "wo", "router", "w_in", "w_out")


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device, moe: bool = False) -> None:
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

        def p(*shape: int) -> nn.Parameter:
            return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device))

        self.ln1_scale = p(d)
        self.ln2_scale = p(d)
        self.wqkv = p(d, 3 * d)
        self.wo = p(d, d)
        if moe:
            self.router = p(d, e)
            self.w_in = p(e, d, f)
            self.w_out = p(e, f, d)
        else:
            self.w_in = p(d, f)
            self.w_out = p(f, d)
        self.names = MOE_NAMES if moe else DENSE_NAMES

    def tree(self) -> Dict[str, torch.Tensor]:
        """The block's leaves by their JAX names (live parameters)."""
        return {n: getattr(self, n) for n in self.names}


def _moe_mlp(block: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Soft-routed MoE, the JAX ``_moe_mlp``: the router's logits and
    softmax in f32 (jnp promotes the bf16 x f32 einsum), the gates cast to
    the activation dtype, every expert on every token, the outputs
    gate-combined."""
    logits = torch.einsum("bsd,de->bse", x.float(), block["router"].float())
    gates = torch.softmax(logits, dim=-1).to(x.dtype)
    h = F.gelu(torch.einsum("bsd,edf->ebsf", x, block["w_in"]), approximate="tanh")
    y = torch.einsum("ebsf,efd->ebsd", h, block["w_out"])
    return torch.einsum("ebsd,bse->bsd", y, gates)


RING_IMPLS = ("ring", "ring_flash")
ATTN_IMPLS = ("ulysses", "flash") + RING_IMPLS


def block_forward(
    cfg: TransformerConfig, block: Mapping[str, torch.Tensor], x: torch.Tensor, mesh: Any = None
) -> torch.Tensor:
    """One transformer block on ``(batch, seq, d_model)`` activations, its
    leaves given by their JAX names (a ``Block.tree()``, or one stage's
    slice of pipeline-stacked leaves); MoE iff it holds a ``router``. With
    ``mesh`` and a ring ``attn_impl``, ``x`` is this rank's sequence block."""
    b, s, d = x.shape
    h = _rmsnorm(x, block["ln1_scale"])
    qkv = (h @ block["wqkv"]).reshape(b, s, 3, cfg.n_heads, cfg.head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if cfg.attn_impl in RING_IMPLS and mesh is not None:
        attn = ring_causal_attention(q, k, v, mesh=mesh, use_flash=cfg.attn_impl == "ring_flash")
    elif cfg.attn_impl == "flash":
        if s % 128:
            raise ValueError(
                f"attn_impl='flash' requires seq % 128 == 0, got seq={s}; "
                f"pad the sequence or use attn_impl='ulysses'"
            )
        attn = flash_causal_attention(q, k, v)
    else:
        attn = causal_attention(q, k, v)
    x = x + attn.reshape(b, s, d) @ block["wo"]
    h = _rmsnorm(x, block["ln2_scale"])
    if "router" in block:
        return x + _moe_mlp(block, h)
    return x + F.gelu(h @ block["w_in"], approximate="tanh") @ block["w_out"]


class Transformer(nn.Module):
    """Token ids ``(batch, seq)`` -> f32 logits ``(batch, seq, vocab)``."""

    def __init__(self, cfg: TransformerConfig, device: Device = None, seed: int = 0) -> None:
        super().__init__()
        if cfg.n_experts < 0 or cfg.moe_every < 1:
            raise ValueError(f"need n_experts >= 0 and moe_every >= 1, got {cfg.n_experts}, {cfg.moe_every}")
        if cfg.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}; expected one of {ATTN_IMPLS}")
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=cfg.dtype, device=device)
        )
        self.layers = nn.ModuleList(
            Block(cfg, device, moe=is_moe_layer(cfg, i)) for i in range(cfg.n_layers)
        )
        self.ln_f_scale = nn.Parameter(torch.empty(cfg.d_model, dtype=cfg.dtype, device=device))
        self.unembed = nn.Parameter(
            torch.empty((cfg.d_model, cfg.vocab_size), dtype=cfg.dtype, device=device)
        )
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Scales to one, matrices to N(0, 1/fan_in) drawn in f32 from a
        generator seeded with ``seed`` (not jax.random's numbers)."""
        g = torch.Generator(device=self.embed.device).manual_seed(seed)
        for name, param in self.named_parameters():
            if name.endswith("_scale"):
                param.fill_(1.0)
            else:
                w = torch.empty(param.shape, dtype=torch.float32, device=param.device)
                w.normal_(generator=g).mul_(1.0 / math.sqrt(param.shape[-2]))
                param.copy_(w)

    def hidden(self, tokens: torch.Tensor, mesh: Any = None) -> torch.Tensor:
        """The final RMSNorm's output ``(batch, seq, d_model)``. With a
        ``mesh`` (ring ``attn_impl``), ``tokens`` and the output are this
        rank's sequence block (:func:`sequence_block`)."""
        x = F.embedding(tokens, self.embed)
        for blk in self.layers:
            x = block_forward(self.cfg, blk.tree(), x, mesh)
        return _rmsnorm(x, self.ln_f_scale)

    def forward(self, tokens: torch.Tensor, mesh: Any = None) -> torch.Tensor:
        """f32 logits of :meth:`hidden`'s output."""
        return (self.hidden(tokens, mesh) @ self.unembed).float()

    def tree(self) -> Dict[str, Any]:
        """The parameters as the JAX module's ``Params`` tree (live tensors)."""
        return {
            "embed": self.embed,
            "layers": [blk.tree() for blk in self.layers],
            "ln_f_scale": self.ln_f_scale,
            "unembed": self.unembed,
        }


def params_tree(model: Any) -> Dict[str, Any]:
    """A model's leaves as its state dict names them (live tensors): for a
    :class:`Transformer`, the JAX module's ``Params`` tree."""
    return model.tree()


def params_from_jax(cfg: TransformerConfig, jax_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``Transformer`` state dict from the JAX module's ``Params`` tree
    with numpy leaves (``jax.tree_util.tree_map(np.asarray, params)``)."""

    def t(a: Any) -> torch.Tensor:
        return tensor_from_numpy(np.array(a)).to(cfg.dtype)

    sd = {
        "embed": t(jax_params["embed"]),
        "ln_f_scale": t(jax_params["ln_f_scale"]),
        "unembed": t(jax_params["unembed"]),
    }
    for i, block in enumerate(jax_params["layers"]):
        for name, value in block.items():
            sd[f"layers.{i}.{name}"] = t(value)
    return sd


# ----------------------------------------------------------------------
# Training state + step
# ----------------------------------------------------------------------


def make_adamw(cfg: TransformerConfig, params: Iterable[torch.Tensor]) -> torch.optim.AdamW:
    """``optax.adamw(cfg.learning_rate)`` in torch over ``params``, its
    state made at once (as ``opt.init(params)`` makes it) so that a restore
    finds live moment tensors to write into."""
    params = list(params)
    opt = torch.optim.AdamW(
        params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
    )
    for p in params:
        opt.state[p] = {
            "step": torch.tensor(0.0, dtype=torch.float32),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
        }
    return opt


def make_optimizer(cfg: TransformerConfig, model: Transformer) -> torch.optim.AdamW:
    """The model's AdamW (:func:`make_adamw` over its parameters)."""
    return make_adamw(cfg, model.parameters())


@dataclasses.dataclass
class TrainState:
    """The checkpointable unit (a ``Stateful``): parameters, optimizer
    state, step counter and the training RNG. Its state dict mirrors the
    JAX ``TrainState.as_pytree()``: ``params`` is the model's ``tree()``
    (for a :class:`Transformer`, the JAX-named tree)."""

    model: Any
    optimizer: torch.optim.AdamW
    step: int
    rng: torch.Generator

    def state_dict(self) -> Dict[str, Any]:
        return {
            "params": params_tree(self.model),
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
            "rng": self.rng.get_state(),
        }

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        load_tree_into(params_tree(self.model), state_dict["params"])
        self.optimizer.load_state_dict(state_dict["opt_state"])
        self.step = int(state_dict["step"])
        self.rng.set_state(state_dict["rng"])


def init_train_state(cfg: TransformerConfig, seed: int = 0, device: Device = None) -> TrainState:
    device = resolve_device(device)
    model = Transformer(cfg, device=device, seed=seed)
    return TrainState(
        model=model,
        optimizer=make_optimizer(cfg, model),
        step=0,
        rng=torch.Generator(device=device).manual_seed(seed),
    )


def sequence_block(tokens: torch.Tensor, mesh: Any) -> torch.Tensor:
    """This rank's block of the global ``(batch, seq)`` tokens along the
    mesh's ``sp`` dimension."""
    n, r = sp_size(mesh), _sp_rank(mesh)
    seq = tokens.shape[1]
    if seq % n:
        raise ValueError(f"seq {seq} must divide over the {n} ranks of the sp dimension")
    s = seq // n
    return tokens[:, r * s:(r + 1) * s]


def _sp_rank(mesh: Any) -> int:
    return mesh.get_local_rank(mesh.mesh_dim_names.index("sp"))


def loss_fn(model: Transformer, tokens: torch.Tensor, mesh: Any = None) -> torch.Tensor:
    """The mean cross-entropy of the next token over the global
    ``(batch, seq)`` tokens. With a mesh of ``sp`` > 1 (ring ``attn_impl``)
    each rank returns its block's share: its positions' summed losses
    (the last global position has no target) over ``batch * (seq - 1)``,
    so that the ranks' shares sum to the mean. The logits are the scored
    positions' product alone, in the model's dtype, so that they are
    contiguous and never copied to f32 (:func:`~..ops.cross_entropy.cross_entropy`
    computes in f32)."""
    if model.cfg.attn_impl not in RING_IMPLS or sp_size(mesh) == 1:
        logits = model.hidden(tokens, mesh)[:, :-1] @ model.unembed
        return cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    block = sequence_block(tokens, mesh)
    b, s = block.shape
    start = _sp_rank(mesh) * s
    targets = tokens[:, start + 1:start + s + 1]
    logits = model.hidden(block, mesh)[:, :targets.shape[1]] @ model.unembed
    total = cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), reduction="sum")
    return total / (b * (tokens.shape[1] - 1))


def _sum_over_sp(mesh: Any, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the ``sp`` ranks, in rank order and in f32,
    back in its dtype: the same bits on every rank. One gather a dtype."""
    from ..parallel.pipeline import _Ring

    ring = _Ring(mesh, "sp")
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        parts = ring.gather(flat, kind="sp_sum")
        total = parts[0].float()
        for part in parts[1:]:
            total += part.float()
        total = total.to(dtype)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = total[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out  # type: ignore[return-value]


def make_train_step(
    cfg: TransformerConfig, mesh: Any = None,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """The full training step (forward, loss, backward, AdamW), updating
    ``state`` in place; returns it with the step's loss.

    With a ``DeviceMesh`` whose ``sp`` dimension has more than one rank
    (ring ``attn_impl``), every rank calls the step with the same global
    tokens; the loss and the gradients are summed over ``sp`` before AdamW,
    so every rank returns the global loss and keeps the same state. The
    mesh may have no other dimension of more than one rank."""
    sequence_parallel = cfg.attn_impl in RING_IMPLS and sp_size(mesh) > 1
    if sequence_parallel and any(
        mesh.size(i) > 1 for i, name in enumerate(mesh.mesh_dim_names) if name != "sp"
    ):
        raise ValueError(
            f"the sequence-parallel step sums over sp only; the mesh {mesh.mesh_dim_names} "
            f"{tuple(mesh.shape)} has another dimension of more than one rank"
        )

    def train_step(state: TrainState, tokens: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, tokens, mesh if sequence_parallel else None)
        loss.backward()
        if sequence_parallel:
            params = [p for p in state.model.parameters() if p.grad is not None]
            *grads, loss = _sum_over_sp(mesh, [p.grad for p in params] + [loss.detach()])
            for p, g in zip(params, grads):
                p.grad = g
        state.optimizer.step()
        # One draw per step, as the JAX step folds its key.
        torch.empty(1, device=state.model.embed.device).random_(generator=state.rng)
        state.step += 1
        return state, loss.detach()

    return train_step


def random_tokens(cfg: TransformerConfig, batch: int, seq: int, seed: int) -> np.ndarray:
    """Token ids drawn with numpy from ``seed`` (int64, ``(batch, seq)``)."""
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))

