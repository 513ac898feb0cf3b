"""The workload the benchmarks checkpoint: a decoder-only transformer LM.

Counterpart of ``torchsnapshot_tpu/models/transformer.py`` for one device:
the same parameters under the same names and layouts (``wqkv`` is
``(d_model, 3 * d_model)``, ``y = x @ W``, never ``nn.Linear``'s
transposed weight), so manifest paths and shapes of the two packages
compare entry by entry. The numerics follow the JAX module: RMSNorm's
rsqrt in f32 cast to the activation dtype before the products, tanh GELU
(``jax.nn.gelu``'s default), f32 logits, the mean integer-label
cross-entropy over ``tokens[:, 1:]``, and AdamW with optax's defaults
(``weight_decay=1e-4``, ``eps=1e-8``, betas ``(0.9, 0.999)``), its moments
kept in the parameter dtype as ``optax.adamw`` keeps them.

Dense blocks only: the MoE blocks, the sharded mesh layouts and the ring
attention variants of the JAX module are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import causal_attention
from ..ops.flash_attention import flash_causal_attention
from ..serialization import tensor_from_numpy
from ..state_dict import load_tree_into

Device = Union[str, torch.device, None]


def resolve_device(device: Device) -> torch.device:
    """``None`` means the CUDA card; without one that raises unless the
    caller asked for the CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: torchsnapshot_tpu_torch's models run on the card; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    n_experts: int = 0  # MoE blocks are not ported: 0 only
    dtype: torch.dtype = torch.bfloat16
    learning_rate: float = 1e-3
    # "ulysses": the dense einsum attention (ops/attention.py); "flash": the
    # flash kernels (ops/flash_attention.py; needs seq % 128 == 0).
    attn_impl: str = "ulysses"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device) -> None:
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff

        def p(*shape: int) -> nn.Parameter:
            return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device))

        self.ln1_scale = p(d)
        self.ln2_scale = p(d)
        self.wqkv = p(d, 3 * d)
        self.wo = p(d, d)
        self.w_in = p(d, f)
        self.w_out = p(f, d)


class Transformer(nn.Module):
    """Token ids ``(batch, seq)`` -> f32 logits ``(batch, seq, vocab)``."""

    def __init__(self, cfg: TransformerConfig, device: Device = None, seed: int = 0) -> None:
        super().__init__()
        if cfg.n_experts:
            raise NotImplementedError("MoE blocks are not ported yet (n_experts must be 0)")
        if cfg.attn_impl not in ("ulysses", "flash"):
            raise ValueError(
                f"unknown or unported attn_impl {cfg.attn_impl!r}; expected 'ulysses' or 'flash'"
            )
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=cfg.dtype, device=device)
        )
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
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

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = F.embedding(tokens, self.embed)
        b, s, d = x.shape
        for blk in self.layers:
            h = _rmsnorm(x, blk.ln1_scale)
            qkv = (h @ blk.wqkv).reshape(b, s, 3, cfg.n_heads, cfg.head_dim)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if cfg.attn_impl == "flash":
                if s % 128:
                    raise ValueError(
                        f"attn_impl='flash' requires seq % 128 == 0, got seq={s}; "
                        f"pad the sequence or use attn_impl='ulysses'"
                    )
                attn = flash_causal_attention(q, k, v)
            else:
                attn = causal_attention(q, k, v)
            x = x + attn.reshape(b, s, d) @ blk.wo
            h = _rmsnorm(x, blk.ln2_scale)
            x = x + F.gelu(h @ blk.w_in, approximate="tanh") @ blk.w_out
        x = _rmsnorm(x, self.ln_f_scale)
        return (x @ self.unembed).float()


def params_tree(model: Transformer) -> Dict[str, Any]:
    """The parameters as the JAX module's ``Params`` tree (live tensors)."""
    return {
        "embed": model.embed,
        "layers": [
            {n: getattr(blk, n) for n in ("ln1_scale", "ln2_scale", "wqkv", "wo", "w_in", "w_out")}
            for blk in model.layers
        ],
        "ln_f_scale": model.ln_f_scale,
        "unembed": model.unembed,
    }


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


def make_optimizer(cfg: TransformerConfig, model: Transformer) -> torch.optim.AdamW:
    """``optax.adamw(cfg.learning_rate)`` in torch, its state made at once
    (as ``opt.init(params)`` makes it) so that a restore finds live moment
    tensors to write into."""
    opt = torch.optim.AdamW(
        model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4,
    )
    for p in model.parameters():
        opt.state[p] = {
            "step": torch.tensor(0.0, dtype=torch.float32),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
        }
    return opt


@dataclasses.dataclass
class TrainState:
    """The checkpointable unit (a ``Stateful``): parameters, optimizer
    state, step counter and the training RNG. Its state dict mirrors the
    JAX ``TrainState.as_pytree()``: ``params`` is the JAX-named tree."""

    model: Transformer
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


def loss_fn(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    logits = model(tokens)[:, :-1]
    return F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1)
    )


def make_train_step(
    cfg: TransformerConfig,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """The full training step (forward, loss, backward, AdamW), updating
    ``state`` in place; returns it with the step's loss."""

    def train_step(state: TrainState, tokens: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, tokens)
        loss.backward()
        state.optimizer.step()
        # One draw per step, as the JAX step folds its key.
        torch.empty(1, device=state.model.embed.device).random_(generator=state.rng)
        state.step += 1
        return state, loss.detach()

    return train_step


def random_tokens(cfg: TransformerConfig, batch: int, seq: int, seed: int) -> np.ndarray:
    """Token ids drawn with numpy from ``seed`` (int64, ``(batch, seq)``)."""
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))

