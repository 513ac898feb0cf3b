"""LFM2-MoE (Liquid AI's LFM2-8B-A1B family): a hybrid decoder of gated
short convolutions and grouped-query attention, with sparse experts.

The layer equations (https://huggingface.co/LiquidAI/LFM2-8B-A1B):

- block: ``h = x + mixer(rmsnorm(x))``, then ``out = h + ffn(rmsnorm(h))``
  (leaves ``operator_norm``, ``ffn_norm``);
- short-conv mixer: ``B, C, x' = split3(x @ in_proj)`` (``in_proj``
  ``(d, 3d)``), ``y = C * causalconv_3(B * x')`` (``conv`` ``(3, d)``,
  taps by channels, no bias, :mod:`..ops.short_conv`), then ``@ out_proj``;
- attention mixer: ``q``, ``k``, ``v`` ``(d, heads x 64)``, ``(d, kv_heads x
  64)`` twice; an RMSNorm of each head of q and of k (``q_norm``,
  ``k_norm``, ``(64,)``); rotary embeddings (rotate-half, base
  ``rope_theta``, positions 0..s-1); causal softmax attention, each KV head
  shared by ``heads / kv_heads`` query heads; then ``@ o``;
- dense feed-forward (the first ``n_dense_layers``): ``w2(silu(x w1) * x
  w3)``;
- sparse feed-forward: ``s = sigmoid(x @ router)`` over all ``n_experts``;
  the ``top_k`` experts chosen on ``s + expert_bias``; their weights ``s``
  at the chosen experts over their sum; the weighted sum of the chosen
  experts' SwiGLU;
- a final RMSNorm and an LM head tied to the embedding; the loss is the
  mean next-token cross-entropy computed in f32, as the transformer's.

The conventions are the transformer's (:mod:`.transformer`): ``y = x @ W``
layouts, RMSNorm's rsqrt in f32 cast to the activation dtype, bf16
parameters and AdamW moments through :func:`~.transformer.make_adamw`,
and one :class:`~.transformer.TrainState`.

``expert_bias`` is a float32 ``(n_experts,)`` buffer of each sparse layer:
in the state, saved and restored, not given to AdamW. The published
configuration gives no rule for updating it, so the step leaves it as it
is. The router's product, sigmoid and top-k run in f32.

An expert layer holds the experts ``cfg.experts_held`` (a range of ids),
as one rank of expert parallelism does. It routes each token over all
``n_experts``, and computes, for the assignments that land on its own
experts, their weighted outputs (the weights normalised over all
``top_k`` chosen experts, as in the whole model). What absent experts
would add is left out; there is no exchange. The experts are stacks
``w1``, ``w3`` ``(held, d, f)`` and ``w2`` ``(held, f, d)``. Routing drops
no token and makes no host synchronisation: the assignments are sorted
by expert on the card into a buffer of every assignment's row, and a
grouped product (``torch._grouped_mm`` for bf16 on the card, a loop over
the groups elsewhere) runs each held expert over its rows, to
device-side offsets; rows past the held experts' are masked out. Each
token's rows are summed back in f32, in a fixed order.

Each step counts its routing on the card (:class:`MoeCounters`): the
assignments on held and on absent experts, and each sparse layer's
most-loaded held expert, alone and times the experts held. The counts go to pinned host memory without
blocking at the step's end, and reach the telemetry registry at a later
step, once a query of the copy's event says it is done.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .. import telemetry
from ..ops.cross_entropy import cross_entropy
from ..ops.flash_attention import flash_causal_attention
from ..ops.short_conv import gated_short_conv
from ..telemetry import names
from ..utils.device import Device, resolve_device
from .transformer import TrainState, make_adamw, params_tree  # noqa: F401 - params_tree re-exported

CONV, ATTENTION = "conv", "full_attention"
# LFM2-8B-A1B's published layer_types.
LFM2_8B_A1B_LAYER_TYPES = (
    CONV, CONV, ATTENTION, CONV, CONV, CONV, ATTENTION, CONV, CONV, CONV, ATTENTION, CONV,
    CONV, CONV, ATTENTION, CONV, CONV, CONV, ATTENTION, CONV, CONV, ATTENTION, CONV, CONV,
)


@dataclasses.dataclass(frozen=True)
class Lfm2Config:
    vocab_size: int = 65536
    d_model: int = 2048
    n_heads: int = 32
    n_kv_heads: int = 8
    layer_types: Tuple[str, ...] = LFM2_8B_A1B_LAYER_TYPES
    d_ff: int = 7168  # the dense layers' SwiGLU width
    n_dense_layers: int = 2
    moe_d_ff: int = 1792  # an expert's SwiGLU width
    n_experts: int = 32  # the router's outputs
    top_k: int = 4
    experts_held: range = range(0, 32)  # the expert ids this rank holds
    conv_kernel: int = 3
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    learning_rate: float = 1e-3

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return len(self.layer_types)

    def is_sparse(self, i: int) -> bool:
        return i >= self.n_dense_layers

    def validate(self) -> None:
        if any(t not in (CONV, ATTENTION) for t in self.layer_types):
            raise ValueError(f"layer_types must be {CONV!r} or {ATTENTION!r}, got {self.layer_types}")
        if self.conv_kernel != 3:
            raise ValueError(f"the short convolution has 3 taps, got conv_kernel={self.conv_kernel}")
        if self.d_model % self.n_heads or self.n_heads % self.n_kv_heads or self.head_dim % 2:
            raise ValueError(
                f"need d_model % n_heads == 0, n_heads % n_kv_heads == 0 and an even head dim; got "
                f"{self.d_model}, {self.n_heads}, {self.n_kv_heads}"
            )
        held = self.experts_held
        if held.step != 1 or len(held) < 1 or held.start < 0 or held.stop > self.n_experts:
            raise ValueError(f"experts_held must be a range of ids in [0, {self.n_experts}), got {held}")
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError(f"need 1 <= top_k <= n_experts, got {self.top_k}, {self.n_experts}")


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


class Lfm2Layer(nn.Module):
    """One block's leaves, by their published names."""

    def __init__(self, cfg: Lfm2Config, i: int, device: torch.device) -> None:
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim

        def p(*shape: int) -> nn.Parameter:
            return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device))

        self.kind = cfg.layer_types[i]
        self.sparse = cfg.is_sparse(i)
        self.operator_norm = p(d)
        if self.kind == CONV:
            self.in_proj, self.conv, self.out_proj = p(d, 3 * d), p(cfg.conv_kernel, d), p(d, d)
            mixer: Tuple[str, ...] = ("in_proj", "conv", "out_proj")
        else:
            self.q, self.k = p(d, cfg.n_heads * hd), p(d, cfg.n_kv_heads * hd)
            self.v, self.o = p(d, cfg.n_kv_heads * hd), p(cfg.n_heads * hd, d)
            self.q_norm, self.k_norm = p(hd), p(hd)
            mixer = ("q", "k", "v", "o", "q_norm", "k_norm")
        self.ffn_norm = p(d)
        if self.sparse:
            e, f = len(cfg.experts_held), cfg.moe_d_ff
            self.router = p(d, cfg.n_experts)
            self.register_buffer("expert_bias", torch.zeros(cfg.n_experts, dtype=torch.float32, device=device))
            self.w1, self.w3, self.w2 = p(e, d, f), p(e, d, f), p(e, f, d)
            ffn: Tuple[str, ...] = ("router", "expert_bias", "w1", "w3", "w2")
        else:
            self.w1, self.w3, self.w2 = p(d, cfg.d_ff), p(d, cfg.d_ff), p(cfg.d_ff, d)
            ffn = ("w1", "w3", "w2")
        self.names = ("operator_norm",) + mixer + ("ffn_norm",) + ffn

    def tree(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, n) for n in self.names}


# ----------------------------------------------------------------------
# Mixers and feed-forwards
# ----------------------------------------------------------------------


def rope_tables(s: int, head_dim: int, theta: float, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin ``(s, head_dim)`` of rotate-half rotary embeddings, f32."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    angles = torch.arange(s, dtype=torch.float32, device=device)[:, None] * inv[None]
    angles = torch.cat([angles, angles], dim=-1)
    return angles.cos(), angles.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` ``(b, s, heads, hd)`` by position, in f32, back in its dtype."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return (xf * cos[:, None] + rotated * sin[:, None]).to(x.dtype)


def conv_mixer(layer: Mapping[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    return gated_short_conv(h @ layer["in_proj"], layer["conv"]) @ layer["out_proj"]


def attention_mixer(
    cfg: Lfm2Config, layer: Mapping[str, torch.Tensor], h: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]
) -> torch.Tensor:
    """QK-norm and RoPE in plain torch, K and V repeated to every query head,
    then :func:`~..ops.flash_attention.flash_causal_attention` (the flash
    kernels on the card; ``seq`` a multiple of 128)."""
    b, s, _ = h.shape
    hd, kv, rep = cfg.head_dim, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q = _rmsnorm((h @ layer["q"]).view(b, s, cfg.n_heads, hd), layer["q_norm"], cfg.norm_eps)
    k = _rmsnorm((h @ layer["k"]).view(b, s, kv, hd), layer["k_norm"], cfg.norm_eps)
    v = (h @ layer["v"]).view(b, s, kv, hd)
    q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    k = k[:, :, :, None].expand(b, s, kv, rep, hd).reshape(b, s, cfg.n_heads, hd)
    v = v[:, :, :, None].expand(b, s, kv, rep, hd).reshape(b, s, cfg.n_heads, hd)
    return flash_causal_attention(q, k, v).reshape(b, s, cfg.n_heads * hd) @ layer["o"]


def dense_ffn(layer: Mapping[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    return (F.silu(h @ layer["w1"]) * (h @ layer["w3"])) @ layer["w2"]


def _on_card(a: torch.Tensor) -> bool:
    return a.device.type == "cuda" and a.dtype == torch.bfloat16


def _gmm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``(M, K) x (G, K, N) -> (M, N)``: rows ``offs[g-1]:offs[g]`` of ``a``
    times ``b[g]``. ``torch._grouped_mm`` for bf16 on the card, where rows
    past ``offs[-1]`` are unspecified; elsewhere a loop over the groups
    (reading ``offs`` on the host), those rows zero."""
    if _on_card(a):
        return torch._grouped_mm(a, b, offs=offs)
    out = torch.zeros((a.shape[0], b.shape[-1]), dtype=a.dtype, device=a.device)
    start = 0
    for g, end in enumerate(offs.tolist()):
        out[start:end] = a[start:end] @ b[g]
        start = end
    return out


def _gmm_weight(a: torch.Tensor, g: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``(M, K), (M, N) -> (G, K, N)``: each group's ``a[rows]^T g[rows]``."""
    if _on_card(a):
        return torch._grouped_mm(a.t(), g, offs=offs)
    out, start = [], 0
    for end in offs.tolist():
        out.append(a[start:end].t() @ g[start:end])
        start = end
    return torch.stack(out)


class _GroupedMM(torch.autograd.Function):
    """:func:`_gmm`, differentiable in ``a`` and ``b``."""

    @staticmethod
    def forward(ctx, a, b, offs):
        ctx.save_for_backward(a, b, offs)
        return _gmm(a, b, offs)

    @staticmethod
    def backward(ctx, grad):
        a, b, offs = ctx.saved_tensors
        grad = grad.contiguous()
        da = _gmm(grad, b.transpose(-2, -1), offs) if ctx.needs_input_grad[0] else None
        db = _gmm_weight(a, grad, offs) if ctx.needs_input_grad[1] else None
        return da, db, None


def grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    return _GroupedMM.apply(a, b, offs)


def _slot_sum(rows: torch.Tensor, slot_row: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's ``k`` rows of the assignment buffer summed, in f32."""
    return rows[slot_row].view(-1, k, rows.shape[-1]).sum(dim=1, dtype=torch.float32)


class _Dispatch(torch.autograd.Function):
    """The assignment buffer's rows, ``x[row_token]``. Its backward sums each
    token's ``k`` rows (a permutation, then a sum: no scatter of many rows
    into one), the rows past the held experts' taking no part: the grouped
    product leaves their gradient unspecified."""

    @staticmethod
    def forward(ctx, x, row_token, slot_row, valid, k):
        ctx.save_for_backward(slot_row, valid)
        ctx.k = k
        return x[row_token]

    @staticmethod
    def backward(ctx, grad):
        slot_row, valid = ctx.saved_tensors
        grad = torch.where(valid[:, None], grad, 0.0)
        return _slot_sum(grad, slot_row, ctx.k).to(grad.dtype), None, None, None, None


class _Combine(torch.autograd.Function):
    """Each token's ``k`` rows of the buffer summed in f32 (:func:`_slot_sum`);
    its backward hands each row its token's gradient."""

    @staticmethod
    def forward(ctx, y, row_token, slot_row, k):
        ctx.save_for_backward(row_token)
        ctx.dtype = y.dtype
        return _slot_sum(y, slot_row, k)

    @staticmethod
    def backward(ctx, grad):
        (row_token,) = ctx.saved_tensors
        return grad[row_token].to(ctx.dtype), None, None, None


def route(
    cfg: Lfm2Config, layer: Mapping[str, torch.Tensor], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(experts, weights)`` ``(T, top_k)`` of tokens ``x`` ``(T, d)``: the
    top-k of the sigmoid scores plus ``expert_bias``, weighted by the scores
    over their sum, in f32."""
    scores = torch.sigmoid(x.float() @ layer["router"].float())
    _, experts = torch.topk(scores + layer["expert_bias"], cfg.top_k, dim=-1)
    weights = scores.gather(1, experts)
    return experts, weights / weights.sum(dim=-1, keepdim=True)


def sparse_ffn(
    cfg: Lfm2Config, layer: Mapping[str, torch.Tensor], h: torch.Tensor, counts: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The held experts' part of the sparse feed-forward of ``h`` ``(b, s, d)``;
    adds the layer's routing counts into ``counts`` (see :class:`MoeCounters`)."""
    b, s, d = h.shape
    t, k = b * s, cfg.top_k
    held = len(cfg.experts_held)
    x = h.reshape(t, d)
    experts, weights = route(cfg, layer, x)
    local = experts.reshape(-1) - cfg.experts_held.start
    is_held = (local >= 0) & (local < held)
    # Each assignment's group: a held expert's local id, the absent ones last.
    key = torch.where(is_held, local, held)
    sorted_key, order = torch.sort(key, stable=True)
    per_group = torch.zeros(held + 1, dtype=torch.int64, device=x.device).scatter_add_(0, key, torch.ones_like(key))
    offs = per_group[:held].cumsum(0).to(torch.int32)
    valid = sorted_key < held
    # Row r of the buffer holds assignment order[r]: its token, and its
    # slot's weight where the expert is held (zero past the held rows).
    row_token = order // k
    slot_row = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=x.device))
    rows = _Dispatch.apply(x, row_token, slot_row, valid, k)
    a = F.silu(grouped_mm(rows, layer["w1"], offs)) * grouped_mm(rows, layer["w3"], offs)
    y = torch.where(valid[:, None], grouped_mm(a, layer["w2"], offs), 0.0)
    row_weight = torch.where(valid, weights.reshape(-1)[order], 0.0)
    out = _Combine.apply(y * row_weight[:, None].to(y.dtype), row_token, slot_row, k).to(h.dtype)
    if counts is not None:
        n_held, top = valid.sum(), per_group[:held].max()
        counts += torch.stack([n_held, t * k - n_held, top, top * held])
    return out.view(b, s, d)


def layer_forward(
    cfg: Lfm2Config, layer: Mapping[str, torch.Tensor], x: torch.Tensor,
    rope: Tuple[torch.Tensor, torch.Tensor], counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One block on ``(b, s, d)``; a conv block iff it holds ``conv``, sparse
    iff it holds a ``router``."""
    h = _rmsnorm(x, layer["operator_norm"], cfg.norm_eps)
    if "conv" in layer:
        with record_function(names.SPAN_LFM2_CONV):
            x = x + conv_mixer(layer, h)
    else:
        with record_function(names.SPAN_LFM2_ATTN):
            x = x + attention_mixer(cfg, layer, h, rope)
    h = _rmsnorm(x, layer["ffn_norm"], cfg.norm_eps)
    if "router" in layer:
        with record_function(names.SPAN_LFM2_MOE):
            return x + sparse_ffn(cfg, layer, h, counts)
    with record_function(names.SPAN_LFM2_FFN):
        return x + dense_ffn(layer, h)


class Lfm2(nn.Module):
    """Token ids ``(batch, seq)`` -> f32 logits ``(batch, seq, vocab)``."""

    def __init__(self, cfg: Lfm2Config, device: Device = None, seed: int = 0) -> None:
        super().__init__()
        cfg.validate()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab_size, cfg.d_model), dtype=cfg.dtype, device=device))
        self.layers = nn.ModuleList(Lfm2Layer(cfg, i, device) for i in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.d_model, dtype=cfg.dtype, device=device))
        self.counters = MoeCounters()
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Norm scales to one, ``expert_bias`` to zero, matrices and conv taps
        to N(0, 1/fan_in) (fan_in ``shape[-2]``) drawn in f32 from ``seed``."""
        g = torch.Generator(device=self.embed.device).manual_seed(seed)
        for name, param in self.named_parameters():
            if name.endswith("norm"):
                param.fill_(1.0)
            else:
                w = torch.empty(param.shape, dtype=torch.float32, device=param.device)
                param.copy_(w.normal_(generator=g).mul_(1.0 / math.sqrt(param.shape[-2])))
        for layer in self.layers:
            if layer.sparse:
                layer.expert_bias.zero_()

    def tree(self) -> Dict[str, Any]:
        """The leaves as the train state names them (live tensors)."""
        return {
            "embed": self.embed,
            "layers": [layer.tree() for layer in self.layers],
            "final_norm": self.final_norm,
        }

    def hidden(self, tokens: torch.Tensor, counts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The final RMSNorm's output ``(b, s, d)``."""
        cfg = self.cfg
        x = F.embedding(tokens, self.embed)
        rope = rope_tables(tokens.shape[1], cfg.head_dim, cfg.rope_theta, x.device)
        for layer in self.layers:
            x = layer_forward(cfg, layer.tree(), x, rope, counts)
        return _rmsnorm(x, self.final_norm, cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, counts: Optional[torch.Tensor] = None) -> torch.Tensor:
        return (self.hidden(tokens, counts) @ self.embed.t()).float()


def loss_fn(model: Lfm2, tokens: torch.Tensor, counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean next-token cross-entropy over ``tokens[:, 1:]``, computed in
    f32 (:func:`~..ops.cross_entropy.cross_entropy`) from the tied head's
    logits in the model's dtype."""
    x = model.hidden(tokens, counts)
    with record_function(names.SPAN_LFM2_LOSS):
        logits = x[:, :-1] @ model.embed.t()
        return cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))


# ----------------------------------------------------------------------
# Routing counters
# ----------------------------------------------------------------------


class MoeCounters:
    """A step's routing counts, summed on the card into one int64 ``(4,)``
    tensor (held assignments, absent assignments, the sum over sparse
    layers of the most-loaded held expert's tokens, and of those tokens
    times the layer's experts held), copied at the step's end to pinned
    host memory without blocking, and added to the registry
    (:data:`~..telemetry.names.MOE_ASSIGNMENTS_TOTAL`,
    :data:`~..telemetry.names.MOE_HELD_MAX_TOKENS_TOTAL`,
    :data:`~..telemetry.names.MOE_HELD_MAX_TOKENS_SCALED_TOTAL`) by a later
    :meth:`publish`, once a query of the copy's event (which never waits)
    says it is done. On the CPU the counts are the host's already and
    are published at the next step all the same."""

    def __init__(self) -> None:
        self._pending: Deque[Tuple[Optional[torch.cuda.Event], torch.Tensor]] = collections.deque()
        self._free: List[torch.Tensor] = []

    @staticmethod
    def begin(device: torch.device) -> torch.Tensor:
        return torch.zeros(4, dtype=torch.int64, device=device)

    def end(self, counts: torch.Tensor) -> None:
        if counts.device.type != "cuda":
            self._pending.append((None, counts))
            return
        host = self._free.pop() if self._free else torch.empty(4, dtype=torch.int64, pin_memory=True)
        host.copy_(counts, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(counts.device))
        self._pending.append((event, host))

    def publish(self) -> int:
        """Add every finished step's counts, oldest first; returns how many
        steps were added."""
        added = 0
        while self._pending and (self._pending[0][0] is None or self._pending[0][0].query()):
            event, host = self._pending.popleft()
            held, absent, top, scaled = (int(v) for v in host.numpy())
            if event is not None:
                self._free.append(host)
            added += 1
            if held + absent == 0:
                continue
            registry = telemetry.metrics()
            registry.counter_inc(names.MOE_ASSIGNMENTS_TOTAL, held, held="1")
            registry.counter_inc(names.MOE_ASSIGNMENTS_TOTAL, absent, held="0")
            registry.counter_inc(names.MOE_HELD_MAX_TOKENS_TOTAL, top)
            registry.counter_inc(names.MOE_HELD_MAX_TOKENS_SCALED_TOTAL, scaled)
        return added


# ----------------------------------------------------------------------
# Training state + step
# ----------------------------------------------------------------------


def init_train_state(cfg: Lfm2Config, seed: int = 0, device: Device = None) -> TrainState:
    """The model, AdamW over its parameters (``expert_bias`` is a buffer,
    not among them), step 0 and the training RNG."""
    device = resolve_device(device)
    model = Lfm2(cfg, device=device, seed=seed)
    return TrainState(
        model=model,
        optimizer=make_adamw(cfg, model.parameters()),
        step=0,
        rng=torch.Generator(device=device).manual_seed(seed),
    )


def make_train_step(cfg: Lfm2Config) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """The full training step (forward, loss, backward, AdamW), updating
    ``state`` in place; returns it with the step's loss. It publishes the
    routing counts of earlier steps that have reached the host, and makes
    no host synchronisation."""

    def train_step(state: TrainState, tokens: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        model = state.model
        model.counters.publish()
        state.optimizer.zero_grad(set_to_none=True)
        counts = MoeCounters.begin(tokens.device)
        loss = loss_fn(model, tokens, counts)
        loss.backward()
        state.optimizer.step()
        model.counters.end(counts)
        # One draw per step, as the transformer's step.
        torch.empty(1, device=model.embed.device).random_(generator=state.rng)
        state.step += 1
        return state, loss.detach()

    return train_step
