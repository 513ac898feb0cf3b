"""The workload models of the port: the transformer (counterpart of
torchsnapshot_tpu.models) and LFM2-MoE (:mod:`.lfm2`, the port's own)."""

from . import lfm2
from .lfm2 import Lfm2, Lfm2Config
from .transformer import (
    TrainState,
    Transformer,
    TransformerConfig,
    block_forward,
    init_train_state,
    is_moe_layer,
    make_train_step,
    params_from_jax,
    params_tree,
)

__all__ = [
    "Lfm2",
    "Lfm2Config",
    "TrainState",
    "Transformer",
    "TransformerConfig",
    "block_forward",
    "init_train_state",
    "is_moe_layer",
    "lfm2",
    "make_train_step",
    "params_from_jax",
    "params_tree",
]
