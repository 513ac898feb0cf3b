"""The workload model of the port (counterpart of torchsnapshot_tpu.models)."""

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
    "TrainState",
    "Transformer",
    "TransformerConfig",
    "block_forward",
    "init_train_state",
    "is_moe_layer",
    "make_train_step",
    "params_from_jax",
    "params_tree",
]
