"""The workload model of the port (counterpart of torchsnapshot_tpu.models)."""

from .transformer import (
    TrainState,
    Transformer,
    TransformerConfig,
    init_train_state,
    make_train_step,
    params_from_jax,
    params_tree,
)

__all__ = [
    "TrainState",
    "Transformer",
    "TransformerConfig",
    "init_train_state",
    "make_train_step",
    "params_from_jax",
    "params_tree",
]
