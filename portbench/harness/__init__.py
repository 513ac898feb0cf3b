"""The port's benchmark harness: discovery, the training loop that
checkpoints, the trace reduction and the comparison that decides
``correct``. Nothing here imports JAX or the JAX package."""
