"""Framework integrations and the migration bridge (counterpart of
``torchsnapshot_tpu/tricks/``).

- :mod:`.torch` — ``TorchStateful``, the JAX package's bridge class for
  torch modules, optimizers and plain state dicts. The port checkpoints
  torch state natively; the class keeps the bridge's contract so that code
  written against it works by changing the import.
- :mod:`.torchsnapshot_reader` — read snapshots written by the reference
  TorchSnapshot 0.0.3 onto the card (or the CPU), and place their sharded
  entries as ``DTensor``s.
- :mod:`.torchsnapshot_writer` — write the reference's format (world
  size 1), an escape hatch back to the reference's tooling.
- :mod:`.convert` — convert a reference-format snapshot to the native one
  (``python -m torchsnapshot_tpu_torch.tricks.convert SRC DST``).

The JAX package's ``flax.py`` and ``orbax.py`` adapt JAX-ecosystem
formats and have no port; their torch counterpart, interop with
``torch.distributed.checkpoint``, is still to come.
"""
