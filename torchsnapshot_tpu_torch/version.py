"""Version of the torchsnapshot_tpu_torch package; the snapshot format is
torchsnapshot_tpu's of the same version."""

__version__ = "0.1.0"
