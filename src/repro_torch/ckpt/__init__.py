"""Checkpoints: `manager.CheckpointManager`, a directory of step snapshots
(manifest + npy shards, atomic, checksummed, async, keep-N) in the JAX
reference package's on-disk format."""
