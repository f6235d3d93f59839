"""repro_torch.data — the on-disk edge-shard store of the out-of-core
pipeline (`edgeshards`), in the reference's format."""
