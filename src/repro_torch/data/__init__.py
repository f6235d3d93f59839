"""repro_torch.data — the on-disk edge-shard store of the out-of-core
pipeline (`edgeshards`), in the reference's format, and the deterministic
synthetic token pipeline of LM training (`pipeline`), the reference's
random bits."""
