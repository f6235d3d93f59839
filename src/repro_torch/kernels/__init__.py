"""repro_torch.kernels — the hand-written CUDA kernels (sources in `csrc/`),
their plain PyTorch versions, and the entry points in `ops`."""
