"""repro_torch.models — the language-model stack of the port (port of
`repro.models`): `config` (the model configurations), `layers` (norm,
RoPE, attention, MLP), `transformer` (the decoder-only stack: parameters,
forward, KV caches) and `steps` (the prefill and decode steps). The dense
decoder family runs here; the MoE, SSM/hybrid and encoder-decoder stacks
and the training step raise NotImplementedError, naming the slice that
brings them.
"""
