"""repro_torch.models — the language-model stack of the port (port of
`repro.models`): `config` (the model configurations), `layers` (norm,
RoPE, attention, MLP), `moe` (the mixture-of-experts FFN and its
expert-parallel dispatch), `ssm` (the mamba2 SSD mixer), `transformer`
(the decoder-only, hybrid and encoder-decoder stacks: parameters,
forward, the encoder, caches), `steps` (the train, prefill and decode
steps) and `pspec` (the activation-sharding context a DTensor run
constrains its activations by). Every config of the registry serves and
trains.
"""
