"""repro_torch.launch — command-line drivers and device meshes of the port
(port of `repro.launch`): `graph_serve` replays a synthetic query trace
through the graph-query server; `serve` prefills and greedily decodes a
batch of prompts on an LM; `train` trains an LM on the synthetic token
pipeline with checkpoint/restart (and holds the presets both share);
`mesh` makes the `torch.distributed` device meshes the distributed engine
runs on (and the fake world of the dry-runs); `graph_dryrun` runs rank 0 of
the graph engine's production world on a Friendster-scale shard, with
`roofline`'s collective recorder and H100 roofline terms; `shapes`,
`sharding`, `plans` and `dryrun` lay an LM cell out at production scale as
DTensors and cost one step on one device; `elastic` reshards a checkpoint
onto another mesh."""
