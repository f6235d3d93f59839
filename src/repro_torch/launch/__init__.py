"""repro_torch.launch — command-line drivers and device meshes of the port
(port of `repro.launch`): `graph_serve` replays a synthetic query trace
through the graph-query server; `mesh` makes the `torch.distributed`
device meshes the distributed engine runs on."""
