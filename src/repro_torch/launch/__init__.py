"""repro_torch.launch — command-line drivers of the port (port of
`repro.launch`): `graph_serve` replays a synthetic query trace through
the graph-query server."""
