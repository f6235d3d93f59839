"""replication_factor: distinct (vertex, part) pairs over the vertices with
an edge, computed by the benchmark from the program's edge assignment."""


def read(rec):
    return rec.replication_factor
