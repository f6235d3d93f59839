"""partition_s: the benchmark's span around the facade's
`.partition(...).result`, ended by a device synchronize."""


def read(rec):
    return rec.spans.get("partition")
