"""build_s: the benchmark's span around the facade's symmetric build,
ended by a device synchronize."""


def read(rec):
    return rec.spans.get("build")
