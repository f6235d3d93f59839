"""evps: LDBC Graphalytics' edges and vertices a second, (|V| + |E|) times
the jobs completed, over the window's seconds."""


def read(rec):
    if not rec.jobs:
        return None
    return rec.ev_per_job * rec.jobs / rec.window_s
