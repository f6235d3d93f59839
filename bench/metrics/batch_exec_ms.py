"""batch_exec_ms: the mean wall of the server's batches in the window, as
its batch log times them (init, the captured loop, the copy back). The
mean, not the median: BFS and SSSP batches take about 85 and 200 ms, and
with half the batches of each the median jumps between the two."""


def read(rec):
    if not rec.batch_log:
        return None
    return 1e3 * sum(wall for _, _, _, wall in rec.batch_log) / len(rec.batch_log)
