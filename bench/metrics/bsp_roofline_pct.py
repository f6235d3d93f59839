"""bsp_roofline_pct.<traffic>: the least time the traced jobs or queries
could take at the card's peak memory bandwidth, over the device time of
every kernel in the traced stretch, in percent. The bytes are the
reference's count for each traced job (`reference.job_bytes`), never the
program's padded streams, so a kernel that skips or renames work is read
against the same work."""


def read(rec):
    tr = rec.device_trace
    peak = rec.peaks.get(rec.device_kind or "", {}).get("hbm_bytes_per_s")
    if tr is None or not rec.traced_bytes or not tr["kernel_s"] or not peak:
        return None
    return 100.0 * rec.traced_bytes / peak / tr["kernel_s"]
