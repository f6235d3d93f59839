"""device_idle_pct.<traffic>: the share of the traced stretch in which no
operation ran on the device, in percent (torch.profiler's device events)."""


def read(rec):
    tr = rec.device_trace
    if tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
