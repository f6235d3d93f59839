"""batch_fill: real queries over padded bucket slots, over the server's
batches in the window, in percent."""


def read(rec):
    slots = sum(bucket for _, _, bucket, _ in rec.batch_log)
    if not slots:
        return None
    return 100.0 * sum(real for _, real, _, _ in rec.batch_log) / slots
