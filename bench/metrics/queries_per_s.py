"""queries_per_s: queries answered over the seconds from the window's start
to its last answer (at least the window): below the offered rate when the
server falls behind."""


def read(rec):
    if not rec.offered:
        return None
    return rec.answered / rec.span_s
