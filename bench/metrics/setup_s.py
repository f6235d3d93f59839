"""setup_s: seconds from the start of the process to the window's start:
generation, partition, build and the cell's warm-up (captures), and in a
run that builds the kernels, their build."""


def read(rec):
    return rec.setup_s
