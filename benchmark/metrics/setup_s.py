"""setup_s: process start to the first timed scan, host clock: the
benchmark's traffic, the kernels' load (their build, in a first run), the
map, the programs and their warm-up and captures, and the settle scans."""


def read(run):
    return run.setup_s
