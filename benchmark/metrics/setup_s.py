"""setup_s: process start to the first timed rebuild (host clock)."""


def read(run):
    return run.setup_s
