"""Seconds from the process's start to the first timed operation:
imports, kernel loading (a build on a checkout's first run), weights
made from the seed, the program's construction and warm-up."""


def read(run):
    return run.get("setup_s")
