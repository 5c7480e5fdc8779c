"""Seconds of the program's first step in set-up (the kernel library's load
or build, the first launches), by the host clock around a synchronised step."""


def read(rec):
    return rec.get("warmup_s")
