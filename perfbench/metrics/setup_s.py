"""Set-up seconds: from the start of the process to the start of the
window (imports, the weights, the program's build and warm-up, the steps
its check follows), by the host clock."""


def read(rec):
    return rec["setup_s"]
