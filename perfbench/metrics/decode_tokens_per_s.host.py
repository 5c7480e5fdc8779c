"""Tokens generated a second over every live cohort lane: every token of
every whole decode call in the traced run's window over the window's
seconds, by the host clock. Per layer, not end to end: the decode path is
paced by the host's launches, so the rate carries every stall of a shared
host and spreads too widely for any bound; ``decode_gap_p95_ms`` is the
cell's end-to-end metric."""


def read(rec):
    if rec["kind"] != "decode_tokens" or not rec["steps"]:
        return None
    return rec["work"] / rec["window_s"]
