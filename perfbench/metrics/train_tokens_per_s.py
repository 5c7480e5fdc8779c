"""Client tokens trained a second: every token of every whole step in the
window over the window's seconds (the step that crosses the deadline
finishes inside it), by the host clock."""


def read(rec):
    if rec["kind"] != "train_tokens" or not rec["steps"]:
        return None
    return rec["work"] / rec["window_s"]
