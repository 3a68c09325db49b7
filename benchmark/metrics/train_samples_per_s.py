"""Rows of every step begun in the window (over all cards), over the
window's seconds up to the synchronisation after the last."""


def read(run):
    return run.rec["rows"] / run.rec["window_s"]
