"""Candidates the window's rounds drew and decoded, per second of the
window, from the server's counters: the decode's rate before the heads'
accept test and the server's dedup thin it to ``accepted_per_s``."""


def read(ctx):
    cand = ctx["after"]["candidates"] - ctx["before"]["candidates"]
    return cand / ctx["window_s"] if cand > 0 else None
