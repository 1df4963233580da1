"""Accepted candidates over candidates drawn in the window's rounds, from
the server's counters."""


def read(ctx):
    cand = ctx["after"]["candidates"] - ctx["before"]["candidates"]
    acc = ctx["after"]["accepted"] - ctx["before"]["accepted"]
    return acc / cand if cand > 0 else None
