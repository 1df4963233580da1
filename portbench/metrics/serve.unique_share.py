"""Unique share of the accepted rows over the window: 1 - duplicates /
accepted, from the server's counters."""


def read(ctx):
    acc = ctx["after"]["accepted"] - ctx["before"]["accepted"]
    dup = ctx["after"]["duplicates"] - ctx["before"]["duplicates"]
    return 1.0 - dup / acc if acc > 0 else None
