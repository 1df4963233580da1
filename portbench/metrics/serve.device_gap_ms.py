"""The card's idle time between rounds, in ms a round: the server's
``device_gap_s`` (from one round's end event to the next one's start
event) over the window's rounds. Near 0 while the next round is queued
before the last one ends. Nothing on the CPU or without the counter."""


def read(ctx):
    a, b = ctx["after"], ctx["before"]
    rounds = a["rounds"] - b["rounds"]
    if "device_gap_s" not in a or rounds <= 0 or a["device_s"] <= 0:
        return None
    return 1e3 * (a["device_gap_s"] - b["device_gap_s"]) / rounds
