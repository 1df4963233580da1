"""Device time a round, in ms: the server's ``device_s`` (each round's
CUDA event pair, from before its draws to after its host copies, read
without synchronising) over the window's rounds. Nothing on the CPU, or
where the server keeps no event pairs (no ``device_gap_s`` beside
``device_s``, which then counts host time)."""


def read(ctx):
    a, b = ctx["after"], ctx["before"]
    rounds = a["rounds"] - b["rounds"]
    if "device_gap_s" not in a or rounds <= 0:
        return None
    s = a["device_s"] - b["device_s"]
    return 1e3 * s / rounds if s > 0 else None
