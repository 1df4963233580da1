"""Device time a chunk, in ms: ``GraphChunk.stats()``'s ``device_s`` (a
CUDA event pair a replay after the capture, from before its staging's
first copy to after the replay) over the replays it timed. Nothing on the
CPU or without the counter."""


def read(ctx):
    g = ctx.get("graph") or {}
    if not g.get("timed"):
        return None
    return 1e3 * g["device_s"] / g["timed"]
