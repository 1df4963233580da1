"""The device's idle time between chunks, in ms a chunk:
``GraphChunk.stats()``'s ``device_gap_s`` (from one replay's end event to
the next chunk's first copy) over the gaps it read. Nothing on the CPU or
without the counter."""


def read(ctx):
    g = ctx.get("graph") or {}
    if not g.get("gaps"):
        return None
    return 1e3 * g["device_gap_s"] / g["gaps"]
