"""Seconds to capture and instantiate the training chunk's CUDA graph
(``GraphChunk.stats()``), a part of set-up."""


def read(ctx):
    g = ctx.get("graph") or {}
    if "capture_s" not in g:
        return None
    return g["capture_s"] + g["instantiate_s"]
