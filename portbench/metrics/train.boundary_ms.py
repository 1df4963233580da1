"""The loop's host work at a chunk's boundary, in ms: the trainer's
``train.boundary`` counter (``do_host``: the sample sentence, the deferred
log fetch, the held-out eval and the checkpoint where their cadences fall,
on the host clock) over the chunks it counted, every chunk of the run."""


def read(ctx):
    try:
        from controlled_peptide_generation_tpu_torch.utils import tracing
    except ImportError:
        return None
    c = tracing.snapshot().get("train.boundary")
    return 1e3 * c["sum"] / c["count"] if c and c["count"] > 0 else None
