"""The loader's host time a chunk, in ms: the trainer's ``train.loader``
counter (the chunk's batches from the dataset and their stack, on the
host clock) over the chunks it counted, every chunk of the run."""


def read(ctx):
    try:
        from controlled_peptide_generation_tpu_torch.utils import tracing
    except ImportError:
        return None
    c = tracing.snapshot().get("train.loader")
    return 1e3 * c["sum"] / c["count"] if c and c["count"] > 0 else None
