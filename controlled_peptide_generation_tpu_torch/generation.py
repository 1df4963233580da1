"""High-level generation: prior samples decoded by the hard-token sampler.

``generate_sentences`` draws z ~ N(0, I) and c from its prior when they are
not given, then runs ``ops/sampling.sample_sentences``. The beam mode,
the deconv family and flows are not ported into this wrapper (the CLaSS
round calls ``ops/beam.beam_search`` itself).
"""

import torch

from .ops import sampling


@torch.no_grad()
def generate_sentences(model, params, mbsize, gen=None, z=None, c=None,
                       sample_mode="categorical", temp=1.0,
                       prepend_start_idx=True, prevent_empty=False,
                       device="cpu"):
    """Returns (sentences [mbsize, T+1] int32, z, c_ix). Draws from
    ``gen`` in the order z, c, sampling noise."""
    if z is None:
        z = model.sample_z_prior(gen, mbsize, device=device)
    if c is None:
        c = model.sample_c_prior(gen, mbsize, device=z.device)
    if not mbsize == z.shape[0] == c.shape[0]:
        raise ValueError(f"sizes dont match {mbsize} {z.shape[0]} "
                         f"{c.shape[0]}")
    sentences = sampling.sample_sentences(
        model, params, z, c, sample_mode=sample_mode, temp=temp,
        prepend_start_idx=prepend_start_idx, prevent_empty=prevent_empty,
        gen=gen)
    return sentences, z, torch.argmax(c, dim=1)
