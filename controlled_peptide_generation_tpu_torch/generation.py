"""High-level generation: prior samples decoded by the hard-token sampler
or the beam search.

``generate_sentences`` draws z ~ N(0, I) and c from its prior when they are
not given, then runs ``ops/sampling.sample_sentences`` or, in the beam
mode, ``ops/beam.beam_search``. The beam's route is decided before the
call, as the JAX package routes it (``ops/beam.py:209-224`` there): a
shape inside the kernel's scope runs the kernel on CUDA tensors, a shape
outside it (beam 15 at T 25, or a decoder with skip connections) the
plain version, which the JAX package runs in its XLA arm. A flow under
``flow_mode`` gen_prior maps every z before the decode (the reference's
semantics); a posterior flow is applied by the callers that decode
latents of Q(z) (``pipeline.decode_top1``, the fused round). The deconv
family computes all its logits at once and replays them
(``ops/beam.beam_search_logits``, ``ops/sampling.sample_from_logits``).
"""

import torch

from .ops import beam as beam_ops
from .ops import sampling


@torch.no_grad()
def generate_sentences(model, params, mbsize, gen=None, z=None, c=None,
                       sample_mode="categorical", temp=1.0,
                       prepend_start_idx=True, prevent_empty=False,
                       device="cpu", min_length=1, beam_size=5, n_best=3):
    """Returns (sentences, z, c_ix). Hard modes: sentences [mbsize, T+1]
    int32. Beam: [mbsize, n_best, T+1] (scores dropped; call
    ``ops.beam.beam_search`` for them). Draws from ``gen`` in the order
    z, c, sampling noise. The returned z is the one decoded (after a
    gen_prior flow), as in the JAX package."""
    if z is None:
        z = model.sample_z_prior(gen, mbsize, device=device)
    if c is None:
        c = model.sample_c_prior(gen, mbsize, device=z.device)
    if not mbsize == z.shape[0] == c.shape[0]:
        raise ValueError(f"sizes dont match {mbsize} {z.shape[0]} "
                         f"{c.shape[0]}")
    if model.flow > 0 and model.flow_mode == "gen_prior":
        z, _ = model.apply_flow(params, z)
    if model.G_class == "deconv":
        logits = model.decode_logits(params, z, c)
        if sample_mode == "beam":
            sentences, _ = beam_ops.beam_search_logits(
                logits, beam_size=beam_size, n_best=n_best,
                min_length=min_length)
        else:
            sentences = sampling.sample_from_logits(
                logits, sample_mode=sample_mode, temp=temp,
                prepend_start_idx=prepend_start_idx,
                prevent_empty=prevent_empty, gen=gen)
    elif sample_mode == "beam":
        plain = not beam_ops.in_kernel_scope(model, params, z, beam_size)
        sentences, _ = beam_ops.beam_search(
            model, params, z, c, beam_size=beam_size, n_best=n_best,
            min_length=min_length, plain=plain)
    else:
        sentences = sampling.sample_sentences(
            model, params, z, c, sample_mode=sample_mode, temp=temp,
            prepend_start_idx=prepend_start_idx,
            prevent_empty=prevent_empty, gen=gen)
    return sentences, z, torch.argmax(c, dim=1)
