"""Inference API of the port: load a trained checkpoint, encode single
sequences, sample, reconstruct and interpolate; what ``static_eval`` and
the sampling pipeline call.

The device math runs where the params live (the GRU encoder's scans in
B4 and the beams in B1 / B3 on the card); the z-space interpolations
(linear, tanh, slerp) are host numpy on tiny arrays, as in the JAX
package. Random draws come from ``torch.Generator``s the caller passes;
without one a function seeds its own from 0.
"""

import json
import logging
import os

import numpy as np
import torch

from .data.vocab import Vocab
from .generation import generate_sentences
from .models.rnn_vae import build_model
from .train import checkpoints
from .utils import runtime

LOG = logging.getLogger("GenerationAPI")


def load_trained_model(model_path, n_vocab, cfg, device="cuda"):
    """Returns (model, params) on ``device`` (CUDA unless the caller asks
    for the CPU; without CUDA it raises). Non-strict load: the parts the
    port runs (embedding, encoder, decoder, of either family) take the
    checkpoint's values where it has them, path by path (the transformer's
    ``['blocks'][i]`` too), and keep a seeded init otherwise."""
    device = runtime.setup(device)
    model = build_model(cfg.model, n_vocab=n_vocab,
                        max_seq_len=cfg.max_seq_len)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    params = checkpoints.load_params(model_path,
                                     model.init_params(gen, device), device)
    return model, params


def _device(params):
    return next(iter(checkpoints.flatten(params).values())).device


def _gen(gen, device):
    return gen if gen is not None else runtime.generator(device, 0)


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@torch.no_grad()
def encode_sequence(model, params, vocab, sequence, sample_q="max",
                    gen=None):
    """Encode one (string or token-list) sequence to z [n, z_dim]: mu for
    "max", else ``sample_q`` draws of q(z|x) from ``gen``."""
    dev = _device(params)
    ixs = torch.tensor([vocab.to_ix(sequence, fix_length=model.max_seq_len)],
                       dtype=torch.int32, device=dev)
    mu, logvar = model.encode(params, ixs, train=False)
    if sample_q == "max":
        return mu
    gen = _gen(gen, dev)
    return torch.cat([model.sample_z(mu, logvar, gen)
                      for _ in range(sample_q)], dim=0)


def sample_from_model(model, params, vocab, z=None, c=None, n_samples=2,
                      print_special_tokens=True, gen=None, **sample_kwargs):
    """``generate_sentences`` with word-level predictions: one list of
    words per sample, or per hypothesis in the beam mode. z and c (arrays
    or tensors) are taken as float32 on the params' device."""
    dev = _device(params)
    z, c = (None if x is None else torch.as_tensor(
        x, dtype=torch.float32, device=dev) for x in (z, c))
    samples, z, c = generate_sentences(model, params, n_samples,
                                       gen=_gen(gen, dev), z=z, c=c,
                                       device=dev, **sample_kwargs)
    samples = samples.cpu().numpy()
    if sample_kwargs.get("sample_mode") == "beam":
        predictions = [[vocab.to_words(hyp, print_special_tokens)
                        for hyp in sent] for sent in samples]
    else:
        predictions = [[vocab.to_words(s, print_special_tokens)]
                       for s in samples]
    return {"predictions": predictions, "z": z, "c": c}


def interpolate_z(z_start, z_end, c=None, method="linear", n_samples=2):
    """Interpolated z rows between two points (host numpy) and their
    mixing weights."""
    z_start = _host(z_start)
    z_end = _host(z_end)
    z_list = [z_start]
    if method == "linear":
        weights = [1 / (n_samples + 1) * i for i in range(1, n_samples + 1)]
        for w in weights:
            z_list.append((1 - w) * z_start + w * z_end)
    elif method == "tanh":
        weights = np.array([1.0 / (n_samples + 1) * i
                            for i in range(1, n_samples + 1)])
        weights = np.tanh(weights * 4 - 2)
        weights = (weights + 1) / 2
        for w in weights:
            z_list.append((1 - w) * z_start + w * z_end)
        weights = list(weights)
    elif method == "slerp":
        p0, p1 = z_start.squeeze(0), z_end.squeeze(0)
        omega = np.arccos(np.clip(
            np.dot(p0 / np.linalg.norm(p0), p1 / np.linalg.norm(p1)),
            -1.0, 1.0))
        so = np.sin(omega)
        weights = [1 / (n_samples + 1) * i for i in range(1, n_samples + 1)]
        for w in weights:
            if so < 1e-6:
                # (near-)parallel endpoints: the slerp ratio is 0/0; its
                # omega -> 0 limit is the linear interpolation
                interp = (1.0 - w) * p0 + w * p1
            else:
                interp = (np.sin((1.0 - w) * omega) / so * p0
                          + np.sin(w * omega) / so * p1)
            z_list.append(np.expand_dims(interp, 0))
    else:
        raise ValueError("Please use another interpolation method.")
    z_list.append(z_end)
    weights = [0.0] + list(weights) + [1.0]
    return np.vstack(z_list), weights


def generate_interpolated_samples(model, params, vocab, z_start, z_end,
                                  c=None, interpolation_method="linear",
                                  interpolation_samples=2, gen=None,
                                  **sample_kwargs):
    """Decode the interpolation between two latents; c is class 1 for
    every point unless given."""
    z_list, weights = interpolate_z(z_start, z_end, c=c,
                                    method=interpolation_method,
                                    n_samples=interpolation_samples)
    if c is None:
        c = np.zeros((z_list.shape[0], model.c_dim), np.float32)
        c[:, 1] = 1.0
    samples = sample_from_model(model, params, vocab, z=z_list, c=c,
                                n_samples=z_list.shape[0], gen=gen,
                                **sample_kwargs)
    samples["interpolation"] = weights
    return samples


def recon_sequence(model, params, vocab, sequence, sample_q, c, gen=None,
                   **mb_sample_kwargs):
    """Decode the encoding(s) of one sequence."""
    gen = _gen(gen, _device(params))
    z = encode_sequence(model, params, vocab, sequence, sample_q, gen=gen)
    return sample_from_model(model, params, vocab, z, c, z.shape[0],
                             gen=gen, **mb_sample_kwargs)


def interpolate_peptides(model, params, vocab, sequence_start, sequence_end,
                         interpolation_kwargs=None, mb_sample_kwargs=None,
                         gen=None):
    """Decode the interpolation between the encodings (mu) of two
    sequences."""
    z_start = encode_sequence(model, params, vocab, sequence_start, "max")
    z_end = encode_sequence(model, params, vocab, sequence_end, "max")
    return generate_interpolated_samples(
        model, params, vocab, z_start, z_end, gen=gen,
        **(interpolation_kwargs or {}), **(mb_sample_kwargs or {}))


def pretty_print_samples(samples, print_all_hypotheses=True):
    res = []
    for i, sample in enumerate(samples):
        if len(sample) > 1 and not print_all_hypotheses:
            sample = sample[:1]
        if len(sample) == 1:
            res.append(f"i {i}: {' '.join(sample[0])}")
        else:
            for j, hyp in enumerate(sample):
                res.append(f"i {i} - hyp {j}: {' '.join(hyp)}")
    return "\n".join(res)


def get_model_and_vocab_path(cfg):
    """Final-vae checkpoint path with highest-iter fallback."""
    base = cfg.savepath
    model_path = os.path.join(base, f"model_{cfg.vae.n_iter}.npz")
    if not os.path.exists(model_path):
        step = checkpoints.latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no model_*.npz under {base}")
        LOG.info("Selected model folder does not have fully trained model! "
                 "Using iteration %s instead", step)
        model_path = os.path.join(base, f"model_{step}.npz")
    vocab_path = os.path.join(base, "vocab.dict")
    LOG.info("api load from rundir=%s model=%s", base, model_path)
    return model_path, vocab_path, base


def get_result_for_model(model_path, print_results=False):
    """This model-iteration's row of the result.json beside it."""
    folder_name = os.path.dirname(model_path)
    with open(os.path.join(folder_name, "result.json")) as f:
        data = json.load(f)
    iteration = os.path.basename(model_path).split(".")[0].split("_")[1]
    model_stats = {}
    for res in data:
        if str(res.get("it")) == str(iteration):
            model_stats = res
    if not model_stats:
        LOG.info("No results for %s found.", model_path)
    if print_results:
        print(f"Results for model {model_path}")
        print(json.dumps(model_stats, indent=2))
    return model_stats


def load_vocab(vocab_path):
    return Vocab.load(vocab_path)
