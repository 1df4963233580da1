"""Model and vocab loading for the port's entry points."""

import json
import logging
import os

import torch

from .data.vocab import Vocab
from .models.rnn_vae import build_model
from .train import checkpoints
from .utils import runtime

LOG = logging.getLogger("GenerationAPI")


def load_trained_model(model_path, n_vocab, cfg, device="cuda"):
    """Returns (model, params) on ``device`` (CUDA unless the caller asks
    for the CPU; without CUDA it raises). Non-strict load: the parts the
    port runs (embedding, decoder) take the checkpoint's values where it
    has them and keep a seeded init otherwise."""
    device = runtime.setup(device)
    model = build_model(cfg.model, n_vocab=n_vocab,
                        max_seq_len=cfg.max_seq_len)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    init = checkpoints.flatten(model.init_params(gen, device))
    stored = checkpoints.flatten(checkpoints.load(model_path, device))
    params = {}
    for path, leaf in init.items():
        if path in stored:
            if stored[path].shape != leaf.shape:
                raise ValueError(
                    f"{model_path}: {checkpoints.keystr(path)} has shape "
                    f"{tuple(stored[path].shape)}, the model wants "
                    f"{tuple(leaf.shape)}")
            leaf = stored[path]
        node = params
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return model, params


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


def get_result_for_model(model_path):
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
    return model_stats


def load_vocab(vocab_path):
    return Vocab.load(vocab_path)
