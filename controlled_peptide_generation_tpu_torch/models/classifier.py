"""Kim-2014 text-CNN attribute classifier over embeddings.

The JAX package's ``models/classifier.py``: parallel valid convolutions
along T of widths min_filter_width..max_filter_width (3..5 shipped) with
num_filters (100) filters each, ReLU, the max over time, concatenated,
dropout, then a linear layer to 2 logits. ``classifier_shapes`` is its
parameter layout, which the checkpoint code also reads (the flat Adam's
classifier segments); ``init`` draws every weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = width * emb_dim for a conv
bank and the input width for the linear layer, as the JAX init does. The
dropout mask comes from a ``torch.Generator`` or is passed in.
"""

import torch

from ..ops import nn


def classifier_shapes(emb_dim, min_filter_width=3, max_filter_width=5,
                      num_filters=100, **_):
    """{(name, leaf): shape}: a conv bank ``conv<w>`` ([w, emb_dim,
    num_filters] and [num_filters]) for each width w, then ``fc`` to 2
    logits. Takes ``cfg.model.C_args``; the defaults are the shipped
    ones."""
    widths = range(min_filter_width, max_filter_width + 1)
    shapes = {}
    for w in widths:
        shapes[f"conv{w}", "w"] = (w, emb_dim, num_filters)
        shapes[f"conv{w}", "b"] = (num_filters,)
    shapes["fc", "w"] = (num_filters * len(widths), 2)
    shapes["fc", "b"] = (2,)
    return shapes


def init(gen, emb_dim, device="cpu", **c_args):
    """Seeded parameters {conv<w>: {w, b}, fc: {w, b}}."""
    params = {}
    for (name, leaf), shape in classifier_shapes(emb_dim, **c_args).items():
        if leaf == "w":
            fan_in = 1
            for n in shape[:-1]:
                fan_in *= n
        params.setdefault(name, {})[leaf] = nn.uniform(
            gen, shape, 1.0 / fan_in ** 0.5, device)
    return params


def apply(params, emb, train=False, gen=None, keep=None, min_filter_width=3,
          max_filter_width=5, dropout=0.5, **_):
    """emb [B, T, E] -> logits [B, 2]. ``keep`` (bool, [B, num_filters *
    n_widths]) is the dropout mask; without it one is drawn from ``gen``
    when ``train``."""
    if emb.shape[1] < max_filter_width:
        raise ValueError(f"the classifier needs seq_len >= "
                         f"{max_filter_width}, got {emb.shape[1]}")
    feats = [torch.relu(nn.conv1d_seq(params[f"conv{w}"], emb)).amax(1)
             for w in range(min_filter_width, max_filter_width + 1)]
    x = nn.dropout(torch.cat(feats, dim=1), dropout, train, gen, keep)
    return nn.linear(params["fc"], x)
