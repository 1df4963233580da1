"""Bidirectional GRU encoder -> (mu, logvar).

A 1-layer biGRU over the embeddings from a zero state: the last states of
the forward and the backward direction are concatenated and fed to two
linear heads. Each direction is one ``gru_scan`` (the CUDA recurrence
kernels on CUDA tensors).
"""

import torch

from ..ops import nn
from ..ops.gru import init_gru_params, gru_scan


def init(gen, emb_dim, h_dim, z_dim, biGRU=True, layers=1, p_dropout=0.0,
         device="cpu"):
    """p_dropout is unused: with one layer torch applies no dropout."""
    if layers != 1:
        raise NotImplementedError("the GRU encoder has one layer")
    del p_dropout
    factor = 2 if biGRU else 1
    params = {"gru_fwd": init_gru_params(gen, emb_dim, h_dim, device)}
    if biGRU:
        params["gru_bwd"] = init_gru_params(gen, emb_dim, h_dim, device)
    params["mu"] = nn.init_linear(gen, factor * h_dim, z_dim, device)
    params["logvar"] = nn.init_linear(gen, factor * h_dim, z_dim, device)
    return params


def apply(params, emb, h_dim, biGRU=True):
    """emb: [B, T, E] -> (mu [B, Z], logvar [B, Z])."""
    h0 = torch.zeros((emb.shape[0], h_dim), dtype=emb.dtype,
                     device=emb.device)
    _, h = gru_scan(params["gru_fwd"], emb, h0)
    if biGRU:
        _, h_bwd = gru_scan(params["gru_bwd"], emb, h0, reverse=True)
        h = torch.cat([h, h_bwd], dim=1)
    return nn.linear(params["mu"], h), nn.linear(params["logvar"], h)
