"""The deconvolutional (non-autoregressive) decoder, G_class 'deconv' (the
JAX package's ``models/deconv.py``).

A stack of transposed convolutions maps (z, c) to a [T, emb_dim] map, with
batch norm, a 3-row convolution block, an optional final convolution and
an optional GRU over the rows, then a linear head to the vocabulary's
logits divided by a temperature. Every logit of a sentence comes out at
once; sampling and the beam replay them step by step
(``ops/sampling.sample_from_logits``, ``ops/beam.beam_search_logits``).
At the default widths (max_seq_len 25, kernel 4, 3 deconv layers, 100
filters) the spatial sizes are 1 -> 4 -> 11 -> 25.

The numerics are the JAX package's:

* its transposed convolution is XLA's convolution of the stride-dilated
  input padded by k - 1 (and the output padding at the far end) with the
  UNFLIPPED HWIO kernel; ``torch.nn.functional.conv_transpose2d`` flips
  its kernel, so it is handed the kernel flipped back
  (``w.flip(0, 1)``), and checkpoints cross over unchanged;
* batch norm takes the batch's statistics (the population variance) in
  training and in evaluation alike: a sentence's logits depend on every
  row decoded with it, so callers decode the rows the JAX package decodes
  together;
* at most 4 deconv layers, and 3 when max_seq_len < 30 and the kernel is
  wider than 3.

The ``useRNN`` GRU runs at H = emb_dim through ``ops/gru.gru_scan``
(above the CUDA recurrence kernels' H <= 128 the plain recurrence, as the
JAX package's kernel scope sends it to XLA). The rest is plain torch
(cuDNN convolutions on the card): the JAX package has no TPU kernel here.
"""

import math

import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.gru import gru_scan, init_gru_params
from ..parallel import collectives


def _layers(max_seq_len, kernel_size, num_deconv_layers):
    """The JAX package's guards on the number of deconv layers."""
    num_deconv_layers = min(num_deconv_layers, 4)
    if max_seq_len < 30 and kernel_size > 3:
        num_deconv_layers = 3
    return num_deconv_layers


def _sentence_sizes(max_seq_len, kernel_size, num_deconv_layers):
    sizes = [max_seq_len - 1]
    for _ in range(num_deconv_layers - 1):
        sizes.append(int(math.floor((sizes[-1] - kernel_size) / 2) + 1))
    return list(reversed(sizes))


def _conv_init(gen, kh, kw, c_in, c_out, device, bias=True):
    """HWIO weight and bias ~ U(-1/sqrt(c_in kh kw), ...); without
    ``bias`` a zero bias, a trainable leaf as in the JAX package."""
    bound = 1.0 / (c_in * kh * kw) ** 0.5
    p = {"w": nn.uniform(gen, (kh, kw, c_in, c_out), bound, device)}
    p["b"] = (nn.uniform(gen, (c_out,), bound, device) if bias
              else torch.zeros((c_out,), device=device))
    return p


def _bn_init(c, device):
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def conv_transpose2d(x, p, stride, out_pad=(0, 0)):
    """x [B, C, H, W] -> [B, C', (H-1) s + kh + op_h, (W-1) s + kw +
    op_w]: XLA's correlation of the dilated input with the HWIO kernel,
    as torch's (flipping) transposed convolution of the flipped kernel."""
    w = p["w"].flip(0, 1).permute(2, 3, 0, 1).to(x.dtype)   # [I, O, kh, kw]
    y = F.conv_transpose2d(x, w, stride=stride, output_padding=out_pad)
    return y + p["b"].to(x.dtype)[None, :, None, None]


def conv2d(x, p, pad_h):
    """The HWIO kernel's correlation, padded pad_h rows on each side."""
    w = p["w"].permute(3, 2, 0, 1).to(x.dtype)              # [O, I, kh, kw]
    y = F.conv2d(x, w, padding=(pad_h, 0))
    return y + p["b"].to(x.dtype)[None, :, None, None]


def batchnorm2d(x, p, eps=1e-5):
    """Batch statistics over (B, H, W), the population variance; inside a
    data-parallel step (``collectives.active``) over the global batch,
    each statistic's sums all-reduced over the ranks."""
    shard = collectives.current()
    if shard is None:
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    else:
        n = x.shape[0] * x.shape[2] * x.shape[3] * shard.world
        mean = shard.sum(x.sum(dim=(0, 2, 3), keepdim=True)) / n
        var = shard.sum(((x - mean) ** 2).sum(dim=(0, 2, 3),
                                              keepdim=True)) / n
    xn = (x - mean) * torch.rsqrt(var + eps)
    return (xn * p["scale"][None, :, None, None]
            + p["bias"][None, :, None, None])


def init(gen, h_dim, output_dim, emb_dim, max_seq_len, num_filters=100,
         kernel_size=4, num_deconv_layers=3, useRNN=False, temperature=1.0,
         use_batch_norm=True, num_conv_layers=2, add_final_conv_layer=True,
         device="cpu"):
    """Seeded parameters in the JAX package's layout: ``deconv0``, ``bn0``,
    ``deconv1``, ``bn1``, ``conv<i>`` / ``cbn<i>``, [``deconv2``,
    ``bn2``], ``deconv_out``, ``bn_out``, [``final_conv``, ``bn_final``],
    [``rnn``], ``fc``."""
    del temperature, use_batch_norm
    num_deconv_layers = _layers(max_seq_len, kernel_size, num_deconv_layers)
    sizes = _sentence_sizes(max_seq_len, kernel_size, num_deconv_layers)
    params = {
        "deconv0": _conv_init(gen, sizes[0], 1, h_dim, num_filters * 2,
                              device),
        "bn0": _bn_init(num_filters * 2, device),
        "deconv1": _conv_init(gen, kernel_size, 1, num_filters * 2,
                              num_filters, device),
        "bn1": _bn_init(num_filters, device),
    }
    for i in range(num_conv_layers):
        params[f"conv{i}"] = _conv_init(gen, 3, 1, num_filters, num_filters,
                                        device, bias=False)
        params[f"cbn{i}"] = _bn_init(num_filters, device)
    if num_deconv_layers > 3:
        params["deconv2"] = _conv_init(gen, kernel_size, 1, num_filters,
                                       num_filters, device)
        params["bn2"] = _bn_init(num_filters, device)
    params["deconv_out"] = _conv_init(gen, kernel_size, emb_dim, num_filters,
                                      1, device)
    params["bn_out"] = _bn_init(1, device)
    if add_final_conv_layer:
        params["final_conv"] = _conv_init(gen, 7, emb_dim, 1, emb_dim,
                                          device)
        params["bn_final"] = _bn_init(emb_dim, device)
    if useRNN:
        params["rnn"] = init_gru_params(gen, emb_dim, emb_dim, device)
    params["fc"] = nn.init_linear(gen, emb_dim, output_dim, device)
    return params


def apply(params, z, c, *, emb_dim, max_seq_len, num_filters=100,
          kernel_size=4, num_deconv_layers=3, useRNN=False, temperature=1.0,
          use_batch_norm=True, num_conv_layers=2,
          add_final_conv_layer=True):
    """(z [B, Z], c [B, C]) -> logits [B, max_seq_len, V]."""
    del num_filters
    num_deconv_layers = _layers(max_seq_len, kernel_size, num_deconv_layers)

    def bn(x, name):
        return batchnorm2d(x, params[name]) if use_batch_norm else x

    x = torch.cat([z, c], dim=1)[:, :, None, None]           # [B, H, 1, 1]
    x = torch.relu(bn(conv_transpose2d(x, params["deconv0"], 2), "bn0"))
    x = torch.relu(bn(conv_transpose2d(x, params["deconv1"], 2, (1, 0)),
                      "bn1"))
    for i in range(num_conv_layers):
        x = torch.relu(bn(conv2d(x, params[f"conv{i}"], 1), f"cbn{i}"))
    if num_deconv_layers > 3:
        x = torch.relu(bn(conv_transpose2d(x, params["deconv2"], 2, (1, 0)),
                          "bn2"))
    x = bn(conv_transpose2d(x, params["deconv_out"], 2, (1, 0)), "bn_out")
    if add_final_conv_layer:                                  # [B, 1, T, E]
        x = conv2d(torch.relu(x), params["final_conv"], 3)   # [B, E, T, 1]
        x = bn(x, "bn_final").permute(0, 3, 2, 1)            # [B, 1, T, E]
    dec = x[:, 0]                                            # [B, T, E]
    if useRNN:
        dec, _ = gru_scan(params["rnn"], dec,
                          dec.new_zeros((dec.shape[0], emb_dim)))
    return nn.linear(params["fc"], dec) / temperature
