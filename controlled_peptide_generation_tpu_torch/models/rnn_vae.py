"""The GRU-decoder part of the composite sequence autoencoder.

The port carries what the CLaSS round needs: the shared word embedding,
the GRU decoder step, the c prior and the (identity) flow. Parameters are
a nested dict of tensors named as in the JAX package, so checkpoints cross
over unchanged. The encoder, the CNN classifier, the deconv and
transformer families, skip connections and flows are not ported yet
(ROADMAP.md) and raise NotImplementedError.
"""

from dataclasses import dataclass, field

import torch

from ..ops import nn
from . import decoder as dec


@dataclass(frozen=True, eq=False)
class RNNVAE:
    n_vocab: int
    max_seq_len: int = 25
    z_dim: int = 100
    c_dim: int = 2
    emb_dim: int = 150
    flow: int = 0
    E_args: dict = field(default_factory=dict)
    G_args: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.G_class != "gru":
            raise NotImplementedError(
                f"the {self.G_class} decoder family is not ported yet "
                f"(ROADMAP.md A9/A11)")
        if self.gru_args.get("skip_connections", False):
            raise NotImplementedError(
                "GRU skip connections are not ported yet (ROADMAP.md A9)")
        if self.flow > 0:
            raise NotImplementedError(
                "flows are not ported yet (ROADMAP.md A9)")

    @property
    def h_dec(self):
        return self.z_dim + self.c_dim

    @property
    def G_class(self):
        return self.G_args.get("G_class", "gru")

    @property
    def gru_args(self):
        return dict(self.G_args.get("GRU_args", {}))

    def init_params(self, gen, device="cpu"):
        """Seeded embedding + GRU decoder parameters (the parts the port
        runs; a checkpoint written from them loads in the JAX package,
        whose loader keeps fresh values for the missing encoder and
        classifier)."""
        return {
            "emb": nn.init_embedding(gen, self.n_vocab, self.emb_dim, device),
            "dec": dec.init(gen, emb_dim=self.emb_dim + self.h_dec,
                            output_dim=self.n_vocab, h_dim=self.h_dec,
                            device=device),
        }

    def sample_c_prior(self, gen, n, device="cpu"):
        """c ~ Cat([0.5, 0.5]) as one-hot rows."""
        bits = torch.rand((n,), generator=gen, device=device) < 0.5
        return self.c_from_bits(bits)

    def c_from_bits(self, bits):
        return nn.onehot(bits.long(), self.c_dim)

    def apply_flow(self, params, z):
        """z -> (z_K, sum log|det J|); the identity for flow == 0."""
        return z, torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)

    def decode_step(self, params, token_hard, token_soft, z, c, h):
        return dec.apply_step(params["dec"], params["emb"], token_hard,
                              token_soft, z, c, h)

    def init_decoder_hidden(self, params, z, c):
        return dec.init_hidden(z, c)


def build_model(cfg_model, n_vocab, max_seq_len) -> RNNVAE:
    """Construct from the cfg.model Bunch (config.py)."""
    if cfg_model.flow > 0:
        raise NotImplementedError("flows are not ported yet (ROADMAP.md A9)")
    return RNNVAE(
        n_vocab=n_vocab,
        max_seq_len=max_seq_len,
        z_dim=cfg_model.z_dim,
        c_dim=cfg_model.c_dim,
        emb_dim=cfg_model.emb_dim,
        flow=cfg_model.flow,
        E_args=dict(cfg_model.E_args),
        G_args={k: (dict(v) if isinstance(v, dict) else v)
                for k, v in cfg_model.G_args.items()},
    )
