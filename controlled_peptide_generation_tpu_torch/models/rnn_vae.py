"""The composite sequence autoencoder: the GRU and transformer families.

The port carries the shared word embedding, the biGRU encoder, the GRU
decoder (teacher-forced pass and free-running step), the transformer
encoder and decoder (``models/transformer.py``), the z and c priors and
the (identity) flow: what phase-1 training and the CLaSS round run.
Parameters are nested dicts (the transformer's blocks a list) of tensors
named as in the JAX package, so checkpoints cross over unchanged. The CNN
classifier (no gradient reaches it in phase 1), the deconv family, skip
connections and flows are not ported yet (ROADMAP.md) and raise
NotImplementedError.

Every random draw of a forward pass (the reparameterization noise, the c
prior, the dropout masks) comes from a ``torch.Generator`` or is passed
in a ``draws`` dict, so tests can feed the JAX package's draws.
"""

from dataclasses import dataclass, field

import torch

from ..data.vocab import PAD_IDX
from ..ops import nn
from . import decoder as dec
from . import encoder as enc
from . import transformer as tfm

_TFM_KEYS = ("d_model", "n_layers", "d_ff", "n_heads", "p_dropout")


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
        if self.E_class not in ("gru", "transformer"):
            raise NotImplementedError(
                f"the {self.E_class} encoder family is not ported yet "
                f"(ROADMAP.md A7)")
        if self.G_class not in ("gru", "transformer"):
            raise NotImplementedError(
                f"the {self.G_class} decoder family is not ported yet "
                f"(ROADMAP.md A7)")
        if self.gru_args.get("skip_connections", False):
            raise NotImplementedError(
                "GRU skip connections are not ported yet (ROADMAP.md A7)")
        if self.flow > 0:
            raise NotImplementedError(
                "flows are not ported yet (ROADMAP.md A7)")

    @property
    def h_dec(self):
        return self.z_dim + self.c_dim

    @property
    def E_class(self):
        return self.E_args.get("E_class", "gru")

    @property
    def G_class(self):
        return self.G_args.get("G_class", "gru")

    @property
    def gru_args(self):
        return dict(self.G_args.get("GRU_args", {}))

    @property
    def enc_tfm_args(self):
        return dict(self.E_args.get("T_args", {}))

    @property
    def dec_tfm_args(self):
        return dict(self.G_args.get("T_args", {}))

    def init_params(self, gen, device="cpu"):
        """Seeded embedding, encoder and decoder parameters (the parts the
        port runs; a checkpoint written from them loads in the JAX
        package, whose non-strict loader keeps fresh values for the
        missing classifier)."""
        emb_p = nn.init_embedding(gen, self.n_vocab, self.emb_dim, device)
        if self.E_class == "transformer":
            enc_p = tfm.init_encoder(
                gen, emb_dim=self.emb_dim, z_dim=self.z_dim,
                max_seq_len=self.max_seq_len, device=device,
                **{k: v for k, v in self.enc_tfm_args.items()
                   if k in _TFM_KEYS})
        else:
            enc_p = enc.init(gen, emb_dim=self.emb_dim, z_dim=self.z_dim,
                             device=device,
                             **{k: v for k, v in self.E_args.items()
                                if k not in ("E_class", "T_args")})
        if self.G_class == "transformer":
            dec_p = tfm.init_decoder(
                gen, emb_dim=self.emb_dim, z_dim=self.z_dim,
                c_dim=self.c_dim, output_dim=self.n_vocab,
                max_seq_len=self.max_seq_len, device=device,
                **{k: v for k, v in self.dec_tfm_args.items()
                   if k in _TFM_KEYS})
        else:
            dec_p = dec.init(gen, emb_dim=self.emb_dim + self.h_dec,
                             output_dim=self.n_vocab, h_dim=self.h_dec,
                             device=device)
        return {"emb": emb_p, "enc": enc_p, "dec": dec_p}

    # ---- encoder / latent ----------------------------------------------

    def encode(self, params, inputs, train=False, gen=None, keeps=None):
        """inputs: [B, T] int tokens -> (mu [B, Z], logvar [B, Z]).
        train, gen and ``keeps`` (one bool mask [B, T, d_model] per block)
        only matter for the transformer encoder's block dropout."""
        emb = nn.embed(params["emb"], inputs)
        if self.E_class == "transformer":
            t_args = self.enc_tfm_args
            return tfm.apply_encoder(
                params["enc"], emb, inputs != PAD_IDX,
                n_heads=t_args.get("n_heads", 4),
                p_dropout=t_args.get("p_dropout", 0.0), train=train,
                bf16=t_args.get("bf16", False), gen=gen, keeps=keeps)
        return enc.apply(params["enc"], emb,
                         h_dim=self.E_args.get("h_dim", 80),
                         biGRU=self.E_args.get("biGRU", True))

    def sample_z(self, mu, logvar, gen=None, eps=None):
        """mu + exp(logvar / 2) * eps, eps ~ N(0, I) from ``gen`` unless
        given."""
        if eps is None:
            eps = torch.randn(mu.shape, generator=gen, device=mu.device,
                              dtype=mu.dtype)
        return mu + torch.exp(logvar / 2.0) * eps

    def sample_z_prior(self, gen, n, device="cpu"):
        return torch.randn((n, self.z_dim), generator=gen, device=device)

    def sample_c_prior(self, gen, n, device="cpu"):
        """c ~ Cat([0.5, 0.5]) as one-hot rows."""
        bits = torch.rand((n,), generator=gen, device=device) < 0.5
        return self.c_from_bits(bits)

    def c_from_bits(self, bits):
        return nn.onehot(bits.long(), self.c_dim)

    def apply_flow(self, params, z):
        """z -> (z_K, sum log|det J|); the identity for flow == 0."""
        return z, torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)

    # ---- decoder ----------------------------------------------------------

    def decode_train(self, params, tokens, z, c, train=True, gen=None,
                     word_drop=None, out_keep=None, keeps=None):
        """Teacher-forced logits [B, T, V]. ``word_drop`` [B, T] is the
        word-dropout mask; ``out_keep`` [B, T, H] the GRU head's dropout
        mask; ``keeps`` the transformer blocks' masks, one [B, T + 1,
        d_model] per block. Masks not given are drawn from ``gen``."""
        if self.G_class == "transformer":
            t_args = self.dec_tfm_args
            return tfm.apply_teacher_forced(
                params["dec"], params["emb"], tokens, z, c, train,
                n_heads=t_args.get("n_heads", 4),
                p_word_dropout=t_args.get("p_word_dropout", 0.3),
                p_dropout=t_args.get("p_dropout", 0.0),
                bf16=t_args.get("bf16", False), gen=gen,
                word_drop=word_drop, keeps=keeps)
        g_args = self.gru_args
        return dec.apply_teacher_forced(
            params["dec"], params["emb"], tokens, z, c, train,
            p_word_dropout=g_args.get("p_word_dropout", 0.3),
            p_out_dropout=g_args.get("p_out_dropout", 0.3), gen=gen,
            word_drop=word_drop, out_keep=out_keep)

    def decode_step(self, params, token_hard, token_soft, z, c, h):
        if self.G_class == "transformer":
            t_args = self.dec_tfm_args
            return tfm.apply_step(params["dec"], params["emb"], token_hard,
                                  token_soft, h,
                                  n_heads=t_args.get("n_heads", 4),
                                  bf16=t_args.get("bf16", False))
        return dec.apply_step(params["dec"], params["emb"], token_hard,
                              token_soft, z, c, h)

    def init_decoder_hidden(self, params, z, c):
        """The decoder state of the step engines: [B, H] for the GRU, the
        KV-cache dict (latent prefix at position 0) for the transformer."""
        if self.G_class == "transformer":
            t_args = self.dec_tfm_args
            return tfm.init_cache(params["dec"], z, c, self.max_seq_len,
                                  n_heads=t_args.get("n_heads", 4),
                                  bf16=t_args.get("bf16", False))
        return dec.init_hidden(z, c)

    # ---- full teacher-forced forward ----------------------------------------

    def forward(self, params, sequences, q_c="prior", sample_z=1,
                labels=None, train=True, gen=None, draws=None):
        """Returns ((mu, logvar), (z, c), dec_logits).

        ``draws`` may hold "eps" [B, Z] (reparameterization noise),
        "c_bits" [B] (bool, the c prior), "word_drop" [B, T], "out_keep"
        [B, T, H] (the GRU head's mask), "enc_keeps" and "dec_keeps" (the
        transformer blocks' masks, one per block; bool); the others are
        drawn from ``gen``. ``train`` switches every dropout, the
        encoder's included."""
        draws = draws or {}
        mu, logvar = self.encode(params, sequences, train=train, gen=gen,
                                 keeps=draws.get("enc_keeps"))
        if sample_z == "max":
            z = mu
        elif sample_z == 1:
            z = self.sample_z(mu, logvar, gen, draws.get("eps"))
        else:
            raise ValueError(f"sample_z must be 1 or 'max': {sample_z!r}")
        if labels is not None:
            c = nn.onehot(labels.long(), self.c_dim)
        elif q_c == "prior":
            bits = draws.get("c_bits")
            c = (self.sample_c_prior(gen, sequences.shape[0],
                                     device=sequences.device)
                 if bits is None else self.c_from_bits(bits))
        else:
            raise NotImplementedError(
                f"q_c={q_c!r} needs the CNN classifier, not ported yet "
                f"(ROADMAP.md A7)")
        dec_logits = self.decode_train(
            params, sequences, z, c, train=train, gen=gen,
            word_drop=draws.get("word_drop"), out_keep=draws.get("out_keep"),
            keeps=draws.get("dec_keeps"))
        return (mu, logvar), (z, c), dec_logits


def build_model(cfg_model, n_vocab, max_seq_len) -> RNNVAE:
    """Construct from the cfg.model Bunch (config.py)."""
    if cfg_model.flow > 0:
        raise NotImplementedError("flows are not ported yet (ROADMAP.md A7)")
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
