"""The composite sequence autoencoder: the GRU, transformer and deconv
families, with the model's options.

The port carries the shared word embedding, the biGRU encoder, the GRU
decoder (teacher-forced pass and free-running step, with or without skip
connections), the transformer encoder and decoder
(``models/transformer.py``), in any pairing of the two families, the
deconv decoder (``models/deconv.py``: all logits at once from (z, c)),
the text-CNN classifier (``models/classifier.py``), the z and c priors and
the planar, radial and alternating flows on z (``models/flow.py``).
Parameters are nested dicts (the transformer's blocks a list) of tensors
named as in the JAX package, so checkpoints cross over unchanged. The
classifier's parameters ``clf`` are made by ``init_classifier`` when
phase 2 starts: phase 1 neither trains nor writes them.

A flow runs in one of two modes (``flow_mode``): ``gen_prior`` applies it
to any z that is generated from, and cannot be trained (the JAX package's
``forward`` raises in training, as here); ``posterior`` trains it on the
flow-posterior objective (``train/train_vae.make_loss_fn``) and decodes
flow(z) of the latents that sampling draws from Q(z).

The encoder and the classifier take [B, T] tokens or [B, T, V] soft rows
(phase 2's soft samples), embedded by ``nn.soft_embed``.

Every random draw of a forward pass (the reparameterization noise, the c
prior, the dropout masks) comes from a ``torch.Generator`` or is passed
in a ``draws`` dict, so tests can feed the JAX package's draws.
"""

from dataclasses import dataclass, field
from typing import Any

import torch

from ..data.vocab import PAD_IDX
from ..ops import nn
from . import classifier as clf
from . import deconv as deconv_mod
from . import decoder as dec
from . import encoder as enc
from . import flow as flow_mod
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
    flow_type: str = ""
    flow_mode: str = "gen_prior"   # gen_prior | posterior
    E_args: dict = field(default_factory=dict)
    G_args: dict = field(default_factory=dict)
    C_args: dict = field(default_factory=dict)
    # model parallelism of the transformer legs (``parallel/tp.py``,
    # ``parallel/pp.py``): the model group's ``collectives.Shard``, and
    # the pipeline schedules that run each leg's full-sequence block stack
    # (the JAX package's hooks of the same names, models/rnn_vae.py:46-47
    # there). None: the one-device model
    tp: Any = None
    enc_blocks_apply: Any = None
    dec_blocks_apply: Any = None

    def __post_init__(self):
        if self.E_class not in ("gru", "transformer"):
            raise ValueError(f"unknown encoder family {self.E_class!r}")
        if self.G_class not in ("gru", "transformer", "deconv"):
            raise ValueError(f"unknown decoder family {self.G_class!r}")
        if self.flow_mode not in ("gen_prior", "posterior"):
            raise ValueError(f"unknown flow_mode {self.flow_mode!r}")

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

    @property
    def deconv_args(self):
        args = dict(self.G_args.get("deconv_args", {}))
        args["max_seq_len"] = self.max_seq_len
        return args

    @property
    def skip_connections(self):
        return (self.G_class == "gru"
                and bool(self.gru_args.get("skip_connections", False)))

    def init_params(self, gen, device="cpu"):
        """Seeded embedding, encoder, decoder (and flow) parameters, the
        phase-1 tree (a checkpoint written from them loads in the JAX
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
        elif self.G_class == "deconv":
            dec_p = deconv_mod.init(gen, h_dim=self.h_dec,
                                    output_dim=self.n_vocab,
                                    emb_dim=self.emb_dim, device=device,
                                    **self.deconv_args)
        else:
            dec_p = dec.init(gen, emb_dim=self.emb_dim + self.h_dec,
                             output_dim=self.n_vocab, h_dim=self.h_dec,
                             device=device,
                             skip_connections=self.skip_connections)
        params = {"emb": emb_p, "enc": enc_p, "dec": dec_p}
        if self.flow > 0:
            params["flow"] = flow_mod.init(gen, self.flow_type, self.flow,
                                           self.z_dim, device)
        return params

    def init_classifier(self, gen, device="cpu"):
        """Seeded classifier parameters, the tree's ``clf`` (phase 2)."""
        return clf.init(gen, self.emb_dim, device, **self.C_args)

    # ---- encoder / latent ----------------------------------------------

    def encode(self, params, inputs, train=False, gen=None, keeps=None):
        """inputs: [B, T] int tokens or [B, T, V] soft rows -> (mu [B, Z],
        logvar [B, Z]). train, gen and ``keeps`` (one bool mask [B, T,
        d_model] per block) only matter for the transformer encoder's
        block dropout."""
        emb = _embed(params, inputs)
        if self.E_class == "transformer":
            t_args = self.enc_tfm_args
            if inputs.dim() == 2:
                pad_mask = inputs != PAD_IDX
            else:
                # a soft row is a token unless PAD dominates it or it is
                # all zeros (the sampler zeroes the rows after EOS)
                pad_mask = ((inputs[..., PAD_IDX] < 0.5)
                            & (inputs.sum(-1) > 0.5))
            return tfm.apply_encoder(
                params["enc"], emb, pad_mask,
                n_heads=t_args.get("n_heads", 4),
                p_dropout=t_args.get("p_dropout", 0.0), train=train,
                bf16=t_args.get("bf16", False), gen=gen, keeps=keeps,
                tp=self.tp, blocks_apply=self.enc_blocks_apply)
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
        if self.flow == 0:
            return z, torch.zeros(z.shape[0], dtype=z.dtype,
                                  device=z.device)
        return flow_mod.apply(params["flow"], self.flow_type, z)

    # ---- decoder ----------------------------------------------------------

    def decode_train(self, params, tokens, z, c, train=True, gen=None,
                     word_drop=None, out_keep=None, keeps=None):
        """Teacher-forced logits [B, T, V]. ``word_drop`` [B, T] is the
        word-dropout mask; ``out_keep`` [B, T, H] the GRU head's dropout
        mask; ``keeps`` the transformer blocks' masks, one [B, T + 1,
        d_model] per block. Masks not given are drawn from ``gen``. The
        deconv family ignores the tokens and has no dropout."""
        if self.G_class == "deconv":
            return self.decode_logits(params, z, c)
        if self.G_class == "transformer":
            t_args = self.dec_tfm_args
            return tfm.apply_teacher_forced(
                params["dec"], params["emb"], tokens, z, c, train,
                n_heads=t_args.get("n_heads", 4),
                p_word_dropout=t_args.get("p_word_dropout", 0.3),
                p_dropout=t_args.get("p_dropout", 0.0),
                bf16=t_args.get("bf16", False), gen=gen,
                word_drop=word_drop, keeps=keeps, tp=self.tp,
                blocks_apply=self.dec_blocks_apply)
        g_args = self.gru_args
        return dec.apply_teacher_forced(
            params["dec"], params["emb"], tokens, z, c, train,
            p_word_dropout=g_args.get("p_word_dropout", 0.3),
            p_out_dropout=g_args.get("p_out_dropout", 0.3), gen=gen,
            word_drop=word_drop, out_keep=out_keep)

    def decode_logits(self, params, z, c):
        """The deconv family's logits [B, T, V] of every step at once."""
        if self.G_class != "deconv":
            raise ValueError("decode_logits is the deconv family's")
        return deconv_mod.apply(params["dec"], z, c, emb_dim=self.emb_dim,
                                **self.deconv_args)

    def decode_step(self, params, token_hard, token_soft, z, c, h,
                    write_pos=None):
        """One free-running step -> (logits [B, V], h'). ``write_pos``, the
        transformer cache's position as an int, spares a step loop that
        knows it a device sync a block. The deconv family has no step: its
        logits replay (``decode_logits``)."""
        if self.G_class == "deconv":
            raise ValueError(DECONV_NO_STEP)
        if self.G_class == "transformer":
            t_args = self.dec_tfm_args
            return tfm.apply_step(params["dec"], params["emb"], token_hard,
                                  token_soft, h,
                                  n_heads=t_args.get("n_heads", 4),
                                  bf16=t_args.get("bf16", False),
                                  write_pos=write_pos)
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

    # ---- classifier ---------------------------------------------------------

    def classify(self, params, inputs, train=False, gen=None, keep=None):
        """Logits [B, 2] of [B, T] tokens or [B, T, V] soft rows; with
        ``train`` the dropout mask ``keep`` (drawn from ``gen`` when not
        given)."""
        return clf.apply(params["clf"], _embed(params, inputs), train=train,
                         gen=gen, keep=keep, **self.C_args)

    # ---- full teacher-forced forward ----------------------------------------

    def forward(self, params, sequences, q_c="prior", sample_z=1,
                labels=None, train=True, gen=None, draws=None):
        """Returns ((mu, logvar), (z, c), dec_logits).

        ``draws`` may hold "eps" [B, Z] (reparameterization noise),
        "c_bits" [B] (bool, the c prior), "word_drop" [B, T], "out_keep"
        [B, T, H] (the GRU head's mask), "enc_keeps" and "dec_keeps" (the
        transformer blocks' masks, one per block; bool); the others are
        drawn from ``gen``. ``train`` switches every dropout, the
        encoder's included. q_c="classifier" takes c = softmax of the
        classifier's logits on the sequences, without dropout."""
        if self.flow > 0 and train:
            raise ValueError(FLOW_IN_FORWARD)
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
        elif q_c == "classifier":
            c = torch.softmax(self.classify(params, sequences), dim=1)
        else:
            raise ValueError("q_c is not labels, prior, or classifier")
        dec_logits = self.decode_train(
            params, sequences, z, c, train=train, gen=gen,
            word_drop=draws.get("word_drop"), out_keep=draws.get("out_keep"),
            keeps=draws.get("dec_keeps"))
        return (mu, logvar), (z, c), dec_logits


FLOW_IN_FORWARD = (
    "flow prior during training needs the flow-KL loss term; use "
    "apply_flow() explicitly (the JAX package's forward raises here too, "
    "models/rnn_vae.py:272-276 there)")
DECONV_NO_STEP = (
    "the deconv decoder has no free-running step: its logits come at once "
    "(decode_logits) and replay through sample_from_logits or "
    "beam_search_logits; the JAX package's step sampler "
    "(ops/sampling.py:sample_sentences) has no deconv arm either")


def _embed(params, inputs):
    """Tokens [B, T] or soft rows [B, T, V] -> embeddings [B, T, E]."""
    if inputs.dim() == 2:
        return nn.embed(params["emb"], inputs)
    return nn.soft_embed(params["emb"], inputs)


def build_model(cfg_model, n_vocab, max_seq_len) -> RNNVAE:
    """Construct from the cfg.model Bunch (config.py)."""
    return RNNVAE(
        n_vocab=n_vocab,
        max_seq_len=max_seq_len,
        z_dim=cfg_model.z_dim,
        c_dim=cfg_model.c_dim,
        emb_dim=cfg_model.emb_dim,
        flow=cfg_model.flow,
        flow_type=cfg_model.flow_type,
        flow_mode=cfg_model.get("flow_mode", "gen_prior"),
        E_args=dict(cfg_model.E_args),
        G_args={k: (dict(v) if isinstance(v, dict) else v)
                for k, v in cfg_model.G_args.items()},
        C_args=dict(cfg_model.C_args),
    )
