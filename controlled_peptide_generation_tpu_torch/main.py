"""Training entry point of the port (the root ``main.py`` of the JAX
package): config parse and save, data, model init, phase-1 WAE/VAE
training and its prior samples, phase-2 controlled-generation training
and its artifacts, result.json export.

    python -m controlled_peptide_generation_tpu_torch.main [--phase -1] \\
        --runname myrun [--dataset synthetic] [--tiny 1] [--device cpu]

``--phase 1`` trains phase 1 (``train/train_vae.py``), ``--phase 2``
phase 2 (``train/train_full.py``) from the run's phase-1 checkpoint
``model_<s_iter>.npz`` (``--loadpath`` names another), and ``--phase -1``,
the default, both, phase 2 from phase 1's params with a fresh classifier.
Phase 2 writes ``full_gen.txt`` (prior samples with their ``label:``
lines), then ``write_phase2_artifacts``. The encoder is a GRU or a
transformer (``--model.E_args.E_class``), the decoder a GRU (with
``--model.G_args.GRU_args.skip_connections 1`` or without), a
transformer or a deconv stack (``--model.G_args.G_class``); a flow on z
(``--model.flow N --model.flow_type planar|radial|alternating
--model.flow_mode posterior``) trains in phase 1. Phase 2 of a flow or a
deconv model raises before any step, as the JAX package cannot run it
(``train_full.check_phase2``). Runs on CUDA unless ``--device cpu`` is
given.

Data parallelism over one process a device (``parallel/dist.py``):

    python -m torch.distributed.run --nproc_per_node N \
        -m controlled_peptide_generation_tpu_torch.main ... --hw.dp N

trains phases 1, 2 and -1 as the JAX package's ``hw.dp N`` does: every
rank steps on the global batch's rows it owns, the gradients averaged
over the ranks (``--hw.zero 1``: ZeRO-1 in phase 1); rank 0 alone writes
the config, vocab, logs, checkpoints, samples and result.json. Without
torchrun, ``--hw.dp 1`` runs as before and ``--hw.dp N`` raises.

Tensor and pipeline parallelism of the transformer family, the same way:

    python -m torch.distributed.run --nproc_per_node 4 \
        -m controlled_peptide_generation_tpu_torch.main ... \
        --hw.tp 2 --hw.pp 2 [--hw.dp 1]

trains both phases on a (data, pipe, model) mesh of the ranks
(``parallel/dist.py`` ``Mesh``): Megatron's slices of the blocks over
'model', GPipe stages over 'pipe', each composed with ``--hw.dp``; the
samples and checkpoints are a one-device run's.
"""

import logging
import os

import torch

from . import config as C
from .data import synthetic
from .data.loader import AttributeDataLoader
from .generation import generate_sentences
from .models.rnn_vae import build_model
from .parallel import dist as pdist
from .train import checkpoints
from .api import generate_interpolated_samples
from .train.train_full import check_phase2, train_full
from .train.train_vae import train_vae
from .utils import runtime
from .utils.io import write_fasta, write_gen_samples
from .utils.logging import MetricLogger

log = logging.getLogger("main")

EXTRA_ARGS = [("--device", dict(default="cuda", help="cuda (default) or cpu"))]


def load_dataset(cfg):
    spec = C.dataset_spec(cfg)
    gen_kwargs = spec.pop("synthetic", None)
    if gen_kwargs:
        synthetic.ensure(spec["data_path"], **gen_kwargs)
    return AttributeDataLoader(mbsize=cfg.vae.batch_size,
                               max_seq_len=cfg.max_seq_len, **spec)


def write_phase2_artifacts(cfg, model, params, dataset, n=32):
    """The controlled-generation artifacts at the cfg.full paths (the JAX
    package's, root ``main.py``):

    * samez: the same prior latents decoded greedily under c = 0 and c = 1
      (attribute control);
    * posz: greedy decodes of the encoder means of amp-positive training
      rows (and their FASTA);
    * interp: the tanh interpolation between two prior latents, through
      ``api.generate_interpolated_samples``;
    * the FASTA of ``full_gen.txt`` when it exists."""
    dev = next(iter(checkpoints.flatten(params).values())).device
    gen = runtime.generator(dev, cfg.seed + 3)
    z = model.sample_z_prior(gen, n, device=dev)
    lines = []
    for c_val in (0, 1):
        c = torch.zeros((n, model.c_dim), device=dev)
        c[:, c_val] = 1.0
        seqs, _, _ = generate_sentences(model, params, n, gen=gen, z=z, c=c,
                                        sample_mode="greedy", device=dev)
        sents = dataset.idx2sentences(seqs.cpu().numpy(), False)
        lines.extend(f"c={c_val}: {s}" for s in sents)
    write_gen_samples(lines, cfg.full.samez_samples_path)

    pos_ix = dataset.get_subset_indices("amp=amp_posc,amp_posnc")
    if len(pos_ix):
        text = torch.from_numpy(dataset._make_batch(pos_ix[:n]).text).to(dev)
        with torch.no_grad():
            mu, _ = model.encode(params, text)
        seqs, _, _ = generate_sentences(model, params, mu.shape[0], gen=gen,
                                        z=mu, sample_mode="greedy",
                                        device=dev)
        sents = dataset.idx2sentences(seqs.cpu().numpy(), False)
        write_gen_samples(sents, cfg.full.posz_samples_path)
        write_fasta(sents, cfg.full.fasta_pos_samples_path)

    za = model.sample_z_prior(gen, 1, device=dev)
    zb = model.sample_z_prior(gen, 1, device=dev)
    res = generate_interpolated_samples(
        model, params, dataset.vocab, za, zb, interpolation_method="tanh",
        interpolation_samples=9, gen=gen, sample_mode="greedy",
        print_special_tokens=False)
    write_gen_samples(
        [f"w={w:.2f}: {' '.join(p[0])}"
         for w, p in zip(res["interpolation"], res["predictions"])],
        cfg.full.interp_samples_path)

    if os.path.exists(cfg.full.gen_samples_path):
        with open(cfg.full.gen_samples_path) as fh:
            gen_sents = [ln for ln in fh.read().splitlines()
                         if not ln.startswith("label:")]
        write_fasta(gen_sents, cfg.full.fasta_gen_samples_path)
    log.info("phase-2 artifacts written under %s", cfg.savepath)


def main(argv=None):
    cfg, args, overrides = C.parse_and_finalize(argv, extra_args=EXTRA_ARGS)
    device = runtime.setup(args.device)
    if cfg.phase not in (1, 2, -1):
        raise ValueError(f"--phase {cfg.phase}: 1, 2 or -1 (both)")
    pdist.init_from_env(device)
    writer = pdist.is_writer()
    if writer:
        C.save_config(overrides, cfg, cfg.savepath)
        C.pretty_print(cfg)
    log.info("device: %s; random seed: %s; rank %d of %d", device, cfg.seed,
             pdist.rank(), pdist.world_size())

    result_json = (os.path.join(cfg.savepath, "result.json")
                   if cfg.resume_result_json else None)
    logger = MetricLogger(cfg.tbpath, result_json) if writer else None
    try:
        # rank 0 first: it may write the synthetic corpus the others read
        with pdist.writer_first():
            dataset = load_dataset(cfg)
        if writer:
            dataset.print_stats(out=log.info)
            dataset.vocab.save(cfg.vocab_path)

        model = build_model(cfg.model, n_vocab=dataset.n_vocab,
                            max_seq_len=cfg.max_seq_len)
        if cfg.phase in (2, -1):
            # before phase 1 too: its run would end in this refusal
            check_phase2(model)
        params = model.init_params(runtime.generator(device, cfg.seed),
                                   device)
        log.info("Model: %s", model)

        if cfg.phase in (1, -1):
            params, _, steps_per_sec = train_vae(cfg, model, dataset,
                                                 params, logger)
            log.info("train throughput: %.2f steps/sec", steps_per_sec)

            if writer:
                log.info("Evaluating base vae...")
                samples, _, _ = generate_sentences(
                    model, params, cfg.evals.sample_size,
                    gen=runtime.generator(device, cfg.seed + 1),
                    sample_mode="categorical", device=device)
                sents = dataset.idx2sentences(samples.cpu().numpy(), False)
                write_gen_samples(sents, cfg.vae.gen_samples_path)
                write_fasta(sents, cfg.vae.fasta_gen_samples_path)

        if cfg.phase in (2, -1):
            # standalone, finalize() resolved loadpath to the phase-1
            # checkpoint; with -1 phase 1's params carry over
            if cfg.phase == -1:
                cfg.loadpath = ""
            params, steps_per_sec = train_full(cfg, model, dataset, params,
                                               logger)
            log.info("full-phase throughput: %.2f steps/sec", steps_per_sec)
            if writer:
                samples, _, c_ix = generate_sentences(
                    model, params, cfg.evals.sample_size,
                    gen=runtime.generator(device, cfg.seed + 2),
                    sample_mode="categorical", device=device)
                write_gen_samples(
                    dataset.idx2sentences(samples.cpu().numpy(), False),
                    cfg.full.gen_samples_path, c_lab=c_ix.cpu().numpy())
                write_phase2_artifacts(cfg, model, params, dataset)

        if writer:
            log.info("saving result.json and vae_result.json at %s",
                     cfg.savepath)
            logger.export_to_json(os.path.join(cfg.savepath, "result.json"))
            logger.export_to_json(
                os.path.join(cfg.savepath, "vae_result.json"),
                it_filter=lambda k, v: k <= cfg.vae.n_iter)
    finally:
        if logger is not None:
            logger.close()
    return cfg


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s(%(name)s): %(message)s")
    main()
