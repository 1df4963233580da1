"""Phase-1 entry point of the port: config parse and save, data, model init,
WAE/VAE training, prior samples, result.json export.

    python -m controlled_peptide_generation_tpu_torch.main --phase 1 \\
        --runname myrun [--dataset synthetic] [--tiny 1] [--device cpu]

The transformer family trains with ``--model.E_args.E_class transformer
--model.G_args.G_class transformer``. Runs on CUDA unless ``--device cpu``
is given. Phase 2 (``--phase 2`` and ``--phase -1``, both phases) and the
mixed families (a transformer encoder with a GRU decoder, or the reverse)
are not ported yet and raise.
"""

import logging
import os

from . import config as C
from .data import synthetic
from .data.loader import AttributeDataLoader
from .generation import generate_sentences
from .models.rnn_vae import build_model
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


def main(argv=None):
    cfg, args, overrides = C.parse_and_finalize(argv, extra_args=EXTRA_ARGS)
    device = runtime.setup(args.device)
    if cfg.phase != 1:
        raise NotImplementedError(
            f"--phase {cfg.phase}: phase-2 training is not ported yet "
            f"(ROADMAP.md A7); run --phase 1")
    families = (cfg.model.E_args.E_class, cfg.model.G_args.G_class)
    if "transformer" in families and families != ("transformer",) * 2:
        raise NotImplementedError(
            f"training a transformer with a GRU (E_class {families[0]}, "
            f"G_class {families[1]}) is not ported yet: no parity test "
            f"covers the mixed families (ROADMAP.md A7); train "
            f"--model.E_args.E_class transformer --model.G_args.G_class "
            f"transformer, or the GRU family")
    C.save_config(overrides, cfg, cfg.savepath)
    C.pretty_print(cfg)
    log.info("device: %s; random seed: %s", device, cfg.seed)

    result_json = (os.path.join(cfg.savepath, "result.json")
                   if cfg.resume_result_json else None)
    logger = MetricLogger(cfg.tbpath, result_json)
    try:
        dataset = load_dataset(cfg)
        dataset.print_stats(out=log.info)
        dataset.vocab.save(cfg.vocab_path)

        model = build_model(cfg.model, n_vocab=dataset.n_vocab,
                            max_seq_len=cfg.max_seq_len)
        params = model.init_params(runtime.generator(device, cfg.seed),
                                   device)
        log.info("Model: %s", model)

        params, _, steps_per_sec = train_vae(cfg, model, dataset, params,
                                             logger)
        log.info("train throughput: %.2f steps/sec", steps_per_sec)

        log.info("Evaluating base vae...")
        samples, _, _ = generate_sentences(
            model, params, cfg.evals.sample_size,
            gen=runtime.generator(device, cfg.seed + 1),
            sample_mode="categorical", device=device)
        sents = dataset.idx2sentences(samples.cpu().numpy(), False)
        write_gen_samples(sents, cfg.vae.gen_samples_path)
        write_fasta(sents, cfg.vae.fasta_gen_samples_path)

        log.info("saving result.json and vae_result.json at %s",
                 cfg.savepath)
        logger.export_to_json(os.path.join(cfg.savepath, "result.json"))
        logger.export_to_json(os.path.join(cfg.savepath, "vae_result.json"),
                              it_filter=lambda k, v: k <= cfg.vae.n_iter)
    finally:
        logger.close()
    return cfg


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s(%(name)s): %(message)s")
    main()
