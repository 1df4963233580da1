"""Static evaluation of a trained run dir, the port's entry point.

    python -m controlled_peptide_generation_tpu_torch.static_eval \
        --runname myrun [--long] [--device cpu]

The battery, as the JAX package's root ``static_eval.py`` prints it:
interpolations between two encoded peptides (linear, tanh, slerp),
prior samples in each sampling mode, interpolations between two prior
latents, reconstructions (among them beam 15 from 4 draws of q(z|x)) and
a reconstruction interpolation. The beam-5 decodes run in the family's
beam kernel on the card (B1, B3), the beam-15 decodes (T·K beyond the
kernels' scope at T 25) in the plain version, where the JAX package runs
its XLA arm.

``--long`` first writes the latent states dump of each split
(``states_{split}_{iter}.npz``, and the ``.h5`` where h5py imports; up
to 10,000 rows a split) and the latent index ``index_{iter}.npz``: what
``sample_pipeline`` reads. Then, in the JAX package's order, the
diagnostics of the dump, each computed on ``--device``:

* ``vis/tsne.py``: the t-SNE of the first 2,000 train z and its figure
  per attribute (``states_train_<iter>_tsne_<attr>.png``); the latent
  discriminators' AUC and accuracy (``..._latent_discriminator.json``);
* ``vis/covar.py`` (``--covar 1``): the Frobenius distance of Cov_q(z)
  to I for positive and unlabeled rows (``..._frob_dist.txt``) and three
  figures each;
* ``vis/kde.py`` (``--kde 1``): the coverage of each point under the
  per-point posteriors (``..._kde.txt``) and a histogram each.

The figures need matplotlib; where it is not installed each diagnostic
logs once the figures it did not draw, and every number is still written.
Runs on CUDA unless ``--device cpu`` is given; the transformer family
takes ``--model.E_args.E_class transformer --model.G_args.G_class
transformer``.
"""

import logging
import os
import time

from . import config as C
from .api import (generate_interpolated_samples, get_model_and_vocab_path,
                  get_result_for_model, interpolate_peptides,
                  load_trained_model, load_vocab, pretty_print_samples,
                  recon_sequence, sample_from_model)
from .pipeline import load_dataloader
from .utils import runtime
from .vis import build_index, covar, kde, tsne

LOG = logging.getLogger("GenerationAPI")

DEFAULT_SEQS = ("M T G E I D T A M L I G G I E F F L K "
                "F A I Y Y F H E R A W Q L I R, M D K L "
                "I V L K M L N S K L P Y G Q R K P F S L R")
MAX_EXAMPLES = 10000   # rows of each split in the dump

EXTRA_ARGS = [
    ("--seqs", dict(default=DEFAULT_SEQS,
                    help="comma separated seqs to reconstruct between")),
    ("--long", dict(action="store_true", default=False,
                    help="state dump + t-SNE/latent discriminator"
                         " + covar/kde diagnostics")),
    ("--covar", dict(type=int, default=1,
                     help="with --long: Cov_q(z)-vs-identity plots")),
    ("--kde", dict(type=int, default=1,
                   help="with --long: per-point density diagnostics")),
    ("--device", dict(default="cuda", help="cuda (default) or cpu")),
]


def test_interpolated_peptides(model, params, vocab):
    for interpolation_method in ["linear", "tanh", "slerp"]:
        LOG.info("INTERPOLATING WITH %s METHOD", interpolation_method)
        peps = interpolate_peptides(
            model, params, vocab,
            "M L L L L L A L A L L A L L L A L L L",
            "M S S S S S L A A A L L",
            interpolation_kwargs={
                "c": None, "interpolation_method": interpolation_method,
                "interpolation_samples": 9},
            mb_sample_kwargs={"sample_mode": "greedy"})
        for w, p in zip(peps["interpolation"], peps["predictions"]):
            print(f"{w:.2f}", " ".join(p[0]))


def test_interpolated_z(model, params, vocab, device):
    z_start = model.sample_z_prior(runtime.generator(device, 1, 0), 1,
                                   device)
    z_end = model.sample_z_prior(runtime.generator(device, 1, 1), 1, device)
    print("# interpolate between z1, z2 sampled from prior. vary sampling")
    for kwargs in [{"sample_mode": "greedy"},
                   {"sample_mode": "beam", "beam_size": 5, "n_best": 3}]:
        print("### interpolate z1 z2 from prior: ", kwargs)
        samples = generate_interpolated_samples(
            model, params, vocab, z_start, z_end, c=None,
            interpolation_method="tanh", interpolation_samples=11, **kwargs)
        for w, p in zip(samples["interpolation"], samples["predictions"]):
            print("prior_zs - {:6s} - w={:.2f} - {}".format(
                kwargs["sample_mode"], w, " ".join(p[0])))


def test_sampling(model, params, vocab, device, n_samples=4):
    z_fix = model.sample_z_prior(runtime.generator(device, 2, 0), n_samples,
                                 device)
    c_fix = model.sample_c_prior(runtime.generator(device, 2, 1), n_samples,
                                 device)
    print("# sampled z from prior, varying sample_mode")
    for kwargs in [{"sample_mode": "greedy"},
                   {"sample_mode": "categorical", "temp": 1.0},
                   {"sample_mode": "categorical", "temp": 0.3},
                   {"sample_mode": "beam", "beam_size": 5, "n_best": 3}]:
        payload = sample_from_model(model, params, vocab, z=z_fix, c=c_fix,
                                    n_samples=n_samples, **kwargs)
        print("### prior: ", kwargs)
        print(pretty_print_samples(payload["predictions"]))


def test_reconstruction(model, params, vocab, seqs_arg):
    seqs = [s.strip().split() for s in seqs_arg.split(",")]
    for seq in seqs:
        print("#### reco of", " ".join(seq), "  -- z = mu = max_z q(z|x) ")
        for kw in [{"sample_mode": "greedy"},
                   {"sample_mode": "categorical", "temp": 1.0},
                   {"sample_mode": "categorical", "temp": 0.3},
                   {"sample_mode": "beam", "beam_size": 5, "n_best": 3}]:
            recos = recon_sequence(model, params, vocab, seq,
                                   sample_q="max", c=None, **kw)
            print(pretty_print_samples(recos["predictions"],
                                       print_all_hypotheses=False),
                  kw["sample_mode"])
        print("#### reco  of", " ".join(seq),
              "  -- beam 15, z = 4x sampled q(z|x) ")
        recos = recon_sequence(model, params, vocab, seq, sample_q=4,
                               c=None, sample_mode="beam", beam_size=15,
                               n_best=3)
        print(pretty_print_samples(recos["predictions"],
                                   print_all_hypotheses=False))


def test_reconstruction_interpol(model, params, vocab, seqs_arg):
    seqs = [s.strip().split() for s in seqs_arg.split(",")]
    for seq1, seq2 in zip(seqs[:-1], seqs[1:]):
        print("#### reco interpol start source: ", " ".join(seq1),
              "  -- z = mu = max_z q(z|x), beam 15")
        samples = interpolate_peptides(
            model, params, vocab, seq1, seq2,
            interpolation_kwargs={"c": None, "interpolation_method": "tanh",
                                  "interpolation_samples": 9},
            mb_sample_kwargs={"sample_mode": "beam", "beam_size": 15,
                              "n_best": 3})
        for w, p in zip(samples["interpolation"], samples["predictions"]):
            print(f"recon interpol - w={w:.2f} - {' '.join(p[0])}")
        print("#### reco interpol end source:   ", " ".join(seq2))


def run_battery(model, params, vocab, seqs_arg, device):
    test_interpolated_peptides(model, params, vocab)
    test_sampling(model, params, vocab, device, n_samples=4)
    test_interpolated_z(model, params, vocab, device)
    test_reconstruction(model, params, vocab, seqs_arg)
    test_reconstruction_interpol(model, params, vocab, seqs_arg)


def run_long_analysis(cfg, model, params, vocab, base, device,
                      with_covar=True, with_kde=True):
    """Write the states dump of each split (unless a readable one exists)
    and the latent index, then run the dump's diagnostics on ``device``.
    Returns {"states": {split: path}, "index": path, "discriminator":
    report, "frob_pos", "frob_unl" (with covar), "kde": {attr_tag:
    fraction} (with kde), "seconds": {split: s, "tsne": s, "covar": s,
    "kde": s}} (the seconds of the splits encoded here; "tsne" covers the
    t-SNE and the discriminators)."""
    fnames = {split: build_index.states_path(base, split, cfg.vae.n_iter)
              for split in ["train", "val", "test"]}
    seconds = {}
    if not all(build_index.readable(f) for f in fnames.values()):
        LOG.info("Extracting states.")
        _, seconds = build_index.extract_from_dataset(
            model, params, vocab, cfg, load_dataloader(cfg), base,
            cfg.vae.n_iter, max_examples=MAX_EXAMPLES)
    else:
        LOG.info("States have already been extracted: %s",
                 ", ".join(fnames.values()))
    idx_path = build_index.index_path(base, cfg.vae.n_iter)
    if not os.path.exists(idx_path):
        build_index.LatentIndex.from_states(fnames["train"], device).save(
            idx_path)
    summary = {"states": fnames, "index": idx_path, "seconds": seconds}
    attributes = C.dataset_spec(cfg)["attributes"]

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        runtime.synchronize(device)
        seconds[name] = time.perf_counter() - t0
        return out

    summary["discriminator"] = timed(
        "tsne", lambda: tsne.eval(fnames, attributes, device=device))
    if with_covar:
        summary["frob_pos"], summary["frob_unl"] = timed(
            "covar", lambda: covar.eval(fnames, device=device))
        LOG.info("Frobenius(Cov_q(z), I): positive %.3f, unlabeled %.3f",
                 summary["frob_pos"], summary["frob_unl"])
    if with_kde:
        summary["kde"] = timed(
            "kde", lambda: kde.eval(fnames, attributes, device=device))
        LOG.info("kde nonzero-density fractions: %s", summary["kde"])
    return summary


def main(argv=None):
    """Returns run_long_analysis's summary (with --long; else only
    "seconds") with the battery's seconds under seconds["battery"]."""
    cfg, args, _ = C.parse_and_finalize(argv, extra_args=EXTRA_ARGS)
    device = runtime.setup(args.device)
    model_path, vocab_path, base = get_model_and_vocab_path(cfg)
    vocab = load_vocab(vocab_path)
    model, params = load_trained_model(model_path, vocab.size(), cfg,
                                       device=device)
    try:
        get_result_for_model(model_path, print_results=True)
    except FileNotFoundError:
        LOG.info("no result.json for this run")
    summary = {"seconds": {}}
    if args.long:
        summary = run_long_analysis(cfg, model, params, vocab, base, device,
                                    with_covar=bool(args.covar),
                                    with_kde=bool(args.kde))
    t0 = time.perf_counter()
    run_battery(model, params, vocab, args.seqs, device)
    runtime.synchronize(device)
    summary["seconds"]["battery"] = time.perf_counter() - t0
    return summary


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(message)s",
                        datefmt="%m/%d/%Y %I:%M:%S %p", level=logging.INFO)
    LOG.info("Running static eval.")
    main()
