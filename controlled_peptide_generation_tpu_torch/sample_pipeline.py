"""CLaSS sampling CLI of the port.

Fit Q_xi(z), fit latent attribute heads, rejection-sample and beam-decode
until --n_samples_acc accepted peptides exist. Runs on CUDA unless
``--device cpu`` is given:

    python -m controlled_peptide_generation_tpu_torch.sample_pipeline \
        --runname myrun --Q_select_amppos 0 \
        --n_samples_per_round 5000 --n_samples_acc 100

The transformer family takes the JAX package's flags,
``--model.E_args.E_class transformer --model.G_args.G_class transformer``
(``T_args`` under each for the widths); its beam runs in the CUDA kernel
of ``ops/tfm_beam_kernel.py`` on the card, whatever ``--hw.pallas_beam``
says, and in the plain version under ``--device cpu``.

``--Q_from_full_dataloader --Q_select_amppos 1`` fits Q on the encodings
of the dataset's amp-positive train and val rows (the encoder runs on the
device; the GRU encoder's scans in the forward-only kernel B4) instead of
the states dump; the eval points and the attribute heads still come from
the states.
"""

import logging

from . import config as C
from . import pipeline
from .utils import runtime

EXTRA_ARGS = [
    ("--QClass", dict(default="mogQ")),
    ("--Q_n_components", dict(type=int, default=100,
                              help="mog num components for Q model")),
    ("--Q_covariance_type", dict(default="diag",
                                 help="mog Q covariance type full|tied|diag")),
    ("--n_samples_per_round", dict(type=int, default=5000,
                                   help="samples per rejection round")),
    ("--n_samples_acc", dict(type=int, default=100,
                             help="accepted samples to stop at")),
    ("--samples_outfn_prefix", dict(default="samples",
                                    help="output filename prefix")),
    ("--Q_select_amppos", dict(type=int, default=0,
                               help="fit Q_xi on amp-positive selection")),
    ("--Q_from_full_dataloader", dict(action="store_true", default=False,
                                      help="fit Q_z from the dataloader")),
    ("--device", dict(default="cuda", help="cuda (default) or cpu")),
]


def main(argv=None):
    cfg, args, _ = C.parse_and_finalize(argv, extra_args=EXTRA_ARGS)
    device = runtime.setup(args.device)
    C.pretty_print(cfg)
    return pipeline.run(cfg, args, device=device)


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(message)s",
                        datefmt="%m/%d/%Y %I:%M:%S %p", level=logging.INFO)
    logging.getLogger("GenerationAPI").info(
        "Sample pipeline. Fit Q_xi(z), Sample from it, score samples.")
    main()
