"""Reader of the latent states dump (``states_{split}_{iter}.h5``).

The dump holds gzip'd h5 datasets named as in H5_SETS; it is written by
the JAX package's static eval. h5py is imported only where a dump is read.
"""

import os

H5_SETS = ("src", "z", "mu", "logvar", "label", "split")


def states_path(base_folder, split, n_iter):
    return os.path.join(base_folder, f"states_{split}_{n_iter}.h5")


def read_states(path):
    import h5py
    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in H5_SETS}
