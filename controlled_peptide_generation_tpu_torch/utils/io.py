"""Host-side artifact IO: generated samples and FASTA files."""

import os


def _ensure_dir(fn):
    fn_dir = os.path.dirname(fn)
    if fn_dir:
        os.makedirs(fn_dir, exist_ok=True)


def write_gen_samples(samples, fn, c_lab=None):
    """samples: list of strings, one line each; with c_lab (one label per
    sample) each sample is preceded by a 'label: y' line."""
    _ensure_dir(fn)
    with open(fn, "w+") as f:
        if c_lab is not None:
            if len(c_lab) != len(samples):
                raise ValueError(f"{len(c_lab)} labels for {len(samples)} "
                                 f"samples")
            f.writelines(f"label: {y}\n{s}\n" for y, s in zip(c_lab, samples))
        else:
            f.write("\n".join(samples) + "\n")


def write_fasta(samples, fn):
    """One FASTA record per non-empty sample string of residues."""
    _ensure_dir(fn)
    with open(fn, "w") as f:
        for i, s in enumerate(samples):
            s = s.replace(" ", "")
            if s:
                f.write(f"> {i + 1} {len(s)}\n{s}\n")
