"""The benchmark of the PyTorch and CUDA port (``controlled_peptide_
generation_tpu_torch``) on NVIDIA GPUs.

One command runs one cell once and prints one JSON line:

    python3 -m portbench.run --workload tfm_wae.class_serve --seed 7 \\
        --seconds 10 --trace 0

``BENCHMARK.json`` at the repository root lists the cells, the
configurations and the metrics. Everything that belongs to one of them is
a file of its own that the harness finds by name: ``configs/<config>.json``
(sizes, flags, vocabulary), ``traffic/<mix>.json`` (the mix's parameters and
the driver that runs it), ``cells/<cell>.json`` (configuration, mix and the
limits of the correctness comparison) and ``metrics/<metric>.py`` (the
reader of a per-layer metric). ``reference/`` holds the plain PyTorch
references that decide ``correct``; they import neither JAX nor the port.
"""
