"""Where the time of a phase-1 train step goes on the card.

    python -m controlled_peptide_generation_tpu_torch.tools.profile_train \\
        [--steps 50] [--warm 20] [--out FILE.json] [flags of main.py]

Builds the model and the data as ``main.py --phase 1`` does (by default
the amp corpus at the shipped width, batch 32, seeded random weights),
runs ``--warm`` train steps, times ``--steps`` steps on the host clock,
then runs ``--steps`` more under ``torch.profiler`` and prints, per step:

* the host wall time, unprofiled and profiled (the profiler's own cost);
* the device's busy time (the union of the CUDA kernels' and copies'
  intervals) and its idle share of the profiled wall time;
* the host time of the parts of a step (batch and draws, forward,
  backward, optimizer), from ``record_function`` ranges;
* the device time of each kernel, largest first, and the launches of the
  port's kernels per step (B2's recurrences, B4, B5's value and gradient).

A step here is the trainer's own ``train_step``
(``train/train_vae.make_train_step``), whose ``record_function`` ranges
split it into its parts, after the batch and draws the trainer's loop
makes; logging, sampling and checkpoints are left out. Needs CUDA.
"""

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import config as C
from ..main import EXTRA_ARGS, load_dataset
from ..models.rnn_vae import build_model
from ..ops import gru_fwd_kernel, gru_kernel, mmd_kernel
from ..ops import losses as L
from ..train import checkpoints
from ..train import train_vae as TV
from ..utils import runtime

PARTS = ("batch+draws", "forward", "backward", "optimizer")


def _union_us(intervals):
    """Total length of the union of [start, end] intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None):
    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--steps", type=int, default=50)
    own.add_argument("--warm", type=int, default=20)
    own.add_argument("--out", default="")
    opts, rest = own.parse_known_args(argv)
    cfg, args, _ = C.parse_and_finalize(
        ["--phase", "1", "--dataset", "amp", "--seed", "1238"] + rest,
        extra_args=EXTRA_ARGS)
    dev = runtime.setup(args.device)
    if dev.type != "cuda":
        raise RuntimeError("profile_train measures the card: it needs CUDA")
    dataset = load_dataset(cfg)
    model = build_model(cfg.model, dataset.n_vocab, cfg.max_seq_len)
    params = model.init_params(runtime.generator(dev, cfg.seed), dev)
    for leaf in checkpoints.flatten(params).values():
        leaf.requires_grad_(True)
    mmd = cfg.losses.wae_mmd
    rf = L.init_rf_basis(runtime.generator(dev, cfg.seed, 1), model.z_dim,
                         mmd.rf_dim, dev)
    train_step, optimizer = TV.make_train_step(model, cfg.vae, cfg.losses,
                                               rf)
    opt_state = optimizer.init(params)
    B, T = cfg.vae.batch_size, cfg.max_seq_len

    def step(it):
        with record_function("batch+draws"):
            text = torch.from_numpy(
                dataset.next_batch("train_vae").text).to(dev)
            draws = TV.draw_step(model, runtime.generator(dev, cfg.seed, it),
                                 B, T, dev)
        train_step(params, opt_state, text, it, draws)

    def window(it0):
        runtime.synchronize(dev)
        t0 = time.perf_counter()
        for it in range(it0, it0 + opts.steps):
            step(it)
        runtime.synchronize(dev)
        return time.perf_counter() - t0

    for it in range(opts.warm):
        step(it)
    wall_plain = window(opts.warm)
    counted = (gru_kernel.gru_seq_fwd, gru_kernel.gru_seq_bwd,
               gru_kernel.gru_seq_wgrad, gru_fwd_kernel.gru_fwd,
               mmd_kernel.mmd_full_fwd, mmd_kernel.mmd_full_bwd)
    for fn in counted:
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = window(opts.warm + opts.steps)
    launches = {fn.__name__: fn.launches / opts.steps for fn in counted}

    n = opts.steps
    # the device's events, less the ranges record_function mirrors there
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name not in PARTS
                  and not getattr(e, "is_user_annotation", False)]
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in dev_events])
    per_kernel = defaultdict(lambda: [0.0, 0])
    for e in dev_events:
        per_kernel[e.name][0] += e.time_range.elapsed_us()
        per_kernel[e.name][1] += 1
    host_parts = defaultdict(float)
    for e in prof.events():
        if e.name in PARTS and e.device_type == torch.autograd.DeviceType.CPU:
            host_parts[e.name] += e.time_range.elapsed_us()
    report = {
        "card": runtime.card_line(),
        "steps": n, "batch": B,
        "wall_ms_per_step": 1e3 * wall_plain / n,
        "wall_ms_per_step_profiled": 1e3 * wall_prof / n,
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall_prof
                              if dev_events else None),
        "host_ms_per_step": {k: host_parts[k] / 1e3 / n for k in PARTS},
        "device_events_per_step": len(dev_events) / n,
        "kernel_launches_per_step": launches,
        "kernels": [{"name": k, "ms_per_step": v[0] / 1e3 / n,
                     "calls_per_step": v[1] / n}
                    for k, v in sorted(per_kernel.items(),
                                       key=lambda kv: -kv[1][0])],
    }
    print(f"[profile] {n} steps at batch {B} ({report['card']}): "
          f"{report['wall_ms_per_step']:.4f} ms per step unprofiled, "
          f"{report['wall_ms_per_step_profiled']:.4f} ms profiled; device "
          f"busy {report['device_busy_ms_per_step']:.4f} ms per step "
          f"({len(dev_events) / n:.1f} device events), idle share "
          + (f"{report['device_idle_share']:.4f}" if dev_events
             else "not measured (the profiler saw no device events)"))
    print("[profile] host ms per step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in report["host_ms_per_step"].items()))
    print(f"[profile] the port's kernel launches per step: {launches}")
    for row in report["kernels"][:15]:
        print(f"[profile]   {row['ms_per_step']:.4f} ms/step, "
              f"{row['calls_per_step']:.1f} calls/step: {row['name'][:100]}")
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return report


if __name__ == "__main__":
    main()
