"""Where the time of a train step goes on the card, phase 1 or phase 2.

    python -m controlled_peptide_generation_tpu_torch.tools.profile_train \\
        [--phase 1|2] [--steps 50] [--warm 20] [--unroll 1] \\
        [--out FILE.json] [flags of main.py]

Builds the model and the data as ``main.py`` does (by default the amp
corpus at the shipped width, batch 32, seeded random weights; in phase 2
with a seeded classifier), runs ``--warm`` steps, times ``--steps`` steps
on the host clock, then runs ``--steps`` more under ``torch.profiler``
and prints, per step:

* the host wall time, unprofiled and profiled (the profiler's own cost);
* the device's busy time (the union of the CUDA kernels' and copies'
  intervals) and its idle share of the profiled wall time;
* the host time of the parts of a step (phase 1: batch and draws,
  forward, backward, optimizer; phase 2: batch and draws, the VAE, the
  attribute and the classifier update, each with its optimizer; with
  ``--unroll``: batches, the chunk's staging and its replay), from
  ``record_function`` ranges;
* the device time of each kernel, largest first, and the launches of the
  port's kernels per step (B2's recurrences, B4, B5's value and gradient);
* the device launches inside and outside a chunk's graph, and the graph's
  nodes, capture and instantiate seconds and memory.

A step here is the trainer's own step (phase 1 ``train_step``,
``train/train_vae.make_train_step``; phase 2 ``train/train_full.FullStep``),
whose ``record_function`` ranges split it into its parts, after the batch
and draws the trainer's loop makes. With ``--unroll N`` (N > 1) it is a
replay of the trainer's chunk of N steps (``TrainChunk``, ``FullChunk``)
divided by N (``--steps`` and ``--warm`` are rounded up to whole chunks;
the warm chunks include the capture): the launches inside are the graph's
kernel nodes per step, those outside the device events a second profiled
window of the chunks' staging alone (draws and copies) records, and what
the profiler saw during the replays is the first window's events less
those; one more replay, launched with the device idle, times the graph's
launch on the host (it moves the params on: a measurement only).
Logging, sampling and checkpoints are left out. Needs CUDA.
"""

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import config as C
from ..main import EXTRA_ARGS, load_dataset
from ..models.rnn_vae import build_model
from ..ops import losses as L
from ..train import checkpoints
from ..train import train_full as TF
from ..train import train_vae as TV
from ..train.chunk import launch_counters
from ..utils import runtime

PARTS = {1: ("batch+draws", "forward", "backward", "optimizer"),
         2: ("batch+draws", "vae update", "attribute update",
             "classifier update", "optimizer")}
CHUNK_PARTS = ("batches", "train.stage", "train.launch")


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


def _phase1(cfg, model, dataset, params, rf, dev, unroll):
    """(step(it), stage(it), chunk) of the phase-1 trainer."""
    flat = C.flat_optimizer_enabled(cfg)
    train_step, optimizer = TV.make_train_step(model, cfg.vae, cfg.losses,
                                               rf, flat)
    opt_state = optimizer.init(params)
    B, T = cfg.vae.batch_size, cfg.max_seq_len
    chunk = (TV.make_train_chunk(model, cfg.vae, cfg.losses, rf, unroll,
                                 cfg.seed, flat) if unroll > 1 else None)

    def texts():
        return np.stack([dataset.next_batch("train_vae").text
                         for _ in range(unroll)])

    def step(it):
        if chunk is None:
            with record_function("batch+draws"):
                text = torch.from_numpy(
                    dataset.next_batch("train_vae").text).to(dev)
                draws = TV.draw_step(
                    model, runtime.generator(dev, cfg.seed, it), B, T, dev)
            train_step(params, opt_state, text, it, draws)
            return
        with record_function("batches"):
            batch = texts()
        chunk(params, opt_state, batch, it)

    return step, lambda it: chunk.stage(texts(), it), chunk


def _phase2(cfg, model, dataset, params, rf, dev, unroll):
    """(step(it), stage(it), chunk) of the phase-2 trainer."""
    full_step = TF.FullStep(model, cfg.full, cfg.losses, rf)
    opt_states = full_step.init(params)
    T = cfg.max_seq_len
    attr = dataset.attributes[0][0]
    chunk = (TF.FullChunk(model, cfg.full, cfg.losses, rf, unroll, cfg.seed)
             if unroll > 1 else None)

    def batch():
        lab = dataset.next_batch("train_amp_lab")
        return (dataset.next_batch("train_vae").text, lab.text,
                np.maximum(getattr(lab, attr), 0))

    def batches():
        return [np.stack(b) for b in zip(*(batch() for _ in range(unroll)))]

    def step(it):
        if chunk is None:
            with record_function("batch+draws"):
                text, lab_text, lab_y = (torch.from_numpy(b).to(dev)
                                         for b in batch())
                draws = TF.draw_full_step(
                    model, runtime.generator(dev, cfg.seed,
                                             TF._STEP_STREAM, it),
                    text.shape[0], lab_text.shape[0], T, dev, cfg.full)
            full_step(params, opt_states, text, lab_text, lab_y, it, draws)
            return
        with record_function("batches"):
            b = batches()
        chunk(params, opt_states, *b, it)

    return step, lambda it: chunk.stage(*batches(), it), chunk


def main(argv=None):
    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--phase", type=int, choices=(1, 2), default=1)
    own.add_argument("--steps", type=int, default=50)
    own.add_argument("--warm", type=int, default=20)
    own.add_argument("--unroll", type=int, default=1)
    own.add_argument("--out", default="")
    opts, rest = own.parse_known_args(argv)
    cfg, args, _ = C.parse_and_finalize(
        ["--phase", str(opts.phase), "--dataset", "amp", "--seed", "1238"]
        + rest, extra_args=EXTRA_ARGS)
    dev = runtime.setup(args.device)
    if dev.type != "cuda":
        raise RuntimeError("profile_train measures the card: it needs CUDA")
    dataset = load_dataset(cfg)
    model = build_model(cfg.model, dataset.n_vocab, cfg.max_seq_len)
    params = model.init_params(runtime.generator(dev, cfg.seed), dev)
    if opts.phase == 2:
        params["clf"] = model.init_classifier(
            runtime.generator(dev, cfg.seed, 5), dev)
    for leaf in checkpoints.flatten(params).values():
        leaf.requires_grad_(True)
    mmd = cfg.losses.wae_mmd
    rf = L.init_rf_basis(runtime.generator(dev, cfg.seed, 1), model.z_dim,
                         mmd.rf_dim, dev)
    unroll = max(opts.unroll, 1)
    step, stage, chunk = (_phase2 if opts.phase == 2 else _phase1)(
        cfg, model, dataset, params, rf, dev, unroll)
    B = cfg.vae.batch_size
    parts = CHUNK_PARTS if chunk is not None else PARTS[opts.phase]
    n = -(-opts.steps // unroll) * unroll
    warm = -(-opts.warm // unroll) * unroll

    def window(it0, stage_only=False):
        runtime.synchronize(dev)
        t0 = time.perf_counter()
        for it in range(it0, it0 + n, unroll):
            if stage_only:
                stage(it)
            else:
                step(it)
        runtime.synchronize(dev)
        return time.perf_counter() - t0

    for it in range(0, warm, unroll):
        step(it)
    wall_plain = window(warm)
    counted = launch_counters()
    for fn in counted:
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = window(warm + n)
    launches = {fn.__name__: fn.launches / n for fn in counted}

    def device_events(prof_):
        # the device's events, less the ranges record_function mirrors
        return [e for e in prof_.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in parts
                and not getattr(e, "is_user_annotation", False)]

    dev_events = device_events(prof)
    outside = len(dev_events) / n
    graph = None
    if chunk is not None:
        with profile(activities=[ProfilerActivity.CUDA]) as prof_stage:
            window(warm + 2 * n, stage_only=True)
        outside = len(device_events(prof_stage)) / n
        # one replay's host time with the device idle: the launch alone,
        # against the replay's host time in the window (which may wait)
        runtime.synchronize(dev)
        t0 = time.perf_counter()
        chunk.graph.replay()
        launch_ms = 1e3 * (time.perf_counter() - t0)
        runtime.synchronize(dev)
        kinds = chunk.node_kinds
        graph = {**chunk.stats(),
                 "replay_launch_ms_idle_device": launch_ms,
                 "kernel_nodes_per_step": kinds.count("kernel") / unroll,
                 "other_nodes_per_step": (len(kinds) - kinds.count("kernel"))
                 / unroll,
                 "profiled_replay_events_per_step":
                     len(dev_events) / n - outside}
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in dev_events])
    per_kernel = defaultdict(lambda: [0.0, 0])
    for e in dev_events:
        per_kernel[e.name][0] += e.time_range.elapsed_us()
        per_kernel[e.name][1] += 1
    host_parts = defaultdict(float)
    for e in prof.events():
        if e.name in parts and e.device_type == torch.autograd.DeviceType.CPU:
            host_parts[e.name] += e.time_range.elapsed_us()
    report = {
        "card": runtime.card_line(), "phase": opts.phase,
        "steps": n, "batch": B, "unroll": unroll,
        "wall_ms_per_step": 1e3 * wall_plain / n,
        "wall_ms_per_step_profiled": 1e3 * wall_prof / n,
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall_prof
                              if dev_events else None),
        "host_ms_per_step": {k: host_parts[k] / 1e3 / n for k in parts},
        "device_events_per_step": len(dev_events) / n,
        "device_launches_outside_graph_per_step": outside,
        "graph": graph,
        "kernel_launches_per_step": launches,
        "kernels": [{"name": k, "ms_per_step": v[0] / 1e3 / n,
                     "calls_per_step": v[1] / n}
                    for k, v in sorted(per_kernel.items(),
                                       key=lambda kv: -kv[1][0])],
    }
    print(f"[profile] phase {opts.phase}: {n} steps at batch {B}, unroll "
          f"{unroll} "
          f"({report['card']}): "
          f"{report['wall_ms_per_step']:.4f} ms per step unprofiled, "
          f"{report['wall_ms_per_step_profiled']:.4f} ms profiled; device "
          f"busy {report['device_busy_ms_per_step']:.4f} ms per step "
          f"({len(dev_events) / n:.1f} device events), idle share "
          + (f"{report['device_idle_share']:.4f}" if dev_events
             else "not measured (the profiler saw no device events)"))
    print("[profile] host ms per step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in report["host_ms_per_step"].items()))
    print(f"[profile] the port's kernel launches per step: {launches}")
    if graph is not None:
        print(f"[profile] device launches per step: inside the graph "
              f"{graph['kernel_nodes_per_step']:.2f} kernel nodes (and "
              f"{graph['other_nodes_per_step']:.2f} other nodes), outside "
              f"{outside:.2f} (the staging: draws and copies); the profiler "
              f"saw {graph['profiled_replay_events_per_step']:.2f} device "
              f"events a step during the replays; one replay's launch "
              f"with the device idle {graph['replay_launch_ms_idle_device']:.4f}"
              f" ms of host time; the graph: {graph['nodes']} nodes, capture "
              f"{graph['capture_s']:.3f} s, instantiate "
              f"{graph['instantiate_s']:.3f} s, pool {graph['pool_bytes']} "
              f"bytes, executable {graph['exec_bytes']} bytes")
    for row in report["kernels"][:15]:
        print(f"[profile]   {row['ms_per_step']:.4f} ms/step, "
              f"{row['calls_per_step']:.1f} calls/step: {row['name'][:100]}")
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return report


if __name__ == "__main__":
    main()
