#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. device: CUDA is required; prints the card's name and power limit;
2. build: compiles the GRU beam kernel (csrc/beam_gru.cu), the GRU
   recurrence kernels of training (f32 and bf16) and the forward-only scan
   (csrc/gru_seq.cu), the transformer beam kernel (csrc/tfm_beam.cu) and
   the WAE-MMD kernels (csrc/mmd_full.cu) with nvcc, and the native
   tokenizer (native/_tokenizer.c) with gcc, one process per
   source, started together before torch is imported, so the imports and
   the device's start-up run meanwhile; prints ptxas' registers and spills,
   and for the GRU scan's instantiations (forward-only and the training
   forward's with residual stores), the backward's at H 80, 102 and 128,
   the bf16 scan's and backward's on the tensor cores (their plans at H
   80, 102 and 127, B 32 and 1,024) and the weight-gradient kernels, f32
   and bf16 on the tensor cores (from gru_kernel.build_log), fails on any
   spill; the MMD kernels' lines (mmd_kernel.ptxas_report) too, the
   value's and the gradient's (cuda_build.check_no_spills);
3. beam kernel vs its plain torch version at the shipped width (V 24,
   H 102, T 25, K 5, n_best 1, fp32, seeded weights) for B in {1, 37,
   2500, 5000, 6144, 12288}: >= 99% of rows with identical token/pointer
   tapes; on the agreeing rows adv and fin_cnt equal and the sc tape and
   final scores within 1e-3 of each other; exact batch invariance (the
   first 2500 rows at B = 12288 equal B = 2500 bitwise); the same
   agreement at the edges of the kernel's scope (SCOPE_CASES);
3t. the transformer beam kernel (B3) vs its plain version at the shipped
   transformer width (d_model 128, 2 layers, d_ff 256, 4 heads, emb 150,
   z 100, V 24, T 25, K 5, n_best 1, fp32, seeded weights) for B in
   B3_BATCHES, with the same gates and batch invariance (B 12288 against
   B 2500), and at the scope edges (B3_SCOPE_CASES);
3-bf16, 3t-bf16. the bf16 forms of B1 and B3 (entries beam_gru_bf16 and
   tfm_beam_bf16) vs their plain versions on the same inputs, the weight
   tree cast to bf16 as --hw.gen_dtype bfloat16 casts it, and for B3 also
   T_args.bf16 over the f32 weights, at the shipped widths for B in
   BF16_BATCHES and at the scope edges (SCOPE_CASES, B3_SCOPE_CASES),
   with the gates stated at BF16_*: (a) the first 2500 rows at B 12288
   equal B 2500 bitwise; (b) at T 1 >= 99% identical token rows, |score
   delta| <= 2e-2 on them; (c) at T 25 every emitted top-1 hypothesis's
   score within rtol 2e-2, atol 0.3 of its teacher-forced recompute under
   the plain version; (d) at T 25 >= 70% identical rows; (e) unique
   decodes of the kernel over the plain version's at B 5000 within
   [0.99, 1.01];
3s. where the beams' time goes: B1 and B3, f32 and bf16, at B 5000 and
   2500 through their stamp entries (the same kernels compiled with phase
   clocks, tools/beam_split.py; measurement only, never on the main path):
   the share of block 0's and the last block's clock cycles per phase, the
   wave each ran in, and the stamp entry's tapes bitwise equal to the
   production entry's; ptxas' registers and spills of every production
   and stamp instantiation;
4. the GRU recurrence kernels (the training forward with its residual
   tape, the backward, the weight gradient) vs their plain versions at the
   encoder and decoder widths (in 150, H 80; in 252, H 102), T 25, B in
   B2_BATCHES, and at the scope edges (B2_SCOPE_CASES): hs and the
   residuals within 1e-4, each gradient within 1e-3 of its largest entry
   against both plain versions of the backward (the chain given the
   kernel forward's residuals, and the full recompute), the backward
   bitwise repeatable; at B 32 of each width, gru_scan through autograd in
   both directions against the same scan inside cuda_build.plain(), all
   six gradients; at B 32 and 1,024 of both widths, two weight-gradient
   runs bitwise equal and within 1e-3 of one torch.mm's largest entry;
4b. the forward-only scan (B4) vs its plain version at both widths, T 25,
   both directions, B in B4_BATCHES (the tape a strided view, as gru_scan
   passes it) and at the scope edges: hs and h_T within 1e-4; B 20000's
   first B rows equal every smaller B bitwise (1 to 8 rows per block);
   B2's forward (the same scan through its training entry, with and
   without its residual stores) equal to B4's hs bitwise at B 32;
4m. the WAE-MMD kernels (B5, value and gradient) vs their plain versions
   for the gaussian, laplace and energy forms at N in B5_NS, D 100, and at
   D 1 and the scope's largest D 256: the value within 1e-5, both
   gradients within 1e-4 of their largest entry, bitwise repeatable; at
   N 1 (a batch of one row) the value and both gradients NaN, as the plain
   versions give; 200 value calls interleaving N in B5_LOOP_NS (one block
   and many), each N's values bitwise equal call to call (the completion
   counter resets); one call at N 32 and one at 4096 captured in a CUDA
   graph hold one kernel node each (no finish launch, no memset), and ten
   replays give the eager value's bits and leave the counter at 0;
5. the CLaSS main path: the pipeline (pipeline.run_from_states, what
   sample_pipeline runs after its file reads) on a run dir holding a
   seeded full-width checkpoint written by the port's saver, with a
   synthetic latent corpus; mogQ with 100 diag components, rounds of 5000
   until 100 unique accepted, in decode modes "all" and "accepted"; the
   beam kernel's launch count must rise; one round with the kernel and one
   with the plain version (plain=True) on the same draws must agree;
5t. the transformer family's CLaSS main path, the same way: a seeded
   full-width transformer checkpoint written by the port's saver, both
   decode modes, the B3 kernel's launch count must rise, one round through
   the kernel and one with plain=True on the same draws must agree;
5-bf16, 5t-bf16. the CLaSS main path decoded in bf16: both families
   under --hw.gen_dtype bfloat16 and the transformer with T_args.bf16 over
   its f32 weights, both decode modes, the bf16 entry's launch count must
   rise; on the same draws one round through the kernel and one with
   plain=True give identical accept masks, tokens within gates (c) and
   (d);
6. the training main path: ``main.main --phase 1 --dataset amp`` at the
   shipped width and batch 32 for 301 steps at the default --hw.unroll 50
   (step 0 eagerly, steps 1-300 as six replays of one captured 50-step
   CUDA graph; its kernel nodes printed): B2 launched 3 times per step
   each, B4 3 times per heldout batch (4 batches per checkpoint), B5's
   value once per step and its backward never (counted through the
   replays); finite losses, recon
   falling, checkpoints at 150 and 300 reloading with their Adam moments,
   vae_gen.txt over the vocab; then one step from the same params, batch
   and draws through the kernels and inside cuda_build.plain() (B2 and B5
   as their plain versions) must agree; then 51 steps with
   ``--vae.z_regu_loss mmd`` (five replays of a 10-step graph): B5's
   value and backward once per step, finite and falling loss;
6t. the transformer family's training main path, the same way (its
   flags, the shipped T_args, batch 32, 301 steps): B5 once per step and
   no other kernel, the same output checks, one step through the kernels
   and inside plain() agreeing (loss rtol 1e-5, gradients 1e-3 of each
   tensor's largest entry);
6p. both families' 301 steps again at --hw.unroll 1 (every step eager):
   the same launches, model_300.npz within 1e-5 of each array's largest
   entry of phase 6's and the logged losses within rtol 1e-5; their
   steps/s are [7]'s yardstick;
6u. 51 steps at cadences 25 / 50 of each family, the default --hw.unroll
   (two replays of a 25-step graph) against --hw.unroll 1 from one seed:
   every array of model_50.npz within 1e-5 of its largest entry (bitwise
   is expected), the logged losses within rtol 1e-5, the same launches;
6f. 51 steps with --hw.flat_optimizer on through the chunks: finite
   losses, recon falling, model_50.npz reloading with count 51 and a
   nonzero v; two updates (the first clipped) from the same params and
   grads, flat against per-leaf Adam, params and m within 1e-5 of each
   tensor's largest entry;
6e. the static eval main path: static_eval.main --long on the phase-6
   GRU run writes the states dump (the .npz: the card has no h5py; 10,000
   rows a split) and the latent index, then prints its battery into
   chiprun_out/: B4 launched 120 times in the dump (20 chunks a split, two
   directions) and 36 in the battery (18 encodes), B1 4 times (the beam-5
   decodes), the plain beam 3 times (beam 15, outside the kernels' scope);
   a second --long on the same run dir finds the dump and runs the
   battery alone (B4 36); the dump's mu, logvar and z within one float16
   ulp plus MAX_HS_DELTA (5d's f32 gate: near zero a float16 ulp is finer
   than the f32 difference of two summation orders) of the same dump
   under cuda_build.plain(), src, label and split equal;
   LatentIndex.search on the card equal to a numpy top-k; the dump's
   seconds per split and the battery's; --long's diagnostics on the card
   (t-SNE and the latent discriminators, covar, kde): their artifacts
   (_latent_discriminator.json, _frob_dist.txt, _kde.txt), finite
   numbers, every figure drawn or named in a "figures not drawn" log line
   (the card's machine has no matplotlib), their seconds;
6e-t. the same on the phase-6t transformer run: its dump, and B3
   launched 4 times in the battery, the plain beam 3 times, B4 never;
   its diagnostics and their seconds;
6v. the diagnostics on the card against the same functions with
   device="cpu" on the phase-6e GRU dump: the latent discriminators' AUCs
   within 1e-4, the Frobenius distances rtol 1e-6, kde's per-point
   non-zero fractions (the first 500 amp-positive and unlabeled rows
   against all 10,000) within one Gaussian (1 / n_train), t-SNE at 500
   points with P within 1e-6 and the final KL within 1%; then the times
   at full size: t-SNE at 2,000 points (seconds, iterations), the
   discriminators, build_covar (host clock), density_stats at 500 x
   10,000 (CUDA events);
5d. the dataloader encodings (run after 6: they encode the phase-6 GRU
   run): pipeline.get_encodings_from_dataloader on its amp-positive train
   and val rows, 2 B4 launches per batch, mu and logvar within 1e-4 of the
   same encode inside plain(); then run_from_states with
   --Q_from_full_dataloader on that run and its dump (read from disk)
   until accepted samples are written, with its rounds and accept rate;
6a. PeptideEvaluator.similarity's aligner (run after 5d): 5d's accepted
   samples against the amp corpus's train split, 100 x 100 drawn under
   one random.seed on the card and on the CPU: the same similarity list,
   the scores on the card equal to the CPU's exactly, align_scores' time
   at those 10,000 pairs (CUDA events);
5d-bf16. the sampling CLI as a user runs it, sample_pipeline.main with
   --Q_from_full_dataloader and --hw.gen_dtype bfloat16 on the phase-6 GRU
   run, reading the phase-6e dump from disk: B4 twice per encode batch,
   the bf16 B1 entry launched, accepted samples written, the rounds it
   launched;
5s. the serial loop as a user runs it, sample_pipeline.main
   --hw.fused_rounds 0 at rounds of 5,000 on the phase-6 GRU run and on the
   phase-6t transformer run, each reading its phase-6e dump from disk: the
   sample files written, peptides unique, at least 100 accepted, B1 (B3)
   launched exactly 5 times a round (chunks of 1,024) and the plain beam
   never; decode_from_z of one round's latents and c through the kernel
   against plain=True (>= 99% identical rows, |score delta| <= 1e-3 on
   them), each family; a serial round's host-clock time beside a fused
   decode-all round's on the same run;
8. the server as a user runs it: build_server on the phase-6 GRU run
   (round 5,000), start(), make_http_server on 127.0.0.1 port 0; one
   request of 64, 16 concurrent urllib clients x 64, one request of 12,000
   (several bounded rounds in flight); /healthz, /stats, a 400 and a 404;
   every 200 response exactly n rows, no peptide twice, their count
   /stats's served, candidates rounds x 5,000, B1 launched once a round
   and the plain beam never; the first round equal, in order and bit for
   bit, to the deduped accepted rows of one pipeline.launch_round with
   round_generator(seed, 1) outside the server; a request still queued at
   stop() raises and the worker thread ends; latency p50 and p99 of the
   burst, served rows/s and the stage split;
8t. the transformer's server on the phase-6t run for one request: B3
   launched once a round;
9. phase-2 training as a user runs it: ``main.main --phase 2`` of the GRU
   family at the shipped width (classifier 3 x 100 filters, batch 32,
   ``--dataset amp``) from phase 6's model_300.npz for FULL_ITERS + 1
   steps (cadences 25 / 50: four replays of a 25-step CUDA graph), and of
   the transformer family from phase 6t's for FULL_ITERS_T + 1 (cadences
   7 / 15: every step eager): full_gen.txt with its label lines,
   full_samez/posz/interp.txt,
   the FASTAs and a last checkpoint with the classifier, finite logged
   losses; B2 launched 5 times a GRU step each (three recurrences in the
   VAE update, two in encode(soft)), B4 twice (the artifacts' encode),
   B5 never (mmdrf), no kernel for the transformer; per family one step's
   three sub-losses and every group's gradients under --full.z_regu_loss
   mmd (B5's value and gradient once) through the kernels against
   cuda_build.plain() on the same params, batches and draws (losses rtol
   1e-5, gradients MAX_GRAD_REL of each tensor's largest entry), then
   three steps on the host clock and one under torch.profiler (device
   events, busy ms, idle share); 11 GRU steps under --full.z_regu_loss mmd
   through main.main (B5 once a step each way); then each mixed family
   (a transformer encoder with a GRU decoder, and the reverse): 51
   phase-1 steps at cadences 25 / 50 (two replays of a 25-step CUDA graph:
   the draws of both families' parts), B2 and B4 for the GRU part alone,
   B5 once a step; the phase-6 output checks; one step through the
   kernels against plain(); one fused CLaSS round through B1 (B3)
   against plain=True on the same draws ([5]'s gates);
9u. the phase-2 chunk (--hw.unroll): phase 2 of the GRU family, 51
   steps at cadences 25 / 50 (two replays of a 25-step graph), of the
   transformer, 21 steps at cadences 10 / 20 (two replays of a 10-step
   graph), and of the GRU-transformer pairing under --full.z_regu_loss
   mmd (21 steps at cadences 10 / 10), each at the default --hw.unroll
   against --hw.unroll 1 from one seed: the same launches (B2 5 x steps
   each way for the GRU, 4 for the pairing; B5 once a step each way
   under mmd, counted through the replays), every array of the last
   checkpoint within MAX_UNROLL_REL of its largest entry (bitwise is
   expected; a miss runs unroll 1 again and prints whether the per-step
   path repeats itself), the logged losses within rtol 1e-5; each graph's
   kernel nodes, capture and instantiate seconds; then both families'
   chunks at the default unroll 50 (cadences 50 / 50, one capture and one
   replay): nodes, capture and instantiate seconds, the graph pool's and
   the executable's bytes; then 101 phase-1 GRU steps under
   --hw.profile_dir (step 0, then four replays of a 25-step graph): one
   trace file of the bounded window, boundaries 3-4 (the last two
   replays) and no others, whose kernel events hold those replays' B2
   and B5 kernels and no eager step's;
10. the model's options at the shipped width: skip connections, a
   posterior alternating flow of 4 layers, deconv (100 filters, kernel
   4, 3 layers) and deconv with useRNN (its GRU at H 150, beyond the
   kernels' H 128: the plain recurrence, counted in
   gru_scan.plain_runs); each 51 phase-1 steps at cadences 25 / 50 (two
   replays of a 25-step CUDA graph): B2 for the encoder's two directions
   (and the GRU decoder), B4 for the same scans of the heldout eval, B5
   once a step; the phase-6 output checks; one step through the kernels
   against plain(); sample_pipeline's fused loop (rounds of 5,000 until
   one accepted): B1 once a round for the flow, the plain beam once a
   round for skip (outside B1's scope), the replay beam
   (beam_search_logits) once a round for deconv; one round's draws
   through the route and through plain=True ([5]'s gates); for skip the
   card's plain beam against the CPU's on 256 latents; the deconv serial
   loop (five replay beams a round, the last chunk padded); the deconv
   server through build_server for one request of 8; the skip model's
   phase 2 for 5 steps (B2 five times a step, B4 twice); static_eval.main
   --long on the skip run (phase 6e's function): B4 launched 120 times in
   its dump and 36 in the battery, the plain beam 7 times (every beam
   decode: skip is outside B1's scope), the dump at 10,000 rows a split,
   the index and the diagnostics' artifacts;
11. data parallelism (parallel/), on the one card, each rank a process of
   parallel.dist.spawn running dp_rank_jobs, which reports the kernels'
   counts of each run: [11] main.main --hw.dp 2 (batch 32, 16 rows a
   rank, --hw.unroll 1) on 2 gloo ranks on cuda:0 (NCCL refuses two ranks
   on one device) for GRU phase 1 (41 steps), the transformer (11 steps)
   and GRU phase 2 (11 iterations from phase 6's run), each against
   --hw.dp 1 of the same flags: every checkpoint array within rtol 2e-4 /
   atol 2e-5, the logged losses within rtol 1e-4, each rank's B2 and B5
   counts those of the one-rank run; [11z] the same GRU run under
   --hw.zero 1 (gloo reduce-scatters and all-gathers CUDA tensors) against
   the one-rank run; [11g] under an NCCL group of world 1 through the DP
   path (--hw.dp 0), phase 6's 301 GRU steps and 9u's 51 phase-2
   iterations at --hw.unroll 50: the chunk's graph holds NCCL's kernels
   (the gradients' and the metrics' averages) and replays, the checkpoint
   within MAX_UNROLL_REL of the run without a group (bitwise is
   expected), the same launches; a traced run's NCCL share of kernel
   time; [11r] the round of both families over [cuda:0, cuda:0]
   (parallel.rounds) against one device on the same draws, decode-all and
   accepted-only: accept, tokens, idx and valid bitwise equal, B1 / B3
   once a device a round, and run_from_states over that list; [11s] the
   server built on the same list answers one request of 64 unique
   peptides;
12. tensor and pipeline parallelism of the transformer family at the
   shipped width, batch 32, --hw.unroll 1, on gloo ranks on cuda:0
   (mp_phase): [12t] --hw.tp 2, [12p] --hw.pp 2, [12x] the mixed family
   (GRU encoder) at --hw.tp 2, each 11 phase-1 steps, and [12f] 11
   phase-2 iterations at --hw.tp 2 (under mmd) from [12t]'s checkpoint, on
   2 ranks; [12m] --hw.tp 2 --hw.pp 2 on 4 ranks; each against main.main
   of the same flags on one rank: every checkpoint array within [11]'s
   bounds, the logged losses within rtol 1e-4, each rank's B5 counts (and
   B2's and B4's in [12x]) those of the one-rank run;
13. the data path and B2 in bf16 (data_bf16_phase): (a) synthetic raw
   sources from a seed (RAW_CARDS DBAASP cards, SATPDB, AMPEP, UniProt,
   ToxinPred and solubility files, data/curation.py write_synthetic_raw)
   through the curation CLI (python -m ...data.curation), the seven CSVs
   and its counts; (b) the native tokenizer (built from
   native/_tokenizer.c in [2]'s pool with the CUDA sources; every loader
   since [6] uses it), the curated corpus's loader tokens equal to its plain
   path's (Vocab.to_ix row by row) bit for bit, both timed on
   TOKENIZE_ROWS rows; (c) main.main --phase 1 --dataset amp on the
   curated corpus at the default GRU width, 51 steps (step 0, then one
   replay of a 50-step CUDA graph): B2 3 times a step each, B4 12, B5's
   value once a step, recon falling; (d) B2's bf16 entries (the training
   forward with its f32 residual tape, the backward, the weight gradient)
   against their plain versions (the backward against both: the chain
   from the kernel's residuals and the recompute) at T 25, B in
   B2_BF16_BATCHES, H 80 and 102: each bf16 output bitwise equal on >=
   B2_BF16_SAME of its entries, every output within B2_BF16_ULPS bf16 ulps
   of its largest entry, each entry run twice, bitwise equal, the
   tape-less forward's hs equal to the taped one's, and batch invariance
   (the B 32 run is on the first 32 rows of the B 1,024 inputs and gives
   those rows' bits);
   their times (CUDA events), bounds in bytes and the library calls
   (torch.nn.GRU in bf16 on cuDNN, forward and data backward; one bf16
   torch.mm for dWh); the three entries at the scope edges
   B2_BF16_WGRAD_EDGES (an odd H, 127; B 5, 9, 33, no multiple of the
   rows a block; T*B not a multiple of the weight gradient's slice) under
   the same gates, twice; (e) a bf16 gru_scan through autograd, and one without, at B 32, both widths and directions,
   against the same scans inside cuda_build.plain() under (d)'s gates:
   B2's bf16 entries launched (counts set to 0 just before), B4 and the
   f32 entries not; a bf16 scan at H 128 raises;
7. prints times beside the card's name and power limit (kernels, their
   plain versions and bounds; B2's training forward with and without its
   residual stores, backward and weight gradient at B 32 and 1,024 at
   both widths, beside cuDNN's GRU forward, whole backward and data
   backward (input and h0 only) and the cuBLAS product that the
   weight-gradient kernel computes, and B2's launches x (time - bound) a
   GRU step; B4, also at the dump's shape, B 512 at H 80, beside cuDNN's
   forward; B5, its gradient at B5_TIMED_NS; B2 in bf16; B2's bf16
   entries and B5's gradient beside the recorded times of the kernels
   they replaced (B2_BF16_BEFORE_MS, B5_BWD_BEFORE_MS); train steps/s
   of both families at --hw.unroll 50 and 1, the transformer beam and round times, the bf16 kernels and rounds, phase-2 steps/s of
   both families and B2's launches a phase-2 step, seconds per phase),
   a `kernels` JSON line, and as the last line {"ok": true, "device":
   {...}}.
"""

import contextlib
import csv
import json
import logging
import os
import random
import shutil
import statistics
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
V, H, T, K = 24, 102, 25, 5
BATCHES = (1, 37, 2500, 5000, 6144, 12288)
# (T, K, V, H, min_length, n_best) beyond the shipped width
SCOPE_CASES = ((25, 5, 24, 102, 4, 3), (10, 3, 13, 14, 4, 3),
               (25, 10, 128, 127, 1, 1), (2, 126, 128, 127, 1, 2))
MIN_SAME_ROWS = 0.99
MAX_SCORE_DELTA = 1e-3
# B2: (input width, H) of the encoder and the decoder at the shipped width
B2_WIDTHS = ((150, 80), (252, 102))
B2_BATCHES = (1, 5, 32, 37, 256, 1024, 4096)
B2_SCAN_BATCH = 32       # gru_scan through autograd: the training batch
# (in, H, B, T) at the edges of the kernels' scope: one step, the largest
# H, batches that are no multiple of the rows per block
B2_SCOPE_CASES = ((252, 102, 37, 1), (16, 128, 37, 25), (16, 128, 5, 1),
                  (8, 1, 33, 25))
MAX_HS_DELTA = 1e-4      # sequential FMAs against cuBLAS sums
MAX_GRAD_REL = 1e-3      # of each gradient tensor's largest entry
# the deconv decoder's gradients: of the larger of each tensor's largest
# entry and this share of the tree's largest gradient (a gradient whose
# exact value is 0 is rounding noise; see step_vs_plain)
DECONV_GRAD_FLOOR = 0.1
TRAIN_ITERS = 300
ROUND_REPS = 21          # host-clock round timings: the host's CPU is shared
OPT_ROUND_REPS = 5       # [10]: a round of each model option
# B3: the transformer beam at the shipped transformer width
TFM_FLAGS = ["--model.E_args.E_class", "transformer",
             "--model.G_args.G_class", "transformer"]
B3_BATCHES = (1, 17, 37, 2500, 5000, 12288)
# (what, T, K, min_length, n_best, model overrides) at the scope's edges
B3_SCOPE_CASES = (
    ("min_length 4, n_best 3", 25, 5, 4, 3, {}),
    ("K 3", 25, 3, 1, 1, {}),
    ("T*K 256", 16, 16, 1, 2, {}),
    ("S 32", 31, 8, 1, 1, {"max_seq_len": 31}),
    ("d_ff 512 (two ff chunks), 8 heads, V 127", 25, 5, 1, 1,
     {"d_ff": 512, "n_heads": 8, "n_vocab": 127}))
# widths whose GRU scan plan is printed with ptxas' registers and spills:
# the encoder's, the decoder's and the scope's largest
PTXAS_WIDTHS = (80, 102, 128)
# B4: the forward-only scan (heldout eval, pipeline encodings), both widths
B4_BATCHES = (1, 5, 32, 37, 1024, 4096, 20000)
# B5: the WAE-MMD, value and gradient; (N, D) beyond the latent width 100
B5_NS = (2, 5, 32, 37, 256, 1024, 4096)
B5_EDGES = ((2, 1), (37, 1), (1024, 1), (2, 256), (37, 256), (1024, 256))
B5_FORMS = ("gaussian", "laplace", "energy")
# [7]: the gradient's times, D 100: the train step's N 32, the z gathered
# over 2 and 4 DP ranks (N 64, 128), and N 4,096
B5_TIMED_NS = (32, 64, 128, 4096)
# the value's completion counter: calls interleaving one-block and many-
# block N, each N's values bitwise equal call to call
B5_LOOP_NS = (32, 37, 1024, 2)
B5_LOOP_CALLS = 200
MAX_MMD_DELTA = 1e-5     # fp64-accumulated pair sums against torch's fp32
MAX_MMD_GRAD_REL = 1e-4  # of each gradient's largest entry
MMD_ITERS = 50           # the short --vae.z_regu_loss mmd run (B5 backward)
UNROLL_ITERS = 50        # 6u and 6f: 51 steps at cadences 25 / 50
FULL_ITERS, FULL_ITERS_T = 100, 30   # [9]: phase-2 steps, GRU / transformer
MAX_UNROLL_REL = 1e-5    # unroll 50 vs 1, of each array's largest entry
FP32_PEAK = 67e12        # H100 SXM fp32 (non-tensor) FLOP/s, NVIDIA data sheet
BF16_PEAK = 989e12       # H100 SXM bf16 tensor-core FLOP/s, dense, data sheet
HBM_RATE = 3.35e12       # H100 SXM HBM3 bytes/s, NVIDIA data sheet
# bf16 decode (3-bf16, 3t-bf16, 5-bf16, 5t-bf16): the gates, each kernel and
# round against its plain version on the same inputs
BF16_BATCHES = (1, 37, 2500, 5000, 12288)
# (b) at T 1: bf16 logits are quantised, so a sum taken in another order
# flips a near-tie now and then; one bf16 logit ulp is 0.0156 at magnitude
# 2-4
BF16_T1_SAME_ROWS = 0.99
BF16_T1_SCORE_DELTA = 2e-2
# (c) at T 25: the kernel's score of each emitted top-1 hypothesis against
# its teacher-forced recompute under the plain version, the JAX package's
# own bf16 hardware guard (tests/test_pallas_beam_tpu.py:155-162)
BF16_RECOMPUTE_RTOL, BF16_RECOMPUTE_ATOL = 2e-2, 0.3
# (d) at T 25: identical rows; on the TPU the JAX package's own two bf16
# arms differed on 22.12% of rows (BENCH_DETAILS.json "divergence"), so 99%
# would fail a correct kernel, and a broken one gives near 0
BF16_T25_SAME_ROWS = 0.70
# (e) unique decodes of the kernel over the plain version's at B 5000 (the
# JAX package measured 1.0006)
BF16_UNIQ_RATIO = (0.99, 1.01)


# [11]: data parallelism on the one card; steps of the 2-rank runs, GRU and
# transformer/phase 2, and the bound of a DP run against its one-rank run
# of the same flags (the tier-1 tests' bound for the DP step, rtol 2e-4 /
# atol 2e-5, and their losses' 1e-4)
DP_ITERS, DP_ITERS_T = 40, 10
DP_RTOL, DP_ATOL, DP_LOSS_RTOL = 2e-4, 2e-5, 1e-4
# [12]: tensor and pipeline parallelism on the one card; steps of each run
# (and phase-2 iterations of [12f]), held to [11]'s bounds against the
# one-rank run of the same flags
MP_ITERS = 10

LOG_FILE = []          # the full log, also under chiprun_out/ (gitignored)


class RoundCounter(logging.Handler):
    """Counts the sampling loop's "Round #" records (rounds launched)."""

    def __init__(self):
        super().__init__()
        self.rounds = 0

    def emit(self, record):
        self.rounds += record.getMessage().startswith("Round #")


class FigureLog(logging.Handler):
    """Collects the diagnostics' "figures not drawn" records (vis/figures.py:
    matplotlib is not installed on the card's machine)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        if "figures not drawn" in record.getMessage():
            self.lines.append(record.getMessage())


class ChunkLog(logging.Handler):
    """Reads the trainers' "<n> replays of a <unroll>-step CUDA graph of
    <k> kernel nodes" record (train/train_vae.py, train/train_full.py) of
    the last run, and the "CUDA graph {...}" record after it (the graph's
    nodes, capture and instantiate seconds, pool and executable bytes,
    train/chunk.py GraphChunk.stats)."""

    def __init__(self):
        super().__init__()
        self.last = self.stats = None

    def emit(self, record):
        msg = record.getMessage()
        words = msg.split()
        if "replays" in words and "CUDA" in words:
            self.last = (int(words[0]), int(words[4].split("-")[0]),
                         int(words[-3]))
        elif msg.startswith("CUDA graph {"):
            self.stats = json.loads(msg[len("CUDA graph "):])


def reset_train_counts():
    """Set the train steps' kernel counts (B2, B4, B5) to 0."""
    from controlled_peptide_generation_tpu_torch.ops import (
        gru_fwd_kernel, gru_kernel, mmd_kernel)
    gru_kernel.reset_launches()
    gru_fwd_kernel.gru_fwd.launches = 0
    mmd_kernel.reset_launches()


def train_counts():
    """The train steps' kernel counts since reset_train_counts."""
    from controlled_peptide_generation_tpu_torch.ops import (
        gru_fwd_kernel, gru_kernel, mmd_kernel)
    return {"B2 fwd": gru_kernel.gru_seq_fwd.launches,
            "B2 bwd": gru_kernel.gru_seq_bwd.launches,
            "B2 wgrad": gru_kernel.gru_seq_wgrad.launches,
            "B4": gru_fwd_kernel.gru_fwd.launches,
            "B5 fwd": mmd_kernel.mmd_full_fwd.launches,
            "B5 bwd": mmd_kernel.mmd_full_bwd.launches}


def dp_rank_jobs(jobs, out_dir):
    """One rank of a group that parallel.dist.spawn started ([11]): main.main
    on each job's flags in turn, the train kernels' counts set to 0 just
    before each run and read just after; writes {name: {counts, seconds,
    chunks, graph}} to out_dir/rank<r>.json (chunks and graph as ChunkLog
    reads them)."""
    import torch.distributed as tdist
    from controlled_peptide_generation_tpu_torch import main as train_main
    from controlled_peptide_generation_tpu_torch.train import (
        train_full, train_vae)
    chunk_log = ChunkLog()
    for trainer in (train_vae, train_full):
        trainer.log.addHandler(chunk_log)
        trainer.log.setLevel("INFO")
    out = {}
    for name, argv in jobs:
        reset_train_counts()
        chunk_log.last = chunk_log.stats = None
        t0 = time.perf_counter()
        train_main.main(argv)
        out[name] = {"counts": train_counts(),
                     "seconds": time.perf_counter() - t0,
                     "chunks": chunk_log.last, "graph": chunk_log.stats}
    with open(os.path.join(out_dir, f"rank{tdist.get_rank()}.json"),
              "w") as fh:
        json.dump(out, fh)


def state_delta(path_a, path_b):
    """The largest |a - b| over the largest |b| of each array of two
    checkpoints (params and Adam state), and whether all are bitwise
    equal."""
    import numpy as np
    worst, key, same = 0.0, None, True
    with np.load(path_a) as a, np.load(path_b) as b:
        if set(a.files) != set(b.files):
            raise AssertionError(f"{path_a} and {path_b} hold other keys")
        for k in b.files:
            x, y = a[k].astype(np.float64), b[k].astype(np.float64)
            same &= a[k].tobytes() == b[k].tobytes()
            rel = float(np.abs(x - y).max(initial=0)) / max(
                float(np.abs(y).max(initial=0)), 1e-30)
            if rel > worst or key is None:
                worst, key = rel, k
    return worst, key, same


def outside_bounds(path_a, path_b, cfg_, n_steps):
    """The arrays of two checkpoints outside rtol DP_RTOL / atol DP_ATOL
    (the tier-1 tests' bound for a DP step against its one-device step).
    The attention keys' bias has an exact gradient of 0 (softmax ignores
    a shift shared by all keys), so Adam turns its rounding noise into
    steps of up to lr either way: its entries (head-major [heads, q k v,
    dh]) are held within 2 lr a step instead, and their moments, noise,
    are left out."""
    import numpy as np
    out = []
    with np.load(path_a) as a, np.load(path_b) as b:
        for k in b.files:
            x, y = a[k], b[k]
            if k.endswith("['qkv']['b']"):
                part = "E_args" if "['enc']" in k else "G_args"
                heads = cfg_.model[part].T_args.get("n_heads", 4)
                keys = np.zeros(y.shape, bool)
                keys.reshape(heads, 3, -1)[:, 1] = True
                if "['opt']" in k:
                    x, y = x[~keys], y[~keys]
                elif np.abs(x - y)[keys].max() > 2 * 1e-3 * n_steps:
                    out.append(k)
                    continue
                else:
                    x, y = x[~keys], y[~keys]
            if not np.allclose(x, y, rtol=DP_RTOL, atol=DP_ATOL):
                out.append(k)
    return out


def losses_delta(cfg_a, cfg_b, prefix):
    """The largest relative difference of two runs' logged losses (their
    result.json rows of the same iterations)."""
    rows = []
    for cfg_ in (cfg_a, cfg_b):
        with open(os.path.join(cfg_.savepath, "result.json")) as fh:
            rows.append({r["it"]: {k: v for k, v in r.items()
                                   if k.startswith(prefix + "L_")}
                         for r in json.load(fh) if prefix + "L_vae" in r})
    if set(rows[0]) != set(rows[1]) or not rows[1]:
        raise AssertionError(f"logged rows {sorted(rows[0])} against "
                             f"{sorted(rows[1])}")
    return max(abs(rows[0][i][k] - v) / max(abs(v), 1e-30)
               for i, r in rows[1].items() for k, v in r.items())


def mp_phase(train_flags, train_top, dev, card):
    """[12]: tensor and pipeline parallelism of the transformer family at
    the shipped width, batch 32, every step eager. NCCL refuses two ranks
    on one device, so the ranks are gloo ranks on cuda:0, started by
    parallel.dist.spawn (each runs dp_rank_jobs): [12t] --hw.tp 2, [12p]
    --hw.pp 2, [12x] the mixed family (GRU encoder) at --hw.tp 2, [12f]
    phase 2 at --hw.tp 2 from [12t]'s checkpoint, on 2 ranks; [12m] --hw.tp
    2 --hw.pp 2 on 4. Each is held against main.main of the same flags on
    one rank: every checkpoint array within rtol DP_RTOL / atol DP_ATOL,
    the logged losses within DP_LOSS_RTOL, and each rank's launches of B5
    (and of B2 and B4, the GRU leg's, in [12x]) equal to the one rank's.
    Raises on any failure; returns every rank's counts."""
    from controlled_peptide_generation_tpu_torch import config as C
    from controlled_peptide_generation_tpu_torch import main as train_main
    from controlled_peptide_generation_tpu_torch.parallel import dist as pdist
    mp_dir = os.path.join(train_top, "mp")
    shutil.rmtree(mp_dir, ignore_errors=True)
    os.makedirs(mp_dir)
    on = "cpu" if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    common = ["--device", on, "--hw.unroll", "1",
              "--vae.cheaplog_every", "5", "--vae.expsvlog_every",
              str(MP_ITERS)]
    tfm = train_flags("mp_t", MP_ITERS, TFM_FLAGS + common)
    extra = train_main.EXTRA_ARGS
    cfg_t, _, _ = C.parse_and_finalize(tfm, extra_args=extra)
    p2 = ["--phase", "2", "--loadpath", cfg_t.vae.chkpt_path.format(MP_ITERS),
          "--full.n_iter", str(MP_ITERS), "--full.cheaplog_every", "5",
          "--full.expsvlog_every", str(MP_ITERS), "--full.z_regu_loss", "mmd"]
    runs = {  # tag: (ranks, flags without the layout, the layout's flags)
        "12t": (2, tfm, ["--hw.tp", "2"]),
        "12p": (2, train_flags("mp_p", MP_ITERS, TFM_FLAGS + common),
                ["--hw.pp", "2"]),
        "12x": (2, train_flags("mp_x", MP_ITERS, [
            "--model.G_args.G_class", "transformer"] + common),
                ["--hw.tp", "2"]),
        "12f": (2, train_flags("mp_f", MP_ITERS, TFM_FLAGS + common) + p2,
                ["--hw.tp", "2"]),
        "12m": (4, train_flags("mp_m", MP_ITERS, TFM_FLAGS + common),
                ["--hw.tp", "2", "--hw.pp", "2"])}
    ranks, spawn_s = {}, {}
    for world in (2, 4):
        out_dir = os.path.join(mp_dir, f"gloo{world}")
        os.makedirs(out_dir)
        jobs = [(tag, flags + layout) for tag, (w, flags, layout)
                in runs.items() if w == world]
        t0 = time.perf_counter()
        pdist.spawn(dp_rank_jobs, world, jobs, out_dir, backend="gloo",
                    threads=0)
        spawn_s[world] = time.perf_counter() - t0
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                for tag, res in json.load(fh).items():
                    ranks.setdefault(tag, []).append(res)
    keys = {tag: ("B5 fwd", "B5 bwd") for tag in runs}
    keys["12x"] += ("B2 fwd", "B2 bwd", "B2 wgrad", "B4")
    counts, failed = [], []
    for tag, (world, flags, layout) in runs.items():
        one = [a + "_1" if a in ("mp_t", "mp_p", "mp_x", "mp_f", "mp_m")
               else a for a in flags]
        reset_train_counts()
        t0 = time.perf_counter()
        cfg_1 = train_main.main(one)
        secs_1, counts_1 = time.perf_counter() - t0, train_counts()
        cfg_n, _, _ = C.parse_and_finalize(flags + layout, extra_args=extra)
        phase2 = tag == "12f"
        last = (cfg_1.full.s_iter + MP_ITERS if phase2 else MP_ITERS)
        path_n, path_1 = ((c.full if phase2 else c.vae).chkpt_path.format(
            last) for c in (cfg_n, cfg_1))
        rel, at, _ = state_delta(path_n, path_1)
        outside = outside_bounds(path_n, path_1, cfg_1, MP_ITERS + 1)
        prefix = "full_" if phase2 else "train_"
        loss_rel = losses_delta(cfg_n, cfg_1, prefix)
        rates = []
        for c in (cfg_n, cfg_1):
            with open(os.path.join(c.savepath, "result.json")) as fh:
                rates.append([r[prefix + "steps_per_sec"] for r in
                              json.load(fh)
                              if prefix + "steps_per_sec" in r][-1])
        per_rank = [res["counts"] for res in ranks[tag]]
        counts += per_rank
        bad = [r for r, c in enumerate(per_rank)
               if any(c[k] != counts_1[k] for k in keys[tag])]
        log(f"[{tag}] main.main {' '.join(layout)} on {world} gloo ranks on "
            f"{on} (batch 32, every step eager) against one "
            f"rank of the same flags: model_{last}.npz largest difference "
            f"{rel:.3e} of the array's largest entry ({at}), arrays outside "
            f"rtol {DP_RTOL} / atol {DP_ATOL} (the keys' bias within 2 lr a "
            f"step): {outside}; logged losses within {loss_rel:.3e}; "
            f"launches per rank {per_rank} against one rank's {counts_1} "
            f"(held: {', '.join(keys[tag])}); "
            f"{[round(res['seconds'], 2) for res in ranks[tag]]} s a rank "
            f"in main.main against {secs_1:.2f} s on one rank; "
            f"{rates[0]:.2f} steps/s over the loop against {rates[1]:.2f} "
            f"({card})")
        if outside or loss_rel > DP_LOSS_RTOL or bad:
            failed.append(f"{tag}: arrays {outside}, losses {loss_rel:.3e}, "
                          f"ranks {bad} with other launches")
    log(f"[12] spawns and the ranks' runs: {spawn_s[2]:.1f} s on 2 ranks, "
        f"{spawn_s[4]:.1f} s on 4 ({card})")
    if failed:
        raise AssertionError(f"[12] against one rank: {failed}")
    return counts


# [13]: the data path and B2 in bf16. (a) synthetic raw sources from
# RAW_SEED (DBAASP cards and the other sources in proportion) through the
# curation CLI; (b) the native tokenizer against its plain version on the
# curated corpus and, timed, on a corpus of TOKENIZE_ROWS rows (the
# reference's training set); (c) phase 1 on the curated corpus for one
# --hw.unroll 50 chunk; (d) B2's bf16 entries against their plain versions
# at T 25, B2_BF16_BATCHES and both widths, timed; (e) a bf16 gru_scan
# through autograd against the same scan inside cuda_build.plain()
RAW_CARDS = 3000
RAW_SEED = 13
TOKENIZE_ROWS = 100000
B2_BF16_BATCHES = (32, 1024)
# bf16 gates of (d) and (e), those of tests/test_torch_gru_bf16.py: each
# bf16 output bitwise equal to its plain version on >= B2_BF16_SAME of its
# entries, and every output (the f32 residual tape too) within
# B2_BF16_ULPS bf16 ulps (2^-8 each) of its largest entry: a product summed
# in another f32 order flips a bf16 rounding now and then, and the flip
# reaches the later steps through the carry
B2_BF16_SAME = 0.99
B2_BF16_ULPS = 2
# (d)'s scope edges of the bf16 entries (T, B, H): an odd H, 127, which
# the tensor-core weight gradient reads by plain loads; B 5, 9 and 33, no
# multiple of the scan's and backward's rows a block; T*B 63, not a
# multiple of the weight gradient's 32-row slice
B2_BF16_WGRAD_EDGES = ((6, 5, 127), (25, 33, 127), (7, 9, 102))
# The times of the kernels that B2's bf16 entries (f32 FMAs on the CUDA
# cores; by entry and (H, B) at T 25) and B5's gradient (one thread a
# feature; by N at D 100) replaced, ms, as this script's [7] measured them
# on an NVIDIA H100 80GB HBM3 at 700 W before the replacement (PERF.md's
# kernel table): [7] prints them beside this run's, for reference only
B2_BF16_BEFORE_MS = {
    "fwd": {(80, 32): 0.0267, (80, 1024): 0.0988, (102, 32): 0.0330,
            (102, 1024): 0.1281},
    "fwd_nores": {(80, 32): 0.0263, (80, 1024): 0.0772, (102, 32): 0.0319,
                  (102, 1024): 0.1018},
    "bwd": {(80, 32): 0.0269, (80, 1024): 0.1156, (102, 32): 0.0359,
            (102, 1024): 0.1624},
    "wgrad": {(80, 32): 0.0131, (80, 1024): 0.1151, (102, 32): 0.0136,
              (102, 1024): 0.1928}}
B5_BWD_BEFORE_MS = {32: 0.0110, 4096: 2.4360}


def b2_bf16_bound_ms(kind, T_, B, H):
    """Least time of a bf16 B2 entry: its products (the f32 kernels' FLOP)
    over the bf16 tensor-core peak, against the bytes the JAX function
    (ops/pallas_gru.py gru_seq in bf16, all tensors at 2 bytes) must move
    over the HBM rate. Its forward writes no residual tape and its backward
    recomputes the gates, so the port's f32 tape is counted nowhere. fwd
    (with or without the port's tape, fwd_nores): gi, wh, bh, h0 in, hs
    out; bwd, the backward's data part: gi, wh, bh, h0, hs, dhs in, dgi and
    dh0 out; wgrad: h0, hs and dgh [T, B, 3H] in, dwh and dbh out."""
    tb, g3 = T_ * B, 3 * H
    if kind in ("fwd", "fwd_nores"):
        flops = 2 * tb * H * g3
        words = tb * g3 + H * g3 + g3 + B * H + tb * H
    elif kind == "bwd":
        flops = 2 * tb * H * g3
        words = (tb * g3 + H * g3 + g3 + B * H + 2 * tb * H + tb * g3
                 + B * H)
    else:
        flops = 2 * tb * (H + 1) * g3
        words = B * H + tb * H + tb * g3 + H * g3 + g3
    t_ops, t_bytes = flops / BF16_PEAK, 2 * words / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bf16_agreement(got, want):
    """(share of entries bitwise equal, max |delta| over the largest
    |want|, max |delta|) of two tensors."""
    same = (got == want).float().mean().item()
    delta = (got.float() - want.float()).abs().max().item()
    return same, delta / max(want.float().abs().max().item(), 1e-30), delta


def bf16_gate(what, pairs, bf16_outputs):
    """Raise unless every (name, got, want) pair is within B2_BF16_ULPS
    ulps of its largest entry and the bf16 ones bitwise on B2_BF16_SAME of
    their entries. Returns {name: (share, relative delta, delta)}."""
    out, bad = {}, []
    for name, got, want in pairs:
        same, delta, abs_delta = bf16_agreement(got, want)
        out[name] = (same, delta, abs_delta)
        if delta > B2_BF16_ULPS * 2.0 ** -8 or (
                name in bf16_outputs and same < B2_BF16_SAME):
            bad.append((name, same, delta))
    if bad:
        raise AssertionError(f"{what}: outside the bf16 gates {bad}")
    return out


def data_bf16_phase(dev, card, cuda_ms, train_top):
    """[13]: (a)-(e) above. Raises on any failure; returns the numbers of
    the report and of the kernels line."""
    import subprocess
    import numpy as np
    import torch
    from controlled_peptide_generation_tpu_torch import config as C
    from controlled_peptide_generation_tpu_torch import main as train_main
    from controlled_peptide_generation_tpu_torch import native
    from controlled_peptide_generation_tpu_torch.data import curation
    from controlled_peptide_generation_tpu_torch.data.loader import (
        AttributeDataLoader)
    from controlled_peptide_generation_tpu_torch.data.vocab import Vocab
    from controlled_peptide_generation_tpu_torch.ops import cuda_build
    from controlled_peptide_generation_tpu_torch.ops import gru as gru_ops
    from controlled_peptide_generation_tpu_torch.ops import gru_fwd_kernel
    from controlled_peptide_generation_tpu_torch.ops import gru_kernel
    from controlled_peptide_generation_tpu_torch.train import (
        train_full, train_vae)
    out = {}
    top = os.path.join(train_top, "curated")
    shutil.rmtree(top, ignore_errors=True)
    raw, corpus = os.path.join(top, "raw"), os.path.join(top, "data", "amp")

    # (a) raw sources from a seed, then the curation CLI as a user runs it
    t0 = time.perf_counter()
    curation.write_synthetic_raw(raw, RAW_CARDS, RAW_SEED)
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "controlled_peptide_generation_tpu_torch.data.curation", "--raw",
         raw, "--out", corpus, "--seed", str(RAW_SEED)],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    cur_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[13a] the curation CLI failed:\n"
                             f"{proc.stderr[-4000:]}")
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    files = sorted(os.listdir(corpus))
    if files != sorted(C.AMP_CSV_FILES) or not all(
            counts[k] > 0 for k in ("amp", "tox", "unlab", "sol")):
        raise AssertionError(f"[13a] curated {files}, counts {counts}")
    log(f"[13a] curation CLI on {RAW_CARDS} synthetic DBAASP cards (and "
        f"SATPDB, AMPEP, UniProt, ToxinPred, solubility sources, seed "
        f"{RAW_SEED}): counts {counts}; raw sources written in "
        f"{raw_s:.2f} s, the CLI (its process included) {cur_s:.2f} s "
        f"(host clock, {card})")
    out["curation_s"], out["counts"] = cur_s, counts

    # (b) the native tokenizer (built in [2]): its tokens against the plain
    # path on the curated corpus, bit for bit, and both timed
    shutil.copy(os.path.join(ROOT, "data", "amp", "vocab.dict"), corpus)
    cfg_c, _, _ = C.parse_and_finalize(["--dataset", "amp", "--datapath",
                                        os.path.dirname(corpus)])
    spec = C.dataset_spec(cfg_c)
    kw = dict(mbsize=32, max_seq_len=cfg_c.max_seq_len, **spec)
    t0 = time.perf_counter()
    loader = AttributeDataLoader(**kw)
    load_s = time.perf_counter() - t0
    if not np.array_equal(loader.tokens, native.tokenize_corpus_reference(
            [r["text"] for r in loader.rows], loader.vocab,
            cfg_c.max_seq_len)):
        raise AssertionError("[13b] native tokens differ from the plain "
                             "path on the curated corpus")
    vocab = Vocab.load(os.path.join(corpus, "vocab.dict"))
    rng = np.random.default_rng(RAW_SEED)
    aa = np.array(vocab.itos[4:])
    lens = rng.integers(5, 40, TOKENIZE_ROWS)
    texts = [" ".join(aa[rng.integers(0, len(aa), n)]) for n in lens]
    t0 = time.perf_counter()
    nat = native.tokenize_corpus(texts, vocab.stoi, cfg_c.max_seq_len)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = native.tokenize_corpus_reference(texts, vocab, cfg_c.max_seq_len)
    ref_s = time.perf_counter() - t0
    if not np.array_equal(nat, ref):
        raise AssertionError("[13b] native tokens differ from the plain "
                             f"path on {TOKENIZE_ROWS} rows")
    log(f"[13b] native tokenizer (built from native/_tokenizer.c in [2], "
        f"{os.path.basename(native.build().__file__)}): the curated corpus "
        f"({len(loader.tokens)} rows) loaded in {load_s:.3f} s, its tokens "
        f"equal to the plain path's bit for bit; {TOKENIZE_ROWS} rows: "
        f"native {1e3 * nat_s:.2f} ms, plain (Vocab.to_ix row by row) "
        f"{1e3 * ref_s:.2f} ms, {ref_s / nat_s:.1f}x, tokens equal (host "
        f"clock, {card})")
    out.update(tok_native_ms=1e3 * nat_s,
               tok_plain_ms=1e3 * ref_s, corpus_rows=len(loader.tokens))

    # (c) phase 1 on the curated corpus: one --hw.unroll 50 chunk
    chunk_log = ChunkLog()
    for trainer in (train_vae, train_full):
        trainer.log.addHandler(chunk_log)
    try:
        reset_train_counts()
        t0 = time.perf_counter()
        cfg_t = train_main.main([
            "--phase", "1", "--dataset", "amp", "--datapath",
            os.path.dirname(corpus), "--savepath_toplevel",
            os.path.join(top, "out"), "--tb_toplevel",
            os.path.join(top, "tb"), "--runname", "curated", "--seed",
            "1238", "--vae.n_iter", "50", "--vae.cheaplog_every", "50",
            "--vae.expsvlog_every", "50", "--device",
            "cpu" if dev.type == "cpu" else f"cuda:{dev.index or 0}"])
        train_s, launches = time.perf_counter() - t0, train_counts()
    finally:
        for trainer in (train_vae, train_full):
            trainer.log.removeHandler(chunk_log)
    with open(os.path.join(cfg_t.savepath, "result.json")) as fh:
        recon = [r["train_L_vae_recon"] for r in json.load(fh)
                 if "train_L_vae_recon" in r]
    want = {"B2 fwd": 153, "B2 bwd": 153, "B2 wgrad": 153, "B4": 12,
            "B5 fwd": 51, "B5 bwd": 0}
    # (the launches and the graph exist on the card; a CPU rehearsal of
    # this phase checks the rest)
    on_card = dev.type == "cuda"
    if (on_card and (launches != want or chunk_log.last is None
                     or chunk_log.last[:2] != (1, 50))
            or not np.isfinite(recon).all() or recon[-1] >= recon[0]):
        raise AssertionError(f"[13c] phase 1 on the curated corpus: "
                             f"launches {launches} (want {want}), chunks "
                             f"{chunk_log.last}, recon {recon}")
    log(f"[13c] main --phase 1 --dataset amp on the curated corpus (default "
        f"GRU width, batch 32, 51 steps: step 0, then one replay of a "
        f"50-step CUDA graph, chunks {chunk_log.last}): "
        f"{train_s:.2f} s in main.main; launches {launches}; recon at the "
        f"logs {[round(r, 4) for r in recon]} ({card})")
    out["train"] = (launches, train_s)

    # (d) B2's bf16 entries against their plain versions, timed
    gen = torch.Generator(device=dev).manual_seed(13)
    bf = torch.bfloat16
    B2_WIDTHS_ = ((150, 80), (252, 102))
    gates, times, projs = {}, {}, {}
    for I, H_ in B2_WIDTHS_:
        p32 = gru_ops.init_gru_params(gen, I, H_, dev)
        wh, bh = p32["wh"].to(bf), p32["bh"].to(bf)
        # one set of inputs at the largest batch; each smaller batch runs
        # on its first rows and must give their bits (batch invariance)
        B_big = max(B2_BF16_BATCHES)
        xs_big = torch.randn((B_big, T, I), generator=gen, device=dev)
        gi_big = ((xs_big @ p32["wi"] + p32["bi"]).transpose(0, 1)
                  .contiguous().to(bf))
        h0_big = (0.5 * torch.randn((B_big, H_), generator=gen, device=dev)
                  ).to(bf)
        dhs_big = torch.randn((T, B_big, H_), generator=gen, device=dev
                              ).to(bf)
        big_out = None
        for B in sorted(B2_BF16_BATCHES, reverse=True):
            xs = xs_big[:B]
            gi, dhs = gi_big[:, :B].contiguous(), dhs_big[:, :B].contiguous()
            h0 = h0_big[:B].contiguous()
            fwd2 = [gru_kernel.gru_seq_fwd(wh, bh, gi, h0) for _ in range(2)]
            hs, res = fwd2[0]
            hs_p, res_p = gru_kernel.gru_seq_res_reference(wh, bh, gi, h0)
            bwd2 = [gru_kernel.gru_seq_bwd(wh, h0, hs, res, dhs)
                    for _ in range(2)]
            chain = bwd2[0]
            chain_p = gru_kernel._bwd_chain_reference(wh, h0, hs, res, dhs)
            recomp = gru_kernel._bwd_recurrence_reference(wh, bh, gi, h0, hs,
                                                          dhs)
            dgi, dghn, _ = chain
            wg = gru_kernel.gru_seq_wgrad(h0, hs, dgi, dghn)
            wg2 = gru_kernel.gru_seq_wgrad(h0, hs, dgi, dghn)
            wg_p = gru_kernel._wgrad_reference(h0, hs, dgi, dghn)
            torch.cuda.synchronize()
            for what, runs in (("forward", fwd2), ("backward", bwd2),
                               ("weight-gradient", (wg, wg2))):
                if not all(torch.equal(a, b) for a, b in zip(*runs)):
                    raise AssertionError(f"[13d] B2 bf16 H {H_} B {B}: two "
                                         f"{what} runs differ")
            outs = (hs, res, *chain)
            if big_out is None:
                big_out = outs
            elif not all(torch.equal(a, b[:B] if b.dim() == 2 else b[:, :B])
                         for a, b in zip(outs, big_out)):
                raise AssertionError(
                    f"[13d] B2 bf16 H {H_}: the B {B} run on the first {B} "
                    f"rows of the B {B_big} inputs differs from those rows "
                    f"(batch invariance)")
            names = ("dgi", "dghn", "dh0")
            g = bf16_gate(
                f"[13d] B2 bf16 H {H_} B {B}",
                [("hs", hs, hs_p), ("res", res, res_p)]
                + [(n, a, b) for n, a, b in zip(names, chain, chain_p)]
                + [(n + " (recompute)", a, b)
                   for n, a, b in zip(names, chain, recomp)]
                + [("dwh", wg[0], wg_p[0]), ("dbh", wg[1], wg_p[1])],
                {"hs", "dgi", "dghn", "dh0", "dgi (recompute)",
                 "dghn (recompute)", "dh0 (recompute)", "dwh", "dbh"})
            if not all(a.dtype == bf for a in (hs, *chain, *wg)):
                raise AssertionError("[13d] a bf16 entry returned another "
                                     "dtype")
            gates[H_, B] = g
            # the library calls: cuDNN's GRU in bf16 (forward; data
            # backward, the input and h0 only) on the same inputs, and the
            # weight gradient as one bf16 torch.mm. cuDNN also does the
            # input projection that B2 takes done (gi = x @ wi + bi, and dx
            # = dgi @ wi^T backward): each is timed alone as its one bf16
            # product, the share of cuDNN's time that B2 has no part of. A
            # library call that fails fails the phase.
            cudnn = torch.nn.GRU(I, H_, batch_first=True).to(dev)
            with torch.no_grad():
                for name, src in (("weight_ih_l0", p32["wi"].T),
                                  ("weight_hh_l0", p32["wh"].T),
                                  ("bias_ih_l0", p32["bi"]),
                                  ("bias_hh_l0", p32["bh"])):
                    getattr(cudnn, name).copy_(src)
            cudnn = cudnn.to(bf)
            cudnn.flatten_parameters()    # one weight chunk, as cuDNN
            cudnn.requires_grad_(False)
            xb = xs.to(bf)
            h0b = h0[None].clone()

            def lib_fwd():
                with torch.no_grad():
                    cudnn(xb, h0b)
            lib = {"fwd": cuda_ms(lib_fwd, 20)}
            lib["fwd_nores"] = lib["fwd"]
            xg = xb.detach().requires_grad_()
            h0g = h0b.detach().requires_grad_()
            data_loss = (cudnn(xg, h0g)[0].float()
                         * dhs.transpose(0, 1).float()).sum()
            lib["bwd"] = cuda_ms(lambda: torch.autograd.grad(
                data_loss, [xg, h0g], retain_graph=True), 20)
            wi_b, bi_b = p32["wi"].to(bf), p32["bi"].to(bf)
            x2, dgi2 = xb.reshape(-1, I), dgi.reshape(-1, 3 * H_)
            proj = {"fwd": cuda_ms(lambda: torch.addmm(bi_b, x2, wi_b), 50),
                    "bwd": cuda_ms(lambda: torch.mm(dgi2, wi_b.T), 50)}
            proj["fwd_nores"] = proj["fwd"]
            hprev1 = torch.cat([torch.cat([h0[None], hs[:-1]]).reshape(
                -1, H_), torch.ones((T * B, 1), dtype=bf, device=dev)], 1)
            dgh = torch.cat([dgi[..., :2 * H_], dghn], 2).reshape(-1, 3 * H_)
            lib["wgrad"] = cuda_ms(lambda: torch.mm(hprev1.T, dgh), 50)
            args = (wh, bh, gi, h0)
            # the forward without its tape (a scan autograd does not
            # record): the training forward's hs, bit for bit
            if not torch.equal(gru_kernel.gru_seq_fwd(
                    *args, residuals=False)[0], hs):
                raise AssertionError(f"[13d] B2 bf16 H {H_} B {B}: the "
                                     f"forward without its tape differs")
            kern = {
                "fwd": (lambda: gru_kernel.gru_seq_fwd(*args),
                        lambda: gru_kernel.gru_seq_res_reference(*args)),
                "fwd_nores": (lambda: gru_kernel.gru_seq_fwd(
                    *args, residuals=False),
                    lambda: gru_kernel.gru_seq_reference(*args)),
                "bwd": (lambda: gru_kernel.gru_seq_bwd(wh, h0, hs, res, dhs),
                        lambda: gru_kernel._bwd_chain_reference(
                            wh, h0, hs, res, dhs)),
                "wgrad": (lambda: gru_kernel.gru_seq_wgrad(h0, hs, dgi,
                                                           dghn),
                          lambda: gru_kernel._wgrad_reference(h0, hs, dgi,
                                                              dghn))}
            times[H_, B] = {k: (cuda_ms(a, 50), cuda_ms(b, 3),
                                b2_bf16_bound_ms(k, T, B, H_), lib[k])
                            for k, (a, b) in kern.items()}
            projs[H_, B] = proj
            for k, (k_ms, p_ms, (b_ms, b_by), l_ms) in times[H_, B].items():
                log(f"[13d] B2 bf16 {k} H {H_} T {T} B {B}: kernel "
                    f"{k_ms:.6f} ms, plain {p_ms:.6f} ms, bound {b_ms:.6f} "
                    f"ms ({b_by}, the JAX function's bytes), library "
                    + (f"{l_ms:.6f} ms (torch.mm)" if k == "wgrad" else
                       f"{l_ms:.6f} ms (cuDNN GRU), of which its input "
                       f"projection alone {proj[k]:.6f} ms")
                    + f" ({card})")
            log(f"[13d] B2 bf16 H {H_} B {B} (plan "
                f"{gru_kernel.bf16_plan(B, H_)}) against the plain versions "
                f"(share bitwise, max |delta| / largest entry): "
                + ", ".join(f"{n} ({s:.5f}, {d:.2e})"
                            for n, (s, d, _) in g.items())
                + "; each entry twice bitwise equal"
                + (f"; its rows equal to the B {B_big} run's"
                   if B < B_big else ""))
    out["bf16_gates"], out["bf16_times"] = gates, times
    out["bf16_proj"] = projs
    # the three bf16 entries at their scope edges, the weight gradient on
    # dgi and dghn from B2's own bf16 backward: (d)'s gates, each entry
    # twice, bitwise equal
    edge_lines = []
    edge_err = {"fwd": 0.0, "bwd": 0.0, "wgrad": 0.0}
    for T_, B, H_ in B2_BF16_WGRAD_EDGES:
        p32 = gru_ops.init_gru_params(gen, H_, H_, dev)
        wh, bh = p32["wh"].to(bf), p32["bh"].to(bf)
        gi = torch.randn((T_, B, 3 * H_), generator=gen, device=dev).to(bf)
        h0 = (0.5 * torch.randn((B, H_), generator=gen, device=dev)).to(bf)
        dhs = torch.randn((T_, B, H_), generator=gen, device=dev).to(bf)
        fwd2 = [gru_kernel.gru_seq_fwd(wh, bh, gi, h0) for _ in range(2)]
        hs, res = fwd2[0]
        bwd2 = [gru_kernel.gru_seq_bwd(wh, h0, hs, res, dhs)
                for _ in range(2)]
        dgi, dghn, _ = bwd2[0]
        runs = [gru_kernel.gru_seq_wgrad(h0, hs, dgi, dghn)
                for _ in range(2)]
        hs_p, res_p = gru_kernel.gru_seq_res_reference(wh, bh, gi, h0)
        chain_p = gru_kernel._bwd_chain_reference(wh, h0, hs, res, dhs)
        recomp = gru_kernel._bwd_recurrence_reference(wh, bh, gi, h0, hs,
                                                      dhs)
        wg_p = gru_kernel._wgrad_reference(h0, hs, dgi, dghn)
        torch.cuda.synchronize()
        names = ("dgi", "dghn", "dh0")
        g = bf16_gate(
            f"[13d] B2 bf16 at its scope edge T {T_} B {B} H {H_}",
            [("hs", hs, hs_p), ("res", res, res_p)]
            + [(n, a, b) for n, a, b in zip(names, bwd2[0], chain_p)]
            + [(n + " (recompute)", a, b)
               for n, a, b in zip(names, bwd2[0], recomp)]
            + [("dwh", runs[0][0], wg_p[0]), ("dbh", runs[0][1], wg_p[1])],
            {"hs", "dwh", "dbh", *names,
             *(n + " (recompute)" for n in names)})
        for what, pair in (("forward", fwd2), ("backward", bwd2),
                           ("weight-gradient", runs)):
            if not all(torch.equal(a, b) for a, b in zip(*pair)):
                raise AssertionError(f"[13d] B2 bf16 T {T_} B {B} H {H_}: "
                                     f"two {what} runs differ")
        for k, names_ in (("fwd", ("hs", "res")), ("bwd", names),
                          ("wgrad", ("dwh", "dbh"))):
            edge_err[k] = max(edge_err[k], *(g[n][2] for n in names_))
        edge_lines.append(
            f"T {T_} B {B} H {H_} (plans {gru_kernel.bf16_plan(B, H_)}, "
            f"{gru_kernel.wgrad_plan(T_, B, H_, bf16=True)}): "
            + ", ".join(f"{n} ({sh:.5f}, {d:.2e})"
                        for n, (sh, d, _) in g.items()))
    log(f"[13d] B2 bf16 forward, backward and weight gradient at their scope "
        f"edges, each twice bitwise equal, (share bitwise, max |delta| / "
        f"largest entry): " + "; ".join(edge_lines))

    # (e) a bf16 gru_scan through autograd (and one without) against the
    # same scan inside cuda_build.plain(); B2's bf16 entries launched, B4
    # and the f32 entries never
    n_f32 = [getattr(f, "launches") for f in (
        gru_kernel.gru_seq_fwd, gru_kernel.gru_seq_bwd,
        gru_kernel.gru_seq_wgrad)]
    b4_0 = gru_fwd_kernel.gru_fwd.launches
    for fn in (gru_kernel.gru_seq_fwd, gru_kernel.gru_seq_bwd,
               gru_kernel.gru_seq_wgrad):
        fn.launches_bf16 = 0
    scan_gates = {}
    for I, H_ in B2_WIDTHS_:
        p = {k: v.to(bf) for k, v in gru_ops.init_gru_params(
            gen, I, H_, dev).items()}
        xs = torch.randn((32, T, I), generator=gen, device=dev).to(bf)
        h0 = (0.5 * torch.randn((32, H_), generator=gen, device=dev)).to(bf)
        w = torch.randn((32, T, H_), generator=gen, device=dev)
        for reverse in (False, True):
            runs = []
            for plain in (False, True):
                leaves = {k: v.detach().requires_grad_() for k, v in
                          p.items()}
                x, h = (xs.detach().requires_grad_(),
                        h0.detach().requires_grad_())
                with cuda_build.plain() if plain else contextlib.nullcontext():
                    hs_, hl = gru_ops.gru_scan(leaves, x, h, reverse=reverse)
                    loss = (hs_.float() * w).sum() + hl.float().sum()
                    grads = torch.autograd.grad(
                        loss, list(leaves.values()) + [x, h])
                    with torch.no_grad():
                        hs_ng = gru_ops.gru_scan(p, xs, h0,
                                                 reverse=reverse)[0]
                runs.append((hs_, hl, hs_ng, *grads))
            names = ["hs", "h_last", "hs (no grad)"] + [
                f"d{k}" for k in p] + ["dx", "dh0"]
            # bitwise shares on B2's own outputs: a gradient taken from
            # dgi by a product (dwh, dwi, dx) or a sum (dbh, dbi) turns one
            # flipped dgi entry into a flipped row or column, so those are
            # held to the ulps bound alone
            scan_gates[H_, reverse] = bf16_gate(
                f"[13e] bf16 gru_scan H {H_} reverse {reverse}",
                list(zip(names, runs[0], runs[1])),
                {"hs", "h_last", "hs (no grad)", "dh0"})
    launched = {n: getattr(gru_kernel, f"gru_seq_{n}").launches_bf16
                for n in ("fwd", "bwd", "wgrad")}
    # per width and direction on the kernel side: one recorded scan (fwd,
    # bwd, wgrad) and one without autograd (fwd with no tape); the plain
    # side launches nothing
    want_l = {"fwd": 2 * 2 * 2, "bwd": 2 * 2, "wgrad": 2 * 2}
    if on_card and (launched != want_l or [getattr(f, "launches") for f in (
            gru_kernel.gru_seq_fwd, gru_kernel.gru_seq_bwd,
            gru_kernel.gru_seq_wgrad)] != n_f32
            or gru_fwd_kernel.gru_fwd.launches != b4_0):
        raise AssertionError(f"[13e] bf16 gru_scan launched {launched} "
                             f"(want {want_l}), f32 entries or B4 moved")
    if on_card:
        try:
            gru_kernel.gru_seq_fwd(*(torch.zeros(s, dtype=bf, device=dev)
                                     for s in ((128, 384), (384,),
                                               (2, 3, 384), (3, 128))))
        except ValueError:
            pass
        else:
            raise AssertionError("[13e] a bf16 scan at H 128 did not raise")
    log(f"[13e] bf16 gru_scan through autograd (and without) at T {T}, B "
        f"32, H 80 and 102, both directions, against the same scan inside "
        f"cuda_build.plain(): B2 bf16 launches {launched}, B4 and the f32 "
        f"entries none; worst (share bitwise, max |delta| / largest entry) "
        f"per output: "
        + ", ".join(f"{n} ({min(g[n][0] for g in scan_gates.values()):.5f}, "
                    f"{max(g[n][1] for g in scan_gates.values()):.2e})"
                    for n in next(iter(scan_gates.values())))
        + f"; a bf16 scan at H 128 raises ({card})")
    out["bf16_launches"] = launched
    out["bf16_err"] = {k: max(max(g[n][2] for n in names_)
                              for g in gates.values())
                       for k, names_ in (("fwd", ("hs", "res")),
                                         ("bwd", ("dgi", "dghn", "dh0")),
                                         ("wgrad", ("dwh", "dbh")))}
    for k, e in edge_err.items():
        out["bf16_err"][k] = max(out["bf16_err"][k], e)
    return out


def log(msg):
    print(msg, flush=True)
    for fh in LOG_FILE:
        fh.write(msg + "\n")
        fh.flush()


def bound_ms(B, bf16=False):
    """Least time for the beam scan at batch B: the FLOP of the GRU and
    head products over the fp32 peak (bf16: the bf16 tensor-core peak),
    against inputs (4 bytes each, bf16 2) read once and tapes written once
    over the HBM rate."""
    flops = B * K * T * 2 * (H * 3 * H + H * V)
    n_in = V * 3 * H + B * 3 * H + H * 3 * H + 3 * H + H * V + V + B * H
    n_out = 3 * B * T * K + B * K + 2 * B
    t_ops = flops / (BF16_PEAK if bf16 else FP32_PEAK)
    t_bytes = ((2 if bf16 else 4) * n_in + 4 * n_out) / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def b3_bound_ms(B, T_=T, K_=K, L=2, D=128, F=256, V_=V, S=26, bf16=False):
    """Least time of the transformer beam scan at batch B: per beam-token
    the products' FLOP, 2 L (3D^2 + D^2 + 2 D F) + 2 D V, plus attention's
    4 D (t+2) per layer at step t, over the fp32 peak (bf16: the bf16
    tensor-core peak); against the inputs (weights, tables, the prefix
    rows; in bf16 2 bytes each but LayerNorm's parameters, the final LN and
    the head, 4) read once and the tapes written once over the HBM rate."""
    per_tok = 2 * L * (3 * D * D + D * D + 2 * D * F) + 2 * D * V_
    flops = B * K_ * sum(per_tok + L * 4 * D * (t + 2) for t in range(T_))
    f32_words = L * 4 * D + 2 * D + D * V_ + V_
    words = (L * (3 * D * D + 3 * D + D * D + D + 2 * D * F + F + D)
             + V_ * D + S * D + 2 * L * B * D)
    n_out = 3 * B * T_ * K_ + B * K_ + 2 * B
    t_ops = flops / (BF16_PEAK if bf16 else FP32_PEAK)
    t_bytes = ((2 if bf16 else 4) * words + 4 * (f32_words + n_out)
               ) / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def b2_bound_ms(kind, T_, B, H):
    """Least time of a B2 kernel at these shapes: the larger of its fp32
    FMAs over the fp32 peak and its inputs read once plus outputs written
    once over the HBM rate. fwd: the recurrent product per step (2 B 3H^2
    FLOP), gi/wh/bh/h0 in, hs and the residual tape [T, B, H, 4] out (the
    tape is not in the JAX forward's function: it moves work from the
    backward, so the pair fwd + bwd is the fair yardstick); bwd: dgh @
    wh^T per step (as many FLOP), wh/h0/hs/res/dhs in, dgi/dghn/dh0 out;
    wgrad: h_{t-1}^T dgh over T*B rows, h0/hs/dgi/dghn in, dwh/dbh out."""
    tb, g3 = T_ * B, 3 * H
    if kind == "fwd":
        flops = 2 * tb * H * g3
        words = tb * g3 + H * g3 + g3 + B * H + tb * H + tb * 4 * H
    elif kind == "bwd":
        flops = 2 * tb * H * g3
        words = (H * g3 + B * H + tb * H + tb * 4 * H + tb * H
                 + tb * g3 + tb * H + B * H)
    else:
        flops = 2 * tb * (H + 1) * g3
        words = B * H + tb * H + tb * g3 + tb * H + H * g3 + g3
    t_ops, t_bytes = flops / FP32_PEAK, 4 * words / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def b4_bound_ms(T_, B, H):
    """Least time of B4 at these shapes: the recurrent product per step
    (2 B 3H^2 FLOP) over the fp32 peak, against gi/wh/bh/h0 read once and
    hs/h_T written once over the HBM rate."""
    g3 = 3 * H
    flops = 2 * T_ * B * H * g3
    words = T_ * B * g3 + H * g3 + g3 + B * H + T_ * B * H + B * H
    t_ops, t_bytes = flops / FP32_PEAK, 4 * words / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def b5_bound_ms(kind, N, D):
    """Least time of B5 for z1, z2 [N, D]: the value's three difference-form
    distances per pair (9 N^2 D FLOP) or one gradient's two distances and
    two weighted differences per pair and feature (12 N^2 D FLOP) over the
    fp32 peak, against z1, z2 read once (and the gradient written once)
    over the HBM rate."""
    flops = (9 if kind == "fwd" else 12) * N * N * D
    words = 2 * N * D + 1 + (N * D if kind == "bwd" else 0)
    t_ops, t_bytes = flops / FP32_PEAK, 4 * words / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main():
    phase_s = {}
    t_mark = [T_START]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now

    sys.path.insert(0, ROOT)
    from controlled_peptide_generation_tpu_torch.ops import cuda_build

    # ---- 2. build: one nvcc per source, started together before torch is
    # imported; the imports and the device's start-up run while they
    # compile (the kernel modules then load the libraries built here)
    t_build = time.perf_counter()

    def timed_build(source):
        log_ = cuda_build.compile_library(source)[1]
        return time.perf_counter() - t_build, log_

    sources = ("beam_gru.cu", "gru_seq.cu", "tfm_beam.cu", "mmd_full.cu")
    from controlled_peptide_generation_tpu_torch import native

    def timed_native():
        native.build()
        return time.perf_counter() - t_build

    pool = ThreadPoolExecutor(len(sources) + 1)
    builds = [pool.submit(timed_build, src) for src in sources]
    native_build = pool.submit(timed_native)
    pool.shutdown(wait=False)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    mark("1a import torch")
    import numpy as np
    from controlled_peptide_generation_tpu_torch import config as C
    from controlled_peptide_generation_tpu_torch import pipeline
    from controlled_peptide_generation_tpu_torch import sample_pipeline
    from controlled_peptide_generation_tpu_torch import serve
    from controlled_peptide_generation_tpu_torch import static_eval
    from controlled_peptide_generation_tpu_torch.api import (
        load_trained_model, load_vocab)
    from controlled_peptide_generation_tpu_torch.latent import fused
    from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
        build_model)
    from controlled_peptide_generation_tpu_torch import main as train_main
    from controlled_peptide_generation_tpu_torch.data.vocab import EOS_IDX
    from controlled_peptide_generation_tpu_torch.models import (
        transformer as tfm)
    from controlled_peptide_generation_tpu_torch.ops import beam, beam_kernel
    from controlled_peptide_generation_tpu_torch.ops import nn
    from controlled_peptide_generation_tpu_torch.ops import gru as gru_ops
    from controlled_peptide_generation_tpu_torch.ops import gru_fwd_kernel
    from controlled_peptide_generation_tpu_torch.ops import gru_kernel
    from controlled_peptide_generation_tpu_torch.ops import losses
    from controlled_peptide_generation_tpu_torch.ops import mmd_kernel
    from controlled_peptide_generation_tpu_torch.ops import tfm_beam_kernel
    from controlled_peptide_generation_tpu_torch.parallel import dist as pdist
    from controlled_peptide_generation_tpu_torch.parallel import (
        rounds as dp_rounds)
    from controlled_peptide_generation_tpu_torch.train import checkpoints
    from controlled_peptide_generation_tpu_torch.train import opt as train_opt
    from controlled_peptide_generation_tpu_torch.tools import beam_split
    from controlled_peptide_generation_tpu_torch.train import train_full
    from controlled_peptide_generation_tpu_torch.train import train_vae
    from controlled_peptide_generation_tpu_torch.tools import profile_train
    from torch.profiler import ProfilerActivity, profile
    from controlled_peptide_generation_tpu_torch.utils import runtime
    from controlled_peptide_generation_tpu_torch.vis import build_index
    from controlled_peptide_generation_tpu_torch.vis import covar, kde, tsne
    from controlled_peptide_generation_tpu_torch.evals import alignment
    from controlled_peptide_generation_tpu_torch.evals import peptide_evals

    cuda_ms = runtime.cuda_ms

    # ---- 1. device ------------------------------------------------------
    dev = runtime.setup("cuda")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    LOG_FILE.append(open(os.path.join(ROOT, "chiprun_out", "chip_smoke.log"),
                         "w"))
    card = runtime.card_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    mark("1b imports and device, the builds running")

    built = [b.result() for b in builds]
    for kernel in (beam_kernel, gru_kernel, tfm_beam_kernel, mmd_kernel):
        kernel.build()
    native_s = native_build.result()
    log("[2] built " + ", ".join(
        f"csrc/{src} in {sec:.2f}s" for src, (sec, _) in zip(sources, built))
        + f", native/_tokenizer.c (gcc) in {native_s:.2f}s, from the start "
        f"of the build ({native.library_path()})")
    mark("2a waiting for the builds")
    for _, nvcc_log in built:
        for line in nvcc_log.splitlines():
            if "Compiling entry" in line or "registers" in line or (
                    "spill" in line):
                log(f"    ptxas: {line.strip()}")
    # the GRU scan's instantiations at each plan width (forward-only and
    # the training forward's, with residual stores), the backward's, the
    # bf16 ones on the tensor cores and the weight gradient's: the scans and
    # the backwards keep wh in registers, so no spill is allowed
    usage = gru_kernel.ptxas_report()
    for H_ in PTXAS_WIDTHS:
        sp = gru_kernel.launch_plan(1, H_)["scan"]
        prefix = f"{sp['KS']}, {sp['S']},"
        found = [n for n in usage if n.startswith((
            f"gru_scan_kernel<{prefix}", f"gru_bwd_kernel<{prefix}"))]
        if not any(n.startswith("gru_bwd") for n in found):
            raise AssertionError(f"no ptxas report of the backward at H "
                                 f"{H_} ({sorted(usage)})")
        for name in sorted(found):
            regs, st, ld = usage[name]
            log(f"[2] H {H_}: {name} (KS, S, R) {regs} registers, spill "
                f"stores {st} B, spill loads {ld} B")
    for name, (regs, st, ld) in sorted(usage.items()):
        if name.startswith(("gru_scan_mma", "gru_bwd_mma")):
            log(f"[2] {name} (k16 steps, rows a block) {regs} registers, "
                f"spill stores {st} B, spill loads {ld} B")
    log("[2] the bf16 scan's and backward's plans (KT, rows, threads, "
        "tiles, grids): " + "; ".join(
            f"H {H_} B {B}: {gru_kernel.bf16_plan(B, H_)}"
            for H_ in (80, 102, 127) for B in B2_BF16_BATCHES))
    for name, (regs, st, ld) in usage.items():
        if name.startswith("gru_wgrad"):
            log(f"[2] {name} (values per copy) {regs} registers, spill "
                f"stores {st} B, spill loads {ld} B")
    cuda_build.check_no_spills(usage, "gru_seq.cu", (
        "gru_scan_kernel", "gru_bwd_kernel", "gru_scan_mma_kernel",
        "gru_bwd_mma_kernel", "gru_wgrad_kernel", "gru_wgrad_mma_kernel"))
    # B5: the value's instantiations and the gradient's, none may spill
    mmd_usage = mmd_kernel.ptxas_report()
    for name, (regs, st, ld) in sorted(mmd_usage.items()):
        log(f"[2] csrc/mmd_full.cu {name}: {regs} registers, spill stores "
            f"{st} B, spill loads {ld} B")
    cuda_build.check_no_spills(mmd_usage, "mmd_full.cu",
                               ("mmd_fwd_kernel", "mmd_grad_kernel"))
    # the beams: each production instantiation beside its stamp one
    for kernel, src in ((beam_kernel, "beam_gru.cu"),
                        (tfm_beam_kernel, "tfm_beam.cu")):
        for name, (regs, st, ld) in sorted(kernel.ptxas_report().items()):
            log(f"[2] csrc/{src} {name}: {regs} registers, spill stores "
                f"{st} B, spill loads {ld} B")

    # ---- run dir: seeded full-width checkpoint + amp vocab ----------------
    run_top = os.path.join(ROOT, "build", "chip_smoke_run")
    flags = ["--savepath_toplevel", run_top, "--runname", "smoke",
             "--vae.n_iter", "1", "--seed", "1238"]
    cfg, _, _ = C.parse_and_finalize(flags)
    vocab = load_vocab(os.path.join(ROOT, "data", "amp", "vocab.dict"))
    vocab.save(os.path.join(cfg.savepath, "vocab.dict"))
    init = build_model(cfg.model, vocab.size(), cfg.max_seq_len).init_params(
        torch.Generator().manual_seed(cfg.seed))
    ckpt = os.path.join(cfg.savepath, "model_1.npz")
    checkpoints.save(ckpt, init)
    model, params = load_trained_model(ckpt, vocab.size(), cfg, device=dev)
    if (model.n_vocab, model.h_dec, model.max_seq_len) != (V, H, T):
        raise AssertionError("the smoke run expects the shipped width")

    # the transformer family's run dir: its own seeded full-width checkpoint
    tflags_t = ["--savepath_toplevel", run_top, "--runname", "smoke_tfm",
                "--vae.n_iter", "1", "--seed", "1238"] + TFM_FLAGS
    cfg_t, _, _ = C.parse_and_finalize(tflags_t)
    vocab.save(os.path.join(cfg_t.savepath, "vocab.dict"))
    ckpt_t = os.path.join(cfg_t.savepath, "model_1.npz")
    checkpoints.save(ckpt_t, build_model(
        cfg_t.model, vocab.size(), cfg_t.max_seq_len).init_params(
            torch.Generator().manual_seed(cfg_t.seed)))
    model_t3, params_t3 = load_trained_model(ckpt_t, vocab.size(), cfg_t,
                                             device=dev)
    if not (model_t3.G_class == "transformer" and tfm_beam_kernel.applicable(
            model_t3, K, torch.float32)):
        raise AssertionError("the transformer smoke model is outside B3")

    mark("2b run dirs and checkpoints")

    # ---- 3. kernel vs plain --------------------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    n_max = max(BATCHES)
    z_all = torch.randn((n_max, model.z_dim), generator=g, device=dev)
    c_all = model.sample_c_prior(g, n_max, device=dev)

    decode_inputs = beam.decode_inputs

    def scan_inputs(B):
        return decode_inputs(model, params, z_all[:B], c_all[:B])[0]

    def compare(ins, kw, what, scan=beam_kernel.beam_scan_gru,
                ref_scan=beam_kernel.beam_scan_gru_reference,
                plan=lambda B, kw: beam_kernel.launch_plan(
                    B, kw["K"], kw["V"], kw["H"])):
        """Kernel vs plain version on the same inputs: every tape. A row
        agrees when its token and pointer tapes are identical; on those
        rows adv and fin_cnt must be equal and the per-step sc tape and
        the final scores within MAX_SCORE_DELTA. Returns the kernel's
        tapes and the max delta on the agreeing rows."""
        got = scan(*ins, **kw)
        ref = ref_scan(*ins, **kw)
        torch.cuda.synchronize()
        B = got[3].shape[0]
        same = ((got[0] == ref[0]).all(dim=(1, 2))
                & (got[1] == ref[1]).all(dim=(1, 2)))
        share_same = same.float().mean().item()
        if not same.any():
            raise AssertionError(f"kernel agrees on no row ({what})")
        # sc is read only on live steps (t < adv: finalization keys finished
        # hypotheses, ys == EOS, by it); once a sentence is done its sc stays
        # ungated while its hidden state advances unseen, so a near-tie
        # there shows in no other tape and is not held. Live entries at the
        # -1e20 blocking scale (fp32 spacing ~1e13 there) must be blocked on
        # both sides; the delta limit holds on the others.
        live = (torch.arange(kw["T"], device=dev)[None, :]
                < ref[4][:, None])[same]
        sc_got, sc_ref = got[2][same][live], ref[2][same][live]
        blocked = sc_ref <= beam_kernel.NEG / 2
        blocked_eq = torch.equal(sc_got <= beam_kernel.NEG / 2, blocked)
        sc_delta = ((sc_got - sc_ref).abs()[~blocked].max().item()
                    if not blocked.all() else 0.0)
        done_delta = ((got[2] - ref[2]).abs()[same][~live].max().item()
                      if not live.all() else 0.0)
        delta = (got[3] - ref[3]).abs()[same].max().item()
        adv_eq = torch.equal(got[4][same], ref[4][same])
        fin_eq = torch.equal(got[5][same], ref[5][same])
        uniq = []
        for tapes in (got, ref):
            top1 = beam.hyps_from_tapes(tapes, 1)[0][:, 0].cpu().numpy()
            uniq.append(len(set(pipeline.canonical_keys(top1))) / B)
        log(f"[3] {what}: rows differing {1 - share_same:.6f}; on agreeing "
            f"rows max |scores delta| {delta:.3e}, max |sc tape delta| on "
            f"live steps {sc_delta:.3e} (blocked entries "
            f"{int(blocked.sum())}, same {blocked_eq}; done steps, not "
            f"held: {done_delta:.3e}), adv equal {adv_eq}, fin_cnt equal "
            f"{fin_eq}; "
            f"uniq ratio kernel {uniq[0]:.4f} plain {uniq[1]:.4f}; plan "
            f"{plan(B, kw)}")
        if (share_same < MIN_SAME_ROWS or delta > MAX_SCORE_DELTA
                or sc_delta > MAX_SCORE_DELTA or not blocked_eq
                or not adv_eq or not fin_eq):
            raise AssertionError(
                f"kernel disagrees with its plain version ({what}): "
                f"{share_same:.4f} identical rows (need {MIN_SAME_ROWS}), "
                f"max scores delta {delta:.3e} and sc delta {sc_delta:.3e} "
                f"(limit {MAX_SCORE_DELTA}), blocked sc entries same "
                f"{blocked_eq}, adv equal {adv_eq}, fin_cnt equal {fin_eq}")
        return got, max(delta, sc_delta)

    kw = dict(T=T, K=K, V=V, H=H, min_length=1, n_best=1)
    max_err = 0.0
    outs = {}
    for B in BATCHES:
        outs[B], delta = compare(scan_inputs(B), kw, f"B={B}")
        max_err = max(max_err, delta)
    for a, b in zip(outs[12288], outs[2500]):
        if not torch.equal(a[:2500], b):
            raise AssertionError("kernel is not batch invariant: rows of "
                                 "B=12288 differ from B=2500")
    log("[3] batch invariance: first 2500 rows of B=12288 == B=2500 "
        "bitwise")
    mark("3a beam batches")
    # the rest of the kernel's scope, on seeded random weights: other beam
    # settings, weights read through the caches (H 127, V 128: too big for
    # shared memory), the widest beam (K = V - 2)
    gs = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, sc):
        return sc * torch.randn(shape, generator=gs, device=dev)

    for t_, k_, v_, h_, ml, nb in SCOPE_CASES:
        B = 512
        ins = (rnd(v_, 3 * h_, sc=0.5), rnd(B, 3 * h_, sc=0.5),
               rnd(h_, 3 * h_, sc=h_ ** -0.5), rnd(3 * h_, sc=0.1),
               rnd(h_, v_, sc=3 * h_ ** -0.5), rnd(v_, sc=0.1),
               rnd(B, h_, sc=1.0))
        compare(ins, dict(T=t_, K=k_, V=v_, H=h_, min_length=ml, n_best=nb),
                f"scope T={t_} K={k_} V={v_} H={h_} min_length={ml} "
                f"n_best={nb} B={B}")
    mark("3b beam scope cases")
    times = {}
    for B in (2500, 5000):
        ins = scan_inputs(B)
        times[B] = (
            cuda_ms(lambda: beam_kernel.beam_scan_gru(*ins, **kw), 20),
            cuda_ms(lambda: beam_kernel.beam_scan_gru_reference(*ins, **kw),
                    5),
            bound_ms(B))
    del outs
    mark("3c beam timings")

    # ---- 3t. B3: the transformer beam kernel vs its plain version -------
    b3_scan = dict(scan=tfm_beam_kernel.beam_scan_tfm,
                   ref_scan=tfm_beam_kernel.beam_scan_tfm_reference,
                   plan=lambda B, kw: tfm_beam_kernel.launch_plan(
                       B, kw["K"], kw["V"], kw["S"], kw["F"]))
    n3 = max(B3_BATCHES)
    z3 = torch.randn((n3, model_t3.z_dim), generator=g, device=dev)
    c3 = model_t3.sample_c_prior(g, n3, device=dev)

    def b3_inputs(m, p, B, **kw):
        ins, dims = decode_inputs(m, p, z3[:B], c3[:B])
        return ins, dict(kw, **dims)

    kw3 = dict(T=T, K=K, V=V, min_length=1, n_best=1)
    b3_err = 0.0
    outs3 = {}
    for B in B3_BATCHES:
        ins, kwb = b3_inputs(model_t3, params_t3, B, **kw3)
        outs3[B], delta = compare(ins, kwb, f"B3 B={B}", **b3_scan)
        b3_err = max(b3_err, delta)
    for a, b in zip(outs3[12288], outs3[2500]):
        if not torch.equal(a[:2500], b):
            raise AssertionError("B3 is not batch invariant: rows of "
                                 "B=12288 differ from B=2500")
    log("[3] B3 batch invariance: first 2500 rows of B=12288 == B=2500 "
        "bitwise")
    del outs3
    mark("3t-a B3 batches")
    for what, t_, k_, ml, nb, over in B3_SCOPE_CASES:
        cfg_s = C.parse_and_finalize(tflags_t)[0]
        for key in ("d_ff", "n_heads"):
            if key in over:
                cfg_s.model.G_args.T_args[key] = over[key]
        m_s = build_model(cfg_s.model, over.get("n_vocab", V),
                          over.get("max_seq_len", T))
        p_s = m_s.init_params(torch.Generator(device=dev).manual_seed(5), dev)
        ins, kwb = b3_inputs(m_s, p_s, 512, T=t_, K=k_, V=m_s.n_vocab,
                             min_length=ml, n_best=nb)
        compare(ins, kwb, f"B3 scope {what}: T={t_} K={k_} V={m_s.n_vocab} "
                f"S={kwb['S']} H={kwb['H']} F={kwb['F']} min_length={ml} "
                f"n_best={nb} B=512", **b3_scan)
    mark("3t-b B3 scope cases")
    b3_times = {}
    for B in (2500, 5000):
        ins, kwb = b3_inputs(model_t3, params_t3, B, **kw3)
        b3_times[B] = (
            cuda_ms(lambda: tfm_beam_kernel.beam_scan_tfm(*ins, **kwb), 10),
            cuda_ms(lambda: tfm_beam_kernel.beam_scan_tfm_reference(
                *ins, **kwb), 3),
            b3_bound_ms(B))
    mark("3t-c B3 timings")

    # ---- 3-bf16, 3t-bf16: the bf16 kernels vs their plain versions -------
    # the decode in bf16 as --hw.gen_dtype bfloat16 runs it (the weight tree
    # cast), and B3 also with T_args.bf16 over the f32 weights
    BF = torch.bfloat16
    params_bf = nn.cast_tree(params, BF)
    params_t3_bf = nn.cast_tree(params_t3, BF)
    cfg_tb = C.parse_and_finalize(tflags_t + [
        "--model.G_args.T_args.bf16", "1"])[0]
    model_tb = build_model(cfg_tb.model, vocab.size(), cfg_tb.max_seq_len)

    def teacher_forced(ins, dims, toks, T_):
        """The teacher-forced score of each row of toks [B, T_+1] (BOS
        first) under the plain version's step: the sum of its f32
        log-probabilities up to and including the first EOS (over all T_
        steps where none)."""
        dt = ins[0].dtype
        tok = nn.canonical_zeros(ins[0])
        B_ = toks.shape[0]
        picks = []
        if "S" in dims:                         # B3: the folded transformer
            pos, layers, lg, lb, wo, bo, k0s, v0s = ins[1:]
            caches = []
            for rows in (k0s, v0s):
                for r in rows:
                    c_ = torch.zeros((B_, dims["S"], tok.shape[1]), dtype=dt,
                                     device=dev)
                    c_[:, 0] = r.to(dt)
                    caches.append(c_)
            L_ = len(layers)
            for t in range(T_):
                x = (tok[toks[:, t]] + pos[t + 1]).to(dt)
                p_ = torch.full((B_,), t + 1, dtype=torch.int32, device=dev)
                for l, lp in enumerate(layers):
                    x, caches[l], caches[L_ + l] = tfm._block_step(
                        lp, x, caches[l], caches[L_ + l], p_, dims["H"],
                        write_pos=t + 1)
                logits = nn.linear({"w": wo, "b": bo}, tfm.final_ln(
                    {"g": lg, "b": lb}, x, dt)).float()
                picks.append(torch.log_softmax(logits, -1).gather(
                    1, toks[:, t + 1:t + 2])[:, 0])
        else:                                   # B1: the GRU step
            zc_gi, wh, bh, wo, bo, zc0 = ins[1:]
            h_ = zc0.to(dt)
            for t in range(T_):
                h_ = beam_kernel.gru_cell_bf16_points(tok[toks[:, t]] + zc_gi,
                                                      h_, wh, bh)
                logits = (h_.float() @ wo.float() + bo.float()).to(dt)
                picks.append(torch.log_softmax(logits.float(), -1).gather(
                    1, toks[:, t + 1:t + 2])[:, 0])
        body = toks[:, 1:T_ + 1]
        eos = (body == EOS_IDX).int()
        live = (torch.cumsum(eos, 1) - eos) == 0
        return (torch.stack(picks, 1) * live).sum(1)

    def recompute_gate(ins, dims, tapes, T_, what):
        """Gate (c): the kernel's top-1 score of each sentence against its
        teacher-forced recompute. Returns the largest |delta|."""
        hyps, sc_ = beam.hyps_from_tapes(tapes, 1)
        rec = teacher_forced(ins, dims, hyps[:, 0], T_)
        err = (sc_[:, 0] - rec).abs()
        lim = BF16_RECOMPUTE_ATOL + BF16_RECOMPUTE_RTOL * rec.abs()
        if (err > lim).any() or not torch.isfinite(rec).all():
            raise AssertionError(
                f"{what}: a top-1 score disagrees with its teacher-forced "
                f"recompute under the plain version: max |delta| "
                f"{err.max().item():.4f}, {int((err > lim).sum())} rows "
                f"beyond atol {BF16_RECOMPUTE_ATOL} + rtol "
                f"{BF16_RECOMPUTE_RTOL}")
        return err.max().item()

    def compare_bf16(ins, dims, kw, what, scan, ref_scan, tag):
        """A bf16 kernel against its plain version on the same inputs: gate
        (b) at T 1, gates (c) and (d) at kw's T. Returns (the kernel's
        tapes at kw's T, the largest |score delta| on the T 1 rows that
        agree, the kernel's and the plain version's unique top-1 decodes)."""
        def rows_same(a, b):
            return ((a[0] == b[0]).all(dim=(1, 2))
                    & (a[1] == b[1]).all(dim=(1, 2)))
        kw1 = dict(kw, **dims, T=1)
        got1, ref1 = scan(*ins, **kw1), ref_scan(*ins, **kw1)
        same1 = rows_same(got1, ref1)
        d1 = ((got1[3] - ref1[3]).abs()[same1].max().item()
              if same1.any() else float("inf"))
        kwt = dict(kw, **dims)
        got, ref = scan(*ins, **kwt), ref_scan(*ins, **kwt)
        torch.cuda.synchronize()
        share1 = same1.float().mean().item()
        share = rows_same(got, ref).float().mean().item()
        rec_err = recompute_gate(ins, dims, got, kw["T"], what)
        uniq = [len(set(pipeline.canonical_keys(
            beam.hyps_from_tapes(tp, 1)[0][:, 0].cpu().numpy())))
            for tp in (got, ref)]
        log(f"[{tag}] {what}: T 1 rows identical {share1:.6f}, max |score "
            f"delta| on them {d1:.3e}; T {kw['T']} rows identical "
            f"{share:.6f}, max |top-1 score - teacher-forced recompute| "
            f"{rec_err:.4f}; unique top-1 decodes kernel {uniq[0]} plain "
            f"{uniq[1]}")
        if share1 < BF16_T1_SAME_ROWS or d1 > BF16_T1_SCORE_DELTA:
            raise AssertionError(
                f"{what}: at T 1 {share1:.4f} identical rows (need "
                f"{BF16_T1_SAME_ROWS}), max score delta {d1:.3e} (limit "
                f"{BF16_T1_SCORE_DELTA})")
        if share < BF16_T25_SAME_ROWS:
            raise AssertionError(
                f"{what}: at T {kw['T']} {share:.4f} identical rows (need "
                f"{BF16_T25_SAME_ROWS})")
        return got, d1, uniq

    bf16_stats = {}
    b3_kernels = dict(scan=tfm_beam_kernel.beam_scan_tfm,
                      ref_scan=tfm_beam_kernel.beam_scan_tfm_reference)
    b1_kernels = dict(scan=beam_kernel.beam_scan_gru,
                      ref_scan=beam_kernel.beam_scan_gru_reference)
    for tag, m, p, z_all_, c_all_, kern in (
            ("3-bf16", model, params_bf, z_all, c_all, b1_kernels),
            ("3t-bf16", model_t3, params_t3_bf, z3, c3, b3_kernels),
            ("3t-bf16 T_args.bf16", model_tb, params_t3, z3, c3,
             b3_kernels)):
        outs_bf, err_bf = {}, 0.0
        for B in BF16_BATCHES:
            ins, dims = decode_inputs(m, p, z_all_[:B], c_all_[:B])
            outs_bf[B], d1, uniq = compare_bf16(
                ins, dims, dict(T=T, K=K, V=V, min_length=1, n_best=1),
                f"B={B}", tag=tag, **kern)
            err_bf = max(err_bf, d1)
            if B == 5000:
                ratio = uniq[0] / uniq[1]
                log(f"[{tag}] uniq_ratio at B 5000: {ratio:.6f}")
                if not BF16_UNIQ_RATIO[0] <= ratio <= BF16_UNIQ_RATIO[1]:
                    raise AssertionError(f"{tag}: uniq_ratio {ratio:.4f} "
                                         f"outside {BF16_UNIQ_RATIO}")
        for a, b in zip(outs_bf[12288], outs_bf[2500]):
            if not torch.equal(a[:2500], b):
                raise AssertionError(f"{tag}: not batch invariant: rows of "
                                     f"B=12288 differ from B=2500")
        log(f"[{tag}] batch invariance: first 2500 rows of B=12288 == "
            f"B=2500 bitwise")
        del outs_bf
        bf16_stats[tag] = err_bf
        mark(f"{tag} batches")
    # the scope edges in bf16: B1's on seeded random inputs, B3's on
    # seeded models with the weight tree cast
    for t_, k_, v_, h_, ml, nb in SCOPE_CASES:
        B = 512
        ins = tuple(a.to(BF) for a in (
            rnd(v_, 3 * h_, sc=0.5), rnd(B, 3 * h_, sc=0.5),
            rnd(h_, 3 * h_, sc=h_ ** -0.5), rnd(3 * h_, sc=0.1),
            rnd(h_, v_, sc=3 * h_ ** -0.5), rnd(v_, sc=0.1),
            rnd(B, h_, sc=1.0)))
        compare_bf16(ins, {"H": h_}, dict(T=t_, K=k_, V=v_, min_length=ml,
                                          n_best=nb),
                     f"scope T={t_} K={k_} V={v_} H={h_} min_length={ml} "
                     f"n_best={nb} B={B}", tag="3-bf16", **b1_kernels)
    for what, t_, k_, ml, nb, over in B3_SCOPE_CASES:
        cfg_s = C.parse_and_finalize(tflags_t)[0]
        for key in ("d_ff", "n_heads"):
            if key in over:
                cfg_s.model.G_args.T_args[key] = over[key]
        m_s = build_model(cfg_s.model, over.get("n_vocab", V),
                          over.get("max_seq_len", T))
        p_s = nn.cast_tree(m_s.init_params(
            torch.Generator(device=dev).manual_seed(5), dev), BF)
        ins, dims = decode_inputs(m_s, p_s, z3[:512], c3[:512])
        compare_bf16(ins, dims, dict(T=t_, K=k_, V=m_s.n_vocab,
                                     min_length=ml, n_best=nb),
                     f"scope {what}: T={t_} K={k_} V={m_s.n_vocab} "
                     f"S={dims['S']} H={dims['H']} F={dims['F']} "
                     f"min_length={ml} n_best={nb} B=512", tag="3t-bf16",
                     **b3_kernels)
    mark("3-bf16 scope cases")
    bf16_times = {}
    for tag, m, p, kern, bound in (
            ("B1", model, params_bf, b1_kernels, bound_ms),
            ("B3", model_t3, params_t3_bf, b3_kernels, b3_bound_ms)):
        for B in (2500, 5000):
            zz, cc = (z_all, c_all) if tag == "B1" else (z3, c3)
            ins, dims = decode_inputs(m, p, zz[:B], cc[:B])
            kwb = dict(T=T, K=K, V=V, min_length=1, n_best=1, **dims)
            bf16_times[tag, B] = (
                cuda_ms(lambda: kern["scan"](*ins, **kwb),
                        20 if tag == "B1" else 10),
                cuda_ms(lambda: kern["ref_scan"](*ins, **kwb), 3),
                bound(B, bf16=True))
    mark("3-bf16 timings")

    # ---- 3s. the beams' phase split, through their stamp entries ---------
    for tag, m, kern, stamped, zz, cc in (
            ("B1", model, beam_kernel.beam_scan_gru,
             beam_kernel.beam_scan_gru_stamped, z_all, c_all),
            ("B3", model_t3, tfm_beam_kernel.beam_scan_tfm,
             tfm_beam_kernel.beam_scan_tfm_stamped, z3, c3)):
        p32 = params if tag == "B1" else params_t3
        for dname, p_ in (("f32", p32), ("bf16", nn.cast_tree(p32, BF))):
            for B in (5000, 2500):
                ins, dims = decode_inputs(m, p_, zz[:B], cc[:B])
                kwb = dict(T=T, K=K, V=V, min_length=1, n_best=1, **dims)
                lines, _ = beam_split.split_lines(
                    f"{tag} {dname} B {B}", kern, stamped, ins, kwb)
                if B == 5000:
                    lines += beam_split.host_lines(f"{tag} {dname} B {B}",
                                                   ins, kwb)
                for line in lines:
                    log(f"[3s] {line} ({card})")
    mark("3s beam phase split")

    # ---- 4. B2: the GRU recurrence kernels vs their plain versions -------
    gb = torch.Generator(device=dev).manual_seed(2)
    b2_err = {"fwd": 0.0, "bwd": 0.0, "wgrad": 0.0}
    grad_names = ("wi", "bi", "wh", "bh", "xs", "h0")

    def rel_err(got, want):
        return ((got - want).abs().max()
                / want.abs().max().clamp_min(1e-30)).item()

    def plan_line(B, H):
        """The recurrence kernels' shared plan and each one's grid."""
        pl = gru_kernel.launch_plan(B, H)
        sp = pl["bwd"]
        return (f"S {sp['S']} KS {sp['KS']} R {sp['rows']}, {sp['threads']} "
                f"threads, {sp['tiles']} tiles, grids (scan, training "
                f"forward, backward) {pl['scan']['grid']}, "
                f"{pl['train_fwd']['grid']}, {sp['grid']}")

    def b2_case(I, H, B, T_, what, scan=False):
        """The training forward (hs and its residual tape), the backward
        and the weight gradient against their plain versions on the same
        inputs: the backward against both, the chain given the kernel
        forward's residuals and the full recompute; the backward twice
        (bitwise equal); with ``scan``, gru_scan through autograd too, both
        directions, kernels against cuda_build.plain()."""
        p = gru_ops.init_gru_params(gb, I, H, dev)
        xs = torch.randn((B, T_, I), generator=gb, device=dev)
        h0 = 0.5 * torch.randn((B, H), generator=gb, device=dev)
        gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1).contiguous()
        hs, res = gru_kernel.gru_seq_fwd(p["wh"], p["bh"], gi, h0)
        hs_ref, res_ref = gru_kernel.gru_seq_res_reference(p["wh"], p["bh"],
                                                           gi, h0)
        dhs = torch.randn(hs.shape, generator=gb, device=dev)
        runs = []
        for _ in range(2):
            dgi, dghn, dh0 = gru_kernel.gru_seq_bwd(p["wh"], h0, hs, res,
                                                    dhs)
            runs.append(gru_kernel.gru_seq_wgrad(h0, hs, dgi, dghn)
                        + (dgi, dh0))
        dgi_c, dghn_c, dh0_c = gru_kernel._bwd_chain_reference(
            p["wh"], h0, hs, res, dhs)
        refs = {"chain": gru_kernel._wgrad_reference(h0, hs, dgi_c, dghn_c)
                + (dgi_c, dh0_c),
                "recompute": gru_kernel.gru_seq_bwd_reference(
                    p["wh"], p["bh"], gi, h0, hs, dhs)}
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
        e_hs = max((hs - hs_ref).abs().max().item(),
                   (res - res_ref).abs().max().item())
        errs = {f"{n} vs {kind}": rel_err(a, b) for kind, ref in refs.items()
                for n, a, b in zip(("dwh", "dbh", "dgi", "dh0"), runs[0],
                                   ref)}
        b2_err["fwd"] = max(b2_err["fwd"], e_hs)
        for ref in refs.values():
            b2_err["wgrad"] = max(b2_err["wgrad"], *(
                (a - b).abs().max().item()
                for a, b in zip(runs[0][:2], ref[:2])))
            b2_err["bwd"] = max(b2_err["bwd"], *(
                (a - b).abs().max().item()
                for a, b in zip(runs[0][2:], ref[2:])))
        w = torch.randn((B, T_, H), generator=gb, device=dev)
        w_last = torch.randn((B, H), generator=gb, device=dev)
        scan_errs = {}
        for reverse in (False, True) if scan else ():
            outs = []
            for plain in (False, True):
                leaves = [p[k].detach().requires_grad_() for k in grad_names[:4]]
                x = xs.detach().requires_grad_()
                h = h0.detach().requires_grad_()
                with (cuda_build.plain() if plain
                      else contextlib.nullcontext()):
                    out, last = gru_ops.gru_scan(
                        dict(zip(grad_names, leaves)), x, h, reverse=reverse)
                    loss = (out * w).sum() + (last * w_last).sum()
                    outs.append((out.detach(), torch.autograd.grad(
                        loss, leaves + [x, h])))
            e_scan = (outs[0][0] - outs[1][0]).abs().max().item()
            g_errs = [rel_err(a, b) for a, b in zip(outs[0][1], outs[1][1])]
            scan_errs["reverse" if reverse else "forward"] = (e_scan,
                                                              max(g_errs))
            if e_scan > MAX_HS_DELTA or max(g_errs) > MAX_GRAD_REL:
                raise AssertionError(
                    f"gru_scan kernels vs cuda_build.plain() disagree "
                    f"({what}, reverse={reverse}): hs {e_scan:.3e}, grads "
                    f"{dict(zip(grad_names, g_errs))}")
        log(f"[4] {what}: max |hs, residual delta| {e_hs:.3e}; backward "
            f"rel errors "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; backward bitwise repeatable {bitwise}"
            + ("; gru_scan vs cuda_build.plain() (|hs delta|, max grad rel "
               "error): " + ", ".join(f"{k} {a:.3e} {b:.3e}" for k, (a, b)
                                       in scan_errs.items())
               if scan else "")
            + f"; plan {plan_line(B, H)}, wgrad "
            f"{gru_kernel.wgrad_plan(T_, B, H)}")
        if (e_hs > MAX_HS_DELTA or max(errs.values()) > MAX_GRAD_REL
                or not bitwise):
            raise AssertionError(
                f"B2 kernels disagree with their plain versions ({what}): "
                f"hs and residuals {e_hs:.3e} (limit {MAX_HS_DELTA}), grads "
                f"{errs} (limit "
                f"{MAX_GRAD_REL} of each tensor's max), bitwise {bitwise}")

    for I, H_ in B2_WIDTHS:
        for B in B2_BATCHES:
            b2_case(I, H_, B, T, f"B2 in {I} H {H_} T {T} B {B}",
                    scan=B == B2_SCAN_BATCH)
    for I, H_, B, T_ in B2_SCOPE_CASES:
        b2_case(I, H_, B, T_, f"B2 scope in {I} H {H_} T {T_} B {B}")
    mark("4a B2 kernels vs plain")

    def b2_timing(I, H_, B):
        """Times of B2's kernels (the training forward with its residual
        stores, beside B4, the same scan without them, on the same tape; the
        backward; the weight gradient), their plain versions and bounds, and
        of the library calls beside them, at one width and batch, T 25."""
        p = gru_ops.init_gru_params(gb, I, H_, dev)
        xs = torch.randn((B, T, I), generator=gb, device=dev)
        h0 = 0.5 * torch.randn((B, H_), generator=gb, device=dev)
        gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1).contiguous()
        hs, res = gru_kernel.gru_seq_fwd(p["wh"], p["bh"], gi, h0)
        dhs = torch.randn(hs.shape, generator=gb, device=dev)
        dgi, dghn, _ = gru_kernel.gru_seq_bwd(p["wh"], h0, hs, res, dhs)
        args = (p["wh"], p["bh"], gi, h0)
        # the weight gradient as one cuBLAS product: [h_{t-1} | 1]^T dgh
        # gives dwh and, in its last row, dbh
        hprev1 = torch.cat([torch.cat([h0[None], hs[:-1]]).reshape(-1, H_),
                            torch.ones((T * B, 1), device=dev)], 1)
        dgh = torch.cat([dgi[..., :2 * H_], dghn], 2).reshape(-1, 3 * H_)
        lib_w = torch.mm(hprev1.T, dgh)
        w_runs = [gru_kernel.gru_seq_wgrad(h0, hs, dgi, dghn)
                  for _ in range(2)]
        wgrad_delta = max((a - b).abs().max().item() for a, b in zip(
            w_runs[0], (lib_w[:H_], lib_w[H_])))
        w_rel = max(rel_err(a, b) for a, b in zip(
            w_runs[0], (lib_w[:H_], lib_w[H_])))
        w_bitwise = all(torch.equal(a, b) for a, b in zip(*w_runs))
        log(f"[4] B2 wgrad at B {B}, H {H_}: two runs bitwise equal "
            f"{w_bitwise}; against one torch.mm max |delta| "
            f"{wgrad_delta:.3e}, {w_rel:.3e} of the largest entry; plan "
            f"{gru_kernel.wgrad_plan(T, B, H_)}")
        if not w_bitwise or w_rel > MAX_GRAD_REL:
            raise AssertionError(f"B2 wgrad at B {B}: bitwise {w_bitwise}, "
                                 f"{w_rel:.3e} of torch.mm's largest entry")
        kern = {
            "fwd": (lambda: gru_kernel.gru_seq_fwd(*args),
                    lambda: gru_kernel.gru_seq_res_reference(*args)),
            # the same scan without residual stores: B4, on the same tape
            "fwd_nores": (lambda: gru_fwd_kernel.gru_fwd(*args),
                          lambda: gru_fwd_kernel.gru_fwd_reference(*args)),
            "bwd": (lambda: gru_kernel.gru_seq_bwd(p["wh"], h0, hs, res,
                                                   dhs),
                    lambda: gru_kernel._bwd_chain_reference(p["wh"], h0, hs,
                                                            res, dhs)),
            "wgrad": (lambda: gru_kernel.gru_seq_wgrad(h0, hs, dgi, dghn),
                      lambda: gru_kernel._wgrad_reference(h0, hs, dgi,
                                                          dghn)),
        }
        # cuDNN: one torch.nn.GRU call on the same [B, T, in] inputs with
        # the weights transposed (it includes the input projection), and
        # the port's gru_scan with its projection, for a like-for-like read
        cudnn = torch.nn.GRU(I, H_, batch_first=True).to(dev)
        with torch.no_grad():
            for name, src in (("weight_ih_l0", p["wi"].T),
                              ("weight_hh_l0", p["wh"].T),
                              ("bias_ih_l0", p["bi"]),
                              ("bias_hh_l0", p["bh"])):
                getattr(cudnn, name).copy_(src)
            lib_out = cudnn(xs, h0[None])[0]
            scan_out = gru_ops.gru_scan(p, xs, h0)[0]
        lib_delta = (lib_out - scan_out).abs().max().item()
        xg = xs.detach().requires_grad_()
        lib_loss = (cudnn(xg, h0[None])[0] * dhs.transpose(0, 1)).sum()
        # cuDNN's data gradient alone: the input and h0 only, the weights
        # not requiring grad (what gru_bwd_kernel computes, with the input
        # projection's backward beside it)
        cudnn_d = torch.nn.GRU(I, H_, batch_first=True).to(dev)
        cudnn_d.load_state_dict(cudnn.state_dict())
        cudnn_d.requires_grad_(False)
        h0g = h0[None].detach().requires_grad_()
        data_loss = (cudnn_d(xg, h0g)[0] * dhs.transpose(0, 1)).sum()
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        scan_loss = (gru_ops.gru_scan(leaves, xg, h0)[0]
                     * dhs.transpose(0, 1)).sum()

        def fwd_bwd(fn, inputs):
            def run():
                torch.autograd.grad((fn() * dhs.transpose(0, 1)).sum(),
                                    inputs)
            return run

        def no_grad(fn):
            def run():
                with torch.no_grad():
                    fn()
            return run

        times = {k: (cuda_ms(a, 50), cuda_ms(b, 5),
                     b4_bound_ms(T, B, H_) if k == "fwd_nores"
                     else b2_bound_ms(k, T, B, H_))
                 for k, (a, b) in kern.items()}
        times["library"] = {
            "cudnn_fwd": cuda_ms(no_grad(lambda: cudnn(xs, h0[None])), 20),
            "cudnn_bwd": cuda_ms(lambda: torch.autograd.grad(
                lib_loss, [xg] + list(cudnn.parameters()),
                retain_graph=True), 20),
            "cudnn_bwd_data": cuda_ms(lambda: torch.autograd.grad(
                data_loss, [xg, h0g], retain_graph=True), 20),
            "cudnn_fwd_bwd": cuda_ms(fwd_bwd(
                lambda: cudnn(xg, h0[None])[0],
                [xg] + list(cudnn.parameters())), 20),
            "scan_fwd": cuda_ms(no_grad(lambda: gru_ops.gru_scan(p, xs, h0)),
                                20),
            "scan_bwd": cuda_ms(lambda: torch.autograd.grad(
                scan_loss, [xg] + list(leaves.values()), retain_graph=True),
                20),
            "scan_fwd_bwd": cuda_ms(fwd_bwd(
                lambda: gru_ops.gru_scan(leaves, xg, h0)[0],
                [xg] + list(leaves.values())), 20),
            "cudnn_vs_scan_delta": lib_delta,
            "wgrad_mm": cuda_ms(lambda: torch.mm(hprev1.T, dgh), 50),
            "wgrad_mm_delta": wgrad_delta}
        return times

    b2_times = {}
    for I, H_ in B2_WIDTHS:
        for B in (32, 1024):
            b2_times[H_, B] = b2_timing(I, H_, B)
    mark("4a B2 timings")

    # ---- 4b. B4: the forward-only scan vs its plain version ---------------
    b4_err = 0.0

    def b4_case(p, gi, h0, reverse, what):
        """B4 against its plain version on one tape: hs and h_T within
        MAX_HS_DELTA. Returns the kernel's (hs, h_T)."""
        nonlocal b4_err
        got = gru_fwd_kernel.gru_fwd(p["wh"], p["bh"], gi, h0, reverse)
        ref = gru_fwd_kernel.gru_fwd_reference(p["wh"], p["bh"], gi, h0,
                                               reverse)
        torch.cuda.synchronize()
        e_hs, e_hT = ((a - b).abs().max().item() for a, b in zip(got, ref))
        b4_err = max(b4_err, e_hs, e_hT)
        if max(e_hs, e_hT) > MAX_HS_DELTA:
            raise AssertionError(f"B4 disagrees with its plain version "
                                 f"({what}): hs {e_hs:.3e}, h_T {e_hT:.3e} "
                                 f"(limit {MAX_HS_DELTA})")
        return got, (e_hs, e_hT)

    for I, H_ in B2_WIDTHS:
        p = gru_ops.init_gru_params(gb, I, H_, dev)
        n4 = max(B4_BATCHES)
        xs = torch.randn((n4, T, I), generator=gb, device=dev)
        h0 = 0.5 * torch.randn((n4, H_), generator=gb, device=dev)
        # the tape as gru_scan hands it over: a time-major view of the
        # batch-major projection; smaller batches are views of its rows
        gi_all = (xs @ p["wi"] + p["bi"]).transpose(0, 1)
        del xs
        for reverse in (False, True):
            outs4, errs4 = {}, {}
            for B in B4_BATCHES:
                outs4[B], errs4[B] = b4_case(p, gi_all[:, :B], h0[:B],
                                             reverse, f"in {I} H {H_} B {B} "
                                             f"reverse {reverse}")
            # every batch against the first rows of the largest: the
            # plans differ (1 to 8 rows per block), the bits must not
            big = max(B4_BATCHES)
            off = [B for B in B4_BATCHES if not all(
                torch.equal(a[:, :B] if a.dim() == 3 else a[:B], b)
                for a, b in zip(outs4[big], outs4[B]))]
            inv = not off
            log(f"[4b] B4 in {I} H {H_} T {T} reverse {reverse}: max "
                f"(|hs delta|, |h_T delta|) per B "
                + ", ".join(f"{B}: {a:.2e} {b:.2e}" for B, (a, b)
                            in errs4.items())
                + f"; B {big}'s first rows == every smaller B bitwise "
                f"{inv}; scan plan at B {big} "
                f"{gru_kernel.launch_plan(big, H_)['scan']}")
            if not inv:
                raise AssertionError(f"B4 is not batch invariant (in {I} H "
                                     f"{H_} reverse {reverse}): B {off} "
                                     f"differ from B {big}'s first rows")
            if not reverse:
                # B2's training forward is the same scan on a contiguous
                # tape, with its residual stores
                hs2, _ = gru_kernel.gru_seq_fwd(p["wh"], p["bh"],
                                                gi_all[:, :32].contiguous(),
                                                h0[:32])
                same = torch.equal(hs2, outs4[32][0])
                log(f"[4b] B2's training forward (with its residual stores) "
                    f"== B4's hs at B 32, bitwise {same}")
                if not same:
                    raise AssertionError("B2's forward and B4 differ on the "
                                         "same tape")
            del outs4
        del gi_all
    for I, H_, B, T_ in B2_SCOPE_CASES:
        p = gru_ops.init_gru_params(gb, I, H_, dev)
        xs = torch.randn((B, T_, I), generator=gb, device=dev)
        h0 = 0.5 * torch.randn((B, H_), generator=gb, device=dev)
        gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1)
        for reverse in (False, True):
            _, (e_hs, e_hT) = b4_case(p, gi, h0, reverse,
                                      f"scope in {I} H {H_} T {T_} B {B}")
            log(f"[4b] B4 scope in {I} H {H_} T {T_} B {B} reverse "
                f"{reverse}: |hs delta| {e_hs:.3e}, |h_T delta| {e_hT:.3e}")
    mark("4b B4 vs plain")

    # ---- 4m. B5: the WAE-MMD kernels vs their plain versions --------------
    b5_err = {"fwd": 0.0, "bwd": 0.0}
    one = torch.ones((), device=dev)

    def b5_case(N, D, form):
        """Value and both gradients against the plain versions on latent-
        like z1 and prior-like z2, each kernel twice (bitwise equal)."""
        z1 = 0.8 * torch.randn((N, D), generator=gb, device=dev) + 0.1
        z2 = torch.randn((N, D), generator=gb, device=dev)
        runs = [(mmd_kernel.mmd_full_fwd(z1, z2, 7.0, form),
                 mmd_kernel.mmd_full_bwd(z1, z2, one, 7.0, form),
                 mmd_kernel.mmd_full_bwd(z2, z1, one, 7.0, form))
                for _ in range(2)]
        ref = (mmd_kernel.mmd_full_reference(z1, z2, 7.0, form),
               mmd_kernel.mmd_full_bwd_reference(z1, z2, 7.0, form),
               mmd_kernel.mmd_full_bwd_reference(z2, z1, 7.0, form))
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
        e_v = abs(runs[0][0].item() - ref[0].item())
        e_g = [rel_err(a, b) for a, b in zip(runs[0][1:], ref[1:])]
        b5_err["fwd"] = max(b5_err["fwd"], e_v)
        b5_err["bwd"] = max(b5_err["bwd"], *(
            (a - b).abs().max().item() for a, b in zip(runs[0][1:], ref[1:])))
        if e_v > MAX_MMD_DELTA or max(e_g) > MAX_MMD_GRAD_REL or not bitwise:
            raise AssertionError(
                f"B5 disagrees with its plain versions (N {N} D {D} {form}): "
                f"value {e_v:.3e} (limit {MAX_MMD_DELTA}), gradients "
                f"{e_g} (limit {MAX_MMD_GRAD_REL} of their max), bitwise "
                f"{bitwise}")
        return f"{N}x{D} {form}: {e_v:.1e} {max(e_g):.1e}"

    def b5_one_row(form):
        """N 1: the value and both gradients divide 0 by N (N - 1) = 0, so
        the kernels must give NaN where the plain versions do."""
        z1 = torch.randn((1, 100), generator=gb, device=dev)
        z2 = torch.randn((1, 100), generator=gb, device=dev)
        got = (mmd_kernel.mmd_full_fwd(z1, z2, 7.0, form),
               mmd_kernel.mmd_full_bwd(z1, z2, one, 7.0, form),
               mmd_kernel.mmd_full_bwd(z2, z1, one, 7.0, form))
        ref = (mmd_kernel.mmd_full_reference(z1, z2, 7.0, form),
               mmd_kernel.mmd_full_bwd_reference(z1, z2, 7.0, form),
               mmd_kernel.mmd_full_bwd_reference(z2, z1, 7.0, form))
        if not all(bool(torch.isnan(a).all()) for a in got + ref):
            raise AssertionError(f"B5 at N 1 ({form}): want NaN value and "
                                 f"gradients as the plain versions give, "
                                 f"got {got[0].item()} and non-NaN gradient "
                                 f"entries")
        return "1x100 NaN as plain"

    for form in B5_FORMS:
        res = [b5_case(N, 100, form) for N in B5_NS]
        res += [b5_case(N, D, form) for N, D in B5_EDGES]
        res.append(b5_one_row(form))
        log(f"[4m] B5 {form} (N x D: |value delta|, max gradient error of "
            f"its max), every case bitwise repeatable: " + "; ".join(res))
    mark("4m B5 vs plain")

    # the value is one launch whose last block resets the completion
    # counter: calls at interleaved N (one block and many) give each N's
    # bits every time, and a call puts one kernel and no memset on the card
    pairs = {N: (0.8 * torch.randn((N, 100), generator=gb, device=dev) + 0.1,
                 torch.randn((N, 100), generator=gb, device=dev))
             for N in B5_LOOP_NS}
    vals = {N: [] for N in B5_LOOP_NS}
    for _ in range(B5_LOOP_CALLS // len(B5_LOOP_NS)):
        for N, (z1, z2) in pairs.items():
            vals[N].append(mmd_kernel.mmd_full_fwd(z1, z2, 7.0))
    vals = {N: torch.stack(v) for N, v in vals.items()}
    loop_same = all(bool((v == v[0]).all()) for v in vals.values())
    loop_err = max(abs(vals[N][0].item() - mmd_kernel.mmd_full_reference(
        *pairs[N], 7.0).item()) for N in B5_LOOP_NS)
    # one call captured in a CUDA graph (its stream's counter made first):
    # the graph must hold one kernel node and no memset or copy, and its
    # replays must give the eager value's bits and leave the counter at 0
    big = [torch.randn((4096, 100), generator=gb, device=dev)
           for _ in range(2)]
    graph_lines, graph_ok = [], True
    for z1, z2 in (pairs[32], big):
        want = mmd_kernel.mmd_full_fwd(z1, z2, 7.0)
        side = torch.cuda.Stream(z1.device)
        count = mmd_kernel._counter(z1.device, side.cuda_stream)
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=side):
            got = mmd_kernel.mmd_full_fwd(z1, z2, 7.0)
        kinds = runtime.graph_node_kinds(graph.raw_cuda_graph())
        graph.instantiate()
        replays = []
        for _ in range(10):
            graph.replay()
            replays.append(got.clone())
        torch.cuda.synchronize()
        same = all(torch.equal(r, want) for r in replays)
        graph_ok &= (kinds == ["kernel"] and same and count.item() == 0)
        graph_lines.append(f"N {z1.shape[0]}: graph nodes {kinds}, 10 "
                           f"replays == the eager value bitwise {same}, "
                           f"counter after {count.item()}")
    log(f"[4m] B5 value, {sum(len(v) for v in vals.values())} calls "
        f"interleaving N {B5_LOOP_NS}: each N's values bitwise equal call to "
        f"call {loop_same}, max |delta| against the plain version "
        f"{loop_err:.3e}; one call captured in a CUDA graph: "
        + "; ".join(graph_lines))
    if not loop_same or loop_err > MAX_MMD_DELTA or not graph_ok:
        raise AssertionError(f"B5's one-launch value: bitwise {loop_same}, "
                             f"error {loop_err:.3e}, graphs {graph_lines} "
                             f"(want one kernel node a call)")
    mark("4m-b B5 value: counter loop, one launch")

    # ---- 5. main path: the CLaSS round ------------------------------------
    rng = np.random.default_rng(4)
    states = {}
    for split, n in (("train", 5000), ("test", 1000)):
        mu = 0.5 * rng.standard_normal((n, model.z_dim))
        label = -np.ones((n, 6), np.int64)
        label[:, 0] = mu[:, 0] + 0.25 * rng.standard_normal(n) > 0
        label[:, 1] = mu[:, 1] + 0.25 * rng.standard_normal(n) > 0
        states[split] = {"mu": mu.astype(np.float16),
                         "logvar": np.full((n, model.z_dim), -1.5,
                                           np.float16),
                         "label": label}

    def class_runs(tag, run_flags, model_, params_, counter,
                   attr="launches"):
        """pipeline.run_from_states in both decode modes; each run drives
        the main path with the kernel's count (``counter.<attr>``, the
        entry's) set to 0 just before it and read just after. Returns
        (launches, loop stats, the last cfg)."""
        launches_, loop_ = {}, {}
        for mode in ("all", "accepted"):
            cfg_, args_, _ = C.parse_and_finalize(
                run_flags + ["--hw.decode_mode", mode, "--Q_n_components",
                             "100", "--Q_covariance_type", "diag",
                             "--n_samples_per_round", "5000",
                             "--n_samples_acc", "100",
                             "--samples_outfn_prefix", f"smoke_{mode}"],
                extra_args=sample_pipeline.EXTRA_ARGS)
            setattr(counter, attr, 0)
            stem, samples, stats = pipeline.run_from_states(
                cfg_, args_, model_, params_, vocab, states, device=dev)
            n_launches = getattr(counter, attr)
            if n_launches < 1:
                raise AssertionError(f"{tag} {mode} run: the main path "
                                     f"never launched the beam kernel")
            peps = samples["peptide"]
            acc = np.asarray(samples["accept"], bool)
            n_acc_unique = len({p for p, a in zip(peps, acc) if a})
            if n_acc_unique < 100 or len(set(peps)) != len(peps):
                raise AssertionError(f"{tag} {mode} run: {n_acc_unique} "
                                     f"unique accepted samples (need 100)")
            for ext in (".plain.txt", ".csv", ".pkl"):
                if not os.path.exists(stem + ext):
                    raise AssertionError(f"missing {stem + ext}")
            cols = [np.asarray(samples[k], np.float64) for k in samples
                    if k not in ("peptide", "accept_z", "accept")]
            if (samples["z"].shape != (len(peps), model_.z_dim)
                    or not all(np.isfinite(c).all() for c in cols)
                    or not set("".join(peps).replace(" ", "")) <= set(
                        vocab.itos[4:])):
                raise AssertionError(f"{tag} {mode} run: malformed sample "
                                     f"columns")
            log(f"[5] {tag} decode_mode={mode}: {stats['rounds']} "
                f"round(s) consumed, "
                f"{stats['rounds_launched']} launched, {stats['candidates']} "
                f"candidates, {stats['accepted_z']} accepted by the test, "
                f"{n_acc_unique} unique accepted kept, kernel launches "
                f"{n_launches}, beam canary passed, loop "
                f"{stats['seconds']:.4f}s, files {stem}.*")
            launches_[mode], loop_[mode] = n_launches, stats
            mark(f"5 {tag} {mode} run")
        return launches_, loop_, cfg_

    def round_checks(tag, cfg_, model_, params_, decode_dtype="float32",
                     timed=True):
        """One round through the kernel and one with plain=True on the same
        draws (identical accept masks, >= 99% identical token rows; a bf16
        decode: gates (c) and (d)), then, when ``timed``, host-clock round
        times per decode mode (quartiles of ROUND_REPS)."""
        bf16 = decode_dtype == "bfloat16" or (
            model_.G_class == "transformer"
            and model_.dec_tfm_args.get("bf16", False))
        Q = pipeline.fitQ_and_test(
            cfg_, pipeline.resolve_QClass("mogQ"),
            {"n_components": 100, "z_num_samples": 10,
             "covariance_type": "diag"}, states, device=dev)[0]
        Q.init_attr_classifiers(
            {a: pipeline.build_clfZ(cfg_, a, states, device=dev)
             for a in ("amp", "tox")}, {"amp": 1, "tox": 0})
        draws = fused.round_draws(pipeline.round_generator(cfg_.seed, 1, dev),
                                  Q._sampler()[1], 5000)
        one_ = dp_rounds.shards_of(params_)
        r_kernel = fused.fused_round(model_, one_, draws, Q,
                                     decode_dtype=decode_dtype)
        r_plain = fused.fused_round(model_, one_, draws, Q, plain=True,
                                    decode_dtype=decode_dtype)
        if not torch.equal(r_kernel[2], r_plain[2]):
            raise AssertionError(f"{tag}: accept masks differ between the "
                                 f"routes")
        rows_same = (r_kernel[3] == r_plain[3]).all(dim=1).float().mean(
            ).item()
        need = BF16_T25_SAME_ROWS if bf16 else MIN_SAME_ROWS
        rec_note = ""
        if bf16:
            # gate (c) on the round's decode: its latents through the
            # kernel again give its tokens and their scores
            p_dec = (params_ if decode_dtype == "float32"
                     else nn.cast_tree(params_, getattr(torch, decode_dtype)))
            ins, dims = decode_inputs(
                model_, p_dec, model_.apply_flow(params_, r_kernel[0])[0],
                model_.c_from_bits(draws.cbit))
            scan = (tfm_beam_kernel.beam_scan_tfm
                    if model_.G_class == "transformer"
                    else beam_kernel.beam_scan_gru)
            tapes = scan(*ins, T=T, K=5, V=V, min_length=1, n_best=1, **dims)
            if not torch.equal(beam.hyps_from_tapes(tapes, 1)[0][:, 0],
                               r_kernel[3]):
                raise AssertionError(f"{tag}: the round's tokens differ "
                                     f"from its latents' decode")
            rec_note = (f", max |top-1 score - teacher-forced recompute| "
                        f"{recompute_gate(ins, dims, tapes, T, tag):.4f}")
        log(f"[5] {tag} same draws, kernel vs plain version: accept masks "
            f"identical, token rows identical {rows_same:.6f}{rec_note}")
        if rows_same < need:
            raise AssertionError(f"{tag}: only {rows_same:.4f} token rows "
                                 f"identical (need {need})")
        mark(f"5 {tag} kernel vs plain round")
        if not timed:
            return None
        round_ms_ = {}
        for mode, cap in (("all", None), ("accepted", 2500)):
            def one_round():
                d = fused.round_draws(
                    pipeline.round_generator(cfg_.seed, 2, dev),
                    Q._sampler()[1], 5000)
                out = fused.fused_round(model_, one_, d, Q, capacity=cap,
                                        decode_dtype=decode_dtype)
                torch.cuda.synchronize()
                return out
            one_round()
            ts = []
            for _ in range(ROUND_REPS):
                t0 = time.perf_counter()
                one_round()
                ts.append(1e3 * (time.perf_counter() - t0))
            round_ms_[mode] = statistics.quantiles(ts, n=4)   # q1, med, q3
        mark(f"5 {tag} round timings")
        return round_ms_

    launches, loop, cfg = class_runs("GRU", flags, model, params,
                                     beam_kernel.beam_scan_gru)
    round_ms = round_checks("GRU", cfg, model, params)

    # ---- 5t. main path: the transformer family's CLaSS round -------------
    launches_t, loop_t, cfg_t5 = class_runs(
        "transformer", tflags_t, model_t3, params_t3,
        tfm_beam_kernel.beam_scan_tfm)
    round_ms_t = round_checks("transformer", cfg_t5, model_t3, params_t3)

    # ---- 5-bf16, 5t-bf16: the CLaSS main path decoded in bf16 --------------
    # --hw.gen_dtype bfloat16 for both families, and the transformer with
    # T_args.bf16 over its f32 weights; the bf16 entries' counts must rise
    bf16_runs = {}
    for tag, run_flags, model_, params_, counter, dtype in (
            ("GRU bf16", flags + ["--hw.gen_dtype", "bfloat16"], model,
             params, beam_kernel.beam_scan_gru, "bfloat16"),
            ("transformer bf16", tflags_t + ["--hw.gen_dtype", "bfloat16"],
             model_t3, params_t3, tfm_beam_kernel.beam_scan_tfm, "bfloat16"),
            ("transformer T_args.bf16",
             tflags_t + ["--model.G_args.T_args.bf16", "1"], model_tb,
             params_t3, tfm_beam_kernel.beam_scan_tfm, "float32")):
        launches_b, loop_b, cfg_b = class_runs(tag, run_flags, model_,
                                               params_, counter,
                                               "launches_bf16")
        bf16_runs[tag] = (launches_b, loop_b,
                          round_checks(tag, cfg_b, model_, params_, dtype))

    # ---- 6. main path: phase-1 training ------------------------------------
    train_top = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(train_top, ignore_errors=True)

    def train_flags(runname, n_iter, extra=()):
        return ["--phase", "1", "--dataset", "amp", "--datapath",
                os.path.join(ROOT, "data"), "--savepath_toplevel", train_top,
                "--tb_toplevel", os.path.join(train_top, "tb"), "--runname",
                runname, "--seed", "1238", "--vae.n_iter", str(n_iter),
                "--vae.cheaplog_every", "100", "--vae.expsvlog_every",
                "150"] + list(extra)

    reset_counts, counts = reset_train_counts, train_counts

    chunk_log = ChunkLog()
    for trainer in (train_vae, train_full):
        trainer.log.addHandler(chunk_log)
        trainer.log.setLevel("INFO")

    def train_run(tag, flags_):
        """main.main on the flags, the kernels' counts set to 0 just before
        and read just after. Returns (cfg, counts, seconds, chunks), chunks
        (replays, steps a replay, kernel nodes of the graph) or None when
        every step ran eagerly."""
        reset_counts()
        chunk_log.last = chunk_log.stats = None
        t0 = time.perf_counter()
        cfg_ = train_main.main(flags_)
        return cfg_, counts(), time.perf_counter() - t0, chunk_log.last

    def check_train_outputs(tag, tcfg_, n_steps_):
        """Finite logged losses with recon falling, every checkpoint
        reloading with its Adam moments (count it + 1, nonzero nu),
        vae_gen.txt over the vocab. Returns (result rows, recon at the
        logs, checkpoint iterations, sample lines, model, last params)."""
        with open(os.path.join(tcfg_.savepath, "result.json")) as fh:
            rows_ = json.load(fh)
        logged = [r for r in rows_ if "train_L_vae_recon" in r]
        bad = [(r["it"], k) for r in logged for k, v in r.items()
               if k.startswith("train_") and not np.isfinite(v)]
        recon_ = [r["train_L_vae_recon"] for r in logged]
        if bad or not recon_ or recon_[-1] >= recon_[0]:
            raise AssertionError(f"{tag} training losses: non-finite {bad}, "
                                 f"recon at the logs {recon_}")
        model_ = build_model(tcfg_.model, V, tcfg_.max_seq_len)
        template = model_.init_params(
            torch.Generator(device=dev).manual_seed(0), dev)
        adam = train_opt.make_optimizer(tcfg_.vae)
        ckpts_ = [it for it in range(1, n_steps_)
                  if it % tcfg_.vae.expsvlog_every == 0]
        params_ = None
        for it in ckpts_:
            params_, state = checkpoints.load_train_state(
                tcfg_.vae.chkpt_path.format(it), template,
                adam.init(template), dev)
            empty = [checkpoints.keystr(k) for k, v in
                     checkpoints.flatten(state["nu"]).items()
                     if not v.abs().sum() > 0]
            if int(state["count"]) != it + 1 or empty:
                raise AssertionError(f"{tag} model_{it}.npz: Adam count "
                                     f"{int(state['count'])}, moments empty "
                                     f"for {empty}")
        with open(tcfg_.vae.gen_samples_path) as fh:
            lines = fh.read().splitlines()
        if (len(lines) != tcfg_.evals.sample_size
                or not set(" ".join(lines).split()) <= set(vocab.itos[4:])):
            raise AssertionError(f"{tcfg_.vae.gen_samples_path}: "
                                 f"{len(lines)} lines (want "
                                 f"{tcfg_.evals.sample_size}) or tokens "
                                 f"outside the vocab")
        return rows_, recon_, ckpts_, lines, model_, params_

    def step_vs_plain(tag, model_, tcfg_, params_):
        """One step from the same params, batch and draws through the
        kernels and inside cuda_build.plain() (every kernel of the step as
        its plain version): loss rtol 1e-5, each gradient within
        MAX_GRAD_REL of its tensor's largest entry. A deconv decoder's
        gradient is held to MAX_GRAD_REL of the larger of its largest
        entry and DECONV_GRAD_FLOOR of the tree's largest gradient: the
        exact gradient of its biases ahead of a batch norm is 0 (the norm
        takes the batch mean out), and bn_out's scale's nearly so (relu,
        the final conv and its norm are invariant to it while bn_out's
        bias is 0), so there both routes give the rounding noise of
        cuDNN's backward, which sums in no fixed order."""
        for leaf in checkpoints.flatten(params_).values():
            leaf.requires_grad_(True)
        batch = torch.from_numpy(train_main.load_dataset(tcfg_).next_batch(
            "train_vae").text).to(dev)
        draws = train_vae.draw_step(
            model_, runtime.generator(dev, tcfg_.seed, 10 ** 6),
            batch.shape[0], tcfg_.max_seq_len, dev)
        rf = losses.init_rf_basis(runtime.generator(dev, tcfg_.seed, 7),
                                  model_.z_dim, tcfg_.losses.wae_mmd.rf_dim,
                                  dev)
        loss_fn = train_vae.make_loss_fn(model_, tcfg_.vae,
                                         tcfg_.losses.wae_mmd, rf)
        res = [train_vae.loss_and_grads(loss_fn, params_, batch, 1.5, draws)]
        with cuda_build.plain():
            res.append(train_vae.loss_and_grads(loss_fn, params_, batch, 1.5,
                                                draws))
        loss_rel = abs(res[0][0].item() - res[1][0].item()) / abs(
            res[1][0].item())
        mmd_delta = abs(res[0][1]["L_wae_mmd"].item()
                        - res[1][1]["L_wae_mmd"].item())
        g_k = checkpoints.flatten(res[0][2])
        g_p = checkpoints.flatten(res[1][2])
        floor = DECONV_GRAD_FLOOR * max(g.abs().max().item()
                                        for g in g_p.values())
        g_errs = {checkpoints.keystr(k): (
            (g_k[k] - g_p[k]).abs().max().item()
            / max(g_p[k].abs().max().item(), floor)
            if model_.G_class == "deconv" and k[0] == "dec"
            else rel_err(g_k[k], g_p[k])) for k in g_k}
        worst = max(g_errs, key=g_errs.get)
        log(f"[6] {tag}: one train step, kernels vs cuda_build.plain() on "
            f"the same params, batch and draws: loss {res[0][0].item():.6f} "
            f"vs {res[1][0].item():.6f} (rel {loss_rel:.3e}), L_wae_mmd "
            f"|delta| {mmd_delta:.3e}; largest gradient error "
            f"{g_errs[worst]:.3e} of the tensor's max ({worst})")
        if (loss_rel > 1e-5 or mmd_delta > MAX_MMD_DELTA
                or g_errs[worst] > MAX_GRAD_REL):
            raise AssertionError(f"{tag}: the train step disagrees between "
                                 f"the kernels and cuda_build.plain()")
        for leaf in checkpoints.flatten(params_).values():
            leaf.requires_grad_(False)

    n_steps = TRAIN_ITERS + 1
    # the default --hw.unroll 50 at cadences 100 / 150: step 0 alone, steps
    # 1-300 as six replays of a 50-step graph
    want_chunks = (TRAIN_ITERS // 50, 50)
    tcfg, train_launches, train_s, chunks = train_run(
        "GRU", train_flags("smoke", TRAIN_ITERS))
    rows, recon, ckpts, gen_lines, model_t, tparams = check_train_outputs(
        "GRU", tcfg, n_steps)
    # three recurrences per step through B2; the heldout eval at each
    # checkpoint runs its three scans without autograd, through B4, on each
    # of its 4 batches; the MMD once per step through B5 (its backward
    # only when it regularizes)
    want = {"B2 fwd": 3 * n_steps, "B2 bwd": 3 * n_steps,
            "B2 wgrad": 3 * n_steps, "B4": 3 * 4 * len(ckpts),
            "B5 fwd": n_steps, "B5 bwd": 0}
    if train_launches != want or chunks is None or chunks[:2] != want_chunks:
        raise AssertionError(f"GRU training launched the kernels "
                             f"{train_launches} times, expected {want}; "
                             f"chunks {chunks}, expected {want_chunks}")
    log(f"[6] phase-1 training, {n_steps} steps at batch "
        f"{tcfg.vae.batch_size} (emb {tcfg.model.emb_dim}, encoder H "
        f"{tcfg.model.E_args.h_dim}, z {tcfg.model.z_dim}, decoder H "
        f"{model_t.h_dec}, V {V}, T {tcfg.max_seq_len}): {train_s:.2f} s in "
        f"main.main; {chunks[0]} replays of a {chunks[1]}-step CUDA graph "
        f"of {chunks[2]} kernel nodes; launches {train_launches} (want "
        f"{want}, counted through the replays); recon at the "
        f"logs {[round(r, 4) for r in recon]}; checkpoints {ckpts} reload "
        f"with Adam count it+1 and nonzero moments; {len(gen_lines)} "
        f"samples in vae_gen.txt; heldout "
        f"{[(r['it'], r['hld_recon']) for r in rows if 'hld_recon' in r]}")
    mark("6a phase-1 training (main.main) and its checks")
    step_vs_plain("GRU", model_t, tcfg, tparams)
    mark("6b one step, kernels vs plain")

    # the short run whose MMD regularizes: B5's backward on the card
    mcfg, mmd_launches, mmd_s, mmd_chunks = train_run("GRU mmd", train_flags(
        "smoke_mmd", MMD_ITERS, ["--vae.z_regu_loss", "mmd",
                                 "--vae.cheaplog_every", "10",
                                 "--vae.expsvlog_every", "1000"]))
    with open(os.path.join(mcfg.savepath, "result.json")) as fh:
        m_loss = [r["train_L_vae"] for r in json.load(fh)
                  if "train_L_vae" in r]
    want_m = MMD_ITERS + 1
    # cadences 10 / 1000: chunks of 10
    if (mmd_launches["B5 fwd"] != want_m or mmd_launches["B5 bwd"] != want_m
            or mmd_chunks is None or mmd_chunks[:2] != (MMD_ITERS // 10, 10)
            or not all(np.isfinite(m_loss)) or m_loss[-1] >= m_loss[0]):
        raise AssertionError(f"the mmd run: launches {mmd_launches} (want "
                             f"B5 fwd and bwd {want_m}), chunks "
                             f"{mmd_chunks}, L_vae at the logs {m_loss}")
    log(f"[6] --vae.z_regu_loss mmd, {want_m} steps: {mmd_s:.2f} s; "
        f"{mmd_chunks[0]} replays of a {mmd_chunks[1]}-step CUDA graph of "
        f"{mmd_chunks[2]} kernel nodes; launches {mmd_launches}; L_vae at "
        f"the logs "
        f"{[round(v, 4) for v in m_loss]}")
    mark("6c mmd run (B5 backward)")

    # ---- 6t. main path: phase-1 training of the transformer family --------
    tcfg_t, tfm_launches, tfm_s, tfm_chunks = train_run(
        "transformer", train_flags("smoke_tfm", TRAIN_ITERS, TFM_FLAGS))
    rows_t, recon_t, ckpts_t, gen_t, model_t6, tparams_t = (
        check_train_outputs("transformer", tcfg_t, n_steps))
    want_t = dict.fromkeys(want, 0)
    want_t["B5 fwd"] = n_steps
    if tfm_launches != want_t or tfm_chunks is None or (
            tfm_chunks[:2] != want_chunks):
        raise AssertionError(f"transformer training launched the kernels "
                             f"{tfm_launches} times, expected {want_t}; "
                             f"chunks {tfm_chunks}, expected {want_chunks}")
    t_args = tcfg_t.model.G_args.T_args
    log(f"[6t] transformer phase-1 training, {n_steps} steps at batch "
        f"{tcfg_t.vae.batch_size} (d_model {t_args.d_model}, "
        f"{t_args.n_layers} layers, d_ff {t_args.d_ff}, {t_args.n_heads} "
        f"heads, emb {tcfg_t.model.emb_dim}, z {tcfg_t.model.z_dim}, V {V}, "
        f"T {tcfg_t.max_seq_len}): {tfm_s:.2f} s in main.main; "
        f"{tfm_chunks[0]} replays of a {tfm_chunks[1]}-step CUDA graph of "
        f"{tfm_chunks[2]} kernel nodes; launches {tfm_launches} (want "
        f"{want_t}); recon at the logs "
        f"{[round(r, 4) for r in recon_t]}; checkpoints {ckpts_t} reload "
        f"with Adam count it+1 and nonzero moments; {len(gen_t)} samples "
        f"in vae_gen.txt; heldout "
        f"{[(r['it'], r['hld_recon']) for r in rows_t if 'hld_recon' in r]}")
    mark("6t-a transformer training (main.main) and its checks")
    step_vs_plain("transformer", model_t6, tcfg_t, tparams_t)
    mark("6t-b one transformer step, kernels vs plain")

    # ---- 6p, 6u: the chunked steps against the per-step path -------------
    def logged(cfg_):
        with open(os.path.join(cfg_.savepath, "result.json")) as fh:
            return {r["it"]: {k: v for k, v in r.items()
                              if k.startswith("train_")
                              and "steps_per_sec" not in k}
                    for r in json.load(fh)}

    def same_run(tag, cfg_a, cfg_b, it, want_a):
        """The checkpoints at ``it`` within MAX_UNROLL_REL of each array's
        largest entry; the logged losses within rtol 1e-5."""
        rel, key, bitwise = state_delta(cfg_a.vae.chkpt_path.format(it),
                                        cfg_b.vae.chkpt_path.format(it))
        rows_a, rows_b = logged(cfg_a), logged(cfg_b)
        loss_rel = max(abs(rows_a[i][k] - v) / max(abs(v), 1e-30)
                       for i, r in rows_b.items() for k, v in r.items())
        if (rel > MAX_UNROLL_REL or set(rows_a) != set(rows_b)
                or loss_rel > 1e-5):
            raise AssertionError(f"{tag}: unroll {want_a} against unroll 1: "
                                 f"model_{it}.npz {key} apart by {rel:.3e} "
                                 f"of its largest entry, logged losses by "
                                 f"{loss_rel:.3e}")
        return rel, key, bitwise, loss_rel

    # 6p: both families' 301 steps at --hw.unroll 1, the yardstick of [7]'s
    # steps/s, against phase 6's chunked runs
    unroll1_runs = {}
    for tag, runname, extra, cfg_c, launches_c in (
            ("GRU", "smoke_u1", (), tcfg, train_launches),
            ("transformer", "smoke_tfm_u1", TFM_FLAGS, tcfg_t, tfm_launches)):
        cfg_1, launches_1, secs_1, chunks_1 = train_run(
            f"{tag} unroll 1", train_flags(runname, TRAIN_ITERS, list(extra)
                                           + ["--hw.unroll", "1"]))
        if chunks_1 is not None or launches_1 != launches_c:
            raise AssertionError(f"{tag} --hw.unroll 1: chunks {chunks_1}, "
                                 f"launches {launches_1} (want {launches_c})")
        unroll1_runs[tag] = (cfg_1, secs_1, same_run(
            f"{tag} 6p", cfg_c, cfg_1, TRAIN_ITERS, 50))
        rel, key, bitwise, loss_rel = unroll1_runs[tag][2]
        log(f"[6p] {tag} 301 steps at --hw.unroll 1: {secs_1:.2f} s in "
            f"main.main, launches {launches_1}; model_{TRAIN_ITERS}.npz "
            f"against phase 6's unroll 50: largest difference {rel:.3e} of "
            f"the array's largest entry ({key}), bitwise "
            f"{'equal' if bitwise else 'different'}; logged losses within "
            f"{loss_rel:.3e}")
    mark("6p per-step runs (unroll 1) of both families")

    # 6u: 51 steps at cadences 25 / 50 (chunks of 25) against unroll 1
    for tag, extra in (("GRU", ()), ("transformer", TFM_FLAGS)):
        runs_u = {}
        for unroll in (None, 1):
            name = f"u{unroll or 'd'}_{tag[:3]}"
            flags_u = train_flags(name, UNROLL_ITERS, list(extra) + [
                "--vae.cheaplog_every", "25", "--vae.expsvlog_every", "50"]
                + (["--hw.unroll", "1"] if unroll else []))
            runs_u[unroll] = train_run(f"{tag} 6u", flags_u)
        chunks_u = runs_u[None][3]
        if chunks_u is None or chunks_u[:2] != (2, 25) or (
                runs_u[1][3] is not None) or runs_u[None][1] != runs_u[1][1]:
            raise AssertionError(f"6u {tag}: chunks {chunks_u}, launches "
                                 f"{runs_u[None][1]} against "
                                 f"{runs_u[1][1]}")
        rel, key, bitwise, loss_rel = same_run(
            f"{tag} 6u", runs_u[None][0], runs_u[1][0], UNROLL_ITERS, 25)
        log(f"[6u] {tag} {UNROLL_ITERS + 1} steps, default --hw.unroll "
            f"({chunks_u[0]} replays of a {chunks_u[1]}-step graph of "
            f"{chunks_u[2]} kernel nodes) against --hw.unroll 1: "
            f"model_{UNROLL_ITERS}.npz largest difference {rel:.3e} of the "
            f"array's largest entry ({key}), bitwise "
            f"{'equal' if bitwise else 'different'}; logged losses within "
            f"{loss_rel:.3e}; launches {runs_u[None][1]}")
    mark("6u unroll 25 against unroll 1, both families")

    # the flat-vector Adam (--hw.flat_optimizer on) through the chunks
    fcfg, f_launches, f_s, f_chunks = train_run("GRU flat", train_flags(
        "smoke_flat", UNROLL_ITERS, ["--hw.flat_optimizer", "on",
                                     "--vae.cheaplog_every", "25",
                                     "--vae.expsvlog_every", "50"]))
    f_rows = logged(fcfg)
    f_recon = [r["train_L_vae_recon"] for _, r in sorted(f_rows.items())
               if "train_L_vae_recon" in r]
    f_bad = [(i, k) for i, r in f_rows.items() for k, v in r.items()
             if not np.isfinite(v)]
    model_f = build_model(fcfg.model, V, fcfg.max_seq_len)
    tmpl_f = model_f.init_params(torch.Generator(device=dev).manual_seed(0),
                                 dev)
    flat_adam = train_opt.make_optimizer(fcfg.vae, flat=True)
    fparams, fstate = checkpoints.load_train_state(
        fcfg.vae.chkpt_path.format(UNROLL_ITERS), tmpl_f,
        flat_adam.init(tmpl_f), dev)
    # the file's m and v run over the JAX train state's leaves, the
    # classifier's included (zeros there), as the JAX package resumes them
    with np.load(fcfg.vae.chkpt_path.format(UNROLL_ITERS)) as data:
        m_file = data["['opt'].m"]
    n_own = sum(v.numel() for v in checkpoints.flatten(tmpl_f).values())
    n_clf = sum(int(np.prod(sh)) for sh in checkpoints.classifier_shapes(
        fcfg.model.emb_dim, **fcfg.model.C_args).values())
    if m_file.shape != (n_own + n_clf,) or np.any(m_file[:n_clf]):
        raise AssertionError(f"the flat checkpoint's m has shape "
                             f"{m_file.shape} (want {n_own} + {n_clf}) or "
                             f"nonzero classifier segments")
    if (f_bad or len(f_recon) < 2 or f_recon[-1] >= f_recon[0]
            or int(fstate["count"]) != UNROLL_ITERS + 1
            or not float(fstate["v"].abs().sum()) > 0
            or f_chunks is None or f_chunks[:2] != (2, 25)):
        raise AssertionError(f"the flat-Adam run: non-finite {f_bad}, recon "
                             f"{f_recon}, count {int(fstate['count'])}, "
                             f"chunks {f_chunks}")
    # two updates from the same params and grads (the first clipped),
    # flat against per-leaf
    leaf_adam = train_opt.make_optimizer(fcfg.vae)
    p_leaf = {k: v.clone() for k, v in checkpoints.flatten(fparams).items()}
    p_leaf = checkpoints.unflatten(p_leaf)
    s_leaf, s_flat = leaf_adam.init(p_leaf), flat_adam.init(fparams)
    g_gen = torch.Generator(device=dev).manual_seed(5)
    norms, upd_err = [], 0.0
    for scale in (1.0, 1e-3):
        grads = checkpoints.unflatten({
            k: scale * torch.randn(v.shape, generator=g_gen, device=dev)
            for k, v in checkpoints.flatten(fparams).items()})
        norms.append(float(leaf_adam.step(p_leaf, grads, s_leaf)))
        flat_adam.step(fparams, grads, s_flat)
        a_f, b_f = checkpoints.flatten(fparams), checkpoints.flatten(p_leaf)
        upd_err = max(upd_err, max(rel_err(a_f[k], b_f[k]) for k in b_f))
    m_leaf = torch.cat([checkpoints.flatten(s_leaf["mu"])[k].reshape(-1)
                        for k in checkpoints.ravel_order(p_leaf)])
    m_err = rel_err(s_flat["m"], m_leaf)
    if not (norms[0] > fcfg.vae.clip_grad > norms[1]) or (
            upd_err > 1e-5 or m_err > 1e-5):
        raise AssertionError(f"flat against per-leaf Adam: norms {norms}, "
                             f"params rel {upd_err:.3e}, m rel {m_err:.3e}")
    log(f"[6f] --hw.flat_optimizer on, {UNROLL_ITERS + 1} steps: {f_s:.2f} s "
        f"in main.main, {f_chunks[0]} replays of a {f_chunks[1]}-step graph "
        f"of {f_chunks[2]} kernel nodes; recon at the logs "
        f"{[round(r, 4) for r in f_recon]}; model_{UNROLL_ITERS}.npz "
        f"reloads with count {int(fstate['count'])} and nonzero v; two "
        f"updates from the same params and grads (global norms "
        f"{norms[0]:.3f}, {norms[1]:.3e}), flat against per-leaf: params "
        f"within {upd_err:.3e} of each tensor's largest entry, m within "
        f"{m_err:.3e}; launches "
        f"{f_launches}")
    mark("6f flat-vector Adam run")

    # ---- 6e. main path: the static eval of the phase-6 runs ----------------
    # static_eval --long writes the states dump and the latent index that
    # sample_pipeline reads (5d, 5d-bf16), then prints its battery
    def static_eval_run(tag, flags_):
        """static_eval.main on the flags, its printed battery into
        chiprun_out/, the counts set to 0 just before and read just after.
        Returns (summary, counts, seconds)."""
        reset_counts()
        beam_kernel.beam_scan_gru.launches = 0
        tfm_beam_kernel.beam_scan_tfm.launches = 0
        beam.beam_search.plain_runs = 0
        out_path = os.path.join(ROOT, "chiprun_out", f"static_eval_{tag}.txt")
        fig_log = FigureLog()
        static_eval.LOG.addHandler(fig_log)
        static_eval.LOG.setLevel("INFO")
        t0 = time.perf_counter()
        try:
            with open(out_path, "w") as fh, contextlib.redirect_stdout(fh):
                summary_ = static_eval.main(flags_ + ["--long", "--device",
                                                      "cuda"])
        finally:
            static_eval.LOG.removeHandler(fig_log)
        seconds_ = time.perf_counter() - t0
        counts_ = dict(counts(), **{
            "B1": beam_kernel.beam_scan_gru.launches,
            "B3": tfm_beam_kernel.beam_scan_tfm.launches,
            "plain beam": beam.beam_search.plain_runs})
        with open(out_path) as fh:
            text = fh.read()
        if "#### reco of" not in text or " - hyp 2: " not in text:
            raise AssertionError(f"static_eval {tag}: the battery printed no "
                                 f"reconstruction or hypotheses ({out_path})")
        # the diagnostics: their artifacts under the JAX package's names,
        # finite numbers, each figure drawn or named as not drawn
        stem_ = summary_["states"]["train"][:-3]
        missing = [stem_ + x for x in ("_latent_discriminator.json",
                                       "_frob_dist.txt", "_kde.txt")
                   if not os.path.exists(stem_ + x)]
        aucs = [v for e in summary_["discriminator"].values()
                for k, v in e.items() if k.endswith("_auc")]
        figs = [f"_tsne_{a}.png" for a, _ in attributes] + [
            f"_{t}{x}" for t in ("pos", "unl") for x in (
                "_q_phi_z.png", "_covar_diag.png", "_covar_offdiag.png")] + [
            f"_kde_{k}.png" for k in summary_["kde"]]
        unnamed = [f for f in figs if not os.path.exists(stem_ + f)
                   and not any(os.path.basename(stem_ + f) in line
                               for line in fig_log.lines)]
        if (missing or unnamed or not aucs or len(fig_log.lines) > 3
                or not np.isfinite(aucs + [summary_["frob_pos"],
                                           summary_["frob_unl"]]
                                   + list(summary_["kde"].values())).all()):
            raise AssertionError(f"static_eval {tag} --long's diagnostics: "
                                 f"missing {missing}, figures neither drawn "
                                 f"nor named {unnamed}, discriminator "
                                 f"{summary_['discriminator']}")
        return summary_, counts_, seconds_, len(figs), len(fig_log.lines)

    def diag_line(summary_):
        """The seconds per diagnostic of a --long run and its numbers."""
        sec = summary_["seconds"]
        aucs = {f"{a}.{k}": round(v, 4) for a, e in
                summary_["discriminator"].items() for k, v in e.items()
                if k.endswith("_auc")}
        return (f"t-SNE + discriminators {sec['tsne']:.3f} s, covar "
                f"{sec['covar']:.3f} s, kde {sec['kde']:.3f} s (host clock); "
                f"AUCs {aucs}; Frobenius pos {summary_['frob_pos']:.4f}, unl "
                f"{summary_['frob_unl']:.4f}; kde non-zero fractions "
                f"{ {k: round(v, 4) for k, v in summary_['kde'].items()} }")

    # what the battery runs (static_eval.py): 18 encodes of one sequence
    # (3 interpolations x 2, 5 reconstructions a sequence, 2 for the
    # reconstruction interpolation), B4 twice each; 4 beam-5 decodes in the
    # kernel (prior samples, prior interpolation, a reconstruction a
    # sequence); 3 beam-15 decodes (T*K 375, outside the kernels' scope) in
    # the plain beam (a reconstruction a sequence, the interpolation)
    n_seqs = len(static_eval.DEFAULT_SEQS.split(","))
    n_encodes = 3 * 2 + 5 * n_seqs + 2 * (n_seqs - 1)
    battery_want = {"B4": 2 * n_encodes, "beam 5": 2 + n_seqs,
                    "beam 15": 2 * n_seqs - 1}
    # the dump: each split's 10,000 rows in chunks of 512 (19 and one of
    # 272), each chunk one encoder call, B4 in both directions
    n_chunks = -(-static_eval.MAX_EXAMPLES // build_index.CHUNK)
    dump_b4 = 2 * n_chunks * 3
    if battery_want != {"B4": 36, "beam 5": 4, "beam 15": 3} or (
            dump_b4 != 120):
        raise AssertionError(f"the static eval's derived counts changed: "
                             f"battery {battery_want}, dump B4 {dump_b4}")
    se_flags = train_flags("smoke", TRAIN_ITERS)
    attributes = C.dataset_spec(tcfg)["attributes"]
    summary, se_counts, se_s, n_figs, n_fig_logs = static_eval_run(
        "gru", se_flags)
    want_se = dict.fromkeys(counts(), 0)
    want_se.update({"B4": dump_b4 + battery_want["B4"],
                    "B1": battery_want["beam 5"], "B3": 0,
                    "plain beam": battery_want["beam 15"]})
    # a second --long on the same run dir finds the dump: the battery alone
    _, se_counts2, se_s2, _, _ = static_eval_run("gru_again", se_flags)
    want_se2 = dict(want_se, B4=battery_want["B4"])
    if se_counts != want_se or se_counts2 != want_se2:
        raise AssertionError(f"static_eval --long launched {se_counts} "
                             f"(want {want_se}), then {se_counts2} (want "
                             f"{want_se2})")
    dumped = {sp: build_index.read_states(p_)
              for sp, p_ in summary["states"].items()}
    bad = {sp: {k: v.shape for k, v in st.items()} for sp, st in
           dumped.items() if st["mu"].shape != (static_eval.MAX_EXAMPLES,
                                                 tcfg.model.z_dim)
           or not os.path.exists(build_index.npz_path(summary["states"][sp]))}
    if bad or not os.path.exists(summary["index"]):
        raise AssertionError(f"the states dump {bad} or the index "
                             f"{summary['index']} is missing")
    # the same dump with every kernel as its plain version
    plain_dir = os.path.join(train_top, "plain_dump")
    os.makedirs(plain_dir, exist_ok=True)
    with cuda_build.plain():
        build_index.extract_from_dataset(
            model_t, tparams, vocab, tcfg, pipeline.load_dataloader(tcfg),
            plain_dir, TRAIN_ITERS, max_examples=static_eval.MAX_EXAMPLES)
    # float16 storage: one ulp where the two routes' f32 values straddle a
    # rounding boundary, plus MAX_HS_DELTA, the f32 gate of the same
    # encoder's outputs (5d): near zero a float16 ulp (down to 6e-8) is
    # finer than the f32 difference of the two routes' sums
    ulp_share, ulp_max, far = {}, 0.0, []
    for sp, st in dumped.items():
        pl = build_index.read_states(build_index.states_path(
            plain_dir, sp, TRAIN_ITERS))
        for k in ("src", "label", "split"):
            if not np.array_equal(st[k], pl[k]):
                raise AssertionError(f"the dump's {sp} {k} differs from the "
                                     f"plain dump's")
        for k in ("mu", "logvar", "z"):
            a, b = st[k], pl[k]
            delta = np.abs(a.astype(np.float32) - b.astype(np.float32))
            ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(
                np.float32)
            ulps = delta / ulp
            ulp_max = max(ulp_max, float(ulps.max()))
            ulp_share[sp, k] = float((ulps > 0).mean())
            if (delta > ulp + MAX_HS_DELTA).any():
                raise AssertionError(f"the dump's {sp} {k} differs from the "
                                     f"plain dump's by more than one float16 "
                                     f"ulp + {MAX_HS_DELTA}")
            over = ulps > 1
            far += [(float(u), float(d), float(m)) for u, d, m in zip(
                ulps[over], delta[over], np.maximum(np.abs(a), np.abs(b))[
                    over].astype(np.float32))]
    # the index on the card against a numpy inner-product top-k (float64
    # sums; a returned row's score is the top-k value at its rank)
    index = build_index.LatentIndex.load(summary["index"], dev)
    queries = dumped["test"]["z"][:256].astype(np.float32)
    got_s, got_i = index.search(queries, k=10)
    sims = queries.astype(np.float64) @ dumped["train"]["z"].astype(
        np.float64).T
    want_s = -np.sort(-sims, axis=1)[:, :10]
    at_i = np.take_along_axis(sims, got_i, axis=1)
    idx_err = max(float(np.abs(got_s - want_s).max()),
                  float(np.abs(at_i - want_s).max()))
    if not np.array_equal(index.z.cpu().numpy(), dumped["train"]["z"].astype(
            np.float32)) or idx_err > 1e-3:
        raise AssertionError(f"LatentIndex.search on the card disagrees with "
                             f"numpy's top-k by {idx_err}")
    log(f"[6e] static_eval --long on the phase-6 GRU run: dump of "
        f"{static_eval.MAX_EXAMPLES} rows a split in "
        + ", ".join(f"{sp} {summary['seconds'][sp]:.3f} s"
                    for sp in ("train", "val", "test"))
        + f" (host clock: draw, encode, copy, write .npz), battery "
        f"{summary['seconds']['battery']:.3f} s, whole call {se_s:.3f} s; "
        f"launches {se_counts} (want {want_se}); again on the dump: "
        f"whole call {se_s2:.3f} s, launches {se_counts2}; mu, logvar, z vs "
        f"the dump under cuda_build.plain(): at most {ulp_max:.0f} float16 "
        f"ulp, largest share of an array differing "
        f"{max(ulp_share.values()):.6f}, {len(far)} entries beyond one ulp "
        f"(ulps, |delta|, magnitude, largest 5: "
        f"{sorted(far, reverse=True)[:5]}); LatentIndex.search (10,000 rows, "
        f"256 queries, k 10) vs numpy: max |delta| {idx_err:.3e} ({card})")
    log(f"[6e] --long's diagnostics of the GRU run's dump on the card: "
        + diag_line(summary) + f"; {n_figs} figures, named as not drawn "
        f"in {n_fig_logs} log line(s) ({card})")
    mark("6e static eval of the GRU run (dump, index, battery)")
    summary_t, se_counts_t, se_s_t, _, _ = static_eval_run(
        "tfm", train_flags("smoke_tfm", TRAIN_ITERS, TFM_FLAGS))
    want_se_t = dict(want_se, B4=0, B1=0, B3=battery_want["beam 5"])
    if se_counts_t != want_se_t or not all(
            build_index.readable(p_) for p_ in summary_t["states"].values()):
        raise AssertionError(f"transformer static_eval --long launched "
                             f"{se_counts_t} (want {want_se_t}) or wrote no "
                             f"dump")
    log(f"[6e] static_eval --long on the phase-6t transformer run: dump "
        + ", ".join(f"{sp} {summary_t['seconds'][sp]:.3f} s"
                    for sp in ("train", "val", "test"))
        + f", battery {summary_t['seconds']['battery']:.3f} s, whole call "
        f"{se_s_t:.3f} s; launches {se_counts_t}; diagnostics: "
        + diag_line(summary_t) + f" ({card})")
    mark("6e-t static eval of the transformer run")

    # ---- 6v. the dump's diagnostics on the card against the CPU ----------
    # the phase-6e GRU dump (10,000 rows a split, z 100, six attributes);
    # the same functions with device="cpu" on the same arrays
    diag_dir = os.path.join(train_top, "diagnostics")
    os.makedirs(diag_dir, exist_ok=True)

    def host_s(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def discriminator(device_):
        return tsne.build_latent_discriminator(
            dumped["train"], os.path.join(diag_dir, f"{device_}.h5"),
            attributes, dumped["val"], dumped["test"], device=device_)

    disc_c, disc_s = host_s(lambda: discriminator("cuda"))
    disc_p = discriminator("cpu")
    auc_err = max(abs(disc_c[a][k] - disc_p[a][k]) for a in disc_p
                  for k in disc_p[a] if k.endswith("_auc"))
    acc_err = max(abs(disc_c[a][k] - disc_p[a][k]) for a in disc_p
                  for k in disc_p[a] if k.endswith("_acc"))
    frob_c, covar_s = host_s(lambda: covar.build_covar(
        dumped["train"], os.path.join(diag_dir, "cuda.h5"), device="cuda"))
    frob_p = covar.build_covar(dumped["train"],
                               os.path.join(diag_dir, "cpu.h5"),
                               device="cpu")
    frob_rel = max(abs(c - p_) / abs(p_) for c, p_ in zip(frob_c, frob_p))
    # kde at 500 x 10,000: the first 500 amp-positive and unlabeled rows'
    # z under every train row's posterior
    st = dumped["train"]
    n_train = st["mu"].shape[0]
    mu_c, lv_c = (torch.as_tensor(st[k], device=dev) for k in ("mu",
                                                              "logvar"))
    kde_err, kde_rows = 0.0, {}
    for target, tag_ in ((1, "pos"), (-1, "unl")):
        sel = np.flatnonzero(st["label"][:, 0] == target)[:500]
        r_c, d_c = kde.density_stats(mu_c, lv_c, st["z"][sel])
        r_p, d_p = kde.density_stats(st["mu"], st["logvar"], st["z"][sel],
                                     device="cpu")
        kde_err = max(kde_err, float((r_c.cpu() - r_p).abs().max()))
        kde_rows[tag_] = (len(sel), float(r_c.mean()), float(d_c.mean()))
    z_kde = torch.as_tensor(st["z"][:500], device=dev)
    kde_ms = cuda_ms(lambda: kde.density_stats(mu_c, lv_c, z_kde), 20)
    # t-SNE at 500 points on both devices, then at the full 2,000
    z500 = torch.as_tensor(st["z"][:500].astype(np.float32))
    ts_c, ts500_s = host_s(lambda: tsne.fit_tsne(z500.to(dev)))
    ts_p = tsne.fit_tsne(z500)
    p_err = float((ts_c.P.cpu() - ts_p.P).abs().max())
    kl_rel = abs(ts_c.kl - ts_p.kl) / ts_p.kl
    emb_err = float((ts_c.embedding.cpu() - ts_p.embedding).abs().max())
    z2000 = torch.as_tensor(st["z"][:2000].astype(np.float32), device=dev)
    ts_full, ts_full_s = host_s(lambda: tsne.fit_tsne(z2000))
    log(f"[6v] the GRU dump's diagnostics, card vs device=\"cpu\": "
        f"discriminators (12 Newton fits on 10,000 x {st['mu'].shape[1]}) "
        f"AUC max |delta| {auc_err:.3e}, accuracy {acc_err:.3e}; Frobenius "
        f"{frob_c} vs {frob_p}, rel {frob_rel:.3e}; kde non-zero fractions "
        f"max |delta| {kde_err:.3e} (one Gaussian 1/{n_train}), rows "
        f"(n, fraction, mean density) {kde_rows}; t-SNE at 500 points: P "
        f"max |delta| {p_err:.3e}, KL {ts_c.kl:.6f} vs {ts_p.kl:.6f} (rel "
        f"{kl_rel:.3e}), {ts_c.n_iter} vs {ts_p.n_iter} iterations, "
        f"embedding max |delta| {emb_err:.3e} ({card})")
    log(f"[6v] full-size times on the card: t-SNE at 2,000 points "
        f"{ts_full_s:.3f} s for {ts_full.n_iter} iterations (KL "
        f"{ts_full.kl:.6f}), at 500 {ts500_s:.3f} s; discriminators "
        f"{disc_s:.3f} s; build_covar (500 rows a set) {covar_s:.4f} s "
        f"(host clock); kde density_stats at 500 x {n_train} "
        f"{kde_ms:.4f} ms (CUDA events) ({card})")
    if (auc_err > 1e-4 or frob_rel > 1e-6 or kde_err > 1.0 / n_train
            or p_err > 1e-6 or kl_rel > 1e-2
            or not torch.isfinite(ts_full.embedding).all()):
        raise AssertionError("a diagnostic on the card disagrees with the "
                             "same function on the CPU")
    mark("6v the dump's diagnostics, card vs CPU")

    # ---- 5d. main path: Q from the dataloader's encodings -----------------
    # the GRU run of phase 6, its amp-positive train and val rows
    dataset = pipeline.load_dataloader(tcfg)
    gru_fwd_kernel.gru_fwd.launches = 0
    enc = pipeline.get_encodings_from_dataloader(
        tcfg, {"amp": 1}, "train,val", model_t, tparams, dataset)
    enc_launches = gru_fwd_kernel.gru_fwd.launches
    with cuda_build.plain():
        enc_plain = pipeline.get_encodings_from_dataloader(
            tcfg, {"amp": 1}, "train,val", model_t, tparams, dataset)
    n_batches = -(-enc[0].shape[0] // tcfg.vae.batch_size)
    enc_delta = max(float(np.abs(a - b).max()) for a, b in zip(enc, enc_plain))
    log(f"[5d] dataloader encodings of {enc[0].shape[0]} amp-positive "
        f"train+val rows in {n_batches} batches: B4 launches {enc_launches} "
        f"(2 per batch), max |mu, logvar delta| against cuda_build.plain() "
        f"{enc_delta:.3e}")
    if enc_launches != 2 * n_batches or enc_delta > MAX_HS_DELTA:
        raise AssertionError("the dataloader encodings did not run through "
                             "B4, or disagree with its plain version")
    cfg_d, args_d, _ = C.parse_and_finalize(
        train_flags("smoke", TRAIN_ITERS) + [
            "--Q_from_full_dataloader", "--Q_select_amppos", "1",
            "--Q_n_components", "10", "--n_samples_per_round", "5000",
            "--n_samples_acc", "100", "--samples_outfn_prefix",
            "smoke_dataloader"], extra_args=sample_pipeline.EXTRA_ARGS)
    # the states of the phase-6e dump, read from disk
    states_d = pipeline.load_states(cfg_d)
    gru_fwd_kernel.gru_fwd.launches = 0
    beam_kernel.beam_scan_gru.launches = 0
    stem_d, samples_d, stats_d = pipeline.run_from_states(
        cfg_d, args_d, model_t, tparams, vocab, states_d, device=dev,
        dataset=dataset)
    dl_launches = {"B4": gru_fwd_kernel.gru_fwd.launches,
                   "B1": beam_kernel.beam_scan_gru.launches}
    n_acc_d = int(np.sum(samples_d["accept"]))
    if (dl_launches["B4"] != 2 * n_batches or dl_launches["B1"] < 1
            or n_acc_d < 100
            or not os.path.exists(stem_d + ".plain.txt")):
        raise AssertionError(f"the --Q_from_full_dataloader run: launches "
                             f"{dl_launches}, {n_acc_d} accepted")
    log(f"[5d] run_from_states --Q_from_full_dataloader on the phase-6 run "
        f"and its dump: {stats_d['rounds']} round(s) consumed "
        f"({stats_d['rounds_launched']} launched), latent accept rate "
        f"{stats_d['accepted_z']}/{stats_d['candidates']} = "
        f"{stats_d['accepted_z'] / stats_d['candidates']:.4f}, "
        f"{stats_d['unique']} unique decodes, {n_acc_d} accepted samples in "
        f"{stem_d}.*; launches {dl_launches}")
    enc_launches += dl_launches["B4"]
    mark("5d dataloader encodings and their pipeline")

    # ---- 6a. the similarity eval's aligner: 100 x 100 peptides -----------
    # the accepted CLaSS samples of 5d against the train split of the amp
    # corpus, the same random.seed on both devices: the same pairs, the
    # same scores
    gen_peps = [p_ for p_, a in zip(samples_d["peptide"],
                                    samples_d["accept"]) if a]
    amp_train = [dataset.rows[i]["text"] for i in
                 dataset.get_subset_indices("split=train")]
    sims = {}
    for device_ in ("cuda", "cpu"):
        random.seed(0)
        sims[device_] = peptide_evals.PeptideEvaluator(
            device=device_).similarity(gen_peps, amp_train, matrix_size=100)
    random.seed(0)
    pairs = peptide_evals.PeptideEvaluator().similarity_pairs(
        gen_peps, amp_train, matrix_size=100)
    max_len = max(max(len(a), len(b)) for a, b in pairs)
    enc_a = alignment.encode_seqs([a for a, _ in pairs], max_len)
    enc_b = alignment.encode_seqs([b for _, b in pairs], max_len)
    args_c = [torch.as_tensor(x, device=dev) for x in (enc_a[0], enc_b[0],
                                                        enc_a[1], enc_b[1])]
    scores_c = alignment.align_scores(*args_c, device=dev).cpu()
    scores_p = alignment.align_scores(enc_a[0], enc_b[0], enc_a[1],
                                      enc_b[1])
    align_ms = cuda_ms(lambda: alignment.align_scores(*args_c, device=dev),
                       20)
    log(f"[6a] PeptideEvaluator.similarity, {len(gen_peps)} accepted "
        f"samples x {len(amp_train)} amp train-split peptides (100 x 100 "
        f"drawn): "
        f"{len(pairs)} pairs of up to {max_len} residues, mean similarity "
        f"{sims['cuda'][1]:.6f} (CPU {sims['cpu'][1]:.6f}); scores on the "
        f"card equal to the CPU's: {torch.equal(scores_c, scores_p)}; "
        f"align_scores {align_ms:.4f} ms (CUDA events) ({card})")
    if (sims["cuda"][0]["sim"] != sims["cpu"][0]["sim"]
            or not torch.equal(scores_c, scores_p) or len(pairs) < 5000):
        raise AssertionError("the aligner on the card disagrees with the "
                             "CPU's")
    mark("6a the similarity eval's aligner")

    # ---- 5d-bf16: the sampling CLI, decoding in bf16, on the phase-6 run --
    # sample_pipeline.main as a user runs it, reading the phase-6e dump
    # (the .npz: the card has no h5py)
    gru_fwd_kernel.gru_fwd.launches = 0
    beam_kernel.beam_scan_gru.launches_bf16 = 0
    rounds_c = RoundCounter()
    pipeline.LOG.addHandler(rounds_c)
    pipeline.LOG.setLevel("INFO")
    t_cli = time.perf_counter()
    stem_c = sample_pipeline.main(train_flags("smoke", TRAIN_ITERS) + [
        "--Q_from_full_dataloader", "--Q_select_amppos", "1",
        "--Q_n_components", "10", "--n_samples_per_round", "5000",
        "--n_samples_acc", "100", "--samples_outfn_prefix",
        "smoke_cli_bf16", "--hw.gen_dtype", "bfloat16"])
    cli_s = time.perf_counter() - t_cli
    pipeline.LOG.removeHandler(rounds_c)
    pipeline.LOG.setLevel(logging.NOTSET)
    cli_launches = {"B4": gru_fwd_kernel.gru_fwd.launches,
                    "B1 bf16": beam_kernel.beam_scan_gru.launches_bf16}
    acc_files = [f for f in os.listdir(os.path.dirname(stem_c))
                 if f.startswith(os.path.basename(stem_c) + ".accepted.")
                 and f.endswith(".csv")]
    n_acc_c = (int(acc_files[0].split(".accepted.")[1].split(".")[0])
               if len(acc_files) == 1 else 0)
    if (cli_launches["B4"] != 2 * n_batches or cli_launches["B1 bf16"] < 1
            or n_acc_c < 100 or not os.path.exists(stem_c + ".plain.txt")):
        raise AssertionError(f"the bf16 sample_pipeline run: launches "
                             f"{cli_launches}, {n_acc_c} accepted")
    log(f"[5d] sample_pipeline.main --Q_from_full_dataloader --hw.gen_dtype "
        f"bfloat16 on the phase-6 run, its dump read from disk: {n_acc_c} "
        f"accepted samples in {stem_c}.* in {cli_s:.3f} s, "
        f"{rounds_c.rounds} round(s) of 5000 launched; launches "
        f"{cli_launches}")
    mark("5d-bf16 sample_pipeline CLI in bf16")

    # ---- 5s. main path: the serial loop (--hw.fused_rounds 0) -------------
    # sample_pipeline.main as a user runs it on the phase-6 GRU run, reading
    # the phase-6e dump from disk; every round decodes its 5,000 candidates
    # in chunks of 1,024 (pipeline.DECODE_CHUNK): five B1 launches a round
    def serial_cli(tag, flags_, counter):
        rounds_s = RoundCounter()
        pipeline.LOG.addHandler(rounds_s)
        pipeline.LOG.setLevel("INFO")
        beam.beam_search.plain_runs = 0
        counter.launches = 0
        t0 = time.perf_counter()
        stem_ = sample_pipeline.main(flags_ + [
            "--hw.fused_rounds", "0", "--Q_n_components", "10",
            "--n_samples_per_round", "5000", "--n_samples_acc", "100",
            "--samples_outfn_prefix", f"smoke_serial_{tag}"])
        secs = time.perf_counter() - t0
        n_launch, n_plain = counter.launches, beam.beam_search.plain_runs
        pipeline.LOG.removeHandler(rounds_s)
        pipeline.LOG.setLevel(logging.NOTSET)
        with open(stem_ + ".csv", newline="") as fh:
            rows_ = list(csv.DictReader(fh))
        peps_ = [r["peptide"] for r in rows_]
        n_acc_ = sum(r["accept"] == "True" for r in rows_)
        per_round = -(-5000 // pipeline.DECODE_CHUNK)
        missing = [ext for ext in (".plain.txt", ".csv", ".pkl")
                   if not os.path.exists(stem_ + ext)]
        if (missing or len(set(peps_)) != len(peps_) or n_acc_ < 100
                or rounds_s.rounds < 1 or n_plain != 0
                or n_launch != per_round * rounds_s.rounds):
            raise AssertionError(
                f"serial {tag} run: missing {missing}, {len(peps_)} rows "
                f"({len(set(peps_))} unique), {n_acc_} accepted, "
                f"{rounds_s.rounds} rounds, launches {n_launch} (want "
                f"{per_round} a round), plain beam {n_plain}")
        log(f"[5s] sample_pipeline.main --hw.fused_rounds 0 on the phase-6 "
            f"{tag} run, its dump read from disk: {rounds_s.rounds} round(s) "
            f"of 5000, {len(peps_)} unique peptides, {n_acc_} accepted, in "
            f"{secs:.3f} s; launches {n_launch} ({per_round} a round), plain "
            f"beam 0; files {stem_}.*")
        return rounds_s.rounds, n_launch

    serial_runs = {
        "GRU": serial_cli("GRU", train_flags("smoke", TRAIN_ITERS),
                          beam_kernel.beam_scan_gru),
        "transformer": serial_cli(
            "transformer", train_flags("smoke_tfm", TRAIN_ITERS, TFM_FLAGS),
            tfm_beam_kernel.beam_scan_tfm)}
    mark("5s serial sample_pipeline CLI, both families")

    def fitted_Q(cfg_):
        """Q (10 components) and the two heads on a run's dump."""
        states_ = pipeline.load_states(cfg_)
        Q_ = pipeline.fitQ_and_test(
            cfg_, pipeline.resolve_QClass("mogQ"),
            {"n_components": 10, "z_num_samples": 10,
             "covariance_type": "diag"}, states_, device=dev)[0]
        Q_.init_attr_classifiers(
            {a: pipeline.build_clfZ(cfg_, a, states_, device=dev)
             for a in ("amp", "tox")}, {"amp": 1, "tox": 0})
        return Q_

    serial_ms = {}
    for tag, cfg_, model_, params_ in (("GRU", tcfg, model_t, tparams),
                                       ("transformer", tcfg_t, model_t6,
                                        tparams_t)):
        Q_s = fitted_Q(cfg_)
        z_s = Q_s.rejection_sample(
            pipeline.round_generator(cfg_.seed, 1, dev), 5000)[0]
        one_ = dp_rounds.shards_of(params_)
        dec = [pipeline.decode_top1(
            z_s, model_, one_, pipeline.round_generator(cfg_.seed, 2, dev),
            plain=plain_) for plain_ in (False, True)]
        same = (dec[0][0] == dec[1][0]).all(axis=1)
        d_score = float(np.abs(dec[0][1] - dec[1][1])[same].max())
        log(f"[5s] {tag} decode_from_z of one round's 5000 latents and c "
            f"(chunks of {pipeline.DECODE_CHUNK}), kernel vs plain=True: "
            f"rows identical {same.mean():.6f}, max |top-1 score delta| on "
            f"them {d_score:.3e}")
        if same.mean() < MIN_SAME_ROWS or d_score > MAX_SCORE_DELTA:
            raise AssertionError(f"{tag} serial decode: kernel vs plain "
                                 f"{same.mean():.4f} rows identical, score "
                                 f"delta {d_score:.3e}")
        # host-clock round times on this run: a serial round against a
        # fused decode-all round (its results copied to the host)
        def serial_round():
            pipeline.one_sampling_round(
                model_, one_, vocab, Q_s, 5000,
                pipeline.round_generator(cfg_.seed, 3, dev))

        def fused_round_():
            host_, ev_ = pipeline.launch_round(
                cfg_, model_, one_, Q_s, 5000,
                pipeline.round_generator(cfg_.seed, 3, dev))
            ev_.synchronize()
        for name, fn in (("serial", serial_round), ("fused", fused_round_)):
            fn()
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                ts.append(1e3 * (time.perf_counter() - t0))
            serial_ms[tag, name] = statistics.median(ts)
        log(f"[5s] {tag} round of 5000 on the phase-6 run (host clock, "
            f"median of 5): serial {serial_ms[tag, 'serial']:.3f} ms "
            f"(rejection, 5 beam launches, pandas frame, physchem per "
            f"peptide), fused decode-all {serial_ms[tag, 'fused']:.3f} ms "
            f"(one round, its host copies) ({card})")
    mark("5s decode_from_z kernel vs plain and round times")

    # ---- 8. main path: the server over HTTP -------------------------------
    def post(url_, n_):
        req_ = urllib.request.Request(
            url_ + "/generate", data=json.dumps({"n": n_}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req_, timeout=300) as r_:
            return json.loads(r_.read()), time.perf_counter() - t0

    def get(url_, path_):
        with urllib.request.urlopen(url_ + path_, timeout=60) as r_:
            return json.loads(r_.read())

    def http_code(fn):
        try:
            fn()
        except urllib.error.HTTPError as e:
            return e.code
        return 200

    cfg_8, args_8, _ = C.parse_and_finalize(
        train_flags("smoke", TRAIN_ITERS) + [
            "--n_samples_per_round", "5000", "--Q_n_components", "10"],
        extra_args=serve.EXTRA_ARGS)
    t0 = time.perf_counter()
    srv = serve.build_server(cfg_8, args_8, device=dev)
    build_s = time.perf_counter() - t0
    mark("8a build_server on the phase-6 run")
    beam_kernel.beam_scan_gru.launches = 0
    beam.beam_search.plain_runs = 0
    srv.start()
    worker = srv._worker
    httpd = serve.make_http_server(srv, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    big_n, burst_n, n_clients = 12000, 64, 16
    responses, burst_lat, queued_err = [], [], {}

    def queued():
        try:
            srv.generate(10 ** 7, timeout=300)
        except RuntimeError as e:
            queued_err["e"] = e
    q_thread = threading.Thread(target=queued)
    try:
        t_http = time.perf_counter()
        out, first_s = post(url, burst_n)
        responses.append((burst_n, out))
        burst_out = [None] * n_clients

        def client(i):
            burst_out[i] = post(url, burst_n)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t_ in threads:
            t_.start()
        for t_ in threads:
            t_.join(300)
        for o_, lat in burst_out:
            responses.append((burst_n, o_))
            burst_lat.append(lat)
        out, big_s = post(url, big_n)
        responses.append((big_n, out))
        http_s = time.perf_counter() - t_http
        health = get(url, "/healthz")
        codes = (http_code(lambda: post(url, 0)),
                 http_code(lambda: get(url, "/nope")))
        # idle: every launched round read
        deadline = time.time() + 60
        while (srv.stats["rounds"] < srv._round_ix
               and time.time() < deadline):
            time.sleep(0.01)
        stats_8 = get(url, "/stats")
        rounds_idle = srv._round_ix

        q_thread.start()
        while not srv._queue and q_thread.is_alive():
            time.sleep(0.001)
    finally:
        srv.stop()
        httpd.shutdown()
        httpd.server_close()
    if q_thread.ident is not None:
        q_thread.join(60)
    serve_launches = beam_kernel.beam_scan_gru.launches
    serve_plain = beam.beam_search.plain_runs
    served_rows = [r for _, o_ in responses for r in o_["samples"]]
    served_peps = [r["peptide"] for r in served_rows]
    # the first round outside the server: one launch_round with round 1's
    # generator, its accepted rows deduped in order
    host_1, ev_1 = pipeline.launch_round(
        cfg_8, srv.model, srv.shards, srv.Q, 5000,
        pipeline.round_generator(cfg_8.seed, 1, dev))
    ev_1.synchronize()
    acc_1 = host_1[2].numpy()
    tok_1 = host_1[3].numpy()[acc_1]
    seen_1, first_1 = set(), []
    for i, k in enumerate(pipeline.canonical_keys(tok_1)):
        if k not in seen_1:
            seen_1.add(k)
            first_1.append(i)
    peps_1 = vocab.to_sentences_batch(tok_1[first_1].astype(np.int64),
                                      print_special_tokens=False)
    score_1 = {k: v.numpy()[acc_1][first_1] for k, v in host_1[1].items()}
    # round 1's rows left unserved at stop() wait in the spare rows
    by_pep = {r["peptide"]: r for r in served_rows + list(srv._spare)}
    first_in_order = [r["peptide"] for r in responses[0][1]["samples"]] == (
        peps_1[:burst_n])
    first_bitwise = all(
        p in by_pep and all(np.float32(by_pep[p][k]).tobytes()
                            == score_1[k][i].tobytes() for k in score_1)
        for i, p in enumerate(peps_1))
    bad = [n_ for n_, o_ in responses if o_["n"] != n_
           or len(o_["samples"]) != n_]
    if (bad or len(set(served_peps)) != len(served_peps)
            or len(served_peps) != stats_8["served"]
            or stats_8["candidates"] != 5000 * stats_8["rounds"]
            or stats_8["rounds"] != rounds_idle
            or serve_launches != srv._round_ix or serve_plain != 0
            or not first_in_order or not first_bitwise
            or not isinstance(queued_err.get("e"), RuntimeError)
            or worker.is_alive() or codes != (400, 404)
            or health["backend"] != "cuda" or not health["ok"]):
        raise AssertionError(
            f"the server: short responses {bad}, {len(served_peps)} rows "
            f"({len(set(served_peps))} unique) against served "
            f"{stats_8['served']}, stats {stats_8}, rounds at idle "
            f"{rounds_idle}, B1 launches {serve_launches} against "
            f"{srv._round_ix} rounds launched, plain beam {serve_plain}, "
            f"first round in order {first_in_order} and bitwise "
            f"{first_bitwise}, queued request {queued_err}, worker alive "
            f"{worker.is_alive()}, codes {codes}, health {health}")
    q = statistics.quantiles(burst_lat, n=100)
    st_8 = stats_8["stage_s"]
    log(f"[8] GenerationServer over HTTP on the phase-6 GRU run (round "
        f"5000, depth {srv._depth}; build_server {build_s:.3f} s): one "
        f"request of {burst_n} in {first_s:.3f} s, then {n_clients} "
        f"concurrent clients x {burst_n}: latency p50 {q[49]:.4f} s, p99 "
        f"{q[98]:.4f} s; then one request of {big_n} in {big_s:.3f} s; "
        f"{len(served_peps)} unique rows served in {http_s:.3f} s = "
        f"{len(served_peps) / http_s:.1f} served rows/s; rounds "
        f"{stats_8['rounds']} ({stats_8['candidates']} candidates, "
        f"{stats_8['accepted']} accepted, {stats_8['duplicates']} "
        f"duplicates), B1 launches {serve_launches} (one a round, "
        f"{srv._round_ix - rounds_idle} for the request queued at stop), "
        f"plain beam 0; device_s {stats_8['device_s']:.4f} (CUDA events), "
        f"device_gap_s {stats_8['device_gap_s']:.4f}, stage_s d2h "
        f"{st_8['d2h']:.4f}, host_postproc {st_8['host_postproc']:.4f}; "
        f"the first round equal "
        f"to one launch_round outside the server ({len(peps_1)} rows, the "
        f"first {burst_n} in order, every score bit for bit); 400 and 404 "
        f"answered; the request queued at stop() raised; the worker ended "
        f"({card})")
    mark("8 the server over HTTP")

    # ---- 8t. the transformer's server for one request (B3) ----------------
    cfg_8t, args_8t, _ = C.parse_and_finalize(
        train_flags("smoke_tfm", TRAIN_ITERS, TFM_FLAGS) + [
            "--n_samples_per_round", "5000", "--Q_n_components", "10"],
        extra_args=serve.EXTRA_ARGS)
    srv_t = serve.build_server(cfg_8t, args_8t, device=dev)
    tfm_beam_kernel.beam_scan_tfm.launches = 0
    srv_t.start()
    try:
        t0 = time.perf_counter()
        rows_8t = srv_t.generate(burst_n, timeout=300)
        lat_8t = time.perf_counter() - t0
    finally:
        srv_t.stop()
    serve_launches_t = tfm_beam_kernel.beam_scan_tfm.launches
    peps_8t = [r["peptide"] for r in rows_8t]
    if (len(peps_8t) != burst_n or len(set(peps_8t)) != burst_n
            or serve_launches_t < 1 or serve_launches_t != srv_t._round_ix):
        raise AssertionError(f"the transformer server: {len(set(peps_8t))} "
                             f"unique of {len(peps_8t)} rows, B3 launches "
                             f"{serve_launches_t}, rounds {srv_t._round_ix}")
    log(f"[8t] transformer GenerationServer on the phase-6t run: one "
        f"request of {burst_n} in {lat_8t:.3f} s, {srv_t._round_ix} "
        f"round(s), B3 launches {serve_launches_t} ({card})")
    mark("8t the transformer's server")


    # ---- 9. main path: phase-2 training and the mixed families ------------
    def full_run(tag, run6, runname, n_iter, extra=(), n1=TRAIN_ITERS,
                 cadences=None):
        """main.main --phase 2 from the phase-1 run's last checkpoint
        (step ``n1``), the kernels' counts set to 0 just before and read
        just after; the phase-2 files, finite logged losses, the last
        checkpoint holding the classifier. ``cadences`` (cheap, expsv)
        default to n_iter / 4 and n_iter / 2. Returns (cfg, counts,
        seconds, the last result row, the last checkpoint's iteration, the
        logged phase-2 rows, the chunks (replays, steps a replay, kernel
        nodes) or None)."""
        every = max(n_iter // 2, 1)
        cheap, every = cadences or (max(every // 2, 1), every)
        flags_ = train_flags(runname, n1, list(extra)) + [
            "--phase", "2", "--loadpath",
            run6.vae.chkpt_path.format(n1), "--full.n_iter",
            str(n_iter), "--full.cheaplog_every", str(cheap),
            "--full.expsvlog_every", str(every)]
        cfg_, launches_, secs_, chunks_ = train_run(tag, flags_)
        fc = cfg_.full
        last_it = fc.s_iter + n_iter
        missing = [p_ for p_ in (
            fc.gen_samples_path, fc.samez_samples_path, fc.posz_samples_path,
            fc.interp_samples_path, fc.fasta_gen_samples_path,
            fc.fasta_pos_samples_path, fc.chkpt_path.format(last_it))
            if not os.path.exists(p_)]
        if missing:
            raise AssertionError(f"{tag}: missing {missing}")
        with open(os.path.join(cfg_.savepath, "result.json")) as fh:
            rows_ = json.load(fh)
        logged_ = [r for r in rows_ if "full_L_vae" in r]
        bad = [(r["it"], k) for r in logged_ for k, v in r.items()
               if not np.isfinite(v)]
        with np.load(fc.chkpt_path.format(last_it)) as data:
            has_clf = "['params']['clf']['fc']['w']" in data.files
            step_ = int(data["['step']"])
        with open(fc.gen_samples_path) as fh:
            gen_lines = fh.read().splitlines()
        if (bad or not logged_ or not has_clf or step_ != last_it
                or len(gen_lines) != 2 * cfg_.evals.sample_size
                or not set(gen_lines[::2]) <= {"label: 0", "label: 1"}):
            raise AssertionError(f"{tag}: non-finite "
                                 f"{bad}, logged {len(logged_)} rows, clf "
                                 f"{has_clf}, step {step_}, "
                                 f"{len(gen_lines)} full_gen.txt lines")
        return cfg_, launches_, secs_, rows_[-1], last_it, logged_, chunks_

    def full_vs_plain(tag, model_, cfg_, ckpt_, n_wall=3):
        """The three phase-2 sub-losses and every group's gradients under
        --full.z_regu_loss mmd (B2 and B5 both on the path) at the params
        of ``ckpt_``, on the same batches and draws, through the kernels
        and inside cuda_build.plain(): losses rtol 1e-5, gradients within
        MAX_GRAD_REL of each tensor's largest entry. Then the run's own
        FullStep (mmdrf): ``n_wall`` steps on the host clock, and one more
        under torch.profiler (device activity alone): device events a
        step, device busy ms a step, idle share of the unprofiled
        steps. Returns (loss rel, grad rel, the tensor of the
        largest gradient error, the kernel route's counts, the
        profile)."""
        cfgf = C.parse_and_finalize(["--full.z_regu_loss", "mmd"])[0].full
        template = model_.init_params(torch.Generator(device=dev).manual_seed(
            0), dev)
        template["clf"] = model_.init_classifier(
            torch.Generator(device=dev).manual_seed(0), dev)
        params_ = checkpoints.load_params(ckpt_, template, dev)
        for leaf in checkpoints.flatten(params_).values():
            leaf.requires_grad_(True)
        ds = train_main.load_dataset(cfg_)
        text = torch.from_numpy(ds.next_batch("train_vae").text).to(dev)
        lab = ds.next_batch("train_amp_lab")
        lab_text = torch.from_numpy(lab.text).to(dev)
        lab_y = torch.from_numpy(np.maximum(
            getattr(lab, ds.attributes[0][0]), 0)).to(dev)
        draws = train_full.draw_full_step(
            model_, runtime.generator(dev, cfg_.seed, 10 ** 6),
            text.shape[0], lab_text.shape[0], cfg_.max_seq_len, dev, cfgf)
        rf = losses.init_rf_basis(runtime.generator(dev, cfg_.seed, 7),
                                  model_.z_dim, cfg_.losses.wae_mmd.rf_dim,
                                  dev)
        vae_l, attr_l, clf_l = train_full.make_full_losses(
            model_, cfgf, cfg_.losses.wae_mmd, rf)
        calls = ((lambda: vae_l(params_, text, 1.5, draws["vae"]),
                  ("E", "G")),
                 (lambda: attr_l(params_, 0.9, draws["attr"]), ("G",)),
                 (lambda: clf_l(params_, lab_text, lab_y, 0.9,
                                draws["clf"]), ("C",)))

        def run():
            out_ = []
            for fn, names in calls:
                loss, met = fn()
                out_.append((loss.detach(), met, train_full.group_grads(
                    loss, params_, names)))
            return out_

        reset_counts()
        res_k = run()
        torch.cuda.synchronize()
        k_counts = counts()
        with cuda_build.plain():
            res_p = run()
        loss_rel, grad_rel, worst = 0.0, 0.0, None
        for (_, mk, gk), (_, mp, gp) in zip(res_k, res_p):
            for k in mp:
                loss_rel = max(loss_rel, abs(mk[k].item() - mp[k].item())
                               / max(abs(mp[k].item()), 1e-30))
            for n_ in gp:
                fk, fp = checkpoints.flatten(gk[n_]), checkpoints.flatten(
                    gp[n_])
                for p_ in fp:
                    e_ = rel_err(fk[p_], fp[p_])
                    if e_ >= grad_rel:
                        grad_rel, worst = e_, checkpoints.keystr(p_)
        if loss_rel > 1e-5 or grad_rel > MAX_GRAD_REL:
            raise AssertionError(f"{tag} phase-2 step (mmd): kernels "
                                 f"vs plain, losses rel {loss_rel:.3e}, "
                                 f"gradient rel {grad_rel:.3e} ({worst})")
        step_ = train_full.FullStep(model_, cfg_.full, cfg_.losses, rf)
        states = step_.init(params_)

        def steps(it0, n):
            for i in range(n):
                step_(params_, states, text, lab_text, lab_y, it0 + i, draws)
            torch.cuda.synchronize()

        steps(0, 1)
        t0 = time.perf_counter()
        steps(1, n_wall)
        wall = (time.perf_counter() - t0) / n_wall
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps(1 + n_wall, 1)
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in ("vae update", "attribute update",
                                  "classifier update", "optimizer")]
        busy = profile_train._union_us(
            [(e.time_range.start, e.time_range.end) for e in evs])
        prof_ = {"events_per_step": len(evs), "busy_ms_per_step": busy / 1e3,
                 "wall_ms_per_step": 1e3 * wall,
                 "idle_share": 1.0 - busy / 1e6 / wall if evs else None}
        for leaf in checkpoints.flatten(params_).values():
            leaf.requires_grad_(False)
        return loss_rel, grad_rel, worst, k_counts, prof_

    full_stats = {}
    for tag, run6, runname, n_it, extra, model_ in (
            ("GRU", tcfg, "smoke_p2", FULL_ITERS, (), model_t),
            ("transformer", tcfg_t, "smoke_tfm_p2", FULL_ITERS_T, TFM_FLAGS,
             model_t6)):
        cfg9, l9, s9, fin9, last9, logged9, ch9 = full_run(
            f"{tag} phase 2", run6, runname, n_it, extra)
        n9 = n_it + 1
        gru = tag == "GRU"
        # B2: three recurrences in the VAE update, two in encode(soft); B4:
        # the artifacts' encode of the amp-positive rows (two directions)
        want9 = {"B2 fwd": 5 * n9 if gru else 0, "B2 bwd": 5 * n9 if gru
                 else 0, "B2 wgrad": 5 * n9 if gru else 0,
                 "B4": 2 if gru else 0, "B5 fwd": 0, "B5 bwd": 0}
        # the GRU's cadences 25 / 50: iteration 300 alone, then four
        # replays of a 25-step graph; the transformer's 7 / 15: unroll 1
        want_ch9 = (4, 25) if gru else None
        if l9 != want9 or (ch9 and ch9[:2]) != want_ch9:
            raise AssertionError(f"{tag} phase 2 launched {l9}, expected "
                                 f"{want9}; chunks {ch9}, expected "
                                 f"{want_ch9}")
        mark(f"9 {tag} phase 2 (main.main)")
        check = full_vs_plain(tag, model_, cfg9,
                              cfg9.full.chkpt_path.format(last9))
        want_k = {"B2 fwd": 5 if gru else 0, "B2 bwd": 5 if gru else 0,
                  "B2 wgrad": 5 if gru else 0, "B4": 0, "B5 fwd": 1,
                  "B5 bwd": 1}
        if check[3] != want_k:
            raise AssertionError(f"{tag} phase-2 step (mmd) launched "
                                 f"{check[3]}, expected {want_k}")
        full_stats[tag] = (cfg9, l9, s9, fin9, n9, check, logged9, ch9)
        lr_, gr_, worst_, kc_, pr = check
        log(f"[9] {tag} main --phase 2 from phase 6's model_{TRAIN_ITERS}"
            f".npz, {n9} steps at batch {cfg9.vae.batch_size}: {s9:.2f} s "
            f"in main.main ("
            + (f"{ch9[0]} replays of a {ch9[1]}-step CUDA graph of {ch9[2]} "
               f"kernel nodes" if ch9 else "every step eager") +
            f"); launches {l9} (B2 "
            f"{l9['B2 fwd'] / n9:.2f} triples a step); L_vae at the logs "
            f"{[round(r['full_L_vae'], 4) for r in logged9]}, clf_acc "
            f"{[round(r['full_clf_acc'], 3) for r in logged9]}; "
            f"{fin9['full_steps_per_sec_warm']:.2f} steps/s after "
            f"{train_vae.WARM_STEPS} steps, {fin9['full_steps_per_sec']:.2f} "
            f"over all (host clock, logs and checkpoints included); files "
            f"full_gen/samez/posz/interp.txt, the FASTAs, "
            f"model_{last9}.npz with the classifier ({card})")
        log(f"[9] {tag} one phase-2 step (--full.z_regu_loss mmd), its "
            f"three sub-losses and every group's gradients, kernels vs "
            f"cuda_build.plain() on the same params, batches and draws: "
            f"losses within rel {lr_:.3e}, gradients within {gr_:.3e} of "
            f"the tensor's max ({worst_}); launches {kc_}")
        log(f"[9] {tag} phase-2 step (mmdrf), 3 steps on the host clock "
            f"and 1 under torch.profiler: {pr['wall_ms_per_step']:.4f} ms a "
            f"step, {pr['events_per_step']:.1f} device events a step, device "
            f"busy {pr['busy_ms_per_step']:.4f} ms, idle share "
            f"{pr['idle_share']:.4f} ({card})")
        mark(f"9 {tag} phase-2 step, kernels vs plain, profile")

    # the GRU family's phase 2 under --full.z_regu_loss mmd: B5 on the path
    cfg9m, l9m, s9m, _, _, logged9m, _ = full_run(
        "GRU phase 2 mmd", tcfg, "smoke_p2_mmd", 10,
        ["--full.z_regu_loss", "mmd"])
    if l9m["B5 fwd"] != 11 or l9m["B5 bwd"] != 11 or l9m["B2 fwd"] != 55:
        raise AssertionError(f"phase 2 under mmd launched {l9m}")
    log(f"[9] GRU main --phase 2 --full.z_regu_loss mmd, 11 steps: "
        f"{s9m:.2f} s; launches {l9m}; L_vae at the logs "
        f"{[round(r['full_L_vae'], 4) for r in logged9m]}")
    mark("9 GRU phase 2 under mmd")

    # the mixed families: 51 phase-1 steps at cadences 25 / 50 through the
    # chunk's CUDA graph, one step kernels vs plain, one fused round each
    mixed_stats, mixed_cfgs = {}, {}
    for tag, fam in (("transformer-GRU", ("transformer", "gru")),
                     ("GRU-transformer", ("gru", "transformer"))):
        fam_flags = ["--model.E_args.E_class", fam[0],
                     "--model.G_args.G_class", fam[1]]
        cfg_x, l_x, s_x, ch_x = train_run(tag, train_flags(
            f"smoke_mixed_{fam[0]}", UNROLL_ITERS, fam_flags + [
                "--vae.cheaplog_every", "25", "--vae.expsvlog_every", "50"]))
        _, recon_x, _, _, model_x, params_x = check_train_outputs(
            tag, cfg_x, UNROLL_ITERS + 1)
        n_gru = 2 * (fam[0] == "gru") + (fam[1] == "gru")
        n_x = UNROLL_ITERS + 1
        want_x = {"B2 fwd": n_gru * n_x, "B2 bwd": n_gru * n_x,
                  "B2 wgrad": n_gru * n_x, "B4": 4 * n_gru, "B5 fwd": n_x,
                  "B5 bwd": 0}
        if l_x != want_x or ch_x is None or ch_x[:2] != (2, 25):
            raise AssertionError(f"{tag} training: launches {l_x} (want "
                                 f"{want_x}), chunks {ch_x}")
        log(f"[9] {tag} phase-1 training, {n_x} steps: {s_x:.2f} s; "
            f"{ch_x[0]} replays of a {ch_x[1]}-step CUDA graph of {ch_x[2]} "
            f"kernel nodes; launches {l_x}; recon at the logs "
            f"{[round(r, 4) for r in recon_x]}")
        step_vs_plain(tag, model_x, cfg_x, params_x)
        mark(f"9 {tag} training and one step vs plain")
        cfg_r, _, _ = C.parse_and_finalize(
            flags + fam_flags, extra_args=sample_pipeline.EXTRA_ARGS)
        round_checks(tag, cfg_r, model_x, params_x, timed=False)
        mixed_stats[tag] = (l_x, s_x, ch_x)
        mixed_cfgs[tag] = cfg_x

    # ---- 9u. the phase-2 chunk (--hw.unroll) against the per-step path ----
    def full_logged(cfg_):
        with open(os.path.join(cfg_.savepath, "result.json")) as fh:
            return {r["it"]: {k: v for k, v in r.items()
                              if k.startswith("full_")
                              and "steps_per_sec" not in k}
                    for r in json.load(fh) if "full_L_vae" in r}

    full_u = {}
    for tag, run6, n1, extra, n_it, cad, want_u in (
            ("GRU", tcfg, TRAIN_ITERS, (), UNROLL_ITERS, (25, 50), (2, 25)),
            ("transformer", tcfg_t, TRAIN_ITERS, TFM_FLAGS, 20, (10, 20),
             (2, 10)),
            ("GRU-transformer mmd", mixed_cfgs["GRU-transformer"],
             UNROLL_ITERS, ["--model.E_args.E_class", "gru",
                            "--model.G_args.G_class", "transformer",
                            "--full.z_regu_loss", "mmd"], 20, (10, 10),
             (2, 10))):
        runs_9u = {}
        for unroll in (None, 1):
            runs_9u[unroll] = full_run(
                f"{tag} 9u", run6, f"p2u{unroll or 'd'}_{tag[:3]}_{tag[-3:]}",
                n_it, list(extra) + (["--hw.unroll", "1"] if unroll else []),
                n1=n1, cadences=cad)
            if unroll is None:
                graph_9u = chunk_log.stats
        (cfg_c, l_c, s_c, _, last_c, _, ch_c), (cfg_1, l_1, s_1, *_) = (
            runs_9u[None], runs_9u[1])
        n_c = n_it + 1
        gru_enc, gru_dec = tag.startswith("GRU"), tag == "GRU"
        n_b2 = 2 * gru_enc * 2 + gru_dec * 1
        mmd = "mmd" in tag
        want_l = {"B2 fwd": n_b2 * n_c, "B2 bwd": n_b2 * n_c,
                  "B2 wgrad": n_b2 * n_c, "B4": 2 * gru_enc,
                  "B5 fwd": n_c * mmd, "B5 bwd": n_c * mmd}
        if (ch_c is None or ch_c[:2] != want_u or runs_9u[1][6] is not None
                or l_c != want_l or l_1 != want_l):
            raise AssertionError(f"9u {tag}: chunks {ch_c} (want {want_u}), "
                                 f"launches {l_c} and unroll 1's {l_1} "
                                 f"(want {want_l})")
        rel, key, bitwise = state_delta(cfg_c.full.chkpt_path.format(last_c),
                                        cfg_1.full.chkpt_path.format(last_c))
        rows_c, rows_1 = full_logged(cfg_c), full_logged(cfg_1)
        loss_rel = max(abs(rows_c[i][k] - v) / max(abs(v), 1e-30)
                       for i, r in rows_1.items() for k, v in r.items())
        cause = ""
        if not bitwise:
            # before blaming the graph: is the per-step path repeatable?
            cfg_2 = full_run(f"{tag} 9u again", run6,
                             f"p2u1b_{tag[:3]}_{tag[-3:]}", n_it,
                             list(extra) + ["--hw.unroll", "1"], n1=n1,
                             cadences=cad)[0]
            rel_2, key_2, bit_2 = state_delta(
                cfg_2.full.chkpt_path.format(last_c),
                cfg_1.full.chkpt_path.format(last_c))
            cause = (f"; unroll 1 twice: largest difference {rel_2:.3e} "
                     f"({key_2}), bitwise "
                     f"{'equal' if bit_2 else 'different'}")
        if (rel > MAX_UNROLL_REL or set(rows_c) != set(rows_1)
                or loss_rel > 1e-5):
            raise AssertionError(f"9u {tag}: the chunk against unroll 1: "
                                 f"model_{last_c}.npz {key} apart by "
                                 f"{rel:.3e}, logged losses by "
                                 f"{loss_rel:.3e}{cause}")
        full_u[tag] = (l_c, s_c, s_1, ch_c, graph_9u)
        log(f"[9u] {tag} phase 2, {n_c} steps at cadences {cad[0]} / "
            f"{cad[1]}, the default --hw.unroll ({ch_c[0]} replays of a "
            f"{ch_c[1]}-step CUDA graph of {ch_c[2]} kernel nodes, "
            f"{graph_9u['nodes']} nodes; capture {graph_9u['capture_s']:.3f}"
            f" s, instantiate {graph_9u['instantiate_s']:.3f} s) against "
            f"--hw.unroll 1: model_{last_c}.npz largest difference "
            f"{rel:.3e} of the array's largest entry ({key}), bitwise "
            f"{'equal' if bitwise else 'different'}{cause}; logged losses "
            f"within {loss_rel:.3e}; launches {l_c} (want {want_l}); "
            f"{s_c:.2f} s against {s_1:.2f} s in main.main ({card})")
        mark(f"9u {tag} unroll against unroll 1")

    # both families' chunks at the default unroll 50 (cadences 50 / 50:
    # iteration 0 alone, then one capture and one replay of 50 steps)
    full_u50 = {}
    for tag, run6, extra in (("GRU", tcfg, ()),
                             ("transformer", tcfg_t, TFM_FLAGS)):
        cfg_50, l_50, s_50, _, _, _, ch_50 = full_run(
            f"{tag} 9u-50", run6, f"p2u50_{tag[:3]}", 50, list(extra),
            cadences=(50, 50))
        st = chunk_log.stats
        if ch_50 is None or ch_50[:2] != (1, 50):
            raise AssertionError(f"9u {tag} unroll 50: chunks {ch_50}")
        full_u50[tag] = (l_50, s_50, st)
        log(f"[9u] {tag} phase-2 chunk at the default --hw.unroll 50: "
            f"{st['kernel_nodes']} kernel nodes ({st['kernel_nodes'] / 50:.1f}"
            f" a step) of {st['nodes']} nodes; capture {st['capture_s']:.3f}"
            f" s, instantiate {st['instantiate_s']:.3f} s; graph pool "
            f"{st['pool_bytes']} bytes, executable {st['exec_bytes']} bytes; "
            f"51 steps in {s_50:.2f} s in main.main ({card})")
        mark(f"9u {tag} unroll 50")

    # a phase-1 run under --hw.profile_dir: the bounded window
    # (utils/tracing.PROFILE_SCHEDULE) of 101 steps at cadences 25 / 25,
    # step 0 alone, then four replays of a 25-step graph: boundaries 3-4,
    # the last two replays, and nothing of the eager steps (step 0, the
    # capture's two warm-up steps)
    trace_dir = os.path.join(train_top, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    cfg_tr, l_tr, s_tr, ch_tr = train_run("GRU traced", train_flags(
        "smoke_trace", 100, ["--vae.cheaplog_every", "25",
                             "--vae.expsvlog_every", "25",
                             "--hw.profile_dir", trace_dir]))
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
              if f.endswith(".pt.trace.json")] if os.path.isdir(
                  trace_dir) else []
    if len(traces) != 1 or ch_tr is None or ch_tr[:2] != (4, 25):
        raise AssertionError(f"the traced phase-1 run: trace files {traces}, "
                             f"chunks {ch_tr}")
    with open(traces[0]) as fh:
        trace_events = json.load(fh)["traceEvents"]
    k_events = [e for e in trace_events if e.get("cat") == "kernel"]
    steps_tr = sorted({e.get("name") for e in trace_events
                       if e.get("name", "").startswith("ProfilerStep#")})
    in_trace = {k: sum(name in e.get("name", "") for e in k_events)
                for k, name in (("B2 fwd", "gru_scan_kernel"),
                                ("B2 bwd", "gru_bwd_kernel"),
                                ("B2 wgrad", "gru_wgrad_kernel"),
                                ("B5 fwd", "mmd_fwd_kernel"))}
    # two replays of 25 steps: 3 of each B2 kernel a step, one B5; the
    # boundaries' held-out evals add B4 launches (gru_scan_kernel) alone
    want_tr = {"B2 fwd": 150, "B2 bwd": 150, "B2 wgrad": 150, "B5 fwd": 50}
    off = {k: v for k, v in in_trace.items()
           if v != want_tr[k] and not (k == "B2 fwd" and v > want_tr[k])}
    if off or steps_tr != [f"ProfilerStep#{i}" for i in (3, 4)]:
        raise AssertionError(f"the trace under --hw.profile_dir holds "
                             f"steps {steps_tr} and {in_trace} of B2's and "
                             f"B5's kernels: not two replays' {off}")
    log(f"[9u] phase-1 training under --hw.profile_dir, 101 steps (step 0, "
        f"four replays of a 25-step graph): {s_tr:.2f} s; trace "
        f"{os.path.basename(traces[0])} of {steps_tr}, "
        f"{os.path.getsize(traces[0])} bytes, {len(k_events)} kernel "
        f"events; B2 / B5 kernels in it {in_trace} (two replays "
        f"{want_tr}); launches {l_tr}")
    mark("9u phase-1 trace under --hw.profile_dir")

    # ---- 10. the model's options: skip connections, a flow, deconv ------
    # one Q (10 components) over the synthetic latent corpus of [5], shared
    # by the options' same-draws rounds and the deconv server
    Q10 = pipeline.fitQ_and_test(
        cfg, pipeline.resolve_QClass("mogQ"),
        {"n_components": 10, "z_num_samples": 10,
         "covariance_type": "diag"}, states, device=dev)[0]
    Q10.init_attr_classifiers(
        {a: pipeline.build_clfZ(cfg, a, states, device=dev)
         for a in ("amp", "tox")}, {"amp": 1, "tox": 0})

    def beam_counts():
        return {"B1": beam_kernel.beam_scan_gru.launches,
                "plain beam": beam.beam_search.plain_runs,
                "replay beam": beam.beam_search_logits.runs}

    def reset_beam_counts():
        beam_kernel.beam_scan_gru.launches = 0
        beam.beam_search.plain_runs = 0
        beam.beam_search_logits.runs = 0

    def option_pipeline(tag, fl, model_, params_, serial=False):
        """sample_pipeline's main path (run_from_states) on the option's
        trained model until one accepted sample: the beams' counts set to
        0 just before and read just after. Returns (counts, stats)."""
        cfg_, args_, _ = C.parse_and_finalize(
            flags + fl + ["--Q_n_components", "10", "--Q_covariance_type",
                          "diag", "--n_samples_per_round", "5000",
                          "--n_samples_acc", "1", "--samples_outfn_prefix",
                          "smoke_" + tag.replace(" ", "_")]
            + (["--hw.fused_rounds", "0"] if serial else []),
            extra_args=sample_pipeline.EXTRA_ARGS)
        reset_beam_counts()
        stem_, samples_, stats_ = pipeline.run_from_states(
            cfg_, args_, model_, params_, vocab, states, device=dev)
        counts_ = beam_counts()
        peps = samples_["peptide"]
        if (not os.path.exists(stem_ + ".csv") or not len(peps)
                or not set("".join(peps).replace(" ", "")) <= set(
                    vocab.itos[4:])):
            raise AssertionError(f"{tag} sample_pipeline: {len(peps)} "
                                 f"samples, files {stem_}.*")
        return counts_, stats_

    opt_flags = {
        "skip": ["--model.G_args.GRU_args.skip_connections", "1"],
        "flow": ["--model.flow", "4", "--model.flow_type", "alternating",
                 "--model.flow_mode", "posterior"],
        "deconv": ["--model.G_args.G_class", "deconv"],
        "deconv useRNN": ["--model.G_args.G_class", "deconv",
                          "--model.G_args.deconv_args.useRNN", "1"]}
    opt_stats = {}
    for tag, fl in opt_flags.items():
        slug = "smoke_opt_" + tag.replace(" ", "_")
        plain_gru0 = gru_ops.gru_scan.plain_runs
        cfg_o, l_o, s_o, ch_o = train_run(tag, train_flags(
            slug, UNROLL_ITERS, fl + ["--vae.cheaplog_every", "25",
                                      "--vae.expsvlog_every", "50"]))
        plain_gru = gru_ops.gru_scan.plain_runs - plain_gru0
        _, recon_o, _, _, model_o, params_o = check_train_outputs(
            tag, cfg_o, UNROLL_ITERS + 1)
        n_o = UNROLL_ITERS + 1
        # B2: the encoder's two directions, and the GRU decoder's scan;
        # B4: the same scans of the heldout eval's 4 batches at step 50
        n_gru = 2 + (model_o.G_class == "gru")
        want_o = {"B2 fwd": n_gru * n_o, "B2 bwd": n_gru * n_o,
                  "B2 wgrad": n_gru * n_o, "B4": 4 * n_gru, "B5 fwd": n_o,
                  "B5 bwd": 0}
        use_rnn = model_o.deconv_args.get("useRNN", False) and (
            model_o.G_class == "deconv")
        if (l_o != want_o or ch_o is None or ch_o[:2] != (2, 25)
                or (plain_gru > 0) != bool(use_rnn)):
            raise AssertionError(f"{tag} training: launches {l_o} (want "
                                 f"{want_o}), chunks {ch_o}, plain GRU "
                                 f"scans {plain_gru}")
        log(f"[10] {tag} phase-1 training, {n_o} steps: {s_o:.2f} s; "
            f"{ch_o[0]} replays of a {ch_o[1]}-step CUDA graph of {ch_o[2]} "
            f"kernel nodes; launches {l_o}; plain GRU scans {plain_gru}"
            + (f" (useRNN: H {model_o.emb_dim} > {gru_kernel.MAX_H})"
               if use_rnn else "")
            + f"; recon at the logs {[round(r, 4) for r in recon_o]}")
        step_vs_plain(tag, model_o, cfg_o, params_o)
        mark(f"10 {tag} training and one step vs plain")

        # the CLaSS main path: sample_pipeline's fused loop
        c_o, st_o = option_pipeline(tag, fl, model_o, params_o)
        n_r = st_o["rounds_launched"]
        route = ("B1" if model_o.flow else "replay beam"
                 if model_o.G_class == "deconv" else "plain beam")
        want_r = {k: (n_r if k == route else 0) for k in c_o}
        if c_o != want_r:
            raise AssertionError(f"{tag} CLaSS loop: beams {c_o}, want "
                                 f"{want_r} over {n_r} rounds")
        # one round's draws through the route and through plain=True
        draws = fused.round_draws(pipeline.round_generator(cfg_o.seed, 1,
                                                           dev),
                                  Q10._sampler()[1], 5000)
        one_o = dp_rounds.shards_of(params_o)
        r_k = fused.fused_round(model_o, one_o, draws, Q10)
        r_p = fused.fused_round(model_o, one_o, draws, Q10, plain=True)
        same = (r_k[3] == r_p[3]).all(dim=1).float().mean().item()
        if not torch.equal(r_k[2], r_p[2]) or same < MIN_SAME_ROWS:
            raise AssertionError(f"{tag}: the round's route and plain=True "
                                 f"differ ({same:.4f} rows identical)")
        ts = []
        for _ in range(OPT_ROUND_REPS):
            t0 = time.perf_counter()
            fused.fused_round(model_o, one_o, draws, Q10)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        round_ms_o = statistics.median(ts)
        extra_o = ""
        if model_o.skip_connections:
            # the plain beam on the card against the CPU's on 256 latents
            cpu_p = checkpoints.unflatten({
                k: v.cpu() for k, v in checkpoints.flatten(params_o).items()})
            z_s = r_k[0][:256]
            cs_s = [model_o.c_from_bits(draws.cbit[:256]).cpu()]
            tk_c, _ = pipeline.decode_top1(z_s, model_o, one_o, chunk=256,
                                           cs=cs_s)
            tk_h, _ = pipeline.decode_top1(z_s.cpu(), model_o,
                                           dp_rounds.shards_of(cpu_p),
                                           chunk=256, cs=cs_s)
            same_cpu = float((tk_c == tk_h).all(axis=1).mean())
            if same_cpu < MIN_SAME_ROWS:
                raise AssertionError(f"skip: the card's plain beam and the "
                                     f"CPU's agree on {same_cpu:.4f} rows")
            extra_o = (f"; the card's plain beam vs the CPU's on 256 "
                       f"latents: {same_cpu:.6f} rows identical")
        log(f"[10] {tag} sample_pipeline (fused, rounds of 5000, until one "
            f"accepted): {n_r} round(s) launched, beams {c_o}, loop "
            f"{st_o['seconds']:.4f} s; one round's draws through the route "
            f"and plain=True: accept masks identical, {same:.6f} token rows "
            f"identical{extra_o}; a decode-all round of 5000 "
            f"{round_ms_o:.3f} ms (median of {OPT_ROUND_REPS}, host clock) "
            f"({card})")
        mark(f"10 {tag} CLaSS rounds")
        opt_stats[tag] = {"train": (l_o, s_o, ch_o),
                          "rounds": (c_o, st_o, round_ms_o),
                          "cfg": cfg_o, "model": model_o, "params": params_o}

    # the serial loop of the deconv model: chunks of 1,024, the last of a
    # round of 5,000 zero-padded from 904 rows, one replay beam a chunk
    od = opt_stats["deconv"]
    c_s, st_s = option_pipeline("deconv serial", opt_flags["deconv"],
                                   od["model"], od["params"], serial=True)
    n_s = st_s["rounds_launched"]
    want_s = {"B1": 0, "plain beam": 0, "replay beam": 5 * n_s}
    if c_s != want_s:
        raise AssertionError(f"deconv serial loop: beams {c_s}, want "
                             f"{want_s}")
    log(f"[10] deconv sample_pipeline --hw.fused_rounds 0: {n_s} round(s) "
        f"of 5000 in chunks of 1024 (the last padded), beams {c_s}, loop "
        f"{st_s['seconds']:.4f} s ({card})")
    # the deconv server: build_server on the run dir, the [5] corpus as its
    # states dump; one request
    cfg_sv, args_sv, _ = C.parse_and_finalize(
        train_flags("smoke_opt_deconv", UNROLL_ITERS, opt_flags["deconv"])
        + ["--n_samples_per_round", "5000", "--Q_n_components", "10"],
        extra_args=serve.EXTRA_ARGS)
    for split, st in states.items():
        n_rows = st["mu"].shape[0]
        build_index._write_states(
            build_index.states_path(cfg_sv.savepath, split,
                                    cfg_sv.vae.n_iter), cfg_sv,
            st["label"].shape[1],
            {"src": np.zeros((n_rows, cfg_sv.max_seq_len), np.int64),
             "z": st["mu"], "mu": st["mu"], "logvar": st["logvar"],
             "label": st["label"], "split": np.zeros((n_rows, 1), np.int64)})
    srv_d = serve.build_server(cfg_sv, args_sv, device=dev)
    reset_beam_counts()
    srv_d.start()
    try:
        t0 = time.perf_counter()
        rows_d = srv_d.generate(8, timeout=120)
        lat_d = time.perf_counter() - t0
    finally:
        srv_d.stop()
    c_sv = beam_counts()
    peps_d = [r["peptide"] for r in rows_d]
    if (len(peps_d) != 8 or len(set(peps_d)) != 8
            or c_sv != {"B1": 0, "plain beam": 0,
                        "replay beam": srv_d._round_ix}):
        raise AssertionError(f"the deconv server: {len(set(peps_d))} unique "
                             f"of {len(peps_d)} rows, beams {c_sv}, rounds "
                             f"{srv_d._round_ix}")
    log(f"[10] deconv GenerationServer (build_server on its run dir): one "
        f"request of 8 in {lat_d:.3f} s, {srv_d._round_ix} round(s), "
        f"beams {c_sv} ({card})")
    mark("10 deconv serial loop and server")

    # phase 2 of the skip model: B2 five times a step, as the GRU's in [9]
    os_ = opt_stats["skip"]
    cfg_p2, l_p2, s_p2, _, _, logged_p2, _ = full_run(
        "skip phase 2", os_["cfg"], "smoke_opt_skip_p2", 4,
        opt_flags["skip"], n1=UNROLL_ITERS)
    want_p2 = {"B2 fwd": 25, "B2 bwd": 25, "B2 wgrad": 25, "B4": 2,
               "B5 fwd": 0, "B5 bwd": 0}
    if l_p2 != want_p2:
        raise AssertionError(f"skip phase 2 launched {l_p2}, want {want_p2}")
    log(f"[10] skip main --phase 2 from its model_{UNROLL_ITERS}.npz, 5 "
        f"steps: {s_p2:.2f} s in main.main; launches {l_p2}; L_vae at the "
        f"logs {[round(r['full_L_vae'], 4) for r in logged_p2]} ({card})")
    mark("10 skip phase 2")
    # static_eval --long of the skip model: its dump (B4 in both directions
    # of each chunk), its index and diagnostics, and the battery, whose beam
    # decodes all take the plain beam (skip is outside B1's scope)
    se_opt, se_opt_counts, se_opt_s, _, _ = static_eval_run(
        "opt_skip", train_flags("smoke_opt_skip", UNROLL_ITERS,
                                opt_flags["skip"]))
    want_se_opt = dict.fromkeys(counts(), 0)
    want_se_opt.update({"B4": dump_b4 + battery_want["B4"], "B1": 0, "B3": 0,
                        "plain beam": battery_want["beam 5"]
                        + battery_want["beam 15"]})
    opt_dump = build_index.read_states(se_opt["states"]["train"])
    if (se_opt_counts != want_se_opt or opt_dump["mu"].shape != (
            static_eval.MAX_EXAMPLES, os_["cfg"].model.z_dim)
            or not os.path.exists(se_opt["index"])):
        raise AssertionError(f"static_eval --long of the skip model: "
                             f"launches {se_opt_counts} (want {want_se_opt}),"
                             f" dump {opt_dump['mu'].shape}, index "
                             f"{se_opt['index']}")
    log(f"[10] skip static_eval --long (dump of 10,000 rows a split, index, "
        f"diagnostics, battery): {se_opt_s:.2f} s; launches {se_opt_counts}"
        f"; dump seconds per split "
        f"{ {k: round(v, 3) for k, v in se_opt['seconds'].items()} }; "
        f"{diag_line(se_opt)} ({card})")
    mark("10 skip static_eval --long")
    opt_launches = {k: sum(v["train"][0][k] for v in opt_stats.values())
                    + l_p2[k] for k in l_p2}
    opt_b1 = opt_stats["flow"]["rounds"][0]["B1"]

    # ---- 11. data parallelism (ROADMAP A9 parts 1-3) ---------------------
    # NCCL refuses two ranks on one device, so on the one card: [11] and
    # [11z] run 2 ranks on cuda:0 over gloo (every step eager: gloo's
    # collectives cannot be captured), [11g] the chunk's captured
    # collectives under an NCCL group of world 1 through the DP path, [11r]
    # and [11s] the round and the server over the list [cuda:0, cuda:0].
    # Each rank is a process of parallel.dist.spawn running dp_rank_jobs;
    # the ranks report their counts, zeroed before each run and read after
    dp_dir = os.path.join(train_top, "dp")
    shutil.rmtree(dp_dir, ignore_errors=True)
    os.makedirs(dp_dir)
    dp_on = ["--device", f"cuda:{dev.index or 0}"]
    p2_from6 = ["--phase", "2", "--loadpath",
                tcfg.vae.chkpt_path.format(TRAIN_ITERS)]
    gloo_jobs = {
        "GRU": train_flags("dp_gru", DP_ITERS, [
            "--vae.cheaplog_every", "10", "--vae.expsvlog_every",
            str(DP_ITERS), "--hw.unroll", "1"]),
        "transformer": train_flags("dp_tfm", DP_ITERS_T, TFM_FLAGS + [
            "--vae.cheaplog_every", "5", "--vae.expsvlog_every",
            str(DP_ITERS_T), "--hw.unroll", "1"]),
        "GRU phase 2": train_flags("dp_p2", TRAIN_ITERS) + p2_from6 + [
            "--full.n_iter", str(DP_ITERS_T), "--full.cheaplog_every", "5",
            "--full.expsvlog_every", str(DP_ITERS_T), "--hw.unroll", "1"]}
    gloo_jobs["GRU ZeRO-1"] = [
        "dp_zero" if a == "dp_gru" else a
        for a in gloo_jobs["GRU"]] + ["--hw.zero", "1"]

    def rank_results(world, backend, jobs):
        out_dir = os.path.join(dp_dir, f"{backend}{world}")
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        pdist.spawn(dp_rank_jobs, world,
                    [(k, v + ["--hw.dp", "0"] + dp_on)
                     for k, v in jobs.items()], out_dir, backend=backend,
                    threads=0)
        secs = time.perf_counter() - t0
        res = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                res.append(json.load(fh))
        return res, secs

    gloo, gloo_s = rank_results(2, "gloo", gloo_jobs)
    mark("11 two gloo ranks on the card (spawn and runs)")
    one_runs = {}
    for tag in ("GRU", "transformer", "GRU phase 2"):
        flags_1 = [a + "_1" if a in ("dp_gru", "dp_tfm", "dp_p2") else a
                   for a in gloo_jobs[tag]] + ["--hw.dp", "1"]
        one_runs[tag] = train_run(f"{tag} dp 1", flags_1)
    mark("11 the one-rank runs of the same flags")

    b2_keys = ("B2 fwd", "B2 bwd", "B2 wgrad", "B5 fwd", "B5 bwd")
    dp_counts = []
    for tag, job in gloo_jobs.items():
        ref_tag = "GRU" if tag == "GRU ZeRO-1" else tag
        cfg_1, counts_1, secs_1, _ = one_runs[ref_tag]
        cfg_2, _, _ = C.parse_and_finalize(job)
        phase2 = "phase 2" in tag
        last = (cfg_1.full.s_iter + DP_ITERS_T if phase2
                else cfg_1.vae.n_iter)
        path_2 = (cfg_2.full if phase2 else cfg_2.vae).chkpt_path.format(last)
        path_1 = (cfg_1.full if phase2 else cfg_1.vae).chkpt_path.format(last)
        rel, key, bitwise = state_delta(path_2, path_1)
        outside = outside_bounds(path_2, path_1, cfg_1,
                                 last - (cfg_1.full.s_iter if phase2 else 0)
                                 + 1)
        loss_rel = losses_delta(cfg_2, cfg_1, "full_" if phase2 else "train_")
        per_rank = [g[tag]["counts"] for g in gloo]
        dp_counts += per_rank
        bad_counts = [r for r, c in enumerate(per_rank)
                      if any(c[k] != counts_1[k] for k in b2_keys)]
        log(f"[11{'z' if 'ZeRO' in tag else ''}] {tag}: main.main --hw.dp 2 "
            f"on 2 gloo ranks on {dp_on[1]} (batch 32, 16 rows a rank, every "
            f"step eager) against --hw.dp 1 of the same flags: "
            f"model_{last}.npz "
            f"largest difference {rel:.3e} of the array's largest entry "
            f"({key}), bitwise {'equal' if bitwise else 'different'}, "
            f"arrays outside rtol {DP_RTOL} / atol {DP_ATOL} (the keys' "
            f"bias within 2 lr a step): {outside}; "
            f"logged losses within {loss_rel:.3e}; launches per rank "
            f"{per_rank} against --hw.dp 1's {counts_1}; "
            f"{[round(g[tag]['seconds'], 2) for g in gloo]} s a rank against "
            f"{secs_1:.2f} s in main.main ({card})")
        if outside or loss_rel > DP_LOSS_RTOL or bad_counts:
            raise AssertionError(f"[11] {tag}: the DP run against --hw.dp "
                                 f"1: arrays {outside}, losses "
                                 f"{loss_rel:.3e}, ranks {bad_counts} with "
                                 f"other B2/B5 launches")
    # steps/s of the GRU phase-1 runs, 2 gloo ranks against 1 rank, both
    # every step eager: the host staging of gloo's collectives
    rates = {}
    for tag, cfg_ in (("dp 2", C.parse_and_finalize(gloo_jobs["GRU"])[0]),
                      ("dp 1", one_runs["GRU"][0])):
        with open(os.path.join(cfg_.savepath, "result.json")) as fh:
            rates[tag] = [r["train_steps_per_sec_warm"] for r in json.load(fh)
                          if "train_steps_per_sec_warm" in r][-1]
    log(f"[11] GRU phase 1, {DP_ITERS + 1} steps every step eager: "
        f"{rates['dp 2']:.2f} steps/s on 2 gloo ranks of one card against "
        f"{rates['dp 1']:.2f} at --hw.dp 1; {gloo_s:.1f} s for the spawn "
        f"and the ranks' four runs ({card})")
    mark("11 checks")

    # [11g]: an NCCL group of world 1 through the DP path (hw.dp 0 under a
    # group): the chunk's graph holds the collectives, against phase 6's
    # and 9u's runs of the same flags without a group
    trace_nccl = os.path.join(train_top, "trace_nccl")
    shutil.rmtree(trace_nccl, ignore_errors=True)
    p2_50 = train_flags("p2u50_GRU", TRAIN_ITERS) + p2_from6 + [
        "--full.n_iter", "50", "--full.cheaplog_every", "50",
        "--full.expsvlog_every", "50"]
    nccl_jobs = {
        "GRU phase 1": train_flags("smoke_nccl", TRAIN_ITERS),
        "GRU phase 2": ["p2u50_GRU_nccl" if a == "p2u50_GRU" else a
                        for a in p2_50],
        "GRU traced": train_flags("smoke_trace_nccl", 100, [
            "--vae.cheaplog_every", "25", "--vae.expsvlog_every", "25",
            "--hw.profile_dir", trace_nccl])}
    (nccl,), nccl_s = rank_results(1, "nccl", nccl_jobs)
    mark("11g an NCCL group of world 1 (spawn and runs)")
    cfg_9u = C.parse_and_finalize(p2_50)[0]
    for tag, cfg_ref, counts_ref, want_ch in (
            ("GRU phase 1", tcfg, train_launches, (TRAIN_ITERS // 50, 50)),
            ("GRU phase 2", cfg_9u, full_u50["GRU"][0], (1, 50))):
        cfg_n, _, _ = C.parse_and_finalize(nccl_jobs[tag])
        phase2 = "2" in tag
        last = (cfg_n.full.s_iter + 50) if phase2 else TRAIN_ITERS
        rel, key, bitwise = state_delta(
            (cfg_n.full if phase2 else cfg_n.vae).chkpt_path.format(last),
            (cfg_ref.full if phase2 else cfg_ref.vae).chkpt_path.format(last))
        res = nccl[tag]
        st, ch = res["graph"], res["chunks"]
        if (ch is None or tuple(ch[:2]) != want_ch or not st
                or not st["collective_nodes"] or rel > MAX_UNROLL_REL
                or any(res["counts"][k] != counts_ref[k] for k in b2_keys)):
            raise AssertionError(f"[11g] {tag}: chunks {ch} (want "
                                 f"{want_ch}), graph {st}, model_{last}.npz "
                                 f"{key} apart by {rel:.3e}, launches "
                                 f"{res['counts']} (want {counts_ref})")
        log(f"[11g] {tag}: main.main --hw.dp 0 under an NCCL group of world "
            f"1 (the DP path): {ch[0]} replays of a {ch[1]}-step CUDA graph "
            f"of {ch[2]} kernel nodes, {st['collective_nodes']} of them "
            f"NCCL's ({st['collective_nodes'] / ch[1]:.0f} a step), "
            f"{st['memcpy_nodes']} copy nodes, {st['nodes']} nodes; capture "
            f"{st['capture_s']:.3f} s; against the same flags without a "
            f"group: model_{last}.npz largest difference {rel:.3e} ({key}), "
            f"bitwise {'equal' if bitwise else 'different'}; launches "
            f"{res['counts']}; {res['seconds']:.2f} s in main.main ({card})")
        dp_counts.append(res["counts"])
    rates_g = {}
    for tag, cfg_ in (("nccl", C.parse_and_finalize(
            nccl_jobs["GRU phase 1"])[0]), ("none", tcfg)):
        with open(os.path.join(cfg_.savepath, "result.json")) as fh:
            rates_g[tag] = [r["train_steps_per_sec_warm"]
                            for r in json.load(fh)
                            if "train_steps_per_sec_warm" in r][-1]
    traces_n = [os.path.join(trace_nccl, f) for f in os.listdir(trace_nccl)
                if f.endswith(".pt.trace.json")]
    with open(traces_n[0]) as fh:
        k_ev = [e for e in json.load(fh)["traceEvents"]
                if e.get("cat") == "kernel"]
    coll_us = sum(e.get("dur", 0) for e in k_ev
                  if runtime.is_collective(e.get("name", "")))
    all_us = sum(e.get("dur", 0) for e in k_ev)
    n_coll = sum(runtime.is_collective(e.get("name", "")) for e in k_ev)
    if not n_coll or len(traces_n) != 1:
        raise AssertionError(f"[11g] the traced DP run: {len(traces_n)} "
                             f"traces, {n_coll} NCCL kernels in it")
    log(f"[11g] GRU phase 1 at --hw.unroll 50, cadences 100 / 150: "
        f"{rates_g['nccl']:.2f} steps/s (warm) through the DP path under "
        f"NCCL world 1 against {rates_g['none']:.2f} without a group "
        f"(phase 6); the traced DP run (101 steps, its bounded window the "
        f"last two replays of a 25-step graph): {n_coll} NCCL kernels, {coll_us:.1f} us of {all_us:.1f} "
        f"us of kernel time ({100 * coll_us / max(all_us, 1e-9):.2f}%); "
        f"{nccl_s:.1f} s for the spawn and the rank's three runs ({card})")
    mark("11g checks")

    # [11r]: the sharded round over [cuda:0, cuda:0] against the one-device
    # round on the same draws, and run_from_states over that list
    two = [dev, dev]
    dp_rounds_launches = {"B1": 0, "B3": 0}
    round_ms_dp = {}
    for tag, cfg_r, model_r, params_r, counter, kkey in (
            ("GRU", cfg, model, params, beam_kernel.beam_scan_gru, "B1"),
            ("transformer", cfg_t5, model_t3, params_t3,
             tfm_beam_kernel.beam_scan_tfm, "B3")):
        Q = pipeline.fitQ_and_test(
            cfg_r, pipeline.resolve_QClass("mogQ"),
            {"n_components": 100, "z_num_samples": 10,
             "covariance_type": "diag"}, states, device=dev)[0]
        Q.init_attr_classifiers(
            {a: pipeline.build_clfZ(cfg_r, a, states, device=dev)
             for a in ("amp", "tox")}, {"amp": 1, "tox": 0})
        two_r = dp_rounds.shards_of(params_r, two)
        one_r = dp_rounds.shards_of(params_r)
        draws = fused.round_draws(pipeline.round_generator(cfg_r.seed, 1,
                                                           dev),
                                  Q._sampler()[1], 5000)
        for cap in (None, 2500):
            one_dev = fused.fused_round(model_r, one_r, draws, Q,
                                        capacity=cap)
            counter.launches = 0
            shd = fused.fused_round(model_r, two_r, draws, Q, capacity=cap)
            n_l = counter.launches
            same = [torch.equal(a, b) for a, b in zip(
                (shd[2], shd[3]) + tuple(shd[4:]),
                (one_dev[2], one_dev[3]) + tuple(one_dev[4:]))]
            z_d = (shd[0] - one_dev[0]).abs().max().item()
            s_d = max((shd[1][k] - v).abs().max().item()
                      for k, v in one_dev[1].items())
            log(f"[11r] {tag} round of 5000, capacity {cap}, over "
                f"[{dp_on[1]}, {dp_on[1]}] against one device on the same "
                f"draws: "
                f"accept, tokens{', idx, valid' if cap else ''} bitwise "
                f"{'equal' if all(same) else 'DIFFERENT'}; z max |delta| "
                f"{z_d:.3e}, scores {s_d:.3e}; {kkey} launches {n_l}")
            if not all(same) or n_l != 2:
                raise AssertionError(f"[11r] {tag} capacity {cap}: equal "
                                     f"{same}, launches {n_l} (want 2)")

            def timed(fn):
                fn()
                ts = []
                for _ in range(ROUND_REPS):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ts.append(1e3 * (time.perf_counter() - t0))
                return statistics.median(ts)
            round_ms_dp[tag, cap] = (
                timed(lambda: fused.fused_round(model_r, two_r, draws, Q,
                                                capacity=cap)),
                timed(lambda: fused.fused_round(model_r, one_r, draws, Q,
                                                capacity=cap)))
        for mode in ("all", "accepted"):
            cfg_m, args_m, _ = C.parse_and_finalize(
                (flags if tag == "GRU" else tflags_t) + [
                    "--hw.decode_mode", mode, "--Q_n_components", "100",
                    "--Q_covariance_type", "diag", "--n_samples_per_round",
                    "5000", "--n_samples_acc", "100",
                    "--samples_outfn_prefix", f"smoke_dp_{mode}"],
                extra_args=sample_pipeline.EXTRA_ARGS)
            counter.launches = 0
            _, samples_m, stats_m = pipeline.run_from_states(
                cfg_m, args_m, model_r, params_r, vocab, states, device=dev,
                devices=two)
            n_l = counter.launches
            peps = samples_m["peptide"]
            n_acc = len({p for p, a in zip(peps, samples_m["accept"]) if a})
            if n_l != 2 * stats_m["rounds_launched"] or n_acc < 100:
                raise AssertionError(f"[11r] {tag} {mode}: {n_l} launches "
                                     f"for {stats_m['rounds_launched']} "
                                     f"rounds, {n_acc} accepted")
            dp_rounds_launches[kkey] += n_l
            log(f"[11r] {tag} run_from_states over [{dp_on[1]}, {dp_on[1]}], "
                f"decode_mode={mode}: {stats_m['rounds_launched']} rounds "
                f"launched, {kkey} launches {n_l} (one a device a round), "
                f"{n_acc} unique accepted, loop {stats_m['seconds']:.4f} s")
        mark(f"11r {tag} sharded rounds")
    log("[11r] a round of 5000 on one card, median of "
        f"{ROUND_REPS} (host clock), sharded over [{dp_on[1]}, {dp_on[1]}] "
        f"against "
        "one device: " + ", ".join(
            f"{t} capacity {c}: {a:.3f} ms against {b:.3f} ms"
            for (t, c), (a, b) in round_ms_dp.items()) + f" ({card})")

    # [11s]: the server on the same two-entry list
    srv_dp = serve.build_server(cfg_8, args_8, device=dev, devices=two)
    beam_kernel.beam_scan_gru.launches = 0
    srv_dp.start()
    try:
        t0 = time.perf_counter()
        rows_dp = srv_dp.generate(64, timeout=300)
        lat_dp = time.perf_counter() - t0
    finally:
        srv_dp.stop()
    n_l = beam_kernel.beam_scan_gru.launches
    peps_dp = [r["peptide"] for r in rows_dp]
    if (len(set(peps_dp)) != 64 or n_l != 2 * srv_dp._round_ix
            or srv_dp.n_dev != 2):
        raise AssertionError(f"[11s] the server over two devices: "
                             f"{len(set(peps_dp))} unique of 64, B1 "
                             f"launches {n_l} for {srv_dp._round_ix} rounds")
    dp_rounds_launches["B1"] += n_l
    log(f"[11s] GenerationServer on the phase-6 run over [{dp_on[1]}, "
        f"{dp_on[1]}]: one request of 64 unique peptides in {lat_dp:.3f} s, "
        f"{srv_dp._round_ix} round(s), B1 launches {n_l} ({card})")
    mark("11s the server over two devices")
    dp_launches = {k: sum(c[k] for c in dp_counts) for k in dp_counts[0]}
    dp_launches.update(dp_rounds_launches)

    # ---- 12. tensor and pipeline parallelism (ROADMAP A9 part 4) ---------
    mp_counts = mp_phase(train_flags, train_top, dev, card)
    mp_launches = {k: sum(c[k] for c in mp_counts) for k in mp_counts[0]}
    mark("12 tensor and pipeline parallelism")

    # ---- 13. the data path (curation, the native tokenizer) and B2 in bf16
    d13 = data_bf16_phase(dev, card, cuda_ms, train_top)
    d13["tok_build_s"] = native_s
    mark("13 curation, tokenizer, curated training, B2 bf16")

    # ---- B4 and B5 timings --------------------------------------------------
    b4_times = {}
    # the decoder's width; B 512 at the encoder's, the dump's chunk
    for B, (I, H_) in ((32, B2_WIDTHS[1]), (1024, B2_WIDTHS[1]),
                       (20000, B2_WIDTHS[1]),
                       (build_index.CHUNK, B2_WIDTHS[0])):
        p = gru_ops.init_gru_params(gb, I, H_, dev)
        xs = torch.randn((B, T, I), generator=gb, device=dev)
        h0 = 0.5 * torch.randn((B, H_), generator=gb, device=dev)
        gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1)
        cudnn = torch.nn.GRU(I, H_, batch_first=True).to(dev)
        with torch.no_grad():
            for name, src in (("weight_ih_l0", p["wi"].T),
                              ("weight_hh_l0", p["wh"].T),
                              ("bias_ih_l0", p["bi"]),
                              ("bias_hh_l0", p["bh"])):
                getattr(cudnn, name).copy_(src)
            lib_delta = (cudnn(xs, h0[None])[0]
                         - gru_ops.gru_scan(p, xs, h0)[0]).abs().max().item()

            def no_grad(fn):
                def run():
                    with torch.no_grad():
                        fn()
                return run

            b4_times[B] = {
                "kernel": cuda_ms(lambda: gru_fwd_kernel.gru_fwd(
                    p["wh"], p["bh"], gi, h0), 50 if B < 20000 else 10),
                "plain": cuda_ms(lambda: gru_fwd_kernel.gru_fwd_reference(
                    p["wh"], p["bh"], gi, h0), 5),
                "bound": b4_bound_ms(T, B, H_),
                "cudnn_fwd": cuda_ms(no_grad(lambda: cudnn(xs, h0[None])),
                                     20 if B < 20000 else 5),
                "scan_fwd": cuda_ms(no_grad(lambda: gru_ops.gru_scan(
                    p, xs, h0)), 20 if B < 20000 else 5),
                "cudnn_delta": lib_delta, "I": I, "H": H_}
        del xs, gi, cudnn
    b5_times = {}
    for N in B5_TIMED_NS:
        z1 = 0.8 * torch.randn((N, 100), generator=gb, device=dev) + 0.1
        z2 = torch.randn((N, 100), generator=gb, device=dev)
        b5_times[N] = {
            "fwd": (cuda_ms(lambda: mmd_kernel.mmd_full_fwd(z1, z2, 7.0),
                            50),
                    cuda_ms(lambda: mmd_kernel.mmd_full_reference(z1, z2,
                                                                  7.0), 5),
                    b5_bound_ms("fwd", N, 100)),
            "bwd": (cuda_ms(lambda: mmd_kernel.mmd_full_bwd(z1, z2, one,
                                                            7.0), 50),
                    cuda_ms(lambda: mmd_kernel.mmd_full_bwd_reference(
                        z1, z2, 7.0), 5),
                    b5_bound_ms("bwd", N, 100)),
            "plan": mmd_kernel.grad_plan(N, 100)}
        del z1, z2
    mark("7a B4 and B5 timings")

    # ---- 7. report --------------------------------------------------------
    for B, (k_ms, p_ms, (b_ms, _)) in times.items():
        log(f"[7] beam scan B={B}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({card})")
    for B, (k_ms, p_ms, (b_ms, b_by)) in b3_times.items():
        log(f"[7] B3 transformer beam scan B={B}: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) ({card})")
    for (tag, B), (k_ms, p_ms, (b_ms, b_by)) in bf16_times.items():
        fp32_ms = (times if tag == "B1" else b3_times)[B][0]
        log(f"[7] {tag} bf16 beam scan B={B}: kernel {k_ms:.4f} ms "
            f"({k_ms / fp32_ms:.3f}x the fp32 kernel's {fp32_ms:.4f} ms), "
            f"plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}, the bf16 "
            f"tensor-core rate) ({card})")
    for tag, loop_, round_ms_ in (("GRU", loop, round_ms),
                                  ("transformer", loop_t, round_ms_t),
                                  *((t_, v_[1], v_[2])
                                    for t_, v_ in bf16_runs.items())):
        for mode in ("all", "accepted"):
            st = loop_[mode]
            q1, med, q3 = round_ms_[mode]
            log(f"[7] {tag} round of 5000 candidates, decode_mode={mode}: "
                f"{med:.3f} ms (median of {ROUND_REPS}, quartiles "
                f"{q1:.3f}-{q3:.3f}, host clock) ({card}); loop "
                f"{st['seconds']:.4f} s over {st['rounds']} consumed "
                f"round(s), {st['rounds_launched']} launched: too short a "
                f"window for an accepted-samples/s metric")
    for (H_, B), t in b2_times.items():
        lib = t["library"]
        I = dict((h, i) for i, h in B2_WIDTHS)[H_]
        # each kernel against its yardstick in this call: cuDNN's forward
        # (with the projection), cuDNN's data gradient (input and h0 only),
        # one torch.mm
        yard = {"fwd": ("cuDNN forward", lib["cudnn_fwd"]),
                "fwd_nores": ("cuDNN forward", lib["cudnn_fwd"]),
                "bwd": ("cuDNN's data backward", lib["cudnn_bwd_data"]),
                "wgrad": ("torch.mm", lib["wgrad_mm"])}
        what = {"fwd": "training forward (with its residual stores)",
                "fwd_nores": "B4, the scan without residual stores",
                "bwd": "backward recurrence", "wgrad": "weight gradient"}
        per_step = 2 if H_ == B2_WIDTHS[0][1] else 1
        for k in ("fwd", "fwd_nores", "bwd", "wgrad"):
            k_ms, p_ms, (b_ms, b_by) = t[k]
            y_name, y_ms = yard[k]
            log(f"[7] B2 {k}, {what[k]}, at B {B}, T {T}, H {H_}: kernel "
                f"{k_ms:.4f} ms"
                + (f" ({1e3 * k_ms / T:.3f} us per step)" if k != "wgrad"
                   else "")
                + f", plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), "
                f"{k_ms / y_ms:.3f}x {y_name} ({y_ms:.4f} ms); launches per "
                f"GRU train step at this width "
                f"{0 if k == 'fwd_nores' else per_step} ({card})")
        log(f"[7] B2 fwd + bwd pair at B {B}, T {T}, H {H_}: kernels "
            f"{t['fwd'][0] + t['bwd'][0]:.4f} ms, bound "
            f"{t['fwd'][2][0] + t['bwd'][2][0]:.6f} ms (the forward's bound "
            f"counts its residual stores, the backward's no gate "
            f"recompute) ({card})")
        log(f"[7] B2 at B {B}, in {I}, H {H_}, T {T}, with the input "
            f"projection: torch.nn.GRU (cuDNN) forward "
            f"{lib['cudnn_fwd']:.4f} ms, backward (input and all weights) "
            f"{lib['cudnn_bwd']:.4f} ms, data backward (input and h0 only) "
            f"{lib['cudnn_bwd_data']:.4f} ms, forward+backward "
            f"{lib['cudnn_fwd_bwd']:.4f} ms; the port's gru_scan forward "
            f"{lib['scan_fwd']:.4f} ms, backward {lib['scan_bwd']:.4f} ms, "
            f"forward+backward {lib['scan_fwd_bwd']:.4f} ms; max |hs delta| "
            f"cuDNN vs gru_scan {lib['cudnn_vs_scan_delta']:.3e} ({card})")
        log(f"[7] B2 wgrad at B {B}, H {H_} as one cuBLAS product, torch.mm "
            f"of [h_(t-1) | 1]^T [{T * B}, {H_ + 1}] by dgh "
            f"[{T * B}, {3 * H_}] on prebuilt operands: "
            f"{lib['wgrad_mm']:.4f} ms (the kernel {t['wgrad'][0]:.4f} ms "
            f"also gathers its operands); max |delta| against the kernel "
            f"{lib['wgrad_mm_delta']:.3e} ({card})")
    # launches x (time - bound) of a GRU train step at batch 32: the
    # encoder's two directions at H 80, the decoder at H 102
    loss_us = {k: sum(n * (b2_times[h, 32][k][0] - b2_times[h, 32][k][2][0])
                      for h, n in ((B2_WIDTHS[0][1], 2), (B2_WIDTHS[1][1], 1)))
               * 1e3 for k in ("fwd", "bwd", "wgrad")}
    log("[7] B2 per GRU train step at batch 32, launches x (time - bound), "
        "two launches at H 80 and one at H 102: " + ", ".join(
            f"{k} {v:.2f} us" for k, v in loss_us.items()) + f" ({card})")
    for B, t in b4_times.items():
        b_ms, b_by = t["bound"]
        I, H_ = t["I"], t["H"]
        log(f"[7] B4 forward-only scan at B {B}, T {T}, H {H_}: kernel "
            f"{t['kernel']:.4f} ms ({1e3 * t['kernel'] / T:.3f} us per "
            f"step, {t['kernel'] / t['cudnn_fwd']:.3f}x cuDNN's forward), "
            f"plain {t['plain']:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}); with the input projection (in {I}): "
            f"torch.nn.GRU (cuDNN) forward {t['cudnn_fwd']:.4f} ms, the "
            f"port's gru_scan without autograd {t['scan_fwd']:.4f} ms, max "
            f"|hs delta| {t['cudnn_delta']:.3e} ({card})")
    for N, t in b5_times.items():
        for k in ("fwd", "bwd"):
            k_ms, p_ms, (b_ms, b_by) = t[k]
            log(f"[7] B5 {k} (gaussian) at N {N}, D 100: kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.6f} ms "
                f"({b_by}), {k_ms / b_ms:.1f}x its bound"
                + (f"; plan {t['plan']}" if k == "bwd" else "")
                + (f"; the earlier kernel (one thread a feature, fp64) "
                   f"{B5_BWD_BEFORE_MS[N]:.4f} ms as recorded before its "
                   f"replacement (NVIDIA H100 80GB HBM3, 700.00 W)"
                   if k == "bwd" and N in B5_BWD_BEFORE_MS else "")
                + f"; no single PyTorch call computes it ({card})")
    for tag, tcfg_, rows_ in (("GRU", tcfg, rows),
                              ("transformer", tcfg_t, rows_t)):
        fin = rows_[-1]
        with open(os.path.join(unroll1_runs[tag][0].savepath,
                               "result.json")) as fh:
            fin_1 = json.load(fh)[-1]
        log(f"[7] {tag} phase-1 training at the shipped width, batch "
            f"{tcfg_.vae.batch_size}, --hw.unroll 50 (the default): "
            f"{fin['train_steps_per_sec_warm']:.2f} steps/s from the first "
            f"chunk boundary after {train_vae.WARM_STEPS} steps, "
            f"{fin['train_steps_per_sec']:.2f} steps/s over all {n_steps}; "
            f"--hw.unroll 1: {fin_1['train_steps_per_sec_warm']:.2f} after "
            f"{train_vae.WARM_STEPS}, {fin_1['train_steps_per_sec']:.2f} over "
            f"all (host clock, log and checkpoint boundaries included) "
            f"({card})")
    for tag, (cfg9, l9, s9, fin9, n9, check, _, ch9) in full_stats.items():
        pr = check[4]
        log(f"[7] {tag} phase-2 training at the shipped width, batch "
            f"{cfg9.vae.batch_size}, "
            + (f"{ch9[1]}-step graphs" if ch9 else "one step at a time")
            + ": "
            f"{fin9['full_steps_per_sec_warm']:.2f} steps/s after "
            f"{train_vae.WARM_STEPS} steps, {fin9['full_steps_per_sec']:.2f} "
            f"over all {n9} (host clock, logs and checkpoints included); B2 "
            f"{l9['B2 fwd'] / n9:.2f} forward, {l9['B2 bwd'] / n9:.2f} "
            f"backward and {l9['B2 wgrad'] / n9:.2f} weight-gradient launches "
            f"a step; {pr['events_per_step']:.1f} device events a step, busy "
            f"{pr['busy_ms_per_step']:.4f} ms, idle share "
            f"{pr['idle_share']:.4f} ({card})")
    for tag, (l_c, s_c, s_1, ch_c, st) in full_u.items():
        log(f"[7] {tag} phase-2 training, [9u]'s steps: {s_c:.2f} s at the "
            f"default --hw.unroll ({ch_c[1]}-step graphs, the capture "
            f"{st['capture_s']:.3f} s and instantiation "
            f"{st['instantiate_s']:.3f} s included) against {s_1:.2f} s at "
            f"--hw.unroll 1, in main.main ({card})")
    for tag, (l_50, s_50, st) in full_u50.items():
        log(f"[7] {tag} phase-2 chunk of 50 steps: capture "
            f"{st['capture_s']:.3f} s, instantiate {st['instantiate_s']:.3f}"
            f" s, {st['kernel_nodes']} kernel nodes, graph pool "
            f"{st['pool_bytes'] / 2 ** 20:.1f} MiB, executable "
            f"{st['exec_bytes'] / 2 ** 20:.1f} MiB ({card})")
    for tag, (l_x, s_x, ch_x) in mixed_stats.items():
        log(f"[7] {tag} phase-1 training, {UNROLL_ITERS + 1} steps at "
            f"--hw.unroll 50 at cadences 25 / 50 ({ch_x[2]} kernel nodes a "
            f"25-step graph): "
            f"{s_x:.2f} s in main.main, capture and checkpoint included "
            f"({card})")
    for tag, st in opt_stats.items():
        l_o, s_o, ch_o = st["train"]
        c_o, st_o, round_ms_o = st["rounds"]
        log(f"[7] {tag} phase-1 training, {UNROLL_ITERS + 1} steps at "
            f"--hw.unroll 50 at cadences 25 / 50 ({ch_o[2]} kernel nodes a "
            f"25-step graph): {s_o:.2f} s in main.main, capture and "
            f"checkpoint included; a decode-all round of 5000 "
            f"{round_ms_o:.3f} ms (median of {OPT_ROUND_REPS}, host clock); "
            f"its sample_pipeline loop {st_o['seconds']:.4f} s over "
            f"{st_o['rounds_launched']} round(s) launched ({card})")
    l9g = full_stats["GRU"][1]
    mix_l = ([v[0] for v in mixed_stats.values()]
             + [v[0] for v in full_u.values()]
             + [v[0] for v in full_u50.values()] + [l_tr])
    k_ms, p_ms, (b_ms, b_by) = times[5000]
    entries = [{
        "name": "beam_scan_gru",
        "route": "cuda",
        "source": "controlled_peptide_generation_tpu_torch/csrc/beam_gru.cu",
        "replaces": "controlled_peptide_generation_tpu/ops/pallas_beam.py:285",
        "launches": (launches["all"] + launches["accepted"]
                     + se_counts["B1"] + se_counts2["B1"]
                     + serial_runs["GRU"][1] + serve_launches + opt_b1
                     + dp_launches["B1"]),
        "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]
    t32 = b2_times[B2_WIDTHS[1][1], 32]
    for k, replaces, lib_ms in (
            ("fwd", "pallas_gru.py:283", t32["library"]["cudnn_fwd"]),
            ("bwd", "pallas_gru.py:312", t32["library"]["cudnn_bwd_data"]),
            ("wgrad", "pallas_gru.py:206", t32["library"]["wgrad_mm"])):
        k_ms, p_ms, (b_ms, b_by) = t32[k]
        entries.append({
            "name": f"gru_seq_{k}", "route": "cuda",
            "source": "controlled_peptide_generation_tpu_torch/csrc/"
                      "gru_seq.cu",
            "replaces": f"controlled_peptide_generation_tpu/ops/{replaces}",
            "launches": (train_launches[f"B2 {k}"] + l9g[f"B2 {k}"]
                         + l9m[f"B2 {k}"]
                         + sum(m_[f"B2 {k}"] for m_ in mix_l)
                         + opt_launches[f"B2 {k}"] + dp_launches[f"B2 {k}"]
                         + mp_launches[f"B2 {k}"]
                         + d13["train"][0][f"B2 {k}"]),
            "max_abs_err": b2_err[k],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms})
    k_ms, p_ms, (b_ms, b_by) = b3_times[5000]
    entries.append({
        "name": "beam_scan_tfm",
        "route": "cuda",
        "source": "controlled_peptide_generation_tpu_torch/csrc/tfm_beam.cu",
        "replaces":
            "controlled_peptide_generation_tpu/ops/pallas_tfm_beam.py:395",
        "launches": (launches_t["all"] + launches_t["accepted"]
                     + se_counts_t["B3"] + serial_runs["transformer"][1]
                     + serve_launches_t + dp_launches["B3"]),
        "max_abs_err": b3_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None})
    t4 = b4_times[32]
    entries.append({
        "name": "gru_scan_fwd",
        "route": "cuda",
        "source": "controlled_peptide_generation_tpu_torch/csrc/gru_seq.cu",
        "replaces":
            "controlled_peptide_generation_tpu/ops/pallas_kernels.py:72",
        "launches": (train_launches["B4"] + enc_launches + se_counts["B4"]
                     + se_counts2["B4"] + se_opt_counts["B4"] + l9g["B4"]
                     + l9m["B4"]
                     + sum(m_["B4"] for m_ in mix_l) + opt_launches["B4"]
                     + dp_launches["B4"] + mp_launches["B4"]
                     + d13["train"][0]["B4"]),
        "max_abs_err": b4_err,
        "ms": t4["kernel"], "plain_ms": t4["plain"],
        "bound_ms": t4["bound"][0], "bound_by": t4["bound"][1],
        "library_ms": t4["cudnn_fwd"]})
    for k, n_launch in (("fwd", train_launches["B5 fwd"]
                         + tfm_launches["B5 fwd"] + mmd_launches["B5 fwd"]
                         + l9m["B5 fwd"] + sum(m_["B5 fwd"] for m_ in mix_l)
                         + opt_launches["B5 fwd"] + dp_launches["B5 fwd"]
                         + mp_launches["B5 fwd"] + d13["train"][0]["B5 fwd"]),
                        ("bwd", mmd_launches["B5 bwd"] + l9m["B5 bwd"]
                         + sum(m_["B5 bwd"] for m_ in mix_l)
                         + dp_launches["B5 bwd"] + mp_launches["B5 bwd"])):
        k_ms, p_ms, (b_ms, b_by) = b5_times[32][k]
        entries.append({
            "name": f"mmd_full_{k}",
            "route": "cuda",
            "source": "controlled_peptide_generation_tpu_torch/csrc/"
                      "mmd_full.cu",
            "replaces":
                "controlled_peptide_generation_tpu/ops/pallas_kernels.py:128",
            "launches": n_launch, "max_abs_err": b5_err[k],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    for name, tag, src, replaces, runs, err in (
            ("beam_gru_bf16", "B1", "beam_gru.cu", "pallas_beam.py:285",
             ("GRU bf16",), bf16_stats["3-bf16"]),
            ("tfm_beam_bf16", "B3", "tfm_beam.cu", "pallas_tfm_beam.py:395",
             ("transformer bf16", "transformer T_args.bf16"),
             max(bf16_stats["3t-bf16"], bf16_stats["3t-bf16 T_args.bf16"]))):
        k_ms, p_ms, (b_ms, b_by) = bf16_times[tag, 5000]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"controlled_peptide_generation_tpu_torch/csrc/{src}",
            "replaces": f"controlled_peptide_generation_tpu/ops/{replaces}",
            "launches": sum(sum(bf16_runs[r][0].values()) for r in runs),
            "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    t13 = d13["bf16_times"][B2_WIDTHS[1][1], B2_SCAN_BATCH]
    for k, replaces in (("fwd", "pallas_gru.py:283"),
                        ("bwd", "pallas_gru.py:312"),
                        ("wgrad", "pallas_gru.py:206")):
        k_ms, p_ms, (b_ms, b_by), l_ms = t13[k]
        entries.append({
            "name": f"gru_seq_{k}_bf16", "route": "cuda",
            "source": "controlled_peptide_generation_tpu_torch/csrc/"
                      "gru_seq.cu",
            "replaces": f"controlled_peptide_generation_tpu/ops/{replaces}",
            "launches": d13["bf16_launches"][k],
            "max_abs_err": d13["bf16_err"][k],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms})
    for (H_, B), tk in sorted(d13["bf16_times"].items()):
        proj = d13["bf16_proj"][H_, B]
        log(f"[7] B2 bf16 at H {H_}, T {T}, B {B}: " + "; ".join(
            f"{k} kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}), {k_ms / b_ms:.1f}x its bound, "
            + f"the earlier kernel (f32 FMAs) "
            f"{B2_BF16_BEFORE_MS[k][H_, B]:.4f} ms as recorded before its "
            f"replacement (NVIDIA H100 80GB HBM3, 700.00 W), library "
            + (f"torch.mm {l_ms:.6f} ms" if k == "wgrad" else
               f"cuDNN {l_ms:.6f} ms, its input projection alone "
               f"{proj[k]:.6f} ms")
            for k, (k_ms, p_ms, (b_ms, b_by), l_ms) in tk.items())
            + f" ({card})")
    log(f"[7] curation CLI on {RAW_CARDS} cards: {d13['curation_s']:.2f} s; "
        f"native tokenizer at {TOKENIZE_ROWS} rows {d13['tok_native_ms']:.2f}"
        f" ms against the plain path's {d13['tok_plain_ms']:.2f} ms, its "
        f"build (gcc, in [2]'s pool) {d13['tok_build_s']:.2f} s; phase 1 on "
        f"the curated corpus, "
        f"51 steps: {d13['train'][1]:.2f} s (host clock, {card})")
    mark("7 report")
    log("[7] seconds per phase (host clock): " + ", ".join(
        f"{k} {v:.2f}" for k, v in phase_s.items())
        + f"; total {time.perf_counter() - T_START:.2f}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(runtime.card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
