"""Where the time of the two beam kernels goes, phase by phase, on the card.

    python -m controlled_peptide_generation_tpu_torch.tools.beam_split \\
        [--batches 5000 2500] [--reps 5]

Builds csrc/beam_gru.cu (B1) and csrc/tfm_beam.cu (B3), makes the shipped
widths' decoders from seeded random weights (the GRU family: H 102, the
transformer family: d_model 128, 2 layers, d_ff 256, 4 heads; V 24, T 25,
K 5), and for each batch and storage type (f32, and bf16 with the weight
tree cast as ``--hw.gen_dtype bfloat16`` casts it):

* launches the stamp entry (``*_stamp``: the same kernel compiled with its
  phase clocks, for measurement only) and prints, for block 0 and the
  grid's last block, the wave the block ran in and the share of its clock
  cycles each phase took (``ops/*_kernel.py:STAMP_PHASES``), with the
  grid, the blocks resident at once and the waves;
* checks that the stamp entry gives the production entry's tapes bitwise;
* times the production entry by CUDA events (``--reps`` launches) and
  prints it beside the stamp launch's span on the global timer: what the
  clocks cost;
* prints the registers and spills ptxas reports for every instantiation,
  production and stamp (``ops/*_kernel.py:ptxas_report``).

``chip_smoke.py`` runs the same report (``split_lines``) on its own
inputs. Needs CUDA.
"""

import argparse
import time

import torch

from ..utils.runtime import cuda_ms


def split_lines(tag, scan, stamped, ins, kw, reps=5):
    """Launch ``stamped`` (a ``*_stamped`` wrapper) on ins, kw; check its
    tapes against ``scan``'s (the production entry) bitwise; time the
    production entry by CUDA events (``reps`` launches), so that the
    stamp launch's span (its first block's start to its last block's end
    on the global timer) stands beside it: what the clocks cost. Returns
    the report's lines and the stamps (``cuda_build.read_stamps``)."""
    scan(*ins, **kw)
    got, st = stamped(*ins, **kw)
    want = scan(*ins, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{tag}: the stamp entry's tapes differ from "
                             f"the production entry's")
    prod_ms = cuda_ms(lambda: scan(*ins, **kw), reps)
    span_ms = st["span_ns"] / 1e6
    lines = [f"{tag}: grid {st['grid']} blocks, {st['slots']} resident at "
             f"once, {st['waves']:.2f} waves; tapes equal to the production "
             f"entry's",
             f"{tag}: stamp launch span {span_ms:.4f} ms (global timer), "
             f"production entry {prod_ms:.4f} ms (CUDA events, {reps} "
             f"launches): the clocks add {100 * (span_ms / prod_ms - 1):.1f}%"]
    for b in st["blocks"]:
        share = ", ".join(f"{k} {100 * v:.1f}%" for k, v in b["share"].items())
        lines.append(f"{tag}: block {b['block']} (wave {b['wave']}), "
                     f"{b['cycles']} cycles: {share}")
    return lines, st


def host_ms(fn, reps=20):
    """Host ms per call of fn, the card synchronized after each (the median
    of ``reps`` calls after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[reps // 2]


def host_lines(tag, ins, kw):
    """The host work a beam wrapper does around its launch on these inputs
    (``decode_inputs``), each part timed alone by ``host_ms``: B3's weight
    packs (``pack_layers``) and plan, B1's transposed weights
    (``weight_layout`` / ``mma_layout``) and plan."""
    from ..ops import beam_kernel, tfm_beam_kernel
    dt = ins[0].dtype
    B = ins[1].shape[0] if "S" not in kw else ins[7][0].shape[0]
    if "S" in kw:
        parts = {"pack_layers": lambda: tfm_beam_kernel.pack_layers(ins[2],
                                                                   dt),
                 "launch_plan": lambda: tfm_beam_kernel.launch_plan(
                     B, kw["K"], kw["V"], kw["S"], kw["F"], dt)}
    else:
        layout = (beam_kernel.weight_layout if dt == torch.float32
                  else beam_kernel.mma_layout)
        parts = {layout.__name__: lambda: layout(ins[2], ins[4]),
                 "launch_plan": lambda: beam_kernel.launch_plan(
                     B, kw["K"], kw["V"], kw["H"], dt)}
    return [f"{tag}: host work per launch, " + ", ".join(
        f"{k} {host_ms(f):.4f} ms" for k, f in parts.items())
        + " (host clock, each synchronized, median of 20)"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[5000, 2500])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    from ..ops import cuda_build
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(cuda_build.compile_library,
                      ("beam_gru.cu", "tfm_beam.cu")))
    if not torch.cuda.is_available():
        raise SystemExit("beam_split: CUDA is not available")
    from .. import config as C
    from ..models.rnn_vae import build_model
    from ..ops import beam, beam_kernel, nn, tfm_beam_kernel
    from ..utils import runtime
    dev = runtime.setup("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{runtime.card_line()}; builds {time.perf_counter() - t0:.1f} s",
          flush=True)
    for kern, src in ((beam_kernel, "beam_gru.cu"),
                      (tfm_beam_kernel, "tfm_beam.cu")):
        kern.build()
        for name, (regs, st, ld) in sorted(kern.ptxas_report().items()):
            print(f"ptxas {src} {name}: {regs} registers, spill stores {st} "
                  f"B, spill loads {ld} B", flush=True)
    tfm_flags = ["--model.E_args.E_class", "transformer",
                 "--model.G_args.G_class", "transformer"]
    n = max(args.batches)
    for fam, flags in (("B1", []), ("B3", tfm_flags)):
        cfg = C.parse_and_finalize(["--seed", "1238"] + flags)[0]
        model = build_model(cfg.model, 24, 25)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                                   dev)
        g = torch.Generator(device=dev).manual_seed(1)
        z = torch.randn((n, model.z_dim), generator=g, device=dev)
        c = model.sample_c_prior(g, n, device=dev)
        kern = tfm_beam_kernel if fam == "B3" else beam_kernel
        scan, stamped = ((kern.beam_scan_tfm, kern.beam_scan_tfm_stamped)
                         if fam == "B3" else
                         (kern.beam_scan_gru, kern.beam_scan_gru_stamped))
        for dt in (torch.float32, torch.bfloat16):
            p = params if dt == torch.float32 else nn.cast_tree(params, dt)
            for B in args.batches:
                ins, dims = beam.decode_inputs(model, p, z[:B], c[:B])
                kw = dict(T=25, K=5, V=24, min_length=1, n_best=1, **dims)
                tname = "bf16" if dt == torch.bfloat16 else "f32"
                tag = f"{fam} {tname} B {B}"
                lines, _ = split_lines(tag, scan, stamped, ins, kw, args.reps)
                for line in lines + host_lines(tag, ins, kw):
                    print(line, flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
