"""The transformer beam's bf16 products on the tensor cores, against the
production entry, on the card.

    python -m controlled_peptide_generation_tpu_torch.tools.tfm_beam_mma

The production bf16 entry of B3 (``tfm_beam_bf16``) keeps its products on
the CUDA cores, one sequential f32 FMA chain per output. The measurement
entry ``tfm_beam_bf16_mma`` is the same kernel with the four products on
the tensor cores (csrc/tfm_beam.cu:gemm_mma: mma.sync m16n8k16, bf16
inputs, f32 accumulators, the same rounding points). This script builds
csrc/tfm_beam.cu and, on seeded random weights at the shipped transformer
width (d_model 128, 2 layers, d_ff 256, 4 heads, V 24, T 25, K 5; the
weight tree cast to bf16, and ``T_args.bf16`` over f32 weights) and at
chip_smoke.py's scope edges of B3, prints for both entries the share of
rows whose token and pointer tapes equal the plain version's at T 1 and at
the case's T (chip_smoke.py's bf16 gates (b) and (d): >= 99% and >= 70%)
and the largest final-score delta on those rows. At the case's T it also
holds both entries, and the plain version itself, against the plain
version with its products summed in FP64 and rounded once (``fp64_sums``):
which sums agree better with exact ones, whatever their order. Then both
entries' times at B 5,000 and 2,500 (CUDA events). Needs CUDA.
"""

import contextlib
import time

import torch

# chip_smoke.py's B3_SCOPE_CASES: (what, T, K, min_length, n_best, model
# overrides)
SCOPE_CASES = (
    ("min_length 4, n_best 3", 25, 5, 4, 3, {}),
    ("K 3", 25, 3, 1, 1, {}),
    ("T*K 256", 16, 16, 1, 2, {}),
    ("S 32", 31, 8, 1, 1, {"max_seq_len": 31}),
    ("d_ff 512 (two ff chunks), 8 heads, V 127", 25, 5, 1, 1,
     {"d_ff": 512, "n_heads": 8, "n_vocab": 127}))
TFM_FLAGS = ["--model.E_args.E_class", "transformer",
             "--model.G_args.G_class", "transformer", "--seed", "1238"]


@contextlib.contextmanager
def fp64_sums():
    """While open, the plain transformer step sums its four products in
    FP64 and rounds each once to the compute type (in place of
    ``models/transformer.py:_lin32``'s f32 sums): a reference whose sums
    are exact far below one bf16 ulp."""
    from ..models import transformer as tfm
    lin32 = tfm._lin32

    def lin64(p, x, dt):
        return ((x.double() @ p["w"].double()).to(dt).float()
                + p["b"].to(dt).float())

    tfm._lin32 = lin64
    try:
        yield
    finally:
        tfm._lin32 = lin32


def _same(a, b):
    """Per row: True where the token and pointer tapes are identical."""
    return ((a[0] == b[0]).all(dim=(1, 2))
            & (a[1] == b[1]).all(dim=(1, 2)))


def main():
    t0 = time.perf_counter()
    from ..ops import cuda_build
    cuda_build.compile_library("tfm_beam.cu")
    if not torch.cuda.is_available():
        raise SystemExit("tfm_beam_mma: CUDA is not available")
    from .. import config as C
    from ..models.rnn_vae import build_model
    from ..ops import beam, nn, tfm_beam_kernel as tk
    from ..utils import runtime
    dev = runtime.setup("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{runtime.card_line()}; build {time.perf_counter() - t0:.1f} s",
          flush=True)
    tk.build()
    entries = (("production", tk.beam_scan_tfm),
               ("tensor cores", tk.beam_scan_tfm_mma))

    def model_of(flags, over=None):
        over = over or {}
        cfg = C.parse_and_finalize(TFM_FLAGS + flags)[0]
        for key in ("d_ff", "n_heads"):
            if key in over:
                cfg.model.G_args.T_args[key] = over[key]
        return build_model(cfg.model, over.get("n_vocab", 24),
                           over.get("max_seq_len", 25))

    model = model_of([])
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    g = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn((5000, model.z_dim), generator=g, device=dev)
    c = model.sample_c_prior(g, 5000, device=dev)
    cases = [("shipped width, tree cast", model,
              nn.cast_tree(params, torch.bfloat16), 25, 5, 1, 1, 5000),
             ("shipped width, T_args.bf16",
              model_of(["--model.G_args.T_args.bf16", "1"]), params, 25, 5,
              1, 1, 5000)]
    for what, t_, k_, ml, nb, over in SCOPE_CASES:
        m = model_of([], over)
        p = m.init_params(torch.Generator(device=dev).manual_seed(5), dev)
        cases.append((f"scope {what}", m, nn.cast_tree(p, torch.bfloat16),
                      t_, k_, ml, nb, 512))
    for what, m, p, t_, k_, ml, nb, B in cases:
        ins, dims = beam.decode_inputs(m, p, z[:B], c[:B])
        for T in (1, t_):
            kw = dict(T=T, K=k_, V=m.n_vocab, min_length=ml, n_best=nb,
                      **dims)
            ref = tk.beam_scan_tfm_reference(*ins, **kw)
            parts, gots = [], {}
            for name, scan in entries:
                got = gots[name] = scan(*ins, **kw)
                same = _same(got, ref)
                delta = ((got[3] - ref[3]).abs()[same].max().item()
                         if same.any() else float("nan"))
                parts.append(f"{name} {same.float().mean().item():.6f} "
                             f"(max |score delta| {delta:.3e})")
            print(f"{what}, B {B}, T {T}: rows identical to the plain "
                  f"version's: " + "; ".join(parts), flush=True)
            if T == t_:
                with fp64_sums():
                    ref64 = tk.beam_scan_tfm_reference(*ins, **kw)
                gots["plain (f32 sums)"] = ref
                shares = "; ".join(
                    f"{name} {_same(got, ref64).float().mean().item():.6f}"
                    for name, got in gots.items())
                print(f"{what}, B {B}, T {T}: rows identical to the plain "
                      f"version's with FP64 sums: {shares}", flush=True)
    for what, m, p, *_ in cases[:2]:
        for B in (5000, 2500):
            ins, dims = beam.decode_inputs(m, p, z[:B], c[:B])
            kw = dict(T=25, K=5, V=24, min_length=1, n_best=1, **dims)
            times = ", ".join(
                f"{name} {runtime.cuda_ms(lambda: scan(*ins, **kw), 10):.4f}"
                f" ms" for name, scan in entries)
            print(f"{what}, B {B}: {times} (CUDA events, 10 launches)",
                  flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
