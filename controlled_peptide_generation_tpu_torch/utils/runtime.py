"""Device selection and numeric settings for the port's entry points."""

import numpy as np
import torch


def set_full_fp32():
    """Full fp32 matmuls and convolutions: the EM and Newton solvers need
    them (TF32 keeps about three decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def setup(device="cuda"):
    """Resolve the device an entry point runs on.

    CUDA unless the caller asks for the CPU. Without CUDA, asking for it
    raises: there is no silent CPU fallback."""
    set_full_fp32()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def generator(device, *words):
    """A torch.Generator on ``device`` seeded from a tuple of integers
    (e.g. (seed, iteration)): every pair gives its own stream, as
    ``jax.random.fold_in`` does for a key."""
    mixed = np.random.SeedSequence([int(w) for w in words])
    gen = torch.Generator(device=device)
    return gen.manual_seed(int(mixed.generate_state(1, np.uint64)[0]))


def synchronize(device):
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_line():
    """The card's name and power limit as nvidia-smi reports them (a card
    set below its maximum power runs slower under load)."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Device ms per call of fn by CUDA events, after one warm-up call. A
    spin kernel holds the stream while the host queues the reps, so the
    card runs them back to back and the host's launch overhead enters the
    reading only where the host needs longer per call than the card (the
    plain versions)."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at up to 2 GHz for 1.5x the host's time to queue the reps
    torch.cuda._sleep(int(2e9 * min(1.5 * reps * host_s + 1e-3, 2.0)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
