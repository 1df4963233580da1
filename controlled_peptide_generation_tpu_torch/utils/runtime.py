"""Device selection and numeric settings for the port's entry points."""

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
