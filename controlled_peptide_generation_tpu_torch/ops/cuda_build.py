"""nvcc builds of the port's CUDA sources, bound with ctypes, and the one
switch to their plain versions.

Each source in ``csrc/`` exposes a plain C interface. ``compile_library``
runs nvcc for sm_90a once per source content into ``build/torch_kernels/``
(at the repository root, listed in .gitignore) and loads the shared
library. Nothing is built when a module is imported: the wrappers call it
at their first launch on a CUDA tensor.

Inside ``with plain():`` the train step's kernels run as their plain
versions on any device (for comparisons with the kernels only): the
training recurrence B2 as its step loop differentiated by autograd,
``gru_scan``'s forward-only route B4 as ``gru_fwd_reference`` and the
WAE-MMD B5 as ``mmd_full_reference``.
"""

import contextlib
import ctypes
import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_plain = False


@contextlib.contextmanager
def plain():
    """Run B2, B4 and B5 as their plain versions while the context is
    open."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def in_plain():
    """True inside ``plain()``."""
    return _plain


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME")
    return path


def compile_library(source):
    """Compile csrc/<source> (skipped when a library of the same source
    content and flags exists) and load it. Returns (ctypes.CDLL, the nvcc
    output of the build, ptxas' -v report included). The output is kept
    beside the library, so a cached build returns it too."""
    src = os.path.join(CSRC, source)
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    so = os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")
    log_path = so[:-3] + ".log"
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        with open(f"{log_path}.{os.getpid()}.tmp", "w") as fh:
            fh.write(log)
        os.replace(f"{log_path}.{os.getpid()}.tmp", log_path)
        os.replace(tmp, so)
    try:
        with open(log_path) as fh:
            log = fh.read()
    except FileNotFoundError:
        log = ""
    return ctypes.CDLL(so), log
