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
import re
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
    content, headers of csrc/ and flags exists) and load it. Returns (ctypes.CDLL, the nvcc
    output of the build, ptxas' -v report included). The output is kept
    beside the library, so a cached build returns it too."""
    src = os.path.join(CSRC, source)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [source] + sorted(f for f in os.listdir(CSRC)
                                  if f.endswith(".cuh")):
        with open(os.path.join(CSRC, name), "rb") as fh:
            digest.update(fh.read())
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


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(log, name):
    """{name(entry): (registers, spill store bytes, spill load bytes)} of
    the kernels in ptxas' -v output ``log`` (a build log), for the entries
    whose mangled name ``name`` maps to a string (to None: skipped)."""
    report, key = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            key = name(m.group(1))
            if key:
                report[key] = [0, 0, 0]
            continue
        if key is None:
            continue
        m = _SPILL.search(line)
        if m:
            report[key][1:] = [int(m.group(1)), int(m.group(2))]
        m = _REGS.search(line)
        if m:
            report[key][0] = int(m.group(1))
            key = None
    return {k: tuple(v) for k, v in report.items()}


def check_no_spills(report, source, want=()):
    """Raise unless no kernel of ``report`` (a ``ptxas_report()`` of
    ``source``: {name: (registers, spill store bytes, spill load bytes)})
    spills and every prefix in ``want`` names at least one of its kernels.
    A kernel whose weights or state live in registers reads a spilled
    value from local memory on every step."""
    spilled = {k: v for k, v in report.items() if v[1] or v[2]}
    missing = [w for w in want if not any(k.startswith(w) for k in report)]
    if spilled or missing:
        raise AssertionError(f"csrc/{source}: spills {spilled}, no ptxas "
                             f"report of {missing} ({sorted(report)})")


def beam_kernel_name(entry):
    """``<kernel><type, production|stamp[, weights via L2 | tensor
    cores]>`` of a mangled beam-kernel name (csrc/beam_gru.cu,
    csrc/tfm_beam.cu), else None: the last template flag is kStamp, B1's
    first kSmemW, B3's first kMma."""
    m = re.search(r"(?<=\d)([a-z_]+_kernel)I(13__nv_bfloat16|f)((?:Lb[01]E)+)",
                  entry)
    if m is None:
        return None
    flags = re.findall(r"Lb([01])E", m.group(3))
    typ = "bf16" if m.group(2) != "f" else "f32"
    kind = "stamp" if flags[-1] == "1" else "production"
    extra = ""
    if len(flags) == 2 and m.group(1).startswith("beam_gru") and (
            flags[0] == "0"):
        extra = ", weights via L2"
    if len(flags) == 2 and m.group(1) == "tfm_beam_kernel" and flags[0] == "1":
        extra = ", tensor cores"
    return f"{m.group(1)}<{typ}, {kind}{extra}>"


def read_stamps(buf, phases, n_phases):
    """The phase split a stamp entry wrote into ``buf`` (int64, see
    PhaseClock in csrc/beam_gru.cu and csrc/tfm_beam.cu). Returns a dict:
    ``blocks``, one entry per recorded block (block 0 and the grid's last)
    with its id, the wave it ran in (0 first), its clock cycles from its
    start to its last phase as ``cycles`` and ``share``, the share of them
    each phase took (names from ``phases``); ``grid``, ``slots`` (blocks
    that started before the first one ended: the blocks resident at once),
    ``waves`` and ``span_ns``, the time from the first block's start to
    the last block's end."""
    if len(phases) != n_phases:
        raise ValueError(f"{len(phases)} phase names for {n_phases} phases")
    v = buf.cpu().tolist()
    rec_words = n_phases + 1
    times = v[2 + 2 * rec_words:]
    starts, ends = times[0::2], times[1::2]
    grid = len(starts)
    first_end = min(ends)
    slots = max(1, sum(1 for s in starts if s < first_end))
    order = sorted(range(grid), key=lambda b: (starts[b], b))
    wave = {b: i // slots for i, b in enumerate(order)}
    blocks = []
    for r in range(2):
        b = v[r]
        total = v[2 + r * rec_words]
        if total <= 0 or (r == 1 and b == v[0]):
            continue
        cyc = v[3 + r * rec_words:2 + (r + 1) * rec_words]
        blocks.append({"block": b, "wave": wave[b], "cycles": total,
                       "share": {n: c / total for n, c in zip(phases, cyc)}})
    return {"blocks": blocks, "grid": grid, "slots": slots,
            "waves": grid / slots,
            "span_ns": max(ends) - min(starts)}
