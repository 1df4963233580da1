"""Device selection and numeric settings for the port's entry points."""

import ctypes
import os

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
    raises: there is no silent CPU fallback. "cuda" without an index is
    ``cuda:LOCAL_RANK`` under torchrun (one process a device, the
    data-parallel ranks of ``parallel/dist.py``), else the current
    device."""
    set_full_fp32()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
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


# CUgraphNodeType of libcuda's graph API, by value
_NODE_KINDS = ("kernel", "memcpy", "memset", "host", "graph", "empty",
               "wait_event", "event_record", "ext_semas_signal",
               "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
               "conditional")


def graph_node_kinds(graph):
    """The kinds of the nodes of a captured CUDA graph (a cudaGraph_t as
    an int, ``torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()``),
    read through libcuda (cuGraphGetNodes, cuGraphNodeGetType): how many
    launches, memsets and copies a captured call makes."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(ctypes.c_void_p(graph), nodes,
                                      ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds.append(_NODE_KINDS[kind.value]
                     if 0 <= kind.value < len(_NODE_KINDS) else str(kind.value))
    return kinds


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of libcuda's graph API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernel_names(graph):
    """The function names of the kernel nodes of a captured CUDA graph (a
    cudaGraph_t as an int, as ``graph_node_kinds`` takes), read through
    libcuda (cuGraphKernelNodeGetParams, cuFuncGetName or
    cuKernelGetName): which kernels a replay launches, NCCL's among them
    (``is_collective``)."""
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(ctypes.c_void_p(graph), nodes,
                                      ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:
            continue
        p = _KernelNodeParams()
        if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                            ctypes.byref(p)):
            raise RuntimeError("cuGraphKernelNodeGetParams failed")
        name = ctypes.c_char_p()
        err = (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func))
               if p.func else
               cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)))
        if err:
            raise RuntimeError("cuFuncGetName failed")
        names.append(name.value.decode())
    return names


def is_collective(kernel_name):
    """True for NCCL's kernels: ncclDevKernel_* at any world size, and
    the kernel NCCL runs for a pre-multiplied sum (the average) at world 1
    (its onerank.cu)."""
    low = kernel_name.lower()
    return "nccl" in low or "onerank" in low
