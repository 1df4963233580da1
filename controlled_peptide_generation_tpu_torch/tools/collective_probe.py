"""What the data-parallel step's collectives cost on the card, and what a
captured CUDA graph holds of them.

    python3 -m controlled_peptide_generation_tpu_torch.tools.collective_probe

1. Under an NCCL group of world 1 (``parallel.dist.spawn``): each
   collective the DP step makes (the gradients' average in place, the
   same as an in-place sum, the z all-gather, ZeRO-1's reduce-scatter)
   captured alone in a CUDA graph, the graph's nodes (kinds, and the
   kernels' names), and the average's device time (CUDA events) on a
   buffer of the shipped GRU model's parameter count.
2. Under 2 gloo ranks on one card (NCCL refuses two ranks on one
   device): the same collectives on CUDA tensors, host clock around each
   call ending in a synchronize: gloo stages them through the host.

Prints one JSON object a line, beside the card's name and power limit.
"""

import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from .. import config as C
from ..models.rnn_vae import build_model
from ..parallel import dist as pdist
from ..parallel.collectives import Shard
from ..train import checkpoints
from ..utils import runtime

REPS = 50
Z_ROWS, Z_DIM, METRICS = 16, 100, 12


def grad_numel():
    """The shipped GRU model's parameter count (V 24, T 25)."""
    cfg = C.default_config()
    model = build_model(cfg.model, n_vocab=24, max_seq_len=25)
    params = model.init_params(torch.Generator().manual_seed(0))
    return sum(t.numel() for t in checkpoints.flatten(params).values())


def _ops(shard, n, dev):
    grads = torch.ones(n, device=dev)
    z = torch.ones(Z_ROWS, Z_DIM, device=dev)
    scatter = torch.ones(n - n % shard.world, device=dev)
    return {
        "gradient average (AVG, in place)": lambda: shard.mean_(grads),
        "in-place sum": lambda: shard.sum_(grads),
        "metrics average": lambda: shard.mean_(torch.ones(METRICS,
                                                          device=dev)),
        "z all-gather": lambda: shard.gather(z),
        "ZeRO-1 reduce-scatter": lambda: shard.reduce_scatter_mean(scatter),
    }


def nccl_world1(out_path, n):
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    shard = Shard()
    out = {}
    for name, fn in _ops(shard, n, dev).items():
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()
            fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            fn()
        raw = graph.raw_cuda_graph()
        out[name] = {"node_kinds": runtime.graph_node_kinds(raw),
                     "kernels": runtime.graph_kernel_names(raw),
                     "eager_ms": runtime.cuda_ms(fn, REPS)}
    with open(out_path, "w") as fh:
        json.dump(out, fh)


def gloo_two_ranks(out_dir, n):
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    shard = Shard()
    out = {}
    for name, fn in _ops(shard, n, dev).items():
        fn()
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize(dev)
        out[name] = {"host_ms": 1e3 * (time.perf_counter() - t0) / REPS}
    with open(os.path.join(out_dir, f"rank{shard.rank}.json"), "w") as fh:
        json.dump(out, fh)


def main():
    runtime.setup("cuda")
    n = grad_numel()
    card = runtime.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "nccl.json")
        pdist.spawn(nccl_world1, 1, path, n, backend="nccl", threads=0)
        with open(path) as fh:
            nccl = json.load(fh)
        pdist.spawn(gloo_two_ranks, 2, tmp, n, backend="gloo", threads=0)
        gloo = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                gloo.append(json.load(fh))
    for name, res in nccl.items():
        kinds = res["node_kinds"]
        print(json.dumps({
            "collective": name, "floats": n if "gradient" in name
            or "sum" in name or "ZeRO" in name else None,
            "nccl_world1_graph_nodes": {k: kinds.count(k)
                                        for k in sorted(set(kinds))},
            "nccl_world1_kernels": res["kernels"],
            "nccl_world1_eager_ms": res["eager_ms"],
            "gloo_2_ranks_host_ms": [g[name]["host_ms"] for g in gloo],
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
