"""A run of train steps as one captured CUDA graph: what phase 1's
``TrainChunk`` (``train/train_vae.py``) and phase 2's ``FullChunk``
(``train/train_full.py``) share, the counterpart of the JAX package's
scans over steps (``make_train_scan``, ``make_full_scan``).

A chunk runs ``unroll`` steps it0 .. it0 + unroll - 1. Each step reads its
own slice of the staged inputs (the batches, and every host scalar that
changes with it, such as beta) and its own draws, those of the per-step
path, so the updates are those of ``unroll`` per-step calls.

On CUDA tensors the steps are one CUDA graph, captured on the first call
and replayed on every later one. Its inputs are static buffers filled
before each replay: the staged inputs by one copy each from pinned host
buffers, every step's draws drawn into theirs by the per-step
generators. The graph holds the addresses of the train state (params and
optimizer state), so a call with other tensors raises. Before the capture
two steps run on copies of the state on the capture stream, so the
libraries, the kernels' set-up and B5's completion counter for that
stream exist and the trajectory does not move. The launch counters skip
that set-up and the capture; each replay adds the launches the capture
made. A capture that fails raises. On CPU tensors the steps run eagerly,
and ``draws`` (one dict per step) may replace the generators' draws, as
tests feed the JAX package's.

Each replay after the capture is a device span (``utils/tracing.py``):
a timing event before its staging's first copy and one after the
replay, read once they have completed (no synchronisation), so that
``stats()`` gives the device seconds of the replays and of the idle gaps
between one replay's end and the next chunk's first copy.

Under data parallelism the steps' collectives (the gradients' and the
metrics' averages, the z gather, a deconv decoder's batch-norm sums) are
nodes of the graph: under NCCL the warm-up steps run them first, which
makes the communicator before the capture, and every replay runs them
again with the rest. NCCL at world 1 runs the average as one kernel of its
own and the gather as one device copy. A gloo group cannot be captured
(it stages CUDA tensors through the host); the trainers refuse such a
chunk (``train_vae.check_chunk``) rather than run its steps eagerly.
"""

import time

import torch

from ..utils import runtime, tracing
from . import checkpoints


def launch_counters():
    """The train steps' kernel wrappers, whose ``launches`` counts a
    replay of a chunk's graph cannot reach (the chunk adds them)."""
    from ..ops import gru_fwd_kernel, gru_kernel, mmd_kernel
    return (gru_kernel.gru_seq_fwd, gru_kernel.gru_seq_bwd,
            gru_kernel.gru_seq_wgrad, gru_fwd_kernel.gru_fwd,
            mmd_kernel.mmd_full_fwd, mmd_kernel.mmd_full_bwd)


class GraphChunk:
    """The shared machinery of a chunk of ``unroll`` steps. A subclass
    gives ``_inputs(it0, *batches)`` -> {name: CPU tensor [unroll, ...]},
    ``_draws(it0, inputs, dev, out=None)`` -> one draws dict per step
    (written into ``out``'s tensors when given) and ``_update(state,
    inputs_i, draws_i)`` -> the metrics of one step, ``inputs_i`` the
    step's slices; ``state`` is the nested dict of the train state's
    tensors, updated in place.

    After the capture: ``node_kinds`` (the graph's node kinds),
    ``captured`` (launches a replay, by counter), ``capture_s`` and
    ``instantiate_s`` (host clock), ``pool_bytes`` (the memory the
    capture reserved: the graph's private pool) and ``exec_bytes`` (the
    device memory the instantiation took); ``replays`` counts the
    replays. Under data parallelism (``shard``, a
    ``collectives.Shard``) the steps' collectives are captured too, and
    ``collective_nodes`` counts NCCL's kernel nodes in the graph."""

    def __init__(self, unroll, shard=None):
        self.unroll = int(unroll)
        self.shard = shard
        self.graph = None
        self.node_kinds = None
        self.collective_nodes = None
        self.captured = {}
        self.replays = 0
        self.device_times = tracing.DeviceTimes()
        self.capture_s = self.instantiate_s = None
        self.pool_bytes = self.exec_bytes = None

    def run(self, state, batches, it0, draws=None):
        """Steps it0 .. it0 + unroll - 1 on ``batches`` (each [unroll,
        ...]); returns the last step's metrics."""
        inputs = self._inputs(it0, *batches)
        for name, x in inputs.items():
            if x.shape[0] != self.unroll:
                raise ValueError(f"{x.shape[0]} {name} rows for a chunk of "
                                 f"{self.unroll}")
        dev = next(iter(checkpoints.flatten(state).values())).device
        if dev.type == "cuda":
            if draws is not None:
                raise ValueError("a chunk on the card draws its own: "
                                 "injected draws run on CPU tensors")
            return self._replay(state, inputs, it0, dev)
        inputs = {k: v.to(dev) for k, v in inputs.items()}
        if draws is None:
            draws = self._draws(it0, inputs, dev)
        for i in range(self.unroll):
            metrics = self._update(state, {k: v[i] for k, v in
                                           inputs.items()}, draws[i])
        return metrics

    @staticmethod
    def _state_ptrs(state):
        return [t.data_ptr() for t in checkpoints.flatten(state).values()]

    def _stage(self, inputs, it0):
        """Fill the captured graph's inputs for steps it0 .. it0 + unroll
        - 1: one copy each from the pinned host buffers (once the last
        stage's copies are done), and every step's draws from the
        per-step generators. Returns the device span started before the
        first copy."""
        with tracing.span("train.stage", it=it0):
            with tracing.span("train.stage.wait", it=it0):
                self._copied.synchronize()
            for k, x in inputs.items():
                self._host[k].copy_(x)
            span = tracing.device_span(self._device)
            for k, x in self._host.items():
                self._dev[k].copy_(x, non_blocking=True)
            self._copied.record()
            self._draws(it0, self._dev, self._device,
                        out=self._static_draws)
        return span

    def _replay(self, state, inputs, it0, dev):
        span = None
        if self.graph is None:
            self._capture(state, inputs, it0, dev)
        elif self._ptrs != self._state_ptrs(state):
            raise ValueError("the chunk's graph was captured on other "
                             "params or optimizer state tensors")
        else:
            span = self._stage(inputs, it0)
        with tracing.span("train.launch", it=it0):
            self.graph.replay()
        if span is not None:
            self.device_times.add(span.end())
        self.replays += 1
        for fn, n in self.captured.items():
            fn.launches += n
        return dict(zip(self._keys, self._packed.clone().unbind(0)))

    def _capture(self, state, inputs, it0, dev):
        counters = launch_counters()
        counts = [fn.launches for fn in counters]
        self._device = dev
        self._dev = {k: torch.empty(x.shape, dtype=x.dtype, device=dev)
                     for k, x in inputs.items()}
        self._host = {k: torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                      for k, x in inputs.items()}
        self._copied = torch.cuda.Event()
        self._copied.record()
        self._static_draws = self._draws(it0, self._dev, dev)
        self._stage(inputs, it0)

        def step_inputs(i):
            return {k: v[i] for k, v in self._dev.items()}

        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            copy = checkpoints.unflatten({
                p: t.detach().clone().requires_grad_(t.requires_grad)
                for p, t in checkpoints.flatten(state).items()})
            for i in range(2):
                self._update(copy, step_inputs(i % self.unroll),
                             self._static_draws[i % self.unroll])
        torch.cuda.current_stream(dev).wait_stream(stream)
        del copy
        for fn, n in zip(counters, counts):
            fn.launches = n
        # the capture empties the allocator's cache first: empty it here
        # too, so the reserved bytes it adds are the graph's pool
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=stream):
            for i in range(self.unroll):
                metrics = self._update(state, step_inputs(i),
                                       self._static_draws[i])
            self._keys = sorted(metrics)
            self._packed = torch.stack([metrics[k] for k in self._keys])
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.captured = {fn: fn.launches - n
                         for fn, n in zip(counters, counts)
                         if fn.launches != n}
        for fn, n in zip(counters, counts):
            fn.launches = n
        self.node_kinds = runtime.graph_node_kinds(graph.raw_cuda_graph())
        if self.shard is not None:
            self.collective_nodes = sum(map(runtime.is_collective,
                                            runtime.graph_kernel_names(
                                                graph.raw_cuda_graph())))
        free = torch.cuda.mem_get_info(dev)[0]
        t0 = time.perf_counter()
        graph.instantiate()
        self.instantiate_s = time.perf_counter() - t0
        self.exec_bytes = free - torch.cuda.mem_get_info(dev)[0]
        self.graph = graph
        self._ptrs = self._state_ptrs(state)

    def summary(self):
        """"<n> replays of a <unroll>-step CUDA graph of <k> kernel nodes",
        the line the trainers log after their loop."""
        return (f"{self.replays} replays of a {self.unroll}-step CUDA graph "
                f"of {self.node_kinds.count('kernel')} kernel nodes")

    def stats(self):
        """The captured graph's size and cost: nodes, kernel nodes, capture
        and instantiate seconds (host clock), the pool's and the
        executable's bytes; the replays, and of those after the capture's
        whose events have completed the device seconds (``device_s`` over
        ``timed``) and the idle seconds before each (``device_gap_s`` over
        ``gaps``), on the device's clock."""
        d = self.device_times
        d.poll()
        return {"unroll": self.unroll, "nodes": len(self.node_kinds),
                "kernel_nodes": self.node_kinds.count("kernel"),
                "memcpy_nodes": self.node_kinds.count("memcpy"),
                "collective_nodes": self.collective_nodes,
                "capture_s": self.capture_s,
                "instantiate_s": self.instantiate_s,
                "pool_bytes": self.pool_bytes,
                "exec_bytes": self.exec_bytes, "replays": self.replays,
                "device_s": d.device_s, "timed": d.spans,
                "device_gap_s": d.gap_s, "gaps": d.gaps}
