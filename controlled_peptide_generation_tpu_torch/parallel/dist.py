"""Process groups: the counterpart of the JAX package's ``get_mesh`` and
``initialize_multihost`` (``parallel/mesh.py:31, 50`` there) for data
parallelism, and of its 2D and 3D meshes (``get_mesh_2d``,
``get_mesh_3d``, ``get_mesh_pipe``) for tensor and pipeline parallelism
(``Mesh``, ``model_parallel``).

One process a rank, each on its own device: ``torchrun`` (``python -m
torch.distributed.run --nproc_per_node N -m
controlled_peptide_generation_tpu_torch.main ... --hw.dp N``) sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; ``init_from_env``
makes the default group from them (NCCL for CUDA, gloo for the CPU), or
keeps a group that already exists, and ``runtime.setup`` puts rank r on
``cuda:LOCAL_RANK``. A group selects the data-parallel path of the
trainers (``data_parallel``); ``hw.dp`` must then be its world size, or 0
("all", as in JAX), and anything else raises: no run drops quietly to one
rank. Without a group ``hw.dp`` 0 and 1 run the one-device path, as
before.

``hw.tp`` or ``hw.pp`` > 1 selects tensor and pipeline parallelism
instead (``model_parallel``): the group's ranks form a (data, pipe,
model) mesh of dp pp tp ranks (``hw.dp`` 0 takes what is left), one
process a rank as before, e.g. ``torchrun --nproc_per_node 4 -m
controlled_peptide_generation_tpu_torch.main ... --hw.tp 2 --hw.pp 2``.

``spawn`` starts ``world`` local ranks over a ``FileStore`` in a temporary
directory (no TCP port, so parallel test workers do not collide), for the
tests and the smoke run. Its target must be a function of a module that
imports the port alone: each rank is a fresh interpreter that imports it.
"""

import contextlib
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from ..train.checkpoints import flatten
from . import pp as pp_mod
from . import tp as tp_mod
from .collectives import Shard


def backend_for(device):
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_from_env(device):
    """The default group: the one that exists, else one from torchrun's
    environment when WORLD_SIZE > 1 (``backend_for(device)``), else
    None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    kwargs = {}
    if torch.device(device).type == "cuda":
        kwargs["device_id"] = torch.device(device)
    dist.init_process_group(backend_for(device), init_method="env://",
                            **kwargs)
    return dist.group.WORLD


def world_size():
    """The default group's size, 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank():
    """This process's rank in the default group, 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def data_parallel(cfg, batch_sizes=()):
    """The ``Shard`` a trainer runs as, or None for the one-device path.

    A process group selects data parallelism; ``hw.dp`` is its world size
    or 0 (the world size, JAX's "all devices"). Raises a ValueError when
    ``hw.dp`` names another size than the group's (no run drops to one
    rank, and ``hw.dp > 1`` without a group has no ranks to run on), and
    when a batch size does not divide over the ranks (the JAX package's
    message, ``train/train_vae.py:316`` there)."""
    n_dp = int(cfg.hw.get("dp", 1))
    world = world_size()
    if n_dp == 0:
        n_dp = world
    if n_dp != world:
        raise ValueError(
            f"hw.dp {n_dp} but the process group has {world} rank(s): "
            f"run one process a device, e.g. python -m torch.distributed.run "
            f"--nproc_per_node {n_dp} -m "
            f"controlled_peptide_generation_tpu_torch.main ... --hw.dp "
            f"{n_dp} (hw.dp 0 takes the group's size)")
    if world == 1 and not dist.is_initialized():
        return None
    for b in batch_sizes:
        if int(b) % n_dp:
            raise ValueError(f"batch_size {b} must divide over {n_dp} "
                             f"devices")
    return Shard()


class Mesh:
    """The ranks of the default group as a (data, pipe, model) mesh of
    shape (dp, pp, tp): the counterpart of the JAX package's
    ``get_mesh_2d``, ``get_mesh_3d`` and ``get_mesh_pipe``
    (``parallel/tp.py:37-62``, ``parallel/pp.py:59-72`` there). The axis
    order is JAX's: 'model' varies fastest, then 'pipe', then 'data', so
    rank r = (d pp + p) tp + t.

    ``model``, ``pipe`` and ``data`` are this rank's groups along each
    axis as ``collectives.Shard``s, None for an axis of size 1. Every rank
    makes every group, in the same order (``torch.distributed.new_group``
    requires it). ``shard`` and ``gather`` move a tree of the model's
    layout (the params, or Adam's moments) between its full form and this
    rank's part: the Megatron slices of the transformer blocks on the
    'model' axis (``parallel/tp.py``), the stage's blocks on the 'pipe'
    axis (``parallel/pp.py``); the 'data' axis replicates them."""

    def __init__(self, dp, pp, tp):
        world = world_size()
        if dp * pp * tp != world:
            raise ValueError(f"a ({dp}, {pp}, {tp}) mesh needs {dp * pp * tp}"
                             f" ranks, the group has {world}")
        self.dp, self.pp, self.tp = dp, pp, tp
        self.d, rest = divmod(rank(), pp * tp)
        self.p, self.t = divmod(rest, tp)
        at = {"data": self.d, "pipe": self.p, "model": self.t}
        sizes = {"data": dp, "pipe": pp, "model": tp}
        for axis in ("model", "pipe", "data"):
            mine = None
            if sizes[axis] > 1:
                others = [a for a in ("data", "pipe", "model") if a != axis]
                for i in range(sizes[others[0]]):
                    for j in range(sizes[others[1]]):
                        pos = {others[0]: i, others[1]: j}
                        ranks = [self.rank_of(**dict(pos, **{axis: k}))
                                 for k in range(sizes[axis])]
                        group = dist.new_group(ranks)
                        if (i, j) == (at[others[0]], at[others[1]]):
                            mine = Shard(group)
            setattr(self, axis, mine)
        self.backend = str(dist.get_backend())

    def rank_of(self, data, pipe, model):
        return (data * self.pp + pipe) * self.tp + model

    def __repr__(self):
        return (f"Mesh(data={self.dp}, pipe={self.pp}, model={self.tp}; "
                f"this rank ({self.d}, {self.p}, {self.t}), {self.backend})")

    def wrap(self, model):
        """``model`` with its transformer legs running this rank's part:
        the Megatron block on the 'model' axis (``tp.make_tp_model``), the
        GPipe schedule on the 'pipe' axis (``pp.make_pp_model``)."""
        if self.tp > 1:
            model = tp_mod.make_tp_model(model, self.model)
        if self.pp > 1:
            model = pp_mod.make_pp_model(model, self.pipe, tp=self.model)
        return model

    def shard(self, tree):
        """This rank's part of a full tree (copies)."""
        tree = tp_mod.shard_tree(tree, self.model)
        return pp_mod.shard_tree(tree, self.pipe)

    def gather(self, tree, grad=False):
        """The full tree from every rank's part: a collective every rank
        of the mesh calls. ``grad``: differentiable, each rank's part
        getting its own slice of its own gradient (the tree then feeds a
        computation every rank repeats: the cached decode step); else
        detached copies."""
        tree = tp_mod.gather_tree(tree, self.model, grad)
        return pp_mod.gather_tree(tree, self.pipe, grad)

    def shard_opt(self, state):
        """``ClipAdam``'s state with its moments cut to this rank's
        part."""
        return dict(state, mu=self.shard(state["mu"]),
                    nu=self.shard(state["nu"]))

    def gather_opt(self, state):
        """``ClipAdam``'s state with its moments gathered in full (a
        collective)."""
        return dict(state, count=state["count"].clone(),
                    mu=self.gather(state["mu"]), nu=self.gather(state["nu"]))

    def global_norm(self, grads):
        """The global norm of a gradient tree (or {path: leaf}) of this
        rank's parts
        (``ClipAdam``'s clip): a leaf split over 'model' sums its squares
        over the model group, a stage's block over the pipe group, a
        replicated leaf counts once."""
        flat = (grads if all(isinstance(k, tuple) for k in grads)
                else flatten(grads))
        any_leaf = next(iter(flat.values()))
        parts = {"split": [], "stage": [], "replicated": []}
        for path, g in flat.items():
            if self.tp > 1 and tp_mod.split_dim(path) is not None:
                kind = "split"
            elif self.pp > 1 and "blocks" in path:
                kind = "stage"
            else:
                kind = "replicated"
            parts[kind].append((g * g).sum())
        sq = {k: (torch.stack(v).sum() if v
                  else any_leaf.new_zeros(())).reshape(1)
              for k, v in parts.items()}
        if self.model is not None:
            self.model.sum_(sq["split"])
        stage = sq["stage"] + sq["split"]
        if self.pipe is not None:
            self.pipe.sum_(stage)
        return torch.sqrt(sq["replicated"] + stage)[0]


def model_parallel(cfg, batch_sizes=()):
    """The ``Mesh`` a trainer runs tensor and pipeline parallelism over,
    or None when ``hw.tp`` and ``hw.pp`` are both 1 (``data_parallel``
    then picks the path).

    The group's world must be dp pp tp, ``hw.dp`` 0 taking what is left
    (JAX's "all devices"); raises a ValueError otherwise (no run drops
    quietly to fewer ranks), and when a batch size does not divide over
    the data axis (the JAX package's message, ``train/train_vae.py:279``
    there)."""
    tp = int(cfg.hw.get("tp", 1) or 1)
    pp = int(cfg.hw.get("pp", 1) or 1)
    if tp == pp == 1:
        return None
    world = world_size()
    n_dp = int(cfg.hw.get("dp", 1))
    if n_dp == 0:
        n_dp = max(world // (tp * pp), 1)
    if n_dp * pp * tp != world:
        raise ValueError(
            f"hw.dp {n_dp} x hw.pp {pp} x hw.tp {tp} is {n_dp * pp * tp} "
            f"rank(s) but the process group has {world}: run one process a "
            f"rank, e.g. python -m torch.distributed.run --nproc_per_node "
            f"{n_dp * pp * tp} -m controlled_peptide_generation_tpu_torch"
            f".main ... --hw.tp {tp} --hw.pp {pp} (hw.dp 0 takes the rest "
            f"of the group)")
    for b in batch_sizes:
        if int(b) % n_dp:
            raise ValueError(f"batch_size {b} must divide over {n_dp} "
                             f"data-parallel devices")
    return Mesh(n_dp, pp, tp)


def parallel_layout(cfg, batch_sizes=()):
    """(mesh, shard) of a trainer: the ``Mesh`` of ``model_parallel`` and
    its data axis when hw.tp or hw.pp > 1, else (None, the ``Shard`` of
    ``data_parallel``); (None, None) is the one-device path."""
    mesh = model_parallel(cfg, batch_sizes)
    if mesh is None:
        return None, data_parallel(cfg, batch_sizes)
    return mesh, mesh.data


def is_writer():
    """True on the rank that writes logs, checkpoints and samples (rank
    0, or the only process)."""
    return rank() == 0


@contextlib.contextmanager
def writer_first():
    """Rank 0 runs the block first (it may write shared files, such as a
    synthetic corpus), the other ranks after it; without a group, just the
    block."""
    grouped = world_size() > 1
    if grouped and not is_writer():
        dist.barrier()
    yield
    if grouped and is_writer():
        dist.barrier()


def _worker(rank_, fn, world, store_dir, backend, threads, args):
    if threads:
        torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank_,
                            world_size=world)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world, *args, backend="gloo", threads=1):
    """Run ``fn(*args)`` in ``world`` new processes, rank r of a group of
    ``world`` over ``backend`` (gloo or nccl), and wait for them; raises
    when a rank fails. ``threads`` pins each rank's torch threads (0
    leaves the default). ``fn`` reads its rank from
    ``torch.distributed.get_rank()``."""
    import torch.multiprocessing as mp
    store_dir = tempfile.mkdtemp(prefix="dp_store_")
    try:
        mp.spawn(_worker, args=(fn, world, store_dir, backend, threads,
                                args), nprocs=world, join=True)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
