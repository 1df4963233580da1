"""Process groups for data parallelism: the counterpart of the JAX
package's ``get_mesh`` and ``initialize_multihost`` (``parallel/mesh.py:31,
50`` there).

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
