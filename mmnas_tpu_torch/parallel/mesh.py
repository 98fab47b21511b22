"""Data parallelism over torch.distributed: one process per card
(counterpart of mmnas_tpu/parallel/mesh.py).

The reference trains and searches with mp.spawn + DDP over NCCL
(train_vqa.py:541-551): each rank takes BATCH_SIZE examples from a
rank-strided sampler, its loss is a SUM over them, and DDP averages the
gradients over the ranks. The JAX package keeps those dynamics on a device
mesh (a global batch of BATCH_SIZE * n_shards, the gradients divided by
n_shards). The port runs the reference's layout with the JAX package's
semantics:

- `init` joins the process group: NCCL when the process's device is a
  card, gloo when the caller asks for the CPU (the tests), a timeout on
  every collective;
- `all_reduce_grads` sums the gradients over the ranks in flat buckets,
  one all_reduce per bucket, and divides them by the world size, before the
  engines' clip. It is the JAX package's psum / n_shards; DDP is not used,
  because the engines take their gradients with torch.autograd.grad over
  explicit leaves and the search's weight step leaves most branches unused;
- `broadcast_params` copies rank 0's parameters to every rank, after the
  init and after a resume (the JAX package's `replicate`);
- `allgather_host_order` gathers per-rank eval outputs into dataset order
  (`gather_rows`, then the JAX package's `eval_dataset_order`);
- `launch` starts one process per card of --GPU (or of the first --NDEV
  cards) with torch.multiprocessing.spawn, or joins torchrun's group
  under --MULTIHOST; a bare command runs one process and no group.

With no group every function is the single-process identity, so the
engines' one-card path is unchanged. `COUNTS` counts the collectives each
kind of call issued (the smoke run reads the all-reduces per step).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

# every collective's limit: a rank that died leaves the others waiting
# at most this long
TIMEOUT = datetime.timedelta(seconds=600)
# bytes of gradient per all_reduce (DDP's default bucket size)
BUCKET_BYTES = 25 * 2**20

# collectives issued, by kind: "all_reduce" (gradient buckets), "broadcast"
# (parameter buckets), "sum" (loss sums) and "gather" (eval outputs, scores)
COUNTS: Dict[str, int] = {"all_reduce": 0, "broadcast": 0, "sum": 0, "gather": 0}


def zero_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


# ------------------------------------------------------------ process group
def init(rank: int, world: int, device: torch.device, init_method: str = "env://",
         timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the process group as `rank` of `world`: NCCL on a CUDA
    `device` (made the process's current card), gloo on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def data_axis_size() -> int:
    """The data shards: one per process, each on its own card."""
    return world_size()


def is_writer() -> bool:
    """Rank 0 alone writes logs, checkpoints and genotype archives."""
    return rank() == 0


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def _wire_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# -------------------------------------------------------------- gradients
def buckets(tensors: Sequence[torch.Tensor], limit: int = BUCKET_BYTES) -> List[List[int]]:
    """The indices of `tensors` in flat buckets, in order: a bucket holds
    one dtype and closes once it reaches `limit` bytes."""
    out: List[List[int]] = []
    size, dtype = 0, None
    for i, t in enumerate(tensors):
        if not out or t.dtype != dtype or size >= limit:
            out.append([])
            size, dtype = 0, t.dtype
        out[-1].append(i)
        size += t.numel() * t.element_size()
    return out


def _in_buckets(tensors: Sequence[torch.Tensor], collective: Callable) -> None:
    """collective(flat) on each bucket of `tensors` flattened, the result
    copied back into them."""
    with torch.no_grad():
        for idx in buckets(tensors):
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
            collective(flat)
            offset = 0
            for i in idx:
                n = tensors[i].numel()
                tensors[i].copy_(flat[offset:offset + n].view_as(tensors[i]))
                offset += n


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> None:
    """Sum `grads` over the ranks and divide them by the world size, in
    place: each bucket flattened, one all_reduce(SUM), copied back. Every
    rank must pass tensors of the same shapes in the same order. With no
    group nothing changes."""
    if not is_initialized():
        return
    world = world_size()

    def reduce(flat):
        dist.all_reduce(flat)
        COUNTS["all_reduce"] += 1
        flat.div_(world)

    _in_buckets(grads, reduce)


def broadcast_params(tensors: Sequence[torch.Tensor]) -> None:
    """Copy rank 0's `tensors` (parameters, alpha) to every rank, in place,
    in flat buckets. With no group nothing changes."""
    if not is_initialized():
        return

    def broadcast(flat):
        dist.broadcast(flat, src=0)
        COUNTS["broadcast"] += 1

    _in_buckets(tensors, broadcast)


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks (a new tensor on `t`'s device)."""
    if not is_initialized():
        return t
    out = t.detach().to(_wire_device(), copy=True)
    dist.all_reduce(out)
    COUNTS["sum"] += 1
    return out.to(t.device)


# ------------------------------------------------------------ eval outputs
def gather_tensor(local: torch.Tensor) -> torch.Tensor:
    """Every rank's `local` (the same shape on every rank), concatenated
    along the leading axis in rank order, on `local`'s device."""
    if not is_initialized() or world_size() == 1:
        return local
    wire = local.to(_wire_device()).contiguous()
    parts = [torch.empty_like(wire) for _ in range(world_size())]
    dist.all_gather(parts, wire)
    COUNTS["gather"] += 1
    return torch.cat(parts).to(local.device)


def gather_rows(local: np.ndarray) -> np.ndarray:
    """`gather_tensor` of a host array: [world * n, ...], rank-major."""
    if world_size() == 1:
        return local
    return gather_tensor(torch.from_numpy(np.ascontiguousarray(local))).numpy()


def eval_dataset_order(outs: np.ndarray, per_process_bs: int, n_items: int,
                       world: int) -> np.ndarray:
    """Reorder eval outputs collected from GLOBAL batches into sampler
    (dataset/subset) order and drop all padding.

    Each global batch is rank-MAJOR (the `world` ranks' per_process_bs rows
    one after another), while the sampler deals positions rank-STRIDED
    (pos = k * world + rank, data/sampler.py). Inverting both is the
    reference's interleaved all_gather reassembly (train_vqa.py:382-395).
    Truncating to n_items (= len(sampler.subset_indices)) removes both the
    sampler divisibility pad and the loader's pad_to_full cycling: every
    padded entry has per-rank position k >= num_samples, hence sampler
    pos >= n_items. The JAX package's function with the world size as an
    argument in place of jax.process_count()."""
    pc = world
    nb = outs.shape[0] // (per_process_bs * pc)
    out = outs.reshape((nb, pc, per_process_bs) + outs.shape[1:])
    out = out.swapaxes(1, 2).reshape((-1,) + outs.shape[1:])
    return out[:n_items]


def allgather_host_order(local: np.ndarray, n_items: int) -> np.ndarray:
    """Every rank's rows of a per-rank eval array (in its loader's order,
    the same count on every rank) in sampler order, the padding dropped.
    Collective: every rank calls it."""
    world = world_size()
    if world == 1:
        return local[:n_items]
    return eval_dataset_order(gather_rows(local), len(local), n_items, world)


# ---------------------------------------------------------------- launcher
def card_ids(gpu: str, n_devices: int) -> List[int]:
    """The cards of a run: the comma-separated --GPU ids, or with
    --NDEV N > 1 the first N cards; 0 and 1 keep the one --GPU card."""
    ids = [int(g) for g in str(gpu).split(",") if g.strip()]
    if n_devices > 1 and len(ids) == 1:
        ids = list(range(n_devices))
    return ids


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _member(index: int, fn: Callable, args: tuple, devices: List[torch.device],
            port: int, timeout: datetime.timedelta) -> None:
    """One spawned process: join the group as rank `index`, run
    fn(device, *args), leave the group even when fn raises."""
    init(index, len(devices), devices[index], f"tcp://localhost:{port}", timeout)
    try:
        fn(devices[index], *args)
    finally:
        shutdown()


def spawn(fn: Callable, args: tuple, devices: Sequence[torch.device],
          timeout: datetime.timedelta = TIMEOUT) -> None:
    """Run fn(device, *args) in one process per entry of `devices`, rank i
    on devices[i], in one group (NCCL on cards, gloo on the CPU) whose
    collectives wait at most `timeout`. `fn` must be importable by name.
    Returns when every process has; a process that raises ends the others
    and the error is raised here."""
    import torch.multiprocessing as mp

    devices = [torch.device(d) for d in devices]
    mp.spawn(_member, args=(fn, args, devices, free_port(), timeout), nprocs=len(devices),
             join=True)


def launch(fn: Callable, args: tuple, gpu: str = "0", n_devices: int = 0,
           multihost: bool = False):
    """The CLIs' entry: fn(device, *args) on the run's cards.

    - multihost: one process of torchrun's group (RANK, WORLD_SIZE,
      LOCAL_RANK, MASTER_ADDR, MASTER_PORT from its environment) on
      cuda:LOCAL_RANK;
    - several cards (--GPU 0,1 or --NDEV N): one spawned process per card;
    - else fn's result on the one card, no group."""
    if multihost:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), device)
        try:
            return fn(device, *args)
        finally:
            shutdown()
    ids = card_ids(gpu, n_devices)
    have = torch.cuda.device_count()
    if not ids or len(set(ids)) != len(ids) or max(ids) >= have or min(ids) < 0:
        raise ValueError(f"cards {ids} asked for, this machine has {have}: one process "
                         "per card, each on a card of its own")
    if len(ids) == 1:
        return fn(torch.device("cuda", ids[0]), *args)
    spawn(fn, args, [torch.device("cuda", i) for i in ids])
    return None


def run_engine(device: torch.device, engine: type, cfg):
    """engine(cfg, device).run(), the CLIs' process body, with rank 0's cfg
    on every rank: under torchrun each process parses its own arguments,
    and a SEED left to chance would differ (the search samples its paths
    from it, and every rank must run the same paths)."""
    if is_initialized():
        box = [cfg]
        dist.broadcast_object_list(box, src=0)
        cfg = box[0]
    return engine(cfg, device).run()
