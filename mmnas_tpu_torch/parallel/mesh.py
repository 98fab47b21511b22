"""Data and tensor parallelism over torch.distributed: one process per
card (counterpart of mmnas_tpu/parallel/mesh.py).

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
- `all_reduce_grads` sums the gradients over the data shards in flat
  buckets, one all_reduce per bucket, and divides them by their count,
  before the engines' clip. It is the JAX package's psum / n_shards; DDP is
  not used, because the engines take their gradients with
  torch.autograd.grad over explicit leaves and the search's weight step
  leaves most branches unused;
- `broadcast_params` copies data shard 0's parameters (each model rank's
  shard) to every data shard, after the init and after a resume (the JAX
  package's `replicate`);
- `allgather_host_order` gathers per-rank eval outputs into dataset order
  (`gather_rows`, then the JAX package's `eval_dataset_order`);
- `launch` starts one process per card of --GPU (or of the first --NDEV
  cards) with torch.multiprocessing.spawn, or joins torchrun's group
  under --MULTIHOST; a bare command runs one process and no group;
  `run_engine` lays the group out in the grid of the run's --MODEL_AXIS.

Tensor parallelism (--MODEL_AXIS M > 1, parallel/sharding.py) lays the
ranks out as the JAX package's `get_mesh` lays out its devices: a grid of
world / M data shards by M model shards, rank r on data shard r // M and
model shard r % M. `init` (or `make_grid`, for a group joined before the
model axis was known) builds one process group per model shard's column
(the data group: the ranks that share the model shard, over which the
batch is split) and one per data shard's row (the model group: the ranks
that split one data shard's layers). The gradients, the loss sums, the
eval gathers and the parameter broadcast run over the data group; the
megatron collectives of sharding.py over the model group. At M = 1 the
data group is the whole world and no model group exists.

With no group every function is the single-process identity, so the
engines' one-card path is unchanged. `COUNTS` counts the collectives each
kind of call issued over the data group (the smoke run reads the
all-reduces per step), `MODEL_COUNTS` those over the model group.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Dict, List, Optional, Sequence

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
# collectives over the model group: "all_reduce" (the row-parallel outputs'
# partial sums forward, the column-parallel inputs' gradients backward, the
# clip's squares) and "gather" (whole ops' weights, checkpoints)
MODEL_COUNTS: Dict[str, int] = {"all_reduce": 0, "gather": 0}

# this process's place in the (data, model) grid: the model axis, its data
# and model groups (None: the default group, or none at all) and the
# collectives' limit they take
_GRID = {"model_axis": 1, "data": None, "model": None, "timeout": TIMEOUT}


def zero_counts() -> None:
    for counts in (COUNTS, MODEL_COUNTS):
        for k in counts:
            counts[k] = 0


# ------------------------------------------------------------ process group
def init(rank: int, world: int, device: torch.device, init_method: str = "env://",
         timeout: datetime.timedelta = TIMEOUT, model_axis: int = 1,
         backend: Optional[str] = None) -> None:
    """Join the process group as `rank` of `world`: NCCL on a CUDA
    `device` (made the process's current card), gloo on the CPU, or
    `backend` when given (gloo between processes that share one card:
    NCCL refuses two ranks on a card); then the grid of `model_axis`."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    _GRID["timeout"] = timeout
    make_grid(model_axis)


def make_grid(model_axis: int) -> None:
    """Lay the group's ranks out as world / model_axis data shards by
    model_axis model shards (rank r: data shard r // M, model shard r % M)
    and build the data and model groups; every rank creates every group,
    in the same order. A world model_axis does not divide is refused as the
    JAX package refuses it (mmnas_tpu/parallel/mesh.py:41-42)."""
    world = world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"n_devices {world} not divisible by model_axis {model_axis}")
    if model_axis == _GRID["model_axis"]:
        return
    if _GRID["model_axis"] != 1:
        raise RuntimeError(f"the grid has model axis {_GRID['model_axis']} already")
    me, n_data, timeout = rank(), world // model_axis, _GRID["timeout"]
    for d in range(n_data):
        ranks = [d * model_axis + m for m in range(model_axis)]
        group = dist.new_group(ranks, timeout=timeout)
        if me in ranks:
            _GRID["model"] = group
    for m in range(model_axis):
        ranks = [d * model_axis + m for d in range(n_data)]
        group = dist.new_group(ranks, timeout=timeout)
        if me in ranks:
            _GRID["data"] = group
    _GRID["model_axis"] = model_axis


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()
    _GRID.update(model_axis=1, data=None, model=None, timeout=TIMEOUT)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def model_axis_size() -> int:
    """The model shards of each data shard: 1 outside tensor parallelism."""
    return _GRID["model_axis"]


def model_rank() -> int:
    """This process's model shard, r % M."""
    return rank() % model_axis_size()


def data_axis_size() -> int:
    """The data shards: world / M (one per process without tensor
    parallelism)."""
    return world_size() // model_axis_size()


def data_rank() -> int:
    """This process's data shard, r // M: it picks the batch and the
    dropout seeds, which the model ranks of one data shard share."""
    return rank() // model_axis_size()


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
    """collective(flat) on each bucket of `tensors` flattened (on the
    group's wire device: a card's tensors cross the host under gloo), the
    result copied back into them."""
    with torch.no_grad():
        for idx in buckets(tensors):
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx]).to(_wire_device())
            collective(flat)
            offset = 0
            for i in idx:
                n = tensors[i].numel()
                tensors[i].copy_(flat[offset:offset + n].view_as(tensors[i]))
                offset += n


def all_reduce_grads(grads: Sequence[torch.Tensor], mean: bool = True) -> None:
    """Sum `grads` over the data group and (with `mean`) divide them by its
    size, in place: each bucket flattened, one all_reduce(SUM), copied
    back. Every rank of the group must pass tensors of the same shapes in
    the same order (under tensor parallelism each model shard's column
    holds the same shards). With no group nothing changes."""
    if not is_initialized():
        return
    n = data_axis_size()

    def reduce(flat):
        dist.all_reduce(flat, group=_GRID["data"])
        COUNTS["all_reduce"] += 1
        if mean:
            flat.div_(n)

    _in_buckets(grads, reduce)


def broadcast_params(tensors: Sequence[torch.Tensor]) -> None:
    """Copy data rank 0's `tensors` (parameters or their shards, alpha) to
    every rank of its data group, in place, in flat buckets. With no group
    nothing changes."""
    if not is_initialized():
        return

    def broadcast(flat):
        # the global rank of data rank 0 in this model shard's column
        dist.broadcast(flat, src=model_rank(), group=_GRID["data"])
        COUNTS["broadcast"] += 1

    _in_buckets(tensors, broadcast)


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the data group (a new tensor on `t`'s device)."""
    if not is_initialized():
        return t
    out = t.detach().to(_wire_device(), copy=True)
    dist.all_reduce(out, group=_GRID["data"])
    COUNTS["sum"] += 1
    return out.to(t.device)


# ------------------------------------------------------------ model group
def _wire_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a model-group collective carries `t` in: fp32 for the
    16-bit floats (the partial sums of bf16 activations add in fp32, and
    gloo takes no bf16), else t's own."""
    return torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype


def model_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the model group, a new tensor on `t`'s device in
    its dtype (`t` itself at M = 1)."""
    if model_axis_size() == 1:
        return t
    out = t.detach().to(_wire_device(), _wire_dtype(t), copy=True)
    dist.all_reduce(out, group=_GRID["model"])
    MODEL_COUNTS["all_reduce"] += 1
    return out.to(t.device, t.dtype)


def model_all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every model rank's `t` (the same shape on each), in model-rank order,
    on `t`'s device in its dtype."""
    if model_axis_size() == 1:
        return [t]
    wire = t.detach().to(_wire_device(), _wire_dtype(t)).contiguous()
    parts = [torch.empty_like(wire) for _ in range(model_axis_size())]
    dist.all_gather(parts, wire, group=_GRID["model"])
    MODEL_COUNTS["gather"] += 1
    return [p.to(t.device, t.dtype) for p in parts]


# ------------------------------------------------------------ eval outputs
def gather_tensor(local: torch.Tensor) -> torch.Tensor:
    """Every data rank's `local` (the same shape on every rank),
    concatenated along the leading axis in data-rank order, on `local`'s
    device."""
    if not is_initialized() or data_axis_size() == 1:
        return local
    wire = local.to(_wire_device()).contiguous()
    parts = [torch.empty_like(wire) for _ in range(data_axis_size())]
    dist.all_gather(parts, wire, group=_GRID["data"])
    COUNTS["gather"] += 1
    return torch.cat(parts).to(local.device)


def gather_rows(local: np.ndarray) -> np.ndarray:
    """`gather_tensor` of a host array: [data shards * n, ...], rank-major."""
    if data_axis_size() == 1:
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
    """Every data rank's rows of a per-rank eval array (in its loader's
    order, the same count on every rank) in sampler order, the padding
    dropped. Collective: every rank calls it."""
    world = data_axis_size()
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
            port: int, timeout: datetime.timedelta, model_axis: int = 1,
            backend: Optional[str] = None) -> None:
    """One spawned process: join the group as rank `index`, run
    fn(device, *args), leave the group even when fn raises."""
    init(index, len(devices), devices[index], f"tcp://localhost:{port}", timeout, model_axis,
         backend)
    try:
        fn(devices[index], *args)
    finally:
        shutdown()


def spawn(fn: Callable, args: tuple, devices: Sequence[torch.device],
          timeout: datetime.timedelta = TIMEOUT, model_axis: int = 1,
          backend: Optional[str] = None) -> None:
    """Run fn(device, *args) in one process per entry of `devices`, rank i
    on devices[i], in one group (NCCL on cards, gloo on the CPU, or
    `backend`) whose collectives wait at most `timeout`, laid out in the
    grid of `model_axis`. `fn` must be importable by name. Returns when
    every process has; a process that raises ends the others and the error
    is raised here."""
    import torch.multiprocessing as mp

    devices = [torch.device(d) for d in devices]
    if len(devices) % model_axis:
        raise ValueError(f"n_devices {len(devices)} not divisible by model_axis {model_axis}")
    mp.spawn(_member, args=(fn, args, devices, free_port(), timeout, model_axis, backend),
             nprocs=len(devices), join=True)


def launch(fn: Callable, args: tuple, gpu: str = "0", n_devices: int = 0,
           multihost: bool = False):
    """The CLIs' entry: fn(device, *args) on the run's cards.

    - multihost: one process of torchrun's group (RANK, WORLD_SIZE,
      LOCAL_RANK, MASTER_ADDR, MASTER_PORT from its environment) on
      cuda:LOCAL_RANK;
    - several cards (--GPU 0,1 or --NDEV N): one spawned process per card;
    - else fn's result on the one card, no group.

    The grid's model axis comes with the engine's cfg (`run_engine`)."""
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
    on every rank (under torchrun each process parses its own arguments,
    and a SEED left to chance would differ: the search samples its paths
    from it, and every rank must run the same paths), in the grid of
    cfg.MODEL_AXIS (refused when it does not divide the world)."""
    if is_initialized():
        box = [cfg]
        dist.broadcast_object_list(box, src=0)
        cfg = box[0]
        make_grid(cfg.MODEL_AXIS)
    elif cfg.MODEL_AXIS != 1:
        raise ValueError(f"n_devices 1 not divisible by model_axis {cfg.MODEL_AXIS}")
    return engine(cfg, device).run()
