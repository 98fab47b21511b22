"""Bilevel supernet search for VQA on one device, or data-parallel on
several (counterpart of mmnas_tpu/engine/search.py).

`SearchExecution(cfg, device).run()` splits one dataset 80/20 into a weight
loader and an arch loader (search_vqa.py:560-583), builds `NetSearch` and
alternates, per epoch (search_vqa.py:268-337):

- a WEIGHT step on every batch of the weight split: sample one op per node
  (KPATH > 1: K paths, each on the stride slice batch[k::K], their losses
  summed into one backward), run only the sampled ops, and update only
  their parameters: the gradient is taken of the parameters the union of
  the paths' masks selects, clipped at NET_GRAD_CLIP over those (the others'
  gradients are 0 in the JAX package and change no norm), and WarmupAdam
  steps under the mask, so a masked-out parameter moves neither itself, nor
  its moments, nor its step count;
- from epoch ALPHA_START, an ARCH step every ALPHA_EVERY weight steps on the
  next batch of the arch split (cycled): every op runs under
  straight-through gates ('full') or the sampled pair ('two'), and only
  alpha is differentiated. The net's parameters enter detached, so no net
  gradient is computed, and the fused attention's backward runs no relation
  pass. Adam(ALPHA_LR_BASE, betas (0, 0.999)) steps alpha, and 'two' mode
  rescales the pair's logits (mixed.py:200-208).

Per epoch it writes a checkpoint {state_dict, net_optim, alpha, alpha_optim,
epoch} in the JAX package's pickle format (either package resumes from the
other's), appends the argmax genotype to ARCH_ROOT/<VERSION>.json (reset on
the first epoch unless resuming) and, with EVAL_EVERY_EPOCH, evaluates the
argmax path on the arch split.

Sampling is on the host (models/supernet.py): a host copy of alpha, renewed
after each arch step, and a CPU generator seeded from SEED and the global
step, one stream for weight steps and another for arch steps (the JAX
package folds global_step and 1e9 + global_step into its key), so a resumed
run samples what an uninterrupted one would. The device's dropout generator
is reseeded the same way. The streams are not the JAX package's; the
parity tests feed the JAX engine the paths this engine recorded
(`SearchResult.paths`). Under --DTYPE bfloat16 each step computes with
`compute_params` (bf16 casts of the fp32 masters); alpha, the gates'
softmax, Adam and the clip stay fp32.

Data parallel (parallel/mesh.py): both loaders are rank-strided, so each
rank takes BATCH_SIZE examples a weight step and an arch step; every rank
samples the same paths (the host generators' seeds depend on SEED and the
step, never the rank, and alpha is the same on every rank), so the weight
step's masked gradients and the arch step's alpha gradients are averaged
over the ranks in the same buckets before the clip and Adam. Dropout
draws its own masks on each rank. Rank 0 alone writes the checkpoint, the
genotype archive and the log; the eval gathers the ranks' predictions.

Tensor parallel (--MODEL_AXIS M > 1, parallel/sharding.py): the supernet
is built whole from the seed and sliced to the model rank's shard; the
loaders, the dropout seeds, the loss sums, the all-reduces and the eval
gathers go by data shard (engine/vqa.py), and every rank samples the same
paths, so the weight step's mask selects the same leaves, whole or
sharded, on every rank. The clip's norm is the whole gradient's; the
checkpoint holds the gathered, unsharded pytree.

The weight step's program (mmnas_tpu/engine/search.py:101-121): 'sampled'
by default; --DENSE_WEIGHT runs mode 'full' (every op, one-hot
straight-through gates from a detached alpha, the inactive outputs
detached), --UNIFIED_WEIGHT mode 'unified' (no branch on the path: the
indices on the device, the decoder's attention candidates one program) and
--HYBRID_WEIGHT mode 'hybrid' (the unified encoder, the sampled decoder).
Their forward and gradients are the sampled program's; the mask, the clip
and Adam are the same. Those three run ops off the path, so under bfloat16
they compute with every parameter's cast, as the JAX package casts every
leaf. They take KPATH 1 only. The arch steps, the eval and ITM's mining
keep their modes.

SCAN_STEPS N (mmnas_tpu/engine/search.py:226-295, :399-431): an epoch's
weight steps run in chunks of N, the arch steps at the same positions
((i+1) % ALPHA_EVERY == 0, N a multiple of ALPHA_EVERY) on the same
arch-loader batches in the same order, and the sub-chunk tail on the
per-step path above; a run gives the per-step loop's paths and states. The
run takes one of two dispatches, printed once a run:

- 'graph': the weight step and the arch step each as one CUDA graph,
  captured at their first use and replayed once a step, where the path
  decides nothing on the host: --UNIFIED_WEIGHT or --DENSE_WEIGHT with
  'full' arch steps, in one process. A chunk ships its N weight batches,
  its arch batches and every uniform its paths need (drawn ahead on the
  host from the same per-step generators: they do not depend on alpha) to
  the device in one copy (`ship`), and samples each path there against the
  device alpha (NetSearch.indices_from_uniforms), to the host loop's
  indices. Inside the graphs the path, the optimizer's mask, its step
  counts, bias corrections and lr are device tensors (optimizer.py
  `step_device`); before each replay the step's inputs are copied into the
  graph's buffers and the dropout generator is reseeded with the step's
  seed, as the per-step loop reseeds it, so each replay draws that step's
  masks. Nothing is read back between replays: the paths, the losses, the
  step counts and alpha's host copy are read once a chunk. `chunk_log`
  keeps, for each graph, the attention kernels' launches of its warm-up
  and of its capture (a replay launches the captured ones again: no Python
  wrapper runs) and its replays; for the run, each chunk's wall time and
  the launches made eagerly in the chunks besides the warm-ups and
  captures (none). On the CPU (no CUDA graphs) the same step programs run
  eagerly. A capture that fails raises.
- 'eager': the sampled program, KPATH > 1, --HYBRID_WEIGHT's decoder,
  'two' arch steps and a data-parallel group choose their ops (or
  collectives) on the host, and NET_OPTIM 'sgd' has no device step: the
  epoch runs on the per-step loop, which is what a chunk of those steps
  would run.
"""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from mmnas_tpu_torch.data.loader import Loader
from mmnas_tpu_torch.engine.vqa import (
    batch_to_device, bce_with_logits_sum, check_int8_shipping, save_on_writer, shard_sampler,
    step_seed,
)
from mmnas_tpu_torch.genotype import append_genotype
from mmnas_tpu_torch.models.convert import (
    alpha_from_jax, alpha_optim_state_from_jax, alpha_optim_state_to_jax, alpha_to_jax,
)
from mmnas_tpu_torch.models.net import INPUT_KEYS, compute_call, compute_params
from mmnas_tpu_torch.models.supernet import CELLS, NetSearch
from mmnas_tpu_torch.ops import fused_attention as FA
from mmnas_tpu_torch.parallel import mesh as pmesh
from mmnas_tpu_torch.parallel.sharding import shard_module, split_flags
from mmnas_tpu_torch.train.checkpoint import (
    ckpt_path, load_checkpoint, load_optim_state, load_params, optim_tree, params_tree,
)
from mmnas_tpu_torch.train.optimizer import (
    WarmupAdam, build_net_optimizer, clip_by_global_norm, plain_adam,
)
from mmnas_tpu_torch.utils.logger import TextLogger
from mmnas_tpu_torch.utils.profiling import epoch_trace

ARCH_STREAM = 1_000_000_000  # arch step s draws from stream ARCH_STREAM + s


# the weight step's forward mode by flag, in the JAX package's order of precedence
WEIGHT_MODES = (("DENSE_WEIGHT_STEP", "full"), ("UNIFIED_WEIGHT_STEP", "unified"),
                ("HYBRID_WEIGHT_STEP", "hybrid"))


def weight_mode(cfg) -> str:
    """The NetSearch mode of the weight step (mmnas_tpu/engine/search.py:108-121)."""
    return next((mode for flag, mode in WEIGHT_MODES if getattr(cfg, flag)), "sampled")


def sample_seed(seed: int, global_step: int) -> int:
    """The seed of the host generator that samples the paths of one step,
    apart from that step's dropout seed (`step_seed`)."""
    return step_seed(seed + 0x9E3779B9, global_step)


def host_copy(alpha: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The host copy of alpha that sampling reads: one small device-to-host
    copy, made after each arch step."""
    return {c: a.detach().to("cpu", copy=True).numpy() for c, a in alpha.items()}


def ship(arrays: Mapping[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """The host arrays as tensors on `device` by one host-to-device copy:
    packed into one byte buffer, each at a 256-byte boundary, copied, and
    viewed back in their dtypes and shapes."""
    at, total = {}, 0
    for k, a in arrays.items():
        a = np.ascontiguousarray(a)
        at[k] = (total, a)
        total += -(-a.nbytes // 256) * 256
    buf = np.empty(total, np.uint8)
    for off, a in at.values():
        buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    flat = torch.from_numpy(buf).to(device)
    return {k: flat[off:off + a.nbytes].view(torch.from_numpy(a[:0]).dtype).view(a.shape)
            for k, (off, a) in at.items()}


def read_paths(idxs: Sequence[Mapping[str, torch.Tensor]]) -> List[Dict[str, np.ndarray]]:
    """Device paths (one dict of index tensors a path) on the host, by one
    device-to-host read."""
    flat = torch.cat([idx[c].reshape(-1) for idx in idxs for c in CELLS]).cpu().numpy()
    out, at = [], 0
    for idx in idxs:
        host = {}
        for c in CELLS:
            n = idx[c].numel()
            host[c] = flat[at:at + n].reshape(tuple(idx[c].shape))
            at += n
        out.append(host)
    return out


class StepProgram:
    """One search step (`fn`, reading the tensors of `inputs`, updating those
    of `state` in place, drawing dropout from `generator`) as a CUDA graph:
    captured at the first `run` on a CUDA device, then replayed. On the CPU
    `fn` runs eagerly at each `run`. `log` holds the attention kernels'
    launches of the warm-up (eager, before the capture) and of the capture,
    the replays and the capture's wall time."""

    def __init__(self, fn: Callable, inputs: Dict[str, torch.Tensor],
                 state: Sequence[torch.Tensor], generator: torch.Generator):
        self.fn, self.inputs, self.state, self.generator = fn, inputs, list(state), generator
        self.device = next(iter(inputs.values())).device
        self.graph, self.outputs = None, None
        self.log = {"warmup": {}, "captured": {}, "replays": 0, "capture_s": 0.0}

    def capture(self) -> None:
        """Warm up on a side stream (the first calls' lazy set-up stays out of
        the graph), put `state` back, then capture `fn` with the generator's
        draws registered to the graph."""
        saved = [t.clone() for t in self.state]
        launches = dict(FA.LAUNCHES)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.log["warmup"] = {k: FA.LAUNCHES[k] - launches[k] for k in launches}
        with torch.no_grad():
            for t, v in zip(self.state, saved):
                t.copy_(v)
        del saved
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.generator)
        launches = dict(FA.LAUNCHES)
        # no garbage collection inside the capture: freeing another graph (one
        # of an engine that died in a reference cycle) there breaks it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.outputs = self.fn()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.log["captured"] = {k: FA.LAUNCHES[k] - launches[k] for k in launches}
        self.log["capture_s"] = time.perf_counter() - t0

    def run(self, feed: Mapping[str, torch.Tensor], seed: int):
        """One step on the inputs `feed`, the generator reseeded with `seed`;
        returns `fn`'s outputs (a replay's are overwritten by the next)."""
        with torch.no_grad():
            for k, t in self.inputs.items():
                t.copy_(feed[k])
        if self.device.type != "cuda":
            self.generator.manual_seed(seed)
            return self.fn()
        if self.graph is None:
            self.capture()
        self.generator.manual_seed(seed)
        self.graph.replay()
        self.log["replays"] += 1
        return self.outputs


@dataclass
class SearchResult:
    net: NetSearch                       # the supernet, on the device
    alpha: Dict[str, torch.Tensor]       # the architecture weights, on the device
    opt_state: Dict                      # the net optimizer's state
    alpha_state: Dict                    # the alpha optimizer's state
    epoch_losses: List[float] = field(default_factory=list)  # summed loss / examples
    step_losses: List[float] = field(default_factory=list)   # per weight step, summed
    # the sampled paths in order: ("weight", global step, [one idx per path]),
    # ("arch", global step, idx) and ITM's ("mine", epoch, idx)
    paths: List[Tuple[str, int, object]] = field(default_factory=list)
    # the host copy of alpha that sampling reads, renewed after each arch step
    alpha_host: Dict[str, np.ndarray] = field(default_factory=dict)


class SearchExecution:
    TASK = "vqa"
    TARGET_KEYS = ("ans",)      # the batch keys a step reads besides INPUT_KEYS

    def __init__(self, cfg, device: torch.device):
        if cfg.KPATH > 1 and weight_mode(cfg) != "sampled":
            raise ValueError("KPATH > 1 requires the sampled weight step "
                             "(no DENSE/UNIFIED/HYBRID)")
        if cfg.ALPHA_BINARY_MODE not in ("full", "two"):
            # 'full_v2' is asserted off in the reference too (mixed.py:71)
            raise ValueError(f"ALPHA_BINARY_MODE={cfg.ALPHA_BINARY_MODE!r} (use 'full' or 'two')")
        if cfg.CKPT_BACKEND != "pickle":
            raise NotImplementedError("the port writes pickle checkpoints only: the orbax "
                                      "backend is not ported (ROADMAP.md, 'Not ported')")
        if cfg.BATCH_SIZE % cfg.KPATH:
            raise ValueError(f"batch {cfg.BATCH_SIZE} not divisible by KPATH={cfg.KPATH}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.logger = TextLogger(cfg.LOG_ROOT, cfg.VERSION)

    # ------------------------------------------------------------------ data
    def build_dataset(self):
        cfg = self.cfg
        if cfg.SYNTH:
            from mmnas_tpu_torch.data.synth import SynthVqaDataset
            return SynthVqaDataset(cfg, size=cfg.SYNTH_SIZE, seed=cfg.SEED)
        from mmnas_tpu_torch.data.vqa import VqaDataset
        return VqaDataset(cfg, "train")

    def make_loader(self, dataset, subset_indices) -> Loader:
        """Both bilevel loaders shuffle and use BATCH_SIZE a rank
        (search_vqa.py:560-583), rank-strided over the split."""
        check_int8_shipping(self.cfg, dataset)
        return Loader(dataset, self.cfg.BATCH_SIZE,
                      sampler=shard_sampler(len(dataset), True, subset_indices),
                      num_workers=self.cfg.NUM_WORKERS)

    def build_net(self, dataset) -> NetSearch:
        init_dict = {"token_size": dataset.token_size, "ans_size": dataset.ans_size,
                     "pretrained_emb": getattr(dataset, "pretrained_emb", None)}
        return shard_module(NetSearch(self.cfg, init_dict, task=self.TASK)).to(self.device)

    # ----------------------------------------------------------------- steps
    def loss(self, pred, batch):
        """BCEWithLogits sum (search_vqa.py:211,282)."""
        return bce_with_logits_sum(pred, batch["ans"])

    def forward_loss(self, run, batch):
        """The loss of one step's batch: `run(b)` is the supernet's train-mode
        forward on a batch `b` with the step's parameters, path, mode and
        generator. One forward and `self.loss` (mmnas_tpu/engine/search.py:73);
        ITM runs three (engine/search_itm.py)."""
        return self.loss(run(batch), batch)

    def on_epoch_start(self, result: SearchResult, dataset, epoch: int) -> None:
        """Per-epoch task hook, before the epoch's loaders start (ITM's
        hard-negative mining, mmnas_tpu/engine/search.py:80); none for VQA
        and VGD."""

    def path_loss(self, net: NetSearch, params: Mapping[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], idxs: Sequence[Mapping],
                  generator: torch.Generator, gates, mode: str):
        """The weight step's summed loss over the paths `idxs` (one per KPATH
        slice, by stride) in the program `mode`."""
        cfg, K = self.cfg, len(idxs)
        loss = 0.0
        for k, idx in enumerate(idxs):
            # a stride slice is a view; the kernels take contiguous tensors
            sl = batch if K == 1 else {key: v[k::K].contiguous() for key, v in batch.items()}
            loss = loss + self.forward_loss(
                lambda b, idx=idx: compute_call(
                    net, cfg, (b, gates, idx),
                    {"mode": mode, "train": True, "generator": generator}, params), sl)
        return loss

    def weight_step(self, net: NetSearch, optim, opt_state: Dict,
                    masters: Mapping[str, torch.nn.Parameter], batch: Dict[str, torch.Tensor],
                    idxs: Sequence[Mapping[str, np.ndarray]], generator: torch.Generator,
                    alpha: Mapping[str, torch.Tensor]):
        """One weight step on the paths `idxs` (one per KPATH slice, by
        stride) in the program of `weight_mode` (mode 'full' builds its gates
        from `alpha`, detached): (summed loss on the device, lr)."""
        cfg, mode = self.cfg, weight_mode(self.cfg)
        mask = net.update_mask(idxs[0])
        for idx in idxs[1:]:  # the union of the paths' masks
            other = net.update_mask(idx)
            mask = {n: max(m, other[n]) for n, m in mask.items()}
        names = [n for n, m in mask.items() if m > 0]
        # the sampled program runs, so casts, only the paths' parameters; the
        # others run ops off the path too, each in the compute dtype
        params = compute_params(net, cfg, names if mode == "sampled" else None)
        gates = {c: alpha[c].detach() for c in CELLS} if mode == "full" else None
        loss = self.path_loss(net, params, batch, idxs, generator, gates, mode)
        grads = self.net_grads(net, loss, masters, names)
        lr = optim.step(opt_state, masters, dict(zip(names, grads)), mask)
        return loss.detach(), lr

    def net_grads(self, net: NetSearch, loss, masters: Mapping[str, torch.nn.Parameter],
                  names: Sequence[str]) -> List[torch.Tensor]:
        """The gradients of `names`, averaged over the data group and clipped
        at NET_GRAD_CLIP over those (search_vqa.py:298). The clip's norm is
        taken over every parameter's slot in `masters`' order, 0 where a
        leaf is not in `names`: a step on the path's leaves rounds it as a
        step program that takes every leaf's gradient (0 off the path,
        `weight_program`) does."""
        grads = torch.autograd.grad(loss, [masters[n] for n in names], allow_unused=True)
        # a selected parameter the loss does not reach (the text-relation
        # stem) has a zero gradient, as in JAX: Adam still counts its step
        grads = [torch.zeros_like(masters[n]) if g is None else g for n, g in zip(names, grads)]
        pmesh.all_reduce_grads(grads)   # every rank ran the same paths: the same leaves
        if self.cfg.NET_GRAD_CLIP > 0:
            at = {n: i for i, n in enumerate(masters)}
            clip_by_global_norm(grads, self.cfg.NET_GRAD_CLIP, split_flags(net, names),
                                slots=([at[n] for n in names], len(at)))
        return grads

    def arch_grads(self, net: NetSearch, alpha: Mapping[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], idx: Mapping, generator: torch.Generator):
        """The arch step's loss on the path (or pairs, in 'two' mode) `idx`
        and the gradients of alpha alone, averaged over the data group."""
        mode = self.cfg.ALPHA_BINARY_MODE
        with torch.no_grad():
            params = {n: p.detach() for n, p in compute_params(net, self.cfg).items()}
        leaves = {c: alpha[c].detach().requires_grad_() for c in CELLS}
        loss = self.forward_loss(
            lambda b: functional_call(net, params, (b, leaves, idx),
                                      {"mode": mode, "train": True, "generator": generator},
                                      tie_weights=False), batch)
        grads = list(torch.autograd.grad(loss, [leaves[c] for c in CELLS]))
        pmesh.all_reduce_grads(grads)
        return loss, grads

    def arch_step(self, net: NetSearch, alpha_optim, alpha_state: Dict,
                  alpha: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                  idx: Mapping[str, np.ndarray], generator: torch.Generator):
        """One arch step on the path (or pairs, in 'two' mode) `idx`: the
        gradient of alpha alone, an Adam step on alpha in place. Returns the
        loss on the device."""
        mode = self.cfg.ALPHA_BINARY_MODE
        loss, grads = self.arch_grads(net, alpha, batch, idx, generator)
        alpha_old = {c: a.clone() for c, a in alpha.items()} if mode == "two" else None
        alpha_optim.step(alpha_state, alpha, dict(zip(CELLS, grads)))
        if mode == "two":
            # keep the pair's logsumexp (mixed.py:200-208)
            net.rescale_alpha(alpha_old, alpha, idx)
        return loss.detach()

    # ------------------------------------------------------------ main loop
    def alpha_optimizer(self):
        """Adam on alpha (mmnas_tpu/engine/search.py:318)."""
        cfg = self.cfg
        return plain_adam(cfg.ALPHA_LR_BASE, cfg.ALPHA_OPT_BETAS, eps=1e-8,
                          weight_decay=cfg.ALPHA_WEIGHT_DECAY)

    def steps(self, result: SearchResult, optim, alpha_optim,
              batches: Iterable[Dict[str, torch.Tensor]],
              next_arch_batch: Callable[[], Dict[str, torch.Tensor]], global_step: int,
              do_arch: bool, generator: torch.Generator):
        """Weight steps on the device batches `batches` from `global_step`
        and, with `do_arch`, an arch step on `next_arch_batch()` after every
        ALPHA_EVERY-th. Each step samples from `result.alpha_host`, renewed
        after each arch step, and is recorded in `result.paths`. Returns the
        weight steps' losses (on the device) and the last lr."""
        cfg, net = self.cfg, result.net
        masters = dict(net.named_parameters())
        losses, lr, rank = [], 0.0, pmesh.data_rank()
        for step, batch in enumerate(batches):
            sampler = torch.Generator().manual_seed(sample_seed(cfg.SEED, global_step))
            idxs = [net.sample_indices(result.alpha_host, sampler) for _ in range(cfg.KPATH)]
            generator.manual_seed(step_seed(cfg.SEED, global_step, rank))
            loss, lr = self.weight_step(net, optim, result.opt_state, masters, batch, idxs,
                                        generator, result.alpha)
            losses.append(loss)
            result.paths.append(("weight", global_step, idxs))
            if do_arch and (step + 1) % cfg.ALPHA_EVERY == 0:
                stream = ARCH_STREAM + global_step
                sampler = torch.Generator().manual_seed(sample_seed(cfg.SEED, stream))
                idx = (net.sample_indices_two(result.alpha_host, sampler)
                       if cfg.ALPHA_BINARY_MODE == "two"
                       else net.sample_indices(result.alpha_host, sampler))
                generator.manual_seed(step_seed(cfg.SEED, stream, rank))
                self.arch_step(net, alpha_optim, result.alpha_state, result.alpha,
                               next_arch_batch(), idx, generator)
                result.alpha_host = host_copy(result.alpha)
                result.paths.append(("arch", global_step, idx))
            global_step += 1
            if cfg.DEBUG:
                print(step, float(loss) / cfg.BATCH_SIZE)
        return losses, lr

    # ------------------------------------------------------------ SCAN_STEPS
    def chunk_dispatch(self) -> Tuple[str, str]:
        """('graph' or 'eager', why) for this run's SCAN_STEPS chunks."""
        cfg, mode = self.cfg, weight_mode(self.cfg)
        if mode not in ("unified", "full"):
            return "eager", f"the {mode} weight program chooses its ops by the path on the host"
        if cfg.ALPHA_BINARY_MODE != "full":
            return "eager", "'two' arch steps choose their ops by the pairs on the host"
        if cfg.NET_OPTIM == "sgd":
            return "eager", "the SGD net optimizer has no step on device tensors"
        if pmesh.is_initialized():
            return "eager", "the steps' collectives run on the host's process group"
        if self.device.type != "cuda":
            return "graph", f"the {mode} weight and 'full' arch steps as device programs, " \
                "run eagerly (no CUDA graphs on the CPU)"
        return "graph", f"the {mode} weight and 'full' arch steps captured as CUDA graphs, " \
            "replayed once a step"

    def chunk_draws(self, net: NetSearch, step0: int, n: int, do_arch: bool
                    ) -> Dict[str, np.ndarray]:
        """Every uniform the paths of steps step0 .. step0 + n - 1 draw, from
        the per-step loop's generators in its order (KPATH 1, 'full' arch
        steps: the step programs'): 'u.<cell>' [n, nodes] for the weight
        steps; 'a.u.<cell>' [n / ALPHA_EVERY, nodes] for the arch steps at
        (i+1) % ALPHA_EVERY == 0."""
        cfg, w, a = self.cfg, [], []
        for i in range(n):
            w.append(net.draw_uniforms(torch.Generator().manual_seed(
                sample_seed(cfg.SEED, step0 + i)), net.n_nodes))
            if do_arch and (i + 1) % cfg.ALPHA_EVERY == 0:
                a.append(net.draw_uniforms(torch.Generator().manual_seed(
                    sample_seed(cfg.SEED, ARCH_STREAM + step0 + i)), net.n_nodes))
        out = {}
        for prefix, draws in (("u.", w), ("a.u.", a)):
            if draws:
                out.update({prefix + c: torch.stack([d[c] for d in draws]).numpy()
                            for c in CELLS})
        return out

    def chunk(self, result: SearchResult, optim, alpha_optim,
              host_batches: Sequence[Dict[str, np.ndarray]],
              arch_batches: Sequence[Dict[str, np.ndarray]], global_step: int,
              generator: torch.Generator):
        """SCAN_STEPS weight steps from `global_step` on the host batches
        `host_batches` and, with `arch_batches` (one per ALPHA_EVERY steps),
        the arch steps between them, on the step programs (the 'graph'
        dispatch). Records the paths as the per-step loop does and renews
        `result.alpha_host`. Returns the losses (on the device) and the last
        lr."""
        net, n = result.net, len(host_batches)
        keys = [k for k in INPUT_KEYS + self.TARGET_KEYS if k in host_batches[0]]
        arrays = self.chunk_draws(net, global_step, n, bool(arch_batches))
        for prefix, batches in (("w.", host_batches), ("a.", arch_batches)):
            if batches:
                arrays.update({prefix + k: np.stack([b[k] for b in batches]) for k in keys})
        names = list(dict(net.named_parameters()))
        # the lr of each step, ahead (it depends on the step count alone)
        states = [dict(result.opt_state, step=result.opt_state.get("step", 0) + i)
                  for i in range(n)]
        arrays["lr"] = np.asarray([optim.rate(st) for st in states], np.float32)
        arrays["counts"] = optim.counts_of(result.opt_state, names)
        if arch_batches:
            arrays["a.lr"] = np.full(len(arch_batches), alpha_optim.rate(result.alpha_state),
                                     np.float32)
            arrays["a.counts"] = alpha_optim.counts_of(result.alpha_state, CELLS)
        losses, paths = self.graph_chunk(result, optim, alpha_optim, ship(arrays, self.device),
                                         keys, n, len(arch_batches), global_step, generator)
        result.paths += paths
        result.alpha_host = host_copy(result.alpha)
        return losses, arrays["lr"][-1]

    def weight_program(self, result: SearchResult, optim, dev, keys, generator) -> StepProgram:
        """The weight step with no host number that depends on the step: the
        path sampled on the device from the buffer 'u.<cell>', every
        parameter's gradient (an unsampled op's is 0), the mask of the path
        and the device step counts `prog.counts` in `step_device`. Returns
        (loss, path)."""
        cfg, net, mode = self.cfg, result.net, weight_mode(self.cfg)
        masters = dict(net.named_parameters())
        names = list(masters)
        inputs = {k: torch.empty_like(dev["w." + k][0]) for k in keys}
        inputs.update({k: torch.empty_like(dev[k][0]) for k in ["lr"] + [f"u.{c}" for c in CELLS]})
        counts = torch.empty_like(dev["counts"])
        # no count passes the run's steps past the largest count it started from
        bias = torch.from_numpy(optim.bias_table(
            self.total_steps + int(dev["counts"].max()))).to(self.device)

        def fn():
            idx = net.indices_from_uniforms(result.alpha, {c: inputs[f"u.{c}"] for c in CELLS})
            gates = {c: result.alpha[c].detach() for c in CELLS} if mode == "full" else None
            loss = self.path_loss(net, compute_params(net, cfg, None), {k: inputs[k] for k in keys},
                                  [idx], generator, gates, mode)
            grads = self.net_grads(net, loss, masters, names)
            optim.step_device(result.opt_state, masters, dict(zip(names, grads)), names, counts,
                              net.update_mask_device(idx), inputs["lr"], bias)
            return loss.detach(), idx

        prog = StepProgram(fn, inputs, [counts] + [masters[n] for n in names] + [
            result.opt_state[k][n] for k in ("m", "v") for n in names], generator)
        prog.counts, prog.names = counts, names
        return prog

    def arch_program(self, result: SearchResult, alpha_optim, dev, keys, generator
                     ) -> StepProgram:
        """The 'full' arch step with the path sampled on the device from the
        buffer 'a.u.<cell>' and alpha's device step counts `prog.counts`.
        Returns (loss, path)."""
        net = result.net
        inputs = {k: torch.empty_like(dev["a." + k][0]) for k in keys}
        inputs.update({k: torch.empty_like(dev["a." + k][0])
                       for k in ["lr"] + [f"u.{c}" for c in CELLS]})
        counts = torch.empty_like(dev["a.counts"])
        bias = torch.from_numpy(alpha_optim.bias_table(
            self.total_steps + int(dev["a.counts"].max()))).to(self.device)

        def fn():
            idx = net.indices_from_uniforms(result.alpha, {c: inputs[f"u.{c}"] for c in CELLS})
            loss, grads = self.arch_grads(net, result.alpha, {k: inputs[k] for k in keys}, idx,
                                          generator)
            alpha_optim.step_device(result.alpha_state, result.alpha, dict(zip(CELLS, grads)),
                                    CELLS, counts, None, inputs["lr"], bias)
            return loss.detach(), idx

        prog = StepProgram(fn, inputs, [counts] + [result.alpha[c] for c in CELLS] + [
            result.alpha_state[k][c] for k in ("m", "v") for c in CELLS], generator)
        prog.counts, prog.names = counts, list(CELLS)
        return prog

    def graph_chunk(self, result: SearchResult, optim, alpha_optim, dev, keys, n, n_arch,
                    global_step, generator):
        """The chunk on the step programs (`weight_program`, `arch_program`):
        each step's inputs copied into its program's buffers, the generator
        reseeded with its seed, one replay; nothing read back until the
        chunk ends."""
        cfg, progs, rank = self.cfg, self.programs, pmesh.data_rank()
        if "weight" not in progs:
            progs["weight"] = self.weight_program(result, optim, dev, keys, generator)
            self.chunk_log["weight"] = progs["weight"].log
        if n_arch and "arch" not in progs:
            progs["arch"] = self.arch_program(result, alpha_optim, dev, keys, generator)
            self.chunk_log["arch"] = progs["arch"].log
        weight, arch = progs["weight"], progs.get("arch")
        with torch.no_grad():
            weight.counts.copy_(dev["counts"])
            if n_arch:
                arch.counts.copy_(dev["a.counts"])
        losses = torch.empty(n, dtype=torch.float32, device=self.device)
        w_paths, a_paths, j = [], [], 0
        launches, t0 = dict(FA.LAUNCHES), time.perf_counter()
        fresh = [p for p in (weight, arch) if p is not None and p.graph is None]
        for i in range(n):
            feed = {k: dev["w." + k][i] for k in keys}
            feed.update({"lr": dev["lr"][i], **{f"u.{c}": dev[f"u.{c}"][i] for c in CELLS}})
            loss, idx = weight.run(feed, step_seed(cfg.SEED, global_step + i, rank))
            with torch.no_grad():
                losses[i].copy_(loss)
                w_paths.append({c: idx[c].clone() for c in CELLS})
            if n_arch and (i + 1) % cfg.ALPHA_EVERY == 0:
                feed = {k: dev["a." + k][j] for k in keys}
                feed.update({"lr": dev["a.lr"][j],
                             **{f"u.{c}": dev[f"a.u.{c}"][j] for c in CELLS}})
                _, idx = arch.run(feed, step_seed(cfg.SEED, ARCH_STREAM + global_step + i, rank))
                with torch.no_grad():
                    a_paths.append({c: idx[c].clone() for c in CELLS})
                j += 1
        host = read_paths(w_paths + a_paths)
        # the chunk's wall time, ended by that read; the attention launches of
        # the chunk besides its programs' warm-ups and captures (0: none eager)
        self.chunk_log.setdefault("chunk_s", []).append(time.perf_counter() - t0)
        eager = self.chunk_log.setdefault("eager_launches", dict.fromkeys(launches, 0))
        for k in launches:
            eager[k] += FA.LAUNCHES[k] - launches[k] - sum(
                p.log[part].get(k, 0) for p in fresh if p.graph is not None
                for part in ("warmup", "captured"))
        counts = torch.cat([weight.counts] + ([arch.counts] if n_arch else [])).cpu().numpy()
        optim.set_counts(result.opt_state, weight.names, counts[:len(weight.names)])
        if "step" in result.opt_state:
            result.opt_state["step"] += n
        if n_arch:
            alpha_optim.set_counts(result.alpha_state, arch.names, counts[len(weight.names):])
            result.alpha_state["step"] += n_arch
        paths, j = [], 0
        for i in range(n):
            paths.append(("weight", global_step + i, [host[i]]))
            if n_arch and (i + 1) % cfg.ALPHA_EVERY == 0:
                paths.append(("arch", global_step + i, host[n + j]))
                j += 1
        return list(losses.unbind()), paths

    def search(self, train_loader: Loader, eval_loader: Loader) -> SearchResult:
        cfg, dev = self.cfg, self.device
        keys = INPUT_KEYS + self.TARGET_KEYS
        net = self.build_net(train_loader.dataset)
        masters = dict(net.named_parameters())
        epoch_steps = train_loader.steps_per_epoch()
        optim = build_net_optimizer(cfg, epoch_steps)
        alpha_optim = self.alpha_optimizer()
        alpha = {c: a.to(dev) for c, a in net.init_alpha().items()}
        opt_state, alpha_state = optim.init(masters), alpha_optim.init(alpha)
        start_epoch = 0
        if cfg.RESUME:
            ckpt = load_checkpoint(cfg.CKPT_FILE_PATH)
            load_params(net, ckpt["state_dict"])
            opt_state = load_optim_state(net, ckpt["net_optim"], dev)
            alpha = alpha_from_jax(ckpt["alpha"], dev)
            alpha_state = alpha_optim_state_from_jax(ckpt["alpha_optim"], dev)
            start_epoch = int(ckpt["epoch"])
            opt_state = WarmupAdam.set_start_step(opt_state, start_epoch * epoch_steps)
            print(f" ========== Resumed from {cfg.CKPT_FILE_PATH} @ epoch {start_epoch}")
        pmesh.broadcast_params(list(masters.values()) + [alpha[c] for c in CELLS])

        generator = torch.Generator(dev)
        arch_json = os.path.join(cfg.ARCH_ROOT, cfg.VERSION + ".json")
        global_step = start_epoch * epoch_steps
        result = SearchResult(net, alpha, opt_state, alpha_state, alpha_host=host_copy(alpha))
        eval_iter = iter(())
        # SCAN_STEPS: the chunks' dispatch, the step programs and their launches
        self.programs = {}
        self.chunk_log = {}
        self.total_steps = cfg.MAX_EPOCH * epoch_steps
        if cfg.SCAN_STEPS > 1:
            self.chunk_log["dispatch"], why = self.chunk_dispatch()
            print(f"search SCAN_STEPS {cfg.SCAN_STEPS}: {self.chunk_log['dispatch']} "
                  f"dispatch ({why})")

        def next_arch_host_batch():
            nonlocal eval_iter
            try:
                return next(eval_iter)
            except StopIteration:  # the arch split cycles (search.py:369-375)
                eval_iter = iter(eval_loader)
                return next(eval_iter)

        def next_arch_batch():
            return batch_to_device(next_arch_host_batch(), dev, keys)

        def epoch_steps_of(do_arch: bool):
            """The epoch's weight (and arch) steps: per step, or in chunks of
            SCAN_STEPS with the sub-chunk tail per step."""
            if cfg.SCAN_STEPS == 1 or self.chunk_log["dispatch"] == "eager":
                return self.steps(result, optim, alpha_optim,
                                  (batch_to_device(b, dev, keys) for b in train_loader),
                                  next_arch_batch, global_step, do_arch, generator)
            losses, lr, buf, step = [], 0.0, [], global_step
            for host_batch in train_loader:
                buf.append(host_batch)
                if len(buf) < cfg.SCAN_STEPS:
                    continue
                arch = ([next_arch_host_batch() for _ in range(cfg.SCAN_STEPS // cfg.ALPHA_EVERY)]
                        if do_arch else [])
                chunk_losses, lr = self.chunk(result, optim, alpha_optim, buf, arch, step,
                                              generator)
                losses += chunk_losses
                step += len(buf)
                buf = []
            if buf:     # the tail; its positions in the epoch are those of 0 .. len(buf) - 1
                tail, lr = self.steps(result, optim, alpha_optim,
                                      (batch_to_device(b, dev, keys) for b in buf),
                                      next_arch_batch, step, do_arch, generator)
                losses += tail
            return losses, lr

        for epoch in range(start_epoch, cfg.MAX_EPOCH):
            self.logger.stamp()
            self.on_epoch_start(result, train_loader.dataset, epoch)
            train_loader.sampler.set_epoch(epoch)
            eval_loader.sampler.set_epoch(epoch)
            eval_loader.sampler.set_shuffle(True)
            result.opt_state = optim.epoch_hook(result.opt_state, epoch)
            eval_iter = iter(eval_loader)
            t0 = time.time()
            # losses stay on the device until the epoch ends
            with epoch_trace(cfg, epoch, start_epoch):       # --PROFILE: the first epoch
                losses, lr = epoch_steps_of(epoch >= cfg.ALPHA_START)
            global_step += len(losses)

            # the global batches' summed losses
            epoch_losses = (pmesh.sum_over_ranks(torch.stack(losses)).tolist()
                            if losses else [])
            result.step_losses += epoch_losses
            loss_sum, epoch_finish, dt = sum(epoch_losses), epoch + 1, time.time() - t0
            result.epoch_losses.append(loss_sum / max(epoch_steps, 1) / cfg.BATCH_SIZE
                                       / pmesh.data_axis_size())
            genotype = net.genotype(result.alpha_host)
            weights = net.genotype_weights(result.alpha_host)
            if epoch_finish % cfg.CKPT_EVERY == 0 or epoch_finish == cfg.MAX_EPOCH:
                save_on_writer(ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, epoch_finish),
                               lambda: {"state_dict": params_tree(net),
                                        "net_optim": optim_tree(result.opt_state, net),
                                        "alpha": alpha_to_jax(alpha),
                                        "alpha_optim": alpha_optim_state_to_jax(alpha_state),
                                        "epoch": epoch_finish})
            msg = (f"epoch = {epoch_finish}  loss = {result.epoch_losses[-1]:.6f}  "
                   f"lr = {float(lr):.8f}  epoch_s = {dt:.1f}")
            print(msg)
            self.logger.write(msg)
            for name in genotype:
                self.logger.write(f"{name}: {genotype[name]}")
            for name in weights:
                self.logger.write(f"{name}: {weights[name]}")
            # per-epoch genotype archive, reset on the first epoch unless
            # resuming (search_vqa.py:379-386, search.py:460-467)
            if pmesh.is_writer():
                if (epoch_finish == 1 + start_epoch and not cfg.RESUME
                        and os.path.exists(arch_json)):
                    os.remove(arch_json)
                append_genotype(arch_json, epoch_finish, genotype)
            if cfg.EVAL_EVERY_EPOCH:
                acc = self.eval(eval_loader, net, result.alpha_host)
                if acc is not None:
                    self.logger.write(f"eval accuracy = {100.0 * acc:.2f}")
        return result

    # ------------------------------------------------------------------ eval
    def eval(self, eval_loader: Loader, net: NetSearch,
             alpha_host: Mapping[str, np.ndarray]) -> Optional[float]:
        """The argmax path's soft-score accuracy on the loader's split
        (search_vqa.py:400-470)."""
        eval_loader.sampler.set_shuffle(False)
        idx = net.chosen_indices(alpha_host)
        names = [n for n, m in net.update_mask(idx).items() if m > 0]
        preds, ans = [], []
        with torch.inference_mode():
            params = compute_params(net, self.cfg, names)
            for batch in eval_loader:
                pred = compute_call(net, self.cfg, (batch_to_device(batch, self.device), None, idx),
                                    params=params)
                preds.append(pred.argmax(dim=-1).cpu().numpy())
                if "ans" in batch:
                    ans.append(batch["ans"])
        if not ans:
            return None
        # every rank's predictions and labels in the split's order, the
        # padding dropped (collective: before the writer gate)
        n_items = len(eval_loader.sampler.subset_indices)
        preds = pmesh.allgather_host_order(np.concatenate(preds), n_items)
        scores = pmesh.allgather_host_order(np.concatenate(ans), n_items)
        if not pmesh.is_writer():
            return None
        acc = float(np.mean(scores[np.arange(len(preds)), preds]))
        print(f"search eval accuracy = {100.0 * acc:.2f}")
        return acc

    # ------------------------------------------------------------------- run
    def run(self) -> SearchResult:
        dataset = self.build_dataset()
        n = len(dataset)
        split = int(n * self.cfg.SPLIT_PORTION)
        if not 0 < split < n:
            raise ValueError(
                f"bilevel split degenerate: {n} examples * SPLIT_PORTION="
                f"{self.cfg.SPLIT_PORTION} -> weight split {split} / arch split {n - split}; "
                "need both non-empty")
        # ONE dataset, 80/20 bilevel split (search_vqa.py:560-583)
        return self.search(self.make_loader(dataset, list(range(split))),
                           self.make_loader(dataset, list(range(split, n))))
