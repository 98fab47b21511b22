"""VQA fixed-architecture execution on one device, or data-parallel on
several (counterpart of mmnas_tpu/engine/vqa.py).

`Execution(cfg, device).run()` builds the dataset and loader and the
genotype's `NetFull`, then

- with RUN_MODE train, trains it (train_vqa.py:226-341): per step the
  train-mode forward (every dropout site at DROPOUT_R, attention weights
  included; under --DTYPE bfloat16 on bf16 casts of the fp32 master
  parameters), the summed BCE-with-logits loss, the backward, the
  global-norm clip at NET_GRAD_CLIP and a WarmupAdam step, both fp32; per
  epoch the optimizer's
  epoch hook, a checkpoint in the JAX package's pickle format (so either
  package resumes from or evaluates it) and, with EVAL_EVERY_EPOCH, an
  eval. RESUME starts from either package's checkpoint; --PROFILE traces
  the first epoch (utils/profiling.py);
- with RUN_MODE val|test, loads the pickled checkpoint at CKPT_FILE_PATH
  (either package's) and evaluates: argmax predictions, the soft-score VQA
  accuracy, the EvalAI result JSON and, where the dataset has annotation
  files, VQAEval (train_vqa.py:352-491).

Data parallel (parallel/mesh.py, one process per card): each rank takes
BATCH_SIZE examples from a rank-strided sampler, so the global batch is
BATCH_SIZE x world; the per-rank loss is a sum, and the gradients are
summed over the ranks and divided by the world size before the clip (the
JAX package's psum / n_shards). Dropout draws its own masks on each rank;
rank 0 draws what one process draws. The epoch's loss line sums the ranks'
losses over the global count; rank 0 alone writes logs and checkpoints,
and every rank waits for the checkpoint before going on; eval outputs are
gathered into dataset order. With one process all of this is the identity.

Tensor parallel (--MODEL_AXIS M > 1, parallel/sharding.py): the ranks form
world / M data shards of M model ranks. The net is built whole from the
seed, then sliced to the rank's shard; the batch, the dropout seeds, the
loss sums, the gradients' all-reduce (divided by the data shards) and the
eval gathers go by data shard, so the model ranks of one data shard take
the same batch and draw the same masks; the clip's norm is the whole
gradient's. Checkpoints hold the gathered, unsharded pytree
(train/checkpoint.py), so every rank takes part in writing one.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from mmnas_tpu_torch.data.loader import Loader
from mmnas_tpu_torch.data.sampler import SubsetShardSampler
from mmnas_tpu_torch.genotype import load_genotype
from mmnas_tpu_torch.models.net import (
    INPUT_KEYS, NetFull, compute_call, compute_dtype, compute_params,
)
from mmnas_tpu_torch.parallel import mesh as pmesh
from mmnas_tpu_torch.parallel.sharding import shard_module, split_flags
from mmnas_tpu_torch.train.checkpoint import (
    ckpt_path, load_checkpoint, load_optim_state, load_params, optim_tree, params_tree,
    save_checkpoint,
)
from mmnas_tpu_torch.train.optimizer import WarmupAdam, build_net_optimizer, clip_by_global_norm
from mmnas_tpu_torch.utils.logger import TextLogger, dump_result_json
from mmnas_tpu_torch.utils.profiling import epoch_trace


def check_int8_shipping(cfg, dataset) -> None:
    """SHIP_INT8 is read by the whole-batch loader alone (VqaDataset.get_batch:
    the packed feature store with DEVICE_REL). The JAX package accepts the
    flag with any other loader and ships float features; the port refuses it."""
    if cfg.SHIP_INT8 and not (hasattr(dataset, "supports_batch") and dataset.supports_batch()):
        raise ValueError(
            "--SHIP_INT8 needs the whole-batch VQA loader: features packed by "
            "tools/pack_features.py and --DEVICE_REL")


@dataclass
class EvalResult:
    accuracy: Optional[float]   # soft-score accuracy (VQAEval overall / 100 when annotated)
    preds: np.ndarray           # argmax answer index per item, dataset order
    seconds: float              # wall time of the batch loop, loader included


@dataclass
class TrainResult:
    net: NetFull                # the trained net, on the device
    opt_state: Dict             # the optimizer state after the last step
    epoch_losses: List[float]   # per epoch: summed loss / examples seen
    step_losses: List[float]    # per step: the batch's summed loss


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device,
                    keys=INPUT_KEYS) -> Dict[str, torch.Tensor]:
    """The arrays of a host batch under `keys` (default: the model inputs),
    as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device, non_blocking=True)
            for k in keys if k in batch}


def bce_with_logits_sum(logits, targets):
    """torch.nn.BCEWithLogitsLoss(reduction='sum') (train_vqa.py:237), in the
    JAX package's stable form max(x,0) - x t + log(1 + exp(-|x|))."""
    per = torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return per.sum()


# apart from any step's seed: a run stays far below 2**40 steps
RANK_STRIDE = 2**40


def step_seed(seed: int, global_step: int, rank: int = 0) -> int:
    """The dropout seed of one train step on one rank: a function of the
    run's seed and the step, so a resumed run draws what an uninterrupted
    one would (the JAX package folds the step into its key,
    engine/vqa.py:182). Each data shard draws its own masks (`rank` is the
    data shard: its model ranks draw the same ones); data shard 0 draws
    what one process does."""
    return ((seed + 1) * 1_000_003 + global_step + rank * RANK_STRIDE) % 2**63


def shard_sampler(data_size: int, shuffle: bool, subset_indices=None) -> SubsetShardSampler:
    """This rank's share of a split: rank-strided over the data shards
    (data/sampler.py), the whole split in one process."""
    return SubsetShardSampler(data_size, num_replicas=pmesh.data_axis_size(),
                              rank=pmesh.data_rank(), shuffle=shuffle,
                              subset_indices=subset_indices)


def save_on_writer(path: str, state_fn) -> None:
    """Rank 0 writes the checkpoint state_fn() to `path`; every rank waits
    until it is on disk, so any rank may read it next. Under tensor
    parallelism every rank calls state_fn, which gathers the shards."""
    if pmesh.model_axis_size() > 1:
        state = state_fn()
        if pmesh.is_writer():
            save_checkpoint(path, state)
    elif pmesh.is_writer():
        save_checkpoint(path, state_fn())
    pmesh.barrier()


class Execution:
    TASK = "vqa"
    TARGET_KEYS = ("ans",)      # the batch keys a train step reads besides INPUT_KEYS

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.logger = TextLogger(cfg.LOG_ROOT, cfg.VERSION)

    # ------------------------------------------------------------------ data
    def build_dataset(self, run_mode: str):
        cfg = self.cfg
        if cfg.SYNTH:
            from mmnas_tpu_torch.data.synth import SynthVqaDataset
            return SynthVqaDataset(cfg, size=cfg.SYNTH_SIZE, seed=cfg.SEED)
        from mmnas_tpu_torch.data.vqa import VqaDataset
        return VqaDataset(cfg, run_mode)

    def make_loader(self, dataset, batch_size: int, shuffle: bool = False) -> Loader:
        """This rank's loader of `batch_size` examples a step (the JAX
        package's per-process loader, engine/vqa.py:78-98): dataset order
        for eval, the epoch-seeded shuffle of the shared sampler for
        training."""
        check_int8_shipping(self.cfg, dataset)
        return Loader(dataset, batch_size, sampler=shard_sampler(len(dataset), shuffle),
                      num_workers=self.cfg.NUM_WORKERS)

    # ----------------------------------------------------------------- model
    def build_net(self, dataset) -> NetFull:
        """The genotype's NetFull from the seed, sliced to this model rank's
        shard under tensor parallelism."""
        cfg = self.cfg
        genotype = load_genotype(cfg.ARCH_PATH, cfg.GENO_EPOCH)
        init_dict = {
            "token_size": dataset.token_size,
            "ans_size": dataset.ans_size,
            "pretrained_emb": getattr(dataset, "pretrained_emb", None),
        }
        return shard_module(NetFull(cfg, genotype, init_dict, task=self.TASK))

    def load_masters(self, dataset) -> NetFull:
        """build_net + the checkpoint at CKPT_FILE_PATH, fp32, on the device,
        in eval mode."""
        if not self.cfg.CKPT_FILE_PATH:
            raise ValueError("eval needs a checkpoint: pass --CKPT_PATH")
        net = self.build_net(dataset)
        load_params(net, load_checkpoint(self.cfg.CKPT_FILE_PATH)["state_dict"])
        return net.to(self.device).eval()

    def load_net(self, dataset) -> NetFull:
        """`load_masters` cast to the compute dtype."""
        return self.load_masters(dataset).to(compute_dtype(self.cfg))

    # ----------------------------------------------------------------- train
    def loss(self, pred, batch: Dict[str, torch.Tensor]):
        """The summed BCE-with-logits loss of the logits `pred` (train_vqa.py:237)."""
        return bce_with_logits_sum(pred, batch["ans"])

    def forward_loss(self, run, batch: Dict[str, torch.Tensor]):
        """The loss of one step's batch: `run(b)` is the net's train-mode
        forward on a batch `b` with the step's parameters and generator. One
        forward and `self.loss`; ITM runs three forwards (engine/itm.py)."""
        return self.loss(run(batch), batch)

    def mean_grads(self) -> bool:
        """Whether the train step divides the gradients summed over the data
        shards by their count (the JAX package's / n_shards,
        mmnas_tpu/engine/vqa.py:122): the per-shard losses are sums. VGD's
        LOSS_AVG means over the global batch are not divided."""
        return True

    def on_epoch_start(self, net: NetFull, dataset, epoch: int) -> None:
        """Per-epoch task hook, before the epoch's loader starts (ITM's
        hard-negative mining); none for VQA and VGD."""

    def train_step(self, net: NetFull, optim, opt_state: Dict,
                   params: Dict[str, torch.nn.Parameter], batch: Dict[str, torch.Tensor],
                   generator: torch.Generator):
        """One optimizer step on one device batch (mmnas_tpu/engine/vqa.py:115-126):
        the forward computes with `compute_params` (bf16 casts of the fp32
        masters under --DTYPE bfloat16, cast once per step), so the gradients,
        the clip and Adam are fp32; `self.forward_loss` is the task's loss.
        The gradients are averaged over the data-parallel ranks before the
        clip. Returns (loss, lr); the loss (this rank's) stays on the device."""
        cfg = self.cfg
        cast = compute_params(net, cfg) if compute_dtype(cfg) != torch.float32 else None
        loss = self.forward_loss(
            lambda b: compute_call(net, cfg, (b,), {"train": True, "generator": generator}, cast),
            batch)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        # a parameter the loss does not reach has a zero gradient, as in JAX
        grads = [torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)]
        pmesh.all_reduce_grads(grads, mean=self.mean_grads())
        if cfg.NET_GRAD_CLIP > 0:
            clip_by_global_norm(grads, cfg.NET_GRAD_CLIP, split_flags(net, names))
        lr = optim.step(opt_state, params, dict(zip(names, grads)))
        return loss.detach(), lr

    def train(self, train_loader: Loader, eval_loader: Optional[Loader] = None) -> TrainResult:
        cfg = self.cfg
        if cfg.CKPT_BACKEND != "pickle":
            raise NotImplementedError("the port writes pickle checkpoints only: the orbax "
                                      "backend is not ported (ROADMAP.md, 'Not ported')")
        net = self.build_net(train_loader.dataset).to(self.device)
        params = dict(net.named_parameters())
        epoch_steps = train_loader.steps_per_epoch()
        optim = build_net_optimizer(cfg, epoch_steps)
        opt_state = optim.init(params)
        start_epoch = 0
        if cfg.RESUME:
            ckpt = load_checkpoint(cfg.CKPT_FILE_PATH)
            load_params(net, ckpt["state_dict"])
            opt_state = load_optim_state(net, ckpt["net_optim"], self.device)
            start_epoch = int(ckpt["epoch"])
            opt_state = WarmupAdam.set_start_step(opt_state, start_epoch * epoch_steps)
            print(f" ========== Resumed from {cfg.CKPT_FILE_PATH} @ epoch {start_epoch}")
        pmesh.broadcast_params(list(params.values()))

        generator = torch.Generator(self.device)
        rank, global_bs = pmesh.data_rank(), cfg.BATCH_SIZE * pmesh.data_axis_size()
        global_step = start_epoch * epoch_steps
        epoch_losses, step_losses = [], []
        for epoch in range(start_epoch, cfg.MAX_EPOCH):
            self.on_epoch_start(net, train_loader.dataset, epoch)
            train_loader.sampler.set_epoch(epoch)
            opt_state = optim.epoch_hook(opt_state, epoch)
            # losses stay on the device until the epoch ends: reading one per
            # step would wait for the device every step
            losses, t0, lr = [], time.time(), 0.0
            with epoch_trace(cfg, epoch, start_epoch):       # --PROFILE: the first epoch
                for step, host_batch in enumerate(train_loader):
                    batch = batch_to_device(host_batch, self.device,
                                            INPUT_KEYS + self.TARGET_KEYS)
                    generator.manual_seed(step_seed(cfg.SEED, global_step, rank))
                    loss, lr = self.train_step(net, optim, opt_state, params, batch, generator)
                    losses.append(loss)
                    global_step += 1
                    if cfg.DEBUG:
                        print(step, float(loss) / cfg.BATCH_SIZE)
            # the global batches' summed losses
            epoch_step_losses = (pmesh.sum_over_ranks(torch.stack(losses)).tolist()
                                 if losses else [])
            step_losses += epoch_step_losses
            loss_sum = sum(epoch_step_losses)
            epoch_finish = epoch + 1
            dt = time.time() - t0
            n_seen = epoch_steps * global_bs
            msg = (f"epoch = {epoch_finish}  loss = {loss_sum / max(n_seen, 1):.6f}  "
                   f"lr = {float(lr):.8f}  ips = {n_seen / dt:.1f}")
            print(msg)
            self.logger.write(msg)
            epoch_losses.append(loss_sum / max(n_seen, 1))

            if epoch_finish % cfg.CKPT_EVERY == 0 or epoch_finish == cfg.MAX_EPOCH:
                save_on_writer(ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, epoch_finish),
                               lambda: {"state_dict": params_tree(net),
                                        "net_optim": optim_tree(opt_state, net),
                                        "epoch": epoch_finish})
            if eval_loader is not None and cfg.EVAL_EVERY_EPOCH:
                self.eval(eval_loader, net=net, valid=True)
        return TrainResult(net, opt_state, epoch_losses, step_losses)

    # ------------------------------------------------------------------ eval
    def eval(self, eval_loader: Loader, net: Optional[NetFull] = None,
             valid: bool = False) -> EvalResult:
        cfg = self.cfg
        dataset = eval_loader.dataset
        if net is None:
            net = self.load_net(dataset)
        preds, ans_scores = [], []
        t0 = time.perf_counter()
        with torch.inference_mode():
            # a net in training keeps fp32 masters: cast them once for the eval
            params = compute_params(net, cfg)
            for batch in eval_loader:
                logits = compute_call(net, cfg, (batch_to_device(batch, self.device),),
                                      params=params)
                preds.append(logits.argmax(dim=-1).cpu().numpy())
                if "ans" in batch:
                    ans_scores.append(batch["ans"])
        # every rank's predictions and labels in dataset order, the padding
        # dropped (collective: before the writer gate)
        n_items = len(eval_loader.sampler.subset_indices)
        preds = pmesh.allgather_host_order(
            np.concatenate(preds) if preds else np.zeros((0,), np.int64), n_items)
        ans_scores = ([pmesh.allgather_host_order(np.concatenate(ans_scores), n_items)]
                      if ans_scores else [])
        seconds = time.perf_counter() - t0
        if not pmesh.is_writer():
            return EvalResult(None, preds, seconds)

        # result JSON in EvalAI format (train_vqa.py:421-430)
        qid_list = getattr(dataset, "qid_list", None)
        ix_to_ans = getattr(dataset, "ix_to_ans", {})
        if qid_list is not None:
            result = [{"answer": ix_to_ans[int(p)], "question_id": int(qid)}
                      for p, qid in zip(preds, qid_list)]
            tag = "tmp" if valid else "result_test"
            dump_result_json(os.path.join(cfg.CKPT_ROOT, tag, f"result_run_{cfg.VERSION}.json"),
                             result)

        accuracy = None
        # skipped when the dataset carries placeholder zero scores (real VQA
        # val/test items): VQAEval below is the metric there
        if ans_scores and getattr(dataset, "has_answer_scores", True):
            scores = ans_scores[0]
            # VQA accuracy == the soft score of the predicted answer
            accuracy = float(np.mean(scores[np.arange(len(preds)), preds]))
            msg = f"eval accuracy = {100.0 * accuracy:.2f}"
            print(msg)
            self.logger.write(msg)
        if qid_list is not None and getattr(dataset, "has_annotations", False):
            from mmnas_tpu_torch.utils.vqa_eval import evaluate_result_file
            stats = evaluate_result_file(dataset, preds)
            if stats:
                msg = ("VQAEval overall = {overall:.2f}  perAnswerType = {perAnswerType}"
                       .format(**stats))
                print(msg)
                self.logger.write(msg)
                accuracy = stats["overall"] / 100.0
        return EvalResult(accuracy, preds, seconds)

    # ------------------------------------------------------------------- run
    def run(self):
        """RUN train -> TrainResult; RUN val|test -> EvalResult."""
        cfg = self.cfg
        if cfg.RUN_MODE == "train":
            train_loader = self.make_loader(self.build_dataset("train"), cfg.BATCH_SIZE,
                                            shuffle=True)
            eval_loader = None
            if cfg.EVAL_EVERY_EPOCH:
                eval_loader = self.make_loader(self.build_dataset("val"), cfg.EVAL_BATCH_SIZE)
            return self.train(train_loader, eval_loader)
        eval_set = self.build_dataset(cfg.RUN_MODE)
        eval_loader = self.make_loader(eval_set, cfg.EVAL_BATCH_SIZE)
        return self.eval(eval_loader, valid=(cfg.RUN_MODE == "val"))
