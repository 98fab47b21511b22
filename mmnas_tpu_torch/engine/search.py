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

Not ported: SCAN_STEPS, the dense/unified/hybrid weight steps, tensor
parallelism (ROADMAP.md).
"""

from __future__ import annotations

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
    from_jax_params, optim_state_from_jax, optim_state_to_jax, to_jax_params,
)
from mmnas_tpu_torch.models.net import INPUT_KEYS, compute_call, compute_params
from mmnas_tpu_torch.models.supernet import CELLS, NetSearch
from mmnas_tpu_torch.parallel import mesh as pmesh
from mmnas_tpu_torch.train.checkpoint import ckpt_path, load_checkpoint
from mmnas_tpu_torch.train.optimizer import (
    WarmupAdam, build_net_optimizer, clip_by_global_norm, plain_adam,
)
from mmnas_tpu_torch.utils.logger import TextLogger
from mmnas_tpu_torch.utils.profiling import epoch_trace

ARCH_STREAM = 1_000_000_000  # arch step s draws from stream ARCH_STREAM + s


def sample_seed(seed: int, global_step: int) -> int:
    """The seed of the host generator that samples the paths of one step,
    apart from that step's dropout seed (`step_seed`)."""
    return step_seed(seed + 0x9E3779B9, global_step)


def host_copy(alpha: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The host copy of alpha that sampling reads: one small device-to-host
    copy, made after each arch step."""
    return {c: a.detach().to("cpu", copy=True).numpy() for c, a in alpha.items()}


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
        for flag in ("DENSE_WEIGHT_STEP", "UNIFIED_WEIGHT_STEP", "HYBRID_WEIGHT_STEP"):
            if getattr(cfg, flag):
                raise NotImplementedError(f"{flag} is not ported (ROADMAP.md, 'Not ported')")
        if cfg.SCAN_STEPS != 1:
            raise NotImplementedError("SCAN_STEPS is not ported (ROADMAP.md, 'Not ported')")
        if cfg.ALPHA_BINARY_MODE not in ("full", "two"):
            # 'full_v2' is asserted off in the reference too (mixed.py:71)
            raise ValueError(f"ALPHA_BINARY_MODE={cfg.ALPHA_BINARY_MODE!r} (use 'full' or 'two')")
        if cfg.CKPT_BACKEND != "pickle":
            raise NotImplementedError("the port writes pickle checkpoints only")
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
        return NetSearch(self.cfg, init_dict, task=self.TASK).to(self.device)

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

    def weight_step(self, net: NetSearch, optim, opt_state: Dict,
                    masters: Mapping[str, torch.nn.Parameter], batch: Dict[str, torch.Tensor],
                    idxs: Sequence[Mapping[str, np.ndarray]], generator: torch.Generator):
        """One weight step on the paths `idxs` (one per KPATH slice, by
        stride): (summed loss on the device, lr)."""
        cfg, K = self.cfg, len(idxs)
        mask = net.update_mask(idxs[0])
        for idx in idxs[1:]:  # the union of the paths' masks
            other = net.update_mask(idx)
            mask = {n: max(m, other[n]) for n, m in mask.items()}
        names = [n for n, m in mask.items() if m > 0]
        params = compute_params(net, cfg, names)
        loss = 0.0
        for k, idx in enumerate(idxs):
            # a stride slice is a view; the kernels take contiguous tensors
            sl = batch if K == 1 else {key: v[k::K].contiguous() for key, v in batch.items()}
            loss = loss + self.forward_loss(
                lambda b, idx=idx: compute_call(
                    net, cfg, (b, None, idx),
                    {"mode": "sampled", "train": True, "generator": generator}, params), sl)
        grads = torch.autograd.grad(loss, [masters[n] for n in names], allow_unused=True)
        # a selected parameter the loss does not reach (the text-relation
        # stem) has a zero gradient, as in JAX: Adam still counts its step
        grads = [torch.zeros_like(masters[n]) if g is None else g for n, g in zip(names, grads)]
        pmesh.all_reduce_grads(grads)   # every rank ran the same paths: the same leaves
        if cfg.NET_GRAD_CLIP > 0:  # net parameters only (search_vqa.py:298)
            clip_by_global_norm(grads, cfg.NET_GRAD_CLIP)
        lr = optim.step(opt_state, masters, dict(zip(names, grads)), mask)
        return loss.detach(), lr

    def arch_step(self, net: NetSearch, alpha_optim, alpha_state: Dict,
                  alpha: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                  idx: Mapping[str, np.ndarray], generator: torch.Generator):
        """One arch step on the path (or pairs, in 'two' mode) `idx`: the
        gradient of alpha alone, an Adam step on alpha in place. Returns the
        loss on the device."""
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
        losses, lr, rank = [], 0.0, pmesh.rank()
        for step, batch in enumerate(batches):
            sampler = torch.Generator().manual_seed(sample_seed(cfg.SEED, global_step))
            idxs = [net.sample_indices(result.alpha_host, sampler) for _ in range(cfg.KPATH)]
            generator.manual_seed(step_seed(cfg.SEED, global_step, rank))
            loss, lr = self.weight_step(net, optim, result.opt_state, masters, batch, idxs,
                                        generator)
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
            net.load_state_dict(from_jax_params(ckpt["state_dict"]), strict=True)
            opt_state = optim_state_from_jax(ckpt["net_optim"], dev)
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

        def next_arch_batch():
            nonlocal eval_iter
            try:
                host_batch = next(eval_iter)
            except StopIteration:  # the arch split cycles (search.py:369-375)
                eval_iter = iter(eval_loader)
                host_batch = next(eval_iter)
            return batch_to_device(host_batch, dev, keys)

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
                losses, lr = self.steps(result, optim, alpha_optim,
                                        (batch_to_device(b, dev, keys) for b in train_loader),
                                        next_arch_batch, global_step, epoch >= cfg.ALPHA_START,
                                        generator)
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
                               lambda: {"state_dict": to_jax_params(net),
                                        "net_optim": optim_state_to_jax(result.opt_state, net),
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
