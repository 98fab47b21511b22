"""VGD (visual grounding) fixed-net execution on one device, or
data-parallel on several (counterpart of mmnas_tpu/engine/vgd.py).

`Execution(cfg, device).run()` is the VQA engine's (engine/vqa.py) with the
task's dataset (RefCOCO-family referring expressions, or SynthVgdDataset
with --SYNTH), the per-region head of NetFull(task="vgd"), its loss and its
eval:

- loss (train_vgd.py:316-334): KLDivLoss(sum) of the log-softmax scores
  against the IoU-weighted target distribution, both masked by
  scores_mask, or BCEWithLogits(sum) on the raw scores; plus LOSS_LAMBDA
  times SmoothL1(sum) on the box deltas of the proposals that hit the
  ground truth (bbox_mask). LOSS_AVG divides each by its mask count,
  floored at 1. Training regresses the BBOX_NORM-normalized deltas;
- eval (train_vgd.py:404-473), on the device: BBOX_NORM folded into
  proj_reg (on the fp32 master weights, before any bf16 cast), the
  forward, the deltas decoded against the proposals and clipped to the
  image, the argmax-score box's IoU with the ground truth, a hit where
  IoU >= OVERLAP_THRESHOLD. The hits stay on the device until the loop
  ends; the ranks' hits are gathered into dataset order and the loader's
  pad items dropped as the VQA eval drops them.

Data parallel, the gradients are averaged over the ranks as the VQA
engine's are, with LOSS_AVG too: each rank's loss is then a mean over its
own masks, and the average of the ranks' means is the reference's DDP step
(the JAX package's global-batch mean differs from it by the ranks' count
skew, mmnas_tpu/engine/vgd.py:119-121).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from mmnas_tpu_torch.data.loader import Loader
from mmnas_tpu_torch.engine.vqa import Execution as VqaExecution
from mmnas_tpu_torch.engine.vqa import batch_to_device, bce_with_logits_sum
from mmnas_tpu_torch.models.net import INPUT_KEYS, VGD_KEYS, NetFull, compute_dtype
from mmnas_tpu_torch.parallel import mesh as pmesh
from mmnas_tpu_torch.utils.bbox import bbox_overlaps_torch
from mmnas_tpu_torch.utils.bbox_transform import bbox_transform_inv_torch, clip_boxes_torch

# the batch keys the eval reads: the model inputs, the proposals, the image's
# (H, W) and the ground-truth box
EVAL_KEYS = INPUT_KEYS + ("bbox", "img_shape", "gt_bbox")


def kld_sum(pred_logprob, target):
    """torch.nn.KLDivLoss(reduction='sum') in the JAX package's form:
    sum(t log t - t x), with 0 log 0 = 0."""
    pos = target > 0
    xlogy = torch.where(pos, target * torch.log(torch.where(pos, target, 1.0)), 0.0)
    return (xlogy - target * pred_logprob).sum()


def smooth_l1_sum(pred, target):
    """torch.nn.SmoothL1Loss(reduction='sum'), beta 1."""
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum()


def vgd_loss(cfg, pred_scores, pred_reg, batch: Mapping[str, torch.Tensor]):
    """The summed score and box losses of one batch (train_vgd.py:316-334,
    mmnas_tpu/engine/vgd.py:48-69)."""
    scores, scores_mask = batch["scores"], batch["scores_mask"]         # [B, L], [B, 1]
    tb, bbox_mask = batch["transformed_bbox"], batch["bbox_mask"]       # [B, L, 4], [B, L, 1]
    if cfg.SCORES_LOSS == "bce":
        loss_scores = bce_with_logits_sum(pred_scores, scores)
    else:
        loss_scores = kld_sum(pred_scores * scores_mask, scores * scores_mask)
    loss_reg = smooth_l1_sum(pred_reg * bbox_mask, tb * bbox_mask)
    if cfg.LOSS_AVG:
        if cfg.SCORES_LOSS == "bce":
            loss_scores = loss_scores / pred_scores.shape[0]
        else:
            loss_scores = loss_scores / torch.clamp(scores_mask.sum(), min=1.0)
        loss_reg = loss_reg / torch.clamp(bbox_mask.sum(), min=1.0)
    return loss_scores + cfg.LOSS_LAMBDA * loss_reg


def fold_bbox_norm(cfg, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """BBOX_NORM's stds and means folded into proj_reg for the eval
    (train_vgd.py:412-419): w' = stds * w per output row (torch's [4, in]
    layout), b' = b stds + means. A new dict; `params` is not changed."""
    params = dict(params)
    if not cfg.BBOX_NORM:
        return params
    w, b = params["proj_reg.weight"], params["proj_reg.bias"]
    stds = torch.tensor(cfg.BBOX_NORM_STDS, dtype=torch.float32, device=w.device)
    means = torch.tensor(cfg.BBOX_NORM_MEANS, dtype=torch.float32, device=w.device)
    params["proj_reg.weight"] = w * stds[:, None]
    params["proj_reg.bias"] = b * stds + means
    return params


def eval_params(net: torch.nn.Module, cfg, names: Optional[Iterable[str]] = None
                ) -> Dict[str, torch.Tensor]:
    """The parameters an eval computes with: the net's fp32 masters (those
    of `names`, when given), BBOX_NORM folded in, then cast to the compute
    dtype, as the JAX package folds the fp32 checkpoint before its bf16
    cast."""
    params = {n: p.detach() for n, p in net.named_parameters()}
    if names is not None:
        params = {n: params[n] for n in names}
    dt = compute_dtype(cfg)
    return {n: p.to(dt) if p.is_floating_point() else p
            for n, p in fold_bbox_norm(cfg, params).items()}


def grounding_hits(cfg, scores, reg, batch: Mapping[str, torch.Tensor]):
    """Per item (hit, IoU) on the device: the deltas decoded against the
    proposals and clipped to the image, the argmax-score box's IoU with the
    ground truth, a hit where IoU >= OVERLAP_THRESHOLD
    (mmnas_tpu/engine/vgd.py:136-145)."""
    decoded = bbox_transform_inv_torch(batch["bbox"], reg)
    clipped = clip_boxes_torch(decoded, batch["img_shape"])
    best = scores.argmax(dim=-1)
    picked = clipped[torch.arange(scores.shape[0], device=scores.device), best]
    iou = bbox_overlaps_torch(picked[:, None, :], batch["gt_bbox"])[:, 0, 0]
    return (iou >= cfg.OVERLAP_THRESHOLD).to(torch.int32), iou


def grounding_forward(net: torch.nn.Module, params: Mapping[str, torch.Tensor],
                      batch: Mapping[str, torch.Tensor], *extra):
    """The eval's forward: `net` on `batch` (and `extra`, the supernet's
    alpha and path) with `params` from eval_params -> (scores, reg)."""
    return functional_call(net, params, (batch, *extra), tie_weights=False)


def hits_over(cfg, loader: Loader, net: torch.nn.Module, params: Mapping[str, torch.Tensor],
              device: torch.device, extra=()):
    """Per item (hits, IoUs) over the loader's split as numpy arrays, in
    dataset order: each batch's forward and grounding_hits on the device,
    one copy to the host at the end, the ranks' items gathered into the
    split's order and the padding dropped (collective)."""
    hits, ious = [], []
    with torch.inference_mode():
        for host_batch in loader:
            batch = batch_to_device(host_batch, device, EVAL_KEYS)
            scores, reg = grounding_forward(net, params, batch, *extra)
            hit, iou = grounding_hits(cfg, scores, reg, batch)
            hits.append(hit)
            ious.append(iou)
        if not hits:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        n_items = len(loader.sampler.subset_indices)
        return (pmesh.allgather_host_order(torch.cat(hits).cpu().numpy(), n_items),
                pmesh.allgather_host_order(torch.cat(ious).cpu().numpy(), n_items))


class GroundingTask:
    """What the VGD engines, fixed net and search, put in the VQA ones'
    place: the dataset and the loss hook."""
    TASK = "vgd"
    TARGET_KEYS = VGD_KEYS

    def build_dataset(self, run_mode: str = "train"):
        cfg = self.cfg
        if cfg.SYNTH:
            from mmnas_tpu_torch.data.synth import SynthVgdDataset
            return SynthVgdDataset(cfg, size=cfg.SYNTH_SIZE, seed=cfg.SEED)
        from mmnas_tpu_torch.data.vgd import VgdDataset
        return VgdDataset(cfg, run_mode)

    def loss(self, pred, batch):
        scores, reg = pred
        return vgd_loss(self.cfg, scores, reg, batch)


@dataclass
class GroundingResult:
    accuracy: Optional[float]   # IoU@OVERLAP_THRESHOLD accuracy, percent (as the JAX eval)
    hits: np.ndarray            # per item, dataset order: 1 where IoU >= OVERLAP_THRESHOLD
    ious: np.ndarray            # per item, dataset order: the argmax box's IoU
    seconds: float              # wall time of the batch loop, loader included


class Execution(GroundingTask, VqaExecution):
    def eval(self, eval_loader: Loader, net: Optional[NetFull] = None,
             valid: bool = False) -> GroundingResult:
        cfg = self.cfg
        if net is None:      # fp32 masters: BBOX_NORM folds into them before the cast
            net = self.load_masters(eval_loader.dataset)
        t0 = time.perf_counter()
        hits, ious = hits_over(cfg, eval_loader, net, eval_params(net, cfg), self.device)
        seconds = time.perf_counter() - t0
        accuracy = None
        if len(hits):
            accuracy = 100.0 * float(hits.sum()) / len(hits)
            print("accuracy = " + str(accuracy) + " %")
            self.logger.write(f"Overall Accuracy is: {accuracy:.2f}")
        return GroundingResult(accuracy, hits, ious, seconds)
