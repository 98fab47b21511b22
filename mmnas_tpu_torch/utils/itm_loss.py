"""ITM triplet losses (counterpart of mmnas_tpu/utils/itm_loss.py).

`bce_triplet_loss` is the reference BCE_Loss: BCE(pos->1) + BCE(negc->0) +
BCE(negi->0), summed, on the sigmoid probabilities the ITM head returns
(full_itm.py:111). The reference adds `loss_pos` twice (itm_loss.py:22),
kept under double_pos=True (ITM_DOUBLE_POS).

`margin_triplet_loss` is the 0.2-margin hinge alternative
(itm_loss.py:27-37).

Not torch.nn.BCELoss: it clamps the log at -100, which gives other values
and gradients on the saturation rail. The JAX package's form is kept
exactly: log(p + 1e-7) and log1p(1e-7 - p) in fp32, finite in value and
gradient at p = 0 or 1.
"""

from __future__ import annotations

import torch

_BCE_EPS = 1e-7  # fp32-representable; bounds |dloss/dp| at 1e7


def _bce_sum(p, target_ones: bool):
    """-sum log(p + eps) (target 1) or -sum log1p(eps - p) (target 0), fp32."""
    p = p.float()
    logp = torch.log(p + _BCE_EPS) if target_ones else torch.log1p(_BCE_EPS - p)
    return -logp.sum()


def bce_triplet_loss(scores_pos, scores_negc, scores_negi, double_pos: bool = True):
    loss_pos = _bce_sum(scores_pos, True)
    loss_negc = _bce_sum(scores_negc, False)
    loss_negi = _bce_sum(scores_negi, False)
    pos_w = 2.0 if double_pos else 1.0
    return pos_w * loss_pos + loss_negc + loss_negi


def margin_triplet_loss(scores_pos, scores_negc, scores_negi, margin: float = 0.2):
    cost_c = torch.clamp(margin + scores_negc - scores_pos, min=0.0)
    cost_i = torch.clamp(margin + scores_negi - scores_pos, min=0.0)
    return cost_c.sum() + cost_i.sum()
