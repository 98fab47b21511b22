"""Op registry (counterpart of mmnas_tpu/ops/registry.py).

The port has the ops of the decoder's safe search space
(dec_safe = [self_att_64, rel_self_att_64, guided_att_64, feed_forward],
which also covers enc_safe) plus 'none'. Every shipped genotype
(arch/*.json) uses only these.
"""

from __future__ import annotations

from torch import nn

from mmnas_tpu_torch.ops import modules as M
from mmnas_tpu_torch.ops.modules import OpCfg

OPS = {
    "none": M.zero,
    "self_att_64": M.self_att,
    "rel_self_att_64": M.rel_self_att,
    "guided_att_64": M.guided_att,
    "feed_forward": M.feed_forward,
}


def make_op(name: str, cfg: OpCfg, norm: bool, residual: bool) -> nn.Module:
    """Instantiate a named candidate op with the reference factory contract
    (ops_adapter.py:24-73)."""
    if name not in OPS:
        raise NotImplementedError(
            f"op '{name}' is not ported yet (ROADMAP.md, queue 1: the rest of the "
            "op library)")
    return OPS[name](cfg, norm, residual)
