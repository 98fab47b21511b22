"""VGD supernet search on one device (counterpart of
mmnas_tpu/engine/search_vgd.py).

The VQA search's bilevel loop (engine/search.py) with the task's dataset,
the supernet's VGD head, the VGD loss (engine/vgd.py: KLD or BCE scores plus
the masked SmoothL1 box loss, search_vgd.py:232-256) and, per epoch with
EVAL_EVERY_EPOCH, IoU@OVERLAP_THRESHOLD of the argmax path on the arch split,
with BBOX_NORM folded into proj_reg on the fp32 masters (search_vgd.py:~455).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from mmnas_tpu_torch.data.loader import Loader
from mmnas_tpu_torch.engine.search import SearchExecution as SearchBase
from mmnas_tpu_torch.engine.vgd import GroundingTask, eval_params, hits_over
from mmnas_tpu_torch.models.supernet import NetSearch


class SearchExecution(GroundingTask, SearchBase):
    def eval(self, eval_loader: Loader, net: NetSearch,
             alpha_host: Mapping[str, np.ndarray]) -> Optional[float]:
        """The argmax path's share of hits on the loader's split
        (mmnas_tpu/engine/search_vgd.py:41-77)."""
        eval_loader.sampler.set_shuffle(False)
        idx = net.chosen_indices(alpha_host)
        names = [n for n, m in net.update_mask(idx).items() if m > 0]
        hits, _ = hits_over(self.cfg, eval_loader, net, eval_params(net, self.cfg, names),
                            self.device, (None, idx))
        if not len(hits):
            return None
        acc = float(hits.sum()) / len(hits)
        print(f"search eval accuracy = {100.0 * acc:.2f} %")
        return acc
