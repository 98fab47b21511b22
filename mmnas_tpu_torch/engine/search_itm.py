"""ITM supernet search on one device (counterpart of
mmnas_tpu/engine/search_itm.py).

The VQA search's bilevel loop (engine/search.py) with the task's dataset,
the supernet's ITM head and, from engine/itm.py:

- the triplet loss of three forwards (positive, hard-negative caption,
  hard-negative image) through the same path in every weight and arch step
  (search_itm.py:399-423);
- hard-negative mining at the start of each mining epoch with one path
  sampled from alpha (search_itm.py:267-270), over the resident corpus. The
  path is drawn on the host from its own stream (MINE_STREAM + epoch) and
  recorded in `SearchResult.paths` as ("mine", epoch, idx);
- per epoch with EVAL_EVERY_EPOCH, the argmax path's R@K over the full score
  matrix of the separate val split (search_itm.py:533-534, :663-671); the
  value logged is i2t R@1.
"""

from __future__ import annotations

import time
from typing import Mapping, Optional

import numpy as np
import torch

from mmnas_tpu_torch.data.loader import Loader
from mmnas_tpu_torch.engine.itm import TripletTask, mine, pair_fns, recall_metrics, recall_scores
from mmnas_tpu_torch.engine.search import SearchExecution as SearchBase
from mmnas_tpu_torch.engine.search import SearchResult, sample_seed
from mmnas_tpu_torch.models.supernet import NetSearch

MINE_STREAM = 2_000_000_000  # the mining path of epoch e draws from MINE_STREAM + e


class SearchExecution(TripletTask, SearchBase):

    def build_eval_dataset(self):
        cfg = self.cfg
        if cfg.SYNTH:
            from mmnas_tpu_torch.data.synth import SynthItmDataset
            return SynthItmDataset(cfg, size=max(20, cfg.SYNTH_SIZE // 4), seed=cfg.SEED + 1,
                                   run_mode="val")
        from mmnas_tpu_torch.data.itm import ItmDataset
        return ItmDataset(cfg, "val")

    def pair_fns(self, net: NetSearch, idx: Mapping[str, np.ndarray]):
        """(encode, decode) of the path idx, casting only that path's
        parameters."""
        return pair_fns(net, self.cfg, idx,
                        names=[n for n, m in net.update_mask(idx).items() if m])

    def on_epoch_start(self, result: SearchResult, dataset, epoch: int) -> None:
        """Hard-negative mining with a sampled path (search_itm.py:267-270)."""
        cfg = self.cfg
        if not self.mining_epoch(dataset, epoch):
            return
        net = result.net
        sampler = torch.Generator().manual_seed(sample_seed(cfg.SEED, MINE_STREAM + epoch))
        idx = net.sample_indices(result.alpha_host, sampler)
        result.paths.append(("mine", epoch, idx))
        t0 = time.time()
        rng = np.random.RandomState(cfg.SEED * 97 + epoch)
        with torch.inference_mode():
            mine(cfg, dataset, self.device_corpus(dataset), rng, *self.pair_fns(net, idx))
        print(f"search mining: {time.time() - t0:.1f}s")

    def eval(self, eval_loader: Loader, net: NetSearch,
             alpha_host: Mapping[str, np.ndarray]) -> Optional[float]:
        """The argmax path's R@K on the val split; returns its i2t R@1 as a
        share."""
        dataset = self.__dict__.get("_eval_dataset")
        if dataset is None:
            dataset = self._eval_dataset = self.build_eval_dataset()
        idx = net.chosen_indices(alpha_host)
        with torch.inference_mode():
            scores = recall_scores(self.cfg, dataset, self.device_corpus(dataset),
                                   *self.pair_fns(net, idx))
        stats = recall_metrics(scores)
        print("search i2t R@1/5/10: %.02f %.02f %.02f" %
              (stats["i2t_r1"], stats["i2t_r5"], stats["i2t_r10"]))
        print("search t2i R@1/5/10: %.02f %.02f %.02f" %
              (stats["t2i_r1"], stats["t2i_r5"], stats["t2i_r10"]))
        return stats["i2t_r1"] / 100.0
