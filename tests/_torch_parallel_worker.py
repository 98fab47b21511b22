"""The port's data-parallel paths in a 2-process gloo group on the CPU, for
tests/test_torch_parallel.py:

    python tests/_torch_parallel_worker.py SPEC.pkl

SPEC is a pickled dict of Cfg / SearchCfg keyword arguments, written by the
test. `mmnas_tpu_torch.parallel.mesh.spawn` starts two processes, one gloo
group; each runs, through the engines' own loops:

- the VQA train from the epoch-0 checkpoint for one epoch, a resume from
  rank 0's epoch-1 checkpoint for a second, and the eval of the epoch-2
  checkpoint;
- the VQA search for one epoch at KPATH 1 'full' and at KPATH 2 'two';
- the VGD eval of a checkpoint, one VGD train step and one VGD search
  weight step (an epoch each from an epoch-0 checkpoint);
- the ITM mining of epoch 0, one triplet train step on the mined negatives
  and the R@K eval, and one ITM train step from an epoch-0 checkpoint.

With --fail in place of SPEC, rank 1 raises while rank 0 waits for it.

Each rank pickles what it saw to <out>/rank<r>.pkl: losses, paths,
predictions, hits, negatives, scores, the first all-reduced gradient of
each train step, its collective counts, and which modules of jax or the JAX
package it loaded (none may be)."""

import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from mmnas_tpu_torch.parallel import mesh as pmesh  # noqa: E402

# the group's limit: a rank that died ends the others' collectives
GROUP_TIMEOUT_S = 120


def one_step_grads(exe, net, batch_keys, loader):
    """The engine's train_step on the loader's first batch: the gradients it
    hands the clip (averaged over the ranks), as numpy, in parameter order."""
    from mmnas_tpu_torch.engine.vqa import batch_to_device
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    seen = []
    reduce = pmesh.all_reduce_grads

    def recording(grads, **kw):
        reduce(grads, **kw)
        seen.append([g.detach().clone().numpy() for g in grads])

    params = dict(net.named_parameters())
    optim = build_net_optimizer(exe.cfg, loader.steps_per_epoch())
    batch = batch_to_device(next(iter(loader)), exe.device, batch_keys)
    pmesh.all_reduce_grads = recording
    try:
        exe.train_step(net, optim, optim.init(params), params, batch,
                       torch.Generator().manual_seed(0))
    finally:
        pmesh.all_reduce_grads = reduce
    return seen[0]


def member(device, spec_path):
    from mmnas_tpu_torch.config import Cfg, SearchCfg
    from mmnas_tpu_torch.engine import itm as PI
    from mmnas_tpu_torch.engine import vgd as PV
    from mmnas_tpu_torch.engine.search import SearchExecution
    from mmnas_tpu_torch.engine.search_vgd import SearchExecution as VgdSearchExecution
    from mmnas_tpu_torch.engine.vqa import Execution, batch_to_device
    from mmnas_tpu_torch.models.net import INPUT_KEYS
    from mmnas_tpu_torch.train.checkpoint import ckpt_path

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    assert pmesh.world_size() == 2
    out = {"rank": pmesh.rank()}

    # VQA train: one epoch, a resume from rank 0's checkpoint, the eval
    cfg = Cfg(**spec["vqa_train"])
    pmesh.zero_counts()
    first = Execution(cfg, device).run()
    steps = len(first.step_losses)
    out["vqa_counts_epoch1"] = dict(pmesh.COUNTS)
    cfg = cfg.replace(CKPT_FILE_PATH=ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, 1), MAX_EPOCH=2)
    second = Execution(cfg, device).run()
    evaluated = Execution(cfg.replace(RUN_MODE="val", CKPT_FILE_PATH=ckpt_path(
        cfg.CKPT_ROOT, cfg.VERSION, 2)), device).run()
    out["vqa_train"] = {"steps_epoch1": steps,
                        "step_losses": first.step_losses + second.step_losses,
                        "epoch_losses": first.epoch_losses + second.epoch_losses,
                        "preds": evaluated.preds, "accuracy": evaluated.accuracy}

    # VQA search, one epoch a leg
    for leg in ("search_k1", "search_k2"):
        pmesh.zero_counts()
        result = SearchExecution(SearchCfg(**spec[leg]), device).run()
        out[leg] = {"paths": result.paths, "step_losses": result.step_losses,
                    "counts": dict(pmesh.COUNTS),
                    "alpha": {c: a.numpy().copy() for c, a in result.alpha.items()}}

    # VGD: the eval's hits, one train step, one search weight step
    cfg = Cfg(**spec["vgd"])
    out["vgd_hits"] = PV.Execution(cfg, device).run().hits
    exe = PV.Execution(Cfg(**spec["vgd_step"]), device)
    out["vgd_step"] = exe.run().step_losses
    loader = exe.make_loader(exe.build_dataset("train"), exe.cfg.BATCH_SIZE, shuffle=True)
    loader.sampler.set_epoch(0)
    batch = batch_to_device(next(iter(loader)), device, exe.TARGET_KEYS)
    out["vgd_mask_counts"] = (float(batch["scores_mask"].sum()), float(batch["bbox_mask"].sum()))
    out["vgd_search"] = {"paths": VgdSearchExecution(SearchCfg(**spec["vgd_search"]),
                                                     device).run().paths}

    # ITM: the mining of epoch 0, one triplet step on its negatives, R@K
    cfg = Cfg(**spec["itm"])
    exe = PI.Execution(cfg, device)
    ds = exe.build_dataset("train")
    net = exe.load_masters(ds)
    exe.on_epoch_start(net, ds, 0)
    out["itm_negatives"] = (ds.neg_caps_idx_tensor.copy(), ds.neg_imgs_idx_tensor.copy())
    out["itm_grads"] = one_step_grads(exe, net, INPUT_KEYS + exe.TARGET_KEYS,
                                      exe.make_loader(ds, cfg.BATCH_SIZE, shuffle=True))
    recall = exe.eval(exe.make_loader(ds, cfg.EVAL_BATCH_SIZE), net=exe.load_masters(ds))
    out["itm_scores"], out["itm_stats"] = recall.scores, recall.stats
    out["itm_step"] = PI.Execution(Cfg(**spec["itm_step"]), device).run().step_losses

    out["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib", "mmnas_tpu"))
    with open(os.path.join(spec["out"], f"rank{pmesh.rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)


def failing_member(device):
    """Rank 1 raises while rank 0 waits for it at a barrier."""
    if pmesh.rank() == 1:
        raise RuntimeError("rank 1 fails")
    pmesh.barrier()


if __name__ == "__main__":
    import datetime

    fail = sys.argv[1] == "--fail"
    pmesh.spawn(failing_member if fail else member, () if fail else (sys.argv[1],),
                [torch.device("cpu")] * 2, datetime.timedelta(seconds=GROUP_TIMEOUT_S))
