"""The port's tensor-parallel paths in a 4-process gloo group on the CPU
(data 2 x model 2), for tests/test_torch_tensor_parallel.py:

    python tests/_torch_tensor_parallel_worker.py SPEC.pkl

SPEC is a pickled dict of Cfg / SearchCfg keyword arguments, written by the
test. `mmnas_tpu_torch.parallel.mesh.spawn` starts four processes, one gloo
group laid out at model axis 2; each runs, through the engines' own loops:

- the VQA train from the epoch-0 checkpoint for one epoch, a resume from
  rank 0's epoch-1 checkpoint for a second, and the eval of the epoch-2
  checkpoint;
- the VQA search for one epoch at KPATH 1 'full';
- one VGD and one ITM train step (an epoch of one global batch).

Each rank pickles what it saw to <out>/rank<r>.pkl: its place in the grid,
losses, paths, predictions, alpha, its collective counts, and which modules
of jax or the JAX package it loaded (none may be).

    python tests/_torch_tensor_parallel_worker.py SPEC.pkl unified

starts two processes instead (data 1 x model 2), each running the VQA
searches of SPEC["unified"] (--UNIFIED_WEIGHT) in turn and pickling their
losses and paths to <out>/unified_rank<r>.pkl."""

import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from mmnas_tpu_torch.parallel import mesh as pmesh  # noqa: E402

WORLD, MODEL_AXIS = 4, 2
# the group's limit: a rank that died ends the others' collectives
GROUP_TIMEOUT_S = 120


def member(device, spec_path):
    from mmnas_tpu_torch.config import Cfg, SearchCfg
    from mmnas_tpu_torch.engine import itm as PI
    from mmnas_tpu_torch.engine import vgd as PV
    from mmnas_tpu_torch.engine.search import SearchExecution
    from mmnas_tpu_torch.engine.vqa import Execution
    from mmnas_tpu_torch.train.checkpoint import ckpt_path

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out = {"rank": pmesh.rank(), "grid": (pmesh.data_rank(), pmesh.model_rank(),
                                          pmesh.data_axis_size(), pmesh.model_axis_size())}

    # VQA train: one epoch, a resume from rank 0's checkpoint, the eval
    cfg = Cfg(**spec["vqa_train"])
    pmesh.zero_counts()
    first = Execution(cfg, device).run()
    out["counts_epoch1"] = (dict(pmesh.COUNTS), dict(pmesh.MODEL_COUNTS))
    out["shapes"] = {n: tuple(p.shape) for n, p in first.net.named_parameters()}
    cfg = cfg.replace(CKPT_FILE_PATH=ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, 1), MAX_EPOCH=2)
    second = Execution(cfg, device).run()
    evaluated = Execution(cfg.replace(RUN_MODE="val", CKPT_FILE_PATH=ckpt_path(
        cfg.CKPT_ROOT, cfg.VERSION, 2)), device).run()
    out["vqa_train"] = {"step_losses": first.step_losses + second.step_losses,
                        "epoch_losses": first.epoch_losses + second.epoch_losses,
                        "preds": evaluated.preds}

    # VQA search, one epoch
    result = SearchExecution(SearchCfg(**spec["search"]), device).run()
    out["search"] = {"paths": result.paths, "step_losses": result.step_losses,
                     "alpha": {c: a.numpy().copy() for c, a in result.alpha.items()}}

    # one VGD and one ITM train step
    for task, mod in (("vgd", PV), ("itm", PI)):
        out[task] = mod.Execution(Cfg(**spec[task]), device).run().step_losses

    out["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib", "mmnas_tpu"))
    with open(os.path.join(spec["out"], f"rank{pmesh.rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)


def unified_member(device, spec_path):
    from mmnas_tpu_torch.config import SearchCfg
    from mmnas_tpu_torch.engine.search import SearchExecution

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    runs = []
    for kw in spec["unified"]:
        result = SearchExecution(SearchCfg(**kw), device).run()
        runs.append({"step_losses": result.step_losses, "paths": result.paths})
    with open(os.path.join(spec["out"], f"unified_rank{pmesh.rank()}.pkl"), "wb") as f:
        pickle.dump({"grid": (pmesh.data_rank(), pmesh.model_rank(), pmesh.data_axis_size(),
                              pmesh.model_axis_size()), "runs": runs}, f)


if __name__ == "__main__":
    import datetime

    fn, world = (unified_member, MODEL_AXIS) if sys.argv[2:] == ["unified"] else (member, WORLD)
    pmesh.spawn(fn, (sys.argv[1],), [torch.device("cpu")] * world,
                datetime.timedelta(seconds=GROUP_TIMEOUT_S), model_axis=MODEL_AXIS)
