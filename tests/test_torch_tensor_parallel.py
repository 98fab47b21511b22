"""The port's tensor parallelism (mmnas_tpu_torch/parallel/sharding.py,
--MODEL_AXIS > 1) on the CPU, over gloo.

(a) The rules: `spec_for_path` splits exactly the leaves the JAX package's
`_spec_for_path` splits, on every leaf of the VQA, VGD and ITM NetFull, the
41-op NetFull and the supernet (mapped by `jax_path` from the port's
names), and `shard_module` takes every split leaf of those nets at model
axis 2, each halved along its split dim. The feed_forward op's own fc and
linear stay whole (the rules' text, not their docstring, decides).
(b) The dropout kernel's plain keep mask at head0 / heads_total is the
whole call's mask at those heads.
(c) One 4-process gloo run (tests/_torch_tensor_parallel_worker.py, started
once for the module: data 2 x model 2; the worker has 300 s, the group's
collectives 120 s), tiny sizes, HSIZE 128 (attention ops of 64-wide heads
run one head a rank; self_att_128's one head does not split and runs whole
on each rank), DROPOUT_R 0, against the JAX engines at N_DEVICES 4,
MODEL_AXIS 2 on conftest's virtual CPU devices, fed the global batches a
2-process JAX run assembles (tests/test_torch_parallel.py's
RankMajorLoader): the VQA train for two epochs (the port resumes from rank
0's epoch-1 checkpoint), the VQA search at KPATH 1 'full' (the JAX engine
replays rank 0's paths), one VGD and one ITM train step. Parameters,
optimizer states and alpha agree to 1e-5, the gradient-free leaves to
Adam's step (as tests/test_torch_parallel.py holds them); the losses to
1e-5; every rank has the same paths and alpha.
(d) The checkpoints written at model axis 2 are the JAX package's unsharded
pytree: the JAX engine's eval at MODEL_AXIS 2 of the port's epoch-2
checkpoint predicts what the port's eval predicted, and the port in one
process (model axis 1, the same global batch) resumes from the port's
epoch-1 checkpoint to the JAX run's epoch 2.
(e) The ranks sit on the grid as the JAX mesh lays out its devices, hold
half of each split leaf, and talk over the model group; the workers load no
jax and no mmnas_tpu module.
(f) --UNIFIED_WEIGHT at data 1 x model 2 (a second worker of 2 processes,
started beside the first): two weight steps at DROPOUT_R 0.1, HSIZE 128 (the
unified node's heads split, one a rank) and HSIZE 64 (its one head runs
whole on each rank), equal the port in one process: losses, paths,
parameters and Adam moments to 1e-5, alpha bit for bit.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec

import mmnas_tpu.parallel.mesh as jax_mesh
from mmnas_tpu.config import Cfg, SearchCfg
from mmnas_tpu.engine import itm as JI
from mmnas_tpu.engine import vgd as JV
from mmnas_tpu.engine.search import SearchExecution as JaxSearchExecution
from mmnas_tpu.engine.vqa import Execution as JaxExecution
from mmnas_tpu.parallel.sharding import _spec_for_path
from mmnas_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mmnas_tpu.train.optimizer import build_net_optimizer as jax_build_net_optimizer
from mmnas_tpu.train.optimizer import plain_adam as jax_plain_adam
from mmnas_tpu_torch.config import Cfg as PortCfg
from mmnas_tpu_torch.config import SearchCfg as PortSearchCfg
from mmnas_tpu_torch.data.synth import SynthItmDataset, SynthVgdDataset, SynthVqaDataset
from mmnas_tpu_torch.engine.search import SearchExecution
from mmnas_tpu_torch.engine.vqa import Execution
from mmnas_tpu_torch.genotype import load_genotype
from mmnas_tpu_torch.models.convert import to_jax_params
from mmnas_tpu_torch.models.net import NetFull
from mmnas_tpu_torch.models.supernet import NetSearch
from mmnas_tpu_torch.ops import fused_attention as FA
from mmnas_tpu_torch.parallel import sharding as S

from _torch_tensor_parallel_worker import MODEL_AXIS, WORLD
from _torch_threads import one_thread_env, one_torch_thread  # noqa: F401  (autouse)
from test_torch_engine import SMALL as VQA_SMALL
from test_torch_itm_engine import TRAIN as ITM_TRAIN
from test_torch_op_library import CFG as ALL_OPS_CFG
from test_torch_op_library import GENE as ALL_OPS_GENE
from test_torch_parallel import RankMajorLoader
from test_torch_search_engine import SMALL as SEARCH_SMALL
from test_torch_search_engine import assert_checkpoints_agree, run_jax_replaying
from test_torch_vgd_engine import TRAIN as VGD_TRAIN

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_tensor_parallel_worker.py"
DATA = WORLD // MODEL_AXIS
WORKER_TIMEOUT_S = 300
# every candidate op of the search spaces, self_att_128 (one 128-wide head:
# it does not split over 2 and runs whole on each model rank) and
# feed_forward_deep (its inner mlp pair splits, its first fc does not)
GENE = {"epoch0": {"enc": [["self_att_64"], ["feed_forward"]],
                   "dec": [["rel_self_att_64"], ["guided_att_64"], ["self_att_128"],
                           ["feed_forward_deep"]]}}
WIDE = dict(HSIZE=128, ATTFLAT_OUT_SIZE=128)
# 16 items: each epoch two global batches of 2 x 4, no pad; the eval's 3 a
# data shard leave a pad item in each shard's last batch
VQA = dict(VQA_SMALL, **WIDE, SYNTH_SIZE=16, EVAL_BATCH_SIZE=3, VERSION="tp")
# 40 items: a weight split of 32 (4 steps of 2 x 4), an arch split of 8
SEARCH = dict(SEARCH_SMALL, **WIDE, SYNTH_SIZE=40, VERSION="tp-search")
# one global batch of 2 x 4 (VGD), of 2 x 5 captions (ITM, random negatives)
VGD = dict(VGD_TRAIN, **WIDE, SYNTH_SIZE=8, VERSION="tp-vgd")
ITM = dict(ITM_TRAIN, **WIDE, SYNTH_SIZE=10, BATCH_SIZE=5, NEG_START_EPOCH=1, VERSION="tp-itm")
# two --UNIFIED_WEIGHT weight steps of 4 (10 items: a weight split of 8),
# no arch step, the attention and output dropout on
UNIFIED = dict(SEARCH_SMALL, UNIFIED_WEIGHT_STEP=True, SYNTH_SIZE=10, DROPOUT_R=0.1,
               ALPHA_START=1, MAX_EPOCH=1, EVAL_EVERY_EPOCH=False)
UNIFIED_WIDTHS = (128, 64)
TOL = 1e-5
# the AttFlat glimpse biases (and VGD's proj_scores bias), whose true
# gradient is 0: Adam turns rounding noise into moves of up to lr either
# way; 4 warmup steps (2 at lr / 4, 2 at lr / 2) of the VQA train, one (lr /
# 4) of the VGD and ITM steps
INVARIANT = {"attflat_x.mlp.linear.bias", "attflat_y.mlp.linear.bias", "proj_scores.bias"}


def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def rank_major_loader(self, dataset, shuffle, subset_indices=None, batch_size=None):
    return RankMajorLoader(dataset, batch_size or self.cfg.BATCH_SIZE, shuffle, subset_indices)


def init_dict(ds):
    return {"token_size": ds.token_size, "ans_size": getattr(ds, "ans_size", 1),
            "pretrained_emb": ds.pretrained_emb}


# ------------------------------------------------------------------ (a), (b)
def jax_rules(tree):
    """Each leaf's path -> the split dim the JAX package's rules give it."""
    dims = {PartitionSpec(): None, PartitionSpec(None, "model"): 1,
            PartitionSpec("model", None): 0}
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        out["/".join(str(n) for n in names)] = dims[_spec_for_path(path, leaf)]
    return out


DATASETS = {"vqa": SynthVqaDataset, "vgd": SynthVgdDataset, "itm": SynthItmDataset}


def small_net(task, kind):
    """The shipped genotype's NetFull of `task`, its supernet, or the 41-op
    NetFull, at tiny widths."""
    if kind == "all_ops":
        return NetFull(ALL_OPS_CFG, ALL_OPS_GENE,
                       init_dict(SynthVqaDataset(ALL_OPS_CFG, size=5, seed=1)))
    if kind == "search":
        cfg = PortSearchCfg(**dict(SEARCH, TASK=task))
        return NetSearch(cfg, init_dict(DATASETS[task](cfg, size=5, seed=1)), task=task)
    cfg = PortCfg(**dict(VQA_SMALL, **WIDE, TASK=task))
    return NetFull(cfg, load_genotype(str(ROOT / "arch" / f"mmnas_{task}.json")),
                   init_dict(DATASETS[task](cfg, size=5, seed=1)), task=task)


@pytest.mark.parametrize("task,kind", [("vqa", "full"), ("vgd", "full"), ("itm", "full"),
                                       ("vqa", "search"), ("vgd", "search"), ("itm", "search"),
                                       ("vqa", "all_ops")])
def test_the_rules_split_the_jax_packages_leaves_and_every_one_shards(task, kind):
    net = small_net(task, kind)
    want = jax_rules(to_jax_params(net))
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    got = {S.jax_path(n): S.spec_for_path(S.jax_path(n), len(s)) for n, s in shapes.items()}
    assert got == want
    split = {n: S.split_dim(n, len(s)) for n, s in shapes.items() if S.split_dim(n, len(s))
             is not None}
    assert any(".mlp.fc." in n for n in split) and any(".wq." in n for n in split)
    # the feed_forward op's own pair stays whole
    assert not [n for n in split if ".core.fc." in n or ".core.linear." in n]
    S.shard_module(net, rank=1, size=2)
    assert net.tp_split == split
    for n, p in net.named_parameters():
        want_shape = list(shapes[n])
        if n in split:
            want_shape[split[n]] //= 2
        assert list(p.shape) == want_shape, n


def test_keep_mask_at_head0_is_the_whole_calls_heads():
    whole = FA.keep_mask_reference(17, 2, 8, 5, 7, 0.3)
    for head0 in (0, 4):
        np.testing.assert_array_equal(FA.keep_mask_reference(17, 2, 4, 5, 7, 0.3, head0, 8),
                                      whole[:, head0:head0 + 4])
    assert 0.5 < float(whole.float().mean()) < 0.9


def test_cpu_attention_dropout_at_head0_draws_the_whole_calls_mask():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 4, 5, 16, generator=g) for _ in range(3))
    whole = FA.fused_attention(q, k, v, dropout_r=0.5, generator=torch.Generator().manual_seed(9))
    for head0 in (0, 2):
        part = FA.fused_attention(*(t[:, head0:head0 + 2] for t in (q, k, v)), dropout_r=0.5,
                                  generator=torch.Generator().manual_seed(9), head0=head0,
                                  heads_total=4)
        torch.testing.assert_close(part, whole[:, head0:head0 + 2], rtol=0, atol=0)


# ------------------------------------------------------------------ (c)-(e)
def write_starts(tmp, arch):
    """The epoch-0 checkpoints every run starts from: seeded port inits in
    the JAX package's pytree, with the JAX package's optimizer states."""
    for name, kw, ds_cls, steps in (("vqa", VQA, SynthVqaDataset, 2),
                                    ("vgd", VGD, SynthVgdDataset, 1),
                                    ("itm", ITM, SynthItmDataset, 1)):
        cfg = PortCfg(**dict(kw, ARCH_PATH=arch))
        ds = ds_cls(cfg, size=cfg.SYNTH_SIZE, seed=cfg.SEED)
        params = to_jax_params(NetFull(cfg.replace(SEED=4), load_genotype(arch), init_dict(ds),
                                       task=cfg.TASK))
        jax_save_checkpoint(str(tmp / f"{name}_epoch0.pkl"), {
            "state_dict": params,
            "net_optim": jax_build_net_optimizer(Cfg(**kw), steps).init(params), "epoch": 0})
    scfg = PortSearchCfg(**SEARCH)
    net = NetSearch(scfg.replace(SEED=5), init_dict(SynthVqaDataset(scfg, size=scfg.SYNTH_SIZE,
                                                                    seed=scfg.SEED)))
    params = to_jax_params(net)
    r = np.random.RandomState(6)
    alpha = {c: a.numpy() + r.randn(*a.shape).astype(np.float32) * 0.5
             for c, a in net.init_alpha().items()}
    jcfg = SearchCfg(**SEARCH)
    aoptim = jax_plain_adam(jcfg.ALPHA_LR_BASE, jcfg.ALPHA_OPT_BETAS, eps=1e-8)
    jax_save_checkpoint(str(tmp / "search_epoch0.pkl"), {
        "state_dict": params, "net_optim": jax_build_net_optimizer(jcfg, 4).init(params),
        "alpha": alpha, "alpha_optim": aoptim.init(alpha), "epoch": 0})


def specs(tmp, arch):
    def run(kw, name, **extra):
        return dict(kw, RUN_MODE="train", RESUME=True, MAX_EPOCH=1, ARCH_PATH=arch,
                    EVAL_EVERY_EPOCH=False, CKPT_FILE_PATH=str(tmp / f"{name}_epoch0.pkl"),
                    CKPT_ROOT=str(tmp / "port" / name), LOG_ROOT=str(tmp / "port" / name / "log"),
                    **extra)

    return {"out": str(tmp), "vqa_train": run(VQA, "vqa"), "vgd": run(VGD, "vgd"),
            "itm": run(ITM, "itm"),
            "search": dict(SEARCH, RESUME=True, MAX_EPOCH=1, KPATH=1, ALPHA_BINARY_MODE="full",
                           EVAL_EVERY_EPOCH=True, CKPT_FILE_PATH=str(tmp / "search_epoch0.pkl"),
                           CKPT_ROOT=str(tmp / "port" / "search"),
                           ARCH_ROOT=str(tmp / "port" / "search" / "arch"),
                           LOG_ROOT=str(tmp / "port" / "search" / "log")),
            "unified": [unified_spec(tmp, h, "port") for h in UNIFIED_WIDTHS]}


def unified_spec(tmp, hsize, root):
    return dict(UNIFIED, HSIZE=hsize, VERSION=f"tp-unified{hsize}",
                CKPT_ROOT=str(tmp / root / "unified"), ARCH_ROOT=str(tmp / root / "unified"),
                LOG_ROOT=str(tmp / root / "unified" / "log"))


def jax_cfg(cls, kw, tmp, name, **extra):
    return cls(**dict(kw, N_DEVICES=WORLD, MODEL_AXIS=MODEL_AXIS, CKPT_ROOT=str(tmp / "jax" / name),
                      LOG_ROOT=str(tmp / "jax" / name / "log"), **extra))


def jax_runs(tmp, spec):
    """The JAX engines at N_DEVICES 4, MODEL_AXIS 2 on the global batches:
    the VQA train's two epochs and the fixed-net VGD and ITM steps."""
    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JaxExecution, "make_loader", rank_major_loader)
        exe = JaxExecution(jax_cfg(Cfg, spec["vqa_train"], tmp, "vqa", MAX_EPOCH=2))
        out["vqa_history"] = exe.train(exe.make_loader(exe.build_dataset("train"),
                                                       shuffle=True))[2]
        for name, mod in (("vgd", JV), ("itm", JI)):
            mod.Execution(jax_cfg(Cfg, spec[name], tmp, name)).run()
    return out


def jax_eval_preds(cfg):
    """The JAX engine's eval of cfg.CKPT_FILE_PATH: its predictions in
    dataset order."""
    preds, order = [], jax_mesh.eval_dataset_order

    def recording(*args):
        preds.append(order(*args))
        return preds[-1]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_mesh, "eval_dataset_order", recording)
        JaxExecution(cfg).run()
    return preds[0]


def port_resumed_at_model_axis_1(tmp, spec):
    """The port in this process (no group, model axis 1) from the epoch-1
    checkpoint the 4 ranks wrote, for epoch 2 at the global batch (2 x 4:
    the same examples a step)."""
    cfg = PortCfg(**dict(spec["vqa_train"], BATCH_SIZE=VQA["BATCH_SIZE"] * DATA, MAX_EPOCH=2,
                         CKPT_FILE_PATH=str(tmp / "port" / "vqa" / "tp_epoch1.pkl"),
                         CKPT_ROOT=str(tmp / "one" / "vqa"),
                         LOG_ROOT=str(tmp / "one" / "vqa" / "log")))
    return Execution(cfg, torch.device("cpu")).run()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    arch = str(tmp / "arch.json")
    Path(arch).write_text(json.dumps(GENE))
    write_starts(tmp, arch)
    spec = specs(tmp, arch)
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    t0 = time.time()
    workers = {}
    try:             # this process's runs while the workers run theirs
        for name, extra in (("worker", []), ("unified", ["unified"])):
            with open(tmp / f"{name}.log", "w") as log:
                workers[name] = subprocess.Popen(
                    [sys.executable, str(WORKER), str(tmp / "spec.pkl")] + extra, cwd=str(ROOT),
                    stdout=log, stderr=subprocess.STDOUT, env=one_thread_env(),
                    start_new_session=True)
        jax = jax_runs(tmp, spec)
        for worker in workers.values():
            worker.wait(timeout=max(1.0, WORKER_TIMEOUT_S - (time.time() - t0)))
    finally:         # the spawned ranks too, should a worker be left running
        for worker in workers.values():
            if worker.poll() is None:
                os.killpg(worker.pid, signal.SIGKILL)
                worker.wait()
    for name, worker in workers.items():
        assert worker.returncode == 0, (tmp / f"{name}.log").read_text()[-3000:]
    ranks = [load_pickle(tmp / f"rank{r}.pkl") for r in range(WORLD)]
    # the JAX search replays the paths rank 0 sampled
    cfg = jax_cfg(SearchCfg, spec["search"], tmp, "search",
                  ARCH_ROOT=str(tmp / "jax" / "search" / "arch"))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JaxSearchExecution, "make_loader", rank_major_loader)
        run_jax_replaying(cfg, ranks[0]["search"]["paths"], m)
    jax["search_log"] = (tmp / "jax" / "search" / "log" / f"log_{cfg.VERSION}.txt").read_text()
    # the JAX eval of the port's epoch-2 checkpoint, written at model axis 2
    jax["preds"] = jax_eval_preds(jax_cfg(Cfg, spec["vqa_train"], tmp, "vqa_eval", RUN_MODE="val",
                                          CKPT_FILE_PATH=str(tmp / "port" / "vqa" /
                                                             "tp_epoch2.pkl")))
    one = port_resumed_at_model_axis_1(tmp, spec)
    unified = [load_pickle(tmp / f"unified_rank{r}.pkl") for r in range(MODEL_AXIS)]
    return {"tmp": tmp, "ranks": ranks, "jax": jax, "one": one, "unified": unified}


def assert_trees_agree(got, want, invariant_tol):
    """params and net_optim leaf by leaf to TOL; the INVARIANT parameters to
    invariant_tol (Adam's steps)."""
    assert got["epoch"] == want["epoch"]
    for key in ("state_dict", "net_optim"):
        assert jax.tree_util.tree_structure(got[key]) == jax.tree_util.tree_structure(want[key])
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got[key]),
                                jax.tree_util.tree_leaves(want[key])):
            assert np.shape(a) == np.shape(b) and np.asarray(a).dtype == np.asarray(b).dtype
            names = [str(getattr(k, "key", getattr(k, "idx", ""))) for k in path]
            name = ".".join(names[:-1] + [{"w": "weight", "b": "bias"}.get(names[-1],
                                                                          names[-1])])
            atol = invariant_tol if key == "state_dict" and name in INVARIANT else TOL
            np.testing.assert_allclose(a, b, rtol=TOL, atol=atol,
                                       err_msg=f"{key}{jax.tree_util.keystr(path)}")


def test_vqa_train_with_resume_matches_jax_at_data_2_model_2(runs):
    tmp, ranks = runs["tmp"], runs["ranks"]
    for r in ranks:          # every rank logs the global batches' losses
        assert r["vqa_train"]["epoch_losses"] == pytest.approx(runs["jax"]["vqa_history"],
                                                               rel=TOL)
        assert r["vqa_train"]["step_losses"] == ranks[0]["vqa_train"]["step_losses"]
    assert len(ranks[0]["vqa_train"]["step_losses"]) == 4
    lr = VQA_SMALL.get("NET_LR_BASE", PortCfg().NET_LR_BASE)
    assert_trees_agree(load_pickle(tmp / "port" / "vqa" / "tp_epoch2.pkl"),
                       load_pickle(tmp / "jax" / "vqa" / "tp_epoch2.pkl"),
                       2 * (2 * lr / 4 + 2 * lr / 2))


def test_checkpoint_written_at_model_axis_2_evaluates_in_jax_and_resumes_at_1(runs):
    tmp, ranks = runs["tmp"], runs["ranks"]
    # every rank holds every prediction, in dataset order; the JAX eval of
    # the same checkpoint at MODEL_AXIS 2 predicts the same
    for r in ranks:
        np.testing.assert_array_equal(r["vqa_train"]["preds"], runs["jax"]["preds"])
    assert len(runs["jax"]["preds"]) == VQA["SYNTH_SIZE"]
    one = runs["one"]
    assert one.epoch_losses == pytest.approx(runs["jax"]["vqa_history"][1:], rel=TOL)
    lr = PortCfg().NET_LR_BASE
    assert_trees_agree(load_pickle(tmp / "one" / "vqa" / "tp_epoch2.pkl"),
                       load_pickle(tmp / "jax" / "vqa" / "tp_epoch2.pkl"),
                       2 * (2 * lr / 4 + 2 * lr / 2))


def test_vqa_search_matches_jax_at_data_2_model_2(runs):
    tmp, ranks = runs["tmp"], runs["ranks"]
    kinds = [kind for kind, _, _ in ranks[0]["search"]["paths"]]
    assert kinds == ["weight", "weight", "arch"] * 2
    for r in ranks:          # every rank sampled the same paths, ends with the same alpha
        assert pickle.dumps(r["search"]["paths"]) == pickle.dumps(ranks[0]["search"]["paths"])
        for c, a in ranks[0]["search"]["alpha"].items():
            np.testing.assert_array_equal(r["search"]["alpha"][c], a)
        assert r["search"]["step_losses"] == ranks[0]["search"]["step_losses"]
    name = "tp-search_epoch1.pkl"
    assert_checkpoints_agree(load_pickle(tmp / "port" / "search" / name),
                             load_pickle(tmp / "jax" / "search" / name))
    log = (tmp / "port" / "search" / "log" / "log_tp-search.txt").read_text()
    evals = [line for line in log.splitlines() if line.startswith("eval accuracy")]
    assert len(evals) == 1 and evals == [line for line in runs["jax"]["search_log"].splitlines()
                                         if line.startswith("eval accuracy")]
    assert (json.loads((tmp / "port" / "search" / "arch" / "tp-search.json").read_text())
            == json.loads((tmp / "jax" / "search" / "arch" / "tp-search.json").read_text()))


@pytest.mark.parametrize("task", ["vgd", "itm"])
def test_vgd_and_itm_train_steps_match_jax_at_data_2_model_2(runs, task):
    tmp, ranks = runs["tmp"], runs["ranks"]
    for r in ranks:
        assert len(r[task]) == 1 and r[task] == ranks[0][task]
    lr = PortCfg(**(VGD if task == "vgd" else ITM)).NET_LR_BASE
    assert_trees_agree(load_pickle(tmp / "port" / task / f"tp-{task}_epoch1.pkl"),
                       load_pickle(tmp / "jax" / task / f"tp-{task}_epoch1.pkl"), 2 * lr / 4)


def test_ranks_sit_on_the_jax_grid_hold_half_of_each_split_leaf_and_load_no_jax(runs):
    ranks = runs["ranks"]
    for r in ranks:
        # rank r: data shard r // 2, model shard r % 2 (mmnas_tpu/parallel/mesh.py:41-44)
        assert r["grid"] == (r["rank"] // MODEL_AXIS, r["rank"] % MODEL_AXIS, DATA, MODEL_AXIS)
        assert r["loaded"] == []
        counts, model_counts = r["counts_epoch1"]
        # 2 train steps over the data group, one bucket each
        assert counts["all_reduce"] == 2 and counts["broadcast"] == 1
        # the megatron f / g and the whole op's gathers over the model group
        assert model_counts["all_reduce"] > 0 and model_counts["gather"] > 0
    shapes = ranks[0]["shapes"]
    assert shapes == ranks[1]["shapes"]
    wq = shapes["dec.0.0.0.core.wq.weight"]
    assert wq == (64, 128) and shapes["dec.0.0.0.core.wm.weight"] == (128, 64)
    assert shapes["dec.0.0.0.core.wr.weight"] == (2, 8)         # replicated: both heads
    assert shapes["attflat_x.mlp.fc.weight"] == (16, 128)
    assert shapes["dec.0.3.0.core.mlp.linear.weight"] == (128, 128)
    assert shapes["dec.0.3.0.core.fc.weight"] == (256, 128)      # feed_forward_deep's first fc
    assert shapes["enc.0.1.0.core.fc.weight"] == (512, 128)      # feed_forward: whole


@pytest.mark.parametrize("run", range(len(UNIFIED_WIDTHS)),
                         ids=[f"hsize{h}" for h in UNIFIED_WIDTHS])
def test_unified_weight_steps_at_data_1_model_2_match_one_process(runs, run):
    tmp, ranks = runs["tmp"], runs["unified"]
    hsize = UNIFIED_WIDTHS[run]
    one = SearchExecution(PortSearchCfg(**unified_spec(tmp, hsize, "one")),
                          torch.device("cpu")).run()
    assert [r["grid"] for r in ranks] == [(0, m, 1, MODEL_AXIS) for m in range(MODEL_AXIS)]
    assert [kind for kind, _, _ in one.paths] == ["weight"] * 2
    for r in ranks:
        assert pickle.dumps(r["runs"][run]["paths"]) == pickle.dumps(one.paths)
        assert r["runs"][run]["step_losses"] == pytest.approx(one.step_losses, rel=TOL)
    name = f"tp-unified{hsize}_epoch1.pkl"
    got = load_pickle(tmp / "port" / "unified" / name)
    want = load_pickle(tmp / "one" / "unified" / name)
    lr = PortSearchCfg(**UNIFIED).NET_LR_BASE
    assert_trees_agree(got, want, 2 * 2 * lr / 4)
    for c in want["alpha"]:
        np.testing.assert_array_equal(got["alpha"][c], want["alpha"][c])
