"""The port's data parallelism (mmnas_tpu_torch/parallel/) on the CPU, over
gloo.

(a) The port's eval_dataset_order is the JAX package's, with
jax.process_count() monkeypatched to 2 and to 4.
(b) Under world 2 the two ranks' batch k, interleaved, is the JAX engine's
batch k at N_DEVICES=2 in one process: for the fixed-net loader and both
bilevel search loaders, over two epochs.
(c) One 2-process gloo run (tests/_torch_parallel_worker.py, started once
for the module; the worker has 300 s, the group's collectives 120 s), tiny
sizes, DROPOUT_R 0:
  - against the JAX engines at N_DEVICES=2, run here on conftest's virtual
    CPU devices from the same epoch-0 checkpoints and fed the global batches
    a 2-process JAX run assembles (shard_batch: rank 0's batch k, then rank
    1's; the port's KPATH slices batch[k::K] of each rank's batch, as that
    run does): the VQA train for two epochs (the port resumes from rank 0's
    epoch-1 checkpoint) and its eval, the VQA search at KPATH 1 'full' and
    at KPATH 2 'two' (the JAX engine replays rank 0's paths). Parameters,
    optimizer states and alpha agree to 1e-5 (the gradient-free leaves to
    Adam's step, as tests/test_torch_engine.py and
    tests/test_torch_search_engine.py hold them), the losses to 1e-5, the
    eval predictions are equal;
  - VGD and ITM against the port's single-process run, which the other
    files hold to the JAX package: the VGD eval hits, ITM's mined negatives
    and R@K are the same, and one VGD and one ITM train step's all-reduced
    gradient is the mean of the gradients of the two ranks' halves computed
    here in one process, to 1e-6 of the largest;
  - both ranks sample the same paths and end with the same alpha; rank 0
    alone writes the log; the all-reduces are one per bucket per step.
(d) The workers load no jax and no mmnas_tpu module.
(e) A rank that raises ends the group at once.
(f) The CLIs' configuration takes --MULTIHOST, --NDEV N and several --GPU
ids, refuses --MODEL_AXIS > 1 naming tensor parallelism; the launcher
refuses cards the machine has not, joins torchrun's group under
--MULTIHOST, and each CLI hands its engine and cards to it."""

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

import mmnas_tpu.parallel.mesh as jax_mesh
from mmnas_tpu.config import Cfg, SearchCfg
from mmnas_tpu.data.loader import Loader as JaxLoader
from mmnas_tpu.data.sampler import SubsetShardSampler as JaxSampler
from mmnas_tpu.data.synth import SynthVqaDataset
from mmnas_tpu.engine.search import SearchExecution as JaxSearchExecution
from mmnas_tpu.engine.vqa import Execution as JaxExecution
from mmnas_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mmnas_tpu.train.optimizer import build_net_optimizer as jax_build_net_optimizer
from mmnas_tpu.train.optimizer import plain_adam as jax_plain_adam
from mmnas_tpu_torch import search_itm, search_vgd, search_vqa, train_itm, train_vgd, train_vqa
from mmnas_tpu_torch.config import Cfg as PortCfg
from mmnas_tpu_torch.config import SearchCfg as PortSearchCfg
from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser
from mmnas_tpu_torch.data.loader import Loader
from mmnas_tpu_torch.data.sampler import SubsetShardSampler
from mmnas_tpu_torch.data.synth import SynthVqaDataset as PortSynthVqaDataset
from mmnas_tpu_torch.engine import itm as PI
from mmnas_tpu_torch.engine import vgd as PV
from mmnas_tpu_torch.engine.search import SearchExecution
from mmnas_tpu_torch.engine.vqa import Execution
from mmnas_tpu_torch.genotype import load_genotype
from mmnas_tpu_torch.models.convert import to_jax_params
from mmnas_tpu_torch.models.net import INPUT_KEYS, NetFull
from mmnas_tpu_torch.models.supernet import NetSearch
from mmnas_tpu_torch.parallel import mesh as pmesh
from mmnas_tpu_torch.train.checkpoint import save_checkpoint

from _torch_parallel_worker import GROUP_TIMEOUT_S, one_step_grads
from _torch_threads import one_thread_env, one_torch_thread  # noqa: F401  (autouse)
from test_torch_engine import GENE
from test_torch_engine import SMALL as VQA_SMALL
from test_torch_itm_engine import TRAIN as ITM_TRAIN
from test_torch_search_engine import SMALL as SEARCH_SMALL
from test_torch_search_engine import assert_checkpoints_agree, run_jax_replaying
from test_torch_vgd_engine import TRAIN as VGD_TRAIN

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_parallel_worker.py"
WORLD = 2
WORKER_TIMEOUT_S = 300
# 16 items: each epoch two global batches of 2 x 4, no pad; the eval's 3 a
# rank leave a pad item in each rank's last batch
VQA = dict(VQA_SMALL, SYNTH_SIZE=16, EVAL_BATCH_SIZE=3, VERSION="dp")
# 40 items: a weight split of 32 (4 steps of 2 x 4) and an arch split of 8
# (one global batch), so that every global batch is whole
SEARCH = dict(SEARCH_SMALL, SYNTH_SIZE=40, VERSION="dp-search")
# 10 items, eval batches of 3: a pad item in each rank's last batch
VGD = dict(VGD_TRAIN, SYNTH_SIZE=10, EVAL_BATCH_SIZE=3, VERSION="dp-vgd")
ITM = dict(ITM_TRAIN, VERSION="dp-itm")
# params and moments of the VQA train after its 4 Adam steps: the same fp32
# sums in other orders (tests/test_torch_engine.py)
TRAIN_TOL = 1e-5
# the AttFlat glimpse biases, whose true gradient is 0: Adam turns rounding
# noise into moves of up to lr either way, 2 steps at 3e-5 and 2 at 6e-5
INVARIANT_TOL = 2 * (2 * 0.00003 + 2 * 0.00006)
# the all-reduced gradient against the mean of the halves', of the largest
GRAD_TOL = 1e-6


def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


class RankMajorLoader:
    """A 2-process JAX run's global batches in one process: each rank's
    loader (rank-strided sampler, the per-process slice of the global
    batch) and each global batch rank 0's slice then rank 1's, as
    shard_batch assembles it (mmnas_tpu/parallel/mesh.py:51-64)."""

    class Samplers:
        def __init__(self, samplers):
            self.samplers = samplers
            self.subset_indices = samplers[0].subset_indices

        def set_epoch(self, epoch):
            for s in self.samplers:
                s.set_epoch(epoch)

        def set_shuffle(self, shuffle):
            for s in self.samplers:
                s.set_shuffle(shuffle)

    def __init__(self, dataset, per_rank, shuffle, subset_indices=None):
        self.loaders = [JaxLoader(dataset, per_rank, num_workers=1, sampler=JaxSampler(
            len(dataset), num_replicas=WORLD, rank=r, shuffle=shuffle,
            subset_indices=subset_indices)) for r in range(WORLD)]
        self.dataset, self.batch_size = dataset, per_rank * WORLD
        self.sampler = self.Samplers([ld.sampler for ld in self.loaders])

    def steps_per_epoch(self):
        return self.loaders[0].steps_per_epoch()

    def __len__(self):
        return self.steps_per_epoch()

    def __iter__(self):
        for parts in zip(*self.loaders):
            yield {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def rank_major_loader(self, dataset, shuffle, subset_indices=None, batch_size=None):
    return RankMajorLoader(dataset, batch_size or self.cfg.BATCH_SIZE, shuffle, subset_indices)


def vqa_init_dict(cfg):
    ds = PortSynthVqaDataset(cfg, size=cfg.SYNTH_SIZE, seed=cfg.SEED)
    return {"token_size": ds.token_size, "ans_size": ds.ans_size,
            "pretrained_emb": ds.pretrained_emb}


def write_starts(tmp, arch):
    """The epoch-0 checkpoints every run starts from: seeded port inits in
    the JAX package's pytree (compiling the JAX init would cost more than
    the runs), with the JAX package's optimizer states."""
    cfg = PortCfg(ARCH_PATH=arch, **VQA)
    params = to_jax_params(NetFull(cfg.replace(SEED=4), load_genotype(arch), vqa_init_dict(cfg)))
    jax_save_checkpoint(str(tmp / "vqa_epoch0.pkl"), {
        "state_dict": params, "net_optim": jax_build_net_optimizer(Cfg(**VQA), 2).init(params),
        "epoch": 0})

    scfg = PortSearchCfg(**SEARCH)
    net = NetSearch(scfg.replace(SEED=5), vqa_init_dict(scfg))
    params = to_jax_params(net)
    r = np.random.RandomState(6)
    alpha = {c: a.numpy() + r.randn(*a.shape).astype(np.float32) * 0.5
             for c, a in net.init_alpha().items()}
    jcfg = SearchCfg(**SEARCH)
    aoptim = jax_plain_adam(jcfg.ALPHA_LR_BASE, jcfg.ALPHA_OPT_BETAS, eps=1e-8)
    jax_save_checkpoint(str(tmp / "search_epoch0.pkl"), {
        "state_dict": params, "net_optim": jax_build_net_optimizer(jcfg, 4).init(params),
        "alpha": alpha, "alpha_optim": aoptim.init(alpha), "epoch": 0})

    for task, kw in (("vgd", VGD), ("itm", ITM)):
        exe = (PV if task == "vgd" else PI).Execution(PortCfg(**kw), torch.device("cpu"))
        net = exe.build_net(exe.build_dataset("train"))
        save_checkpoint(str(tmp / f"{task}.pkl"),
                        {"state_dict": to_jax_params(net), "net_optim": None, "epoch": 0})


def specs(tmp, arch):
    """The worker's configurations (keyword arguments of Cfg / SearchCfg)."""
    def dirs(name):
        return dict(CKPT_ROOT=str(tmp / "port" / name), LOG_ROOT=str(tmp / "port" / name / "log"))

    search = dict(SEARCH, RESUME=True, MAX_EPOCH=1, CKPT_FILE_PATH=str(tmp / "search_epoch0.pkl"))
    return {
        "out": str(tmp),
        "vqa_train": dict(VQA, RUN_MODE="train", RESUME=True, MAX_EPOCH=1, ARCH_PATH=arch,
                          EVAL_EVERY_EPOCH=False, CKPT_FILE_PATH=str(tmp / "vqa_epoch0.pkl"),
                          **dirs("vqa")),
        "search_k1": dict(search, KPATH=1, ALPHA_BINARY_MODE="full", EVAL_EVERY_EPOCH=True,
                          ARCH_ROOT=str(tmp / "port" / "search_k1" / "arch"),
                          **dirs("search_k1")),
        "search_k2": dict(search, KPATH=2, ALPHA_BINARY_MODE="two", EVAL_EVERY_EPOCH=False,
                          ARCH_ROOT=str(tmp / "port" / "search_k2" / "arch"),
                          **dirs("search_k2")),
        "vgd": dict(VGD, RUN_MODE="val", CKPT_FILE_PATH=str(tmp / "vgd.pkl"), **dirs("vgd")),
        "itm": dict(ITM, RUN_MODE="val", CKPT_FILE_PATH=str(tmp / "itm.pkl"), **dirs("itm")),
    }


def jax_train_and_eval(tmp, spec):
    """The JAX package's VQA train at N_DEVICES=2 for the two epochs, then
    its eval of its epoch-2 checkpoint (its own dataset-order loader); the
    predictions are read where its eval puts them in dataset order."""
    cfg = Cfg(**dict(spec, N_DEVICES=WORLD, MAX_EPOCH=2, CKPT_ROOT=str(tmp / "jax" / "vqa"),
                     LOG_ROOT=str(tmp / "jax" / "vqa" / "log")))
    exe = JaxExecution(cfg)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JaxExecution, "make_loader", rank_major_loader)
        _, _, history = exe.train(exe.make_loader(exe.build_dataset("train"), shuffle=True))
    preds = []
    order = jax_mesh.eval_dataset_order

    def recording(*args):
        preds.append(order(*args))
        return preds[-1]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_mesh, "eval_dataset_order", recording)
        JaxExecution(cfg.replace(RUN_MODE="val", CKPT_FILE_PATH=str(
            tmp / "jax" / "vqa" / "dp_epoch2.pkl"))).run()
    return history, preds[0]


def single_process(tmp, spec):
    """The port in this process, no group: the VGD eval's hits, ITM's
    mining of epoch 0 and its R@K, and the gradient of each rank's half of
    one VGD and one ITM train step."""
    cpu = torch.device("cpu")
    out = {}
    for task, mod in (("vgd", PV), ("itm", PI)):
        cfg = PortCfg(**dict(spec[task], CKPT_ROOT=str(tmp / "single" / task),
                             LOG_ROOT=str(tmp / "single" / task / "log")))
        exe = mod.Execution(cfg, cpu)
        ds = exe.build_dataset("train")
        if task == "vgd":
            out["vgd_hits"] = exe.run().hits
        else:
            exe.on_epoch_start(exe.load_masters(ds), ds, 0)
            out["itm_negatives"] = (ds.neg_caps_idx_tensor.copy(), ds.neg_imgs_idx_tensor.copy())
            recall = exe.eval(exe.make_loader(ds, cfg.EVAL_BATCH_SIZE), net=exe.load_masters(ds))
            out["itm_scores"], out["itm_stats"] = recall.scores, recall.stats
        out[f"{task}_halves"] = [one_step_grads(
            exe, exe.load_masters(ds), INPUT_KEYS + exe.TARGET_KEYS,
            Loader(ds, cfg.BATCH_SIZE, num_workers=1, sampler=SubsetShardSampler(
                len(ds), num_replicas=WORLD, rank=r, shuffle=True))) for r in range(WORLD)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    arch = str(tmp / "arch.json")
    Path(arch).write_text(json.dumps(GENE))
    write_starts(tmp, arch)
    spec = specs(tmp, arch)
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    t0 = time.time()
    with open(tmp / "worker.log", "w") as log:
        worker = subprocess.Popen([sys.executable, str(WORKER), str(tmp / "spec.pkl")],
                                  cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT,
                                  env=one_thread_env(), start_new_session=True)
        try:         # this process's runs while the workers run theirs
            jax_history, jax_preds = jax_train_and_eval(tmp, spec["vqa_train"])
            single = single_process(tmp, spec)
            worker.wait(timeout=WORKER_TIMEOUT_S - (time.time() - t0))
        finally:     # the spawned ranks too, should the worker be left running
            if worker.poll() is None:
                os.killpg(worker.pid, signal.SIGKILL)
                worker.wait()
    assert worker.returncode == 0, (tmp / "worker.log").read_text()[-3000:]
    ranks = [load_pickle(tmp / f"rank{r}.pkl") for r in range(WORLD)]

    # the JAX search legs replay the paths rank 0 sampled
    jax_logs = {}
    for leg in ("search_k1", "search_k2"):
        cfg = SearchCfg(**dict(spec[leg], N_DEVICES=WORLD, CKPT_ROOT=str(tmp / "jax" / leg),
                               ARCH_ROOT=str(tmp / "jax" / leg / "arch"),
                               LOG_ROOT=str(tmp / "jax" / leg / "log")))
        with pytest.MonkeyPatch.context() as m:
            m.setattr(JaxSearchExecution, "make_loader", rank_major_loader)
            run_jax_replaying(cfg, ranks[0][leg]["paths"], m)
        jax_logs[leg] = (tmp / "jax" / leg / "log" / f"log_{cfg.VERSION}.txt").read_text()
    return {"tmp": tmp, "ranks": ranks, "jax_history": jax_history, "jax_preds": jax_preds,
            "jax_logs": jax_logs, "single": single}


@pytest.mark.parametrize("world", [2, 4])
def test_eval_dataset_order_is_the_jax_packages(monkeypatch, world):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    bs, nb = 3, 4
    outs = np.random.RandomState(world).randn(nb * world * bs, 2)
    for n_items in (nb * world * bs, nb * world * bs - world - 1, 5):
        np.testing.assert_array_equal(pmesh.eval_dataset_order(outs, bs, n_items, world),
                                      jax_mesh.eval_dataset_order(outs, bs, n_items))


@pytest.mark.parametrize("engine", ["train", "search"])
def test_two_ranks_batches_interleave_into_the_jax_global_batch(monkeypatch, tmp_path, engine):
    """Batch k of rank r is rows r, r + 2, ... of the JAX engine's batch k
    (N_DEVICES=2, one process, the sampler's order)."""
    kw = dict(VQA if engine == "train" else SEARCH, LOG_ROOT=str(tmp_path))
    cls, port_cls = ((Cfg, PortCfg) if engine == "train" else (SearchCfg, PortSearchCfg))
    jcfg = cls(**dict(kw, N_DEVICES=WORLD))
    ds = SynthVqaDataset(jcfg, size=jcfg.SYNTH_SIZE, seed=jcfg.SEED)
    if engine == "train":
        jax_loaders = [JaxExecution(jcfg).make_loader(ds, shuffle=True)]
    else:
        jexe, split = JaxSearchExecution(jcfg), int(len(ds) * jcfg.SPLIT_PORTION)
        jax_loaders = [jexe.make_loader(ds, shuffle=True, subset_indices=idx)
                       for idx in (list(range(split)), list(range(split, len(ds))))]
    port_loaders = []
    for r in range(WORLD):
        monkeypatch.setattr(pmesh, "world_size", lambda: WORLD)
        monkeypatch.setattr(pmesh, "rank", lambda r=r: r)
        if engine == "train":
            port_loaders.append([Execution(port_cls(**kw), torch.device("cpu")).make_loader(
                ds, jcfg.BATCH_SIZE, shuffle=True)])
        else:
            exe = SearchExecution(port_cls(**kw), torch.device("cpu"))
            port_loaders.append([exe.make_loader(ds, list(range(split))),
                                 exe.make_loader(ds, list(range(split, len(ds))))])
    monkeypatch.undo()
    for i, jl in enumerate(jax_loaders):
        ranks = [pl[i] for pl in port_loaders]
        for epoch in (0, 1):
            for ld in [jl] + ranks:
                ld.sampler.set_epoch(epoch)
            n = 0
            for jb, *parts in zip(jl, *ranks):
                for key in jb:
                    both = np.stack([p[key] for p in parts], axis=1)
                    np.testing.assert_array_equal(both.reshape(jb[key].shape), jb[key])
                n += 1
            assert n == jl.steps_per_epoch() == ranks[0].steps_per_epoch() > 0


def test_vqa_train_with_resume_and_eval_match_jax_at_two_devices(runs):
    tmp, (r0, r1) = runs["tmp"], runs["ranks"]
    assert r0["vqa_train"]["steps_epoch1"] == 2
    for r in (r0, r1):      # every rank logs the global batches' losses
        assert r["vqa_train"]["epoch_losses"] == pytest.approx(runs["jax_history"], rel=1e-5)
    assert len(r0["vqa_train"]["step_losses"]) == 4
    got = load_pickle(tmp / "port" / "vqa" / "dp_epoch2.pkl")
    want = load_pickle(tmp / "jax" / "vqa" / "dp_epoch2.pkl")
    assert got["epoch"] == want["epoch"] == 2 and int(got["net_optim"]["step"]) == 4
    for key in ("state_dict", "net_optim"):
        assert jax.tree_util.tree_structure(got[key]) == jax.tree_util.tree_structure(want[key])
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got[key]),
                                jax.tree_util.tree_leaves(want[key])):
            names = [getattr(k, "key", None) for k in path]
            invariant = (key == "state_dict" and names[0] in ("attflat_x", "attflat_y")
                         and names[1:] == ["mlp", "linear", "b"])
            np.testing.assert_allclose(a, b, rtol=TRAIN_TOL,
                                       atol=INVARIANT_TOL if invariant else TRAIN_TOL,
                                       err_msg=jax.tree_util.keystr(path))
    # the eval of the epoch-2 checkpoints: every rank holds every prediction
    np.testing.assert_array_equal(r0["vqa_train"]["preds"], runs["jax_preds"])
    np.testing.assert_array_equal(r1["vqa_train"]["preds"], runs["jax_preds"])
    assert len(runs["jax_preds"]) == VQA["SYNTH_SIZE"]
    assert r0["vqa_train"]["accuracy"] is not None and r1["vqa_train"]["accuracy"] is None


@pytest.mark.parametrize("leg", ["search_k1", "search_k2"])
def test_vqa_search_matches_jax_at_two_devices(runs, leg):
    tmp, (r0, r1) = runs["tmp"], runs["ranks"]
    kinds = [kind for kind, _, _ in r0[leg]["paths"]]
    assert kinds == ["weight", "weight", "arch"] * 2
    # every rank sampled the same paths and ends with the same alpha
    assert pickle.dumps(r0[leg]["paths"]) == pickle.dumps(r1[leg]["paths"])
    for c in r0[leg]["alpha"]:
        np.testing.assert_array_equal(r0[leg]["alpha"][c], r1[leg]["alpha"][c])
    name = "dp-search_epoch1.pkl"
    got, want = load_pickle(tmp / "port" / leg / name), load_pickle(tmp / "jax" / leg / name)
    assert_checkpoints_agree(got, want)
    assert not np.allclose(got["alpha"]["dec"],
                           load_pickle(tmp / "search_epoch0.pkl")["alpha"]["dec"])
    log = (tmp / "port" / leg / "log" / "log_dp-search.txt").read_text()
    assert sum(line.startswith("epoch = 1") for line in log.splitlines()) == 1
    evals = [line for line in log.splitlines() if line.startswith("eval accuracy")]
    assert evals == [line for line in runs["jax_logs"][leg].splitlines()
                     if line.startswith("eval accuracy")]
    assert len(evals) == (leg == "search_k1")
    archive = json.loads((tmp / "port" / leg / "arch" / "dp-search.json").read_text())
    assert archive == json.loads((tmp / "jax" / leg / "arch" / "dp-search.json").read_text())


def test_one_all_reduce_per_bucket_and_step(runs):
    (r0, r1) = runs["ranks"]
    params = jax.tree_util.tree_leaves(load_pickle(runs["tmp"] / "vqa_epoch0.pkl")["state_dict"])
    n_buckets = len(pmesh.buckets([torch.from_numpy(np.asarray(p)) for p in params]))
    assert n_buckets == 1
    for r in (r0, r1):
        # 2 train steps; one loss sum and one broadcast of the parameters
        assert r["vqa_counts_epoch1"] == {"all_reduce": 2 * n_buckets, "broadcast": 1,
                                          "sum": 1, "gather": 0}
        for leg in ("search_k1", "search_k2"):
            counts = r[leg]["counts"]
            # 4 weight steps and 2 arch steps, one bucket each
            assert counts["all_reduce"] == 6 and counts["broadcast"] == 1
            assert counts["sum"] == 1
            # the eval's predictions and labels
            assert counts["gather"] == (2 if leg == "search_k1" else 0)


def test_vgd_hits_and_train_step_gradient_match_one_process(runs):
    (r0, r1), single = runs["ranks"], runs["single"]
    assert len(single["vgd_hits"]) == VGD["SYNTH_SIZE"]
    for r in (r0, r1):
        np.testing.assert_array_equal(r["vgd_hits"], single["vgd_hits"])
    assert_mean_of_halves(r0["vgd_grads"], r1["vgd_grads"], single["vgd_halves"])


def test_itm_mining_recall_and_train_step_gradient_match_one_process(runs):
    (r0, r1), single = runs["ranks"], runs["single"]
    for r in (r0, r1):
        for got, want in zip(r["itm_negatives"], single["itm_negatives"]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(r["itm_scores"], single["itm_scores"], rtol=1e-5, atol=1e-5)
        assert r["itm_stats"] == single["itm_stats"]
    assert r0["itm_scores"].shape == (4, 20)
    assert_mean_of_halves(r0["itm_grads"], r1["itm_grads"], single["itm_halves"])


def assert_mean_of_halves(got0, got1, halves):
    """Both ranks hold the same all-reduced gradient, the mean of the two
    halves' gradients to GRAD_TOL of the largest entry."""
    largest = max(float(np.abs(g).max()) for g in got0)
    assert largest > 0 and len(got0) == len(halves[0])
    for a, b, h0, h1 in zip(got0, got1, *halves):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, (h0 + h1) / 2, rtol=0, atol=GRAD_TOL * largest)
    # the halves differ: each rank computed on its own examples
    assert any(not np.allclose(h0, h1) for h0, h1 in zip(*halves))


def test_workers_load_no_jax(runs):
    for r in runs["ranks"]:
        assert r["loaded"] == []


def test_a_rank_that_raises_ends_the_group():
    t0 = time.time()
    proc = subprocess.run([sys.executable, str(WORKER), "--fail"], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=WORKER_TIMEOUT_S,
                          env=one_thread_env())
    # the spawn reports the first rank to fail: rank 1's error, or rank 0's
    # barrier broken by rank 1's exit (gloo: "... caused by a remote worker
    # ..."); rank 0 did not wait out the group's timeout
    assert proc.returncode != 0 and "ProcessRaisedException" in proc.stderr
    assert "rank 1 fails" in proc.stderr or "remote worker" in proc.stderr
    assert time.time() - t0 < GROUP_TIMEOUT_S


def parse(task, argv, search=False):
    return cfg_from_args(task, make_arg_parser(task, search=search).parse_args(
        ["--SYNTH", "--SEED", "1"] + argv), search=search)


def test_cli_config_takes_data_parallel_flags_and_refuses_tensor_parallel():
    for argv in (["--MULTIHOST"], ["--NDEV", "2"], ["--GPU", "0,1"], ["--GPU", "0,1", "--NDEV", "2"]):
        parse("vqa", argv)
    assert parse("vqa", ["--NDEV", "4"]).N_DEVICES == 4
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        parse("vqa", ["--MODEL_AXIS", "2", "--NDEV", "2"])
    with pytest.raises(ValueError, match="different worlds"):
        parse("vqa", ["--GPU", "0,1", "--NDEV", "3"])
    with pytest.raises(ValueError, match="torchrun"):
        parse("vqa", ["--MULTIHOST", "--NDEV", "2"])
    assert pmesh.card_ids("0,1", 0) == [0, 1] and pmesh.card_ids("2", 0) == [2]
    assert pmesh.card_ids("0", 3) == [0, 1, 2] and pmesh.card_ids("1", 1) == [1]


def test_launcher_places_processes_on_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.launch(lambda dev, x: (dev, x), ("a",), "1", 0) == (torch.device("cuda", 1), "a")
    for gpu, ndev in (("0,2", 0), ("0", 3), ("0,0", 0)):
        with pytest.raises(ValueError, match="one process per card"):
            pmesh.launch(lambda dev: dev, (), gpu, ndev)
    spawned = []
    monkeypatch.setattr(pmesh, "spawn", lambda fn, args, devices: spawned.append(devices))
    assert pmesh.launch(lambda dev: dev, (), "0,1", 0) is None
    assert spawned == [[torch.device("cuda", 0), torch.device("cuda", 1)]]
    # --MULTIHOST: torchrun's environment names the rank, the world and the card
    joined = []
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(pmesh, "init", lambda *a: joined.append(a))
    monkeypatch.setattr(pmesh, "shutdown", lambda: joined.append("left"))
    assert pmesh.launch(lambda dev: dev, (), "0", 0, multihost=True) == torch.device("cuda", 1)
    assert joined == [(3, 4, torch.device("cuda", 1)), "left"]


CLIS = [(train_vqa, Execution, False), (search_vqa, SearchExecution, True),
        (train_vgd, PV.Execution, False), (search_vgd, None, True),
        (train_itm, PI.Execution, False), (search_itm, None, True)]


@pytest.mark.parametrize("cli,engine,search", CLIS,
                         ids=["train_vqa", "search_vqa", "train_vgd", "search_vgd", "train_itm",
                              "search_itm"])
def test_each_cli_launches_its_engine_on_its_cards(monkeypatch, cli, engine, search):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    launched = []
    monkeypatch.setattr(cli, "launch", lambda *a: launched.append(a))
    cli.main(["--SYNTH", "--GPU", "0,1"])
    cli.main(["--SYNTH", "--MULTIHOST"])
    (fn, (exe, cfg), gpu, ndev, multihost), second = launched
    assert fn is pmesh.run_engine and (gpu, ndev, multihost) == ("0,1", 0, False)
    assert exe is (engine or cli.SearchExecution) and isinstance(cfg, (PortSearchCfg if search
                                                                      else PortCfg))
    assert second[2:] == ("0", 0, True)
