"""The port's ITM paths end to end on the CPU, against the JAX package's
engines.

(a) Fixed-net training with mining: from one JAX NetFull init of
arch/mmnas_itm.json and its `optim.init` state, saved as an epoch-0
checkpoint, the JAX package's ITM Execution (N_DEVICES 1) and the port's
Execution(cfg, cpu) each train two epochs (RESUME, DROPOUT_R 0, mining
before each epoch, the same synthetic batches in the same order). The
negatives each epoch mined are equal, the epoch losses agree (1e-5), and so
do the epoch-2 checkpoints in params and net_optim.
(b) The eval: the port's score matrix of the JAX checkpoint against the JAX
package's sweep of it (2e-4) with equal R@K, and the JAX eval of the port's
checkpoint gives the port eval's R@K.
(c) The port's mining and eval in caption blocks of 7 (TEXT_ENC_BLOCK) and
tiles of 16 pairs (EVAL_PAIRS) give what the whole-table sweeps give.
(d) The search: from one supernet init, alpha and both optimizers' states
(an epoch-0 checkpoint), each package runs one epoch of mining, KPATH 1
weight steps and 'full' arch steps, and its argmax-path R@K eval; the JAX
engine replays the paths the port sampled, the mining path included
(tests/test_torch_search_engine.py). The mined negatives are equal, the
epoch-1 checkpoints agree in params, optimizer states and alpha (1e-5), the
R@K lines are the same.
(e) In a fresh interpreter the port runs a CPU ITM train epoch, an eval and
a search epoch without loading jax or any module of the JAX package.
(f) The ITM CLIs refuse the CPU (with --MULTIHOST too, which
they take) and --MODEL_AXIS > 1."""

import contextlib
import copy
import io
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from mmnas_tpu.config import Cfg, SearchCfg
from mmnas_tpu.data.synth import SynthItmDataset
from mmnas_tpu.engine import itm as JI
from mmnas_tpu.engine.search_itm import SearchExecution as JaxSearchExecution
from mmnas_tpu.genotype import load_genotype
from mmnas_tpu.models.net import NetFull as JaxNetFull
from mmnas_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from mmnas_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mmnas_tpu.train.optimizer import build_net_optimizer as jax_build_net_optimizer
from mmnas_tpu.train.optimizer import plain_adam as jax_plain_adam
from mmnas_tpu_torch import search_itm, train_itm
from mmnas_tpu_torch.config import Cfg as PortCfg
from mmnas_tpu_torch.config import SearchCfg as PortSearchCfg
from mmnas_tpu_torch.data.synth import SynthItmDataset as PortSynthItmDataset
from mmnas_tpu_torch.engine import itm as PI
from mmnas_tpu_torch.engine.search_itm import SearchExecution
from mmnas_tpu_torch.models import net as NETM
from mmnas_tpu_torch.models.convert import to_jax_params
from mmnas_tpu_torch.models.supernet import NetSearch

from test_torch_search_engine import NOISY, assert_checkpoints_agree, run_jax_replaying
from _torch_threads import one_thread_env, one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARCH = str(ROOT / "arch" / "mmnas_itm.json")
# tests/test_itm.py's tiny_cfg sizes, with 12 regions so that some images
# have pad regions
SMALL = dict(TASK="itm", SYNTH=True, HSIZE=64, ATTFLAT_OUT_SIZE=128, ATTFLAT_MLP_SIZE=32,
             REL_SIZE=16, FRCNFEAT_LEN=12, FRCNFEAT_SIZE=16, WORD_EMBED_SIZE=12, MAX_TOKEN=10,
             SCORES_LOSS="bce", NEG_RANDSIZE=6, NEG_HARDSIZE=2, NEG_BATCHSIZE=4, DROPOUT_R=0.0,
             NUM_WORKERS=1)
TRAIN = dict(SMALL, SYNTH_SIZE=20, BATCH_SIZE=4, EVAL_BATCH_SIZE=4, SEED=11, VERSION="train_itm",
             ARCH_PATH=ARCH)
SEARCH = dict(SMALL, SYNTH_SIZE=20, BATCH_SIZE=4, NODES=(("enc", 1), ("dec", 3)), ALPHA_START=0,
              ALPHA_EVERY=2, SEED=13, VERSION="parity-search-itm", N_DEVICES=1)
# params and moments after two epochs (10 Adam steps): the same fp32 forwards
# and backward in both packages, with sums in other orders
TRAIN_TOL = 1e-5
# ...except the AttFlat glimpse biases, whose true gradient is 0: each
# package gets rounding noise there, which Adam turns into moves of up to lr
# either way (tests/test_torch_search_engine.py): 10 warmup steps of up to
# lr (1e-4 / 4 ... 3 / 4 of it)
INVARIANT = (("attflat_x", "mlp", "linear", "b"), ("attflat_y", "mlp", "linear", "b"))
INVARIANT_TOL = 10 * 1e-4
# The same holds for the entries of an AttFlat's hidden bias whose unit is
# active at every position: it shifts all of the glimpse's logits alike,
# which the softmax cancels, so its true gradient is 0 (measured: 1e-18 in
# fp64) and Adam turns the fp32 rounding noise into moves of up to lr either
# way (measured: 4.2e-5 apart after the 10 steps). Those entries are found
# from the port's fp64 gradient of the first step and held to
# INVARIANT_TOL (in the search, to its Adam-step bound); the leaf's other
# entries and its Adam moments stay at TRAIN_TOL.
HIDDEN_BIAS = {("attflat_x", "mlp", "fc", "b"): "attflat_x.mlp.fc.bias",
               ("attflat_y", "mlp", "fc", "b"): "attflat_y.mlp.fc.bias"}
DEAD_GRAD = 10 * 1e-9
SCORE_TOL = 2e-4        # the nets' tolerance (tests/test_torch_net.py)


def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def recording(monkeypatch, cls, name, mined):
    """Wrap cls.<name> (a mining call whose dataset is the argument
    `dataset`) to append copies of the negatives it leaves."""
    orig = getattr(cls, name)

    def wrapped(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        ds = kwargs.get("dataset") or next(a for a in args if hasattr(a, "neg_caps_idx_tensor"))
        mined.append((ds.neg_caps_idx_tensor.copy(), ds.neg_imgs_idx_tensor.copy()))
        return out

    monkeypatch.setattr(cls, name, wrapped)


def dead_entries(exe, net, batch, *path):
    """Per HIDDEN_BIAS leaf, its entries whose gradient on one step's
    `batch` (of the supernet's path `path`: None, idx) is below DEAD_GRAD,
    all in fp64, DROPOUT_R 0 (a copy of `net` is cast)."""
    net = copy.deepcopy(net).double()
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    kw = {"mode": "sampled"} if path else {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(NETM, "compute_dtype", lambda cfg: torch.float64)
        loss = exe.forward_loss(
            lambda b: net(b, *path, train=True, generator=torch.Generator(), **kw), batch)
    params = dict(net.named_parameters())
    grads = torch.autograd.grad(loss, [params[n] for n in HIDDEN_BIAS.values()])
    return {leaf: g.abs().numpy() < DEAD_GRAD for leaf, g in zip(HIDDEN_BIAS, grads)}


def assert_same_negatives(got, want, n):
    assert len(got) == len(want) == n
    for (gc, gi), (wc, wi) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gi, wi)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Epoch-2 checkpoints of both packages from one JAX epoch-0 checkpoint,
    and the negatives each mined."""
    tmp = tmp_path_factory.mktemp("itm")
    common = dict(TRAIN, RUN_MODE="train", RESUME=True, MAX_EPOCH=2, EVAL_EVERY_EPOCH=False,
                  CKPT_FILE_PATH=str(tmp / "epoch0.pkl"), LOG_ROOT=str(tmp / "log"))
    jcfg = Cfg(N_DEVICES=1, CKPT_ROOT=str(tmp / "jax"), **common)
    jds = SynthItmDataset(jcfg, size=jcfg.SYNTH_SIZE, seed=jcfg.SEED)
    jnet = JaxNetFull(jcfg, load_genotype(ARCH), {"token_size": jds.token_size, "ans_size": 1,
                                                  "pretrained_emb": jds.pretrained_emb}, "itm")
    params = jnet.init(jax.random.PRNGKey(4))
    jax_save_checkpoint(jcfg.CKPT_FILE_PATH, {
        "state_dict": params, "net_optim": jax_build_net_optimizer(jcfg, 5).init(params),
        "epoch": 0})
    mined = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        recording(mp, JI.Execution, "mine_hard_negatives", mined["jax"])
        recording(mp, PI.Execution, "mine_hard_negatives", mined["port"])
        jex = JI.Execution(jcfg)
        _, _, jax_history = jex.train(jex.make_loader(jds, shuffle=True))
        pcfg = PortCfg(CKPT_ROOT=str(tmp / "port"), **common)
        pex = PI.Execution(pcfg, torch.device("cpu"))
        dead = {}

        def train_step(net, optim, state, params, batch, generator):
            if not dead:
                dead.update(dead_entries(pex, net, batch))
            return PI.Execution.train_step(pex, net, optim, state, params, batch, generator)

        pex.train_step = train_step
        pds = PortSynthItmDataset(pcfg, size=pcfg.SYNTH_SIZE, seed=pcfg.SEED)
        port = pex.train(pex.make_loader(pds, pcfg.BATCH_SIZE, shuffle=True))
    return tmp, jax_history, port, mined, dead


def test_port_itm_train_epochs_with_mining_match_jax(trained):
    tmp, jax_history, port, mined, dead = trained
    assert_same_negatives(mined["port"], mined["jax"], 2)
    # the second epoch mined with the trained net and its own RNG stream
    assert not all(np.array_equal(a, b) for a, b in zip(mined["port"][0], mined["port"][1]))
    assert len(port.step_losses) == 10 and all(np.isfinite(port.step_losses))
    assert port.epoch_losses == pytest.approx(jax_history, rel=TRAIN_TOL)
    want = load_pickle(tmp / "jax" / "train_itm_epoch2.pkl")
    got = load_pickle(tmp / "port" / "train_itm_epoch2.pkl")
    assert got["epoch"] == want["epoch"] == 2 and int(got["net_optim"]["step"]) == 10
    for key in ("state_dict", "net_optim"):
        assert jax.tree_util.tree_structure(got[key]) == jax.tree_util.tree_structure(want[key])
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got[key]),
                                jax.tree_util.tree_leaves(want[key])):
            assert a.dtype == b.dtype
            names = tuple(getattr(k, "key", None) for k in path)
            invariant = key == "state_dict" and names in INVARIANT
            if key == "state_dict" and names in HIDDEN_BIAS:
                entries = dead[names]
                np.testing.assert_allclose(a[entries], b[entries], rtol=TRAIN_TOL,
                                           atol=INVARIANT_TOL, err_msg=jax.tree_util.keystr(path))
                a, b = a[~entries], b[~entries]
            np.testing.assert_allclose(a, b, rtol=TRAIN_TOL,
                                       atol=INVARIANT_TOL if invariant else TRAIN_TOL,
                                       err_msg=jax.tree_util.keystr(path))
    before = load_pickle(tmp / "epoch0.pkl")["state_dict"]["proj"]["w"]
    assert not np.allclose(got["state_dict"]["proj"]["w"], before)


def jax_score_matrix(cfg, ckpt):
    """The JAX package's score matrix of the synthetic val corpus under the
    checkpoint's params (its eval's sweep, engine/itm.py:707-717)."""
    jex = JI.Execution(cfg)
    ds = SynthItmDataset(cfg, size=cfg.SYNTH_SIZE, seed=cfg.SEED, run_mode="val")
    net = jex.build_net(ds)
    params = jax_load_checkpoint(ckpt)["state_dict"]
    scorer, corpus = jex.make_pair_scorer(net), jex.device_corpus(ds)
    n_caps = len(ds)
    return JI.score_matrix_sweep(
        n_caps // 5, n_caps, 0, cfg.EVAL_BATCH_SIZE * 2,
        lambda s, c: jex.encode_text_window(net, params, corpus, s, c),
        lambda te, ii, cc: JI.sharded_pair_call_async(
            jex.mesh, jex.n_shards, lambda a, b: scorer(params, corpus, te, a, b), ii, cc))


def test_each_package_evaluates_the_others_itm_checkpoint(trained, capsys):
    tmp = trained[0]
    common = dict(TRAIN, RUN_MODE="val", LOG_ROOT=str(tmp / "log"), CKPT_ROOT=str(tmp / "eval"))
    jax_ck, port_ck = (str(tmp / pkg / "train_itm_epoch2.pkl") for pkg in ("jax", "port"))
    port_of_jax = PI.Execution(PortCfg(CKPT_FILE_PATH=jax_ck, **common), torch.device("cpu")).run()
    port_of_port = PI.Execution(PortCfg(CKPT_FILE_PATH=port_ck, **common),
                                torch.device("cpu")).run()
    jcfg = Cfg(N_DEVICES=1, CKPT_FILE_PATH=port_ck, **common)
    jax_of_port = JI.Execution(jcfg).run()
    want = jax_score_matrix(jcfg, jax_ck)
    capsys.readouterr()
    assert port_of_jax.scores.shape == (4, 20)
    np.testing.assert_allclose(port_of_jax.scores, want, rtol=SCORE_TOL, atol=SCORE_TOL)
    assert port_of_jax.stats == JI.recall_metrics(want)
    assert jax_of_port == port_of_port.stats


def test_blocked_mining_and_eval_match_the_whole_table(trained, tmp_path):
    """TEXT_ENC_BLOCK 7 (which does not divide 20 captions) and EVAL_PAIRS
    16: the same negatives and the same score matrix as the whole-table
    sweeps, bit for bit (one RNG stream, the same scorer)."""
    tmp = trained[0]
    cfg = PortCfg(**dict(TRAIN, RUN_MODE="val", LOG_ROOT=str(tmp_path), CKPT_ROOT=str(tmp_path),
                         CKPT_FILE_PATH=str(tmp / "port" / "train_itm_epoch2.pkl")))
    out = []
    for kw in ({}, {"TEXT_ENC_BLOCK": 7, "EVAL_PAIRS": 16}):
        exe = PI.Execution(cfg.replace(**kw), torch.device("cpu"))
        ds = PortSynthItmDataset(cfg, size=cfg.SYNTH_SIZE, seed=cfg.SEED)
        net = exe.load_net(ds)
        exe.mine_hard_negatives(net, ds, epoch=3)
        result = exe.eval(exe.make_loader(ds, 4), net=net)
        out.append((ds.neg_caps_idx_tensor, ds.neg_imgs_idx_tensor, result.scores))
    for got, want in zip(out[1], out[0]):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("search_itm")

    def kw(pkg):
        return dict(SEARCH, CKPT_ROOT=str(tmp / pkg), ARCH_ROOT=str(tmp / pkg / "arch"),
                    LOG_ROOT=str(tmp / "log" / pkg), RESUME=True, MAX_EPOCH=1, KPATH=1,
                    ALPHA_BINARY_MODE="full", EVAL_EVERY_EPOCH=True,
                    CKPT_FILE_PATH=str(tmp / "epoch0.pkl"))

    jcfg = SearchCfg(**kw("jax"))
    ds = SynthItmDataset(jcfg, size=jcfg.SYNTH_SIZE, seed=jcfg.SEED)
    init_dict = {"token_size": ds.token_size, "ans_size": 1, "pretrained_emb": ds.pretrained_emb}
    # a seeded port init in the JAX pytree (tests/test_torch_itm.py holds the
    # supernet's ITM leaves to the JAX init's)
    net = NetSearch(PortSearchCfg(**dict(SEARCH, SEED=5)), init_dict, task="itm")
    params = to_jax_params(net)
    r = np.random.RandomState(6)
    alpha = {c: a.numpy() + r.randn(*a.shape).astype(np.float32) * 0.5
             for c, a in net.init_alpha().items()}
    aoptim = jax_plain_adam(jcfg.ALPHA_LR_BASE, jcfg.ALPHA_OPT_BETAS, eps=1e-8)
    jax_save_checkpoint(jcfg.CKPT_FILE_PATH, {
        "state_dict": params, "net_optim": jax_build_net_optimizer(jcfg, 4).init(params),
        "alpha": alpha, "alpha_optim": aoptim.init(alpha), "epoch": 0})
    mined = {"jax": [], "port": []}
    logs = {}
    with pytest.MonkeyPatch.context() as mp:
        recording(mp, JaxSearchExecution, "on_epoch_start", mined["jax"])
        recording(mp, SearchExecution, "on_epoch_start", mined["port"])
        pex = SearchExecution(PortSearchCfg(**kw("port")), torch.device("cpu"))
        dead = {}

        def weight_step(net, optim, state, masters, batch, idxs, generator):
            if not dead:
                dead.update(dead_entries(pex, net, batch, None, idxs[0]))
            return SearchExecution.weight_step(pex, net, optim, state, masters, batch, idxs,
                                               generator)

        pex.weight_step = weight_step
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            port = pex.run()
        logs["port"] = out.getvalue()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run_jax_replaying(jcfg, port.paths, mp, JaxSearchExecution)
        logs["jax"] = out.getvalue()
    return tmp, port, logs, mined, dead


def recall_lines(log):
    return [line for line in log.splitlines() if line.startswith("search i2t")
            or line.startswith("search t2i")]


def test_port_itm_search_matches_jax(searched):
    tmp, port, logs, mined, dead = searched
    assert [(kind, step) for kind, step, _ in port.paths] == [
        ("mine", 0), ("weight", 0), ("weight", 1), ("arch", 1), ("weight", 2), ("weight", 3),
        ("arch", 3)]
    assert_same_negatives(mined["port"], mined["jax"], 1)
    assert len(port.step_losses) == 4 and all(np.isfinite(port.step_losses))
    name = "parity-search-itm_epoch1.pkl"
    got, want = load_pickle(tmp / "port" / name), load_pickle(tmp / "jax" / name)
    assert_checkpoints_agree(got, want, NOISY, dead)
    assert int(got["alpha_optim"]["step"]) == 2 and int(got["net_optim"]["step"]) == 4
    assert not np.allclose(got["alpha"]["dec"], load_pickle(tmp / "epoch0.pkl")["alpha"]["dec"])
    assert recall_lines(logs["port"]) == recall_lines(logs["jax"])
    assert len(recall_lines(logs["port"])) == 2
    archive = (tmp / "port" / "arch" / "parity-search-itm.json").read_bytes()
    assert archive == (tmp / "jax" / "arch" / "parity-search-itm.json").read_bytes()


def test_port_cpu_itm_paths_never_load_jax(tmp_path):
    script = textwrap.dedent(f"""
        import math
        import sys
        import torch
        from mmnas_tpu_torch.config import Cfg, SearchCfg
        from mmnas_tpu_torch.engine.itm import Execution
        from mmnas_tpu_torch.engine.search_itm import SearchExecution
        root = {str(tmp_path)!r}
        cfg = Cfg(**dict({TRAIN!r}, RUN_MODE="train", MAX_EPOCH=1, DROPOUT_R=0.1,
                         EVAL_EVERY_EPOCH=True, LOG_ROOT=root, CKPT_ROOT=root, VERSION="v"))
        train = Execution(cfg, torch.device("cpu")).run()
        assert len(train.step_losses) == 5 and all(map(math.isfinite, train.step_losses))
        result = Execution(cfg.replace(RUN_MODE="val", CKPT_FILE_PATH=root + "/v_epoch1.pkl"),
                           torch.device("cpu")).run()
        assert result.scores.shape == (4, 20), result.scores.shape
        scfg = SearchCfg(**dict({SEARCH!r}, MAX_EPOCH=1, DROPOUT_R=0.1, CKPT_ROOT=root,
                                ARCH_ROOT=root, LOG_ROOT=root))
        search = SearchExecution(scfg, torch.device("cpu")).run()
        assert len(search.step_losses) == 4 and all(map(math.isfinite, search.step_losses))
        assert [k for k, _, _ in search.paths] == ["mine"] + ["weight", "weight", "arch"] * 2
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mmnas_tpu"))
        assert not loaded, loaded
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=one_thread_env(),
                          timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")


def test_itm_clis_refuse_the_cpu_and_multihost(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in ("train", "val"):
        with pytest.raises(RuntimeError, match="CUDA"):
            train_itm.main(["--RUN", run, "--SYNTH"])
    with pytest.raises(RuntimeError, match="CUDA"):
        search_itm.main(["--SYNTH"])
    for main in (train_itm.main, search_itm.main):
        # --MULTIHOST (data parallel under torchrun) is taken: the CPU is not
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--SYNTH", "--MULTIHOST"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for main in (train_itm.main, search_itm.main):
        with pytest.raises(NotImplementedError, match="tensor parallelism"):
            main(["--SYNTH", "--MODEL_AXIS", "2"])
