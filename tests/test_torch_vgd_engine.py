"""The port's VGD paths end to end on the CPU, against the JAX package's
engines.

(a) Fixed-net training: from one JAX NetFull init of arch/mmnas_vgd.json
and its `optim.init` state, saved as an epoch-0 checkpoint, the JAX
package's VGD Execution (N_DEVICES 1) and the port's Execution(cfg, cpu)
each train one epoch (RUN train, RESUME, DROPOUT_R 0, the same synthetic
batches in the same order). Their epoch-1 checkpoints agree in params and
net_optim (1e-5), and each package's eval reads the other's checkpoint.
(b) The search: from one supernet init, alpha and both optimizers' states
(an epoch-0 checkpoint), each package runs one epoch of KPATH 1 weight
steps and 'full' arch steps; the JAX engine replays the paths the port
sampled (the parity harness of tests/test_torch_search_engine.py). The
epoch-1 checkpoints agree in params, optimizer states and alpha (1e-5), the
genotype archives have the same bytes, the argmax-path evals print the
same accuracy.
(c) In a fresh interpreter the port runs a CPU VGD eval, a train epoch and
a search epoch without loading jax or any module of the JAX package.
(d) The VGD CLIs refuse the CPU (with --MULTIHOST too, which
they take), take --MODEL_AXIS 2 over 4 cards and refuse it over 1 or 3."""

import contextlib
import io
import json
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
from mmnas_tpu.data.synth import SynthVgdDataset
from mmnas_tpu.engine.search_vgd import SearchExecution as JaxSearchExecution
from mmnas_tpu.engine.vgd import Execution as JaxExecution
from mmnas_tpu.genotype import load_genotype
from mmnas_tpu.models.net import NetFull as JaxNetFull
from mmnas_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mmnas_tpu.train.optimizer import build_net_optimizer as jax_build_net_optimizer
from mmnas_tpu.train.optimizer import plain_adam as jax_plain_adam
from mmnas_tpu_torch import search_vgd, train_vgd
from mmnas_tpu_torch.config import Cfg as PortCfg
from mmnas_tpu_torch.config import SearchCfg as PortSearchCfg
from mmnas_tpu_torch.engine.search_vgd import SearchExecution
from mmnas_tpu_torch.engine.vgd import Execution
from mmnas_tpu_torch.engine.vqa import batch_to_device
from mmnas_tpu_torch.models import net as NETM
from mmnas_tpu_torch.models.convert import to_jax_params
from mmnas_tpu_torch.models.net import INPUT_KEYS, VGD_KEYS
from mmnas_tpu_torch.models.supernet import NetSearch

from test_torch_search_engine import NOISY, assert_checkpoints_agree, eval_lines, run_jax_replaying
from _torch_threads import one_thread_env, one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARCH = str(ROOT / "arch" / "mmnas_vgd.json")
# the reference shapes (15 query tokens, a 14x14 text relation, 100
# regions) at a tiny width
SMALL = dict(TASK="vgd", SYNTH=True, HSIZE=64, ATTFLAT_OUT_SIZE=128, ATTFLAT_MLP_SIZE=32,
             REL_SIZE=8, FRCNFEAT_SIZE=32, WORD_EMBED_SIZE=12, DROPOUT_R=0.0, NUM_WORKERS=1)
TRAIN = dict(SMALL, SYNTH_SIZE=8, LAYERS=1, BATCH_SIZE=4, EVAL_BATCH_SIZE=4, SEED=11,
             VERSION="train_vgd", ARCH_PATH=ARCH)
SEARCH = dict(SMALL, SYNTH_SIZE=20, BATCH_SIZE=4, NODES=(("enc", 1), ("dec", 3)), ALPHA_START=0,
              ALPHA_EVERY=2, SEED=13, VERSION="parity-search-vgd", N_DEVICES=1)
# the parameters whose true gradient is 0, held to Adam's step size as the
# VQA tests hold the glimpse biases (tests/test_torch_search_engine.py):
# the text AttFlat's glimpse bias and, under SCORES_LOSS 'kld', proj_scores'
# bias, a shift of all 100 scores that the log_softmax cancels. Each package
# gets rounding noise there, which Adam's first steps turn into moves of up
# to lr either way (measured: proj_scores.b 4.3e-4 apart after the search's
# 4 steps).
INVARIANT = (("attflat_x", "mlp", "linear", "b"), ("proj_scores", "b"))
SEARCH_NOISY = NOISY + INVARIANT
# In the search also the entries of the text AttFlat's hidden bias whose true
# gradient on the first weight batch is below a few times Adam's eps (1e-9):
# a hidden unit that no token of that batch drives gets fp32 rounding noise
# there (5e-10), which Adam's g / (|g| + eps) turns into a step of a good
# share of lr either way (measured: 1.9e-5 apart after 4 steps). The true
# gradient is the port's in fp64 on that batch and path; the leaf's other
# entries and its Adam moments stay at 1e-5.
HIDDEN_BIAS = ("attflat_x", "mlp", "fc", "b")
DEAD_GRAD = 10 * 1e-9
# params and moments after one epoch (2 Adam steps): the same fp32 forward
# and backward in both packages, with sums in other orders
TRAIN_TOL = 1e-5
# ...except the INVARIANT leaves: 2 warmup steps of up to lr (0.00014 / 4)
# either way
INVARIANT_TOL = 2 * 2 * 0.00014 / 4


def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Epoch-1 checkpoints of both packages from one JAX epoch-0 checkpoint."""
    tmp = tmp_path_factory.mktemp("vgd")
    common = dict(TRAIN, RUN_MODE="train", RESUME=True, MAX_EPOCH=1, EVAL_EVERY_EPOCH=False,
                  NET_LR_BASE=0.00014, CKPT_FILE_PATH=str(tmp / "epoch0.pkl"),
                  LOG_ROOT=str(tmp / "log"))
    jcfg = Cfg(N_DEVICES=1, CKPT_ROOT=str(tmp / "jax"), **common)
    ds = SynthVgdDataset(jcfg, size=jcfg.SYNTH_SIZE, seed=jcfg.SEED)
    jnet = JaxNetFull(jcfg, load_genotype(ARCH), {"token_size": ds.token_size, "ans_size": 1,
                                                  "pretrained_emb": ds.pretrained_emb}, "vgd")
    params = jnet.init(jax.random.PRNGKey(4))
    jax_save_checkpoint(jcfg.CKPT_FILE_PATH, {
        "state_dict": params, "net_optim": jax_build_net_optimizer(jcfg, 2).init(params),
        "epoch": 0})
    _, _, jax_history = JaxExecution(jcfg).run()
    port = Execution(PortCfg(CKPT_ROOT=str(tmp / "port"), **common), torch.device("cpu")).run()
    return tmp, jax_history, port


def test_port_vgd_train_epoch_matches_jax(trained):
    tmp, jax_history, port = trained
    assert len(port.step_losses) == 2 and all(np.isfinite(port.step_losses))
    assert port.epoch_losses == pytest.approx(jax_history, rel=TRAIN_TOL)
    want = load_pickle(tmp / "jax" / "train_vgd_epoch1.pkl")
    got = load_pickle(tmp / "port" / "train_vgd_epoch1.pkl")
    assert got["epoch"] == want["epoch"] == 1 and int(got["net_optim"]["step"]) == 2
    for key in ("state_dict", "net_optim"):
        assert jax.tree_util.tree_structure(got[key]) == jax.tree_util.tree_structure(want[key])
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got[key]),
                                jax.tree_util.tree_leaves(want[key])):
            assert a.dtype == b.dtype
            names = tuple(getattr(k, "key", None) for k in path)
            invariant = key == "state_dict" and names in INVARIANT
            np.testing.assert_allclose(a, b, rtol=TRAIN_TOL,
                                       atol=INVARIANT_TOL if invariant else TRAIN_TOL,
                                       err_msg=jax.tree_util.keystr(path))
    # the box head moved: its gradient reached proj_reg through the SmoothL1 term
    before = load_pickle(tmp / "epoch0.pkl")["state_dict"]["proj_reg"]["w"]
    assert not np.allclose(got["state_dict"]["proj_reg"]["w"], before)


def test_each_package_evaluates_the_others_vgd_checkpoint(trained, capsys):
    tmp, _, _ = trained
    common = dict(TRAIN, RUN_MODE="val", LOG_ROOT=str(tmp / "log"), CKPT_ROOT=str(tmp / "eval"))
    jax_ck, port_ck = (str(tmp / pkg / "train_vgd_epoch1.pkl") for pkg in ("jax", "port"))
    port_of_jax = Execution(PortCfg(CKPT_FILE_PATH=jax_ck, **common), torch.device("cpu")).run()
    port_of_port = Execution(PortCfg(CKPT_FILE_PATH=port_ck, **common), torch.device("cpu")).run()
    capsys.readouterr()
    jax_of_port = JaxExecution(Cfg(N_DEVICES=1, CKPT_FILE_PATH=port_ck, **common)).run()
    assert port_of_jax.hits.shape == (TRAIN["SYNTH_SIZE"],)
    near = np.abs(port_of_jax.ious - 0.5) < 1e-6
    np.testing.assert_array_equal(port_of_jax.hits[~near], port_of_port.hits[~near])
    np.testing.assert_allclose(port_of_jax.ious, port_of_port.ious, atol=1e-4)
    assert jax_of_port == pytest.approx(port_of_port.accuracy)
    assert capsys.readouterr().out.count("accuracy = ") == 1


@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("search_vgd")
    mp = pytest.MonkeyPatch()

    def kw(pkg):
        return dict(SEARCH, CKPT_ROOT=str(tmp / pkg), ARCH_ROOT=str(tmp / pkg / "arch"),
                    LOG_ROOT=str(tmp / "log" / pkg), RESUME=True, MAX_EPOCH=1, KPATH=1,
                    ALPHA_BINARY_MODE="full", EVAL_EVERY_EPOCH=True,
                    CKPT_FILE_PATH=str(tmp / "epoch0.pkl"))

    jcfg = SearchCfg(**kw("jax"))
    ds = SynthVgdDataset(jcfg, size=jcfg.SYNTH_SIZE, seed=jcfg.SEED)
    init_dict = {"token_size": ds.token_size, "ans_size": 1, "pretrained_emb": ds.pretrained_emb}
    # a seeded port init in the JAX pytree (tests/test_torch_vgd.py holds the
    # supernet's VGD leaves to the JAX init's)
    net = NetSearch(PortSearchCfg(**dict(SEARCH, SEED=5)), init_dict, task="vgd")
    params = to_jax_params(net)
    r = np.random.RandomState(6)
    alpha = {c: a.numpy() + r.randn(*a.shape).astype(np.float32) * 0.5
             for c, a in net.init_alpha().items()}
    aoptim = jax_plain_adam(jcfg.ALPHA_LR_BASE, jcfg.ALPHA_OPT_BETAS, eps=1e-8)
    jax_save_checkpoint(jcfg.CKPT_FILE_PATH, {
        "state_dict": params, "net_optim": jax_build_net_optimizer(jcfg, 4).init(params),
        "alpha": alpha, "alpha_optim": aoptim.init(alpha), "epoch": 0})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port = SearchExecution(PortSearchCfg(**kw("port")), torch.device("cpu")).run()
    port_log = out.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_jax_replaying(jcfg, port.paths, mp, JaxSearchExecution)
    mp.undo()
    kind, step, idxs = port.paths[0]
    assert (kind, step) == ("weight", 0)
    grad = first_batch_grad_fp64(PortSearchCfg(**kw("port")), net, idxs[0],
                                 "attflat_x.mlp.fc.bias")
    return tmp, port, port_log, out.getvalue(), grad.abs().numpy() < DEAD_GRAD


def first_batch_grad_fp64(cfg, net, idx, name):
    """The gradient of `net`'s parameter `name` on the search's first weight
    batch and path `idx`, all in fp64 (`net` is cast in place)."""
    exe = SearchExecution(cfg, torch.device("cpu"))
    dataset = exe.build_dataset()
    loader = exe.make_loader(dataset, list(range(int(len(dataset) * cfg.SPLIT_PORTION))))
    loader.sampler.set_epoch(0)
    batch = batch_to_device(next(iter(loader)), torch.device("cpu"), INPUT_KEYS + VGD_KEYS)
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    net.double()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(NETM, "compute_dtype", lambda cfg: torch.float64)
        pred = net(batch, None, idx, mode="sampled", train=True, generator=torch.Generator())
    return torch.autograd.grad(exe.loss(pred, batch), dict(net.named_parameters())[name])[0]


def test_port_vgd_search_matches_jax(searched):
    tmp, port, port_log, jax_log, dead = searched
    assert [(kind, step) for kind, step, _ in port.paths] == [
        ("weight", 0), ("weight", 1), ("arch", 1), ("weight", 2), ("weight", 3), ("arch", 3)]
    assert len(port.step_losses) == 4 and all(np.isfinite(port.step_losses))
    name = "parity-search-vgd_epoch1.pkl"
    got, want = load_pickle(tmp / "port" / name), load_pickle(tmp / "jax" / name)
    assert_checkpoints_agree(got, want, SEARCH_NOISY, {HIDDEN_BIAS: dead})
    assert int(got["alpha_optim"]["step"]) == 2 and int(got["net_optim"]["step"]) == 4
    assert not np.allclose(got["alpha"]["dec"], load_pickle(tmp / "epoch0.pkl")["alpha"]["dec"])
    archive = (tmp / "port" / "arch" / "parity-search-vgd.json").read_bytes()
    assert archive == (tmp / "jax" / "arch" / "parity-search-vgd.json").read_bytes()
    assert [len(json.loads(archive)["epoch1"][c]) for c in ("enc", "dec")] == [1, 3]
    assert eval_lines(port_log) == eval_lines(jax_log) and len(eval_lines(port_log)) == 1


def test_port_cpu_vgd_paths_never_load_jax(tmp_path):
    script = textwrap.dedent(f"""
        import math
        import sys
        import torch
        from mmnas_tpu_torch.config import Cfg, SearchCfg
        from mmnas_tpu_torch.engine.search_vgd import SearchExecution
        from mmnas_tpu_torch.engine.vgd import Execution
        root = {str(tmp_path)!r}
        cfg = Cfg(**dict({TRAIN!r}, RUN_MODE="train", MAX_EPOCH=1, DROPOUT_R=0.1,
                         EVAL_EVERY_EPOCH=True, LOG_ROOT=root, CKPT_ROOT=root, VERSION="v"))
        train = Execution(cfg, torch.device("cpu")).run()
        assert len(train.step_losses) == 2 and all(map(math.isfinite, train.step_losses))
        result = Execution(cfg.replace(RUN_MODE="val", CKPT_FILE_PATH=root + "/v_epoch1.pkl"),
                           torch.device("cpu")).run()
        assert result.hits.shape == (8,), result.hits.shape
        scfg = SearchCfg(**dict({SEARCH!r}, MAX_EPOCH=1, DROPOUT_R=0.1, CKPT_ROOT=root,
                                ARCH_ROOT=root, LOG_ROOT=root))
        search = SearchExecution(scfg, torch.device("cpu")).run()
        assert len(search.step_losses) == 4 and all(map(math.isfinite, search.step_losses))
        assert [k for k, _, _ in search.paths].count("arch") == 2
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mmnas_tpu"))
        assert not loaded, loaded
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=one_thread_env(),
                          timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")


def test_vgd_clis_refuse_the_cpu_and_multihost(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in ("train", "val"):
        with pytest.raises(RuntimeError, match="CUDA"):
            train_vgd.main(["--RUN", run, "--SYNTH"])
    with pytest.raises(RuntimeError, match="CUDA"):
        search_vgd.main(["--SYNTH"])
    for main in (train_vgd.main, search_vgd.main):
        # --MULTIHOST (data parallel under torchrun) is taken: the CPU is not
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--SYNTH", "--MULTIHOST"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cli in (train_vgd, search_vgd):
        # tensor parallelism: taken where the model axis divides the cards,
        # refused with the JAX package's words where it does not
        launched = []
        monkeypatch.setattr(cli, "launch", lambda *a: launched.append(a))
        cli.main(["--SYNTH", "--NDEV", "4", "--MODEL_AXIS", "2"])
        assert launched[0][1][1].MODEL_AXIS == 2 and launched[0][2:] == ("0", 4, False)
        for bad in (["--MODEL_AXIS", "2"], ["--NDEV", "3", "--MODEL_AXIS", "2"]):
            with pytest.raises(ValueError, match="not divisible by model_axis 2"):
                cli.main(["--SYNTH"] + bad)
