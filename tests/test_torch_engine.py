"""The PyTorch port's eval and train paths end to end on the CPU.

(a) A JAX NetFull init, saved by the JAX package's save_checkpoint, is
evaluated by the port's Execution(cfg, cpu).run() (RUN val, SYNTH): its
predictions equal the argmax of the JAX net.apply on the same batches.
(b) In a fresh interpreter the port runs its CPU eval and one CPU train
epoch (with dropout) without ever loading jax or any module of the JAX
package (the GPU machine has no JAX).
(c) The slice as a whole: from one JAX init and `optim.init` state, saved
as an epoch-0 checkpoint, the JAX package's Execution (N_DEVICES 1) and
the port's Execution(cfg, cpu) each train one epoch (RUN train, RESUME,
DROPOUT_R 0, the same synthetic batches in the same order). Their epoch-1
checkpoints agree in params and in net_optim, and each package's eval
reads the other's checkpoint."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmnas_tpu.config import Cfg
from mmnas_tpu.data.loader import _stack
from mmnas_tpu.data.synth import SynthVqaDataset
from mmnas_tpu.genotype import load_genotype
from mmnas_tpu.engine.vqa import Execution as JaxExecution
from mmnas_tpu.models.net import NetFull as JaxNetFull
from mmnas_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mmnas_tpu.train.optimizer import build_net_optimizer as jax_build_net_optimizer
from mmnas_tpu_torch.config import Cfg as PortCfg
from mmnas_tpu_torch.engine.vqa import Execution
from mmnas_tpu_torch import train_vqa

from _torch_threads import one_thread_env, one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(TASK="vqa", SYNTH=True, SYNTH_SIZE=6, HSIZE=64, ATTFLAT_OUT_SIZE=128,
             ATTFLAT_MLP_SIZE=32, REL_SIZE=8, FRCNFEAT_LEN=8, FRCNFEAT_SIZE=16,
             WORD_EMBED_SIZE=12, MAX_TOKEN=6, DROPOUT_R=0.0, BATCH_SIZE=4,
             EVAL_BATCH_SIZE=4, NUM_WORKERS=1, SEED=11)
# every ported op once; arch/mmnas_vqa.json itself runs on the card (chip_smoke.py)
GENE = {"epoch0": {"enc": [["self_att_64"], ["feed_forward"]],
                   "dec": [["rel_self_att_64"], ["guided_att_64"], ["self_att_64", "none"],
                           ["feed_forward"]]}}


@pytest.fixture
def arch_path(tmp_path):
    path = tmp_path / "arch.json"
    path.write_text(json.dumps(GENE))
    return str(path)


def test_port_eval_of_jax_checkpoint_matches_jax_argmax(tmp_path, arch_path):
    cfg = Cfg(RUN_MODE="val", LOG_ROOT=str(tmp_path / "log"), CKPT_ROOT=str(tmp_path / "ck"),
              CKPT_FILE_PATH=str(tmp_path / "jax.pkl"), ARCH_PATH=arch_path, **SMALL)
    ds = SynthVqaDataset(cfg, size=cfg.SYNTH_SIZE, seed=cfg.SEED)
    init_dict = {"token_size": ds.token_size, "ans_size": ds.ans_size,
                 "pretrained_emb": ds.pretrained_emb}
    jnet = JaxNetFull(cfg, load_genotype(cfg.ARCH_PATH), init_dict, "vqa")
    params = jnet.init(jax.random.PRNGKey(2))
    jax_save_checkpoint(cfg.CKPT_FILE_PATH, {"state_dict": params, "net_optim": {}, "epoch": 1})
    apply = jax.jit(jnet.apply)
    want = []
    for s in range(0, len(ds), 4):
        batch = _stack([ds[i % len(ds)] for i in range(s, s + 4)])
        logits = apply(params, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append(np.asarray(jnp.argmax(logits, axis=-1)))
    want = np.concatenate(want)[:len(ds)]

    result = Execution(cfg, torch.device("cpu")).run()
    np.testing.assert_array_equal(result.preds, want)
    scores = np.stack([ds[i]["ans"] for i in range(len(ds))])
    assert result.accuracy == pytest.approx(float(np.mean(scores[np.arange(len(ds)), want])))


def test_port_cpu_eval_never_loads_jax(tmp_path, arch_path):
    script = textwrap.dedent(f"""
        import math
        import os
        import sys
        import torch
        from mmnas_tpu_torch.config import Cfg
        from mmnas_tpu_torch.engine.vqa import Execution
        from mmnas_tpu_torch.models.convert import to_jax_params
        from mmnas_tpu_torch.train.checkpoint import save_checkpoint
        cfg = Cfg(RUN_MODE="val", LOG_ROOT={str(tmp_path / 'log')!r},
                  CKPT_ROOT={str(tmp_path / 'ck')!r},
                  CKPT_FILE_PATH={str(tmp_path / 'port.pkl')!r}, ARCH_PATH={arch_path!r},
                  **{SMALL!r})
        exe = Execution(cfg, torch.device("cpu"))
        net = exe.build_net(exe.build_dataset("val"))
        save_checkpoint(cfg.CKPT_FILE_PATH, {{"state_dict": to_jax_params(net),
                                             "net_optim": None, "epoch": 0}})
        result = exe.run()
        assert result.preds.shape == (6,), result.preds.shape
        train = Execution(cfg.replace(RUN_MODE="train", MAX_EPOCH=1, DROPOUT_R=0.1,
                                      EVAL_EVERY_EPOCH=False), torch.device("cpu")).run()
        assert len(train.step_losses) == 2 and all(map(math.isfinite, train.step_losses))
        assert os.path.exists(os.path.join(cfg.CKPT_ROOT, "train_epoch1.pkl"))
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "mmnas_tpu"))
        assert not loaded, loaded
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=one_thread_env(),
                          timeout=120, cwd=str(Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")


def test_train_mode_and_cpu_only_cli_are_refused(tmp_path, monkeypatch):
    """The CLI never falls back to the CPU, for training or eval. (Training in
    bf16 on fp32 masters is ported; tests/test_torch_net.py holds
    its gradient to the JAX package's.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in ("train", "val"):
        with pytest.raises(RuntimeError, match="CUDA"):
            train_vqa.main(["--RUN", run, "--SYNTH"])


# params and moments after one epoch (2 Adam steps) of the two packages,
# from one checkpoint: each computes the same fp32 forward and backward with
# sums in other orders; observed max abs diff 1.1e-6
TRAIN_TOL = 1e-5
# ...except the AttFlat glimpse biases: the softmax over regions cancels a
# bias shared by all regions, so their true gradient is 0 and each package
# gets rounding noise, which Adam's first steps turn into moves of up to lr
# (3e-5 per warmup step) either way; observed 3e-5
INVARIANT = ("attflat_x", "attflat_y")
INVARIANT_TOL = 2 * 2 * 0.00012 / 4


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Epoch-1 checkpoints of both packages from one JAX epoch-0 checkpoint."""
    tmp = tmp_path_factory.mktemp("slice")
    arch = tmp / "arch.json"
    arch.write_text(json.dumps(GENE))
    common = dict(SMALL, RUN_MODE="train", RESUME=True, MAX_EPOCH=1, EVAL_EVERY_EPOCH=False,
                  ARCH_PATH=str(arch), CKPT_FILE_PATH=str(tmp / "epoch0.pkl"),
                  LOG_ROOT=str(tmp / "log"))
    jcfg = Cfg(N_DEVICES=1, CKPT_ROOT=str(tmp / "jax"), **common)
    ds = SynthVqaDataset(jcfg, size=jcfg.SYNTH_SIZE, seed=jcfg.SEED)
    jnet = JaxNetFull(jcfg, load_genotype(jcfg.ARCH_PATH),
                      {"token_size": ds.token_size, "ans_size": ds.ans_size,
                       "pretrained_emb": ds.pretrained_emb}, "vqa")
    params = jnet.init(jax.random.PRNGKey(4))
    opt_state = jax_build_net_optimizer(jcfg, 2).init(params)
    jax_save_checkpoint(jcfg.CKPT_FILE_PATH,
                        {"state_dict": params, "net_optim": opt_state, "epoch": 0})
    _, _, jax_history = JaxExecution(jcfg).run()
    port = Execution(PortCfg(CKPT_ROOT=str(tmp / "port"), **common), torch.device("cpu")).run()
    return tmp, jax_history, port


def load_pickle(path):
    import pickle
    with open(path, "rb") as f:
        return pickle.load(f)


def test_port_train_epoch_matches_jax(trained):
    tmp, jax_history, port = trained
    assert port.epoch_losses == pytest.approx(jax_history, rel=1e-5)
    want = load_pickle(tmp / "jax" / "train_epoch1.pkl")
    got = load_pickle(tmp / "port" / "train_epoch1.pkl")
    assert got["epoch"] == want["epoch"] == 1
    for key in ("state_dict", "net_optim"):
        assert jax.tree_util.tree_structure(got[key]) == jax.tree_util.tree_structure(want[key])
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got[key]),
                                jax.tree_util.tree_leaves(want[key])):
            assert a.dtype == b.dtype
            names = [getattr(k, "key", None) for k in path]
            invariant = (key == "state_dict" and names[0] in INVARIANT
                         and names[1:] == ["mlp", "linear", "b"])
            tol = INVARIANT_TOL if invariant else TRAIN_TOL
            np.testing.assert_allclose(a, b, rtol=TRAIN_TOL, atol=tol,
                                       err_msg=jax.tree_util.keystr(path))
    assert int(got["net_optim"]["step"]) == 2


def test_each_package_evaluates_the_others_checkpoint(trained):
    tmp, _, _ = trained
    common = dict(SMALL, RUN_MODE="val", ARCH_PATH=str(tmp / "arch.json"),
                  LOG_ROOT=str(tmp / "log"), CKPT_ROOT=str(tmp / "eval"))
    port_of_jax = Execution(PortCfg(CKPT_FILE_PATH=str(tmp / "jax" / "train_epoch1.pkl"),
                                    **common), torch.device("cpu")).run()
    port_of_port = Execution(PortCfg(CKPT_FILE_PATH=str(tmp / "port" / "train_epoch1.pkl"),
                                     **common), torch.device("cpu")).run()
    jax_of_port = JaxExecution(Cfg(N_DEVICES=1, CKPT_FILE_PATH=str(
        tmp / "port" / "train_epoch1.pkl"), **common)).run()
    np.testing.assert_array_equal(port_of_jax.preds, port_of_port.preds)
    assert jax_of_port == pytest.approx(port_of_jax.accuracy)
