"""The port's bilevel search end to end on the CPU, against the JAX package's
SearchExecution.

(a) The slice as a whole, in two legs from one start (a seeded init, alpha
and both optimizers' states, saved by the JAX package as an epoch-0
checkpoint), DROPOUT_R 0, the
same synthetic batches in the same order:
  leg 1, KPATH 1, 'full' arch steps: each package runs one epoch (4 weight
  steps, 2 arch steps) and its argmax-path eval;
  leg 2, KPATH 2, 'two' arch steps: each package resumes from the OTHER's
  epoch-1 checkpoint for one more epoch.
The port samples its paths on the host; the JAX engine replays the paths the
port recorded: its sample_indices / sample_indices_two are monkeypatched in
this test to hand back the recorded indices, which enter its jitted steps
as arguments. Nothing in mmnas_tpu/ changes for this. After each leg the
checkpoints agree in params, net_optim, alpha and alpha_optim (1e-5), the
genotype archives have the same bytes and the eval accuracies are equal.
(b) A CPU search epoch in a fresh interpreter loads no jax and no
mmnas_tpu module. (c) The search CLI refuses the CPU."""

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
import jax.numpy as jnp

from mmnas_tpu.config import SearchCfg
from mmnas_tpu.data.synth import SynthVqaDataset
from mmnas_tpu.engine.search import SearchExecution as JaxSearchExecution
from mmnas_tpu.models.supernet import NetSearch as JaxNetSearch
from mmnas_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from mmnas_tpu.train.optimizer import build_net_optimizer as jax_build_net_optimizer
from mmnas_tpu.train.optimizer import plain_adam as jax_plain_adam
from mmnas_tpu_torch import search_vqa
from mmnas_tpu_torch.config import SearchCfg as PortSearchCfg
from mmnas_tpu_torch.engine.search import SearchExecution
from mmnas_tpu_torch.models.convert import to_jax_params
from mmnas_tpu_torch.models.supernet import NetSearch

from _torch_threads import one_thread_env, one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(TASK="vqa", SYNTH=True, SYNTH_SIZE=20, BATCH_SIZE=4, HSIZE=64,
             ATTFLAT_OUT_SIZE=128, ATTFLAT_MLP_SIZE=16, REL_SIZE=8, FRCNFEAT_LEN=8,
             FRCNFEAT_SIZE=16, WORD_EMBED_SIZE=10, MAX_TOKEN=6, NODES=(("enc", 1), ("dec", 2)),
             DROPOUT_R=0.0, ALPHA_START=0, ALPHA_EVERY=2, SEED=13, NUM_WORKERS=1,
             VERSION="parity-search", N_DEVICES=1)
STEPS = 4                      # 16 of the 20 items in the weight split, batches of 4
# params, moments, alpha and its moments after each leg: both packages
# compute the same fp32 forward and backward with sums in other orders
TOL = 1e-5
# ...except where Adam turns rounding noise into a step: it moves an element
# by up to lr whatever the gradient's size, so an element whose gradient is
# rounding noise moves by an amount of either sign in each package. That is
# so for the AttFlat glimpse biases (`mlp.linear.b`): a softmax over the
# sequence cancels a bias shared by all positions, so their true gradient
# is 0. Those two leaves are bounded by Adam's step size, lr per step
# (warmup lr 1e-4) over the 8 steps of both legs; their Adam moments, the
# gradients' history, are still held to TOL, and so is every other leaf.
ADAM_STEP_TOL = 8 * 0.0004 / 4


def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def jnp_idx(idx):
    return {c: jnp.asarray(v, jnp.int32) for c, v in idx.items()}


def run_jax_replaying(cfg, paths, monkeypatch, engine=JaxSearchExecution):
    """JAX `engine`(cfg).run() (the VQA SearchExecution or a subclass) with
    the sampled indices taken from the port's recorded `paths` ((kind, global
    step, indices), in order; ITM's ("mine", epoch, idx) are handed to the
    engine's mining at the start of that epoch)."""
    queues = {"weight": [p for kind, _, p in paths if kind == "weight"],
              "arch": [[p] for kind, _, p in paths if kind == "arch"],
              "mine": [(epoch, p) for kind, epoch, p in paths if kind == "mine"]}
    pending = []
    epoch_start = engine.on_epoch_start

    def on_epoch_start(self, net, params, alpha, dataset, epoch):
        if queues["mine"] and queues["mine"][0][0] == epoch:
            pending[:] = [jnp_idx(queues["mine"].pop(0)[1])]
        return epoch_start(self, net, params, alpha, dataset, epoch)

    def replayed(self, rng, alpha):
        return pending.pop(0)

    def jitted(body, kind):
        def with_paths(*args):
            *state, idxs = args
            pending[:] = idxs               # read while tracing, in sampling order
            return body(*state)

        step = jax.jit(with_paths)
        return lambda *state: step(*state, [jnp_idx(i) for i in queues[kind].pop(0)])

    with monkeypatch.context() as m:
        m.setattr(JaxNetSearch, "sample_indices", replayed)
        m.setattr(JaxNetSearch, "sample_indices_two", replayed)
        m.setattr(JaxSearchExecution, "make_weight_step",
                  lambda self, net, optim: jitted(self.weight_body(net, optim), "weight"))
        m.setattr(JaxSearchExecution, "make_arch_step",
                  lambda self, net, aoptim: jitted(self.arch_body(net, aoptim), "arch"))
        m.setattr(engine, "on_epoch_start", on_epoch_start)
        engine(cfg).run()
    assert queues == {"weight": [], "arch": [], "mine": []}


def run_logged(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    return result, out.getvalue()


def eval_lines(log):
    return [line for line in log.splitlines() if line.startswith("search eval accuracy")]


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("search")
    mp = pytest.MonkeyPatch()

    def dirs(pkg, **kw):
        return dict(SMALL, CKPT_ROOT=str(tmp / pkg), ARCH_ROOT=str(tmp / pkg / "arch"),
                    LOG_ROOT=str(tmp / "log" / pkg), RESUME=True, **kw)

    leg1 = dict(MAX_EPOCH=1, KPATH=1, ALPHA_BINARY_MODE="full", EVAL_EVERY_EPOCH=True,
                CKPT_FILE_PATH=str(tmp / "epoch0.pkl"))
    jcfg = SearchCfg(**dirs("jax", **leg1))
    ds = SynthVqaDataset(jcfg, size=jcfg.SYNTH_SIZE, seed=jcfg.SEED)
    init_dict = {"token_size": ds.token_size, "ans_size": ds.ans_size,
                 "pretrained_emb": ds.pretrained_emb}
    jnet = JaxNetSearch(jcfg, init_dict)
    # a seeded port init in the JAX pytree (compiling the JAX init costs more
    # than the legs; tests/test_torch_supernet.py holds the two structures
    # equal)
    params = to_jax_params(NetSearch(PortSearchCfg(**dict(SMALL, SEED=5)), init_dict))
    r = np.random.RandomState(6)
    alpha = {c: jnp.asarray(np.asarray(a) + r.randn(*a.shape).astype(np.float32) * 0.5)
             for c, a in jnet.init_alpha().items()}
    aoptim = jax_plain_adam(jcfg.ALPHA_LR_BASE, jcfg.ALPHA_OPT_BETAS, eps=1e-8)
    jax_save_checkpoint(jcfg.CKPT_FILE_PATH, {
        "state_dict": params, "net_optim": jax_build_net_optimizer(jcfg, STEPS).init(params),
        "alpha": alpha, "alpha_optim": aoptim.init(alpha), "epoch": 0})

    port1, port_log1 = run_logged(lambda: SearchExecution(
        PortSearchCfg(**dirs("port", **leg1)), torch.device("cpu")).run())
    _, jax_log1 = run_logged(lambda: run_jax_replaying(jcfg, port1.paths, mp))

    leg2 = dict(MAX_EPOCH=2, KPATH=2, ALPHA_BINARY_MODE="two", EVAL_EVERY_EPOCH=False)
    ck1 = "parity-search_epoch1.pkl"
    port2 = SearchExecution(PortSearchCfg(**dirs("port", CKPT_FILE_PATH=str(tmp / "jax" / ck1),
                                                 **leg2)), torch.device("cpu")).run()
    run_jax_replaying(SearchCfg(**dirs("jax", CKPT_FILE_PATH=str(tmp / "port" / ck1), **leg2)),
                      port2.paths, mp)
    mp.undo()
    return tmp, (port1, port_log1, jax_log1), port2


# the state_dict leaves held to ADAM_STEP_TOL: the AttFlat glimpse biases
NOISY = (("attflat_x", "mlp", "linear", "b"), ("attflat_y", "mlp", "linear", "b"))


def assert_checkpoints_agree(got, want, noisy=NOISY, noisy_entries=None):
    """Every leaf to TOL, except the state_dict leaves of `noisy`, whole, and
    the entries of `noisy_entries` (a state_dict leaf's path -> a boolean
    mask of its entries), which are held to ADAM_STEP_TOL; the rest of such
    a leaf stays at TOL."""
    assert got["epoch"] == want["epoch"]
    for key in ("state_dict", "net_optim", "alpha", "alpha_optim"):
        assert jax.tree_util.tree_structure(got[key]) == jax.tree_util.tree_structure(want[key])
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got[key]),
                                jax.tree_util.tree_leaves(want[key])):
            assert np.asarray(a).dtype == np.asarray(b).dtype, jax.tree_util.keystr(path)
            names = tuple(getattr(k, "key", None) for k in path)
            where = f"{key}{jax.tree_util.keystr(path)}"
            step_bound = key == "state_dict" and names in noisy
            entries = (noisy_entries or {}).get(names) if key == "state_dict" else None
            if entries is not None:
                a, b = np.asarray(a), np.asarray(b)
                np.testing.assert_allclose(a[entries], b[entries], rtol=TOL, atol=ADAM_STEP_TOL,
                                           err_msg=where)
                a, b = a[~entries], b[~entries]
            np.testing.assert_allclose(a, b, rtol=TOL, atol=ADAM_STEP_TOL if step_bound else TOL,
                                       err_msg=where)


def test_leg1_sampled_steps_and_full_arch_steps_match_jax(legs):
    tmp, (port1, port_log, jax_log), _ = legs
    kinds = [(kind, step) for kind, step, _ in port1.paths]
    assert kinds == [("weight", 0), ("weight", 1), ("arch", 1), ("weight", 2), ("weight", 3),
                     ("arch", 3)]
    assert len(port1.step_losses) == STEPS and all(np.isfinite(port1.step_losses))
    name = "parity-search_epoch1.pkl"
    got, want = load_pickle(tmp / "port" / name), load_pickle(tmp / "jax" / name)
    assert_checkpoints_agree(got, want)
    assert int(got["alpha_optim"]["step"]) == 2 and int(got["net_optim"]["step"]) == STEPS
    # the arch steps moved alpha
    assert not np.allclose(got["alpha"]["dec"], load_pickle(tmp / "epoch0.pkl")["alpha"]["dec"])
    assert eval_lines(port_log) == eval_lines(jax_log) and len(eval_lines(port_log)) == 1


def test_leg2_kpath_and_two_mode_resumed_from_the_other_package_match_jax(legs):
    tmp, _, port2 = legs
    assert [kind for kind, _, _ in port2.paths] == ["weight", "weight", "arch"] * 2
    assert all(len(idxs) == 2 for kind, _, idxs in port2.paths if kind == "weight")
    assert port2.paths[0][1] == STEPS              # resumed: global steps continue
    name = "parity-search_epoch2.pkl"
    assert_checkpoints_agree(load_pickle(tmp / "port" / name), load_pickle(tmp / "jax" / name))


def test_genotype_archives_have_the_same_bytes(legs):
    tmp, _, _ = legs
    port = (tmp / "port" / "arch" / "parity-search.json").read_bytes()
    assert port == (tmp / "jax" / "arch" / "parity-search.json").read_bytes()
    archive = json.loads(port)
    assert list(archive) == ["epoch1", "epoch2"]       # kept across the resume
    assert [len(archive["epoch2"][c]) for c in ("enc", "dec")] == [1, 2]


def test_port_cpu_search_never_loads_jax(tmp_path):
    script = textwrap.dedent(f"""
        import math
        import sys
        import torch
        from mmnas_tpu_torch.config import SearchCfg
        from mmnas_tpu_torch.engine.search import SearchExecution
        cfg = SearchCfg(**dict({SMALL!r}, MAX_EPOCH=1, DROPOUT_R=0.1, KPATH=2,
                               CKPT_ROOT={str(tmp_path)!r}, ARCH_ROOT={str(tmp_path)!r},
                               LOG_ROOT={str(tmp_path)!r}))
        result = SearchExecution(cfg, torch.device("cpu")).run()
        assert len(result.step_losses) == 4 and all(map(math.isfinite, result.step_losses))
        assert [k for k, _, _ in result.paths].count("arch") == 2
        # SCAN_STEPS: a chunk of 4 (graph dispatch, eagerly on the CPU) under
        # REMAT, then the same in chunks on the per-step programs
        for extra in ({{"UNIFIED_WEIGHT_STEP": True, "REMAT": True}}, {{"KPATH": 2}}):
            cfg = SearchCfg(**dict({SMALL!r}, MAX_EPOCH=1, DROPOUT_R=0.1, SCAN_STEPS=4,
                                   CKPT_ROOT={str(tmp_path)!r}, ARCH_ROOT={str(tmp_path)!r},
                                   LOG_ROOT={str(tmp_path)!r}, **extra))
            result = SearchExecution(cfg, torch.device("cpu")).run()
            assert len(result.step_losses) == 4 and all(map(math.isfinite, result.step_losses))
            assert [k for k, _, _ in result.paths].count("arch") == 2
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mmnas_tpu"))
        assert not loaded, loaded
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=one_thread_env(),
                          timeout=120, cwd=str(Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")


def test_search_cli_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        search_vqa.main(["--SYNTH"])
    with pytest.raises(NotImplementedError, match="orbax"):
        SearchExecution(PortSearchCfg(**dict(SMALL, CKPT_BACKEND="orbax")), torch.device("cpu"))
