"""SCAN_STEPS in the port (engine/search.py `chunk`), on the CPU: a search run
in chunks of N steps is the per-step loop's run.

The JAX package's tests/test_scan_steps.py holds its lax.scan chunk to its
per-step loop, and tests/test_torch_search_engine.py and
tests/test_torch_weight_programs.py hold the port's per-step loop to the JAX
engine; here the port's chunks are held to the port's per-step loop, which
closes the chain without compiling a JAX program.

- Runs as tests/test_scan_steps.py sizes them (HSIZE 64, batch 8, 80
  synthetic items: 8 weight steps an epoch, ALPHA_EVERY 2, two epochs from
  ALPHA_START 1), at the small widths of tests/test_torch_search_engine.py,
  DROPOUT_R 0.1: SCAN_STEPS 4 under --UNIFIED_WEIGHT (the 'graph' dispatch,
  whose step programs run eagerly on the CPU), 6 with a 2-step tail under
  KPATH 2 and 4 with 'two' arch steps (the 'eager' dispatch: the per-step
  loop, printed as such), a VGD run
  under --UNIFIED_WEIGHT, and 4 under --UNIFIED_WEIGHT --REMAT. Each gives
  the per-step run's paths exactly, its params, net optimizer state, alpha
  and alpha optimizer state to the JAX test's tolerance (rtol 2e-4, atol
  2e-5; they agree to the bit here) and a genotype archive of the same
  bytes.
- The pieces: the samplers on alpha's tensor (as a step program calls them)
  give `sample_indices` / `sample_indices_two`'s indices exactly, on many
  alphas and uniforms, and those of the plain inverse CDF and stable Gumbel
  top-2; `step_device` gives `step`'s update over a masked
  schedule, to the bit; `ship` hands back its arrays."""

import numpy as np
import pytest
import torch

from mmnas_tpu_torch.config import SearchCfg
from mmnas_tpu_torch.engine.search import SearchExecution, ship
from mmnas_tpu_torch.engine.search_vgd import SearchExecution as VgdSearchExecution
from mmnas_tpu_torch.models.supernet import CELLS, NetSearch
from mmnas_tpu_torch.train.optimizer import WarmupAdam, plain_adam

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RUN = dict(TASK="vqa", SYNTH=True, SYNTH_SIZE=80, BATCH_SIZE=8, HSIZE=64,
           ATTFLAT_OUT_SIZE=128, ATTFLAT_MLP_SIZE=16, REL_SIZE=8, FRCNFEAT_LEN=8,
           FRCNFEAT_SIZE=16, WORD_EMBED_SIZE=10, MAX_TOKEN=6, NODES=(("enc", 1), ("dec", 2)),
           DROPOUT_R=0.1, MAX_EPOCH=2, ALPHA_START=1, ALPHA_EVERY=2, SEED=3, NUM_WORKERS=1,
           N_DEVICES=1, EVAL_EVERY_EPOCH=False, CKPT_EVERY=100)
RTOL, ATOL = 2e-4, 2e-5          # tests/test_scan_steps.py's
CASES = {  # name: (engine, extra config, SCAN_STEPS, dispatch)
    "unified": (SearchExecution, {"UNIFIED_WEIGHT_STEP": True}, 4, "graph"),
    "kpath2_tail": (SearchExecution, {"KPATH": 2}, 6, "eager"),
    "two": (SearchExecution, {"ALPHA_BINARY_MODE": "two"}, 4, "eager"),
    "vgd_unified": (VgdSearchExecution, {"TASK": "vgd", "UNIFIED_WEIGHT_STEP": True}, 4,
                    "graph"),
    "unified_remat": (SearchExecution, {"UNIFIED_WEIGHT_STEP": True, "REMAT": True}, 4,
                      "graph"),
}


def run(engine, tmp, scan, **extra):
    d = str(tmp / f"scan{scan}")
    cfg = SearchCfg(**dict(RUN, SCAN_STEPS=scan, VERSION="scan", CKPT_ROOT=d, ARCH_ROOT=d,
                           LOG_ROOT=d, **extra))
    ex = engine(cfg, torch.device("cpu"))
    result = ex.run()
    return ex, result, (tmp / f"scan{scan}" / "scan.json").read_bytes()


def state_leaves(result):
    """Every number a run's checkpoint holds, by name."""
    out = {f"param.{n}": p.detach() for n, p in result.net.named_parameters()}
    for key in ("m", "v"):
        out.update({f"net_optim.{key}.{n}": t for n, t in result.opt_state[key].items()})
        out.update({f"alpha_optim.{key}.{c}": result.alpha_state[key][c] for c in CELLS})
    out.update({f"alpha.{c}": result.alpha[c].detach() for c in CELLS})
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_chunks_give_the_per_step_run(name, tmp_path, capsys):
    engine, extra, scan, dispatch = CASES[name]
    _, want, want_archive = run(engine, tmp_path, 1, **extra)
    capsys.readouterr()
    ex, got, got_archive = run(engine, tmp_path, scan, **extra)
    assert ex.chunk_log["dispatch"] == dispatch
    assert f"SCAN_STEPS {scan}: {dispatch} dispatch" in capsys.readouterr().out
    assert repr(got.paths) == repr(want.paths)
    assert [k for k, _, _ in got.paths].count("arch") == 4       # epoch 2: 8 steps / 2
    assert got_archive == want_archive
    assert got.opt_state["t"] == want.opt_state["t"]
    assert got.opt_state["step"] == want.opt_state["step"] == 16
    assert got.alpha_state["t"] == want.alpha_state["t"]
    assert got.alpha_state["step"] == want.alpha_state["step"] == 4
    np.testing.assert_allclose(got.step_losses, want.step_losses, rtol=RTOL, atol=ATOL)
    g, w = state_leaves(got), state_leaves(want)
    assert list(g) == list(w)
    for n in g:
        np.testing.assert_allclose(g[n].numpy(), w[n].numpy(), rtol=RTOL, atol=ATOL, err_msg=n)


def plain_inverse_cdf(alpha, u):
    """The host sampler's math before the split (numpy's exp and cumsum)."""
    out = {}
    for c in CELLS:
        a = np.asarray(alpha[c], np.float64)
        e = np.exp(a - a.max(axis=-1, keepdims=True))
        cdf = np.cumsum(e / e.sum(axis=-1, keepdims=True), axis=-1)
        out[c] = np.minimum((cdf <= (u[c] * cdf[:, -1])[:, None]).sum(axis=-1), a.shape[1] - 1)
    return out


def test_device_samplers_give_the_host_samplers_indices():
    r = np.random.RandomState(0)
    n_nodes, shapes = {"enc": 12, "dec": 18}, {"enc": (12, 2), "dec": (18, 4)}
    for trial in range(200):
        scale = (0.1, 1.0, 5.0, 40.0)[trial % 4]
        alpha = {c: (r.randn(*shapes[c]) * scale).astype(np.float32) for c in CELLS}
        if trial % 7 == 0:      # ties, and a row far from the others
            alpha["dec"][0] = 1.0
            alpha["dec"][1, 2] = 300.0
        seed = 1000 + trial
        host = NetSearch.sample_indices(alpha, torch.Generator().manual_seed(seed))
        u = NetSearch.draw_uniforms(torch.Generator().manual_seed(seed), n_nodes)
        dev = NetSearch.indices_from_uniforms({c: torch.from_numpy(a) for c, a in alpha.items()},
                                              u)
        plain = plain_inverse_cdf(alpha, {c: v.numpy() for c, v in u.items()})
        for c in CELLS:
            assert dev[c].dtype == torch.int64 and host[c].dtype == np.int64
            np.testing.assert_array_equal(dev[c].numpy(), host[c])
            np.testing.assert_array_equal(host[c], plain[c])
        host2 = NetSearch.sample_indices_two(alpha, torch.Generator().manual_seed(seed))
        draws = NetSearch.draw_uniforms_two(torch.Generator().manual_seed(seed), shapes)
        dev2 = NetSearch.indices_two_from_uniforms(
            {c: torch.from_numpy(a) for c, a in alpha.items()}, draws)
        for c in CELLS:
            np.testing.assert_array_equal(dev2[c].numpy(), host2[c])
            gumbel, u2 = (x.numpy() for x in draws[c])
            a = alpha[c].astype(np.float64)
            pair = np.argsort(gumbel - a, axis=-1, kind="stable")[:, :2]
            logits = np.take_along_axis(a, pair, axis=1)
            p = np.exp(logits - logits.max(axis=1, keepdims=True))
            second = (u2 >= p[:, 0] / p.sum(axis=1)).astype(np.int64)
            rows = np.arange(len(a))
            np.testing.assert_array_equal(
                host2[c], np.stack([pair[rows, second], pair[rows, 1 - second]], axis=1))


@pytest.mark.parametrize("optim", [
    WarmupAdam(1e-3, betas=(0.9, 0.98), eps=1e-9, weight_decay=0.01, epoch_steps=2),
    plain_adam(0.1, (0.0, 0.999))], ids=["warmup_adam", "plain_adam"])
def test_device_step_is_the_host_step_over_a_masked_schedule(optim):
    r = np.random.RandomState(1)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {n: torch.from_numpy(r.randn(*s).astype(np.float32)) for n, s in shapes.items()}
    dev = {n: p.clone() for n, p in params.items()}
    names = list(shapes)
    host_state, dev_state = optim.init(params), optim.init(dev)
    counts = torch.from_numpy(optim.counts_of(dev_state, names))
    bias = torch.from_numpy(optim.bias_table(20))
    for step in range(10):
        grads = {n: torch.from_numpy(r.randn(*s).astype(np.float32)) for n, s in shapes.items()}
        mask = {n: float(r.rand() < 0.6) for n in names}
        lr = optim.rate(host_state)
        optim.step(host_state, params, grads, mask)
        optim.step_device(dev_state, dev, grads, names, counts,
                          torch.tensor([mask[n] for n in names]), torch.tensor(lr), bias)
        dev_state["step"] += 1
        for n in names:
            torch.testing.assert_close(dev[n], params[n], rtol=0, atol=0)
            for key in ("m", "v"):
                torch.testing.assert_close(dev_state[key][n], host_state[key][n], rtol=0, atol=0)
    optim.set_counts(dev_state, names, counts.numpy())
    assert dev_state["t"] == host_state["t"] and sum(dev_state["t"].values()) > 0


def test_ship_hands_back_each_array_in_one_buffer():
    r = np.random.RandomState(2)
    arrays = {"f": r.randn(3, 5).astype(np.float32), "d": r.rand(7), "i": r.randint(0, 9, (2, 3)),
              "b": r.rand(4) > 0.5, "h": r.randn(1).astype(np.float16)}
    got = ship(arrays, torch.device("cpu"))
    base = got["f"].untyped_storage().data_ptr()
    for k, a in arrays.items():
        assert got[k].untyped_storage().data_ptr() == base        # one buffer
        assert (got[k].data_ptr() - base) % 256 == 0               # 16-byte rows and more
        np.testing.assert_array_equal(got[k].numpy(), a)
