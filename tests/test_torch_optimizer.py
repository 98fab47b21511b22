"""The port's optimizers against the JAX package's, step by step, on the same
parameter and gradient streams (numpy, seeded): WarmupAdam across the
warmup boundaries and one milestone decay, with a per-parameter mask on
some steps and global-norm clipping of every gradient; plain Adam;
momentum SGD with its cosine schedule. Parameters, moments, per-parameter
step counts, the global step and the lr agree to 1e-6 (fp32; the two sum
the moments and bias corrections in other orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmnas_tpu.train import optimizer as J
from mmnas_tpu_torch.train import optimizer as P

TOL = 1e-6
SHAPES = {"w": (5, 4), "b": (4,), "emb": (3, 6)}


def streams(steps, seed=0):
    r = np.random.RandomState(seed)
    params = {n: r.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: (r.randn(*s) * 3).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(steps)]
    return params, grads


def assert_trees(port, ref):
    for n in SHAPES:
        np.testing.assert_allclose(np.asarray(port[n]), np.asarray(ref[n]), rtol=TOL, atol=TOL)


def run_both(jopt, popt, steps, masks=None, clip=None, epoch_of=None):
    w0, grads = streams(steps)
    jp = {n: jnp.asarray(a) for n, a in w0.items()}
    js = jopt.init(jp)
    pp = {n: torch.from_numpy(a.copy()) for n, a in w0.items()}
    ps = popt.init(pp)
    epoch = -1
    for i, g in enumerate(grads):
        if epoch_of is not None and epoch_of(i) != epoch:
            epoch = epoch_of(i)
            js, ps = jopt.epoch_hook(js, epoch), popt.epoch_hook(ps, epoch)
        jg = {n: jnp.asarray(a) for n, a in g.items()}
        pg = {n: torch.from_numpy(a.copy()) for n, a in g.items()}
        if clip is not None:
            jg, jnorm = J.clip_by_global_norm(jg, clip)
            plist, pnorm = P.clip_by_global_norm(list(pg.values()), clip)
            pg = dict(zip(pg, plist))
            assert float(pnorm) == pytest.approx(float(jnorm), rel=TOL)
            assert_trees(pg, jg)
        mask = None if masks is None else masks(i)
        jp, js, jlr = jopt.step(js, jp, jg, mask)
        plr = popt.step(ps, pp, pg, mask)
        assert float(plr) == pytest.approx(float(jlr), rel=TOL)
        assert_trees(pp, jp)
        for key in js:
            if isinstance(js[key], dict):
                if key == "t":
                    assert ps["t"] == {n: int(t) for n, t in js["t"].items()}
                else:
                    assert_trees(ps[key], js[key])
            else:
                assert float(ps[key]) == pytest.approx(float(js[key]), rel=TOL)


def test_warmup_adam_with_decay_mask_and_clip_matches_jax():
    es = 3
    args = dict(betas=(0.9, 0.98), eps=1e-9, epoch_steps=es, decay_list=(3,), decay_r=0.2)
    # 14 steps: warmup quarters at steps 1-3, 4-6, 7-9, full rate after; decay at epoch 3
    masks = lambda i: {"w": 1.0, "b": float(i % 3 != 1), "emb": float(i % 4 == 0)}  # noqa: E731
    run_both(J.WarmupAdam(1e-2, **args), P.WarmupAdam(1e-2, **args), 14, masks=masks,
             clip=1.0, epoch_of=lambda i: i // es)


def test_warmup_adam_weight_decay_and_plain_adam_match_jax():
    run_both(J.WarmupAdam(1e-3, weight_decay=0.01, epoch_steps=2),
             P.WarmupAdam(1e-3, weight_decay=0.01, epoch_steps=2), 6)
    run_both(J.plain_adam(0.1), P.plain_adam(0.1), 6)


def test_momentum_sgd_matches_jax():
    run_both(J.MomentumSGD(0.05, 0.9, 1e-4, max_epoch=4, eta_min=0.001),
             P.MomentumSGD(0.05, 0.9, 1e-4, max_epoch=4, eta_min=0.001), 8,
             epoch_of=lambda i: i // 2)
