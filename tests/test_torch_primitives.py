"""PyTorch port primitives vs mmnas_tpu.ops.primitives on the same inputs
(numpy from a seed), fp32, tolerance 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmnas_tpu.ops import primitives as JP
from mmnas_tpu_torch.models.convert import from_jax_params
from mmnas_tpu_torch.ops import primitives as TP

TOL = 1e-5


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 100, 16)])
def test_layernorm_matches_jax(shape):
    r = np.random.RandomState(0)
    x = (r.randn(*shape) * 3 + 1).astype(np.float32)
    a = r.randn(shape[-1]).astype(np.float32)
    b = r.randn(shape[-1]).astype(np.float32)
    want = np.asarray(JP.layernorm({"a": jnp.asarray(a), "b": jnp.asarray(b)}, jnp.asarray(x)))
    ln = TP.LayerNorm(shape[-1])
    ln.load_state_dict(from_jax_params({"a": a, "b": b}))
    got = ln(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_lstm_matches_jax():
    r = np.random.RandomState(1)
    x = r.randn(3, 6, 12).astype(np.float32)
    x[0, 4:] = 0.0                       # padding tokens run through the recurrence
    p = _host(JP.lstm_init(jax.random.PRNGKey(0), 12, 16))
    want = np.asarray(JP.lstm(p, jnp.asarray(x)))
    m = TP.LSTM(12, 16)
    m.load_state_dict(from_jax_params(p))
    got = m(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (3, 6, 16)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_relu", [True, False])
def test_mlp_matches_jax(use_relu):
    r = np.random.RandomState(2)
    x = r.randn(4, 7, 16).astype(np.float32)
    p = _host(JP.mlp_init(jax.random.PRNGKey(1), 16, 32, 8))
    want = np.asarray(JP.mlp(p, jnp.asarray(x), None, 0.0, use_relu, False))
    m = TP.MLP(16, 32, 8, use_relu=use_relu)
    m.load_state_dict(from_jax_params(p))
    got = m(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_make_mask_and_mask_scores_match_jax():
    r = np.random.RandomState(3)
    feat = r.randn(3, 9, 5).astype(np.float32)
    feat[0, 6:] = 0.0
    feat[2, 1] = 0.0
    want = np.asarray(JP.make_mask(jnp.asarray(feat)))
    got = TP.make_mask(torch.from_numpy(feat)).numpy()
    assert got.shape == (3, 1, 1, 9)
    np.testing.assert_array_equal(got, want)
    scores = r.randn(3, 2, 4, 9).astype(np.float32)
    np.testing.assert_array_equal(
        TP.mask_scores(torch.from_numpy(scores), torch.from_numpy(got)).numpy(),
        np.asarray(JP.mask_scores(jnp.asarray(scores), jnp.asarray(want))))


def test_dropout_is_inverted_and_seeded():
    x = torch.ones(64, 256)
    assert TP.dropout(x, 0.25, train=False) is x
    assert TP.dropout(x, 0.0, train=True) is x
    a = TP.dropout(x, 0.25, True, torch.Generator().manual_seed(7))
    b = TP.dropout(x, 0.25, True, torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a[a != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.75))
    assert abs((a == 0).float().mean().item() - 0.25) < 0.01


def test_dropout_needs_a_generator_on_the_tensors_device():
    """A generator draws only on its own device: a CPU generator cannot
    feed the mask of a tensor elsewhere, so dropout refuses the pair."""
    x = torch.ones(4, 4, device="meta")
    with pytest.raises(ValueError, match="generator on that device"):
        TP.dropout(x, 0.1, True, torch.Generator().manual_seed(0))
