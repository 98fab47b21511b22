"""The plain versions of the probe kernels (mmnas_tpu_torch/tools/probes.py)
against the math of the TPU probe scripts in tools/debug/, on the CPU.

The scripts cannot be imported (each runs `pallas_call` when imported), so
this file keeps its own copy of their numpy lines and cites them. Inputs are
drawn as the scripts draw them (RandomState(0), in their order).

- rows 5-6 (_probe_bias.py, _probe_bias2.py): the RSA log-bias against the
  fp64 chain of _probe_bias.py:41-43 and against the JAX package's
  `rsa_log_bias` (mmnas_tpu/ops/attention.py:67) on relu(raw W1 + b1) in
  fp32. The log turns the fp32 rounding of pre into large bias errors near
  the 1e-6 clamp, so the check is on exp(bias) = max(pre, 1e-6), absolute
  1e-5 (pre is a sum of 64 terms of size ~1, rounded in fp32), and on the
  bias itself where pre > 0.1, absolute 1e-5;
- rows 7-9 (_probe_slice.py, _probe_outer.py, _probe_wrblock.py): exact.
The kernels themselves run on the card (tests/test_torch_cuda_kernel.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmnas_tpu.ops.attention import rsa_log_bias as jax_rsa_log_bias
from mmnas_tpu_torch.tools import probes

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


def script_bias_inputs():
    """_probe_bias.py:5-11 (the same lines in _probe_bias2.py)."""
    B, H, L, Rr, R = 8, 8, 100, 4, 64
    r = np.random.RandomState(0)
    raw = np.abs(r.randn(B, L, L, Rr)).astype(np.float32)
    w1 = (r.randn(Rr, R) * 0.5).astype(np.float32)
    b1 = (r.randn(R) * 0.1).astype(np.float32)
    wrw = (r.randn(R, H) * 0.3).astype(np.float32)
    wrb = (r.randn(H) * 0.1).astype(np.float32)
    return raw, w1, b1, wrw, wrb


def script_bias64(raw, w1, b1, wrw, wrb):
    """_probe_bias.py:41-43."""
    t64 = np.maximum(raw.astype(np.float64) @ w1.astype(np.float64) + b1, 0)
    pre64 = np.einsum("bxyr,rh->bhxy", t64, wrw.astype(np.float64)) + wrb[None, :, None, None]
    return np.log(np.maximum(pre64, 1e-6))


@pytest.fixture(scope="module")
def bias():
    raw, w1, b1, wrw, wrb = script_bias_inputs()
    # the port's layouts: W1 [R, Rr], Wr [H, R]
    got = probes.probe_bias(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in (raw, w1.T, b1, wrw.T, wrb))).numpy()
    t32 = np.maximum(raw @ w1 + b1, 0)
    jax_ref = np.asarray(jax_rsa_log_bias({"w": jnp.asarray(wrw), "b": jnp.asarray(wrb)},
                                          jnp.asarray(t32)))
    return got, script_bias64(raw, w1, b1, wrw, wrb), jax_ref


def assert_bias_close(got, want):
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=0, atol=TOL)
    away = np.exp(want) > 0.1
    assert away.mean() > 0.2
    np.testing.assert_allclose(got[away], want[away], rtol=0, atol=TOL)


def test_bias_inputs_are_the_scripts(bias):
    raw, w1, b1, wrw, wrb = script_bias_inputs()
    mine = probes.bias_inputs()
    for a, b in zip(mine, (raw, w1.T, b1, wrw.T, wrb)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("against", ["fp64 chain", "jax rsa_log_bias"])
def test_bias_plain_version_matches(bias, against):
    got, fp64, jax_ref = bias
    assert got.shape == (8, 8, 100, 100) and got.dtype == np.float32
    assert_bias_close(got, fp64 if against == "fp64 chain" else jax_ref)
    # both bias probes have this one plain version
    raw, w1, b1, wr, br = (torch.from_numpy(a) for a in probes.bias_inputs())
    assert torch.equal(probes.probe_bias(raw, w1, b1, wr, br, fresh=True),
                       torch.from_numpy(got))


def test_slice_plain_version_is_exact():
    """_probe_slice.py:4-11: 2 plane in fp32, from f32 and bf16 planes."""
    r = np.random.RandomState(0)
    for dt in (torch.float32, torch.bfloat16):
        plane = torch.from_numpy(r.randn(1, 100, 100).astype(np.float32)).to(dt)
        want = plane[0].float().numpy() * 2.0
        got = probes.probe_slice(plane)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(probes.slice_inputs()[dt], plane)


def test_outer_plain_version_is_exact():
    """_probe_outer.py:4-17: plane (x) w1 row + b1, rounded as numpy rounds."""
    r = np.random.RandomState(0)
    mine = probes.outer_inputs()
    for dt in (torch.float32, torch.bfloat16):
        plane = torch.from_numpy(r.randn(100, 100).astype(np.float32)).to(dt)
        w = torch.from_numpy((r.randn(64) * 0.5).astype(np.float32)).to(dt)
        b1 = torch.from_numpy((r.randn(64) * 0.1).astype(np.float32)).to(dt)
        want = (plane.float().numpy()[:, :, None] * w.float().numpy()[None, None, :]
                + b1.float().numpy()[None, None, :])
        np.testing.assert_array_equal(probes.probe_outer(plane, w, b1).numpy(), want)
        assert all(torch.equal(a, b) for a, b in zip(mine[dt], (plane, w, b1)))


@pytest.mark.parametrize("variant", ["a", "b"])
def test_wrblock_plain_version_is_exact(variant):
    """_probe_wrblock.py:4-6: Wr [H, R, 1], copied to out[b, h] for b < 2."""
    wr = torch.from_numpy(np.random.RandomState(0).randn(8, 64, 1).astype(np.float32))
    got = probes.probe_wrblock(wr, variant)
    assert got.shape == (2, 8, 64, 1)
    assert torch.equal(got, torch.stack([wr, wr])) and torch.equal(probes.wrblock_inputs(), wr)


def test_cli_prints_the_scripts_lines_on_the_cpu(capsys):
    out = probes.main(["--device", "cpu", "--only", "wrblock"])
    assert out == {"wrblock": {"a": 0.0, "b": 0.0}}
    probes.main(["--device", "cpu", "--only", "slice"])
    probes.main(["--device", "cpu", "--only", "outer"])
    lines = capsys.readouterr().out.splitlines()
    assert "A per-h block maxdiff: 0.0" in lines and "B dyn-index maxdiff: 0.0" in lines
    assert "float32: chunked sublane slice maxdiff 0.000e+00" in lines
    assert "bfloat16: outer+bias maxdiff 0.000e+00" in lines


def test_cli_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probes.main(["--only", "slice"])
