"""PyTorch port attention vs the JAX package on the same inputs.

The port's plain `fused_attention_reference` (what a CPU tensor takes) and
`scaled_dot_attention` are held against the JAX jnp `scaled_dot_attention`
for SA, GA (Lq != Lk), bias and mask+rel, and against the Pallas kernel
`pallas_attention.fused_attention` in interpret mode. With attention
dropout, the random streams of the two packages are not meant to match, so
both sides get one keep mask: the port's forward with it is held against
the jnp expression of tests/test_pallas_dropout_tpu.py:42-46, and autograd
through it against the Pallas backward `_bwd_call` in interpret mode, which
takes the mask as an input. fp32, tolerance 1e-5 (as
tests/test_pallas_attention.py). Masked scores: the Pallas kernel adds -1e9
while the plain paths replace with -1e9; every row here has a valid key,
where the two agree. The CUDA kernels themselves are checked against the
plain version on the card by chip_smoke.py and
tests/test_torch_cuda_kernel.py."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmnas_tpu.ops import pallas_attention as PA
from mmnas_tpu.ops.attention import scaled_dot_attention as jax_sda
from mmnas_tpu_torch.ops import fused_attention as FA
from mmnas_tpu_torch.ops.attention import scaled_dot_attention

TOL = 1e-5
B, H, D, RR, R = 2, 2, 16, 4, 8
RATE = 0.1


@pytest.fixture
def interpret():
    old = PA.INTERPRET
    PA.INTERPRET = True
    yield
    PA.INTERPRET = old


def make_case(kind, Lq, Lk, seed=0):
    """(numpy inputs, JAX args, port args) for one attention case."""
    r = np.random.RandomState(seed)
    q = r.randn(B, H, Lq, D).astype(np.float32)
    k = r.randn(B, H, Lk, D).astype(np.float32)
    v = r.randn(B, H, Lk, D).astype(np.float32)
    mask = r.rand(B, 1, 1, Lk) > 0.6
    mask[..., 0] = False                        # every row keeps a valid key
    bias = r.randn(B, H, Lq, Lk).astype(np.float32) if kind == "bias" else None
    rel = None
    if kind == "rel":
        rel = (r.randn(B, Lq, Lk, RR).astype(np.float32),      # raw geometry
               (r.randn(RR, R) * 0.5).astype(np.float32),      # W1 [Rr, R] (JAX layout)
               (r.randn(R) * 0.5).astype(np.float32),
               (r.randn(R, H) * 0.3).astype(np.float32),       # Wr [R, H]
               (r.randn(H) * 0.3).astype(np.float32))
    m = None if kind == "plain" else mask
    jax_args = ([jnp.asarray(a) for a in (q, k, v)],
                dict(mask=None if m is None else jnp.asarray(m),
                     log_bias=None if bias is None else jnp.asarray(bias),
                     rel=None if rel is None else tuple(jnp.asarray(a) for a in rel)))
    t = torch.from_numpy
    port_rel = None
    if rel is not None:
        raw, w1, b1, wr, br = rel
        port_rel = (t(raw), t(w1.T.copy()), t(b1), t(wr.T.copy()), t(br))
    port_args = ([t(a) for a in (q, k, v)],
                 dict(mask=None if m is None else t(m),
                      log_bias=None if bias is None else t(bias), rel=port_rel))
    return jax_args, port_args


CASES = [("plain", 14, 14), ("mask", 14, 14), ("mask", 8, 6), ("bias", 8, 8), ("rel", 8, 8)]


@pytest.mark.parametrize("kind,Lq,Lk", CASES)
def test_port_attention_matches_jax_jnp(kind, Lq, Lk):
    (jq, jkw), (tq, tkw) = make_case(kind, Lq, Lk)
    want = np.asarray(jax_sda(*jq, jkw["mask"], jkw["log_bias"], rel=jkw["rel"]))
    ref = FA.fused_attention_reference(*tq, tkw["mask"], tkw["log_bias"], rel=tkw["rel"])
    sda = scaled_dot_attention(*tq, tkw["mask"], tkw["log_bias"], rel=tkw["rel"])
    assert ref.shape == (B, H, Lq, D)
    np.testing.assert_allclose(ref.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(sda.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind,Lq,Lk", [("mask", 8, 6), ("rel", 8, 8)])
def test_port_attention_matches_pallas_kernel(interpret, kind, Lq, Lk):
    (jq, jkw), (tq, tkw) = make_case(kind, Lq, Lk, seed=1)
    want = np.asarray(PA.fused_attention(*jq, jkw["mask"], jkw["log_bias"], rel=jkw["rel"],
                                         need_draw=False))
    got = FA.fused_attention_reference(*tq, tkw["mask"], tkw["log_bias"], rel=tkw["rel"])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    _, (tq, tkw) = make_case("mask", 8, 6)
    before = dict(FA.LAUNCHES)
    got = FA.fused_attention(*tq, tkw["mask"])
    torch.testing.assert_close(got, FA.fused_attention_reference(*tq, tkw["mask"]),
                               rtol=0, atol=0)
    g = torch.Generator().manual_seed(0)
    leaves = [t.clone().requires_grad_() for t in tq]
    FA.fused_attention(*leaves, tkw["mask"], dropout_r=RATE, generator=g).sum().backward()
    assert FA.LAUNCHES == before                # the CPU path launches nothing
    with pytest.raises(ValueError, match="no kernel"):
        FA.fused_attention(*[a.to("meta") for a in tq])
    with pytest.raises(ValueError, match="log_bias or rel"):
        _, (tq2, tkw2) = make_case("rel", 8, 8)
        FA.fused_attention(*tq2, log_bias=torch.zeros(B, H, 8, 8), rel=tkw2["rel"])


def test_attention_dropout_is_not_ported():
    """Attention dropout is ported; this checks it on the CPU path (the name
    is the one the test had before the port's dropout existed, kept so the
    test keeps its history): the keep rate is 1 - r, the mask
    follows the generator's seed, eval mode and rate 0 drop nothing, and a
    generator is required."""
    r = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(r.randn(4, 4, 50, 50).astype(np.float32)) for _ in range(3))
    v = torch.ones_like(v)                      # o = rowsum(dropped-out a): sees the mask

    def run(seed, train=True, rate=RATE):
        return scaled_dot_attention(q, k, v, dropout_r=rate, train=train,
                                    generator=torch.Generator().manual_seed(seed))

    plain = scaled_dot_attention(q, k, v)
    torch.testing.assert_close(run(0, train=False), plain, rtol=0, atol=0)
    torch.testing.assert_close(run(0, rate=0.0), plain, rtol=0, atol=0)
    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    g = torch.Generator().manual_seed(1)
    keep = torch.rand(4, 4, 50, 50, generator=g) < 1 - RATE   # the draw the CPU path makes
    assert abs(keep.float().mean().item() - (1 - RATE)) < 0.01  # 40000 draws: sd 0.0015
    want = FA.fused_attention_reference(q, k, v, keep=keep, dropout_r=RATE)
    torch.testing.assert_close(run(1), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        scaled_dot_attention(q, k, v, dropout_r=RATE, train=True)


def test_philox_and_keep_mask_reference():
    """The numpy Philox4x32-10 the dropout kernel is held against: the
    Random123 known-answer vectors, and a keep mask with rate 1 - r that
    follows its seed."""
    zeros = FA.philox4x32_10(np.zeros(4, np.uint32), 0)
    assert [int(x) for x in zeros] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    pi = FA.philox4x32_10(np.array([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
                                   np.uint32), 0x299F31D0A4093822)
    assert [int(x) for x in pi] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]
    keep = FA.keep_mask_reference(5, 4, 8, 25, 50, RATE)
    assert keep.shape == (4, 8, 25, 50) and keep.dtype == torch.bool
    assert abs(keep.float().mean().item() - (1 - RATE)) < 0.01     # 40000 draws
    assert torch.equal(keep, FA.keep_mask_reference(5, 4, 8, 25, 50, RATE))
    assert not torch.equal(keep, FA.keep_mask_reference(6, 4, 8, 25, 50, RATE))


def keep_for(Lq, Lk, seed=4):
    return np.random.RandomState(seed).rand(B, H, Lq, Lk) < 1 - RATE


def test_dropout_forward_with_a_given_mask_matches_jnp():
    (jq, jkw), (tq, tkw) = make_case("mask", 8, 6, seed=5)
    keep = keep_for(8, 6)
    jmask = jnp.where(jkw["mask"][:, :, :, :], -1e9, 0.0)
    s = jnp.einsum("bhqd,bhkd->bhqk", jq[0], jq[1]) / math.sqrt(D) + jmask
    want = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1) * keep / (1 - RATE), jq[2])
    got = FA.fused_attention_reference(*tq, tkw["mask"], keep=torch.from_numpy(keep),
                                       dropout_r=RATE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


BWD_CASES = [("sa", "mask", 8, 8), ("ga", "mask", 8, 6), ("bias", "bias", 8, 8),
             ("rsa", "rel", 8, 8)]


@pytest.mark.parametrize("name,kind,Lq,Lk", BWD_CASES)
def test_plain_backward_matches_pallas_bwd(interpret, name, kind, Lq, Lk):
    """Autograd through the plain version, with a keep mask at r 0.1, against
    the Pallas `_bwd_call` (interpret mode) given the same mask: dq, dk, dv,
    dbias, dW1, db1, dWr, dbr and the raw geometry's gradient."""
    (jq, jkw), (tq, tkw) = make_case(kind, Lq, Lk, seed=6)
    keep = keep_for(Lq, Lk)
    do = np.random.RandomState(7).randn(B, H, Lq, D).astype(np.float32)
    jrel = None
    if jkw["rel"] is not None:
        raw, w1, b1, wr, br = jkw["rel"]
        jrel = (tuple(raw[..., c] for c in range(RR)), w1, b1, wr, br)
    mask_add = None if jkw["mask"] is None else jnp.where(jkw["mask"][:, 0, 0, :], -1e9, 0.0)
    dq, dk, dv, dbias, drel = PA._bwd_call(
        *jq, jkw["log_bias"], mask_add, jrel, jnp.asarray(keep, jnp.bfloat16),
        1.0 / math.sqrt(D), RATE, True, jnp.asarray(do))
    want = [dq, dk, dv] + ([dbias] if dbias is not None else [])
    if drel is not None:
        draw, dw1, db1, dwr, dbr = drel
        # port layouts: raw [B,Lq,Lk,Rr], W1 [R,Rr], Wr [H,R]
        want += [jnp.stack(draw, axis=-1), dw1.T, db1, dwr.T, dbr]

    leaves = [t.clone().requires_grad_() for t in tq]
    bias = tkw["log_bias"]
    bias = None if bias is None else bias.clone().requires_grad_()
    rel = None if tkw["rel"] is None else [t.clone().requires_grad_() for t in tkw["rel"]]
    out = FA.fused_attention_reference(*leaves, tkw["mask"], bias, rel=rel,
                                       keep=torch.from_numpy(keep), dropout_r=RATE)
    wrt = leaves + ([bias] if bias is not None else []) + (rel or [])
    got = torch.autograd.grad(out, wrt, torch.from_numpy(do))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    if rel is None:
        return
    # the relation pass's plain twin on its own, for the dpre that autograd
    # gives through the plain forward for the same cotangent: held to the
    # Pallas kernel's relation gradients directly, at the same 1e-5
    raw, w1, b1, wr, br = tkw["rel"]
    pre = (torch.matmul(torch.relu(torch.matmul(raw, w1.t()) + b1), wr.t()) + br)
    pre = pre.permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = FA.fused_attention_reference(*tq, tkw["mask"], torch.log(torch.clamp(torch.relu(pre),
                                                                               min=1e-6)),
                                       keep=torch.from_numpy(keep), dropout_r=RATE)
    dpre = torch.autograd.grad(out, pre, torch.from_numpy(do))[0]
    twin = FA.relation_bwd_reference(raw, w1, b1, wr, br, dpre, need_draw=True)
    for g, w in zip(twin, want[-5:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_rsa_conditioning_tool_on_cpu():
    """tools/rsa_conditioning.py on CPU tensors: the wrapper takes the plain
    version, so kernel and plain agree bit for bit, on the plain chain and
    on the 'kernel's' pre alike; at this small size both sit within 1e-5 of
    the fp64 chain and attention."""
    from mmnas_tpu_torch.tools import rsa_conditioning as RC

    g = torch.Generator().manual_seed(0)
    _, _, _, mask, rel = RC.make_inputs(g, 16, 2, 12)
    valid = (~mask).sum(-1).flatten()
    assert int(valid.min()) >= 8 and bool((~mask[..., 0]).all())
    assert [tuple(t.shape) for t in rel] == [(16, 12, 12, 4), (64, 4), (64,), (2, 64), (2,)]
    (row,) = RC.main(["--device", "cpu", "--B", "4", "--H", "2", "--L", "12"])
    assert row["kernel_vs_plain"] == 0.0 and row["kernel_vs_plain_on_kernel_pre"] == 0.0
    assert row["kernel_vs_fp64"] <= TOL and row["plain_vs_fp64"] <= TOL
    assert row["kernel_pre_vs_fp64"] <= 1e-6 and row["plain_pre_vs_fp64"] <= 1e-6
