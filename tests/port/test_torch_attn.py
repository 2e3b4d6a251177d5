"""K4 (ops/attn.py::mha_small_head) on CPU tensors, i.e. its plain PyTorch
version, against the reference's Pallas kernel in interpret mode
(cloudvectordb_tpu/ops/pallas_attn.py), forward and custom-VJP gradients,
on the same numpy inputs: ragged key padding and one fully masked row.

Tolerances: f32 2e-5 on outputs and gradients (the reference's own
interpret-mode test uses 2e-5 and 5e-5; both sides compute the same f32
formulas, summed in different orders). bf16 inputs: the outputs are bf16
on both sides and may differ where the f32 result sits near a rounding
boundary, so by at most one bf16 step of the largest value (2^-7 x max)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudvectordb_tpu.ops.pallas_attn import mha_small_head as jax_mha
from cloudvectordb_tpu_torch.ops import attn

CASES = [(2, 128, 4, 16), (2, 256, 2, 32)]  # (B, L, H, d)


def _inputs(b, length, h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, length, h * d)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, length), np.int32)
    mask[0, length - 37:] = 0  # ragged key padding
    mask[1, :] = 0  # a fully masked row: the mean of v over all L keys
    return q, k, v, mask, do


def _jax(q, k, v, mask, do, h, d, dtype):
    scale = d ** -0.5
    cast = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
    args = (cast(q), cast(k), cast(v))
    m = jnp.asarray(mask)
    out, vjp = jax.vjp(lambda a, b, c: jax_mha(a, b, c, m, h, d, scale, True), *args)
    grads = vjp(cast(do))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch(q, k, v, mask, do, h, d, dtype):
    ts = [torch.tensor(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    before = (attn.mha_small_head.launches, attn.mha_small_head.bwd_launches)
    out = attn.mha_small_head(*ts, torch.tensor(mask), h, d, d ** -0.5)
    grads = torch.autograd.grad(out, ts, torch.tensor(do).to(dtype))
    assert (attn.mha_small_head.launches, attn.mha_small_head.bwd_launches) == before
    assert out.dtype == dtype and all(g.dtype == dtype for g in grads)
    return [x.detach().float().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("b,length,h,d", CASES)
def test_plain_forward_and_backward_match_the_reference_f32(b, length, h, d):
    q, k, v, mask, do = _inputs(b, length, h, d, seed=length + d)
    ref = _jax(q, k, v, mask, do, h, d, jnp.float32)
    got = _torch(q, k, v, mask, do, h, d, torch.float32)
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, r, atol=2e-5, rtol=0, err_msg=name)
    # the fully masked row is the mean of v, as the reference gives
    np.testing.assert_allclose(got[0][1], np.broadcast_to(
        v[1].reshape(length, h, d).mean(0).reshape(-1), (length, h * d)), atol=1e-5)


@pytest.mark.parametrize("b,length,h,d", CASES)
def test_plain_forward_and_backward_match_the_reference_bf16(b, length, h, d):
    q, k, v, mask, do = _inputs(b, length, h, d, seed=7 + d)
    ref = _jax(q, k, v, mask, do, h, d, jnp.bfloat16)
    got = _torch(q, k, v, mask, do, h, d, torch.bfloat16)
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
        assert np.abs(a - r).max() <= 2.0 ** -7 * np.abs(r).max(), name


def test_plain_backward_is_not_autograd_of_the_forward():
    """The custom backward agrees with autograd through the plain forward
    where the two must agree (no fully masked row)."""
    q, k, v, mask, do = _inputs(2, 128, 4, 16, seed=3)
    mask[1] = 1
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = attn._fwd_plain(*ts, torch.tensor(mask), 4, 16, 0.25)
    auto = torch.autograd.grad(out, ts, torch.tensor(do))
    custom = attn._bwd_plain(*(torch.tensor(a) for a in (q, k, v)), torch.tensor(mask),
                             torch.tensor(do), 4, 16, 0.25)
    for a, c in zip(auto, custom):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-5)


def test_bad_shapes_raise():
    x = torch.zeros(2, 128, 64)
    with pytest.raises(ValueError):
        attn.mha_small_head(x, x, x, torch.ones(2, 128), 4, 32, 1.0)
    with pytest.raises(ValueError):
        attn.mha_small_head(x, x, x, torch.ones(2, 64), 4, 16, 1.0)
    with pytest.raises(TypeError):
        attn.mha_small_head(x, x, x.half(), torch.ones(2, 128), 4, 16, 1.0)
