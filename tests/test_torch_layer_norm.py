"""The port's fused LayerNorm (prismer_tpu_torch/ops/layer_norm.py) against
the JAX package's Pallas kernel (prismer_tpu/ops/layer_norm.py), run in
interpret mode on the CPU as its own tests run it, and its gradient against
JAX's custom_vjp. Inputs from a numpy seed; fp32 atol 2e-5, bf16 atol 2e-2
(with rtol 2e-2: the two sides sum the fp32 statistics in another order, so
the final bf16 rounding can flip one ulp, ~0.8 % relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.ops import layer_norm as jax_ln
from prismer_tpu_torch.models import layers as port_layers
from prismer_tpu_torch.ops import layer_norm as port_ln

torch.set_num_threads(2)


def _case(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return jx, jnp.asarray(scale), jnp.asarray(bias), tx, \
        torch.from_numpy(scale), torch.from_numpy(bias)


@pytest.mark.parametrize("rows,d,dtype,tol", [
    (300, 256, jnp.float32, 2e-5),    # does not divide the 512-row block
    (256, 256, jnp.bfloat16, 2e-2),
    (37, 64, jnp.float32, 2e-5),
])
def test_plain_matches_jax_interpret_kernel(rows, d, dtype, tol):
    jx, js, jb, tx, ts, tb = _case(rows, (rows, d), dtype)
    want = jax_ln._ln_forward(jx, js, jb, 1e-5, interpret=True)
    got = port_ln.fused_layer_norm(tx, ts, tb)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    assert port_ln.fused_layer_norm.launches == 0   # the CPU runs no kernel


def test_plain_is_the_models_layer_norm():
    """One LayerNorm definition: the model's LayerNorm module and the
    kernel's plain version."""
    assert port_layers.fp32_layer_norm is port_ln.fp32_layer_norm
    _, _, _, tx, ts, tb = _case(1, (4, 9, 128), jnp.float32)
    ln = port_layers.LayerNorm(128)
    with torch.no_grad():
        ln.weight.copy_(ts)
        ln.bias.copy_(tb)
        torch.testing.assert_close(port_ln.fused_layer_norm(tx, ts, tb),
                                   ln(tx), rtol=0, atol=0)


def test_gradient_matches_jax_custom_vjp():
    jx, js, jb, tx, ts, tb = _case(3, (2, 50, 128), jnp.float32)
    gj = jax.grad(lambda x, s, b: jnp.sum(
        jax_ln.fused_layer_norm(x, s, b) ** 2), argnums=(0, 1, 2))(jx, js, jb)
    leaves = [t.clone().requires_grad_() for t in (tx, ts, tb)]
    port_ln.fused_layer_norm(*leaves).pow(2).sum().backward()
    for name, g, t in zip(("x", "scale", "bias"), gj, leaves):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-5,
                                   rtol=2e-5, err_msg=name)


def test_bf16_gradient_dtypes_and_formula():
    """dx in x's dtype, dscale / dbias in the parameters' dtype, from the
    fp32 formula (JAX `_ln_bwd`) on the bf16 values."""
    jx, js, jb, tx, ts, tb = _case(4, (3, 11, 64), jnp.bfloat16)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 11, 64)).astype(np.float32)).to(torch.bfloat16)
    leaves = [tx.clone().requires_grad_(), ts.clone().requires_grad_(),
              tb.clone().requires_grad_()]
    port_ln.fused_layer_norm(*leaves).backward(g)
    _, vjp = jax.vjp(
        lambda x, s, b: jax_ln.fused_layer_norm(x, s, b), jx, js, jb)
    want = vjp(jnp.asarray(g.float().numpy()).astype(jnp.bfloat16))
    assert [t.grad.dtype for t in leaves] == [torch.bfloat16, torch.float32,
                                              torch.float32]
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=2e-2, rtol=2e-2)
