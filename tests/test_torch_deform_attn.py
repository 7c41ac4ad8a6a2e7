"""Multi-scale deformable attention in the PyTorch port
(prismer_tpu_torch.experts.ops.deform_attn) against the JAX package on the
CPU: the port's plain version against JAX's gather formulation and against
the TPU kernel `ms_deform_attn_onehot` run in Pallas interpret mode, at the
small shapes and ragged query counts of tests/test_deform_attn_pallas.py,
with out-of-range locations (atol 1e-5: the same sums in another order).
The wrapper takes the plain version for CPU tensors and refuses what the op
does not take. The CUDA kernel itself is held to the plain version on the
card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.experts.ops import deform_attn as jax_da
from prismer_tpu.experts.ops import deform_attn_pallas as jax_dap
from prismer_tpu_torch.experts.ops import deform_attn as port_da

torch.set_num_threads(2)

SHAPES = ((12, 16), (6, 8), (3, 4))


def _inputs(seed, n=2, h=4, d=8, shapes=SHAPES, lq=40, p=4):
    rng = np.random.default_rng(seed)
    s = sum(hl * wl for hl, wl in shapes)
    value = rng.standard_normal((n, s, h, d)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (n, lq, h, len(shapes), p, 2)
                      ).astype(np.float32)
    attn = rng.uniform(0, 1, (n, lq, h, len(shapes), p)).astype(np.float32)
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    return value, loc, attn


def _port(value, loc, attn, shapes=SHAPES):
    return port_da.ms_deform_attn(torch.from_numpy(value), shapes,
                                  torch.from_numpy(loc),
                                  torch.from_numpy(attn)).numpy()


@pytest.mark.parametrize("lq", [40, 37])
@pytest.mark.parametrize("reference", ["gather", "onehot_interpret"])
def test_plain_matches_jax(lq, reference):
    value, loc, attn = _inputs(lq, lq=lq)
    args = (jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(attn))
    if reference == "gather":
        want = jax_da.ms_deform_attn(*args)
    else:
        want = jax_dap.ms_deform_attn_onehot(*args, q_tile=16, c_tile=128,
                                             interpret=True)
    np.testing.assert_allclose(_port(value, loc, attn), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_bilinear_sample_matches_jax():
    """The per-level sampler alone, with coordinates on and past every
    edge of the map."""
    rng = np.random.default_rng(3)
    val = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    x = rng.uniform(-2.0, 8.0, (2, 30)).astype(np.float32)
    y = rng.uniform(-2.0, 6.0, (2, 30)).astype(np.float32)
    x[0, :4] = [-1.0, 0.0, 6.0, 6.5]
    y[0, :4] = [-1.0, 4.0, 4.5, 0.0]
    want = jax_da._bilinear_sample_zero_pad(jnp.asarray(val), jnp.asarray(x),
                                            jnp.asarray(y))
    got = port_da._bilinear_sample_zero_pad(
        torch.from_numpy(val), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    value, loc, attn = _inputs(5)
    before = port_da.ms_deform_attn.launches
    got = _port(value, loc, attn)
    want = port_da.ms_deform_attn_reference(
        torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(attn)).numpy()
    np.testing.assert_array_equal(got, want)
    assert port_da.ms_deform_attn.launches == before


@pytest.mark.parametrize("fault", ["float64", "rank", "levels", "points"])
def test_wrapper_refuses_what_the_op_does_not_take(fault):
    value, loc, attn = (torch.from_numpy(a) for a in _inputs(6))
    shapes = SHAPES
    if fault == "float64":
        value = value.double()
    elif fault == "rank":
        value = value.reshape(2, -1, 32)
    elif fault == "levels":
        shapes = SHAPES[:2] + ((3, 5),)
    else:
        attn = attn[..., :3]
    with pytest.raises(ValueError, match="ms_deform_attn"):
        port_da.ms_deform_attn(value, shapes, loc, attn)
