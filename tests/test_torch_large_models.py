"""Prismer-LARGE and Prismer-HUGE in the port, on the CPU: every registry
model's head dims and widths are ones the kernels take, and a patch-14 ViT
(the first patch size the port runs beside BASE's 16) matches the JAX
package.

The patch-14 check is prismer_tiny with all six experts at 64 px, which 14
does not divide: the rgb stem's VALID convolution drops the last 8 pixels,
and the label stems rescale the 224 px maps by 16 / 14 (dense) and 4 / 14
(id maps) before their strided convolutions. fp32 encode outputs to 1e-4,
as tests/test_torch_model.py holds the patch-16 encoder.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.config import build_prismer_config
from prismer_tpu.data.device import materialize_experts
from prismer_tpu.models.prismer import Prismer
from prismer_tpu_torch import config as port_config
from prismer_tpu_torch.convert.from_jax import load_jax_variables
from prismer_tpu_torch.data.device import \
    materialize_experts as port_materialize
from prismer_tpu_torch.models.prismer import Prismer as PortPrismer
from prismer_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS
from prismer_tpu_torch.ops.layer_norm import MAX_DIM, width_ok
from tests.test_torch_model import (instance_slots, raw_batch,
                                    seeded_variables, task_config, to_jax,
                                    to_torch)

torch.set_num_threads(2)

REGISTRY = ("prismer_base", "prismer_large", "prismer_huge")


def _config(model):
    return port_config.build_prismer_config(
        {"experts": port_config.CAPTION_EXPERTS, "image_resolution": 480,
         "prismer_model": model})


@pytest.mark.parametrize("model", REGISTRY)
def test_registry_head_dims_are_kernel_head_dims(model):
    """The flash kernels are built for the trunk's, the resampler's and
    the decoder's head dims of every registry model."""
    cfg = _config(model)
    v, d = cfg.vision, cfg.decoder
    dims = {v.width // v.heads, v.width // v.resampler_heads, d.head_dim}
    assert dims <= set(KERNEL_HEAD_DIMS), (model, dims)
    # the fused decode cross kernel's lane rule: 64 in every decoder
    assert d.head_dim == 64


@pytest.mark.parametrize("model", REGISTRY)
def test_registry_widths_pass_the_layer_norm_width_check(model):
    """ViT widths (768, 1024, 1280) and decoder widths go through the
    LayerNorm kernels (multiple of 8) and ln_proj / adaptor_fused (multiple
    of 64, the encoder's set_ln_proj path)."""
    cfg = _config(model)
    for width in (cfg.vision.width, cfg.decoder.hidden_size):
        assert width_ok(width, 8) and width_ok(width, 64), (model, width)
    assert MAX_DIM == 1280
    assert not width_ok(1344, 64) and not width_ok(1000, 64)


def test_kernel_head_dims_cover_the_registry_and_nothing_unchecked():
    want = set()
    for model in REGISTRY:
        v = _config(model).vision
        want |= {v.width // v.heads, v.width // v.resampler_heads}
    assert want == {64, 80, 96, 128, 160} == set(KERNEL_HEAD_DIMS)


def _patch14(cfg):
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, patch_size=14))


def test_patch14_vit_encode_matches_jax_at_64px():
    jcfg = _patch14(build_prismer_config(task_config()))
    pcfg = _patch14(port_config.build_prismer_config(task_config()))
    assert jcfg.vision.rgb_tokens == pcfg.vision.rgb_tokens == 16
    model = Prismer(jcfg)
    ex = materialize_experts(to_jax(raw_batch(0, batch=1)))
    ones = jnp.ones((1, 4), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), ex, ones, ones)
    variables = seeded_variables(shapes, 5)
    port = PortPrismer(pcfg)
    load_jax_variables(port, variables)
    port.eval()
    raw = raw_batch(2)
    want = np.array(jax.jit(lambda v, r: model.apply(
        v, materialize_experts(r), method=Prismer.encode))(
        to_jax(variables), to_jax(raw)))
    with torch.no_grad():
        got = port.encode(port_materialize(to_torch(raw)),
                          torch.from_numpy(instance_slots())).numpy()
    # 16 rgb tokens + 64 latents; the stems gave the resampler 6 x 16 x 16
    assert got.shape == want.shape == (2, 16 + 64, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
