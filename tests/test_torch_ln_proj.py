"""The port's fused LayerNorm -> projection kernels' plain versions
(prismer_tpu_torch/ops/ln_proj.py) and the `set_ln_proj(True)` wiring,
against the JAX package on the CPU.

`ln_proj` and `adaptor_fused` run as the JAX tests run them: the Pallas
kernels in interpret mode (`interpret=True`), whose rounding points the
port's plain versions follow, and JAX's XLA composition `_ln_proj_ref`,
which applies the activation in bf16 and so differs by bf16 noise. Then a
tiny VisionTransformer and the tiny caption slice with the flag on in both
packages (JAX routes the flag to `_ln_proj_ref` on the CPU). Inputs and
weights come from a numpy seed, at a small width (D 256) and at LARGE's
(D 1024, R 300). Tolerances are those of
tests/test_ln_proj.py: fp32 atol 2e-5, bf16 atol 2e-2 (3e-2 for the
adaptor) with rtol 2e-2, since the two sides sum each product in another
order and a bf16 rounding can flip one ulp of values up to ~30.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.config import VisionEncoderConfig as JaxVisionConfig
from prismer_tpu.models import layers as jax_layers
from prismer_tpu.models import roberta as jax_roberta
from prismer_tpu.models.caption import build_generate_fn
from prismer_tpu.models.vit import VisionTransformer as JaxViT
from prismer_tpu.ops import ln_proj as jax_lp
from prismer_tpu_torch.config import VisionEncoderConfig
from prismer_tpu_torch.convert.from_jax import (jax_path_and_value,
                                                load_jax_variables)
from prismer_tpu_torch.models import layers as port_layers
from prismer_tpu_torch.models.caption import \
    build_generate_fn as port_build_generate_fn
from prismer_tpu_torch.models.vit import VisionTransformer
from prismer_tpu_torch.ops import ln_proj as port_lp
from tests.test_torch_model import (build_pair, instance_slots, prompt_batch,
                                    raw_batch, seeded_variables, to_jax,
                                    to_torch)

torch.set_num_threads(2)

R, D, FS = 600, 256, (256, 256, 512)   # R does not divide the 256-row block
BF16_TOL = {"ln_proj": 2e-2, "adaptor": 3e-2}


def _port(a, dtype):
    """A JAX array as a torch tensor of the same (already rounded) values."""
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _case(seed, r, d, fs, dtype):
    """(JAX args, port args): x (r, d), fp32 LN affine, weights (d, f) for
    JAX and (f, d) for the port, biases (f,), all in `dtype`."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((r, d)), jnp.float32).astype(dtype)
    scale = jnp.asarray(1.0 + 0.1 * rng.standard_normal(d), jnp.float32)
    bias = jnp.asarray(0.1 * rng.standard_normal(d), jnp.float32)
    ws = [jnp.asarray(rng.standard_normal((d, f)) / math.sqrt(d),
                      jnp.float32).astype(dtype) for f in fs]
    bs = [jnp.asarray(0.1 * rng.standard_normal(f), jnp.float32).astype(dtype)
          for f in fs]
    port = (_port(x, dtype), _port(scale, jnp.float32),
            _port(bias, jnp.float32),
            [_port(w, dtype).t().contiguous() for w in ws],
            [_port(b, dtype) for b in bs])
    return (x, scale, bias, ws, bs), port


def _close(got, want, dtype, bf16_tol):
    assert got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                         else torch.float32)
    fp32 = dtype == jnp.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-5 if fp32 else bf16_tol,
                               rtol=1e-6 if fp32 else 2e-2)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("act", [None, "quick_gelu"])
def test_ln_proj_plain_matches_jax_interpret_kernel(dtype, act):
    (x, s, b, ws, bs), port = _case(0, R, D, FS, dtype)
    want = jax_lp.ln_proj(x, s, b, ws, bs, activation=act, block_r=256,
                          interpret=True)
    got = port_lp.ln_proj(*port, activation=act)
    assert len(got) == 3 and port_lp.ln_proj.launches == 0
    for g, w in zip(got, want):
        _close(g, w, dtype, BF16_TOL["ln_proj"])


@pytest.mark.parametrize("act", [None, "quick_gelu"])
def test_ln_proj_plain_close_to_jax_reference_composition(act):
    """bf16: JAX's XLA composition adds the bias and applies the activation
    in bf16, the kernels in fp32 on the rounded product."""
    (x, s, b, ws, bs), port = _case(1, R, D, FS, jnp.bfloat16)
    want = jax_lp._ln_proj_ref(x, s, b, tuple(ws), tuple(bs), act, 1e-5)
    for g, w in zip(port_lp.ln_proj(*port, activation=act), want):
        _close(g, w, jnp.bfloat16, BF16_TOL["ln_proj"])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_adaptor_plain_matches_jax_interpret_kernel(dtype):
    (x, s, b, ws, bs), (px, ps, pb, pws, pbs) = _case(2, R, D, (D, D), dtype)
    want = jax_lp.adaptor_fused(x, s, b, ws[0], bs[0], ws[1], bs[1],
                                block_r=256, interpret=True)
    got = port_lp.adaptor_fused(px, ps, pb, pws[0], pbs[0], pws[1], pbs[1])
    assert port_lp.adaptor_fused.launches == 0
    _close(got, want, dtype, BF16_TOL["adaptor"])


# the LARGE width (ViT-L/14): D 1024, R ragged against the CUDA kernels'
# 128- and 64-row tiles and JAX's 256-row block (300 = 2 x 128 + 44)
R_LARGE, D_LARGE = 300, 1024


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("act", [None, "quick_gelu"])
def test_ln_proj_plain_matches_jax_interpret_kernel_large(dtype, act):
    """q/k/v (3 x D) without an activation, c_fc (4 D) with quick_gelu."""
    fs = (D_LARGE,) * 3 if act is None else (4 * D_LARGE,)
    (x, s, b, ws, bs), port = _case(7, R_LARGE, D_LARGE, fs, dtype)
    want = jax_lp.ln_proj(x, s, b, ws, bs, activation=act, block_r=256,
                          interpret=True)
    got = port_lp.ln_proj(*port, activation=act)
    assert len(got) == len(fs) and port_lp.ln_proj.launches == 0
    for g, w in zip(got, want):
        _close(g, w, dtype, BF16_TOL["ln_proj"])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_adaptor_plain_matches_jax_interpret_kernel_large(dtype):
    (x, s, b, ws, bs), (px, ps, pb, pws, pbs) = _case(
        8, R_LARGE, D_LARGE, (D_LARGE, D_LARGE), dtype)
    want = jax_lp.adaptor_fused(x, s, b, ws[0], bs[0], ws[1], bs[1],
                                block_r=256, interpret=True)
    got = port_lp.adaptor_fused(px, ps, pb, pws[0], pbs[0], pws[1], pbs[1])
    assert port_lp.adaptor_fused.launches == 0
    _close(got, want, dtype, BF16_TOL["adaptor"])


def _grads_close(leaves, want, what):
    for t, w, name in zip(leaves, want, what):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w.T if t.ndim == 2 and
                                   name.startswith("w") else w, atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_ln_proj_gradients_match_jax_custom_vjp():
    (x, s, b, ws, bs), (px, ps, pb, pws, pbs) = _case(3, 96, 128, (128, 256),
                                                      jnp.float32)

    def loss(x, s, b, ws, bs):
        outs = jax_lp.ln_proj(x, s, b, ws, bs, activation="quick_gelu",
                              interpret=True, block_r=32)
        return sum(jnp.sum(o * o) for o in outs)

    gx, gs, gb, gws, gbs = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        x, s, b, tuple(ws), tuple(bs))
    leaves = [t.clone().requires_grad_() for t in (px, ps, pb, *pws, *pbs)]
    outs = port_lp.ln_proj(leaves[0], leaves[1], leaves[2], leaves[3:5],
                           leaves[5:], activation="quick_gelu")
    sum((o * o).sum() for o in outs).backward()
    _grads_close(leaves, (gx, gs, gb, *gws, *gbs),
                 ("x", "scale", "bias", "w0", "w1", "b0", "b1"))


def test_adaptor_gradients_match_jax_custom_vjp():
    (x, s, b, ws, bs), (px, ps, pb, pws, pbs) = _case(4, 96, 128, (128, 128),
                                                      jnp.float32)
    args = (x, s, b, ws[0], bs[0], ws[1], bs[1])
    want = jax.grad(lambda *a: jnp.sum(jnp.square(jax_lp.adaptor_fused(
        *a, interpret=True, block_r=32))), argnums=tuple(range(7)))(*args)
    leaves = [t.clone().requires_grad_()
              for t in (px, ps, pb, pws[0], pbs[0], pws[1], pbs[1])]
    port_lp.adaptor_fused(*leaves).square().sum().backward()
    _grads_close(leaves, want, ("x", "scale", "bias", "wd", "bd", "wu", "bu"))


def test_leading_dims_restored():
    _, (px, ps, pb, pws, pbs) = _case(5, 60, 128, (128, 64), jnp.float32)
    flat = port_lp.ln_proj(px, ps, pb, pws, pbs)
    lead = port_lp.ln_proj(px.reshape(4, 15, 128), ps, pb, pws, pbs)
    for f, l in zip(flat, lead):
        assert l.shape == (4, 15, f.shape[-1])
        torch.testing.assert_close(l.reshape(f.shape), f, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the wiring: VisionTransformer with the flag on in both packages
# ---------------------------------------------------------------------------

VIT = dict(image_resolution=64, patch_size=16, width=128, layers=2, heads=4,
           experts=(("rgb", 3), ("depth", 1)), resampler_layers=1,
           resampler_heads=4, resampler_latents=8)


class _flags:
    """Both packages' set_ln_proj(mode), reset to the default after."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        jax_layers.set_ln_proj(self.mode)
        port_layers.set_ln_proj(self.mode)

    def __exit__(self, *exc):
        jax_layers.set_ln_proj(None)
        port_layers.set_ln_proj(None)


@pytest.fixture(scope="module")
def vit_pair():
    rng = np.random.default_rng(6)
    inputs = {"rgb": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
              "depth": rng.uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)}
    model = JaxViT(cfg=JaxVisionConfig(**VIT), dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), to_jax(inputs))
    variables = seeded_variables(shapes, 7)
    port = VisionTransformer(VisionEncoderConfig(**VIT))
    load_jax_variables(port, variables)
    return model, to_jax(variables), port.eval(), inputs


def _port_grads(port, inputs, train=False):
    port.zero_grad(set_to_none=True)
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in inputs.items()}
    out = port(leaves, train=train)
    out.square().sum().backward()
    return out, leaves


def test_vit_flag_on_matches_jax_flag_on(vit_pair):
    """Outputs within 1e-5, input and parameter gradients within 2e-4 (as
    tests/test_ln_proj.py holds JAX's flag on against off)."""
    model, variables, port, inputs = vit_pair
    with _flags(True):
        def loss(params, x):
            out = model.apply(dict(variables, params=params), x)
            return jnp.sum(out * out), out

        (_, want), (g_params, g_inputs) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                                 to_jax(inputs))
        got, leaves = _port_grads(port, inputs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_inputs[k]),
                                   atol=2e-4, rtol=2e-4, err_msg=k)
    n = 0
    for name, p in port.named_parameters():
        _, path, g = jax_path_and_value(name, p.grad.numpy())
        want_g = g_params
        for key in path:
            want_g = want_g[key]
        np.testing.assert_allclose(g, np.asarray(want_g), atol=2e-4,
                                   rtol=2e-4, err_msg=name)
        n += 1
    assert n == len(jax.tree.leaves(g_params))


@pytest.mark.parametrize("train", [False, True])
def test_vit_flag_on_equals_flag_off_in_the_port(vit_pair, train):
    """On the CPU the fused branch runs the plain versions: flag on equals
    flag off to fp32 noise, outputs and gradients, in eval and in train
    mode (batch statistics, trunk blocks rematerialised around the
    autograd Functions)."""
    port = vit_pair[2]
    inputs = vit_pair[3]
    runs = []
    for mode in (False, True):
        state = {k: v.clone() for k, v in port.state_dict().items()}
        with _flags(mode):
            out, leaves = _port_grads(port, inputs, train)
        grads = {n: p.grad.clone() for n, p in port.named_parameters()}
        runs.append((out.detach(), leaves["rgb"].grad, grads))
        port.load_state_dict(state)   # train mode moves BN statistics
    (o0, x0, g0), (o1, x1, g1) = runs
    torch.testing.assert_close(o1, o0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(x1, x0, rtol=2e-4, atol=2e-4)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=2e-4, atol=2e-4,
                                   msg=name)


def test_state_dict_keys_unchanged_by_the_flag(vit_pair):
    """The flag changes no parameter: the JAX tree loads strictly with it
    on, and the keys are those of a block built with it off."""
    variables = jax.tree.map(np.asarray, vit_pair[1])
    keys = list(vit_pair[2].state_dict())
    with _flags(True):
        port = VisionTransformer(VisionEncoderConfig(**VIT))
        load_jax_variables(port, variables)
    assert list(port.state_dict()) == keys
    assert any(k.endswith("resblocks_0.ln_1.weight") for k in keys)


def test_caption_ids_flag_on_match_jax_flag_on():
    """The tiny six-expert caption slice (fp32, fused decode off, as the
    port runs on the CPU): token ids with the flag on equal JAX's."""
    model, variables, port = build_pair()
    raw = raw_batch(31)
    ids, mask = prompt_batch(31)
    jax_roberta.set_fused_decode("off")
    try:
        with _flags(True):
            want = np.asarray(build_generate_fn(model)(
                variables, to_jax(raw), ids, mask))
            got = port_build_generate_fn(port)(
                to_torch(raw), torch.from_numpy(ids), torch.from_numpy(mask),
                torch.from_numpy(instance_slots()))
    finally:
        jax_roberta.set_fused_decode("auto")
    np.testing.assert_array_equal(got.numpy(), want)
