"""Fused LM-head + label-smoothed CE of the PyTorch port (prismer_tpu_torch)
against the JAX package on the CPU: the port's autograd Function, whose
forward and backward run the plain versions of the `ce_stats` / `ce_grads`
kernels here, against the JAX `fused_label_smoothed_loss` (Pallas in
interpret mode) and `label_smoothed_loss`. Loss and the gradients of h, emb
and bias, fp32, max abs <= 1e-5. The vocab (300) is no multiple of any
tile, one sample has every target ignored, and the prompt is masked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.models.roberta import label_smoothed_loss as jax_ls_loss
from prismer_tpu.ops import fused_ce as jfc
from prismer_tpu_torch.models.roberta import label_smoothed_loss
from prismer_tpu_torch.ops import fused_ce as pfc

torch.set_num_threads(2)

TOL = 1e-5
B, L, D, V = 3, 9, 64, 300


def _inputs(seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, L, D)).astype(np.float32)
    emb = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(V)).astype(np.float32)
    labels = rng.integers(0, V, (B, L)).astype(np.int32)
    labels[:, :3] = -100          # the prompt
    labels[0, -2:] = -100         # right padding
    labels[1, :] = -100           # a sample with nothing to predict
    labels[2, 4] = V - 1          # the last vocab row
    return h, emb, bias, labels


def _port_loss_and_grads(h, emb, bias, labels, fused):
    ts = [torch.from_numpy(x).requires_grad_() for x in (h, emb, bias)]
    lab = torch.from_numpy(labels)
    if fused:
        loss = pfc.fused_label_smoothed_loss(ts[0], ts[1], ts[2], lab)
    else:
        loss = label_smoothed_loss(ts[0] @ ts[1].t() + ts[2], lab)
    loss.sum().backward()
    return loss.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_loss_and_grads(h, emb, bias, labels, fused):
    def f(h_, e_, b_):
        if fused:
            return jfc.fused_label_smoothed_loss(h_, e_, b_,
                                                 jnp.asarray(labels),
                                                 interpret=True)
        return jax_ls_loss(h_ @ e_.T + b_, jnp.asarray(labels))

    loss, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (h, emb, bias)))
    grads = vjp(jnp.ones_like(loss))
    return np.asarray(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("jax_path", ["fused_interpret", "logits"])
def test_fused_loss_and_grads_match_jax(jax_path):
    h, emb, bias, labels = _inputs(0)
    want_loss, want = _jax_loss_and_grads(h, emb, bias, labels,
                                          jax_path == "fused_interpret")
    got_loss, got = _port_loss_and_grads(h, emb, bias, labels, True)
    assert got_loss[1] == 0.0 and np.all(got[0][1] == 0.0)
    np.testing.assert_allclose(got_loss, want_loss, rtol=0, atol=TOL)
    for name, g, w in zip(("h", "emb", "bias"), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)


def test_port_logits_path_matches_fused_path():
    h, emb, bias, labels = _inputs(1)
    loss_f, grads_f = _port_loss_and_grads(h, emb, bias, labels, True)
    loss_p, grads_p = _port_loss_and_grads(h, emb, bias, labels, False)
    np.testing.assert_allclose(loss_f, loss_p, rtol=0, atol=TOL)
    for name, a, b in zip(("h", "emb", "bias"), grads_f, grads_p):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=name)


def test_stats_and_grads_wrappers_are_plain_on_cpu():
    """On CPU tensors `ce_stats` / `ce_grads` are the plain versions and
    count no launch; the stats equal the materialised logits'."""
    h, emb, bias, labels = _inputs(2)
    h2 = torch.from_numpy(h.reshape(-1, D))
    e, bb = torch.from_numpy(emb), torch.from_numpy(bias)
    lab = torch.from_numpy(np.clip(labels.reshape(-1), 0, None))
    before = (pfc.ce_stats.launches, pfc.ce_grads.launches)
    xlab, sumx, lse = pfc.ce_stats(h2, e, bb, lab)
    x = (h2.double() @ e.double().t() + bb.double())
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(x, 1).numpy(),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(sumx.numpy(), x.sum(1).numpy(), rtol=1e-6,
                               atol=TOL)
    np.testing.assert_allclose(
        xlab.numpy(), x.gather(1, lab.long()[:, None])[:, 0].numpy(),
        rtol=0, atol=TOL)
    gv = torch.rand(h2.shape[0], generator=torch.Generator().manual_seed(0))
    dh, demb, dbias = pfc.ce_grads(h2, e, bb, lab, gv, lse, 0.1)
    assert dh.dtype == demb.dtype == dbias.dtype == torch.float32
    assert (pfc.ce_stats.launches, pfc.ce_grads.launches) == before


def test_bf16_gradients_come_back_in_the_operand_dtypes():
    h, emb, bias, labels = _inputs(3)
    hb = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    eb = torch.from_numpy(emb).to(torch.bfloat16).requires_grad_()
    bb = torch.from_numpy(bias).requires_grad_()
    loss = pfc.fused_label_smoothed_loss(hb, eb, bb, torch.from_numpy(labels))
    assert loss.dtype == torch.float32
    loss.sum().backward()
    assert hb.grad.dtype == eb.grad.dtype == torch.bfloat16
    assert bb.grad.dtype == torch.float32


def test_use_fused_ce_rule():
    """auto: the kernels for training on CUDA, the logits path for
    forward-only surfaces and on the CPU; on / off force both surfaces."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    try:
        pfc.set_fused_ce("auto")
        assert pfc.use_fused_ce(True, cuda)
        assert not pfc.use_fused_ce(False, cuda)
        assert not pfc.use_fused_ce(True, cpu)
        pfc.set_fused_ce("on")
        assert pfc.use_fused_ce(False, cpu)
        pfc.set_fused_ce("off")
        assert not pfc.use_fused_ce(True, cuda)
        with pytest.raises(ValueError):
            pfc.set_fused_ce("1")
    finally:
        pfc.set_fused_ce("auto")
