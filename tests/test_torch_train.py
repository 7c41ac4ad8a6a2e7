"""The caption fine-tune step of the PyTorch port (prismer_tpu_torch.train)
against the JAX package's `build_train_step` on the CPU.

prismer_tiny with a dense expert (so the stems' BatchNorms run in train
mode) and obj_detection (random instance slots), 64 px, batch 2, a ragged
right-padded caption batch with a masked prompt, freeze_vision, dropout 0
(prismer_tiny's). JAX runs its Pallas kernels in interpret mode
(`set_attention_impl("flash")`, `set_fused_ce("on")`); the port forces its
fused CE path so both sides take the kernels' plain versions here. The
instance slots JAX's step draws (from the module-folded 'instance' stream,
recorded by a debug callback) are handed to the port's step. Weights come
from a numpy seed in the JAX variable tree.

Stated tolerances: loss 1e-5 rel; gradients 1e-4 rel L2 per trainable leaf
(compared through the inverse name map; a key projection's bias shifts
every score of a query by the same amount, so its gradient is zero in exact
arithmetic and is held relative to its weight's gradient instead); the
update after two steps 1e-3
rel L2 per leaf (Adam's first steps are near sign(g), so a gradient that
differs in its last bits can flip a near-zero element); batch statistics
1e-5; frozen leaves bitwise unchanged.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prismer_tpu.config import build_prismer_config
from prismer_tpu.data.device import materialize_experts
from prismer_tpu.models import layers as jax_layers
from prismer_tpu.models import vit as jax_vit
from prismer_tpu.models.prismer import Prismer, compute_dtype
from prismer_tpu.models.vit import draw_instance_slots
from prismer_tpu.ops import fused_ce as jax_fused_ce
from prismer_tpu.train import TrainState as JaxTrainState
from prismer_tpu.train import build_eval_loss_step as jax_eval_step
from prismer_tpu.train import build_train_step as jax_train_step
from prismer_tpu.train import checkpoint as jax_checkpoint
from prismer_tpu.train import freeze_labels, make_optimizer
from prismer_tpu.train import schedules as jax_schedules
from prismer_tpu.train.step import _merge_frozen
from prismer_tpu_torch import config as port_config
from prismer_tpu_torch.convert.from_jax import (jax_path_and_value,
                                                load_jax_masters,
                                                load_jax_variables)
from prismer_tpu_torch.models import layers as port_layers
from prismer_tpu_torch.models import prismer as port_prismer
from prismer_tpu_torch.models import vit as port_vit
from prismer_tpu_torch.models.caption import caption_targets
from prismer_tpu_torch.models.vit import BatchNorm
from prismer_tpu_torch.ops import fused_ce as port_fused_ce
from prismer_tpu_torch.train import TrainState as PortTrainState
from prismer_tpu_torch.train import build_eval_loss_step, build_train_step
from prismer_tpu_torch.train import checkpoint as port_checkpoint
from prismer_tpu_torch.train import optim as port_optim
from prismer_tpu_torch.train import schedules as port_schedules
from tests.test_torch_model import raw_batch, seeded_variables, to_torch

torch.set_num_threads(2)

EXPERTS = ["depth", "obj_detection"]
RES = 64
LR = 1e-4
WD = 0.05
STEPS_PER_EPOCH = 5
PROMPT = 2
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_UPDATE = 1e-3
TOL_STATS = 1e-5
# bf16 step against JAX's bf16 step: two bf16 computations of the same
# network round in different places. The loss to 1e-2 rel; each gradient no
# further from the fp32 gradient than 2x JAX's bf16 gradient is
TOL_BF16_LOSS = 1e-2
TOL_BF16_GRAD_RATIO = 2.0


def task(dtype):
    return dict(port_config.tiny_test_config(EXPERTS, RES), dtype=dtype)


def caption_batch(seed, vocab=512):
    """Raw experts plus a ragged right-padded caption batch (lengths 7 and
    5 of 7) with the prompt and pads masked in the targets."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (2, 7)).astype(np.int32)
    ids[:, 0] = 0
    mask = np.ones_like(ids)
    ids[1, 5:], mask[1, 5:] = 1, 0
    targets = np.where(ids == 1, -100, ids)
    targets[:, :PROMPT] = -100
    return {"experts": raw_batch(seed, batch=2), "input_ids": ids,
            "attention_mask": mask, "targets": targets.astype(np.int32)}


def jax_batch(batch):
    return jax.tree.map(jnp.asarray, batch)


def port_batch(batch):
    return {k: to_torch(v) for k, v in batch.items()}


def build_jax(dtype, seed=0):
    cfg = build_prismer_config(task(dtype))
    model = Prismer(cfg)
    b = jax_batch(caption_batch(0))
    ex = materialize_experts(jax.tree.map(lambda x: x[:1], b["experts"]))
    ones = jnp.ones((1, 7), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), ex, ones, ones)
    return cfg, model, seeded_variables(shapes, seed)


def build_port(variables_np, dtype, freeze="freeze_vision", lr=LR):
    cfg = port_config.build_prismer_config(task(dtype))
    port = port_prismer.Prismer(cfg)
    load_jax_variables(port, variables_np)
    masters = load_jax_masters(port, variables_np)
    schedule = port_schedules.per_step_cosine(lr, 0.0, STEPS_PER_EPOCH, 1)
    state = PortTrainState.create(port, schedule, WD, freeze, masters)
    return port, state


class JaxRun:
    """The JAX side: build_train_step plus the same loss's gradients."""

    def __init__(self, cfg, model, variables_np, freeze="freeze_vision",
                 lr=LR):
        variables = jax.tree.map(jnp.asarray, variables_np)
        params = variables["params"]
        schedule = jax_schedules.per_step_cosine(lr, 0.0, STEPS_PER_EPOCH, 1)
        self.labels = freeze_labels(params, freeze)
        self.tx = tx = make_optimizer(schedule, WD, params, freeze)
        self.state = JaxTrainState.create(params, tx,
                                          variables["batch_stats"],
                                          rng=jax.random.key(7))
        self.step_fn = jax_train_step(model, tx, freeze_tree=self.labels,
                                      donate=False)
        dtype = compute_dtype(cfg)

        def loss_fn(p, stats, batch, drop_rng, inst_rng):
            experts = materialize_experts(batch["experts"], dtype)
            per_sample, _ = model.apply(
                {"params": _merge_frozen(p, self.labels),
                 "batch_stats": stats}, experts, batch["input_ids"],
                batch["attention_mask"], batch["targets"], train=True,
                rngs={"dropout": drop_rng, "instance": inst_rng},
                method=Prismer.forward_loss, mutable=["batch_stats"])
            return jnp.mean(per_sample)

        self.grad_fn = jax.jit(jax.grad(loss_fn))

    def step(self, batch):
        """(instance slots, grads, loss) of one step; advances the state.
        The slots are the ones the encoder drew (`record_instance_slots`)."""
        _, drop_rng, inst_rng = jax.random.split(self.state.rng, 3)
        grads = self.grad_fn(self.state.params, self.state.batch_stats,
                             batch, drop_rng, inst_rng)
        jax.effects_barrier()
        slots = DRAWN_SLOTS[-1]
        self.state, metrics = self.step_fn(self.state, batch)
        return slots, grads, float(metrics["loss"])


DRAWN_SLOTS = []


def record_instance_slots(monkeypatch):
    """Record every instance-slot draw of the JAX encoder: its key is
    make_rng('instance') folded with the module path, not the step's
    'instance' key itself."""
    real = jax_vit.draw_instance_slots
    DRAWN_SLOTS.clear()

    def recording(key, *args):
        slots = real(key, *args)
        jax.debug.callback(lambda s: DRAWN_SLOTS.append(np.asarray(s)),
                           slots)
        return slots

    monkeypatch.setattr(jax_vit, "draw_instance_slots", recording)


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree, np.float64)


def _rel(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if scale is None:
        scale = np.linalg.norm(want)
    return np.linalg.norm(got - want) / max(scale, 1e-30)


def _grad_rel(name, got, jgrads):
    """rel L2 of a port gradient against JAX's; a key bias (zero gradient
    in exact arithmetic: softmax ignores a per-query constant) against the
    norm of its projection weight's gradient."""
    _, path, value = jax_path_and_value(name, got.numpy())
    scale = None
    if name.endswith(("key.bias", "k_proj.bias")):
        _, wpath, _ = jax_path_and_value(name[:-len("bias")] + "weight",
                                         np.zeros((1, 1)))
        scale = np.linalg.norm(_leaf(jgrads, wpath))
    return _rel(value, _leaf(jgrads, path), scale)


@pytest.fixture
def kernels_plain():
    """Both packages through their attention and fused-CE kernel paths."""
    jax_layers.set_attention_impl("flash")
    jax_fused_ce.set_fused_ce("on")
    port_fused_ce.set_fused_ce("on")
    try:
        yield
    finally:
        jax_layers.set_attention_impl(None)
        jax_fused_ce.set_fused_ce("auto")
        port_fused_ce.set_fused_ce("auto")


def _run_both(monkeypatch, dtype, steps, lr=LR):
    record_instance_slots(monkeypatch)
    cfg, model, variables_np = build_jax(dtype)
    jrun = JaxRun(cfg, model, variables_np, lr=lr)
    port, state = build_port(variables_np, dtype, lr=lr)
    step = build_train_step(port)
    batch = caption_batch(1)
    jb, pb = jax_batch(batch), port_batch(batch)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    masters0 = {n: m.clone() for n, m in state.masters.items()}
    out = []
    for _ in range(steps):
        slots, jgrads, jloss = jrun.step(jb)
        monkeypatch.setattr(port_prismer, "draw_instance_slots",
                            lambda *a, s=slots: torch.from_numpy(s.copy()))
        state, metrics = step(state, pb)
        pgrads = {n: leaf.grad.clone() for n, leaf in state.trainable()}
        out.append((jloss, float(metrics["loss"]), jgrads, pgrads))
    return jrun, port, state, before, masters0, variables_np, out


def test_two_steps_match_jax_build_train_step(kernels_plain, monkeypatch):
    jrun, port, state, before, _, variables_np, steps = _run_both(
        monkeypatch, "float32", 2)
    for k, (jloss, ploss, jgrads, pgrads) in enumerate(steps):
        assert abs(ploss - jloss) <= TOL_LOSS * abs(jloss), (k, ploss, jloss)
        assert len(pgrads) > 40
        for name, g in pgrads.items():
            rel = _grad_rel(name, g, jgrads)
            assert rel <= TOL_GRAD, (k, name, rel)
    # params after two steps: the update, per trainable leaf
    after = state.params_fp32()
    for name, label in state.labels.items():
        _, path, now = jax_path_and_value(name, after[name].numpy())
        start = _leaf(variables_np["params"], path)
        want = _leaf(jrun.state.params, path)
        if label == port_optim.FROZEN:
            assert torch.equal(port.get_parameter(name), before[name]), name
            np.testing.assert_array_equal(want, start)
        elif name.endswith(("key.bias", "k_proj.bias")):
            # Adam scales a rounding-noise gradient to +-lr per step on
            # both sides: only its size is determined
            assert np.abs(now - start).max() <= 2 * LR * (1 + WD), name
        else:
            rel = _rel(now - start, want - start)
            assert rel <= TOL_UPDATE, (name, rel)
    # the stems' BatchNorm running statistics after two train-mode steps
    n_bn = 0
    for key, t in port.state_dict().items():
        coll, path, value = jax_path_and_value(key, t.numpy())
        if coll == "batch_stats":
            np.testing.assert_allclose(
                value, _leaf(jrun.state.batch_stats, path), rtol=TOL_STATS,
                atol=TOL_STATS, err_msg=key)
            assert not np.array_equal(
                value, _leaf(variables_np["batch_stats"], path)), key
            n_bn += 1
    assert n_bn == 16
    assert state.step == 2


def _port_layout(name, value):
    """A flax-layout leaf in the port's layout (inverse of
    jax_path_and_value's transposes)."""
    if name.endswith(".weight") and value.ndim == 2:
        return value.T
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value


def _flax_tree(grads, like):
    """Port gradients (by name) in the flax tree of `like`; zeros for
    leaves without one (the frozen ones)."""
    tree = jax.tree.map(np.zeros_like, like)
    for name, g in grads.items():
        _, path, value = jax_path_and_value(name, g.numpy())
        node = tree
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = value
    return tree


def test_bf16_update_matches_jax_fp32_params(kernels_plain, monkeypatch):
    """The fault and its repair: one bf16 train step at lr 5e-5. With fp32
    masters the port's update (fp32 params after minus before) is JAX's:
    the optimizer of JAX's build_train_step (optax AdamW under
    multi_transform on fp32 params, flax casting at use) applied to the
    step's gradient, to rel L2 <= 1e-2 on every trainable leaf. AdamW
    applied to the bf16-stored weights themselves rounds the update away:
    most of those weights do not move.

    The gradient is the port's own. Adam's first update is lr * sign(g), so
    elements whose gradient lies within bf16 rounding of zero take the
    other sign in any other bf16 computation of the same step. The port's
    bf16 gradient is held instead to be no further from the step's fp32
    gradient than JAX's bf16 gradient is, within TOL_BF16_GRAD_RATIO (the
    stems' train-mode BatchNorm backward subtracts means, so their bf16
    gradients sit 5-15 % from fp32 in both packages)."""
    lr = 5e-5
    jrun, port, state, before, masters0, variables_np, steps = _run_both(
        monkeypatch, "bfloat16", 1, lr=lr)
    jloss, ploss, jgrads, pgrads = steps[0]
    assert abs(ploss - jloss) <= TOL_BF16_LOSS * abs(jloss), (ploss, jloss)
    # the step's fp32 gradient: the port's fp32 step on the same weights,
    # batch and slots (held to JAX's fp32 step at 1e-4 by the test above)
    port32, state32 = build_port(variables_np, "float32", lr=lr)
    build_train_step(port32)(state32, port_batch(caption_batch(1)))
    g32 = _flax_tree({n: leaf.grad for n, leaf in state32.trainable()},
                     variables_np["params"])
    for name, g in pgrads.items():
        d_port = _grad_rel(name, g, g32)
        _, path, _ = jax_path_and_value(name, g.numpy())
        d_jax = _grad_rel(name, torch.from_numpy(np.asarray(
            _port_layout(name, _leaf(jgrads, path)))), g32)
        assert d_port <= TOL_BF16_GRAD_RATIO * d_jax, (name, d_port, d_jax)
    params = jax.tree.map(jnp.asarray, variables_np["params"])
    updates, _ = jrun.tx.update(
        jax.tree.map(jnp.asarray, _flax_tree(pgrads, variables_np["params"])),
        jrun.tx.init(params), params)
    jax_after = optax.apply_updates(params, updates)
    after = state.params_fp32()
    naive_far = 0
    for name, master in state.masters.items():
        _, path, now = jax_path_and_value(name, after[name].numpy())
        start = _leaf(variables_np["params"], path)
        want = _leaf(jax_after, path) - start
        rel = _rel(now - start, want)
        assert rel <= 1e-2, (name, rel)
        # the weights themselves follow the masters, rounded
        assert torch.equal(port.get_parameter(name),
                           master.to(torch.bfloat16))
        # without masters: AdamW on the bf16 weight with the same gradient
        w = before[name].clone().requires_grad_()
        w.grad = pgrads[name].to(torch.bfloat16)
        opt = torch.optim.AdamW([w], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=WD)
        opt.step()
        _, _, naive = jax_path_and_value(
            name, (w.detach().float() - masters0[name]).numpy())
        naive_far += _rel(naive, want) > 0.5
    assert len(state.masters) > 40
    assert naive_far >= len(state.masters) // 2, naive_far


def test_train_state_needs_masters_for_low_precision_leaves():
    cfg = port_config.build_prismer_config(task("bfloat16"))
    model = port_prismer.build_random_prismer(cfg, 0, device="cpu")
    sched = port_schedules.per_step_cosine(LR, 0.0, 10, 1)
    with pytest.raises(ValueError, match="masters"):
        PortTrainState.create(model, sched, WD, "freeze_vision")
    masters = port_prismer.random_masters(model, 0)
    state = PortTrainState.create(model, sched, WD, "freeze_vision", masters)
    for name, m in state.masters.items():
        assert m.dtype == torch.float32
        assert state.labels[name] == port_optim.TRAIN
        assert torch.equal(m.to(torch.bfloat16), model.get_parameter(name))
    # the optimizer holds exactly the trainable fp32 leaves
    leaves = [p for g in state.optimizer.param_groups for p in g["params"]]
    assert all(p.dtype == torch.float32 for p in leaves)
    assert len(leaves) == sum(1 for v in state.labels.values()
                              if v == port_optim.TRAIN)


@pytest.mark.parametrize("mode", ["freeze_lang", "freeze_vision",
                                  "freeze_lang_vision"])
def test_freeze_partitions_equal_jax(mode):
    _, _, variables_np = build_jax("float32")
    port = port_prismer.Prismer(port_config.build_prismer_config(
        task("float32")))
    want = freeze_labels(variables_np["params"], mode)
    got = port_optim.freeze_labels((n for n, _ in port.named_parameters()),
                                   mode)
    assert len(got) == len(jax.tree.leaves(want))
    shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    for name, label in got.items():
        _, path, _ = jax_path_and_value(name, np.zeros(shapes[name]))
        node = want
        for p in path:
            node = node[p]
        assert node == label, (mode, name)
    counts = port_optim.count_params(port, got)
    assert 0 < counts["trainable"] < counts["total"]


def test_schedules_equal_jax():
    cases = [
        (port_schedules.cosine_schedule(5e-5, 1e-6, 1000),
         jax_schedules.cosine_schedule(5e-5, 1e-6, 1000)),
        (port_schedules.warmup_schedule(1e-6, 3e-4, 2000),
         jax_schedules.warmup_schedule(1e-6, 3e-4, 2000)),
        (port_schedules.step_schedule(1e-4, 1e-6, 0.5),
         jax_schedules.step_schedule(1e-4, 1e-6, 0.5)),
        (port_schedules.pretrain_schedule(1e-4, 1e-6, 1e-6, 300, 1000, 10),
         jax_schedules.pretrain_schedule(1e-4, 1e-6, 1e-6, 300, 1000, 10)),
        (port_schedules.per_step_cosine(5e-5, 0.0, 250, 3),
         jax_schedules.per_step_cosine(5e-5, 0.0, 250, 3)),
    ]
    for port_fn, jax_fn in cases:
        for s in (0, 1, 7, 299, 300, 749, 1000, 2500, 9999):
            want = float(jax_fn(jnp.asarray(s, jnp.int32)))
            # JAX evaluates the formulas in fp32, the port in Python floats
            assert math.isclose(port_fn(s), want, rel_tol=1e-5,
                                abs_tol=1e-12), (s, port_fn(s), want)


def test_eval_loss_equals_jax_eval_step(monkeypatch):
    """Eval loss (BatchNorm running statistics, no dropout, the plain logits
    path). JAX's eval draws the instance slots from a fixed key and the
    port's fixed draw is its own, so the port is handed JAX's draw."""
    cfg, model, variables_np = build_jax("float32")
    batch = caption_batch(2)
    want = float(jax_eval_step(model)(jax.tree.map(jnp.asarray,
                                                   variables_np),
                                      jax_batch(batch)))
    port, _ = build_port(variables_np, "float32")
    slots = np.asarray(draw_instance_slots(jax.random.key(0), 256, 128))
    monkeypatch.setattr(port_vit, "draw_instance_slots",
                        lambda *a: torch.from_numpy(slots.copy()))
    stats = {k: t.clone() for k, t in port.state_dict().items()
             if "running" in k}
    got = float(build_eval_loss_step(port)(port_batch(batch)))
    assert abs(got - want) <= TOL_LOSS * abs(want), (got, want)
    for k, t in stats.items():                 # eval mutates nothing
        assert torch.equal(port.state_dict()[k], t), k
    assert not port_fused_ce.use_fused_ce(False, torch.device("cuda"))


def test_checkpoint_restore_continue_equals_uninterrupted(tmp_path):
    """bf16 model with masters: save after one step, restore into a fresh
    state, take a step; equal to two uninterrupted steps, bit for bit."""
    cfg = port_config.build_prismer_config(task("bfloat16"))
    batch = port_batch(caption_batch(3))

    def fresh():
        model = port_prismer.build_random_prismer(cfg, 4, device="cpu")
        sched = port_schedules.per_step_cosine(LR, 0.0, 10, 1)
        return PortTrainState.create(model, sched, WD, "freeze_vision",
                                     port_prismer.random_masters(model, 4),
                                     seed=11)

    a = fresh()
    step_a = build_train_step(a.model)
    step_a(a, batch)
    path = str(tmp_path / "state.pt")
    port_checkpoint.save_checkpoint(path, a, {"epoch": 0, "best_cider": 1.5})
    loss_a = float(step_a(a, batch)[1]["loss"])

    b = fresh()
    b, meta = port_checkpoint.restore_checkpoint(path, b)
    assert meta == {"epoch": 0, "best_cider": 1.5} and b.step == 1
    loss_b = float(build_train_step(b.model)(b, batch)[1]["loss"])
    assert loss_a == loss_b
    for (n, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), n
    for n in a.masters:
        assert torch.equal(a.masters[n], b.masters[n]), n
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_params_npz_crosses_between_packages(tmp_path):
    _, _, variables_np = build_jax("float32")
    # freeze "none": every bf16-stored leaf has its fp32 master (a frozen
    # leaf keeps only its stored precision)
    port, state = build_port(variables_np, "bfloat16", freeze="none")
    path = str(tmp_path / "params.npz")
    port_checkpoint.save_params_npz(path, state.params_fp32())
    tree = jax_checkpoint.load_params_npz(path)
    flat_want = jax.tree_util.tree_flatten_with_path(variables_np["params"])[0]
    for keypath, value in flat_want:
        node = tree
        for k in keypath:
            node = node[k.key]
        np.testing.assert_array_equal(node, value)
    jpath = str(tmp_path / "jax.npz")
    jax_checkpoint.save_params_npz(jpath, variables_np["params"])
    back = port_checkpoint.load_params_npz(jpath)
    assert jax.tree.structure(back) == jax.tree.structure(tree)


def test_freeze_vision_npz_keeps_frozen_leaves_fp32(tmp_path, monkeypatch):
    """The bf16 model under freeze_vision, one train step: the exported
    .npz holds the frozen ViT leaves at full precision, bit for bit the
    JAX package's .npz of its params (a frozen leaf never moves there,
    test_two_steps_match_jax_build_train_step), not their bf16 rounding."""
    _, _, variables_np = build_jax("float32")
    port, state = build_port(variables_np, "bfloat16")
    monkeypatch.setattr(port_prismer, "draw_instance_slots",
                        lambda *a: torch.arange(256) % 128)
    state, _ = build_train_step(port)(state, port_batch(caption_batch(1)))
    assert state.step == 1 and state.frozen_fp32
    path, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    port_checkpoint.save_params_npz(path, state.params_fp32())
    jax_checkpoint.save_params_npz(jpath, variables_np["params"])
    got, want = np.load(path), np.load(jpath)
    assert set(got.files) == set(want.files)
    frozen = [n for n, label in state.labels.items()
              if label == port_optim.FROZEN
              and port.get_parameter(n).dtype == torch.bfloat16]
    assert len(frozen) > 10
    for name in frozen:
        _, jpath_parts, _ = jax_path_and_value(
            name, np.zeros(port.get_parameter(name).shape))
        key = "".join(f"['{p}']" for p in jpath_parts)
        np.testing.assert_array_equal(got[key], want[key], err_msg=name)
        assert got[key].dtype == np.float32
        rounded = port.get_parameter(name).float().numpy()
        assert not np.array_equal(_port_layout(name, got[key]), rounded), name
    # the optimizer's leaves are the trainable ones only, as before
    assert {n for n, _ in state.trainable()} == {
        n for n, label in state.labels.items() if label != port_optim.FROZEN}


def test_caption_loss_equals_jax_caption_loss(monkeypatch):
    """The task head's eval loss (pads and prompt masked, mean of the
    per-sample sums) against JAX's caption_loss, JAX's fixed slot draw
    handed to the port."""
    from prismer_tpu.models.caption import caption_loss as jax_caption_loss
    from prismer_tpu_torch.data.device import materialize_experts as pm
    from prismer_tpu_torch.models.caption import caption_loss
    cfg, model, variables_np = build_jax("float32")
    batch = caption_batch(5)
    jb, pb = jax_batch(batch), port_batch(batch)
    want = float(jax_caption_loss(
        model, jax.tree.map(jnp.asarray, variables_np),
        materialize_experts(jb["experts"]), jb["input_ids"],
        jb["attention_mask"], PROMPT, train=False))
    port, _ = build_port(variables_np, "float32")
    slots = np.asarray(draw_instance_slots(jax.random.key(0), 256, 128))
    monkeypatch.setattr(port_vit, "draw_instance_slots",
                        lambda *a: torch.from_numpy(slots.copy()))
    with torch.no_grad():
        got = float(caption_loss(port, pm(pb["experts"]), pb["input_ids"],
                                 pb["attention_mask"], PROMPT, train=False))
    assert abs(got - want) <= TOL_LOSS * abs(want), (got, want)


def test_metrics_logger_writes_jax_records(tmp_path):
    from prismer_tpu.train.metrics import MetricsLogger as JaxLogger
    from prismer_tpu_torch.train.metrics import MetricsLogger
    import json
    for cls, name in ((MetricsLogger, "port"), (JaxLogger, "jax")):
        logger = cls(str(tmp_path / "logs"), name)
        logger.log({"step": 1, "loss": 2.5})
        logger.log({"step": 2, "loss": 2.25})
        cls(str(tmp_path / "off"), name, enabled=False).log({"step": 1})
    lines = {n: [json.loads(x) for x in
                 (tmp_path / "logs" / f"{n}.jsonl").read_text().splitlines()]
             for n in ("port", "jax")}
    assert [sorted(r) for r in lines["port"]] == [sorted(r)
                                                  for r in lines["jax"]]
    assert [(r["step"], r["loss"]) for r in lines["port"]] == [(1, 2.5),
                                                               (2, 2.25)]
    assert not (tmp_path / "off").exists()


def test_caption_targets_mask_pads_and_prompt():
    ids = torch.tensor([[0, 9, 8, 7, 2], [0, 5, 2, 1, 1]])
    got = caption_targets(ids, (ids != 1).int(), 2, 1)
    assert got.tolist() == [[-100, -100, 8, 7, 2], [-100, -100, 2, -100,
                                                    -100]]


def test_batch_norm_train_uses_flax_statistics():
    """Biased batch variance E[x^2] - E[x]^2 over (B, H, W) in fp32, running
    statistics 0.9 * old + 0.1 * batch, as flax BatchNorm(momentum=0.9)."""
    import flax.linen as nn
    rng = np.random.default_rng(5)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 4, 6))).astype(np.float32)
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 6))
        bn.running_mean.fill_(0.3)
        bn.running_var.fill_(2.0)
    got = bn(torch.from_numpy(x).to(torch.bfloat16), train=True)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, dtype=jnp.float32)
    variables = {"params": {"scale": jnp.linspace(0.5, 1.5, 6),
                            "bias": jnp.linspace(-0.2, 0.2, 6)},
                 "batch_stats": {"mean": jnp.full(6, 0.3),
                                 "var": jnp.full(6, 2.0)}}
    want, mutated = flax_bn.apply(variables,
                                  jnp.asarray(x, jnp.bfloat16),
                                  mutable=["batch_stats"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    unbiased = torch.from_numpy(x).reshape(-1, 6).var(0, unbiased=True)
    assert not torch.allclose(bn.running_var, 0.9 * 2.0 + 0.1 * unbiased)


def _dropout_model(seed=0):
    cfg = port_config.build_prismer_config(task("float32"))
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, hidden_dropout_prob=0.1))
    return port_prismer.build_random_prismer(cfg, seed, device="cpu")


def _grads_with_dropout(model, batch, seed):
    model.zero_grad(set_to_none=True)
    from prismer_tpu_torch.data.device import materialize_experts as pm
    loss = model.forward_loss(pm(batch["experts"]), batch["input_ids"],
                              batch["attention_mask"], batch["targets"],
                              train=True,
                              generator=torch.Generator().manual_seed(seed))
    loss.mean().backward()
    return float(loss.mean()), {n: p.grad.clone()
                                for n, p in model.named_parameters()
                                if p.grad is not None}


def test_remat_gradients_equal_plain_gradients_with_dropout(monkeypatch):
    """Dropout 0.1 with every layer rematerialised: the recomputation draws
    the same masks (seeds drawn before the checkpointed call), so the
    gradients equal those of the same step without remat."""
    model = _dropout_model()
    batch = port_batch(caption_batch(4))
    calls = []
    real = port_layers.remat

    def counting(fn, *args):
        calls.append(fn)
        return real(fn, *args)

    monkeypatch.setattr(port_layers, "remat", counting)
    import prismer_tpu_torch.models.roberta as roberta
    import prismer_tpu_torch.models.vit as vit
    monkeypatch.setattr(roberta, "remat", counting)
    monkeypatch.setattr(vit, "remat", counting)
    loss_r, grads_r = _grads_with_dropout(model, batch, 9)
    assert len(calls) == 2 + 3        # ViT trunk blocks + decoder layers
    monkeypatch.setattr(roberta, "remat", lambda fn, *a: fn(*a))
    monkeypatch.setattr(vit, "remat", lambda fn, *a: fn(*a))
    loss_p, grads_p = _grads_with_dropout(model, batch, 9)
    assert loss_r == loss_p
    assert grads_r.keys() == grads_p.keys()
    for n in grads_r:
        torch.testing.assert_close(grads_r[n], grads_p[n], rtol=1e-6,
                                   atol=1e-7, msg=n)
    # dropout is live: another seed gives another loss
    loss_other, _ = _grads_with_dropout(model, batch, 10)
    assert loss_other != loss_r


def test_dropout_is_flax_semantics_and_not_on_attention_probabilities():
    """Keep with 1 - rate, kept values scaled by 1 / (1 - rate) in the
    input dtype; identity without a seed. The attention core has no
    dropout: a layer's attention output is the same under any seed."""
    x = torch.ones(4000, dtype=torch.bfloat16)
    y = port_layers.Dropout(0.1, 3, x.device)(x)
    kept = y != 0
    assert y.dtype == torch.bfloat16
    assert torch.all(y[kept] == torch.tensor(1 / 0.9, dtype=torch.bfloat16))
    assert 0.85 < kept.float().mean().item() < 0.95
    assert torch.equal(port_layers.Dropout(0.1, None, x.device)(x), x)
    model = _dropout_model()
    layer = model.text_decoder.layers_0
    h = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(2, 5, dtype=torch.int32)
    with torch.no_grad():
        a = layer.self_attn(h, h, mask, causal=True)
        b = layer.self_attn(h, h, mask, causal=True)
    assert torch.equal(a, b)
    import inspect
    src = inspect.getsource(type(layer.self_attn))
    assert "Dropout" not in src and "dropout" not in src
