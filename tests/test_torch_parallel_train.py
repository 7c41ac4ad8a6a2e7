"""The port's data-parallel train step (train/step.py under a mesh,
parallel/zero.py) at 2 ranks over gloo on the CPU, and the drivers'
collectives across those ranks.

prismer_tiny with depth + obj_detection at 64 px (the stems' BatchNorms
in train mode, random instance slots), freeze_vision, a ragged caption
batch of 4 (2 rows a rank), leaves from 512 elements sharded (as JAX's dry
run). Against the port's one-process step on the whole batch, under the
tolerances of tests/test_torch_train.py (loss 1e-5 rel, gradients 1e-4 rel
L2 per leaf, the update after two steps 1e-3 rel L2, BatchNorm statistics
1e-5):

  * "dp" with decoder dropout 0.1: the masks of the global batch, the
    global batch statistics;
  * the same step with the BatchNorm sync off misses the statistics by
    far more than the tolerance;
  * "zero2" and "zero3" (dropout 0.1) equal "dp"; under "zero3" the
    attention and fused cross-entropy entry points get plain tensors,
    never a DTensor;
  * in bf16 (one step), "zero2" equals "dp" bit for bit, and "zero3"
    equals it in the forward and the decoder and to bf16 rounding in the
    encoder's gradients;
  * a "zero3" checkpoint written by the 2 ranks after step 1 restores in
    one process, and the restored step 2 equals the ranks' step 2;
  * "dp" with dropout 0 equals JAX's `build_train_step` on the batch
    sharded over a 2-way 'data' mesh of the 8 CPU devices (`JaxRun` of
    tests/test_torch_train.py), on the depth expert alone: no instance
    slots, so the ranks run while JAX does.

The collectives: `gather_results`, `gather_for_metrics` and
`broadcast_from_main` across the 2 ranks against what JAX's
`process_allgather` / `broadcast_one_to_all` give for the same
per-process values. The ranks are spawned once, in the module fixture,
and import no JAX.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.experimental import multihost_utils

from prismer_tpu.cli import common as jax_common
from prismer_tpu.config import build_prismer_config, tiny_test_config
from prismer_tpu.models.prismer import Prismer
from prismer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from prismer_tpu.parallel.mesh import shard_batch as jax_shard_batch
from prismer_tpu_torch.convert.from_jax import (_leaves, jax_path_and_value,
                                                torch_key_and_value)
from prismer_tpu_torch.parallel import runtime
from tests import torch_parallel_util as util
from tests.test_torch_train import (TOL_GRAD, TOL_LOSS, TOL_STATS,
                                    TOL_UPDATE, JaxRun, _grad_rel, _leaf,
                                    _rel, build_jax, jax_batch)

torch.set_num_threads(2)

WORLD = 2
BATCH = 4
STEPS = 2
COLLECTIVES = {
    "results": [[{"image_id": 7, "caption": "a dog."}],
                [{"image_id": 5, "caption": "ünïcode, \"quoted\""},
                 {"image_id": 9, "caption": ""}]],
    "metrics": [np.asarray([1.5, 2.0], np.float32),
                np.asarray([0.25, -3.0], np.float32)],
    "scalars": [0.1, 7.0],
}


def _is_bn(name):
    return name.endswith(("running_mean", "running_var"))


def _without_obj_detection(variables_np):
    drop = ("conv1_obj_detection", "instance_embedding")
    return {coll: {"expert_encoder": {
                k: v for k, v in tree["expert_encoder"].items()
                if k not in drop}, **{k: v for k, v in tree.items()
                                      if k != "expert_encoder"}}
            for coll, tree in variables_np.items()}


def _jax_sharded_step(variables_np, batch):
    """JAX's build_train_step (and the same loss's gradients) on the batch
    sharded over a 2-way 'data' mesh: (grads, loss, JaxRun)."""
    cfg = build_prismer_config(dict(tiny_test_config(["depth"], util.RES),
                                    dtype="float32"))
    jrun = JaxRun(cfg, Prismer(cfg), variables_np)
    jb = jax_shard_batch(jax_batch(batch), jax_make_mesh(n_data=WORLD))
    _, drop_rng, inst_rng = jax.random.split(jrun.state.rng, 3)
    grads = jrun.grad_fn(jrun.state.params, jrun.state.batch_stats, jb,
                         drop_rng, inst_rng)
    jrun.state, metrics = jrun.step_fn(jrun.state, jb)
    return grads, float(metrics["loss"]), jrun


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    ckpt = str(tmp / "state")
    _, _, variables_np = build_jax("float32")
    variables_np = jax.tree.map(np.asarray, variables_np)
    batch = util.caption_batch(1, BATCH)
    drop = util.tiny_cfg("float32", dropout=0.1)
    bf16 = util.tiny_cfg("bfloat16", dropout=0.1)
    # against JAX: depth only (BatchNorm in train mode, no instance slots
    # to carry over, so the ranks need nothing JAX computes), dropout 0
    depth_vars = _without_obj_detection(variables_np)
    depth_batch = dict(batch, experts={k: batch["experts"][k]
                                       for k in ("rgb", "depth")})
    depth_cfg = util.tiny_cfg("float32", experts=["depth"])

    common = dict(variables_np=variables_np, batch_np=batch, steps=STEPS,
                  slots=None)
    cases = [
        dict(name="dp", cfg=drop, mode="dp", **common),
        dict(name="dp_unsynced", cfg=drop, mode="dp", sync=False, **common),
        dict(name="zero2", cfg=drop, mode="zero2", **common),
        dict(name="zero3", cfg=drop, mode="zero3", save=ckpt, kernels=True,
             **common),
        dict(name="dp_jax", cfg=depth_cfg, variables_np=depth_vars,
             batch_np=depth_batch, slots=None, mode="dp", steps=1),
    ] + [dict(name=f"{mode}_bf16", cfg=bf16, mode=mode, **dict(common, steps=1))
         for mode in ("dp", "zero2", "zero3")]
    # the ranks run while this process runs JAX and the one-process port
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(runtime.spawn, util.rank_train_cases, WORLD,
                            "cpu", str(tmp / "store"),
                            args=(cases, COLLECTIVES))
        jax_step = _jax_sharded_step(depth_vars, depth_batch)
        one = util.run_steps(drop, variables_np, batch, None, None,
                             steps=STEPS)
        ranks = ranks.result()
    restored = util.restore_and_step(drop, variables_np, batch, None, ckpt)
    return dict(ranks=ranks, one=one, restored=restored, jax=jax_step,
                variables=variables_np, depth_variables=depth_vars)


def _assert_step_close(got, want, start, update=True):
    """One step's record against another's, under the TOL_* tolerances;
    with `update`, the update since `start` (Adam's first steps are near
    lr * sign(g), so tests/test_torch_train.py holds the update after two
    steps, not one)."""
    assert abs(got["loss"] - want["loss"]) <= TOL_LOSS * abs(want["loss"])
    assert len(want["grads"]) > 40
    for name, g in want["grads"].items():
        scale = None
        if name.endswith(("key.bias", "k_proj.bias")):
            scale = np.linalg.norm(want["grads"][name[:-4] + "weight"])
        rel = _rel(got["grads"][name], g, scale)
        assert rel <= TOL_GRAD, (name, rel)
    n_bn = 0
    for name, now in want["params"].items():
        if _is_bn(name):
            np.testing.assert_allclose(got["params"][name], now,
                                       rtol=TOL_STATS, atol=TOL_STATS,
                                       err_msg=name)
            n_bn += 1
        elif update and name in want["grads"] and not name.endswith(
                ("key.bias", "k_proj.bias")):
            rel = _rel(got["params"][name] - start[name], now - start[name])
            assert rel <= TOL_UPDATE, (name, rel)
    assert n_bn == 16


def _start(variables_np):
    """The starting values by port name, in port layout."""
    out = {}
    for coll, tree in variables_np.items():
        for path, value in _leaves(tree):
            key, value = torch_key_and_value(coll, path, value)
            out[key] = np.asarray(value, np.float32)
    return out


@pytest.mark.parametrize("mode", ["dp", "zero2", "zero3"])
def test_step_equals_one_process(runs, mode):
    """Both ranks end each step with the same state, and it is one
    process's on the whole batch (dropout 0.1, BatchNorm synced)."""
    start = _start(runs["variables"])
    r0, r1 = (r[mode] for r in runs["ranks"])
    for k in range(STEPS):
        assert r0[k]["loss"] == r1[k]["loss"]
        for name, v in r0[k]["params"].items():
            np.testing.assert_array_equal(v, r1[k]["params"][name], name)
        _assert_step_close(r0[k], runs["one"][k], start,
                           update=k == STEPS - 1)


@pytest.mark.parametrize("mode", ["zero2", "zero3"])
def test_sharded_modes_equal_dp(runs, mode):
    start = _start(runs["variables"])
    r0 = runs["ranks"][0]
    for k in range(STEPS):
        _assert_step_close(r0[mode][k], r0["dp"][k], start,
                           update=k == STEPS - 1)


def test_zero2_equals_dp_in_bfloat16(runs):
    """bf16 weights with fp32 masters: ZeRO-2's sharded masters and
    moments give dp's step bit for bit (loss, gradients, parameters and
    BatchNorm statistics)."""
    got, want = (runs["ranks"][0][f"{m}_bf16"][0] for m in ("zero2", "dp"))
    assert got["loss"] == want["loss"]
    for kind in ("grads", "params"):
        assert got[kind].keys() == want[kind].keys()
        for name, v in want[kind].items():
            np.testing.assert_array_equal(got[kind][name], v, name)


def test_zero3_equals_dp_in_bfloat16(runs):
    """Under zero3 every weight is fp32 and Dense / Conv cast it to bf16 at
    use. The forward is dp's bit for bit (loss, BatchNorm statistics) and
    so is every decoder gradient. FSDP2 passes each sharded module's
    inputs through an autograd node of its own, so the encoder output's
    gradient, summed in bf16 over the decoder layers' cross-attention, is
    summed in another order: the encoder's gradients agree to bf16
    rounding (rel L2 per leaf under 2^-4, 16 units of bf16 rounding; a key
    bias, zero in exact arithmetic, against its weight's gradient)."""
    got, want = (runs["ranks"][0][f"{m}_bf16"][0] for m in ("zero3", "dp"))
    assert got["loss"] == want["loss"]
    n_bn = 0
    for name, v in want["params"].items():
        if _is_bn(name):
            np.testing.assert_array_equal(got["params"][name], v, name)
            n_bn += 1
    assert n_bn == 16
    assert got["grads"].keys() == want["grads"].keys()
    n_dec = 0
    for name, g in want["grads"].items():
        if name.startswith("text_decoder."):
            np.testing.assert_array_equal(got["grads"][name], g, name)
            n_dec += 1
            continue
        scale = None
        if name.endswith(("key.bias", "k_proj.bias")):
            scale = np.linalg.norm(want["grads"][name[:-4] + "weight"])
        rel = _rel(got["grads"][name], g, scale)
        assert rel <= 2.0 ** -4, (name, rel)
    assert n_dec > 40


def test_step_without_batch_norm_sync_misses_the_global_statistics(runs):
    """Per-rank statistics: the same comparison fails, by far more than the
    tolerance, in the BatchNorm running statistics."""
    got = runs["ranks"][0]["dp_unsynced"][0]["params"]
    want = runs["one"][0]["params"]
    worst = max(np.abs(got[n] - want[n]).max() for n in want if _is_bn(n))
    assert worst > 100 * TOL_STATS, worst
    synced = runs["ranks"][0]["dp"][0]["params"]
    assert max(np.abs(synced[n] - want[n]).max()
               for n in want if _is_bn(n)) <= TOL_STATS


def test_zero3_hands_kernels_plain_tensors(runs):
    seen = runs["ranks"][0]["zero3:kernel_inputs"]
    assert len(seen) > 20 and set(seen) == {"plain"}, set(seen)


def test_zero3_checkpoint_restores_in_one_process(runs):
    """Written by 2 ranks after step 1; one process restores it and takes
    step 2, within TOL_UPDATE of the ranks' uninterrupted step 2."""
    start = runs["ranks"][0]["zero3"][0]["params"]
    _assert_step_close(runs["restored"], runs["ranks"][0]["zero3"][1],
                       start)


def test_dp_step_equals_jax_build_train_step_on_a_sharded_batch(runs):
    jgrads, jloss, jrun = runs["jax"]
    got = runs["ranks"][0]["dp_jax"][0]
    assert abs(got["loss"] - jloss) <= TOL_LOSS * abs(jloss)
    assert len(got["grads"]) > 30
    for name, g in got["grads"].items():
        rel = _grad_rel(name, torch.from_numpy(g), jgrads)
        assert rel <= TOL_GRAD, (name, rel)
    start = _start(runs["depth_variables"])
    n_bn = 0
    for name, now in got["params"].items():
        coll, path, now = jax_path_and_value(name, now)
        tree = jrun.state.batch_stats if coll == "batch_stats" \
            else jrun.state.params
        want = _leaf(tree, path)
        if coll == "batch_stats":
            np.testing.assert_allclose(now, want, rtol=TOL_STATS,
                                       atol=TOL_STATS, err_msg=name)
            n_bn += 1
        elif name in got["grads"] and not name.endswith(
                ("key.bias", "k_proj.bias")):
            _, _, first = jax_path_and_value(name, start[name])
            rel = _rel(now - first, want - first)
            assert rel <= TOL_UPDATE, (name, rel)
    assert n_bn == 8


def test_collectives_across_ranks_match_jax(runs):
    """Each rank gets what JAX's collectives give for the same per-process
    values: the results concatenated and the metrics stacked in process
    order (process_allgather of each process's array, tiled=False), rank
    0's scalar as float32 (broadcast_one_to_all)."""
    want_results = sum((jax_common.gather_results(r)
                        for r in COLLECTIVES["results"]), [])
    json.dumps(want_results)
    want_metrics = np.concatenate([
        np.asarray(multihost_utils.process_allgather(m))
        for m in COLLECTIVES["metrics"]])
    want_scalar = float(multihost_utils.broadcast_one_to_all(
        np.asarray(COLLECTIVES["scalars"][0], np.float32)))
    for r, out in enumerate(runs["ranks"]):
        got = out["collectives"]
        assert got["gather_results"] == want_results
        np.testing.assert_array_equal(got["gather_for_metrics"],
                                      want_metrics)
        assert got["gather_for_metrics"].shape == (WORLD, 2)
        assert got["broadcast_from_main"] == want_scalar
        assert got["is_main_process"] == (r == 0)
