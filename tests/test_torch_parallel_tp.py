"""Tensor parallelism of the port (parallel/tp.py, JAX's `_tp_spec` on the
'model' axis) at 4 ranks over gloo on the CPU: a 2 x 2 ('data', 'model')
mesh, each rank holding the column or row slice of the q/k/v, c_fc,
intermediate, down_proj, out_proj, c_proj and up_proj kernels.

Two steps of "dp" + TP and of "zero3" + TP (leaves from 512 elements
sharded on 'data' as well, on a dim TP leaves free) on prismer_tiny with
depth + obj_detection at 64 px, decoder dropout 0.1, a caption batch of 4,
against the port's one-process steps on the whole batch, under the
tolerances of tests/test_torch_train.py. The ranks are spawned once, in
the module fixture, and import no JAX.
"""

import jax
import numpy as np
import pytest
import torch

from prismer_tpu_torch.parallel import runtime
from tests import torch_parallel_util as util
from tests.test_torch_parallel_train import STEPS, _assert_step_close, _start
from tests.test_torch_train import build_jax

torch.set_num_threads(2)

WORLD = 4
BATCH = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, _, variables_np = build_jax("float32")
    variables_np = jax.tree.map(np.asarray, variables_np)
    batch = util.caption_batch(1, BATCH)
    cfg = util.tiny_cfg("float32", dropout=0.1)
    common = dict(cfg=cfg, variables_np=variables_np, batch_np=batch,
                  steps=STEPS, slots=None, n_model=2)
    cases = [dict(name="dp_tp", mode="dp", **common),
             dict(name="zero3_tp", mode="zero3", kernels=True, **common)]
    ranks = runtime.spawn(util.rank_train_cases, WORLD, "cpu",
                          str(tmp_path_factory.mktemp("tp")), args=(cases,))
    one = util.run_steps(cfg, variables_np, batch, None, None, steps=STEPS)
    return ranks, one, _start(variables_np)


@pytest.mark.parametrize("mode", ["dp_tp", "zero3_tp"])
def test_tensor_parallel_step_equals_one_process(runs, mode):
    ranks, one, start = runs
    for k in range(STEPS):
        for r in range(1, WORLD):
            assert ranks[r][mode][k]["loss"] == ranks[0][mode][k]["loss"]
            for name, v in ranks[0][mode][k]["params"].items():
                np.testing.assert_array_equal(
                    v, ranks[r][mode][k]["params"][name], f"{name} rank {r}")
        _assert_step_close(ranks[0][mode][k], one[k], start,
                           update=k == STEPS - 1)


def test_tensor_parallel_slices_the_named_kernels_only(runs):
    """The kernels reach the attention and CE entry points as plain,
    full-width tensors."""
    ranks, _, _ = runs
    seen = ranks[0]["zero3_tp:kernel_inputs"]
    assert len(seen) > 20 and set(seen) == {"plain"}
