"""Sharded caption generation of the port (`caption.
build_sharded_generate_fn`) at 2 and 4 ranks over gloo on the CPU, against
the port's one-process `build_generate_fn` and the JAX package's
`build_sharded_generate_fn` on its 8-device mesh.

The tiny six-expert model (weights from numpy seed 0 in the JAX tree), a
batch of 8 (4 and 2 rows a rank), beam 3, 12 tokens. Three modes on both
sides: fused decode off; forced on (the port's plain versions of kernels
1-5, JAX's kernels in interpret mode); on with int8 cross K/V. Every mode
must give the same ids bit for bit everywhere: every rank's gathered ids,
one process's ids, and JAX's. The ranks are spawned once per world size,
in the module fixture, while the test process runs JAX; they import no
JAX.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from prismer_tpu.models import roberta as jax_rb
from prismer_tpu.models.caption import \
    build_sharded_generate_fn as jax_sharded_generate_fn
from prismer_tpu.models.prismer import prepare_serving_variables
from prismer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from prismer_tpu_torch import config as port_config
from prismer_tpu_torch.models import roberta as port_rb
from prismer_tpu_torch.models.caption import build_generate_fn
from prismer_tpu_torch.parallel import runtime
from tests import torch_parallel_util as util
from tests.test_torch_model import (build_pair, instance_slots, prompt_batch,
                                    raw_batch, task_config, to_jax, to_torch)

torch.set_num_threads(2)

BATCH = 8
GEN = dict(num_beams=3, max_length=12, min_length=6)
MODES = {"off": ("off", "off"), "on": ("on", "off"), "int8": ("on", "int8")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    model, variables, port = build_pair()
    variables_np = jax.tree.map(np.asarray, variables)
    raw = raw_batch(21, batch=BATCH)
    ids, mask = prompt_batch(21, batch=BATCH)
    slots = instance_slots()
    cfg = port_config.build_prismer_config(task_config())
    # the ranks run while this process runs JAX and the one-process port
    with ThreadPoolExecutor(2) as pool:
        ranks = {world: pool.submit(
            runtime.spawn, util.rank_generate, world, "cpu",
            str(tmp_path_factory.mktemp(f"gen{world}")),
            args=(cfg, variables_np, raw, ids, mask, slots, GEN))
            for world in (2, 4)}
        jax_ids, one = {}, {}
        mesh = jax_make_mesh(n_data=8)
        try:
            for mode, (fused, kv) in MODES.items():
                jax_rb.set_fused_decode(fused)
                jax_rb.set_kv_quant(kv)
                port_rb.set_fused_decode(fused)
                port_rb.set_kv_quant(kv)
                vs = prepare_serving_variables(model, variables)
                gen = jax_sharded_generate_fn(model, mesh, **GEN)
                jax_ids[mode] = np.asarray(gen(vs, to_jax(raw), ids, mask))
                one[mode] = build_generate_fn(port, **GEN)(
                    to_torch(raw), torch.from_numpy(ids),
                    torch.from_numpy(mask), torch.from_numpy(slots)).numpy()
        finally:
            jax_rb.set_fused_decode("auto")
            jax_rb.set_kv_quant("off")
            port_rb.set_fused_decode("auto")
            port_rb.set_kv_quant("off")
        ranks = {world: f.result() for world, f in ranks.items()}
    return jax_ids, one, ranks


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_generate_equals_one_process_and_jax(runs, world, mode):
    jax_ids, one, ranks = runs
    assert jax_ids[mode].shape == (BATCH, GEN["max_length"])
    np.testing.assert_array_equal(one[mode], jax_ids[mode])
    for r, out in enumerate(ranks[world]):
        np.testing.assert_array_equal(out[mode], jax_ids[mode],
                                      err_msg=f"rank {r}")
