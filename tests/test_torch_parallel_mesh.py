"""The port's placement rules (parallel/mesh.py `param_placements`) against
JAX's `param_shardings` at the real shapes of Prismer-BASE and -LARGE (six
experts, 480 px; JAX's shapes from `jax.eval_shape`, the port's model on
the meta device), leaf for leaf through the port's transposes, for FSDP on
a (8, 1) mesh, TP on (1, 2) and FSDP + TP on (4, 2); the runtime's one
rank per process guard; `batch_rows`."""

import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from prismer_tpu.parallel.mesh import make_mesh, param_shardings
from prismer_tpu_torch import config as port_config
from prismer_tpu_torch.convert.from_jax import torch_key_and_value
from prismer_tpu_torch.models.prismer import Prismer
from prismer_tpu_torch.parallel import mesh as port_mesh
from prismer_tpu_torch.parallel import runtime
from tests.test_sharding_real_shapes import FULL_EXPERTS, _abstract_params

MESHES = {"fsdp": ((8, 1), True, False), "tp": ((1, 2), False, True),
          "fsdp+tp": ((4, 2), True, True)}


def _axes(entry):
    if entry is None:
        return None
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _port_layout(path, spec, shape):
    """A flax leaf's spec in the port's layout, and the port name."""
    view = np.broadcast_to(np.zeros((), np.int8), shape)
    name, port_view = torch_key_and_value("params", path, view)
    flax = [_axes(spec[d]) if d < len(spec) else None
            for d in range(len(shape))]
    if path[-1] == "kernel":
        order = {2: (1, 0), 4: (3, 2, 0, 1)}[len(shape)]
        flax = [flax[d] for d in order]
    return name, tuple(flax), port_view.shape


@pytest.fixture(scope="module", params=["prismer_base", "prismer_large"])
def models(request):
    _, params = _abstract_params(request.param)
    cfg = port_config.build_prismer_config({
        "experts": FULL_EXPERTS, "image_resolution": 480,
        "prismer_model": request.param, "freeze": "freeze_vision",
        "dtype": "bfloat16"})
    return params, Prismer(cfg, device="meta")


@pytest.mark.parametrize("kind", list(MESHES))
def test_placements_equal_jax_leaf_for_leaf(models, kind):
    params, port = models
    (n_data, n_model), fsdp, tp = MESHES[kind]
    shardings = param_shardings(params, make_mesh(n_data, n_model),
                                fsdp=fsdp, tp=tp)
    got = port_mesh.param_placements(port, n_data, n_model, fsdp=fsdp,
                                     tp=tp)
    shapes = {_path(p): leaf.shape for p, leaf in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    want = {}
    for p, sh in jax.tree_util.tree_flatten_with_path(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        path = _path(p)
        name, spec, shape = _port_layout(path, sh.spec, shapes[path])
        assert tuple(port.get_parameter(name).shape) == shape, name
        want[name] = spec
    assert len(want) == len(shapes)
    assert set(got) == set(want)
    assert got == want
    split = sum(any(s) for s in want.values())
    assert split > 100, split


def _path(keys):
    return tuple(k.key for k in keys)


def test_batch_rows_split_the_data_axis():
    class Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, d):
            self.d = d

        def size(self, dim):
            return 4

        def get_local_rank(self, axis):
            return self.d

    assert [port_mesh.batch_rows(8, Mesh(d)) for d in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="does not divide"):
        port_mesh.batch_rows(6, Mesh(0))


def test_one_rank_per_process(tmp_path, monkeypatch):
    """runtime.init refuses a thread other than the main one and a second
    group in the process; without torchrun's variables it names them."""
    errors = []

    def other():
        try:
            runtime.init("cpu", rank=0, world_size=1)
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert errors and "thread other than the main" in errors[0]
    assert not dist.is_initialized()
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="RANK is not set"):
        runtime.init("cpu")
    store = dist.FileStore(str(tmp_path / "store"), 1)
    runtime.init("cpu", store=store, rank=0, world_size=1)
    try:
        assert runtime.world() == 1 and runtime.is_main()
        assert dist.get_backend() == "gloo"
        with pytest.raises(RuntimeError, match="already open"):
            runtime.init("cpu", store=store, rank=0, world_size=1)
    finally:
        runtime.shutdown()
    assert not dist.is_initialized()
    assert runtime.backend_for("cuda") == "nccl"
    assert runtime.backend_for(torch.device("cpu")) == "gloo"
