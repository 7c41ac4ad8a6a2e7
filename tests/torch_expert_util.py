"""Helpers shared by the label-expert tests of the PyTorch port
(tests/test_torch_expert_*.py): numpy-seeded flax variables, and the
relative L2 distance the tolerances are stated in."""

import math

import jax
import numpy as np
import torch


def seeded(shapes, seed, raw_std=0.02):
    """Numpy values for every leaf of a flax variable shape tree
    ({'params': ..., 'batch_stats': ...}): kernels N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1^2), biases N(0, 0.05^2), BatchNorm means
    N(0, 0.1^2) and variances 1 + tanh(N(0, 1)) / 2 (in (0.5, 1.5)), other raw parameters N(0,
    raw_std^2). fan_in is the product of all but the last axis (flax's
    Conv and Dense layouts)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name, shape = str(path[-1].key), sd.shape
        normal = rng.standard_normal(shape, dtype=np.float32)
        if name == "kernel":
            x = normal / np.float32(math.sqrt(math.prod(shape[:-1])))
        elif name == "scale":
            x = 1.0 + 0.1 * normal
        elif name == "bias":
            x = 0.05 * normal
        elif name == "mean":
            x = 0.1 * normal
        elif name == "var":
            x = 1.0 + 0.5 * np.tanh(normal)
        else:
            x = raw_std * normal
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def rel_l2(got, want) -> float:
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def t(x) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def run_both(jax_module, port_module, *inputs, seed=0, method=None):
    """Seeded variables for `jax_module` (from its shape tree on `inputs`),
    loaded into `port_module` (its state dict keyed by the flax paths);
    returns (JAX outputs as numpy, port outputs) on the same numpy
    inputs."""
    import jax.numpy as jnp

    from prismer_tpu_torch.convert.from_jax import load_jax_variables

    args = [jnp.asarray(a) for a in inputs]
    kw = {} if method is None else {"method": method}
    shapes = jax.eval_shape(
        lambda *a: jax_module.init(jax.random.key(0), *a, **kw), *args)
    variables = seeded(shapes, seed)
    want = jax.jit(lambda v, *a: jax_module.apply(v, *a, **kw))(variables,
                                                               *args)
    load_jax_variables(port_module, variables)
    port_module.eval()
    with torch.no_grad():
        got = port_module(*[t(a) for a in inputs])
    return jax.tree.map(np.asarray, want), got


def assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")
