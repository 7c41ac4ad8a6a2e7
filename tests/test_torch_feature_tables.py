"""The port's feature-table converter (prismer_tpu_torch.convert.
feature_tables) against the JAX package's on synthetic tables: the four
.pt tables and a pickled sklearn PCA written here, both converters' .npz
and _labels.npz equal array for array. The port runs without sklearn (the
card's machine has none) and refuses a pickle that names any other
global."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from sklearn.decomposition import PCA

from prismer_tpu.convert import feature_tables as jax_tables
from prismer_tpu_torch.convert import feature_tables

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    d = tmp_path_factory.mktemp("tables")
    rng = np.random.default_rng(0)
    for name, n in (("coco", 133), ("ade", 150), ("detection", 722)):
        torch.save({"labels": [f"{name} class {i} ü" for i in range(n)],
                    "features": torch.from_numpy(
                        rng.normal(size=(n, 64)).astype(np.float32))},
                   d / f"{name}_features.pt")
    torch.save(torch.from_numpy(rng.normal(size=64).astype(np.float32)),
               d / "background_features.pt")
    pca = PCA(64).fit(rng.normal(size=(200, 768)))
    with open(d / "clip_pca.pkl", "wb") as f:
        pickle.dump(pca, f)
    return d


def test_port_converter_equals_jax_without_sklearn(src, tmp_path):
    jax_tables.convert(str(src), str(tmp_path / "jax" / "features.npz"))
    code = ("import sys; sys.modules['sklearn'] = None\n"
            "from prismer_tpu_torch.convert.feature_tables import main\n"
            f"main(['--src', {str(src)!r}, '--dst', "
            f"{str(tmp_path / 'port' / 'features.npz')!r}])\n"
            "assert not [m for m in sys.modules if m.startswith('sklearn')"
            " and sys.modules[m] is not None]\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=str(ROOT)))
    for suffix in ("features.npz", "features_labels.npz"):
        want = np.load(tmp_path / "jax" / suffix, allow_pickle=True)
        got = np.load(tmp_path / "port" / suffix, allow_pickle=True)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = np.load(tmp_path / "port" / "features.npz")
    assert got["pca_components"].shape == (64, 768)
    assert sorted(np.load(tmp_path / "port" / "features_labels.npz",
                          allow_pickle=True).files) == [
        "ade_labels", "allow_pickle", "coco_labels", "detection_labels"]


def test_unpickler_refuses_other_globals(tmp_path):
    path = tmp_path / "clip_pca.pkl"
    with open(path, "wb") as f:
        pickle.dump({"components_": os.system}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.system"):
        feature_tables.load_pca(str(path))
