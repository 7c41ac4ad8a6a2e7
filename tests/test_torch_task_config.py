"""The port's task-config reader (prismer_tpu_torch.config.load_task_config
/ parse_yaml) against PyYAML's `safe_load`, which the JAX package reads the
same files with: every file of prismer_tpu/configs/ (each dataset key of
caption.yaml), the config strings the JAX driver tests write, and YAML 1.1
plain scalars one by one; the constructs outside the subset raise
ValueError naming the file and line."""

import importlib.util
import math
from pathlib import Path

import pytest
import yaml

from prismer_tpu import config as jax_config
from prismer_tpu_torch import config

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "prismer_tpu" / "configs").glob("*.yaml"))


def _same(got, want):
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    if isinstance(want, dict):
        return (isinstance(got, dict) and list(got) == list(want)
                and all(_same(got[k], want[k]) for k in want))
    if isinstance(want, list):
        return (isinstance(got, list) and len(got) == len(want)
                and all(_same(g, w) for g, w in zip(got, want)))
    return type(got) is type(want) and got == want


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_repo_configs_equal_safe_load(path):
    want = yaml.safe_load(path.read_text())
    assert _same(config.load_task_config(str(path)), want)
    assert config.default_config_path(path.stem) == str(path)
    assert config.default_config_path(path.stem) == \
        jax_config.default_config_path(path.stem)
    if path.stem == "caption":
        for target in ("coco", "nocaps", "demo"):
            assert _same(config.load_task_config(str(path), target),
                         jax_config.load_task_config(str(path), target))


def _jax_driver_configs(tmp):
    """The YAML strings tests/test_driver_end_to_end.py and
    tests/test_driver_vqa_classification.py write (their f-strings, with
    these paths)."""
    spec = importlib.util.spec_from_file_location(
        "jax_driver_tests",
        ROOT / "tests" / "test_driver_vqa_classification.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    data = f"{tmp}/data"
    caption = f"""
coco:
  dataset: 'coco'
  data_path: '{data}'
  label_path: '{data}/labels'
  experts: 'none'
  image_resolution: 64
  prismer_model: 'prismer_tiny'
  freeze: 'freeze_vision'
  batch_size_train: 2
  batch_size_test: 2
  init_lr: 1.0e-4
  weight_decay: 0.05
  min_lr: 0
  max_epoch: 1
  prefix: 'a toy'
"""
    vqa = (f"datasets: ['vqav2']\n"
           f"data_path: '{data}'\nlabel_path: '{data}/labels'\n"
           f"k_test: 2\ninference: 'rank'\n" + mod._strip(mod.TINY))
    cls = (f"data_path: '{data}'\nlabel_path: '{data}/labels'\n"
           f"dataset: 'imagenet'\nshots: 1\nk_test: 2\n"
           f"prefix: 'a photo of'\n" + mod._strip(mod.TINY))
    pretrain = (f"datasets: ['coco']\ncoco_data_path: '{data}'\n"
                f"label_path: '{data}/labels'\n"
                f"warmup_lr: 1.0e-6\nwarmup_steps: 2\n"
                + mod._strip(mod.TINY))
    return {"caption": caption, "vqa": vqa, "classification": cls,
            "pretrain": pretrain}


@pytest.mark.parametrize("name", ["caption", "vqa", "classification",
                                  "pretrain"])
def test_jax_driver_test_configs_equal_safe_load(name, tmp_path):
    text = _jax_driver_configs(tmp_path)[name]
    want = yaml.safe_load(text)
    assert _same(config.parse_yaml(text), want)
    assert want  # the strings are not empty documents
    path = tmp_path / f"{name}.yaml"
    path.write_text(text)
    assert _same(config.load_task_config(str(path)),
                 jax_config.load_task_config(str(path)))


SCALARS = ["5.0e-5", "3.0e-4", "1e-4", "0", "20", "-1", "1.0e5", ".5",
           "0x10", "-0x1_f", "1_000", "0.5", "-1.5e+3", "1.", "0o17", "09",
           "+12", "yes", "Yes", "NO", "yEs", "y", "Off", "on",
           "TRUE", "false", "~", "null", "Null", "", "inf", "nan",
           "'none'", "none", '"a: b"', "'it''s'", "it's",
           '"tab\\there"', "[a, 'b c', 3]", "[]", "[a, [b, 1.0e-6], ~]",
           "[x, y,]", "a#b", "a  # comment", "/data/dataset_vqa",
           "'/data/dataset_vqa'", "A picture of"]


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalar_resolves_as_safe_load(scalar):
    text = f"key: {scalar}\n"
    assert _same(config.parse_yaml(text), yaml.safe_load(text))


# plain scalars PyYAML resolves to a number or a date by YAML 1.1 rules
# that no config uses: refused rather than reproduced
UNSUPPORTED = ["00", "017", "0b101", "-0b1_0", "1:30", "-1:30.5", ".inf",
               "-.Inf", ".NaN", "2001-12-14", "2001-12-14 21:59:43.10 -5"]


@pytest.mark.parametrize("scalar", UNSUPPORTED)
def test_unsupported_scalars_raise(scalar):
    text = f"key: {scalar}\n"
    assert not isinstance(yaml.safe_load(text)["key"], str)
    with pytest.raises(ValueError, match="<string>:1: .*not supported"):
        config.parse_yaml(text)


REFUSED = {
    "anchor": "a: &x 1\nb: 2",
    "alias": "a: 1\nb: *x",
    "tag": "a: !!str 1",
    "literal block": "a: |\n  text",
    "folded block": "a: >\n  text",
    "flow mapping": "a: {b: 1}",
    "flow mapping in a list": "a: [b, {c: 1}]",
    "documents": "a: 1\n---\nb: 2",
    "document start": "---\na: 1",
    "directive": "%YAML 1.1\na: 1",
    "tab indent": "a:\n\tb: 1",
    "block sequence": "a:\n  - b",
    "multi-line scalar": "a: b\n  c",
    "unclosed quote": "a: 'b",
    "unclosed list": "a: [b, c",
    "mapping in a value": "a: b: c",
    "bad dedent": "a:\n    b: 1\n  c: 2",
    "complex key": "? a\n: b",
    "timestamp": "a: 2001-12-14",
    "merge key": "<<: 1",
    "hex escape": 'a: "\\x41"',
    "unicode escape": 'a: "\\u00e9"',
    "text after a quote": "a: 'b' c",
    "no key": "just a line",
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_constructs_raise_with_file_and_line(name, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("# header\n" + REFUSED[name] + "\n")
    with pytest.raises(ValueError, match=r"bad\.yaml:\d+: "):
        config.load_task_config(str(path))
