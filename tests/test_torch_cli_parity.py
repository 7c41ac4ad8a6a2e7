"""The port's drivers' `main` against the JAX drivers' `main` on the CPU,
on the same fp32 weights, data and loader order.

The weights are made from numpy seed 0 in the JAX variable tree of
prismer_tiny (PrismerZ: RGB only, 64 px) and saved by the JAX
`save_params_npz`; both drivers load them with `--pretrained`. Both take
their batches from one loader thread after `random.seed(0)`, so that the
train-time augmentation draws the same numbers in the same order (the
loaders' index order is held equal in tests/test_torch_data.py).

- train_vqa: each step's lr and loss (per-sample answer weights), the
  printed epoch line, then the rank eval's EvalAI list over the trained
  weights, entry for entry;
- train_classification --evaluate: the rank eval's predicted class per
  image over the lower-cased class names, and the printed accuracy;
- common.load_pretrained of a reference `.bin` equals the converter CLI's
  `.npz` loaded by `load_npz_into`.

Stated tolerance: losses 1e-5 relative (tests/test_torch_train.py's);
learning rates 1e-6 relative (fp32 in JAX, float64 in the port).
"""

import json
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.cli import train_classification as jax_cls_cli
from prismer_tpu.cli import train_vqa as jax_vqa_cli
from prismer_tpu.config import build_prismer_config as jax_build_config
from prismer_tpu.models import caption as jax_caption_head
from prismer_tpu.models.prismer import Prismer as JaxPrismer
from prismer_tpu.train.checkpoint import save_params_npz as jax_save_npz
from prismer_tpu_torch.cli import common, train_classification, train_vqa
from prismer_tpu_torch.config import build_prismer_config
from prismer_tpu_torch.convert import cli as port_convert_cli
from prismer_tpu_torch.models import caption as caption_head
from prismer_tpu_torch.models.prismer import Prismer, build_random_prismer
from tests.test_torch_cli import tree  # noqa: F401  (the module's fixture)
from tests.test_torch_convert import build_synthetic_reference_checkpoint
from tests.test_torch_model import seeded_variables

torch.set_num_threads(2)

TOL_LOSS = 1e-5
TOL_LR = 1e-6
MODEL = {"experts": "none", "image_resolution": 64,
         "prismer_model": "prismer_tiny", "dtype": "float32"}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """PrismerZ tiny params from numpy seed 0, saved by the JAX package."""
    jmodel = JaxPrismer(jax_build_config(MODEL))
    ones = jnp.ones((1, 4), jnp.int32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            {"rgb": jnp.zeros((1, 64, 64, 3))}, ones, ones)
    path = tmp_path_factory.mktemp("weights") / "prismer_z.npz"
    jax_save_npz(str(path), seeded_variables(shapes, 0)["params"])
    return str(path)


def _argv(tree, cfg, exp, out, weights, *extra):  # noqa: F811
    return ["--config", tree.cfgs[cfg], "--exp_name", exp,
            "--mixed_precision", "fp32", "--tokenizer_dir",
            str(tree.tok_dir), "--logging_dir", str(out / "logging"),
            "--results_dir", str(out / "results"), "--pretrained", weights,
            *extra]


def _one_loader_thread(monkeypatch, module):
    real = module.create_loader

    def create_loader(dataset, batch_size, num_workers=8, train=False,
                      **kw):
        return real(dataset, batch_size, num_workers=1, train=train,
                    worker_type="thread", **kw)

    monkeypatch.setattr(module, "create_loader", create_loader)


def _record_steps(monkeypatch, module, steps, lr_before=None):
    """Wrap the driver's build_train_step: each step's (lr, loss). The lr
    is `lr_before(state)` where given, else the one the step set on the
    port's optimizer."""
    real = module.build_train_step

    def build(*a, **kw):
        step_fn = real(*a, **kw)

        def step(state, batch):
            lr = lr_before(state) if lr_before else None
            state, metrics = step_fn(state, batch)
            if lr is None:
                lr = state.optimizer.param_groups[0]["lr"]
            steps.append((float(lr), float(metrics["loss"])))
            return state, metrics
        return step

    monkeypatch.setattr(module, "build_train_step", build)


def _run_jax(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", ["driver"] + argv)
    random.seed(0)
    module.main()


def _run_port(module, argv):
    random.seed(0)
    module.main(argv + ["--device", "cpu"])


def test_train_vqa_main_equals_jax(tree, weights, tmp_path,  # noqa: F811
                                   monkeypatch, capsys):
    monkeypatch.setenv("PRISMER_TOKENIZER_DIR", str(tree.tok_dir))
    schedules, jax_steps, port_steps = {}, [], []
    for name, module in (("jax", jax_vqa_cli), ("port", train_vqa)):
        _one_loader_thread(monkeypatch, module)
        real = module.per_step_cosine

        def schedule(*a, _real=real, _name=name):
            schedules[_name] = _real(*a)
            return schedules[_name]
        monkeypatch.setattr(module, "per_step_cosine", schedule)
    # JAX: optax reads the schedule at the step count before the update;
    # the port sets the lr on the optimizer inside the step
    _record_steps(monkeypatch, jax_vqa_cli, jax_steps,
                  lambda s: schedules["jax"](int(s.step)))
    _record_steps(monkeypatch, train_vqa, port_steps)

    _run_jax(monkeypatch, jax_vqa_cli,
             _argv(tree, "vqa", "vqa", tmp_path / "jax", weights))
    jax_out = capsys.readouterr().out
    _run_port(train_vqa, _argv(tree, "vqa", "vqa", tmp_path / "port",
                               weights))
    port_out = capsys.readouterr().out

    assert len(port_steps) == len(jax_steps) == 2
    for (p_lr, p_loss), (j_lr, j_loss) in zip(port_steps, jax_steps):
        assert abs(p_lr - j_lr) <= TOL_LR * abs(j_lr), (p_lr, j_lr)
        assert abs(p_loss - j_loss) <= TOL_LOSS * abs(j_loss), (p_loss,
                                                                j_loss)
    assert [schedules["port"](i) for i in range(4)] == pytest.approx(
        [float(schedules["jax"](i)) for i in range(4)], rel=TOL_LR)

    def epoch_line(out):
        line = [l for l in out.splitlines() if l.startswith("Epoch 000")][0]
        return line.rsplit("|", 1)[0]
    assert epoch_line(port_out) == epoch_line(jax_out)
    want = json.loads((tmp_path / "jax" / "results"
                       / "vqa_results_vqa.json").read_text())
    got = json.loads((tmp_path / "port" / "results"
                      / "vqa_results_vqa.json").read_text())
    assert got == want
    assert [r["question_id"] for r in got] == [1000, 1001, 1002]


def test_train_classification_evaluate_equals_jax(
        tree, weights, tmp_path, monkeypatch, capsys):  # noqa: F811
    monkeypatch.setenv("PRISMER_TOKENIZER_DIR", str(tree.tok_dir))
    preds = {"jax": [], "port": []}
    for name, head in (("jax", jax_caption_head), ("port", caption_head)):
        real = head.build_rank_fn

        def build_rank_fn(model, *, k_test, _real=real, _name=name):
            rank = _real(model, k_test=k_test)

            def fn(*a):
                best = rank(*a)
                preds[_name].extend(np.asarray(
                    best.cpu() if _name == "port" else best).tolist())
                return best
            return fn
        monkeypatch.setattr(head, "build_rank_fn", build_rank_fn)
    for module in (jax_cls_cli, train_classification):
        _one_loader_thread(monkeypatch, module)

    _run_jax(monkeypatch, jax_cls_cli,
             _argv(tree, "classification", "c", tmp_path / "jax", weights,
                   "--evaluate"))
    jax_out = capsys.readouterr().out
    _run_port(train_classification,
              _argv(tree, "classification", "c", tmp_path / "port",
                    weights, "--evaluate"))
    port_out = capsys.readouterr().out
    assert len(preds["port"]) == 4 and preds["port"] == preds["jax"]
    assert set(preds["port"]) <= {0, 1, 2}
    assert port_out.startswith("accuracy: ")
    assert port_out == jax_out


def test_load_pretrained_bin_equals_the_converter_npz(tmp_path):
    cfg = build_prismer_config(dict(MODEL, experts=["depth"]))
    jcfg = jax_build_config(dict(MODEL, experts=["depth"]))
    src = tmp_path / "pytorch_model.bin"
    torch.save(build_synthetic_reference_checkpoint(
        jcfg, np.random.default_rng(4)), src)
    npz = tmp_path / "port.npz"
    port_convert_cli.main(["--kind", "prismer", "--src", str(src), "--dst",
                           str(npz), "--prismer_model", "prismer_tiny",
                           "--experts", "depth", "--image_resolution",
                           "64"])
    want = Prismer(cfg, device="meta").to_empty(device="cpu")
    port_convert_cli.load_npz_into(want, str(npz))
    model = build_random_prismer(cfg, 0, "cpu")
    values = common.load_pretrained(str(src), cfg, model)
    got = model.state_dict()
    for key, value in want.state_dict().items():
        if key in values:
            assert torch.equal(got[key], value), key
            assert torch.equal(values[key], value.float()), key
    assert "text_decoder.lm_head.bias" in values
    # a file leaf of another shape than the model's raises
    sd = torch.load(src, weights_only=True)
    bias = next(k for k in sd if k.endswith("cls.predictions.bias")
                or k.endswith("lm_head.bias"))
    sd[bias] = sd[bias][:-1]
    torch.save(sd, src)
    with pytest.raises(ValueError, match="in the file, .* in the model"):
        common.load_pretrained(str(src), cfg,
                               build_random_prismer(cfg, 0, "cpu"))
