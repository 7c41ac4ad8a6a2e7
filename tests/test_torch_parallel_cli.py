"""`cli.train_caption.main` at 2 ranks on the CPU with --multihost
--full_shard, as torchrun starts it (the group opened by the driver from
RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT, gloo): each rank trains on
its shard of the data under ZeRO-3, captions its shard of the test split,
rank 0 scores and writes the gathered results and the checkpoint (the
single-process format: one process loads it), and a second run resumes
from that checkpoint under --full_shard. The data tree and the argument
list are tests/test_torch_cli.py's."""

import json
import socket

import pytest
import torch

from prismer_tpu_torch.parallel import runtime
from tests import torch_parallel_util as util
from tests.test_torch_cli import tree  # noqa: F401  (the data tree fixture)

torch.set_num_threads(2)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _argv(tree, name, *extra):
    return ["--config", tree.cfgs[name], "--exp_name", "mh",
            "--mixed_precision", "fp32", "--tokenizer_dir", str(tree.tok_dir),
            "--logging_dir", str(tree.root / "mh_logging"),
            "--results_dir", str(tree.root / "mh_results"),
            "--device", "cpu", "--multihost", "--full_shard", *extra]


@pytest.fixture(scope="module")
def outs(tree, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("mh")
    runs = [dict(module="prismer_tpu_torch.cli.train_caption",
                 argv=_argv(tree, "caption"), port=_free_port()),
            dict(module="prismer_tpu_torch.cli.train_caption",
                 argv=_argv(tree, "caption2", "--from_checkpoint"),  # 2 epochs
                 port=_free_port())]
    return runtime.spawn(util.rank_driver, 2, "cpu", str(tmp / "store"),
                         args=(runs,))


def test_train_caption_full_shard_at_two_ranks(tree, outs):  # noqa: F811
    first = [o[0] for o in outs]
    for out in first:
        assert out.count("Epoch 000") <= 1
    assert "Epoch 000 | loss " in first[0] and "| CIDEr " in first[0]
    scores = json.loads(first[0].strip().splitlines()[-1])
    assert "CIDEr" in scores
    res = json.loads((tree.root / "mh_results"
                      / "caption_results_mh_coco.json").read_text())
    # the two shards' captions, gathered by rank 0
    assert sorted(r["image_id"] for r in res) == [5, 7, 42]


def test_resume_under_full_shard_at_two_ranks(tree, outs):  # noqa: F811
    second = [o[1] for o in outs]
    assert "resuming from epoch 1" in second[0]
    assert "Epoch 001 | loss " in second[0] and "Epoch 000" not in second[0]
    ckpt = tree.root / "mh_logging" / "caption_mh" / "state"
    payload = torch.load(ckpt, weights_only=True)
    # one step an epoch a rank (two records each of batch 2), two epochs
    assert payload["metadata"]["epoch"] == 1 and payload["step"] == 2
    # the single-process layout: whole tensors, the optimizer by index
    assert not any(hasattr(t, "placements")
                   for t in payload["model"].values())
    assert sorted(payload["optimizer"]["state"]) == list(range(
        len(payload["optimizer"]["param_groups"][0]["params"])))
