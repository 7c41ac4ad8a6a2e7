"""`prismer_tpu_torch.parallel.dryrun`: JAX's dryrun_multichip checks at 4
ranks over gloo on the CPU (ZeRO-3 + tensor parallelism on a 2 x 2 mesh
below 0.45 of the parameters a rank, ZeRO-2's optimizer state likewise, a
finite step of each, sharded generation equal to one process's with the
serving kernels' plain versions forced on, fp32 and int8 cross K/V), and
the refusal, by the function (whose default is the card) and by the
command line, of more ranks than cards."""

import pytest
import torch

from prismer_tpu_torch.parallel import dryrun

torch.set_num_threads(2)


def test_dryrun_multichip_4_on_the_cpu(capsys):
    r = dryrun.dryrun_multichip(4, "cpu")
    assert r["zero3_ratio"] < 0.45 and r["zero2_ratio"] < 0.45
    assert r["ids_off"].shape == (4, 12) == r["ids_int8"].shape
    assert "dryrun_multichip(4): ok" in capsys.readouterr().out


def test_dryrun_multichip_runs_on_the_cards_by_default():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices"):
        dryrun.dryrun_multichip(2)


def test_dryrun_command_needs_a_card_a_rank():
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as e:
        dryrun.main(["2"])
    assert e.value.code == 2
