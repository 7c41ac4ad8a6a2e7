"""The bf16 launch plans of the encoder's fused LayerNorm kernels (14
`ln_proj`, 15 `adaptor_fused`), on the CPU.

`ops.ln_proj.ln_proj_plan` / `adaptor_plan` mirror `proj_plan` / `ad_plan`
in csrc/ln_proj.cu, and the C entries refuse a call whose plan differs. They
are pinned at every registry encoder width (D 768, 1024, 1280) at the row
counts of batch 1, 5, 8 and 16 of the model with that width (964, 640 and
1220 tokens) and at R = 1 and 17: each fits a block's shared memory, and
the tiles of `ln_proj`'s persistent walk cover every (row, column) of every
output exactly once, none straddles two outputs and none stores a row at or
past R. No test here needs a card.
"""

import pytest
import torch

from prismer_tpu_torch.ops import ln_proj as lp

SMEM_MAX = 232448
TOKENS = {768: 964, 1024: 640, 1280: 1220}
ROWS = [(d, r) for d, t in TOKENS.items()
        for r in (t, 5 * t, 8 * t, 16 * t, 1, 17)]


def _cdiv(a, b):
    return -(-a // b)


def _check_walk(plan, r, fs):
    """Every (row, column) of every output stored exactly once: the tiles
    are the aligned 128 x 256 grid of each output, each once, clipped to R
    and F_i, and the blocks' walks partition them evenly."""
    seen = set()
    per_block = [0] * plan["blocks"]
    for block, out, row0, col0, rows, cols in lp.ln_proj_tiles(plan, fs):
        assert (out, row0, col0) not in seen
        seen.add((out, row0, col0))
        per_block[block] += 1
        assert row0 % 128 == 0 and col0 % 256 == 0
        assert 0 < rows <= 128 and row0 + rows <= r        # no row past R
        assert 0 < cols <= 256 and col0 + cols <= fs[out]  # one output only
    want = {(i, row0, col0) for i, f in enumerate(fs)
            for row0 in range(0, r, 128) for col0 in range(0, f, 256)}
    assert seen == want
    assert min(per_block) >= 1 and max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("d, r", ROWS)
def test_ln_proj_plan_covers_every_output_once(d, r):
    for fs in ((d, d, d), (4 * d,)):
        plan = lp.ln_proj_plan(r, d, fs)
        assert plan["kind"] == "wgmma" and plan["cluster"] == (1, 1, 1)
        assert plan["smem"] <= SMEM_MAX
        assert plan["threads"] == 384 and plan["stages"] == 3
        assert plan["chunks"] == d // 64
        assert plan["col_tiles"] == sum(_cdiv(f, 256) for f in fs)
        assert plan["tiles"] == _cdiv(r, 128) * plan["col_tiles"]
        assert plan["blocks"] == min(plan["tiles"], lp.H100_SMS)
        assert plan["scratch_bytes"] == r * 8
        _check_walk(plan, r, fs)


@pytest.mark.parametrize("d, r", ROWS)
def test_adaptor_plan_fits_and_covers_every_row(d, r):
    plan = lp.adaptor_plan(r, d)
    assert plan["kind"] == "wgmma" and plan["cluster"] == (1, 1, 1)
    assert plan["smem"] <= SMEM_MAX and 2 <= plan["stages"] <= 4
    # a block's 64 rows: the last block holds row R - 1, none starts past it
    assert (plan["blocks"] - 1) * 64 < r <= plan["blocks"] * 64
    assert plan["col_tiles"] * 128 >= d > (plan["col_tiles"] - 1) * 128
    assert plan["scratch_bytes"] == r * 8
    # one more stage would not fit
    stage = 64 * 128 + 128 * 128
    assert (plan["stages"] == 4
            or plan["smem"] + stage + 16 > SMEM_MAX)


@pytest.mark.parametrize("r, d, fs, want", [
    (7712, 768, (768,) * 3, {"tiles": 549, "blocks": 132, "smem": 221232}),
    (7712, 768, (3072,), {"tiles": 732, "blocks": 132, "smem": 221232}),
    (9760, 1280, (5120,), {"tiles": 1540, "blocks": 132, "smem": 225328}),
    (17, 768, (768,) * 3, {"tiles": 9, "blocks": 9, "smem": 221232}),
])
def test_ln_proj_plan_pinned(r, d, fs, want):
    """The numbers PERF.md quotes: at BASE q/k/v 549 tiles fill 4.16
    rounds of 132 blocks."""
    plan = lp.ln_proj_plan(r, d, fs)
    assert {k: plan[k] for k in want} == want


@pytest.mark.parametrize("d, stages, smem", [(768, 4, 214600),
                                             (1024, 3, 222776),
                                             (1280, 2, 230952)])
def test_adaptor_plan_pinned(d, stages, smem):
    plan = lp.adaptor_plan(8 * TOKENS[d], d)
    assert (plan["stages"], plan["smem"]) == (stages, smem)
    assert plan["blocks"] == _cdiv(8 * TOKENS[d], 64)


def test_fp32_plans_are_the_fma_kernels():
    """fp32 (the parity checks) keeps the FMA kernels' grids: ln_proj
    column groups of 768 x row tiles of 32, the adaptor 16 rows a block."""
    p = lp.ln_proj_plan(964, 768, (768, 768, 768), torch.float32)
    assert p["kind"] == "fma" and p["grid"] == (3, 31) and p["blocks"] == 93
    assert p["smem"] == (32 * 772 + 3 * 128 * 36) * 4
    a = lp.adaptor_plan(964, 1280, torch.float32)
    assert a["grid"] == (61, 1) and a["smem"] == (2 * 16 * 1284
                                                  + 3 * 128 * 36) * 4
    assert p["scratch_bytes"] == a["scratch_bytes"] == 0
