"""The deformable-attention kernel's launch plan
(prismer_tpu_torch.experts.ops.deform_attn.deform_plan, mirrored by
`make_plan` in csrc/ms_deform_attn.cu), on the CPU: which levels are staged
in shared memory at the segmentation expert's shapes and at the small and
odd shapes the kernel also takes, the shared memory a block asks for, and
that the blocks cover every (n, q, h) exactly once. Then the plain version
against JAX's gather formulation and the interpret-mode TPU kernel
`ms_deform_attn_onehot` on Mask2Former-shaped locations (each query's
reference point plus Deformable DETR's grid-initialised offsets and pixel
jitter), made with numpy from a seed (atol 1e-5: the same sums in another
order). The CUDA kernel itself is held to the plain version on the card by
chip_smoke.py."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prismer_tpu.experts.ops import deform_attn as jax_da
from prismer_tpu.experts.ops import deform_attn_pallas as jax_dap
from prismer_tpu_torch.experts.ops import deform_attn as port_da

torch.set_num_threads(2)

SEG_LEVELS = ((15, 15), (30, 30), (60, 60))     # res5, res4, res3 at 480 px
SEG_S = sum(h * w for h, w in SEG_LEVELS)
SMALL = ((12, 16), (6, 8), (3, 4))
MAX_SMEM = 232_448          # a block's shared memory on sm_90
CSRC = (Path(port_da.__file__).resolve().parents[2] / "csrc"
        / "ms_deform_attn.cu")


def _covered(plan, n, lq, heads):
    """How often each (n, q, h) is a task of some block: block b takes
    (n, h, chunk) = (b // (chunks * heads), b // chunks % heads,
    b % chunks), and queries chunk * per ... in index order."""
    seen = np.zeros((n, lq, heads), np.int64)
    for block in range(plan["blocks"]):
        chunk = block % plan["chunks"]
        nh = block // plan["chunks"]
        begin = chunk * plan["per"]
        seen[nh // heads, begin:min(begin + plan["per"], lq),
             nh % heads] += 1
    return seen


@pytest.mark.parametrize("n", [16, 5, 1])
def test_plan_at_the_segmentation_shapes(n):
    plan = port_da.deform_plan(SEG_LEVELS, n, SEG_S, 8, 32, 4)
    assert plan["vec"] == 4
    assert plan["staged"] == [0, 1]          # 15 x 15 and 30 x 30, not 60 x 60
    assert plan["stage_rows"] == 225 + 900
    assert plan["smem"] == 32_768 + 144_000 + 128 <= MAX_SMEM
    assert plan["boxes"][:2] == [1, 4] and plan["box_rows"][:2] == [225, 225]
    assert plan["srow"] == [0, 225, -1]
    # about one block an SM
    assert plan["blocks"] <= 132 and plan["blocks"] >= 120
    assert (_covered(plan, n, SEG_S, 8) == 1).all()


@pytest.mark.parametrize("lq", [40, 37])
def test_plan_at_the_cpu_test_shapes(lq):
    plan = port_da.deform_plan(SMALL, 2, lq, 4, 8, 4)
    assert plan["vec"] == 4
    assert plan["staged"] == [0, 1, 2]
    # smallest level first; 32-byte rows, boxes of whole 128-byte lines
    assert plan["srow"] == [60, 12, 0]
    assert plan["smem"] == 32_768 + 252 * 32 + 128
    assert (_covered(plan, 2, lq, 4) == 1).all()


@pytest.mark.parametrize("case", ["large_level", "d_not_boxed", "d_wide",
                                  "unaligned", "one_query"])
def test_gather_path_where_staging_does_not_suit(case):
    shapes, n, lq, heads, d, aligned = SEG_LEVELS, 2, SEG_S, 8, 32, True
    if case == "large_level":
        shapes = ((100, 100), (30, 30))
        lq = 10_900
    elif case == "d_not_boxed":
        d = 6
    elif case == "d_wide":
        d = 260
    elif case == "unaligned":
        aligned = False
    else:
        lq = 1
    plan = port_da.deform_plan(shapes, n, lq, heads, d, 4, aligned=aligned)
    assert plan["smem"] <= MAX_SMEM
    if case == "large_level":
        assert plan["staged"] == [1] and plan["srow"][0] == -1
        assert plan["smem"] == 32_768 + 900 * 128 + 128
    else:
        assert plan["staged"] == [] and plan["smem"] == 32_768 + 128
    assert plan["vec"] == (1 if case in ("d_not_boxed", "unaligned") else 4)
    assert (_covered(plan, n, lq, heads) == 1).all()


def test_constants_match_the_cuda_source():
    text = CSRC.read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", text)
        assert m, name
        return m.group(1).strip()

    assert const("kWarps") == str(port_da.WARPS)
    assert const("kBoxRows") == str(port_da.BOX_ROWS)
    assert const("kStageBytes") == "160 * 1024" == \
        f"{port_da.STAGE_BYTES // 1024} * 1024"
    assert const("kMinQueries") == "2 * kWarps"
    assert const("kGroup") == "8"             # 4 queries a warp
    assert const("kTableBytes") == "kWarps * 64 * 32"
    assert port_da.TABLE_BYTES == port_da.WARPS * 64 * 32 == 32_768
    assert port_da.MIN_QUERIES == 2 * port_da.WARPS


def _mask2former_case(seed, n, heads, d, shapes, p=4, jitter=2.0):
    """value, locations and weights at Lq = S: each query's own pixel
    centre on its level's grid, plus head h's direction (cos, sin of 2 pi h
    / H, scaled to the unit square's edge) times p + 1 pixels of level l,
    plus N(0, jitter^2) pixels, divided by (W_l, H_l)."""
    rng = np.random.default_rng(seed)
    s = sum(hl * wl for hl, wl in shapes)
    nl = len(shapes)
    ref = []
    for hl, wl in shapes:
        ys, xs = np.meshgrid((np.arange(hl) + 0.5) / hl,
                             (np.arange(wl) + 0.5) / wl, indexing="ij")
        ref.append(np.stack([xs.ravel(), ys.ravel()], -1))
    ref = np.concatenate(ref)                                  # (S, 2)
    theta = np.arange(heads) * 2 * np.pi / heads
    grid = np.stack([np.cos(theta), np.sin(theta)], -1)
    grid /= np.abs(grid).max(-1, keepdims=True)
    pixels = grid[:, None, :] * np.arange(1, p + 1)[None, :, None]
    pixels = pixels[None, None, :, None] + jitter * rng.standard_normal(
        (n, s, heads, nl, p, 2))
    norm = np.array([[wl, hl] for hl, wl in shapes], np.float64)
    loc = (ref[None, :, None, None, None, :]
           + pixels / norm[None, None, None, :, None, :]).astype(np.float32)
    value = rng.standard_normal((n, s, heads, d)).astype(np.float32)
    logits = rng.standard_normal((n, s, heads, nl * p))
    attn = np.exp(logits - logits.max(-1, keepdims=True))
    attn = (attn / attn.sum(-1, keepdims=True)).reshape(
        n, s, heads, nl, p).astype(np.float32)
    return value, loc, attn


@pytest.mark.parametrize("reference", ["gather", "onehot_interpret"])
def test_plain_matches_jax_on_mask2former_shaped_locations(reference):
    shapes = ((3, 3), (6, 6), (12, 12))
    value, loc, attn = _mask2former_case(7, 1, 2, 8, shapes)
    # the case reaches past the maps' edges, as the model's does
    assert ((loc < 0) | (loc > 1)).any()
    args = (jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    if reference == "gather":
        want = jax_da.ms_deform_attn(*args)
    else:
        want = jax_dap.ms_deform_attn_onehot(*args, q_tile=64, c_tile=128,
                                             interpret=True)
    got = port_da.ms_deform_attn(torch.from_numpy(value), shapes,
                                 torch.from_numpy(loc),
                                 torch.from_numpy(attn)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
