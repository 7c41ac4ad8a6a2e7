"""Why the label stems' ReLU-fed leaves (`chip_smoke.RELU_FED`: each
stem's Conv_i and bn_i) are the leaves where two fp32 BASE train steps
that should agree part most. Phase "multi-gpu" of chip_smoke.py holds
them at TOL_TRAIN_GRAD_RELU when two ranks run the stems at batch 2 and
one process at 4; this probe reads what differs.

    python3 tools/probe_relu_fed.py

Needs one card. Prismer-BASE, six experts, 480 px, fp32, TF32 off:
  A. two ranks on the card over gloo, the fp32 "dp" step at batch 4 (2
     rows a rank) against one process on the 4 rows, with cuDNN's default
     algorithm choice and with `cudnn.deterministic`: the largest gradient
     rel L2 on the ReLU-fed leaves and on the others; rank 0's stem
     BatchNorm outputs (the ReLUs' inputs) against one process's rows:
     largest difference and how many elements lie on the other side of
     zero;
  B. one process, dropout 0: the step on the 4 rows against the same
     step with the rows in reverse order (the same sum, added in another
     order; the same shapes, so the same algorithms): the same two
     errors; and the cancellation in each stem BatchNorm bias's gradient,
     sum |g| / |sum g| over the (B, H, W) elements of each channel
     (median and largest over the channels; the worst leaf's BatchNorm).
Prints one line a reading and writes them to
chiprun_out/probe_relu_fed.json with the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

STEM_BN = re.compile(r"\.conv1_\w+\.bn_\d$")
LR = 5e-5


def _errors(got, want):
    """(largest rel L2 on the ReLU-fed leaves, its leaf, largest on the
    others, its leaf)."""
    errs = {n: cs.grad_rel(n, got[n], want[n], want) for n in want}
    fed = [n for n in errs if cs.RELU_FED.search(n)]
    rest = [n for n in errs if n not in fed]
    assert len(fed) == 72, len(fed)
    w_fed, w_rest = max(fed, key=errs.get), max(rest, key=errs.get)
    return errs[w_fed], w_fed, errs[w_rest], w_rest


def _step(cfg, batch, mesh=None, grads_at_bn=None):
    """One fp32 step from the seeded state: (whole gradients on the CPU,
    the stem BatchNorm outputs in module order); with `grads_at_bn` (a
    dict), the gradient at each stem BatchNorm's output under its name."""
    import functools

    import torch

    from prismer_tpu_torch.parallel import zero
    from prismer_tpu_torch.train import build_train_step
    state = cs.train_state(cfg, "cuda", LR)
    outs = []

    def hook(name, mod, args, y):
        outs.append(y.detach().clone())
        if grads_at_bn is not None:
            y.register_hook(lambda g: grads_at_bn.__setitem__(
                name, g.detach().clone()))

    hooks = [m.register_forward_hook(functools.partial(hook, n))
             for n, m in state.model.named_modules() if STEM_BN.search(n)]
    step = build_train_step(state.model, mesh, "dp")
    state, _ = step(state, batch)
    for h in hooks:
        h.remove()
    grads = {n: g.cpu() for n, g in zero.full_grads(state).items()}
    del state, step
    torch.cuda.empty_cache()
    return grads, outs


def _apart(outs_a, outs_b, rows):
    """(largest difference, elements on the other side of zero, elements)
    of the first list against `rows` of the second."""
    pairs = list(zip(outs_a, outs_b))
    assert len(pairs) == 24, len(pairs)
    return (max((a - b[rows]).abs().max().item() for a, b in pairs),
            sum(int(((a > 0) != (b[rows] > 0)).sum()) for a, b in pairs),
            sum(a.numel() for a, _ in pairs))


def _rank():
    """One of two gloo ranks on the card (reading A); rank 0's readings."""
    import torch

    from prismer_tpu_torch.ops import _build
    from prismer_tpu_torch.parallel import runtime
    from prismer_tpu_torch.parallel.mesh import (batch_rows, make_mesh,
                                                 shard_batch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.kernels()
    mesh = make_mesh(device="cuda")
    cfg = cs.slice_config("float32")
    batch = cs._to_cuda(cs.caption_batch(cfg, 4, torch.Generator()
                                         .manual_seed(cs.SEED + 13), "cpu"))
    rows = batch_rows(4, mesh)
    out = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        g_dp, o_dp = _step(cfg, shard_batch(batch, mesh), mesh)
        g_one, o_one = _step(cfg, batch)
        out[det] = {"grads": _errors(g_dp, g_one),
                    "stems": _apart(o_dp, o_one, rows)}
        del o_dp, o_one
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out if runtime.rank() == 0 else None


def _reversed(tree):
    if isinstance(tree, dict):
        return {k: _reversed(v) for k, v in tree.items()}
    return tree.flip(0)


def _cancellation(grads_at_bn):
    """{stem BatchNorm: (median, largest) over its channels of
    sum |g| / |sum g|}, g its output's gradient (what its bias sums)."""
    out = {}
    for name, g in grads_at_bn.items():
        g = g.double().reshape(-1, g.shape[-1])
        ratio = g.abs().sum(0) / g.sum(0).abs().clamp_min(1e-300)
        out[name] = (ratio.median().item(), ratio.max().item())
    return out


def main() -> int:
    import torch

    from prismer_tpu_torch.ops import _build
    from prismer_tpu_torch.parallel import runtime
    if not torch.cuda.is_available():
        print("no CUDA device: this probe needs one GPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_info()
    print(f"card: {card}", flush=True)
    _build.build()
    _build.kernels()
    readings = {"card": card}

    with tempfile.TemporaryDirectory() as d:
        ranks = runtime.spawn(_rank, 2, "cuda", d, backend="gloo",
                              timeout=600)
    for det, r in ranks[0].items():
        e_fed, n_fed, e_rest, n_rest = r["grads"]
        diff, flips, n = r["stems"]
        label = "deterministic" if det else "default"
        print(f"A. 2 gloo ranks vs one process, cuDNN {label}: ReLU-fed "
              f"{e_fed:.3g} at {n_fed}, others {e_rest:.3g} at {n_rest}; "
              f"stem BatchNorm outputs {diff:.3g} apart, {flips} of {n} "
              f"elements across zero ({card})", flush=True)
        readings[f"A_{label}"] = {"relu_fed": [e_fed, n_fed],
                                  "others": [e_rest, n_rest],
                                  "stem_bn_max_abs_diff": diff,
                                  "stem_bn_across_zero": flips,
                                  "stem_bn_elements": n}

    cfg = cs.slice_config("float32")
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, hidden_dropout_prob=0.0))
    batch = cs._to_cuda(cs.caption_batch(cfg, 4, torch.Generator()
                                         .manual_seed(cs.SEED + 13), "cpu"))
    at_bn = {}
    g_fwd, o_fwd = _step(cfg, batch, grads_at_bn=at_bn)
    g_rev, o_rev = _step(cfg, _reversed(batch))
    e_fed, n_fed, e_rest, n_rest = _errors(g_rev, g_fwd)
    diff, flips, n = _apart([o.flip(0) for o in o_rev], o_fwd,
                            slice(None))
    canc = _cancellation(at_bn)
    assert len(canc) == 24, len(canc)
    worst_bn = n_fed.rsplit(".", 1)[0].replace(".Conv_", ".bn_")
    print(f"B. one process, rows reversed vs in order: ReLU-fed "
          f"{e_fed:.3g} at {n_fed}, others {e_rest:.3g} at {n_rest}; stem "
          f"BatchNorm outputs {diff:.3g} apart, {flips} of {n} across zero",
          flush=True)
    med = sorted(c[0] for c in canc.values())
    print(f"B. cancellation sum|g| / |sum g| in the stem BatchNorm biases' "
          f"gradients: the channel median {med[0]:.3g} to {med[-1]:.3g} "
          f"over the 24 BatchNorms, largest channel "
          f"{max(c[1] for c in canc.values()):.3g}; {worst_bn}: median "
          f"{canc[worst_bn][0]:.3g}, largest {canc[worst_bn][1]:.3g}",
          flush=True)
    readings["B"] = {"relu_fed": [e_fed, n_fed], "others": [e_rest, n_rest],
                     "stem_bn_max_abs_diff": diff, "stem_bn_across_zero":
                     flips, "stem_bn_elements": n,
                     "cancellation_median_max": canc}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_relu_fed.json").write_text(json.dumps(readings, indent=1))
    return 0



if __name__ == "__main__":
    sys.exit(main())
