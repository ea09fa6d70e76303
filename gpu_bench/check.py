"""The numbers that decide ``correct``: the program's outputs against the
reference's, each number beside its limit (``limits/<cell>.json``).

Frames: the share of pixels whose largest RGBA difference exceeds
``OFF_PX``, and the mean absolute difference, over the frames compared.

Training steps: the worst step's loss gap; the median leaf's gap between
the norms of the first gradient (the program's worked out from its bank
after one step: (p0 − p1)/lr); and of the bank's change after the checked
steps. A leaf gap is |‖prog‖ − ‖ref‖| over the larger of the reference
leaf's norm and the median leaf's. The median is over the leaves whose
reference gradient is not zero: a field the frame reads through a blend
weight of 0 (the constant colour of a fully textured slot, the opacity,
which no RGB pixel reads) has a gradient of exactly 0. Leaves under
``LEAF_FLOOR`` of that median are left out of the gradient and change
gaps.

The gradient and change gaps are the upper median of the leaf gaps, not
their largest. The largest is the small ``uv_transform`` leaf's on most
seeds: its texture offsets' gradients are sums of bilinear slopes that
cancel, so a rounding-level shift of the uv moves them by tenths of
themselves on some seeds. The upper median reads 1 where the program
leaves its state unchanged (at least half the leaves are at or above the
median leaf's norm)."""

from __future__ import annotations

import json
import math
import os
import statistics

import torch

OFF_PX = 0.02  # a display-unit difference a viewer sees
LEAF_FLOOR = 1e-3


def frame_numbers(frames: list, refs: list) -> dict:
    """Compare program frames with reference frames (lists of (H, W, 4))."""
    off, total, abs_sum, count, finite = 0, 0, 0.0, 0, True
    for got, want in zip(frames, refs):
        got = got.to(want.device, torch.float32)
        finite = finite and bool(torch.isfinite(got).all())
        d = (got - want).abs()
        d = torch.where(torch.isfinite(d), d, torch.full_like(d, 1.0))
        off += int((d.amax(-1) > OFF_PX).sum())
        total += d.shape[0] * d.shape[1]
        abs_sum += float(d.double().sum())
        count += d.numel()
    return {"off_px_share": off / total, "mean_abs_err": abs_sum / count, "non_finite": 0.0 if finite else 1.0}


def _norms(fields: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in fields.items()}


def train_numbers(prog: dict, ref: dict, learning_rate: float) -> dict:
    """``prog`` and ``ref`` hold ``losses`` (checked steps), ``p0``, ``p1``
    and ``pn`` (the bank before, after one step, after the checked steps;
    field → tensor) and the reference also ``g1`` (its first gradients)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    finite = all(math.isfinite(x) for x in prog["losses"])
    g_ref = _norms(ref["g1"])
    med = statistics.median(v for v in g_ref.values() if v > 0.0)
    leaves = [k for k in g_ref if g_ref[k] >= LEAF_FLOOR * med]
    g_prog = _norms({k: (prog["p0"][k].double() - prog["p1"][k].double()) / learning_rate for k in leaves})
    c_ref = _norms({k: ref["pn"][k].double() - ref["p0"][k].double() for k in leaves})
    c_prog = _norms({k: prog["pn"][k].double() - prog["p0"][k].double() for k in leaves})
    g_med, c_med = statistics.median(g_ref[k] for k in leaves), statistics.median(c_ref.values())
    grad_gap = statistics.median_high([abs(g_prog[k] - g_ref[k]) / max(g_ref[k], g_med) for k in leaves])
    change_gap = statistics.median_high([abs(c_prog[k] - c_ref[k]) / max(c_ref[k], c_med) for k in leaves])
    out = {"loss_gap": loss_gap, "grad_gap_median": grad_gap, "change_gap_median": change_gap,
           "non_finite": 0.0 if finite else 1.0}
    return {k: (v if math.isfinite(v) else 1.0) for k, v in out.items()}


def load_limits(root: str, cell: str) -> dict:
    path = os.path.join(root, "limits", f"{cell}.json")
    with open(path) as f:
        return json.load(f)["limits"]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (a number passes at or under it); a
    number without a limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
