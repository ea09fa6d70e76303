"""The roofline counts on a tiny scene: the work is what the frame needs,
counted from the reference's own view of it."""

from __future__ import annotations

import pytest
import torch

from gpu_bench import harness, roofline
from gpu_bench.reference import render as ref
from gpu_bench.scene import make_inputs, reference_scene

from .conftest import ROOT, small


@pytest.mark.parametrize("cell", ["rustediron_ibl.fwd", "pbr_scene.fwd"])
def test_frame_work_counts(cell):
    bench = harness.load_benchmark(ROOT)
    cfg = harness.load_config(ROOT, bench, harness.find_cell(bench, cell)["config"])
    cfg.update(small(cell))
    w, h = cfg["width"], cfg["height"]
    rs = reference_scene(cfg, make_inputs(cfg, 7, "cpu"), "cpu")
    pose = torch.tensor([*cfg["camera"]["centre"][:2], cfg["camera"]["centre"][2] - cfg["camera"]["radius"], 0.0, 0.0])
    work = roofline.frame_work(rs, pose, w, h)
    clip = ref.to_clip(rs.corners[..., 0:3], ref.view_proj(pose[0:3], pose[3], pose[4], w / h))
    _, _, _, valid = ref.front_triangles(clip, w, h)
    hits = int((ref.rasterize(clip, w, h) >= 0).sum())
    assert work["hits"] == hits > 0 and 0 < work["tris"] <= int(valid.sum())
    k4_bytes, k4_flops = work["kernel4"]
    assert k4_bytes == work["tris"] * 55 * 4 + w * h * 4 + hits * 15 * 4
    assert k4_flops == hits * roofline.plane_flops(15)
    ps_bytes, ps_flops = work["ps_stage"]
    assert ps_bytes > hits * (15 + 4) * 4 and ps_flops >= hits * roofline.shade_flops(4, 0, 0, False, False)
    least = roofline.least_seconds(*work["ps_stage"])
    assert least == max(ps_bytes / roofline.HBM_BYTES_PER_S, ps_flops / roofline.FP32_FLOPS)


def test_texels_are_counted_once_and_per_level():
    pages = ref.Pages.build(torch.zeros((2, 8, 8, 3), dtype=torch.uint8), [False, False])
    page = torch.tensor([0, 0, 1])
    uv = torch.tensor([[0.5, 0.5], [0.5, 0.5], [0.01, 0.99]])
    rows = roofline._tap_rows(pages, page, uv, None)
    assert rows.numel() == 12 and torch.unique(rows).numel() == 8  # the repeated sample reads no new texel
    rows = roofline._tap_rows(pages, page, uv, torch.tensor([0.5, 0.5, 3.0]))
    assert torch.unique(rows).numel() == 4 + 4 + 1  # levels 0 and 1 of page 0; page 1 at the last level (one texel)
    assert bool((rows < pages.stack.shape[0]).all())


def test_shares_cannot_pass_100():
    work = (1.0e6, 1.0e9)
    least = roofline.least_seconds(*work)
    assert 100.0 * least / least == 100.0
    assert 100.0 * least / (2 * least) == 50.0
    assert roofline.shade_flops(4, 0, 0, True, False) == 51 + 380 + 15
