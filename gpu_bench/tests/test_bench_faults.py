"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of the run is driven at
the test size, on the CPU."""

from __future__ import annotations

import dataclasses

import physically_based_renderer_tpu_torch as port
from physically_based_renderer_tpu_torch.parallel import sharded

from .conftest import run_small


def test_frame_altered_where_produced(monkeypatch):
    real = port.render

    def altered(*args, **kwargs):
        img = real(*args, **kwargs)
        return brighten_band(img)

    monkeypatch.setattr(port, "render", altered)
    res = run_small("rustediron_ibl.fwd")
    assert not res["correct"]


def brighten_band(img):
    """Brighten one 8-row band of the frame by 0.05."""
    out = img.clone()
    out[8:16, :, :3] += 0.05
    return out


def test_step_returns_its_state_unchanged(monkeypatch):
    real = port.make_train_step

    def make(**kw):
        step = real(**kw)

        def unchanged(scene, camera, target):
            _, loss = step(scene, camera, target)
            return scene, loss

        return unchanged

    monkeypatch.setattr(port, "make_train_step", make)
    res = run_small("pbr_scene.train")
    assert not res["correct"]
    assert res["checks"]["grad_gap_median"]["value"] == 1.0
    assert res["checks"]["change_gap_median"]["value"] == 1.0


class _HalfMean:
    """``torch`` as the trainer sees it, but its ``mean`` over the first
    half of the rows only: half of the batch left out."""

    def __init__(self, torch_mod):
        self._t = torch_mod

    def __getattr__(self, name):
        return getattr(self._t, name)

    def mean(self, x, *a, **k):
        return self._t.mean(x[: x.shape[0] // 2], *a, **k)


def test_half_of_the_batch_left_out(monkeypatch):
    monkeypatch.setattr(sharded, "torch", _HalfMean(sharded.torch))
    res = run_small("pbr_scene.train")
    assert not res["correct"]


def test_faults_restore():
    assert dataclasses.is_dataclass(port.Camera) and sharded.torch.__name__ == "torch"
