"""The result line: its keys and types, the traced run's device fields and
breakdown, and the refusal to print one without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from .conftest import ROOT, run_small


def _check_line(res, traced):
    assert list(res)[-1] == "checks"
    assert isinstance(res["correct"], bool) and res["correct"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev) and dev["count"] == 1
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name
    if traced:
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert len(res["breakdown"]["device_ops"]) <= 10 and len(res["breakdown"]["idle_gaps"]) <= 10
    json.dumps(res)


def test_untraced_line_has_the_end_to_end_metrics():
    res = run_small("rustediron_ibl.fwd")
    _check_line(res, False)
    assert set(res["metrics"]) == {"setup_s", "frame_rate", "frame_p95_ms"}


def test_traced_line_has_device_fields_and_breakdown():
    res = run_small("rustediron_ibl.fwd", traced=True)
    _check_line(res, True)
    assert "setup_s" not in res["metrics"] and res["attempted"] == 12
    assert "raster_ms.fwd" in res["metrics"]  # a host span; the device metrics need the card's trace


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        return
    out = subprocess.run([sys.executable, os.path.join(ROOT, "gpu_bench", "run.py"), "--workload", "pbr_scene.fwd",
                          "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
