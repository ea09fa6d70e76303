"""The control of the comparison: the reference put in the program's place,
computed one precision step lower (TF32 operands in every product a matrix
multiply would form, ``reference.render.round_tf32``), read by the same
numbers as a run. Its readings set the upper end of each limit; the
benchmark's own runs never run it.

    python3 gpu_bench/control.py --workload <cell> --seeds 11 12 13

prints one JSON line a seed: the control's numbers beside the limits."""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_numbers(root: str, cell_name: str, seed: int, device, cfg_overrides: dict | None = None) -> dict:
    from gpu_bench import check, harness, loops, seeded
    from gpu_bench.reference import render as ref
    from gpu_bench.reference import train as ref_train
    from gpu_bench.scene import make_inputs, reference_scene

    bench = harness.load_benchmark(root)
    cell = harness.find_cell(bench, cell_name)
    cfg = harness.load_config(root, bench, cell["config"])
    cfg.update(cfg_overrides or {})
    mix = harness.load_traffic(cell["traffic"])
    w, h = cfg["width"], cfg["height"]
    inputs = make_inputs(cfg, seed, device)
    exact = reference_scene(cfg, inputs, device)
    lower = reference_scene(cfg, inputs, device, tf32=True)
    num = int(cfg["camera"]["poses"])
    path = torch.as_tensor(seeded.camera_path(seed, cfg["camera"], num), device=device)
    if mix["loop"] == "frames":
        gen = torch.Generator().manual_seed(seed % seeded.SEED_MOD)
        ks = torch.randperm(num, generator=gen)[: int(mix["sample_frames"])].tolist()
        want, got = [], []
        with torch.no_grad():
            for k in ks:
                p = path[k]
                want.append(ref.render(exact, p[0:3], p[3], p[4], w, h))
                got.append(ref.render(lower, p[0:3], p[3], p[4], w, h, tf32=True))
        return check.frame_numbers(got, want)
    views = int(mix["views"])
    poses = loops.train_views(seed, cfg["camera"], views, device)
    targets = seeded.targets(seed, views, h, w, device)
    n, lr = int(mix["checked_steps"]), float(mix["learning_rate"])
    idx = [k % views for k in range(n)]
    args = ([poses[i] for i in idx], [targets[i] for i in idx], w, h, lr)
    losses, g1, banks = ref_train.sgd_steps(exact, *args)
    c_losses, _, c_banks = ref_train.sgd_steps(lower, *args, tf32=True)
    prog = dict(losses=c_losses, p0=exact.bank, p1=c_banks[0], pn=c_banks[-1])
    refd = dict(losses=losses, p0=exact.bank, p1=banks[0], pn=banks[-1], g1=g1)
    return check.train_numbers(prog, refd, lr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the comparison's control, one precision step lower")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("gpu_bench: the control runs on the card", file=sys.stderr)
        return 3
    from gpu_bench import check

    limits = check.load_limits(HERE, args.workload)
    for seed in args.seeds:
        numbers = control_numbers(ROOT, args.workload, seed, "cuda")
        fails = [k for k, v in numbers.items() if v > limits.get(k, float("inf"))]
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers, "limits": limits,
                          "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
