"""Run one cell of the benchmark once and print its result line.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Each run is a fresh process: it builds (or finds built) the program's
kernels, makes its inputs from the seed, warms up the cell's shapes,
measures for ``--seconds`` (``--trace 1``: profiles a bounded number of
frames or steps instead), checks what the timed path produced against the
plain reference, and prints one JSON line as the last line of standard
output. It needs the CUDA card(s) the cell asks for and exits non-zero
without printing a result where there are none.

Everything is found by name from ``BENCHMARK.json``: the configuration's
file (``configs/<config>.json``), the traffic mix (``traffic/<mix>.json``),
each per-layer metric's reader (``metrics/<metric>.py``) and each cell's
limits (``limits/<cell>.json``)."""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here, before the heavy imports

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "physically_based_renderer_tpu")


def cache_env(root: str) -> None:
    """Fixed cache directories inside the checkout for every compiler cache
    a run could touch (the program's own nvcc builds go to ``build/kernels``
    of the checkout)."""
    base = os.path.join(root, "build", "gpu_bench", "cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    sys.path.insert(0, ROOT)
    from gpu_bench import harness  # noqa: E402

    try:
        bench = harness.load_benchmark(ROOT)
        cell = harness.find_cell(bench, args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"gpu_bench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"gpu_bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = harness.run_cell(ROOT, bench, cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
                              device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"gpu_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
