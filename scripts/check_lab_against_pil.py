"""Hold the port's CIELab → sRGB conversion (``utils/_lab.lab_to_rgb``) to
PIL's ``convert("RGB")`` of mode LAB over all 2^24 8-bit Lab triples.

    python scripts/check_lab_against_pil.py

Needs NumPy and PIL (with LittleCMS); runs on the CPU in about half a
minute, one L* value (2^16 triples) at a time. Prints the number of triples
that differ (0 when the port's table and interpolation are LittleCMS's) and
exits non-zero if any do. The tier-1 tests keep a seeded subsample of this
(``tests/test_torch_image_tiff_codecs.py::test_lab_to_rgb_subsample``).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from physically_based_renderer_tpu_torch.utils._lab import lab_to_rgb  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    ab = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1).reshape(-1, 2)
    flip = np.array([0, 128, 128], np.uint8)  # PIL's LAB unpacker flips a* and b*'s sign bits
    differ = 0
    for lum in range(256):
        lab = np.concatenate([np.full((len(ab), 1), lum), ab], 1).astype(np.uint8)
        pil = np.asarray(Image.frombytes("LAB", (256, 256), (lab ^ flip).tobytes()).convert("RGB")).reshape(-1, 3)
        differ += int((lab_to_rgb(lab) != pil).any(1).sum())
    print(f"{differ} of {256 ** 3} Lab triples differ from PIL's convert('RGB') "
          f"({time.perf_counter() - t0:.1f} s on the CPU)")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
