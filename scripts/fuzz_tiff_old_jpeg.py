"""Hold the port's old-style JPEG TIFF reader (``utils/_ojpeg.py``) to PIL
over seeded mutants of every layout it reads.

    python scripts/fuzz_tiff_old_jpeg.py [MUTANTS_A_LAYOUT] [SEED]

Needs NumPy, PIL (with libtiff and libjpeg) and the JAX package's
``load_image`` (the reference: ``PIL.Image.open``). Nine 40×37 files —
the table layout at 2×2 and at 1×1, gray, the split header, one
interchange-format stream, 16×32 tiles two across, a restart interval over
a stream with its own RSTn, big-endian, separate planes — each mutated
``MUTANTS_A_LAYOUT`` times (200 by default): bits flipped in the data before
the IFD, a table offset moved, a strip's or tile's offset or byte count
changed, ``YCbCrSubsampling`` / ``JPEGRestartInterval`` / ``RowsPerStrip`` /
``JPEGInterchangeFormat`` set, the tables made one, two strips swapped.
Each mutant must decode to PIL's samples bit for bit or be refused by both
(the port with ``ValueError``). Prints the count of each outcome per layout
and exits non-zero if any mutant differs. The tier-1 tests keep 60 of these
(``tests/test_torch_image_tiff_old_jpeg.py::test_mutation_fuzz``).
"""

from __future__ import annotations

import io
import os
import struct
import sys
import tempfile

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from chip_smoke import write_old_jpeg_tiff  # noqa: E402
from physically_based_renderer_tpu.utils.image_io import load_image as jax_load_image  # noqa: E402
from physically_based_renderer_tpu_torch.utils import _tiff  # noqa: E402
from physically_based_renderer_tpu_torch.utils.image_io import load_image  # noqa: E402
from test_torch_image_formats import _seeded_photo  # noqa: E402
from test_torch_image_gif_tiff import tiff_ifd  # noqa: E402


def _jpeg(block: np.ndarray, subsampling: int = 2, **kw) -> bytes:
    buf = io.BytesIO()
    gray = block.shape[-1] == 1
    Image.fromarray(block[..., 0] if gray else block).save(
        buf, "JPEG", quality=85, **({} if gray else {"subsampling": subsampling}), **kw)
    return buf.getvalue()


def _bases(d: str) -> dict:
    rng = np.random.default_rng(7)
    img, gray = _seeded_photo(rng, 40, 37, 3), _seeded_photo(rng, 40, 37, 1)
    pad = np.pad(img, ((0, 8), (0, 27), (0, 0)), mode="edge")
    strips = [_jpeg(img[y:y + 16]) for y in range(0, 40, 16)]
    layouts = {
        "tables": (strips, dict(rows_per_strip=16)),
        "tables 1x1": ([_jpeg(img[y:y + 8], 0) for y in range(0, 40, 8)], dict(rows_per_strip=8, subsampling=(1, 1))),
        "gray": ([_jpeg(gray[y:y + 16]) for y in range(0, 40, 16)], dict(rows_per_strip=16, photometric=1)),
        "split header": (strips, dict(rows_per_strip=16, layout="split")),
        "interchange": ([_jpeg(img)], dict(layout="interchange")),
        "tiles": ([_jpeg(pad[y:y + 16, x:x + 32]) for y in (0, 16, 32) for x in (0, 32)], dict(tile=(16, 32))),
        "restart markers": ([_jpeg(img, restart_marker_blocks=2)], dict(restart_interval=2)),
        "big-endian": (strips, dict(rows_per_strip=16, byteorder=">")),
        "separate planes": ([_jpeg(img[y:y + 24, :, c:c + 1]) for c in range(3) for y in (0, 24)],
                            dict(rows_per_strip=24, extra={284: (3, [2]), 258: (3, [8, 8, 8]), 277: (3, [3]),
                                                           530: (3, [1, 1])})),
    }
    out = {}
    for name, (streams, kw) in layouts.items():
        path = os.path.join(d, "base.tif")
        write_old_jpeg_tiff(path, streams, 37, 40, **kw)
        with open(path, "rb") as f:
            out[name] = f.read()
    return out


def _mutant(data: bytes, rng) -> bytes:
    order, tags, types = _tiff._ifd(data)
    t = {k: (types[k], list(v)) for k, v in tags.items()}
    (ifd,) = struct.unpack_from(order + "I", data, 4)
    blob = bytearray(data[8:ifd])
    op = int(rng.integers(6))
    offsets, counts = (324, 325) if 324 in t else (273, 279)
    if op == 0:
        for _ in range(int(rng.integers(1, 4))):
            blob[int(rng.integers(len(blob)))] ^= 1 << int(rng.integers(8))
    elif op == 1 and any(k in t for k in (519, 520, 521)):
        k = int(rng.choice([k for k in (519, 520, 521) if k in t]))
        j = int(rng.integers(len(t[k][1])))
        t[k][1][j] = max(0, t[k][1][j] + int(rng.integers(-70, 70)))
    elif op == 2:
        k = (offsets, counts)[int(rng.integers(2))]
        j = int(rng.integers(len(t[k][1])))
        t[k][1][j] = max(0, t[k][1][j] + int(rng.integers(-40, 40)))
    elif op == 3:
        k = int(rng.choice([530, 515, 278, 513]))
        t[k] = {530: (3, [int(x) for x in rng.choice([1, 2, 4], 2)]), 515: (3, [int(rng.integers(0, 12))]),
                278: (4, [int(rng.choice([8, 16, 24, 32, 40, 7]))]), 513: (4, [int(rng.integers(8, len(data)))])}[k]
        if k == 513:
            t[514] = (4, [int(rng.integers(0, 400))])
    elif op == 4 and 519 in t:
        k = int(rng.choice([519, 520, 521]))
        t[k] = (4, [t[k][1][0]] * len(t[k][1]) if rng.integers(2) else t[k][1][:1])
    elif len(t[offsets][1]) > 1:
        i, j = (int(x) for x in rng.choice(len(t[offsets][1]), 2, replace=False))
        for k in (offsets, counts):
            t[k][1][i], t[k][1][j] = t[k][1][j], t[k][1][i]
    return tiff_ifd(t, order, data=bytes(blob))


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 23
    differ = 0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.tif")
        for name, data in _bases(d).items():
            rng = np.random.default_rng([seed, len(name)])
            seen = {"equal": 0, "both refuse": 0, "differ": 0}
            for _ in range(n):
                with open(path, "wb") as f:
                    f.write(_mutant(data, rng))
                try:
                    ref = jax_load_image(path)
                except Exception:  # noqa: BLE001 — whatever PIL raises for a file it refuses
                    ref = None
                try:
                    got = load_image(path)
                except ValueError:
                    got = None
                if ref is None and got is None:
                    seen["both refuse"] += 1
                elif ref is not None and got is not None and ref.shape == got.shape and np.array_equal(ref, got):
                    seen["equal"] += 1
                else:
                    seen["differ"] += 1
            differ += seen["differ"]
            print(f"{name}: {seen}")
    print(f"{differ} of {9 * n} mutants differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
