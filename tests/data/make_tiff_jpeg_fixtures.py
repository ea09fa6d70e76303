"""Write the JPEG-in-TIFF fixture of this directory and its manifest entry.

    python tests/data/make_tiff_jpeg_fixtures.py

Needs NumPy and PIL (with libjpeg and libtiff). ``page_color_1024_tiles.tif``
holds PIL's decode of the committed ``page_color_1024.jpg`` as a tiled,
JPEG-compressed TIFF the way libtiff lays one out: 240×240 tiles (the edge
tiles padded by repeating the last row and column, then cropped on reading),
each tile a JPEG stream that PIL encodes (``quality=90``, 4:2:0, YCbCr),
the quantisation and Huffman tables moved into the ``JPEGTables`` tag so that
every tile is an abbreviated stream (``chip_smoke.split_jpeg_tables``), the
container written by ``chip_smoke.write_jpeg_tiff`` (photometric 6,
``YCbCrSubsampling`` 2×2). PIL reads the file back through libtiff, as the
JAX package's ``load_image`` does; ``manifest.json`` keeps its shape, its
size in bytes and the SHA-256 of those samples (C-order uint8 bytes), against
which the port's decoder is held (``tests/test_torch_image_tiff_jpeg_ico.py``
and phase ak of ``chip_smoke.py`` on the card's machine, which has no PIL).
The other entries of the manifest stay as they are.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from chip_smoke import split_jpeg_tables, write_jpeg_tiff  # noqa: E402

NAME, TILE = "page_color_1024_tiles.tif", 240


def tiles(img: np.ndarray) -> tuple[bytes, list]:
    """The shared tables and each tile's abbreviated stream, in rows of tiles."""
    h, w, _ = img.shape
    tables, chunks = None, []
    for y in range(0, h, TILE):
        for x in range(0, w, TILE):
            block = img[y:y + TILE, x:x + TILE]
            block = np.pad(block, ((0, TILE - block.shape[0]), (0, TILE - block.shape[1]), (0, 0)), mode="edge")
            buf = io.BytesIO()
            Image.fromarray(block).save(buf, format="JPEG", quality=90, subsampling=2)
            t, chunk = split_jpeg_tables(buf.getvalue())
            assert tables in (None, t), "PIL changed its tables between tiles"
            tables = t
            chunks.append(chunk)
    return tables, chunks


def main() -> None:
    with Image.open(os.path.join(HERE, "page_color_1024.jpg")) as im:
        page = np.asarray(im)
    tables, chunks = tiles(page)
    path = os.path.join(HERE, NAME)
    write_jpeg_tiff(path, chunks, page.shape[1], page.shape[0], tile=(TILE, TILE), tables=tables)
    with Image.open(path) as im:
        decoded = np.ascontiguousarray(np.asarray(im))
    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)
    manifest[NAME] = {"shape": list(decoded.shape), "bytes": os.path.getsize(path),
                      "decoded_sha256": hashlib.sha256(decoded.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
