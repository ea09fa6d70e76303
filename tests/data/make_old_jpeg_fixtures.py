"""Write the old-style JPEG TIFF fixtures of this directory and their
manifest entries.

    python tests/data/make_old_jpeg_fixtures.py

Needs NumPy and PIL (with libjpeg and libtiff). Each file holds PIL's decode
of a committed JPEG page as an old-style JPEG TIFF (compression 6) in the
table layout, written by ``chip_smoke.write_old_jpeg_tiff``: 16 strips of 64
rows, each a JPEG stream PIL encodes (``quality=85``, standard Huffman
tables) of which the strip keeps only its entropy-coded data;
``JPEGQTables``, ``JPEGDCTables`` and ``JPEGACTables`` point at the first
strip's bare tables (the chroma components share one offset each), and
``JPEGRestartInterval`` is the MCUs of one strip — libtiff's restart
interval for such a file, an RSTn between every two strips:

* ``page_color_1024_old_jpeg.tif``: ``page_color_1024.jpg``, three samples
  at 4:2:0 (photometric 6, ``YCbCrSubsampling`` 2×2);
* ``page_gray_1024_old_jpeg.tif``: ``page_gray_1024.jpg``, one sample
  (photometric 1).

The output depends on nothing but the committed pages and PIL's encoder.
PIL reads each back through libtiff's old-style JPEG codec, as the JAX
package's ``load_image`` does; ``manifest.json`` keeps its shape, its size
in bytes and the SHA-256 of those samples (C-order uint8 bytes), against
which the port's decoder is held (``tests/test_torch_image_tiff_old_jpeg.py``
and phase an of ``chip_smoke.py`` on the card's machine, which has no PIL).
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

from chip_smoke import write_old_jpeg_tiff  # noqa: E402

FILES = {"page_color_1024_old_jpeg.tif": ("page_color_1024.jpg", 6),  # name → (source page, photometric)
         "page_gray_1024_old_jpeg.tif": ("page_gray_1024.jpg", 1)}
ROWS = 64  # a strip


def main() -> None:
    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)
    for name, (source, photometric) in FILES.items():
        with Image.open(os.path.join(HERE, source)) as im:
            page = np.asarray(im)
        streams = []
        for y in range(0, page.shape[0], ROWS):
            buf = io.BytesIO()
            Image.fromarray(page[y:y + ROWS]).save(buf, format="JPEG", quality=85,
                                                   **({"subsampling": 2} if page.ndim == 3 else {}))
            streams.append(buf.getvalue())
        mcu = 16 if page.ndim == 3 else 8
        path = os.path.join(HERE, name)
        write_old_jpeg_tiff(path, streams, page.shape[1], page.shape[0], photometric=photometric,
                            rows_per_strip=ROWS, restart_interval=-(-page.shape[1] // mcu) * (ROWS // mcu))
        with Image.open(path) as im:
            decoded = np.ascontiguousarray(np.asarray(im))
        if decoded.ndim == 2:
            decoded = decoded[..., None]
        manifest[name] = {"shape": list(decoded.shape), "bytes": os.path.getsize(path),
                          "decoded_sha256": hashlib.sha256(decoded.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
