"""Write the WebP fixtures of this directory and their manifest entries.

    python tests/data/make_webp_fixtures.py

Needs NumPy and PIL (with libwebp). Each file is encoded by PIL and decoded
again by PIL as the JAX package's ``load_image`` does (RGB, or RGBA for a
file with alpha); ``manifest.json`` keeps, per file, the shape, the size in
bytes and the SHA-256 of PIL's decoded samples (C-order uint8 bytes),
against which the port's decoder is held (``tests/test_torch_image_webp.py``
and phase aj of ``chip_smoke.py`` on the card's machine, which has no PIL).
The other entries of the manifest stay as they are:

  * ``page_color_1024_lossless.webp``: PIL's decode of the committed
    ``page_color_1024.jpg``, lossless (VP8L), ``method=4``; it decodes to
    that JPEG's own digest;
  * ``page_color_1024_q90.webp``: the same pixels, lossy (VP8),
    ``quality=90``, ``method=6``;
  * ``page_rgba_512_q80.webp``: a 512² RGBA page drawn from fixed NumPy
    seeds (``make_jpeg_fixtures.page``, its alpha a smooth field), lossy
    with an ``ALPH`` chunk (``quality=80``, ``alpha_quality=100``: the alpha
    plane VP8L-coded under the horizontal filter).
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from make_jpeg_fixtures import page, smooth_field  # noqa: E402


def colour_page() -> np.ndarray:
    with Image.open(os.path.join(HERE, "page_color_1024.jpg")) as im:
        return np.asarray(im)


def rgba_page() -> np.ndarray:
    img = page(25, 4)[:512, :512].copy()
    alpha = 0.5 + 0.45 * smooth_field(np.random.default_rng(26), 512, 512, 1)[..., 0]
    img[..., 3] = np.round(np.clip(alpha, 0.0, 1.0) * 255.0).astype(np.uint8)
    return img


FIXTURES = {
    "page_color_1024_lossless.webp": (colour_page, dict(lossless=True, method=4)),
    "page_color_1024_q90.webp": (colour_page, dict(quality=90, method=6)),
    "page_rgba_512_q80.webp": (rgba_page, dict(quality=80, method=4, alpha_quality=100)),
}


def main() -> None:
    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)
    for name, (make, options) in FIXTURES.items():
        buf = io.BytesIO()
        Image.fromarray(make()).save(buf, format="WEBP", **options)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            decoded = np.ascontiguousarray(np.asarray(im))
        manifest[name] = {"shape": list(decoded.shape), "bytes": len(data),
                          "decoded_sha256": hashlib.sha256(decoded.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
