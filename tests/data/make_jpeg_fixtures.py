"""Write the JPEG fixtures of this directory and their manifest.

    python tests/data/make_jpeg_fixtures.py

Needs NumPy and PIL (with libjpeg-turbo). Each image is drawn from a fixed
NumPy seed, encoded by PIL at quality 90 (baseline, optimised Huffman tables
off) and decoded again by PIL; ``manifest.json`` keeps, per file, the shape
and the SHA-256 of PIL's decoded samples (C-order uint8 bytes; a CMYK file
as PIL's ``convert("RGB")``, as ``load_image`` gives it), against which the
port's decoder is held (``tests/test_torch_image_io.py``,
``tests/test_torch_image_formats.py``, and ``chip_smoke.py`` on the card's
machine, which has no PIL):

  * ``page_color_1024.jpg``: a 1024² 4:2:0 colour page, the size of the
    reference's ``_1K`` texture sets;
  * ``page_gray_1024.jpg``: a 1024² grayscale page;
  * ``background_3k.jpg``: a 3072×1536 4:2:0 equirect background, the size
    of an sIBL ``_3k`` image;
  * ``page_color_1024_progressive.jpg`` and ``page_gray_1024_progressive.jpg``:
    the two pages again from the same arrays, quality and subsampling,
    progressive (libjpeg's simple progression): the same coefficients, so
    the same decode as their baseline twins;
  * ``cmyk_512.jpg``: a 512² CMYK page (Adobe marker, inverted samples, as
    PIL writes CMYK), baseline.
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
QUALITY = 90


def smooth_field(rng, height: int, width: int, channels: int) -> np.ndarray:
    """(height, width, channels) in about [−1, 1]: three sinusoids a channel
    at integer frequencies 1-4, so the field tiles."""
    yy, xx = (np.mgrid[0:height, 0:width] + 0.5)
    out = np.zeros((height, width, channels))
    for c in range(channels):
        for _ in range(3):
            kx, ky = rng.integers(1, 5, 2)
            out[..., c] += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * (kx * xx / width + ky * yy / height)
                                                          + rng.uniform(0, 2 * np.pi))
    return out / 3.0


def page(seed: int, channels: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = 0.5 + 0.4 * smooth_field(rng, 1024, 1024, channels) + rng.normal(0.0, 0.012, (1024, 1024, channels))
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def cmyk_page(seed: int) -> np.ndarray:
    """(512, 512, 4): a smooth C, M, Y field and a lighter K."""
    img = page(seed, 4)[:512, :512].copy()
    img[..., 3] //= 3
    return img


def background(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h, w = 1536, 3072
    vv = ((np.arange(h) + 0.5) / h)[:, None, None]
    sky = np.concatenate([0.35 + 0.5 * (1 - vv), 0.45 + 0.4 * (1 - vv), 0.55 + 0.4 * (1 - vv)], -1)
    img = sky + 0.1 * smooth_field(rng, h, w, 3) + rng.normal(0.0, 0.01, (h, w, 3))
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


FIXTURES = {
    "page_color_1024.jpg": (lambda: page(21, 3), dict(subsampling=2)),
    "page_gray_1024.jpg": (lambda: page(22, 1)[..., 0], {}),
    "background_3k.jpg": (lambda: background(23), dict(subsampling=2)),
    "page_color_1024_progressive.jpg": (lambda: page(21, 3), dict(subsampling=2, progressive=True)),
    "page_gray_1024_progressive.jpg": (lambda: page(22, 1)[..., 0], dict(progressive=True)),
    "cmyk_512.jpg": (lambda: cmyk_page(24), dict(mode="CMYK")),
}


def main() -> None:
    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)  # other writers' entries (make_bcn_fixtures.py) stay
    for name, (make, opts) in FIXTURES.items():
        buf = io.BytesIO()
        opts = dict(opts)
        Image.fromarray(make(), opts.pop("mode", None)).save(buf, "JPEG", quality=QUALITY, **opts)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            decoded = np.ascontiguousarray(np.asarray(im.convert("RGB") if im.mode == "CMYK" else im))
        if decoded.ndim == 2:
            decoded = decoded[..., None]
        manifest[name] = {"shape": list(decoded.shape), "bytes": len(data),
                          "decoded_sha256": hashlib.sha256(decoded.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
