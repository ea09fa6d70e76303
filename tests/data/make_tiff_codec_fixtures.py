"""Write the Zstd and CCITT TIFF fixtures of this directory and their
manifest entries.

    python tests/data/make_tiff_codec_fixtures.py

Needs NumPy and PIL (with libtiff built with Zstd). Each file is written by
PIL's own TIFF writer (libtiff):

* ``page_color_1024_zstd.tif``: PIL's decode of the committed
  ``page_color_1024.jpg`` as a Zstd-compressed TIFF (compression 50000)
  under horizontal differencing (predictor 2), PIL's strips. It decodes to
  the colour JPEG's own samples, so its digest is that JPEG's;
* ``page_mask_1024_g4.tif``: PIL's decode of ``page_gray_1024.jpg``
  thresholded at > 128 as a 1-bit CCITT T.6 (Group 4) TIFF;
* ``page_mask_1024_g3.tif``: the same mask as two-dimensional T.4 (Group 3,
  T4Options bit 0), which decodes to the Group 4 file's samples.

PIL reads each back through libtiff, as the JAX package's ``load_image``
does; ``manifest.json`` keeps its shape, its size in bytes and the SHA-256
of those samples (C-order uint8 bytes), against which the port's decoder is
held (``tests/test_torch_image_tiff_codecs.py`` and phase am of
``chip_smoke.py`` on the card's machine, which has neither PIL nor a Zstd
package). The other entries of the manifest stay as they are.
"""

import hashlib
import json
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = {  # name → (source page, PIL's save options)
    "page_color_1024_zstd.tif": ("page_color_1024.jpg", dict(compression="zstd", tiffinfo={317: 2})),
    "page_mask_1024_g4.tif": ("page_gray_1024.jpg", dict(compression="group4")),
    "page_mask_1024_g3.tif": ("page_gray_1024.jpg", dict(compression="group3", tiffinfo={292: 1})),
}


def main() -> None:
    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)
    for name, (source, save) in FILES.items():
        with Image.open(os.path.join(HERE, source)) as im:
            page = np.asarray(im)
        img = Image.fromarray(page) if "color" in name else Image.fromarray(page > 128).convert("1")
        path = os.path.join(HERE, name)
        img.save(path, **save)
        with Image.open(path) as im:
            decoded = np.ascontiguousarray(np.asarray(im.convert("RGB") if im.mode == "1" else im))
        manifest[name] = {"shape": list(decoded.shape), "bytes": os.path.getsize(path),
                          "decoded_sha256": hashlib.sha256(decoded.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
