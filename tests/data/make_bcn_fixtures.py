"""Write the decoded digests of the seeded block-compressed DDS pages into
this directory's manifest.

    python tests/data/make_bcn_fixtures.py

Needs NumPy and PIL. The pages are not files here: ``chip_smoke.seeded_bcn_pages``
draws their blocks from a fixed ``numpy.random.default_rng`` seed (its
stream is the same on every NumPy), so the card's machine, which has no
PIL, makes the same bytes. This script decodes each page with PIL as the
JAX package's ``load_image`` does (BC1-BC3 and BC7 RGBA, BC4 L, BC5 and
BC6H RGB) and keeps, under the page's name in ``manifest.json``, its shape,
its size in bytes and the SHA-256 of the decoded samples (C-order uint8
bytes), against which the port's decoder is held
(``tests/test_torch_image_dds.py``, phase ai of ``chip_smoke.py``). The
other entries of the manifest stay as they are.
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

from chip_smoke import seeded_bcn_pages  # noqa: E402


def main() -> None:
    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)
    for name, data in seeded_bcn_pages().items():
        with Image.open(io.BytesIO(data)) as im:
            decoded = np.asarray(im)
        if decoded.ndim == 2:
            decoded = decoded[..., None]
        decoded = np.ascontiguousarray(decoded)
        manifest[name] = {"shape": list(decoded.shape), "bytes": len(data),
                          "decoded_sha256": hashlib.sha256(decoded.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
