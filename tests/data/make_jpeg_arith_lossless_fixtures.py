"""Write the arithmetic-coded, lossless and block-smoothed JPEG fixtures of
this directory and their manifest entries.

    python tests/data/make_jpeg_arith_lossless_fixtures.py

Needs NumPy, PIL and the port (``tests/jpeg_encoders.py`` reads the Huffman
fixtures' coefficients through its coefficient store). Every file comes from
the committed fixtures of ``make_jpeg_fixtures.py``, themselves drawn from
fixed seeds, so a rerun writes the same bytes:

  * ``page_color_1024_arith.jpg``: SOF9, the colour page's seeded pixels
    as PIL encodes them at quality 80 (4:2:0), re-coded arithmetically
    (default conditioning, no restarts). Not ``page_color_1024.jpg``'s own
    coefficients: PIL reads a JPEG in 64 KB blocks and libjpeg's arithmetic
    decoder cannot wait for the next, so PIL reads no arithmetic scan of
    more than ~64 KB, and that page's one scan is ~98 KB;
  * ``page_color_1024_progressive_arith.jpg``: SOF10,
    ``page_color_1024_progressive.jpg``'s coefficients and its scan script
    (libjpeg's simple progression; its largest scan ~60 KB), with a COM
    segment across each 64 KB boundary that a scan would cross, so that
    PIL's reads stop in the markers: ``page_color_1024.jpg``'s decode;
  * ``page_gray_1024_lossless.jpg``: SOF3, predictor 7, no point transform,
    ``page_gray_1024.jpg``'s decoded samples: that page's decode;
  * ``page_color_1024_smoothed.jpg``: the progressive twin without its last
    three scans (the final AC refinements of Cr, Cb and Y), which libjpeg
    block-smooths.

``manifest.json`` gets, per file, the shape, the size and the SHA-256 of
PIL's decoded samples (C-order uint8), against which the port's decoder is
held (``tests/test_torch_image_jpeg_arith_lossless.py``, and ``chip_smoke.py``
phase al on the card's machine, which has no PIL).
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)  # for make_jpeg_fixtures
sys.path.insert(0, os.path.dirname(HERE))  # tests/, for jpeg_encoders
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # the repository, for the port

import jpeg_encoders as enc  # noqa: E402
from make_jpeg_fixtures import page  # noqa: E402


def _read(name: str) -> bytes:
    with open(os.path.join(HERE, name), "rb") as f:
        return f.read()


def _pil_reads(data: bytes) -> bool:
    try:
        with Image.open(io.BytesIO(data)) as im:
            im.load()
        return True
    except OSError:
        return False


def padded_for_pil(data: bytes) -> bytes:
    """A multi-scan arithmetic file with a COM segment before each scan that
    PIL would not read otherwise, long enough to cross the 64 KB boundary
    ahead of it: PIL's read stops in the COM (libjpeg suspends there) and
    the scan starts a fresh 64 KB."""
    head, scans, tail = enc.split_scans(data)
    out = head
    for scan in scans:
        if not _pil_reads(out + scan + tail):
            boundary = -(-(len(out) + 4) // 65536) * 65536  # the COM's length field wants at least 2
            out += b"\xff\xfe" + (boundary - len(out) - 1).to_bytes(2, "big") + bytes(boundary - len(out) - 3)
        out += scan
        assert _pil_reads(out + tail), "a scan longer than PIL's 64 KB reads"
    return out + tail


def fixtures() -> dict:
    progressive = _read("page_color_1024_progressive.jpg")
    buf = io.BytesIO()
    Image.fromarray(page(21, 3)).save(buf, "JPEG", quality=80, subsampling=2)
    with Image.open(io.BytesIO(_read("page_gray_1024.jpg"))) as im:
        gray = np.asarray(im)
    head, scans, tail = enc.split_scans(progressive)
    assert len(scans) == 10, len(scans)
    return {
        "page_color_1024_arith.jpg": enc.transcode_to_arith(buf.getvalue()),
        "page_color_1024_progressive_arith.jpg": padded_for_pil(enc.transcode_to_arith(progressive, progressive=True)),
        "page_gray_1024_lossless.jpg": enc.write_lossless([gray], [(1, 1)], psv=7),
        "page_color_1024_smoothed.jpg": enc.join_scans(head, scans[:7], tail),
    }


def main() -> None:
    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)  # the other writers' entries stay
    for name, data in fixtures().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            decoded = np.ascontiguousarray(np.asarray(im))
        if decoded.ndim == 2:
            decoded = decoded[..., None]
        manifest[name] = {"shape": list(decoded.shape), "bytes": len(data),
                          "decoded_sha256": hashlib.sha256(decoded.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
