"""Image IO — the counterpart of ``physically_based_renderer_tpu/utils/image_io.py``,
written with NumPy and the standard library's zlib and lzma so it needs no imaging
package: ``load_image`` (PNG, JPEG, BMP, DDS, GIF, TIFF, WebP, ICO and TGA:
``utils/_png.py``, ``utils/_jpeg.py`` with ``utils/_jpeg_arith.py`` and
``utils/_jpeg_lossless.py``, ``utils/_bmp.py``, ``utils/_dds.py``
with ``utils/_bcn.py``, ``utils/_gif.py``, ``utils/_tiff.py`` (with
``_jpeg.py`` for JPEG-in-TIFF), ``utils/_webp.py`` with ``utils/_vp8l.py``
and ``utils/_vp8.py``, ``utils/_ico.py``, ``utils/_tga.py``; TIFF's codecs ``utils/_zstd.py``,
``utils/_ccitt.py``, its CIELab ``utils/_lab.py``), ``load_hdr``,
``save_hdr``, ``save_png`` and ``find_asset_root``."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Decode a PNG, JPEG (sequential or progressive, Huffman- or
    arithmetic-coded, or lossless; gray, YCbCr, RGB, CMYK or YCCK; a
    progressive file short of scans block-smoothed, scans out of order
    decoded as libjpeg decodes them), BMP, DDS (uncompressed, BC1-BC7), GIF
    (its first frame), TIFF
    (its first image, turned by its orientation: raw, LZW, Deflate,
    PackBits, JPEG, old-style JPEG, LZMA, Zstd, CCITT (Modified Huffman,
    RLEW, G3 1-D and 2-D, G4) or ThunderScan; gray, RGB, YCbCr, palette,
    CMYK, CIELab; 1-32-bit, signed and float samples), WebP (lossless,
    lossy, lossy with alpha; the first frame of an animation), ICO (PIL's
    entry: PNG- or BMP-coded) or TGA file → (H, W, C) uint8, the file's kind
    told by its content, not its name, as PIL tells it: the signatures
    first (ICO's ``\\0\\0\\1\\0`` before TGA, which has none, as PIL's plugin
    order has it), then TGA by the header checks PIL makes. The JAX
    package's mode rules (PIL): gray stays one channel, images with alpha
    become RGBA (C 4), all others RGB (C 3; a WebP file is never gray; 16-,
    32-bit and float gray go through ``convert("RGB")``). The samples equal
    PIL's decode bit for bit (CIELab through LittleCMS's conversion, to
    RGBA as PIL gives it); a file PIL refuses raises ``ValueError``."""
    from ._bmp import SIGNATURE as BMP_SIGNATURE, decode_bmp
    from ._dds import SIGNATURE as DDS_SIGNATURE, decode_dds
    from ._gif import SIGNATURES as GIF_SIGNATURES, decode_gif
    from ._ico import decode_ico, looks_like_ico
    from ._jpeg import SIGNATURE as JPEG_SIGNATURE, decode_jpeg
    from ._png import SIGNATURE as PNG_SIGNATURE, decode_png
    from ._tga import decode_tga, looks_like_tga
    from ._tiff import SIGNATURES as TIFF_SIGNATURES, decode_tiff
    from ._webp import decode_webp, is_webp

    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data)
    if data.startswith(BMP_SIGNATURE):
        return decode_bmp(data)
    if data.startswith(DDS_SIGNATURE):
        return decode_dds(data)
    if data[:6] in GIF_SIGNATURES:
        return decode_gif(data)
    if data[:4] in TIFF_SIGNATURES:
        return decode_tiff(data)
    if is_webp(data):
        return decode_webp(data)
    if looks_like_ico(data):
        return decode_ico(data)
    if looks_like_tga(data):
        return decode_tga(data)
    raise ValueError(f"{path}: not a PNG, JPEG, BMP, DDS, GIF, TIFF, WebP, ICO or TGA file (first bytes "
                     f"{data[:8]!r})")


def load_hdr(path: str) -> np.ndarray:
    """Decode a Radiance RGBE (.hdr) file → (H, W, 3) float32 linear radiance
    (header, flat or adaptive-RLE scanlines; the sIBL ``*_Env.hdr`` format)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = 0
    exposure = 1.0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line.startswith(b"EXPOSURE="):
            exposure *= float(line.split(b"=", 1)[1])
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].split()
    pos = eol + 1
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {dims!r}")
    height, width = int(dims[1]), int(dims[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((height, width, 4), np.uint8)
    off = 0
    for y in range(height):
        if (8 <= width < 32768 and off + 4 <= len(buf) and buf[off] == 2 and buf[off + 1] == 2
                and ((int(buf[off + 2]) << 8) | int(buf[off + 3])) == width):
            off += 4  # adaptive RLE: the 4 components stored one after another
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[off])
                    off += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[off]
                        off += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = buf[off : off + count]
                        off += count
                        x += count
        else:
            row = buf[off : off + width * 4].reshape(width, 4)
            if ((row[:, 0] == 1) & (row[:, 1] == 1) & (row[:, 2] == 1)).any():
                raise NotImplementedError("old-style RLE HDR not supported")
            rgbe[y] = row
            off += width * 4

    mant = rgbe[..., :3].astype(np.float32)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    out = mant * scale[..., None]
    # FreeImage writes a bogus EXPOSURE=0 header (Chelsea_Stairs_Env.hdr):
    # only a meaningful positive exposure rescales.
    if exposure > 0.0 and exposure != 1.0:
        out /= exposure
    return out


def save_hdr(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float32 linear radiance → Radiance RGBE, flat
    scanlines: one shared exponent a pixel, the mantissas truncated."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    nz = maxc > 1e-32
    _, e = np.frexp(maxc[nz])  # maxc = f·2^e, f ∈ [0.5, 1)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[nz, :3] = np.clip(img[nz] * np.ldexp(1.0, 8 - e)[:, None], 0, 255).astype(np.uint8)
    rgbe[nz, 3] = (e + 128).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def save_png(path: str, img: np.ndarray) -> None:
    """Write an image to PNG. Accepts float [0,1] (H,W,3|4) or uint8."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]  # grey, RGB, RGBA

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


# Where the JAX package also looks for the reference renderer's assets.
REFERENCE_ASSETS = os.path.join(os.sep, "root", "reference", "Assets")


def find_asset_root() -> str | None:
    """The reference asset tree, if one is present: ``$PBR_ASSETS``, else the
    reference renderer's mounted tree (``REFERENCE_ASSETS``), else an
    ``Assets`` directory at the repository root — the JAX package's order."""
    for cand in (
        os.environ.get("PBR_ASSETS", ""),
        REFERENCE_ASSETS,
        os.path.join(os.path.dirname(__file__), "..", "..", "Assets"),
    ):
        if cand and os.path.isdir(cand):
            return os.path.abspath(cand)
    return None
