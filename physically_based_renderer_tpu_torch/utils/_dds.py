"""DDS (DirectDraw Surface) decoding with NumPy — the ``.dds`` part of
``utils/image_io.load_image``, bit for bit what PIL's ``DdsImagePlugin``
gives under the JAX package's mode rules.

The 124-byte header, its pixel format and the DX10 header; only the top
mip level of the first face, as PIL reads. Uncompressed ``DDPF_RGB`` at
any bit count with any masks (RGB, or RGBA with ``DDPF_ALPHAPIXELS``): each
field shifted down by its mask's trailing zeros and scaled as PIL's
``DdsRgbDecoder`` scales it, ``int(v / (mask >> shift) * 255)`` in float64,
truncated; a file shorter than its pixels reads zeros past its end, as
that decoder does. ``DDPF_LUMINANCE`` at 8 bits (L) and at 16 bits with
alpha (LA, which becomes RGBA); ``DDPF_PALETTEINDEXED8`` (an RGBA palette
of 256 entries, P, which becomes RGB without the alpha); DX10
``R8G8B8A8_*``; the block-compressed formats PIL lists (``utils/_bcn.py``).
A header PIL refuses, and a format it does not implement, raise
``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from ._bcn import decode_bcn

SIGNATURE = b"DDS "
HEADER = 128  # the magic and the 124-byte header
ALPHAPIXELS, FOURCC, PALETTEINDEXED8, RGB, LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
FOURCCS = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3", b"BC4U": "BC4", b"ATI1": "BC4", b"BC5S": "BC5S",
           b"BC5U": "BC5", b"ATI2": "BC5"}
DXGI = {70: "BC1", 71: "BC1", 73: "BC2", 74: "BC2", 76: "BC3", 77: "BC3", 79: "BC4", 80: "BC4", 82: "BC5", 83: "BC5",
        84: "BC5S", 95: "BC6H", 96: "BC6HS", 97: "BC7", 98: "BC7", 99: "BC7", 27: "RGBA", 28: "RGBA", 29: "RGBA"}


def _masked(data: bytes, pos: int, width: int, height: int, bitcount: int, masks) -> np.ndarray:
    """``DdsRgbDecoder``: little-endian pixels of ``bitcount // 8`` bytes,
    each mask's field scaled to 8 bits."""
    size = bitcount // 8
    n = width * height
    raw = data[pos:pos + n * size]
    raw += bytes(n * size - len(raw))
    px = np.frombuffer(raw, np.uint8).reshape(n, size).astype(np.uint64)
    value = (px << (8 * np.arange(size, dtype=np.uint64))).sum(-1, dtype=np.uint64)
    out = []
    for mask in masks:
        shift = (mask & -mask).bit_length() - 1 if mask else 0
        total = mask >> shift
        if not total:
            out.append(np.zeros(n, np.uint8))
            continue
        field = ((value & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
        out.append((field / total * 255).astype(np.uint8))
    return np.stack(out, -1).reshape(height, width, len(masks))


def decode_dds(data: bytes) -> np.ndarray:
    """DDS bytes → (H, W, 1) uint8 gray, (H, W, 3) RGB or (H, W, 4) RGBA."""
    if not data.startswith(SIGNATURE) or len(data) < 8:
        raise ValueError("not a DDS file")
    (header_size,) = struct.unpack_from("<I", data, 4)
    if header_size != 124:
        raise ValueError(f"DDS: header size {header_size} (PIL reads only 124)")
    if len(data) < HEADER:
        raise ValueError("DDS: the header is truncated")
    height, width = struct.unpack_from("<II", data, 12)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    masks = struct.unpack_from("<4I", data, 92)
    pos = HEADER
    if width == 0 or height == 0:
        raise ValueError(f"DDS: a {width}x{height} image")
    if pfflags & RGB:
        return _masked(data, pos, width, height, bitcount, masks if pfflags & ALPHAPIXELS else masks[:3])
    if pfflags & LUMINANCE:
        if bitcount == 8:
            channels = 1
        elif bitcount == 16 and pfflags & ALPHAPIXELS:
            channels = 2
        else:
            raise ValueError(f"DDS: luminance at {bitcount} bits, flags {pfflags:#x}, which PIL does not read")
        px = _raw(data, pos, width * height * channels).reshape(height, width, channels)
        if channels == 2:  # LA → RGBA
            px = px[..., [0, 0, 0, 1]]
        return np.ascontiguousarray(px)
    if pfflags & PALETTEINDEXED8:
        palette = np.frombuffer(data[pos:pos + 1024].ljust(1024, b"\0"), np.uint8).reshape(256, 4)[:, :3]
        return np.ascontiguousarray(palette[_raw(data, pos + 1024, width * height).reshape(height, width)])
    if not pfflags & FOURCC:
        raise ValueError(f"DDS: pixel format flags {pfflags:#x}, which PIL does not read")
    if fourcc == b"DX10":
        if len(data) < HEADER + 20:
            raise ValueError("DDS: the DX10 header is truncated")
        (dxgi,) = struct.unpack_from("<I", data, HEADER)
        pos += 20
        if dxgi not in DXGI:
            raise ValueError(f"DDS: DXGI format {dxgi}, which PIL does not implement")
        fmt = DXGI[dxgi]
        if fmt == "RGBA":
            return _raw(data, pos, width * height * 4).reshape(height, width, 4).copy()
    elif fourcc in FOURCCS:
        fmt = FOURCCS[fourcc]
    else:
        raise ValueError(f"DDS: pixel format {fourcc!r}, which PIL does not implement")
    return decode_bcn(data[pos:], fmt, width, height)


def _raw(data: bytes, pos: int, n: int) -> np.ndarray:
    raw = data[pos:pos + n]
    if len(raw) < n:
        raise ValueError("DDS: the pixel data is truncated (PIL: image file is truncated)")
    return np.frombuffer(raw, np.uint8)
