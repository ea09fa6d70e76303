"""PyTorch port vs the JAX package: ``utils/image_io.load_image`` on DDS files
(``utils/_dds.py``, ``utils/_bcn.py``).

Every file is decoded by the port and by the JAX package's own
``load_image`` (PIL 12.1) and the two held with ``np.array_equal``
(``held_to_jax``): no tolerance. Where PIL refuses a file, the port must
raise ``ValueError`` too.

Files PIL writes (DXT1, DXT3, DXT5, BC2, BC3, BC5; raw L, LA, RGB, RGBA);
headers written here for what PIL does not write: uncompressed masks at
16, 24 and 32 bits (among them R 0b11, G 0b1100), luminance, palettes,
DX10 R8G8B8A8, and pages of random blocks in every block format PIL reads —
BC4, BC5S, BC6H (UF16 and SF16, each of the 14 modes and the reserved
ones) and BC7 (each of the 8 modes and the modeless block) among them —
at sizes that are not multiples of 4. Exhaustive pages pin the integer
rules: every BC1 endpoint value against random partners, every BC4
endpoint pair, every BC6H 16-bit endpoint (so every half float PIL maps
to 8 bits). The seeded pages of ``chip_smoke.seeded_bcn_pages`` decode to
their manifest digests.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from chip_smoke import DDS_DXGI, DDS_FOURCC, dds_header, seeded_bcn_pages, write_dds
from physically_based_renderer_tpu_torch.utils.image_io import load_image
from test_torch_image_formats import DATA, _write, held_to_jax

RGB, ALPHAPIXELS, LUMINANCE, PALETTE, FOURCC = 0x40, 0x1, 0x20000, 0x20, 0x4
BLOCK = {"BC1": 8, "BC4": 8}


def bc_file(fmt: str, w: int, h: int, blocks: bytes, *, fourcc: bytes | None = None, dxgi: int | None = None) -> bytes:
    """A DDS file of ``fmt`` blocks: its FourCC (or ``fourcc``), or a DX10
    header of ``dxgi`` (default the format's)."""
    if dxgi is None and fourcc is None and fmt in DDS_FOURCC:
        fourcc = DDS_FOURCC[fmt]
    if fourcc is not None:
        return dds_header(w, h, FOURCC, fourcc) + blocks
    return dds_header(w, h, FOURCC, b"DX10", dxgi=DDS_DXGI.get(fmt) if dxgi is None else dxgi) + blocks


def random_blocks(rng, fmt: str, w: int, h: int) -> np.ndarray:
    return rng.integers(0, 256, ((-(-w // 4)) * (-(-h // 4)), BLOCK.get(fmt, 16)), dtype=np.uint8)


# -- files PIL writes ------------------------------------------------------------------------

PIL_WRITES = {"DXT1": "RGBA", "DXT3": "RGBA", "DXT5": "RGBA", "BC2": "RGBA", "BC3": "RGBA", "BC5": "RGB",
              "raw L": "L", "raw LA": "LA", "raw RGB": "RGB", "raw RGBA": "RGBA"}


@pytest.mark.parametrize("kind", list(PIL_WRITES))
def test_dds_written_by_pil(tmp_path, kind):
    """PIL's own DDS writer at 37×23 and 64×32 (its BCn encoder crops the
    edge blocks on reading)."""
    rng = np.random.default_rng(len(kind))
    mode = PIL_WRITES[kind]
    for h, w in ((23, 37), (32, 64)):
        a = rng.integers(0, 256, (h, w, len(mode)), dtype=np.uint8)
        im = Image.fromarray(a[..., 0] if mode == "L" else a, mode)
        path = str(tmp_path / "p.dds")
        im.save(path, **({} if kind.startswith("raw") else {"pixel_format": kind}))
        got = held_to_jax(path)
        assert got.shape[:2] == (h, w)


# -- headers written here ---------------------------------------------------------------------

RNG = np.random.default_rng(14)
PX32 = RNG.integers(0, 256, 7 * 5 * 4, dtype=np.uint8).tobytes()
ALL16 = np.arange(65536, dtype="<u2").tobytes()
DDS_CRAFTED = {
    "rgb_565": dds_header(256, 256, RGB, bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0)) + ALL16,
    "rgba_5551": dds_header(256, 256, RGB | ALPHAPIXELS, bitcount=16, masks=(0x7C00, 0x3E0, 0x1F, 0x8000)) + ALL16,
    "rgba_4444": dds_header(256, 256, RGB | ALPHAPIXELS, bitcount=16, masks=(0xF00, 0xF0, 0xF, 0xF000)) + ALL16,
    "masks_0b11_0b1100": dds_header(256, 256, RGB, bitcount=16, masks=(0b11, 0b1100, 0xFFF0, 0)) + ALL16,
    "mask_with_gap": dds_header(256, 256, RGB, bitcount=16, masks=(0b101, 0xFF00, 0, 0)) + ALL16,
    "rgb_24": dds_header(7, 5, RGB, bitcount=24, masks=(0xFF0000, 0xFF00, 0xFF, 0)) + PX32[:7 * 5 * 3],
    "bgra_32": dds_header(7, 5, RGB | ALPHAPIXELS, bitcount=32, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)) + PX32,
    "rgbx_32": dds_header(7, 5, RGB, bitcount=32, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)) + PX32,
    "r10g10b10a2": dds_header(7, 5, RGB | ALPHAPIXELS, bitcount=32,
                              masks=(0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000)) + PX32,
    "rgb_truncated": dds_header(7, 5, RGB, bitcount=32, masks=(0xFF0000, 0xFF00, 0xFF, 0)) + PX32[:50],
    "luminance_8": dds_header(7, 5, LUMINANCE, bitcount=8) + PX32[:35],
    "luminance_alpha_16": dds_header(7, 5, LUMINANCE | ALPHAPIXELS, bitcount=16) + PX32[:70],
    "luminance_16_no_alpha": dds_header(7, 5, LUMINANCE, bitcount=16) + PX32[:70],
    "luminance_32": dds_header(7, 5, LUMINANCE | ALPHAPIXELS, bitcount=32) + PX32,
    "luminance_truncated": dds_header(7, 5, LUMINANCE, bitcount=8) + PX32[:20],
    "palette": dds_header(7, 5, PALETTE, bitcount=8) + RNG.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    + PX32[:35],
    "dx10_r8g8b8a8": dds_header(7, 5, FOURCC, b"DX10", dxgi=28) + PX32,
    "dx10_r8g8b8a8_srgb": dds_header(7, 5, FOURCC, b"DX10", dxgi=29) + PX32,
    "dx10_unlisted_format": dds_header(7, 5, FOURCC, b"DX10", dxgi=2) + PX32,
    "unknown_fourcc": dds_header(8, 8, FOURCC, b"DXT2") + bytes(64),
    "no_format_flags": dds_header(8, 8, 0) + bytes(64),
    "alpha_only_flag": dds_header(8, 8, 0x2, bitcount=8) + bytes(64),
    "header_size_100": b"DDS " + struct.pack("<I", 100) + dds_header(8, 8, LUMINANCE, bitcount=8)[8:] + bytes(64),
    "header_truncated": dds_header(8, 8, LUMINANCE, bitcount=8)[:60],
    "zero_width": dds_header(0, 5, LUMINANCE, bitcount=8) + bytes(10),
    "bc1_truncated": bc_file("BC1", 8, 8, bytes(24)),
    "bc7_truncated": bc_file("BC7", 8, 8, bytes(40)),
}


@pytest.mark.parametrize("name", list(DDS_CRAFTED))
def test_dds_crafted(tmp_path, name):
    held_to_jax(_write(tmp_path, f"{name}.dds", DDS_CRAFTED[name]))


# -- random blocks in every format -----------------------------------------------------------

# format → the headers PIL reads it from: FourCCs and DXGI formats
BLOCK_HEADERS = {
    "BC1": [dict(fourcc=b"DXT1"), dict(dxgi=70), dict(dxgi=71)],
    "BC2": [dict(fourcc=b"DXT3"), dict(dxgi=73), dict(dxgi=74)],
    "BC3": [dict(fourcc=b"DXT5"), dict(dxgi=76), dict(dxgi=77)],
    "BC4": [dict(fourcc=b"ATI1"), dict(fourcc=b"BC4U"), dict(dxgi=79), dict(dxgi=80)],
    "BC5": [dict(fourcc=b"ATI2"), dict(fourcc=b"BC5U"), dict(dxgi=82), dict(dxgi=83)],
    "BC5S": [dict(fourcc=b"BC5S"), dict(dxgi=84)],
    "BC6H": [dict(dxgi=95)],
    "BC6HS": [dict(dxgi=96)],
    "BC7": [dict(dxgi=97), dict(dxgi=98), dict(dxgi=99)],
}
BC6_MODE_BITS = [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27, 31]  # 14 modes, 4 reserved


@pytest.mark.parametrize("fmt", list(BLOCK_HEADERS))
def test_random_blocks_match_pil(tmp_path, fmt):
    """256×64 pages of random blocks under each header PIL maps to the
    format, then 61×35, 5×3 and 1×1 pages (whole blocks, cropped). BC6H
    blocks cycle through every mode value, the reserved ones included; BC7
    blocks through every mode bit and the modeless first byte."""
    rng = np.random.default_rng(sum(map(ord, fmt)))
    for kw in BLOCK_HEADERS[fmt]:
        for w, h in ((256, 64), (61, 35), (5, 3), (1, 1)):
            blocks = random_blocks(rng, fmt, w, h)
            n = len(blocks)
            if fmt.startswith("BC6"):
                mode = np.array(BC6_MODE_BITS)[np.arange(n) % len(BC6_MODE_BITS)]
                blocks[:, 0] = np.where(mode < 2, (blocks[:, 0] & 0xFC) | mode, (blocks[:, 0] & 0xE0) | mode)
            elif fmt == "BC7":
                lead = np.arange(n) % 9
                blocks[:, 0] = np.where(lead == 8, 0, (blocks[:, 0] | 1) << lead)
            got = held_to_jax(_write(tmp_path, "b.dds", bc_file(fmt, w, h, blocks.tobytes(), **kw)))
            assert got is not None and got.shape[:2] == (h, w), (kw, w, h)


def test_bc1_every_endpoint_value(tmp_path):
    """Every 5-6-5 value as the first endpoint and as the second, against
    random partners and all four indices (both colour modes of BC1, and
    BC2's and BC3's four-colour rule)."""
    rng = np.random.default_rng(5)
    every = np.arange(65536)
    partner = rng.integers(0, 65536, 65536)
    lut = np.frombuffer(np.array([0b11100100] * 4, np.uint8).tobytes(), "<u4")[0]
    for c0, c1 in ((every, partner), (partner, every)):
        colour = np.zeros((65536, 8), np.uint8)
        colour[:, 0:2] = c0.astype("<u2").view(np.uint8).reshape(-1, 2)
        colour[:, 2:4] = c1.astype("<u2").view(np.uint8).reshape(-1, 2)
        colour[:, 4:8] = np.frombuffer(np.uint32(lut).tobytes(), np.uint8)
        held_to_jax(_write(tmp_path, "bc1.dds", bc_file("BC1", 1024, 1024, colour.tobytes())))
        alpha = rng.integers(0, 256, (65536, 8), dtype=np.uint8)
        for fmt in ("BC2", "BC3"):
            held_to_jax(_write(tmp_path, "bc.dds", bc_file(fmt, 1024, 1024, np.concatenate([alpha, colour], 1)
                                                           .tobytes())))


@pytest.mark.parametrize("fmt", ["BC4", "BC5S"])
def test_bc4_every_endpoint_pair(tmp_path, fmt):
    """All 65,536 (a0, a1) pairs, each block's 16 indices 0-7 twice: both
    interpolation rules and their truncation (signed for BC5S)."""
    a0, a1 = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    idx = np.tile(np.arange(8), 2)
    lut = int(sum(int(v) << (3 * i) for i, v in enumerate(idx)))
    half = np.zeros((65536, 8), np.uint8)
    half[:, 0], half[:, 1] = a0.ravel(), a1.ravel()
    half[:, 2:8] = np.frombuffer(lut.to_bytes(6, "little"), np.uint8)
    blocks = half if fmt == "BC4" else np.concatenate([half, half[::-1]], 1)
    held_to_jax(_write(tmp_path, "bc4.dds", bc_file(fmt, 1024, 1024, blocks.tobytes())))


@pytest.mark.parametrize("fmt", ["BC6H", "BC6HS"])
def test_bc6h_every_half_value(tmp_path, fmt):
    """Mode 13 (16-bit endpoints, unquantised as they are), its first
    endpoint every 16-bit value in red, green and blue, all indices 0: each
    texel is the endpoint's ·31/64 (·31/32) half float as PIL maps it to
    8 bits — every half from 0 to 65504, and the signed ones."""
    v = np.arange(65536)
    bits = np.zeros((65536, 128), np.uint8)
    bits[:, :5] = [1, 1, 1, 1, 0]  # mode value 0x0f
    for c in range(3):  # r0, g0, b0 bits 0-9, then each one's bits 15 … 10 after its delta field
        bits[:, 5 + 10 * c:15 + 10 * c] = (v[:, None] >> np.arange(10)) & 1
        at = 35 + 10 * c + 4
        bits[:, at:at + 6] = (v[:, None] >> np.arange(15, 9, -1)) & 1
    blocks = np.packbits(bits, axis=1, bitorder="little")
    got = held_to_jax(_write(tmp_path, "bc6.dds", bc_file(fmt, 1024, 1024, blocks.tobytes())))
    assert len(np.unique(got)) > 200  # the sweep spans the 8-bit range


# -- the seeded pages -----------------------------------------------------------------------

SEEDED = seeded_bcn_pages()


@pytest.mark.parametrize("name", list(SEEDED))
def test_seeded_pages_decode_to_their_digests(tmp_path, name):
    """The pages of ``chip_smoke.seeded_bcn_pages`` (phase ai's) decode to
    the digests ``tests/data/make_bcn_fixtures.py`` took from PIL, and equal
    the JAX package's decode here."""
    with open(os.path.join(DATA, "manifest.json")) as f:
        entry = json.load(f)[name]
    data = SEEDED[name]
    got = held_to_jax(_write(tmp_path, name, data))
    assert list(got.shape) == entry["shape"] and len(data) == entry["bytes"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["decoded_sha256"]


def test_bc7_seeded_page_covers_every_mode():
    """The 1024² page's random first bytes select every BC7 mode: mode 7 (a
    first byte of exactly 0x80) in about 256 blocks, as many modeless."""
    blocks = np.frombuffer(SEEDED["bc7_1024.dds"], np.uint8, offset=148).reshape(-1, 16)
    first = blocks[:, 0].astype(int)
    mode = np.where(first == 0, 8, np.argmax((first[:, None] >> np.arange(8)) & 1, 1))
    counts = np.bincount(mode, minlength=9)
    assert counts.min() >= 200 and counts[7] < 330, counts


def test_write_dds_round_trips(tmp_path):
    """``chip_smoke.write_dds`` (phase ai's B8G8R8A8 writer): RGB and RGBA
    pages read back unchanged by both packages."""
    rng = np.random.default_rng(8)
    for c in (3, 4):
        a = rng.integers(0, 256, (19, 26, c), dtype=np.uint8)
        path = str(tmp_path / f"w{c}.dds")
        write_dds(path, a)
        assert np.array_equal(held_to_jax(path), a)
        assert np.array_equal(load_image(path), a)


def test_srgb_flag_changes_no_sample(tmp_path):
    """BC7_UNORM_SRGB (and R8G8B8A8_UNORM_SRGB) decode as their UNORM twins:
    PIL only records a gamma."""
    rng = np.random.default_rng(9)
    blocks = random_blocks(rng, "BC7", 32, 32).tobytes()
    a = load_image(_write(tmp_path, "u.dds", bc_file("BC7", 32, 32, blocks, dxgi=98)))
    b = load_image(_write(tmp_path, "s.dds", bc_file("BC7", 32, 32, blocks, dxgi=99)))
    assert np.array_equal(a, b)
    with Image.open(io.BytesIO(bc_file("BC7", 32, 32, blocks, dxgi=99))) as im:
        assert "gamma" in im.info
