"""PyTorch port vs PIL and the JAX package: the image decoders behind
``utils/image_io.load_image`` (``utils/_png.py``, ``utils/_jpeg.py``), the
sIBL background and the asset cache's pages.

PNG: files written here with each filter type forced in turn (and mixed
row by row), Adam7-interlaced or not, split over two IDAT chunks, for every
color type and bit depth, and files PIL writes itself; JPEG: files PIL
encodes from seeded images (quality 75 and 95; gray, 4:4:4, 4:2:2, 4:2:0;
17×13 and 100×75; restart markers off and on). Every decode is bit-equal to
PIL's in ``load_image``'s modes (the JAX package's ``load_image`` is PIL):
no case needed a tolerance. The committed fixtures of ``tests/data/``
decode to the SHA-256 digests their manifest holds (PIL's decode).

``SIBLSet.load_background``, ``AssetCache.page``, ``load_sky_background``
and the pages of ``rustediron_sphere_scene`` on a temporary tree laid out
like the reference's Assets (PNG and JPEG maps, an ``.ibl`` with a ``_3k``
JPEG background, a Radiance env): bit-equal to the JAX package's on the same
files. A subprocess checks that the port imports neither PIL nor JAX.
"""

import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest
from PIL import Image

from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models import sibl as jsibl
from physically_based_renderer_tpu_torch import scenes
from physically_based_renderer_tpu_torch.models import sibl
from physically_based_renderer_tpu_torch.ops.texture import sky_u8
from physically_based_renderer_tpu_torch.utils.image_io import load_image, save_hdr, save_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
FILTERS = ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4])
SIZES = ((13, 17), (1, 1), (9, 3))


def pil_load(path) -> np.ndarray:
    """The JAX package's ``load_image`` (PIL), for files outside its package."""
    with Image.open(path) as im:
        if im.mode not in ("RGB", "RGBA", "L"):
            im = im.convert("RGBA" if "A" in im.mode else "RGB")
        arr = np.asarray(im)
    return arr[..., None] if arr.ndim == 2 else arr


def _write(tmp_path, name, data: bytes) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


# -- a PNG encoder with forced filters ------------------------------------------------------


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """Filter (h, row_bytes) bytes, row y with ``ftypes[y % len]``."""
    out = []
    for y in range(rows.shape[0]):
        cur = rows[y].astype(np.int64)
        prev = rows[y - 1].astype(np.int64) if y else np.zeros_like(cur)
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        t = ftypes[y % len(ftypes)]
        pred = (0 * cur, a, prev, (a + prev) >> 1, _paeth(a, prev, c))[t]
        out.append(np.concatenate([[t], (cur - pred) & 255]))
    return np.concatenate(out).astype(np.uint8).tobytes()


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * c).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.reshape(h, w * c).astype(np.uint8)
    bits = ((samples.reshape(h, w)[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, -1), axis=1)


def encode_png(samples, depth, ctype, ftypes, interlace=False, plte=None, trns=None) -> bytes:
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    subs = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7] if interlace else [samples]
    raw = b"".join(_filter_rows(_pack(s, depth), bpp, ftypes) for s in subs if s.size)
    z = zlib.compress(raw)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", plte.tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", z[: len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b"")


PNG_CASES = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)] + [(3, d) for d in (1, 2, 4, 8)] + \
    [(4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("ctype,depth", PNG_CASES)
def test_png_matches_pil(tmp_path, ctype, depth):
    """Every filter forced in turn and mixed, Adam7 or not, two IDATs; the
    palette with and without tRNS; 16-bit gray near and past 255."""
    rng = np.random.default_rng(100 * ctype + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    n = 0
    for h, w in SIZES:
        s = rng.integers(0, 1 << depth, (h, w, channels))
        if ctype == 0 and depth == 16:
            s[::2] = rng.integers(0, 300, s[::2].shape)
        plte = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8) if ctype == 3 else None
        for trns in ((None, b"\x01\x80") if ctype == 3 else (None,)):
            for ftypes in FILTERS:
                for interlace in (False, True):
                    path = _write(tmp_path, f"c{n}.png", encode_png(s, depth, ctype, ftypes, interlace, plte, trns))
                    got, ref = load_image(path), pil_load(path)
                    assert got.dtype == np.uint8 and got.shape == ref.shape, (ftypes, interlace, got.shape, ref.shape)
                    assert np.array_equal(got, ref), (h, w, ftypes, interlace, trns)
                    n += 1


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_written_by_pil(tmp_path, mode):
    """PIL's own encoder (its adaptive row filters) on a 64×48 image."""
    rng = np.random.default_rng(7)
    chans = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    yy, xx = np.mgrid[0:48, 0:64]
    a = (yy[..., None] * 3 + xx[..., None] * 2 + rng.integers(0, 40, (48, 64, chans))) % 256
    im = Image.fromarray(a.astype(np.uint8)[..., 0] if chans == 1 else a.astype(np.uint8), mode)
    if mode == "P":
        im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tolist())
    path = str(tmp_path / "pil.png")
    im.save(path)
    assert np.array_equal(load_image(path), pil_load(path))


def test_save_png_round_trip(tmp_path):
    rng = np.random.default_rng(8)
    for shape in ((5, 7), (5, 7, 3), (5, 7, 4)):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        save_png(str(tmp_path / "s.png"), a)
        got = load_image(str(tmp_path / "s.png"))
        assert np.array_equal(got, a.reshape(*shape[:2], -1)) and np.array_equal(got, pil_load(tmp_path / "s.png"))


# -- JPEG -------------------------------------------------------------------------------------

JPEG_MODES = {"gray": None, "444": 0, "422": 1, "420": 2}


def _seeded_photo(rng, h, w, c):
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * (np.sin(xx / 7.0) * np.cos(yy / 5.0))[..., None] + rng.normal(0, 25, (h, w, c))
    return np.clip(base, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("mode", list(JPEG_MODES))
def test_jpeg_matches_pil(tmp_path, mode, quality):
    """17×13 and 100×75 (neither a multiple of the MCU), restart markers off,
    every 3 MCUs, and every MCU row: bit-equal to PIL."""
    rng = np.random.default_rng(quality + len(mode))
    for h, w in ((13, 17), (75, 100)):
        a = _seeded_photo(rng, h, w, 1 if mode == "gray" else 3)
        for restart in ({}, dict(restart_marker_blocks=3), dict(restart_marker_rows=1)):
            buf = io.BytesIO()
            opts = {} if mode == "gray" else dict(subsampling=JPEG_MODES[mode])
            Image.fromarray(a[..., 0] if mode == "gray" else a).save(buf, "JPEG", quality=quality, **opts, **restart)
            data = buf.getvalue()
            assert (b"\xff\xdd" in data) == bool(restart)
            path = _write(tmp_path, "p.jpg", data)
            got, ref = load_image(path), pil_load(path)
            assert got.shape == ref.shape == (h, w, 1 if mode == "gray" else 3)
            assert np.array_equal(got, ref), (h, w, restart, int(np.abs(got.astype(int) - ref).max()))


def test_unsupported_files_raise(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, "JPEG")
    arithmetic = bytearray(buf.getvalue())
    arithmetic[arithmetic.index(b"\xff\xc0") + 1] = 0xC9  # SOF0 → SOF9: arithmetic-coded
    with pytest.raises(NotImplementedError, match="arithmetic.*ROADMAP item 17"):
        load_image(_write(tmp_path, "a.jpg", bytes(arithmetic)))
    with pytest.raises(ValueError, match="not a PNG, JPEG, BMP or TGA file"):
        load_image(_write(tmp_path, "x.png", b"GIF89a" + bytes(32)))
    png = bytearray(encode_png(np.zeros((2, 2, 3), np.int64), 8, 2, [0]))
    png[30] ^= 1  # inside IHDR's body: its CRC no longer matches
    with pytest.raises(ValueError, match="CRC"):
        load_image(_write(tmp_path, "bad.png", bytes(png)))


@pytest.mark.parametrize("name", ["page_color_1024.jpg", "page_gray_1024.jpg", "background_3k.jpg"])
def test_committed_fixtures_decode_to_their_digests(name):
    with open(os.path.join(DATA, "manifest.json")) as f:
        entry = json.load(f)[name]
    path = os.path.join(DATA, name)
    got = load_image(path)
    assert list(got.shape) == entry["shape"] and os.path.getsize(path) == entry["bytes"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["decoded_sha256"]
    assert np.array_equal(got, pil_load(path))


# -- the asset tree: pages, the sIBL background, the sky -----------------------------------

IBL = """[Header]
Name = "Seeded Stairs"
[Background]
BGfile = "Seeded_3k.jpg"
[Enviroment]
EVfile = "Chelsea_Stairs_Env.hdr"
EVmulti = 1.0
[Sun]
SUNcolor = 255,230,200
SUNmulti = 1.5
SUNu = 0.3
SUNv = 0.25
"""


def write_asset_tree(root, rng, bg_size=(48, 96)) -> str:
    """A temporary tree laid out like the reference's Assets: the rustediron
    set's four maps (PNG and JPEG, one gray), the Chelsea_Stairs sIBL set
    (descriptor, ``_3k`` JPEG background, Radiance env)."""
    d = root / "rustediron"
    d.mkdir(parents=True)
    photo = lambda c: _seeded_photo(rng, 40, 40, c)  # noqa: E731
    Image.fromarray(photo(3)).save(d / "rustediron2_basecolor.png")
    Image.fromarray(photo(3)).save(d / "rustediron2_metallic.jpg", quality=90)
    Image.fromarray(photo(1)[..., 0]).save(d / "rustediron2_roughness.jpg", quality=80)
    Image.fromarray(photo(4), "RGBA").save(d / "rustediron2_normal.png")
    e = root / "Chelsea_Stairs"
    e.mkdir()
    (e / "Chelsea_Stairs.ibl").write_text(IBL)
    Image.fromarray(_seeded_photo(rng, *bg_size, 3)).save(e / "Seeded_3k.jpg", quality=85)
    save_hdr(str(e / "Chelsea_Stairs_Env.hdr"), rng.uniform(0, 4, (8, 16, 3)).astype(np.float32))
    return str(root)


def test_asset_cache_and_background_match_jax(tmp_path):
    root = write_asset_tree(tmp_path / "Assets", np.random.default_rng(5))
    jcache, cache = jscenes.AssetCache(root, texture_size=32), scenes.AssetCache(root, texture_size=32)
    for slot in scenes.RUSTEDIRON_SLOTS:
        j, p = jcache.page("rusted_iron", slot), cache.page("rusted_iron", slot)
        assert j == p and np.array_equal(cache.pages[p], jcache.pages[j]), slot
    assert cache.srgb == jcache.srgb and cache.page("rusted_iron", "specular") is None
    ibl = os.path.join(root, "Chelsea_Stairs", "Chelsea_Stairs.ibl")
    bg, jbg = sibl.parse_ibl(ibl).load_background(), jsibl.parse_ibl(ibl).load_background()
    assert bg.dtype == np.float32 and bg.shape == (48, 96, 3) and np.array_equal(bg, jbg)
    sky = cache.load_sky_background("chelsea_stairs", device="cpu")
    assert np.array_equal(sky.numpy(), sky_u8(np.asarray(jcache.load_sky_background("chelsea_stairs"))).numpy())
    scene = scenes.rustediron_sphere_scene(cache, texture_size=32, environment="chelsea_stairs", device="cpu")
    jscene = jscenes.rustediron_sphere_scene(jcache, texture_size=32, environment="chelsea_stairs")
    for a, b in zip(scene.atlas.mips, jscene.atlas.mips):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    assert np.array_equal(scene.env_map.numpy(), np.asarray(jscene.env_map))
    assert np.array_equal(scene.sky_map.numpy(), sky_u8(np.asarray(jscene.sky_map)).numpy())


def test_background_candidates(tmp_path):
    """No BGfile: a ``_<n>k`` image is taken, gray repeated to RGB; then an
    ``_env.png``; none → None."""
    rng = np.random.default_rng(6)
    (tmp_path / "s.ibl").write_text("[Header]\nName = x\n")
    assert sibl.parse_ibl(str(tmp_path / "s.ibl")).load_background() is None
    Image.fromarray(_seeded_photo(rng, 8, 16, 3)).save(tmp_path / "s_env.png")
    assert np.array_equal(sibl.parse_ibl(str(tmp_path / "s.ibl")).load_background(),
                          jsibl.parse_ibl(str(tmp_path / "s.ibl")).load_background())
    Image.fromarray(_seeded_photo(rng, 8, 16, 1)[..., 0]).save(tmp_path / "s_2k.jpg")
    bg = sibl.parse_ibl(str(tmp_path / "s.ibl")).load_background()
    assert bg.shape == (8, 16, 3) and np.array_equal(bg, jsibl.parse_ibl(str(tmp_path / "s.ibl")).load_background())


def test_port_imports_neither_pil_nor_jax(tmp_path):
    """After load_image (PNG, JPEG, BMP and TGA), load_obj and obj_scene."""
    for ext in ("jpg", "bmp", "tga"):
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / f"t.{ext}")
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from physically_based_renderer_tpu_torch import scenes
        from physically_based_renderer_tpu_torch.models.obj_loader import load_obj
        from physically_based_renderer_tpu_torch.utils.image_io import load_image, save_png
        d = {str(tmp_path)!r}
        save_png(d + "/t.png", np.zeros((4, 4, 3), np.uint8))
        assert load_image(d + "/t.png").shape == (4, 4, 3) and load_image(d + "/t.jpg").shape == (8, 8, 3)
        assert load_image(d + "/t.bmp").shape == load_image(d + "/t.tga").shape == (8, 8, 3)
        open(d + "/m.mtl", "w").write("newmtl a\\nKd 1 0 0\\nmap_Kd t.jpg\\n")
        open(d + "/m.obj", "w").write("mtllib m.mtl\\nv 0 0 0\\nv 1 0 0\\nv 0 1 0\\nvt 0 0\\nvt 1 0\\nvt 0 1\\n"
                                      "usemtl a\\nf 1/1 2/2 3/3\\n")
        load_obj(d + "/m.obj", device="cpu")
        s = scenes.obj_scene(d + "/m.obj", texture_size=8, device="cpu")
        assert s.atlas is not None
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "jax", "physically_based_renderer_tpu"))
        print("imported:", bad)
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
