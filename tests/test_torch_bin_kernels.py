"""The binning's CUDA path seen from the CPU: CPU tensors take the plain
version (no launch, no build, no ``nvcc``), the wrappers of
``csrc/raster_bin.cu`` refuse what the kernels do not take before anything
is built or launched, and the kernel chain's sizes (``raster_bin._plan``)
are the plain version's. The kernels themselves are held against the plain
version on the card by ``tests/test_torch_cuda.py``."""

import pytest
import torch

from physically_based_renderer_tpu_torch.ops import raster_bin, raster_row
from physically_based_renderer_tpu_torch.ops.raster import setup_corners
from torch_parity import bin_soup

FIELDS = ("packed", "pair_tri", "starts", "num_pairs", "overflowed")
W, H = 256, 128
BASE = dict(width=W, height=H, rows=H, y_offset=0, tile_h=8, tile_w=128, max_span=16, pairs_cap=None,
            big_cap=None, big2_span=0, big2_cap=None, cull_backface=True)


@pytest.fixture
def no_build(monkeypatch):
    """Fail on any attempt to build or load the kernels' library."""
    def refuse(*_):
        raise AssertionError("the CPU path built or loaded csrc/raster_bin.cu")

    raster_bin.kernel_library.cache_clear()
    monkeypatch.setattr(raster_bin, "load_library", refuse)


@pytest.mark.parametrize("case", ["corner_c14", "tris_c6", "ids_margin", "band_big2"])
def test_cpu_tensors_take_the_plain_version(no_build, case):
    """``bin_for_shade`` and ``bin_triangles`` on CPU tensors: the plain
    version's result, bit for bit, and no ``launch/bin``."""
    soup = dict(num_t=600, num_c={"corner_c14": 14, "tris_c6": 6}.get(case), indexed=case == "tris_c6")
    clip, attrs, fm, tris, _ = bin_soup(3, W, H, **soup)
    kw = dict(BASE, tris=tris)
    kw.update({"ids_margin": dict(bbox_margin_px=2.0, tile_h=16),
               "band_big2": dict(rows=64, y_offset=40, big2_span=4096, big2_cap=8)}.get(case, {}))
    before = raster_bin.BIN_LAUNCHES
    got = raster_row.bin_for_shade(clip, attrs, fm, **kw)
    ref = raster_row.bin_for_shade_plain(clip, attrs, fm, **kw)
    st = setup_corners(clip if tris is None else clip[tris.long()], W, H, True, None)
    tri_kw = {k: v for k, v in kw.items() if k not in ("cull_backface", "tris")}
    got_st = raster_bin.bin_triangles(st, face_material=fm, **tri_kw)
    ref_st = raster_bin.bin_triangles_plain(st, face_material=fm, **tri_kw)
    assert raster_bin.BIN_LAUNCHES == before
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
        assert torch.equal(getattr(got_st, f), getattr(ref_st, f)), f
    assert int(ref.num_pairs) > 0


def _clip_inputs(case):
    clip, attrs, fm, tris, mask = bin_soup(4, W, H, num_t=64, num_c=6, indexed=case.startswith("tris"), mask=True)
    return dict(verts_clip=clip, packed_attrs=attrs, face_material=fm, tris=tris, tri_mask=mask)


# each: what is changed in valid CPU arguments, and the error it must raise
REFUSED = {
    "cpu_tensors": (lambda a: a, "needs CUDA tensors"),
    "clip_float64": (lambda a: dict(a, verts_clip=a["verts_clip"].double()), "verts_clip must be"),
    "clip_strided": (lambda a: dict(a, verts_clip=a["verts_clip"].transpose(0, 1).contiguous().transpose(0, 1)),
                     "verts_clip must be"),
    "clip_shape": (lambda a: dict(a, verts_clip=a["verts_clip"][..., :3].contiguous()), "verts_clip has shape"),
    "attrs_rows": (lambda a: dict(a, packed_attrs=a["packed_attrs"][1:]), "packed_attrs has shape"),
    "face_material_float": (lambda a: dict(a, face_material=a["face_material"].float()), "face_material must be"),
    "tri_mask_uint8": (lambda a: dict(a, tri_mask=a["tri_mask"].to(torch.uint8)), "tri_mask must be"),
    "attrs_other_device": (lambda a: dict(a, packed_attrs=a["packed_attrs"].to("meta")), "is on meta"),
    "tris_int16": (lambda a: dict(a, tris=a["tris"].to(torch.int16)), "tris must be"),
    "tris_shape": (lambda a: dict(a, tris=a["tris"][:, :2].contiguous()), "tris has shape"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_clip_wrapper_refuses_what_the_kernels_do_not_take(no_build, case):
    change, message = REFUSED[case]
    a = change(_clip_inputs("tris" if case.startswith("tris") else case))
    kw = {k: v for k, v in BASE.items() if k != "cull_backface"}
    with pytest.raises(ValueError, match=message):
        raster_bin.bin_clip_cuda(a.pop("verts_clip"), a.pop("packed_attrs"), a.pop("face_material"), **a, **kw)


@pytest.mark.parametrize("case", ["cpu_tensors", "z_strided", "xy_float64", "valid_float", "channels_width"])
def test_screen_wrapper_refuses_what_the_kernels_do_not_take(no_build, case):
    clip, attrs, fm, _, _ = bin_soup(4, W, H, num_t=64, num_c=6)
    st = setup_corners(clip, W, H, True, None)  # z is a strided view
    fields = {f: getattr(st, f).contiguous() for f in ("xy", "z", "inv_w", "area", "valid")}
    cc = torch.cat([attrs * st.inv_w[..., None], st.inv_w[..., None]], dim=-1)
    if case == "z_strided":
        fields["z"] = st.z
    elif case == "xy_float64":
        fields["xy"] = fields["xy"].double()
    elif case == "valid_float":
        fields["valid"] = fields["valid"].float()
    elif case == "channels_width":
        cc = cc[:5]
    message = {"cpu_tensors": "needs CUDA tensors", "z_strided": "st.z must be", "xy_float64": "st.xy must be",
               "valid_float": "st.valid must be", "channels_width": "corner_channels has shape"}[case]
    kw = {k: v for k, v in BASE.items() if k != "cull_backface"}
    with pytest.raises(ValueError, match=message):
        raster_bin.bin_triangles_cuda(type(st)(**fields), face_material=fm, corner_channels=cc, **kw)


# (width, height, tile_h, tile_w, binning arguments) — the kernel chain's sizes against the plain version's arrays
PLANS = {
    "v1": (256, 128, 16, 128, dict(max_span=8)),
    "row_big2": (256, 128, 8, 128, dict(max_span=16, big2_span=4096, big2_cap=7)),
    "span_wide": (256, 128, 4, 128, dict(max_span=64)),
    "capped": (256, 128, 8, 128, dict(max_span=16, pairs_cap=300, big_cap=5)),
    "int64_keys": (1024, 1024, 1, 1, dict(max_span=8)),  # 2^20 tiles: 11-bit ids leave int32 keys 2^20 - 2
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_sizes_are_the_plain_versions(case):
    """``_plan`` (the kernels' sizes, all from shapes): the pair arrays are
    min(keys, pairs_cap) + chunk long, as the plain version's, and the int64
    keys are taken exactly where the plain version takes them."""
    width, height, tile_h, tile_w, kw = PLANS[case]
    num_t = 2000
    clip, _, _, _, _ = bin_soup(9, width, height, num_t=num_t, num_c=None)
    st = setup_corners(clip, width, height, True, None)
    binned = raster_bin.bin_triangles_plain(st, width=width, height=height, tile_h=tile_h, tile_w=tile_w, **kw)
    plan = raster_bin._plan(num_t, width=width, rows=height, tile_h=tile_h, tile_w=tile_w, max_span=kw["max_span"],
                            pairs_cap=kw.get("pairs_cap"), big_cap=kw.get("big_cap"),
                            big2_span=kw.get("big2_span", 0), big2_cap=kw.get("big2_cap"))
    assert binned.pair_tri.shape[0] == binned.packed.shape[0] == plan.num_slots + 128
    assert binned.starts.shape[0] == plan.ntiles + 1
    assert plan.keys_i64 == (case == "int64_keys")
