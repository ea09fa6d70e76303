"""PyTorch port vs the JAX package: ``raster_pallas.rasterize_binned_shade``,
kernel 7's own (non-differentiable) entry.

The port's function is a thin wrapper over ``raster_row.shade_row_packed(
v1=True)``; on CPU tensors it runs kernel 7's plain version. It is held
against JAX ``rasterize_binned_shade(..., interpret=True)`` on the same
inputs, as ``tests/test_raster_shade.py:205`` holds the JAX row kernel
against it: ids equal except at exact quantized-depth ties (each differing
pixel checked to be one), RGBA within 2e-4, the IBL mode's 11 channels within
2e-4 + 1e-4·|v|, and under ``want_gbuf`` the six interpolated attributes
within 1e-4 + 1e-4·|v| (plane-evaluated positions and normals, f32 in
another order). Then JAX's own call form of ``tests/test_depth_quantization.py``
(sub- and super-quantum ties of two quads) runs on the port, the signature
is JAX's minus the "Do not port" arguments, and a pair-cap overflow raises.
"""

import inspect
import types

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.ops import raster_pallas as jrp
from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
from test_depth_quantization import Z_FAR_SUBQ, Z_FAR_SUPER, Z_NEAR_SUBQ, _two_quads
from test_torch_raster_shade_ibl import _with_ibl
from test_torch_raster_shade_v1 import IBL_SCENES, SCENES, _check_ids, _inputs, _t

ATOL, RTOL = 2e-4, 1e-4
GBUF_ATOL = 1e-4


@pytest.mark.parametrize("case, want_gbuf", [("grid", False), ("grid", True), ("lit_sphere", True)])
def test_rasterize_binned_shade_matches_jax(case, want_gbuf):
    jscene, jcam, width, height = SCENES[case]()
    args, kw = _inputs(jscene, jcam)
    ref = jrp.rasterize_binned_shade(*args, width=width, height=height, want_gbuf=want_gbuf, interpret=True, **kw)
    counts = raster_row.SHADE_V1_KERNEL_LAUNCHES, raster_row.KERNEL_LAUNCHES
    got = raster_pallas.rasterize_binned_shade(*(_t(a) for a in args), width=width, height=height,
                                               want_gbuf=want_gbuf, **kw)
    assert (raster_row.SHADE_V1_KERNEL_LAUNCHES, raster_row.KERNEL_LAUNCHES) == counts  # CPU: the plain version
    assert len(got) == len(ref) == (4 if want_gbuf else 3)
    assert got[1].dtype == got[2].dtype == torch.int32 and got[0].shape == (height, width, 4)
    same = _check_ids(args, width, height, types.SimpleNamespace(tri_id=got[1], mat_id=got[2]), ref)
    np.testing.assert_allclose(got[0].numpy()[same], np.asarray(ref[0])[same], atol=ATOL, rtol=0)
    if want_gbuf:
        assert got[3].shape == np.asarray(ref[3]).shape == (height, width, 6)
        hit = same & (got[1].numpy() >= 0)
        np.testing.assert_allclose(got[3].numpy()[hit], np.asarray(ref[3])[hit], atol=GBUF_ATOL, rtol=RTOL)


def test_rasterize_binned_shade_ibl_matches_jax():
    jscene, jcam, width, height = IBL_SCENES["sphere"]()
    jscene = _with_ibl(jscene, "none")
    args, kw = _inputs(jscene, jcam)
    sh9 = jscene.ibl.irradiance_sh9
    ref = jrp.rasterize_binned_shade(*args, sh9, width=width, height=height, interpret=True, **kw)
    got = raster_pallas.rasterize_binned_shade(*(_t(a) for a in args), _t(sh9), width=width, height=height, **kw)
    same = _check_ids(args, width, height, types.SimpleNamespace(tri_id=got[1], mat_id=got[2]), ref)
    assert got[0].shape == (height, width, 11)
    np.testing.assert_allclose(got[0].numpy()[same], np.asarray(ref[0])[same], atol=ATOL, rtol=RTOL)


def _ids_shade(z_first, z_second):
    """``tests/test_depth_quantization.py``'s ``_ids_shade`` on the port."""
    verts, tris = _two_quads(z_first, z_second)
    vc = _t(verts)[_t(tris).long()]
    l3 = torch.zeros((1, 3))
    _rgba, tri_id, _m = raster_pallas.rasterize_binned_shade(
        vc, torch.ones((4, 3, 6)), torch.zeros((4,), dtype=torch.int32), torch.ones((1, 9)) * 0.5, l3, l3, l3,
        torch.zeros((1,)), torch.zeros((3,)), torch.zeros((3,)), width=128, height=64, cull_backface=False,
        num_materials=1)
    return tri_id.numpy()


def test_depth_quantization_contract_on_the_port():
    """Sub-quantum: the first-drawn quad wins either way; super-quantum: the
    nearer one (the JAX package's contract for kernel 7)."""
    for first, second, winners in ((Z_NEAR_SUBQ, Z_FAR_SUBQ, {0, 1}), (Z_FAR_SUBQ, Z_NEAR_SUBQ, {0, 1}),
                                   (Z_NEAR_SUBQ, Z_FAR_SUPER, {0, 1}), (Z_FAR_SUPER, Z_NEAR_SUBQ, {2, 3})):
        assert set(np.unique(_ids_shade(first, second))) == winners


def test_signature_is_jax_minus_do_not_port():
    port = inspect.signature(raster_pallas.rasterize_binned_shade).parameters
    ref = inspect.signature(jrp.rasterize_binned_shade).parameters
    assert list(port) == [k for k in ref if k not in ("interpret", "mm_precision")]
    for name, p in port.items():
        assert (p.kind, p.default) == (ref[name].kind, ref[name].default), name
    assert (port["tile_h"].default, port["max_span"].default, port["big2_span"].default,
            port["want_gbuf"].default) == (4, 16, 0, False)


def test_overflow_raises():
    jscene, jcam, width, height = SCENES["grid"]()
    args, kw = _inputs(jscene, jcam)
    with pytest.raises(RuntimeError, match="overflow"):
        raster_pallas.rasterize_binned_shade(*(_t(a) for a in args), width=width, height=height, pairs_cap=16,
                                             **kw)
