"""PyTorch port vs the JAX package: kernel 7, the v1 fused raster+shade
behind ``raster_shade`` and ``raster_shade_ibl`` with their defaults.

Both functions now take JAX's defaults (``tile_h=4``, ``max_span=16``, no
big2 class, ``row_layout=False``): the v1 binning, whose per-tile step is
kernel 7 in the JAX package and the shade mode of the port's kernel at
4×128 tiles. On CPU tensors the port runs the plain version
(``raster_shade_tiles_plain``); it is held against JAX ``raster_shade(...,
interpret=True)`` on the same inputs: ids equal except at exact
quantized-depth ties (the TPU kernel's leading pairs; each differing pixel
is checked to be one), RGBA within 2e-4 (``tests/test_raster_shade.py``'s
tolerance), the IBL mode's 11 channels within 2e-4 + 1e-4·|v|, and the
material and light gradients within the JAX suite's gradient tolerance
(``torch_parity.grad_tolerance``: rtol 2e-3 + 5e-5·max).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import depth_ties
from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.ops import raster_pallas as jrp
from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
from test_torch_raster_row import _inputs, _lit_sphere
from test_torch_raster_shade_ibl import _sphere, _with_ibl
from torch_parity import grad_tolerance

ATOL, RTOL = 2e-4, 1e-4


def _grid():
    return jscenes.red_sphere_grid_scene(slices=8, stacks=4), JCamera.create(position=(0.0, -3.0, -18.0),
                                                                             aspect=2.0), 128, 64


SCENES = {"grid": _grid, "lit_sphere": _lit_sphere}
# Under IBL the grid's roughness-0 spheres carry the JAX package's float32
# GGX noise past 2e-4 (HDR values): the IBL path's own test scenes instead.
IBL_SCENES = {"sphere": lambda: (*_sphere(), 128, 64), "lit_sphere": _lit_sphere}


def _t(x):
    return torch.as_tensor(np.array(x))


def _check_ids(args, width, height, got, ref):
    """Ids equal but at quantized ties → the pixels where they are equal."""
    got_ids, ref_ids = got.tri_id.numpy(), np.asarray(ref[1])
    diff = got_ids != ref_ids
    if diff.any():
        assert (got_ids[diff] >= 0).all() and (ref_ids[diff] >= 0).all()
        pixels = tuple(torch.as_tensor(i) for i in np.nonzero(diff))
        assert depth_ties(_t(args[0]), width, height, pixels, _t(got_ids[diff]), _t(ref_ids[diff]), exact=False)
    assert diff.sum() <= 4 and 0.05 < (ref_ids >= 0).mean() < 0.95
    np.testing.assert_array_equal(got.mat_id.numpy()[~diff], np.asarray(ref[2])[~diff])
    return ~diff


@pytest.mark.parametrize("case", sorted(SCENES))
def test_kernel7_plain_version_matches_jax(case):
    jscene, jcam, width, height = SCENES[case]()
    args, kw = _inputs(jscene, jcam)
    ref = jrp.raster_shade(*args, width=width, height=height, interpret=True, **kw)
    counts = raster_row.SHADE_V1_KERNEL_LAUNCHES, raster_row.KERNEL_LAUNCHES
    got = raster_pallas.raster_shade(*(_t(a) for a in args), width=width, height=height, **kw)
    assert (raster_row.SHADE_V1_KERNEL_LAUNCHES, raster_row.KERNEL_LAUNCHES) == counts  # CPU: the plain version
    assert not bool(got.overflowed)
    same = _check_ids(args, width, height, got, ref)
    np.testing.assert_allclose(got.rgba.numpy()[same], np.asarray(ref[0])[same], atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(IBL_SCENES))
def test_kernel7b_ibl_plain_version_matches_jax(case):
    jscene, jcam, width, height = IBL_SCENES[case]()
    jscene = _with_ibl(jscene, "none")
    args, kw = _inputs(jscene, jcam)
    sh9 = jscene.ibl.irradiance_sh9
    ref = jrp.raster_shade_ibl(*args, sh9, width=width, height=height, interpret=True, **kw)
    got = raster_pallas.raster_shade_ibl(*(_t(a) for a in args), _t(sh9), width=width, height=height, **kw)
    same = _check_ids(args, width, height, got, ref)
    assert got.rgba.shape == (height, width, 11)
    np.testing.assert_allclose(got.rgba.numpy()[same], np.asarray(ref[0])[same], atol=ATOL, rtol=RTOL)
    assert not got.rgba.numpy()[got.tri_id.numpy() < 0].any()


@pytest.mark.parametrize("case", sorted(SCENES))
def test_kernel7_material_and_light_gradients_match_jax(case):
    """The bench loss mean(rgba[..., :3]²) through the v1 forward and the
    shading adjoint (the same backward as the row path)."""
    jscene, jcam, width, height = SCENES[case]()
    args, kw = _inputs(jscene, jcam)

    def jloss(props, strength, ambient):
        a = list(args)
        a[3], a[4], a[8] = props, strength, ambient
        return jnp.mean(jrp.raster_shade(*a, width=width, height=height, interpret=True, **kw)[0][..., :3] ** 2)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(args[3], args[4], args[8])
    targs = [_t(a) for a in args]
    leaves = [targs[i].requires_grad_() for i in (3, 4, 8)]
    loss = torch.mean(raster_pallas.raster_shade(*targs, width=width, height=height, **kw).rgba[..., :3] ** 2)
    got = torch.autograd.grad(loss, leaves)
    for a, b in zip(ref, got):
        grad_tolerance(np.asarray(a), b.numpy())
    assert float(got[0].abs().sum()) > 0 and float(got[1].abs().sum()) > 0


def test_raster_shade_defaults_match_jax():
    """C1: the port's ``raster_shade`` takes the JAX functions' defaults (its
    ``raster_shade_ibl`` passes its keywords on to it), so a call carried
    across as written bins alike."""
    port = inspect.signature(raster_pallas.raster_shade).parameters
    for jax_fn in (jrp.raster_shade, jrp.raster_shade_ibl):
        ref = inspect.signature(jax_fn).parameters
        for name in ("tile_h", "tile_w", "max_span", "big2_span", "row_layout"):
            assert port[name].default == ref[name].default, (jax_fn.__name__, name)
    assert (port["tile_h"].default, port["max_span"].default, port["row_layout"].default) == (4, 16, False)
