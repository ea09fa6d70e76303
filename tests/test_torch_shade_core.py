"""PyTorch port vs the JAX package: the per-pixel shader ``shade_core``
(``ibl=False``) on random NumPy inputs with directional, point and spot
lights. Display-encoded outputs agree to atol 1e-5. HDR outputs (up to ~10)
agree to atol 1e-5 plus rtol 1e-4: on these inputs each float32 evaluation
is within 6.4e-5 relative of a float64 one (near-grazing n·v and sharp
highlights amplify rounding). The port forms the GGX term 1 − (n·h)² as
|n×h|², equal to the JAX expression in exact arithmetic."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.ops import shade_core as jsc
from physically_based_renderer_tpu_torch.ops import shade_core as tsc

N = 4096


def _inputs(seed, num_dir, num_point, num_spot):
    rng = np.random.default_rng(seed)
    L = max(num_dir + num_point + num_spot, 1)
    f = lambda *s, lo=-1.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)
    pos = f(3, N, lo=-3, hi=3)
    nrm = f(3, N)
    props = np.concatenate(
        [f(3, N, lo=0, hi=1), f(1, N, lo=0, hi=1), f(3, N, lo=0, hi=0.1),
         f(1, N, lo=0.2, hi=1), f(1, N, lo=0.3, hi=1)]
    )
    lights = dict(
        light_strength=f(L, 3, lo=0, hi=2),
        light_direction=(lambda d: d / np.linalg.norm(d, axis=-1, keepdims=True))(f(L, 3)),
        light_position=f(L, 3, lo=-4, hi=4),
        light_spot_power=f(L, lo=1, hi=16),
        ambient=f(3, lo=0, hi=0.1),
        eye=np.array([0.3, -0.5, -8.0], np.float32),
    )
    return pos, nrm, props, lights


@pytest.mark.parametrize("counts", [(4, 0, 0), (1, 1, 1), (0, 2, 0), (0, 0, 2), (0, 0, 0)])
@pytest.mark.parametrize("apply_tonemap", [True, False])
def test_shade_core_matches(counts, apply_tonemap):
    num_dir, num_point, num_spot = counts
    pos, nrm, props, lights = _inputs(sum(counts) * 7 + apply_tonemap, *counts)
    uni_j = jsc.pack_shading_uniforms(**{k: jnp.asarray(v) for k, v in lights.items()})
    uni_t = tsc.pack_shading_uniforms(**{k: torch.as_tensor(v) for k, v in lights.items()})
    np.testing.assert_array_equal(uni_t.numpy(), np.asarray(uni_j))
    kw = dict(num_dir=num_dir, num_point=num_point, num_spot=num_spot, apply_tonemap=apply_tonemap)
    out_j = jsc.shade_core(
        tuple(jnp.asarray(pos[c]) for c in range(3)),
        tuple(jnp.asarray(nrm[c]) for c in range(3)),
        tuple(jnp.asarray(props[c]) for c in range(9)),
        uni_j, ibl=False, **kw,
    )
    out_t = tsc.shade_core(
        tuple(torch.as_tensor(pos[c]) for c in range(3)),
        tuple(torch.as_tensor(nrm[c]) for c in range(3)),
        tuple(torch.as_tensor(props[c]) for c in range(9)),
        uni_t, **kw,
    )
    assert len(out_t) == len(out_j) == 4
    rtol = 0.0 if apply_tonemap else 1e-4
    for c, (a, b) in enumerate(zip(out_j, out_t)):
        np.testing.assert_allclose(
            b.numpy(), np.asarray(a).reshape(N), atol=1e-5, rtol=rtol, err_msg=f"channel {c}"
        )


def test_unpack_uniform_grads_inverts_pack():
    _, _, _, lights = _inputs(3, 1, 1, 1)
    uni = tsc.pack_shading_uniforms(**{k: torch.as_tensor(v) for k, v in lights.items()})
    g_ls, g_ld, g_lp, g_lsp, g_amb, g_eye = tsc.unpack_uniform_grads(uni, 3)
    ref = jsc.unpack_uniform_grads(jnp.asarray(uni.numpy()), 3, False)
    for a, b in zip(ref[:6], (g_ls, g_ld, g_lp, g_lsp, g_amb, g_eye)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(g_ls.numpy(), lights["light_strength"])
    np.testing.assert_array_equal(g_eye.numpy(), lights["eye"])
