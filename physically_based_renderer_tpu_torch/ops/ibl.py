"""Image-based lighting: diffuse irradiance, the split-sum specular
prefilter and the env gather of the fused path — the counterpart of
``physically_based_renderer_tpu/ops/ibl.py``.

Every convolution is a dense weighted sum over environment texels,
``out[n] = Σ_texels w(n, d) L(d) dω``: exact quadrature, no sampling noise,
differentiable w.r.t. the environment map. The weights are elementwise
math; the sums over texels are ``torch.matmul`` with the texel axis as the
contraction (float32: TF32 must stay off, ``torch.backends.cuda.matmul.
allow_tf32`` is False by default). Equirect maps use the reference's
``WorldToSkyUV`` mapping, so IBL lookups and the sky agree.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .sky import INV_2PI, INV_PI, world_to_sky_uv
from .shade_core import SH_COEFFS
from .texture import bilinear, bilinear_taps, sample_equirect

PI = math.pi
MIN_ROUGHNESS = 0.05  # ops/brdf.py of the JAX package
_ROW_CHUNK = 1024  # output directions per step of the dense quadratures


def sky_uv_to_direction(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inverse of ``world_to_sky_uv``: uv → unit direction, with the
    reference's truncated constants so the round trip is exact."""
    theta = (0.75 - u) / INV_2PI  # atan2(z, x)
    phi = (0.5 - v) / INV_PI  # asin(y)
    y = torch.sin(phi)
    c = torch.cos(phi)
    return torch.stack([c * torch.cos(theta), y, c * torch.sin(theta)], dim=-1)


def equirect_grid(height: int, width: int, device=None):
    """Texel-centre directions (H·W, 3) and solid angles (H·W,) of an
    equirect map under the sky mapping."""
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dirs = sky_uv_to_direction(uu, vv).reshape(-1, 3)
    dphi = (1.0 / height) / INV_PI
    dtheta = (1.0 / width) / INV_2PI
    elev = (0.5 - vv) / INV_PI
    solid = (torch.cos(elev) * dphi * dtheta).reshape(-1)
    return dirs, solid


def resize_env(env: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Block-mean downsample of an equirect map when the sizes divide,
    otherwise a bilinear resample at the new texel centres (differentiable)."""
    h, w, c = env.shape
    if h == height and w == width:
        return env
    if h % height == 0 and w % width == 0:
        return env.reshape(height, h // height, width, w // width, c).mean(dim=(1, 3))
    vs = (torch.arange(height, dtype=torch.float32, device=env.device) + 0.5) / height
    us = (torch.arange(width, dtype=torch.float32, device=env.device) + 0.5) / width
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    return sample_equirect(env, torch.stack([uu, vv], dim=-1))


def _cosines(n_dirs: torch.Tensor, l_dirs: torch.Tensor) -> torch.Tensor:
    """(No, 3) × (Ne, 3) → (No, Ne) dot products as explicit f32 sums."""
    return n_dirs[:, 0:1] * l_dirs[:, 0] + n_dirs[:, 1:2] * l_dirs[:, 1] + n_dirs[:, 2:3] * l_dirs[:, 2]


def _quadrature(n_dirs: torch.Tensor, weights, env_flat: torch.Tensor) -> torch.Tensor:
    """Σ_texels weights(cos(n, l)) · env, in chunks of output directions so
    the (No, Ne) weight block stays small."""
    out = []
    for s in range(0, n_dirs.shape[0], _ROW_CHUNK):
        out.append(torch.matmul(weights(n_dirs[s : s + _ROW_CHUNK]), env_flat))
    return torch.cat(out)


def irradiance_map(env: torch.Tensor, out_height: int = 32, out_width: int = 64,
                   env_samples: int = 64) -> torch.Tensor:
    """Cosine-convolved diffuse irradiance map (out_h, out_w, 3):
    E(n) = ∫ L(l) max(n·l, 0) dl / π."""
    env_small = resize_env(env, env_samples, env_samples * 2)
    l_dirs, solid = equirect_grid(env_samples, env_samples * 2, env.device)
    n_dirs, _ = equirect_grid(out_height, out_width, env.device)
    wgt = lambda n: torch.clamp(_cosines(n, l_dirs), min=0.0) * solid[None, :] / PI
    return _quadrature(n_dirs, wgt, env_small.reshape(-1, 3)).reshape(out_height, out_width, 3)


def prefilter_specular(env: torch.Tensor, base_height: int = 64, base_width: int = 128,
                       num_levels: int = 5, env_samples: int = 64) -> tuple[torch.Tensor, ...]:
    """Split-sum term 1: GGX-prefiltered radiance per roughness level, level
    l at roughness l/(num_levels−1) and resolution base >> l, under the
    N = V = R approximation (n·h = √((1 + n·l)/2))."""
    env_small = resize_env(env, env_samples, env_samples * 2)
    l_dirs, solid = equirect_grid(env_samples, env_samples * 2, env.device)
    env_flat = env_small.reshape(-1, 3)
    levels = []
    for lvl in range(num_levels):
        rough = lvl / max(num_levels - 1, 1)
        h = max(base_height >> lvl, 4)
        w = max(base_width >> lvl, 8)
        n_dirs, _ = equirect_grid(h, w, env.device)
        # roughness 0 is a mirror: a very tight GGX keeps it differentiable
        alpha = MIN_ROUGHNESS**2 if lvl == 0 else max(rough, MIN_ROUGHNESS) ** 2
        a2 = alpha * alpha

        def weights(n, a2=a2):
            cos_nl = _cosines(n, l_dirs)
            ndoth2 = (1.0 + cos_nl) * 0.5
            denom = ndoth2 * (a2 - 1.0) + 1.0
            wgt = a2 / (PI * denom * denom) * torch.clamp(cos_nl, min=0.0) * solid[None, :]
            return wgt / torch.clamp(wgt.sum(dim=-1, keepdim=True), min=1e-12)

        levels.append(_quadrature(n_dirs, weights, env_flat).reshape(h, w, 3))
    return tuple(levels)


def sh9_coeffs(env: torch.Tensor, env_samples: int = 64) -> torch.Tensor:
    """Projection of the env map onto the first 9 real spherical harmonics
    (9, 3): L_lm = Σ_texels Y_lm(d) L(d) dω."""
    env_small = resize_env(env, env_samples, env_samples * 2)
    dirs, solid = equirect_grid(env_samples, env_samples * 2, env.device)
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    ybasis = torch.stack([
        0.282095 * torch.ones_like(x),
        0.488603 * y,
        0.488603 * z,
        0.488603 * x,
        1.092548 * x * y,
        1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
    ])
    return torch.matmul(ybasis * solid[None, :], env_small.reshape(-1, 3))


def sh9_irradiance(sh: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """E(n)/π from 9 SH coefficients, the Ramamoorthi–Hanrahan closed form:
    unit normals (..., 3) → (..., 3), the ``irradiance_map`` convention."""
    c1, c2, c3, c4, c5 = SH_COEFFS
    x, y, z = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    e = (
        c1 * sh[8] * (x * x - y * y)
        + c3 * sh[6] * (z * z)
        + c4 * sh[0]
        - c5 * sh[6]
        + 2.0 * c1 * (sh[4] * x * y + sh[7] * x * z + sh[5] * y * z)
        + 2.0 * c2 * (sh[3] * x + sh[1] * y + sh[2] * z)
    )
    return e * (1.0 / PI)


def brdf_lut(size: int = 64, num_samples: int = 256, device=None) -> torch.Tensor:
    """Split-sum term 2: the (roughness, n·v) → (scale, bias) table (size,
    size, 2) by GGX importance sampling over a Hammersley set. The radical
    inverse runs in int64 with 32-bit masks (torch's uint32 has few ops)."""
    ar = lambda: (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    nv = ar()[None, :, None]  # inner axis of the JAX package's vmap
    r = ar()[:, None, None]
    i = torch.arange(num_samples, dtype=torch.int64, device=device)
    m32 = 0xFFFFFFFF
    bits = ((i << 16) | (i >> 16)) & m32
    for mask, shift in ((0x55555555, 1), (0x33333333, 2), (0x0F0F0F0F, 4), (0x00FF00FF, 8)):
        bits = (((bits & mask) << shift) | ((bits & (mask << shift)) >> shift)) & m32
    xi2 = bits.to(torch.float32) * 2.3283064365386963e-10
    xi1 = i.to(torch.float32) / num_samples

    rc = torch.clamp(r, min=MIN_ROUGHNESS)
    a = rc * rc
    vx, vz = torch.sqrt(1.0 - nv * nv), nv
    phi = 2.0 * PI * xi1
    cos_th = torch.sqrt((1.0 - xi2) / (1.0 + (a * a - 1.0) * xi2))
    sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
    hx, hy, hz = sin_th * torch.cos(phi), sin_th * torch.sin(phi), cos_th
    vdh_raw = vx * hx + vz * hz
    lz = 2.0 * vdh_raw * hz - vz
    ndotl = torch.clamp(lz, min=0.0)
    ndoth = torch.clamp(hz, min=0.0)
    vdoth = torch.clamp(vdh_raw, min=0.0)
    k = (rc * rc) / 2.0  # Smith G with the IBL remap k = r²/2
    g = ndotl / (ndotl * (1 - k) + k) * (nv / (nv * (1 - k) + k))
    g_vis = torch.where(ndoth > 0, g * vdoth / torch.clamp(ndoth * nv, min=1e-8), 0.0)
    fc = torch.pow(1.0 - vdoth, 5.0)
    scale = torch.sum((1.0 - fc) * g_vis, dim=-1) / num_samples
    bias = torch.sum(fc * g_vis, dim=-1) / num_samples
    return torch.stack([scale, bias], dim=-1)


def stack_specular_levels(levels) -> torch.Tensor:
    """Every prefiltered level resampled to level 0's resolution and stacked
    on channels → (H0, W0, L·3)."""
    h, w = levels[0].shape[0], levels[0].shape[1]
    return torch.cat([levels[0], *(resize_env(lvl, h, w) for lvl in levels[1:])], dim=-1)


@dataclasses.dataclass(frozen=True)
class IBLMaps:
    """The precomputed IBL bundle (the JAX package's field names)."""

    irradiance: torch.Tensor  # (Hi, Wi, 3) equirect
    specular_levels: tuple[torch.Tensor, ...]  # per-roughness equirect levels
    lut: torch.Tensor  # (S, S, 2): [roughness, n·v] → (scale, bias)
    specular_stack: torch.Tensor | None = None  # (Hs, Ws, L·3) levels on channels
    # float16 copies: the taps the fused path's forward reads (the JAX
    # package's f16 quad words hold the same values); gradients go straight
    # through to the f32 originals
    specular_stack_f16: torch.Tensor | None = None
    irradiance_f16: torch.Tensor | None = None
    irradiance_sh9: torch.Tensor | None = None  # (9, 3) SH projection of the env

    @staticmethod
    def build(env: torch.Tensor) -> "IBLMaps":
        """Every map from an HDR equirect env (H, W, 3), on its device;
        differentiable w.r.t. ``env`` through the f32 fields."""
        levels = prefilter_specular(env)
        stack = stack_specular_levels(levels)
        irr = irradiance_map(env)
        return IBLMaps(
            irradiance=irr,
            specular_levels=levels,
            lut=brdf_lut(device=env.device),
            specular_stack=stack,
            specular_stack_f16=stack.detach().to(torch.float16),
            irradiance_f16=irr.detach().to(torch.float16),
            irradiance_sh9=sh9_coeffs(env),
        )

    @property
    def num_specular_levels(self) -> int:
        return len(self.specular_levels)

    def to(self, device) -> "IBLMaps":
        move = lambda t: None if t is None else t.to(device)
        return IBLMaps(
            irradiance=move(self.irradiance),
            specular_levels=tuple(move(t) for t in self.specular_levels),
            lut=move(self.lut),
            specular_stack=move(self.specular_stack),
            specular_stack_f16=move(self.specular_stack_f16),
            irradiance_f16=move(self.irradiance_f16),
            irradiance_sh9=move(self.irradiance_sh9),
        )


def env_brdf_approx(ndotv: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Analytic split-sum BRDF term (Karis/Lazarov) → (..., 2) = (scale,
    bias)."""
    c0 = torch.tensor([-1.0, -0.0275, -0.572, 0.022], dtype=torch.float32, device=ndotv.device)
    c1 = torch.tensor([1.0, 0.0425, 1.04, -0.04], dtype=torch.float32, device=ndotv.device)
    r4 = roughness[..., None] * c0 + c1
    a004 = torch.minimum(r4[..., 0] * r4[..., 0], torch.exp2(-9.28 * ndotv)) * r4[..., 0] + r4[..., 1]
    return torch.stack([a004 * -1.04 + r4[..., 2], a004 * 1.04 + r4[..., 3]], dim=-1)


def specular_levels_lerp(smp_all: torch.Tensor, roughness: torch.Tensor, num_levels: int) -> torch.Tensor:
    """Roughness → blend of the two nearest levels of a stacked specular
    sample (..., L·3) → (..., 3). The roughness clip splits a tie 0.5/0.5,
    as ``jnp.clip`` does (the grid's roughness sweep starts at 0 and ends
    at 1)."""
    lod = torch.minimum(torch.maximum(roughness, roughness.new_zeros(())), roughness.new_ones(()))
    lod = lod * (num_levels - 1)
    l0 = torch.floor(lod)
    frac = (lod - l0)[..., None]
    l1 = torch.clamp(l0 + 1, 0, num_levels - 1)
    pre0 = torch.zeros(smp_all.shape[:-1] + (3,), dtype=smp_all.dtype, device=smp_all.device)
    pre1 = torch.zeros_like(pre0)
    for li in range(num_levels):
        smp = smp_all[..., 3 * li : 3 * li + 3]
        pre0 = pre0 + (l0 == li).to(smp.dtype)[..., None] * smp
        pre1 = pre1 + (l1 == li).to(smp.dtype)[..., None] * smp
    return pre0 * (1.0 - frac) + pre1 * frac


class _SpecularTaps(torch.autograd.Function):
    """The four bilinear taps of the specular stack, read from its float16
    copy; their cotangents go straight through to the f32 stack, summed over
    hit pixels only (a background pixel's taps are masked out downstream,
    and sending its zeros into one texel would serialise the scatter)."""

    @staticmethod
    def forward(ctx, stack, stack_f16, hit, i00, i01, i10, i11):
        c = stack.shape[-1]
        flat = stack_f16.reshape(-1, c)
        ctx.save_for_backward(hit, i00, i01, i10, i11)
        ctx.stack_shape = stack.shape
        return tuple(flat[i].to(torch.float32) for i in (i00, i01, i10, i11))

    @staticmethod
    def backward(ctx, *g_taps):
        g_stack = None
        if ctx.needs_input_grad[0]:
            hit, *idx = ctx.saved_tensors
            shape = ctx.stack_shape
            sel = torch.nonzero(hit.reshape(-1)).squeeze(1)
            rows = torch.cat([i.reshape(-1)[sel] for i in idx])
            vals = torch.cat([g.reshape(-1, shape[2])[sel] for g in g_taps])
            g_stack = torch.zeros((shape[0] * shape[1], shape[2]), dtype=torch.float32, device=hit.device)
            # accumulating index_put_ sorts the rows and sums each run in
            # order (no float atomics on the card): the same bits every run
            g_stack = g_stack.index_put_((rows,), vals, accumulate=True).reshape(shape)
        return g_stack, None, None, None, None, None, None


def sample_spec_sky_merged(ibl: IBLMaps, r: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """The specular half of the fused IBL path's env gather
    (``sample_spec_sky_merged`` semantics) → smp_all (..., L·3) f32. The JAX
    package merges the sky's taps into this gather, a TPU gather-count trick;
    the port samples the sky on its own (``sky.sample_sky``).

    ``smp_all`` filters the f16-rounded taps of the specular stack along the
    unit reflect directions ``r``; it is differentiable w.r.t.
    ``ibl.specular_stack`` (straight-through, hit pixels) and w.r.t. ``r``
    through the filter weights. Its background pixels are not meaningful:
    mask them before any arithmetic."""
    hs, ws = ibl.specular_stack.shape[0], ibl.specular_stack.shape[1]
    idx, (fx, fy) = bilinear_taps(world_to_sky_uv(r), hs, ws)
    taps = _SpecularTaps.apply(ibl.specular_stack, ibl.specular_stack_f16, hit, *idx)
    return bilinear(taps, fx, fy)
