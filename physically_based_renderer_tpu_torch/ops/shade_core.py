"""Per-pixel Cook-Torrance (+ IBL) shading math — the counterpart of
``physically_based_renderer_tpu/ops/shade_core.py``.

The reference's ``Default.hlsl:47-161`` pixel shader with
``LightingUtil.hlsl`` BRDF semantics, as pure elementwise math over tensors
of one common shape S: vectors are 3-tuples of such tensors and the shading
uniforms are one (1, U) row. ``csrc/shade_core.cuh`` evaluates the same
expressions in registers, in the same order.

One term is written differently from the JAX package, with the same value in
exact arithmetic: the GGX denominator forms 1 − (n·h)² as |n×h|². At a
0.05-roughness highlight the float32 subtraction left ~1e-4 of error in the
display-encoded colour (about as much as the JAX package's two float32
paths differ from each other); the cross-product form is within ~1e-6 of a
float64 evaluation.

Uniform row layout (``pack_shading_uniforms``):
    [0:3]  eye position
    [3:6]  ambient light (unused when ``ibl=True``)
    [6:8]  pad
    [8 + 10·i : 18 + 10·i]  light i: strength(3), direction(3), position(3),
                            spot_power(1)
    [8 + 10·L :]            (ibl only) 27 SH9 irradiance coefficients,
                            k-major: sh[k][c] at 8 + 10·L + 3·k + c
"""

from __future__ import annotations

import torch

PI = 3.14159265359  # LightingUtil.hlsl literal
LN2 = 0.6931471805599453

UNI_LIGHT0 = 8
UNI_PER_LIGHT = 10
SH_COEFFS = (0.429043, 0.511664, 0.743125, 0.886227, 0.247708)  # Ramamoorthi-Hanrahan c1..c5


def uniform_count(num_lights: int, ibl: bool) -> int:
    return UNI_LIGHT0 + UNI_PER_LIGHT * num_lights + (27 if ibl else 0)


def pack_shading_uniforms(
    light_strength: torch.Tensor,  # (L, 3)
    light_direction: torch.Tensor,  # (L, 3)
    light_position: torch.Tensor,  # (L, 3)
    light_spot_power: torch.Tensor,  # (L,)
    ambient: torch.Tensor,  # (3,)
    eye: torch.Tensor,  # (3,)
    sh9: torch.Tensor | None = None,  # (9, 3) irradiance SH coefficients
) -> torch.Tensor:
    """Pack the shading uniforms into one (1, U) f32 row (differentiable:
    the backward's uniform cotangent slices back out through autograd)."""
    lrows = light_strength.shape[0]
    lights = torch.cat(
        [
            light_strength.reshape(lrows, 3),
            light_direction.reshape(lrows, 3),
            light_position.reshape(lrows, 3),
            light_spot_power.reshape(lrows, 1),
        ],
        dim=-1,
    ).reshape(-1)
    pad = torch.zeros((2,), dtype=torch.float32, device=eye.device)
    parts = [eye.reshape(3), ambient.reshape(3), pad, lights]
    if sh9 is not None:
        parts.append(sh9.reshape(27))
    return torch.cat(parts).reshape(1, -1)


def unpack_uniform_grads(g_uni: torch.Tensor, num_lights: int, ibl: bool):
    """Inverse of :func:`pack_shading_uniforms` for a cotangent row:
    (1, ≥U) → (g_strength, g_direction, g_position, g_spot_power,
    g_ambient, g_eye, g_sh9 (9, 3) or None)."""
    g = g_uni.reshape(-1)
    s0 = UNI_LIGHT0 + UNI_PER_LIGHT * num_lights
    lblock = g[UNI_LIGHT0:s0].reshape(num_lights, 10)
    g_sh9 = g[s0 : s0 + 27].reshape(9, 3) if ibl else None
    return lblock[:, 0:3], lblock[:, 3:6], lblock[:, 6:9], lblock[:, 9], g[3:6], g[0:3], g_sh9


def num_output_channels(ibl: bool) -> int:
    """Channels ``shade_core`` returns: (r, g, b, opacity), or the 11 of the
    IBL mode."""
    return 11 if ibl else 4


def shade_core(
    pos,  # 3-tuple of S-shaped tensors: world position
    nrm,  # 3-tuple: raw interpolated normal (not normalized)
    props,  # 9-tuple: diffuse rgb, metallic, fresnel_r0 rgb, roughness, opacity
    uni: torch.Tensor,  # (1, U) f32
    *,
    num_dir: int,
    num_point: int,
    num_spot: int,
    apply_tonemap: bool,
    ibl: bool = False,
):
    """The pixel shader as elementwise math.

    ``ibl=False``: (r, g, b, opacity), display encoded (Reinhard + gamma)
    when ``apply_tonemap``, HDR otherwise.
    ``ibl=True``: (hdr_r, hdr_g, hdr_b, sf_r, sf_g, sf_b, rx, ry, rz,
    roughness, opacity), HDR whatever ``apply_tonemap`` says: hdr = direct
    + kd·irr_SH9·albedo, sf = F0·scale + bias (Karis/Lazarov
    ``env_brdf_approx``), r the unit reflect(−v, n). The env gather outside
    completes hdr + sf·prefiltered(r, roughness)."""

    def u(k):  # one uniform element, broadcasts like a scalar
        return uni[0, k]

    def vdot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def vnormalize(a):  # math3d.normalize parity (1e-20 guard)
        inv = torch.rsqrt(torch.clamp(vdot(a, a), min=1e-20))
        return (a[0] * inv, a[1] * inv, a[2] * inv)

    alb = props[0:3]
    met = props[3]
    f0c = props[4:7]
    rough = props[7]
    opac = props[8]

    n = vnormalize(nrm)
    v = vnormalize((u(0) - pos[0], u(1) - pos[1], u(2) - pos[2]))
    f0 = tuple(f0c[c] + (alb[c] - f0c[c]) * met for c in range(3))  # Default.hlsl:94-96

    ndotv = torch.clamp(vdot(n, v), min=0.0)
    r_cl = torch.clamp(rough, min=0.05)  # LightingUtil.hlsl:51
    a_g = r_cl * r_cl
    a2 = a_g * a_g
    kg = (rough + 1.0) * (rough + 1.0) / 8.0  # LightingUtil.hlsl:66-67
    gv = ndotv / (ndotv * (1.0 - kg) + kg)
    one_m_met = 1.0 - met
    inv_pi_alb = tuple(alb[c] * (1.0 / PI) for c in range(3))

    out_c = [None, None, None]

    def add_light(strength, l, atten):
        """One BRDFCookTorrance accumulation (LightingUtil.hlsl:85-104)."""
        h = vnormalize((v[0] + l[0], v[1] + l[1], v[2] + l[2]))
        ndoth = torch.clamp(vdot(n, h), min=0.0)
        # dn = ndoth²(a2−1)+1, with 1−ndoth² formed as |n×h|² (equal for unit
        # vectors): near a sharp highlight n·h ≈ 1 and the f32 subtraction
        # keeps a thousandth of 1−ndoth², ~1e-4 of the shaded value.
        nxh = (n[1] * h[2] - n[2] * h[1], n[2] * h[0] - n[0] * h[2], n[0] * h[1] - n[1] * h[0])
        dn = torch.where(ndoth > 0.0, vdot(nxh, nxh) + ndoth * ndoth * a2, 1.0)
        ndf = a2 / (PI * dn * dn)
        ndotl = torch.clamp(vdot(n, l), min=0.0)
        gl = ndotl / (ndotl * (1.0 - kg) + kg)
        hv = torch.clamp(vdot(h, v), 0.0, 1.0)
        t = 1.0 - hv
        t2 = t * t
        t5 = t2 * t2 * t
        spec_s = ndf * (gv * gl) / (4.0 * ndotv * ndotl + 1e-3)
        for c in range(3):
            f = f0[c] + (1.0 - f0[c]) * t5
            contrib = ((1.0 - f) * one_m_met * inv_pi_alb[c] + spec_s * f) * (
                strength[c] * atten
            ) * ndotl
            out_c[c] = contrib if out_c[c] is None else out_c[c] + contrib

    def to_light(b):
        tl = (u(b + 6) - pos[0], u(b + 7) - pos[1], u(b + 8) - pos[2])
        d = torch.sqrt(torch.clamp(vdot(tl, tl), min=1e-20))
        inv_d = 1.0 / torch.clamp(d, min=1e-20)
        l = (tl[0] * inv_d, tl[1] * inv_d, tl[2] * inv_d)
        d_sat = torch.clamp(d, min=0.01)
        return d, l, d_sat

    li = 0
    for _ in range(num_dir):
        b = UNI_LIGHT0 + li * UNI_PER_LIGHT
        add_light((u(b), u(b + 1), u(b + 2)), (-u(b + 3), -u(b + 4), -u(b + 5)), 1.0)
        li += 1
    for _ in range(num_point):
        b = UNI_LIGHT0 + li * UNI_PER_LIGHT
        d, l, d_sat = to_light(b)
        atten = torch.where(d <= 100.0, 1.0 / (d_sat * d_sat), 0.0)
        add_light((u(b), u(b + 1), u(b + 2)), l, atten)
        li += 1
    for _ in range(num_spot):
        b = UNI_LIGHT0 + li * UNI_PER_LIGHT
        d, l, d_sat = to_light(b)
        cone = torch.clamp(-(l[0] * u(b + 3) + l[1] * u(b + 4) + l[2] * u(b + 5)), min=0.0)
        atten = torch.where(d <= 100.0, torch.pow(cone, u(b + 9)) / (d_sat * d_sat), 0.0)
        add_light((u(b), u(b + 1), u(b + 2)), l, atten)
        li += 1

    if out_c[0] is None:
        zero = pos[0] * 0.0
        out_c = [zero, zero, zero]

    if ibl:
        s0 = UNI_LIGHT0 + UNI_PER_LIGHT * (num_dir + num_point + num_spot)
        return _ibl_tail(n, v, ndotv, f0, one_m_met, alb, rough, opac, out_c,
                         lambda k, c: u(s0 + 3 * k + c), vnormalize)

    rows = []
    for c in range(3):
        lit = u(3 + c) * alb[c] + out_c[c]  # ambient·albedo + direct
        if apply_tonemap:
            x = torch.clamp(lit, min=0.0)
            x = x / (x + 1.0)  # Reinhard (Default.hlsl:153)
            lit = torch.pow(torch.clamp(x, min=1e-8), 1.0 / 2.2)
        rows.append(lit)
    rows.append(opac)
    return tuple(rows)


def _ibl_tail(n, v, ndotv, f0, one_m_met, alb, rough, opac, direct, sh, vnormalize):
    """The in-kernel half of the IBL ambient (``ambient_ibl`` semantics), in
    the JAX package's order; ``sh(k, c)`` reads one SH9 coefficient.
    Elementwise min splits a tie 0.5/0.5, as ``jnp.minimum`` does."""
    t5v = 1.0 - ndotv
    t5v = (t5v * t5v) * (t5v * t5v) * t5v  # (1 − n·v)^5
    x, y, z = n
    c1, c2, c3, c4, c5 = SH_COEFFS
    xx_yy = x * x - y * y
    zz = z * z
    xy = x * y
    xz = x * z
    yz = y * z
    zero = torch.zeros((), dtype=ndotv.dtype, device=ndotv.device)
    # env_brdf_approx, with exp2(x) written as exp(x·ln2)
    e2 = torch.exp(torch.minimum(-9.28 * ndotv, zero) * LN2)
    r40 = rough * -1.0 + 1.0
    r41 = rough * -0.0275 + 0.0425
    r42 = rough * -0.572 + 1.04
    r43 = rough * 0.022 - 0.04
    a004 = torch.minimum(r40 * r40, e2) * r40 + r41
    scale = a004 * -1.04 + r42
    bias = a004 * 1.04 + r43
    rows = []
    for c in range(3):
        irr = (
            c1 * sh(8, c) * xx_yy
            + c3 * sh(6, c) * zz
            + c4 * sh(0, c)
            - c5 * sh(6, c)
            + 2.0 * c1 * (sh(4, c) * xy + sh(7, c) * xz + sh(5, c) * yz)
            + 2.0 * c2 * (sh(3, c) * x + sh(1, c) * y + sh(2, c) * z)
        ) * (1.0 / PI)
        ks = f0[c] + (1.0 - f0[c]) * t5v
        kd = (1.0 - ks) * one_m_met
        rows.append(direct[c] + kd * irr * alb[c])
    for c in range(3):
        rows.append(f0[c] * scale + bias)
    rows.extend(vnormalize(tuple(2.0 * ndotv * n[c] - v[c] for c in range(3))))  # reflect(−v, n)
    rows.append(rough)
    rows.append(opac)
    return tuple(rows)
