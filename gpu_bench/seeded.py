"""Inputs made from ``--seed`` on the device: texture pages, the HDR
environment and its LDR sky, the training targets and the camera path.

The fields are those the repository's chip smoke test seeds (smooth
sinusoid pages quantised to uint8 as a decoded JPEG is, normal maps within
~17° of +z, a sky gradient with two sun lobes, a horizon gradient with
texel noise), drawn here from a ``torch.Generator`` on the card in a few
large calls. Every seed gives the same sizes and the same set of camera
poses; only the texel values and the order of the poses change."""

from __future__ import annotations

import math

import numpy as np
import torch

SEED_MOD = 1 << 62


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator of ``device`` for one named input of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % SEED_MOD)
    return g


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def texture_pages(seed: int, slots: list[str], size: int, device) -> torch.Tensor:
    """(N, size, size, 3) uint8 pages, one for each slot name of ``slots``:
    per channel three sinusoids at integer frequencies 1-4 (so a page tiles
    under the wrap sampler and its mips keep structure), amplitude 0.3-1,
    random phase; colour and scalar maps 0.5 + 0.4·field, normal maps the
    unit vector (0.3·f0, 0.3·f1, 1) encoded 0.5 + 0.5·v."""
    g = generator(seed, 1, device)
    n = len(slots)
    k = torch.randint(1, 5, (n, 3, 3, 2), generator=g, device=device).to(torch.float32)
    amp = _uniform(g, (n, 3, 3), 0.3, 1.0, device)
    phase = _uniform(g, (n, 3, 3), 0.0, 2.0 * math.pi, device)
    yy, xx = torch.meshgrid(*(((torch.arange(size, device=device, dtype=torch.float32) + 0.5) / size,) * 2),
                            indexing="ij")
    arg = 2.0 * math.pi * (k[..., 0, None, None] * xx + k[..., 1, None, None] * yy) + phase[..., None, None]
    field = (amp[..., None, None] * torch.sin(arg)).sum(2).permute(0, 2, 3, 1) / 3.0  # (n, S, S, 3)
    normal = torch.tensor([s == "normal" for s in slots], device=device)[:, None, None, None]
    v = torch.cat([0.3 * field[..., :2], torch.ones_like(field[..., :1])], dim=-1)
    img = torch.where(normal, 0.5 + 0.5 * v / torch.linalg.vector_norm(v, dim=-1, keepdim=True), 0.5 + 0.4 * field)
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def environment(seed: int, height: int, width: int, device) -> torch.Tensor:
    """An HDR equirect (H, W, 3) float32 in the sIBL ``_Env.hdr`` form: a
    smooth sky gradient and two bright sun lobes (values up to ~50)."""
    g = generator(seed, 2, device)
    v = ((torch.arange(height, device=device, dtype=torch.float32) + 0.5) / height)[:, None]
    u = ((torch.arange(width, device=device, dtype=torch.float32) + 0.5) / width)[None, :]
    theta, phi = 2 * math.pi * u, math.pi * (0.5 - v)
    d = torch.stack(torch.broadcast_tensors(torch.cos(phi) * torch.cos(theta), torch.sin(phi),
                                            torch.cos(phi) * torch.sin(theta)), dim=-1)
    vv = v.expand(height, width)
    env = torch.stack([0.3 + 0.7 * (1 - vv), 0.4 + 0.5 * (1 - vv), 0.6 + 0.6 * (1 - vv)], dim=-1)
    s = torch.randn((2, 3), generator=g, device=device)
    s = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)
    s[:, 1] = s[:, 1].abs()
    power = _uniform(g, (2,), 20.0, 60.0, device)
    gain = _uniform(g, (2,), 30.0, 50.0, device)
    tint = _uniform(g, (2, 3), 0.7, 1.0, device)
    for i in range(2):
        lobe = torch.clamp(d @ s[i], min=0.0) ** power[i]
        env = env + gain[i] * lobe[..., None] * tint[i]
    return env.contiguous()


def sky_u8(seed: int, height: int, width: int, device) -> torch.Tensor:
    """The LDR sky background (H, W, 3) uint8: a horizon gradient with
    ±0.08 texel noise, quantised round(clip(x, 0, 1)·255) as an sIBL
    ``_3k`` JPEG decodes."""
    g = generator(seed, 3, device)
    vv = ((torch.arange(height, device=device, dtype=torch.float32) + 0.5) / height)[:, None, None]
    base = torch.cat([0.35 + 0.5 * (1 - vv), 0.45 + 0.4 * (1 - vv), 0.55 + 0.4 * (1 - vv)], dim=-1)
    noise = _uniform(g, (height, width, 3), -0.08, 0.08, device)
    return torch.round(torch.clamp(base + noise, 0.0, 1.0) * 255.0).to(torch.uint8)


def targets(seed: int, count: int, height: int, width: int, device) -> torch.Tensor:
    """(count, H, W, 3) training targets in display units: smooth colour
    fields 0.5 ± 0.35, one per view, all different."""
    g = generator(seed, 4, device)
    k = torch.randint(1, 6, (count, 3, 2), generator=g, device=device).to(torch.float32)
    phase = _uniform(g, (count, 3), 0.0, 2.0 * math.pi, device)
    yy = ((torch.arange(height, device=device, dtype=torch.float32) + 0.5) / height)[:, None]
    xx = ((torch.arange(width, device=device, dtype=torch.float32) + 0.5) / width)[None, :]
    arg = 2.0 * math.pi * (k[..., 0, None, None] * xx + k[..., 1, None, None] * yy) + phase[..., None, None]
    return (0.5 + 0.35 * torch.sin(arg)).permute(0, 2, 3, 1).contiguous()


def camera_path(seed: int, path: dict, count: int) -> np.ndarray:
    """(count, 5) float32 poses [position xyz, yaw, pitch] on a closed loop
    of ``path["poses"]`` poses around ``path["centre"]`` at ``path["radius"]``,
    each looking at the centre: yaw = yaw0 + yaw_amp·sin(2πt), pitch =
    pitch_amp·sin(4πt) (a figure eight, as a user drags the mouse), or a full
    turn in yaw with ``yaw_amp`` null. The seed picks the loop's starting
    pose and its direction, so every seed visits the same poses."""
    rng = np.random.default_rng(int(seed) % SEED_MOD)
    p = int(path["poses"])
    start, sign = int(rng.integers(p)), (1 if rng.integers(2) else -1)
    t = ((start + sign * np.arange(count)) % p) / p
    if path.get("yaw_amp") is None:
        yaw = path.get("yaw0", 0.0) + 2.0 * math.pi * t
    else:
        yaw = path.get("yaw0", 0.0) + path["yaw_amp"] * np.sin(2.0 * math.pi * t)
    pitch = path["pitch_amp"] * np.sin(4.0 * math.pi * t)
    fwd = np.stack([np.cos(pitch) * np.sin(yaw), np.sin(pitch), np.cos(pitch) * np.cos(yaw)], axis=-1)
    pos = np.asarray(path["centre"], np.float64)[None] - path["radius"] * fwd
    return np.concatenate([pos, yaw[:, None], pitch[:, None]], axis=-1).astype(np.float32)
