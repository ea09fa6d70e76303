"""Multi-process rendering and training over ``torch.distributed`` — the
counterpart of ``physically_based_renderer_tpu/parallel/sharded.py``.

One process per device. Every function takes an optional process ``group``
(the default group when None); with no process group initialised it runs as
a world of one: rank 0, no collectives. The caller initialises the group
(``parallel/distributed.initialize_distributed``: NCCL for CUDA tensors,
gloo for CPU tensors).

  * **Row bands** (``render_sharded``, ``make_train_step``): the frame is cut
    into ``n`` horizontal bands, one per rank. Geometry, materials and
    lights are replicated; each rank renders its band with ``render(rows=,
    y_offset=)``, so the forward needs no communication. The training step
    all-reduces the material gradients and the loss in one flat buffer —
    the ``pmean`` that ``shard_map``'s transpose inserts in the JAX package.
  * **Triangle shards** (``render_tri_sharded``, ``merge="band"``): each rank
    holds ceil(T/n) triangles, the O(T/n) memory axis. A band
    reduce-scatter ring: at step k a rank rasterizes band (rank+k+1) mod n
    against its own shard into a G-buffer (``raster_gbuffer``), merges it by
    depth into the travelling (z, attrs, tri id, material) buffer and passes
    the buffer to rank−1. After n steps each rank holds its own band
    resolved over every shard and shades it (``shade_compose_band_attrs``).
    The pass is a ``torch.autograd.Function`` whose backward sends the
    cotangent the other way, so geometry gradients reach the shard that owns
    the winning triangle.

Gradients of replicated inputs (materials, lights, the eye) that a rank
computes through ``render_sharded`` or ``render_tri_sharded`` are that
rank's share; sum them over the ranks (``make_train_step`` does) to get the
gradient of the whole frame's loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from .. import math3d
from ..camera import Camera
from ..models.scene import Scene, flatten_scene_corners
from ..ops.raster_pallas import raster_gbuffer
from ..renderer import check_scene, render, shade_compose_band_attrs


def process_group(group=None):
    """``group``, else the default process group; None when no process
    group is initialised (a world of one)."""
    if group is not None:
        return group
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def rank_and_size(group) -> tuple[int, int]:
    """This process's rank in ``group`` and the group's size; (0, 1) for None."""
    return (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))


def _band(height: int, n: int) -> int:
    if height % n:
        raise ValueError(f"height {height} must divide over {n} ranks")
    return height // n


def render_sharded(
    scene: Scene,
    camera: Camera,
    *,
    width: int,
    height: int,
    group=None,
    **render_kwargs: Any,
) -> torch.Tensor:
    """This rank's row band of the frame, (H/n, W, 4): ``render(rows=H/n,
    y_offset=rank·H/n)``. ``height`` must divide by the group's size n.
    Gradients of replicated inputs through it are this rank's share (see the
    module docstring); ``parallel/distributed.fetch_image`` gathers the
    bands into the frame."""
    rank, n = rank_and_size(process_group(group))
    band = _band(height, n)
    return render(scene, camera, width=width, height=height, rows=band, y_offset=rank * band,
                  **render_kwargs)


def shard_target(target: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows of a (H, W, C) target image."""
    rank, n = rank_and_size(process_group(group))
    band = _band(target.shape[0], n)
    return target[rank * band : (rank + 1) * band]


def make_train_step(
    *,
    width: int,
    height: int,
    learning_rate: float = 0.1,
    group=None,
    **render_kwargs: Any,
):
    """Build an inverse-rendering SGD step over the material bank, row-band
    sharded over the group.

    Returns ``step(scene, camera, target) -> (scene, loss)``. ``target`` is
    this rank's (H/n, W, 3) band of the target frame (``shard_target``). Each
    rank's loss is its band's ``mean((render[..., :3] − target)²)``; the
    gradients of the floating-point fields of ``scene.materials`` and the
    loss go through one ``all_reduce`` (SUM, then /n) of a flat buffer, so
    every rank takes the same step on the whole frame's mean loss and
    returns that loss. Fields the render does not read have no gradient and
    stay as they are; integer fields are never touched. With no process
    group (a world of one) no collective runs."""

    def step(scene: Scene, camera: Camera, target: torch.Tensor):
        grp = process_group(group)
        rank, n = rank_and_size(grp)
        band = _band(height, n)
        mats = scene.materials
        params = {
            k: getattr(mats, k).detach().requires_grad_()
            for k in mats.tensor_fields()
            if getattr(mats, k).is_floating_point()
        }
        s = dataclasses.replace(scene, materials=dataclasses.replace(mats, **params))
        img = render(s, camera, width=width, height=height, rows=band, y_offset=rank * band, **render_kwargs)
        loss = torch.mean((img[..., :3] - target) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        # A field the render does not read has no gradient on any rank (that
        # depends on the code path only), so every rank packs the same fields.
        grads = {k: g for k, g in zip(params, grads) if g is not None}
        loss = loss.detach()
        if grp is not None:
            flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads.values()])
            dist.all_reduce(flat, group=grp)
            flat = flat / n
            loss = flat[0]
            parts = torch.split(flat[1:], [g.numel() for g in grads.values()])
            grads = {k: part.view_as(g) for (k, g), part in zip(grads.items(), parts)}
        with torch.no_grad():
            new = {k: params[k].detach() - learning_rate * g for k, g in grads.items()}
        return dataclasses.replace(scene, materials=dataclasses.replace(mats, **new)), loss

    return step


def _global_rank(group, group_rank: int) -> int:
    return group_rank if group is dist.group.WORLD else dist.get_global_rank(group, group_rank)


def _shift(tensors, group, send_to: int, recv_from: int):
    """Send ``tensors`` to group rank ``send_to`` and receive their
    like-shaped counterparts from ``recv_from``, in one batch."""
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), _global_rank(group, send_to), group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, _global_rank(group, recv_from), group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Pass tensors one hop down the ring (rank r → r−1); the backward passes
    the floating-point tensors' cotangents one hop up (r → r+1)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        rank, n = rank_and_size(group)
        ctx.group = group
        ctx.floating = [t.is_floating_point() for t in tensors]
        out = _shift(tensors, group, (rank - 1) % n, (rank + 1) % n)
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.floating) if not f])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        rank, n = rank_and_size(ctx.group)
        floats = [torch.zeros_like(g) if g is None else g for g, f in zip(grads, ctx.floating) if f]
        back = iter(_shift(floats, ctx.group, (rank + 1) % n, (rank - 1) % n))
        return (None, *[next(back) if f else None for f in ctx.floating])


@dataclasses.dataclass(frozen=True)
class TriangleShard:
    """One rank's rows of the corner-major geometry: the clip coordinates,
    attributes and face materials of triangles [start, start + rows),
    zero-padded to ceil(T/n) rows."""

    clip: torch.Tensor  # (ceil(T/n), 3, 4)
    attrs: torch.Tensor  # (ceil(T/n), 3, C)
    face_material: torch.Tensor  # (ceil(T/n),)
    start: int


def triangle_shard(scene: Scene, camera: Camera, rank: int, n: int) -> TriangleShard:
    """Rank ``rank``'s shard of the scene's triangles out of ``n``: rows
    [start, start + ceil(T/n)) of the instance expansion. Only the instances
    that hold those rows are expanded (the rows plus at most one partial
    instance at each end), then clipped. Zero rows (w = 0: rejected by the
    setup) pad the last shard."""
    counts = [d.num_instances * d.mesh.num_triangles for d in scene.draws]
    num_t = sum(counts)
    rows = -(-num_t // n)
    start = rank * rows
    stop = min(start + rows, num_t)
    draws, skip, off = [], 0, 0  # off: the global index of the draw's first triangle
    for d, count in zip(scene.draws, counts):
        lo, hi = max(start, off), min(stop, off + count)
        if lo < hi:
            tb = d.mesh.num_triangles
            i0, i1 = (lo - off) // tb, -(-(hi - off) // tb)
            if not draws:
                skip = lo - off - i0 * tb
            draws.append(dataclasses.replace(d, worlds=d.worlds[i0:i1], material_ids=d.material_ids[i0:i1]))
        off += count
    if draws:
        geom = flatten_scene_corners(dataclasses.replace(scene, draws=tuple(draws)))
        attrs = geom.attrs[skip : skip + stop - start]
        face_material = geom.face_material[skip : skip + stop - start]
    else:  # a shard past the last triangle: padding only
        attrs = scene.draws[0].worlds.new_zeros((0, 3, 6))
        face_material = scene.draws[0].material_ids.new_zeros((0,))
    pad = rows - attrs.shape[0]

    def padded(x):
        return torch.nn.functional.pad(x, (0,) * (2 * (x.ndim - 1)) + (0, pad)) if pad else x

    clip = math3d.transform_points_h(attrs[..., 0:3], camera.view_proj())
    return TriangleShard(clip=padded(clip), attrs=padded(attrs), face_material=padded(face_material),
                         start=start)


def render_tri_sharded(
    scene: Scene,
    camera: Camera,
    *,
    width: int,
    height: int,
    merge: str = "band",
    group=None,
    **render_kwargs: Any,
) -> torch.Tensor:
    """This rank's row band (H/n, W, 4) of the frame, with the TRIANGLES
    sharded over the group: the band reduce-scatter ring of the module
    docstring (JAX ``render_tri_sharded(merge="band")``). Each rank keeps
    only its ceil(T/n) rows of the clip coordinates, attributes and face
    materials (zero rows pad the last shard; they have zero area and are
    culled). The merge takes a shard's candidate where its depth is strictly
    nearer (``z < buf_z``; +inf at background), and carries global triangle
    ids. ``render_kwargs`` go to ``raster_gbuffer`` (8-row tiles, max span
    16, no big2 class, as in the JAX package).

    Differentiable: gradients of replicated inputs are this rank's share
    (module docstring); geometry gradients arrive on the rank whose shard
    holds the triangle. Raises ``RuntimeError`` when any band's binning
    overflowed its pair cap. ``merge="ring"`` and ``"allgather"`` are not
    ported (they are kept in the JAX package for comparison only)."""
    if merge != "band":
        raise ValueError(f"merge={merge!r} is not ported; the band reduce-scatter ring (merge='band') is")
    check_scene(scene, camera)
    grp = process_group(group)
    rank, n = rank_and_size(grp)
    band = _band(height, n)

    shard = triangle_shard(scene, camera, rank, n)
    clip_loc, attrs_loc, fm_loc, start = shard.clip, shard.attrs, shard.face_material, shard.start
    num_materials = scene.materials.num_materials

    device = attrs_loc.device
    buf_z = torch.full((band, width), float("inf"), dtype=torch.float32, device=device)
    buf_attrs = torch.zeros((band, width, attrs_loc.shape[-1]), dtype=torch.float32, device=device)
    buf_tid = torch.full((band, width), -1, dtype=torch.int32, device=device)
    buf_mat = torch.zeros((band, width), dtype=torch.int32, device=device)
    overflowed = torch.zeros((), dtype=torch.bool, device=device)
    kw = dict(tile_h=8, max_span=16, **render_kwargs)
    for k in range(n):
        y0 = ((rank + k + 1) % n) * band
        out = raster_gbuffer(clip_loc, attrs_loc, fm_loc, width=width, height=height, rows=band,
                             y_offset=y0, num_materials=num_materials, **kw)
        hit_k = out.tri_id >= 0
        z_k = torch.where(hit_k, out.depth, float("inf"))
        take = z_k < buf_z
        buf_z = torch.where(take, z_k, buf_z)
        buf_attrs = torch.where(take[..., None], out.attrs, buf_attrs)
        buf_tid = torch.where(take, torch.where(hit_k, out.tri_id + start, -1), buf_tid)
        buf_mat = torch.where(take, out.mat_id, buf_mat)
        overflowed = overflowed | out.overflowed
        if k < n - 1:
            buf_z, buf_attrs, buf_tid, buf_mat = _RingShift.apply(grp, buf_z, buf_attrs, buf_tid, buf_mat)
    img = shade_compose_band_attrs(scene, camera, buf_attrs, buf_tid >= 0, buf_mat, width=width,
                                   height=height, y_offset=rank * band)
    if bool(overflowed):
        raise RuntimeError("raster binning overflow in a band of the triangle-sharded ring: "
                           "triangles would be missing")
    return img
