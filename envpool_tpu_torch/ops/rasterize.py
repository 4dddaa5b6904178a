"""Rasterizer for physics scenes (the ``from_pixels`` path), batched.

Counterpart of ``envpool_tpu/ops/rasterize.py``: an orthographic side
view (looking along +y) over the model's geom table, centred on one
body's x at a fixed height.  Spheres and ellipsoids are discs, capsules
and cylinders stadiums (distance to their axis segment), boxes the
stadium along their longest axis, anything else a small marker, and a
floor plane fills everything below z = 0 with a checker.  The nearest geom
(camera depth y) wins each pixel; its luma from ``geom_rgba`` darkens
toward its edge.

Every env's image is ``[H, W]`` of a ``[N, H, W]`` float32 batch, drawn
one geom at a time with a running depth and luma, as the JAX loop does:
no ``[N, ng, H, W]`` tensor.  The pixel grid is computed in float64 and
rounded once (:func:`pixel_grid`), so the card and the CPU sample the
same points; JAX's float32 grid lies within an ulp of it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..physics.kinematics import fk, quat2mat

__all__ = ["frame_rule_violations", "pixel_grid", "render_scene", "rounding_pixels"]

_SPHERE, _CAPSULE, _ELLIPSOID, _CYLINDER, _BOX = 2, 3, 4, 5, 6
_PLANE = 0


def pixel_grid(view_size: float, height: int, width: int):
    """The image's sample points relative to the camera: ``(x [W], z
    [H])`` float32, left to right and top to bottom, each spaced
    ``view_size / (n − 1)`` and computed in float64 and rounded once.
    (JAX's float32 ``linspace`` rounds its points differently from one
    compiled program to another, by an ulp.)"""
    h = view_size / 2
    return (np.linspace(-h, h, width).astype(np.float32),
            np.linspace(h, -h, height).astype(np.float32))


@functools.lru_cache(maxsize=64)
def _scene(model, device: torch.device, dtype: torch.dtype):
    """Per geom: its body, its frame in the body (rotation and offset) and
    what the JAX loop reads as Python numbers (type, radius, half length,
    axis column, luma)."""
    gtype = np.asarray(model.geom_type)
    gsize = np.asarray(model.geom_size, np.float64)
    rgba = np.asarray(model.geom_rgba, np.float64)
    lumas = 255.0 * (0.299 * rgba[:, 0] + 0.587 * rgba[:, 1] + 0.114 * rgba[:, 2])
    geoms = []
    for g in range(len(gtype)):
        t = int(gtype[g])
        lum = float(lumas[g]) if np.isfinite(lumas[g]) else 128.0
        half, axis = 0.0, 2
        if t == _SPHERE:
            r = float(gsize[g][0])
        elif t in (_CAPSULE, _CYLINDER):
            half, r = float(gsize[g][1]), float(gsize[g][0])
        elif t == _BOX:
            axis = int(np.argmax(gsize[g]))
            half = float(gsize[g][axis])
            r = float(np.mean([gsize[g][i] for i in range(3) if i != axis]))
        elif t == _ELLIPSOID:
            r = float(np.mean(gsize[g]))
        else:  # meshes and height fields: a small marker at the geom
            r = 0.05
        geoms.append((t, r, half, axis, lum))

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    return (
        dev(np.asarray(model.geom_body), torch.int64),
        dev(quat2mat(np.asarray(model.geom_quat, np.float64))),
        dev(np.asarray(model.geom_pos, np.float64)),
        geoms,
    )


def _layers(model, qpos, height, width, track_body, view_size, cam_height):
    """The sample points ``px [N, 1, W]``, ``pz [1, H, 1]`` and then, per
    geom in the table's order, ``(type, radius, luma, dist, depth)``: the
    distance ``[N, H, W]`` of every sample to the geom's segment in the
    image plane (None for a plane) and its camera depth ``[N, 1, 1]``."""
    dtype, device = qpos.dtype, qpos.device
    gb, gquat, gpos, geoms = _scene(model, device, dtype)
    Rs, ps = fk(model, qpos)
    Rg = Rs[:, gb]  # [N, ng, 3, 3]
    gR = Rg @ gquat
    gp = ps[:, gb] + (Rg @ gpos[..., None]).squeeze(-1)
    xs, zs = (torch.as_tensor(v, device=device) for v in pixel_grid(view_size, height, width))
    px = (ps[:, track_body, 0, None] + xs.to(dtype))[:, None, :]
    pz = (cam_height + zs.to(dtype))[None, :, None]
    yield px, pz
    for g, (t, r, half, axis, lum) in enumerate(geoms):
        if t == _PLANE:
            yield t, r, lum, None, None
            continue
        center = gp[:, g]  # [N, 3]
        if half:
            ax_w = gR[:, g, :, axis]
            a, b = center - half * ax_w, center + half * ax_w
        else:
            a = b = center
        ax, az = a[:, 0, None, None], a[:, 2, None, None]
        abx, abz = b[:, 0, None, None] - ax, b[:, 2, None, None] - az
        ab2 = abx * abx + abz * abz + 1e-9
        tpar = torch.clamp(((px - ax) * abx + (pz - az) * abz) / ab2, 0.0, 1.0)
        qx = ax + tpar * abx
        qz = az + tpar * abz
        dist = torch.sqrt((px - qx) ** 2 + (pz - qz) ** 2)
        yield t, r, lum, dist, ((a[:, 1] + b[:, 1]) / 2.0)[:, None, None]


def render_scene(
    model,
    qpos: torch.Tensor,
    height: int = 84,
    width: int = 84,
    track_body: int = 1,
    view_size: float = 2.0,
    cam_height: float = 0.6,
) -> torch.Tensor:
    """``[N, height, width]`` luma in ``[0, 255]``, in the dtype of the
    states ``qpos`` ``[N, nq]``.

    Camera: orthographic, looking along +y, centred on ``track_body``'s x
    and at height ``cam_height``, spanning ``view_size`` world units.
    """
    layers = _layers(model, qpos, height, width, track_body, view_size, cam_height)
    px, pz = next(layers)
    shape = (qpos.shape[0], height, width)
    depth = qpos.new_full(shape, float("inf"))
    luma = qpos.new_full(shape, 168.0)  # sky
    for t, r, lum, dist, d in layers:
        if dist is None:
            # Ground: everything below z = 0, checkered for motion cues.
            better = (pz <= 0.0) & (depth > 1e3)
            check = (torch.floor(px / 0.5).to(torch.int32)
                     + torch.floor(pz / 0.5).to(torch.int32)) % 2 == 0
            luma = torch.where(better, torch.where(check, 90.0, 110.0).to(qpos.dtype), luma)
            depth = torch.where(better, 1e3, depth)
            continue
        better = (dist <= np.float32(r)) & (d < depth)
        shade = lum * (1.0 - 0.35 * (dist / np.float32(r + 1e-9)))
        luma = torch.where(better, shade, luma)
        depth = torch.where(better, d, depth)
    return luma


def rounding_pixels(model, qpos, height=84, width=84, track_body=1, view_size=2.0,
                    cam_height=0.6, eps=1e-4, eps_luma=1e-2):
    """Where float rounding may decide a pixel of :func:`render_scene`:
    ``(edge, trunc)``, ``[N, H, W]`` bools from a float64 render of
    ``qpos``.  ``edge``: a geom's edge (distance within ``eps`` of its
    radius), two covering geoms' depths within ``eps``, the floor's line or
    a checker line within ``eps`` of a sample.  There two float32 renders
    of nearby states may paint different geoms.  ``trunc``: a shaded geom
    wins and its luma lies within ``eps_luma`` of an integer, where the
    uint8 cast may truncate a float32 luma either way (by 1)."""
    layers = _layers(model, qpos.double(), height, width, track_body, view_size, cam_height)
    px, pz = next(layers)
    shape = (qpos.shape[0], height, width)
    depth = torch.full(shape, float("inf"), dtype=torch.float64, device=qpos.device)
    luma = torch.full_like(depth, 168.0)
    edge = torch.zeros(shape, dtype=torch.bool, device=qpos.device)
    shaded = edge.clone()

    def near_line(x, step):
        return ((x / step - torch.round(x / step)).abs() * step <= eps)

    for t, r, lum, dist, d in layers:
        if dist is None:
            edge |= (pz.abs() <= eps) | near_line(px, 0.5) | near_line(pz, 0.5)
            better = (pz <= 0.0) & (depth > 1e3)
            luma = torch.where(better, 100.0, luma)
            depth = torch.where(better, 1e3, depth)
            shaded &= ~better
            continue
        r32 = float(np.float32(r))
        cover = dist <= r32 + eps
        edge |= ((dist - r32).abs() <= eps) | (cover & ((d - depth).abs() <= eps))
        better = (dist <= r32) & (d < depth)
        luma = torch.where(better, lum * (1.0 - 0.35 * (dist / (r + 1e-9))), luma)
        depth = torch.where(better, d, depth)
        shaded |= better
    trunc = shaded & ((luma - torch.round(luma)).abs() <= eps_luma)
    return edge, trunc


def frame_rule_violations(got: torch.Tensor, want: torch.Tensor, edge: torch.Tensor,
                          trunc: torch.Tensor) -> dict:
    """How two uint8 frame batches ``[N, ..., H, W]`` of the same states
    break the frame rule: equal everywhere except at ``edge`` pixels (any
    difference) and ``trunc`` pixels (a difference of 1).  ``edge`` and
    ``trunc`` are ``[N, H, W]`` (:func:`rounding_pixels`), broadcast over
    any axis between.  Returns the counts of differing pixels, of those
    at an edge and at a truncation, and of violations."""
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    while edge.dim() < diff.dim():
        edge, trunc = edge.unsqueeze(1), trunc.unsqueeze(1)
    differ = diff > 0
    ok = edge | (trunc & (diff <= 1))
    return {
        "pixels": diff.numel(),
        "differ": int(differ.sum()),
        "at_edge": int((differ & edge).sum()),
        "at_trunc": int((differ & ~edge & trunc).sum()),
        "violations": int((differ & ~ok).sum()),
        "max_diff": int(diff.max()) if diff.numel() else 0,
    }
