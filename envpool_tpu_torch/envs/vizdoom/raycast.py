"""Batched Wolfenstein-style raycaster for the Doom-like scenarios.

Counterpart of ``envpool_tpu/envs/vizdoom/raycast.py``, over ``[N]`` envs:
per-column wall hits (the closed-form caster over the scenario's static
wall boxes, or the 28-step DDA over the grid), a per-column depth buffer,
billboard sprites for monsters, items and projectiles, and a weapon and
muzzle-flash overlay.  Every function computes in the dtype of the
player's position, so the frame rule can render a state in float64.

XLA turns a division by a constant into a product with its reciprocal, so
where the JAX package divides by a constant the port multiplies by the
reciprocal: the floor's shading rows then round as JAX's do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...ops.batched import const, first_argmin

H = W = 84          # native render resolution (config-resized upstream)
FOV = 1.2           # ~69 degrees
_MAX_DDA = 28       # DDA steps; enough to cross a 24-cell map diagonally

# Wall palette by wall type (1..5): RGB base colors.
_WALL_RGB = (
    (0.0, 0.0, 0.0),        # 0: empty (unused)
    (110.0, 100.0, 90.0),   # 1: grey stone
    (120.0, 70.0, 50.0),    # 2: brown brick
    (60.0, 90.0, 60.0),     # 3: green slime wall
    (90.0, 90.0, 120.0),    # 4: blue tech
    (140.0, 120.0, 60.0),   # 5: exit / goal wall
)

# Sprite palette by entity type: body color.
SPR_MONSTER = 0
SPR_MEDKIT = 1
SPR_ARMOR = 2
SPR_AMMO = 3
SPR_VEST = 4      # goal object (green armor vest)
SPR_FIREBALL = 5
SPR_POISON = 6
SPR_RGB = np.asarray(
    [
        [150, 60, 40],    # monster: brown/red imp
        [200, 200, 200],  # medkit: white (red cross accent)
        [60, 150, 60],    # armor: green
        [160, 140, 40],   # ammo: yellow clip
        [40, 180, 40],    # vest: bright green
        [230, 120, 20],   # fireball: orange
        [80, 40, 120],    # poison: purple
    ],
    np.float32,
)
SPR_RADIUS = np.asarray([0.35, 0.18, 0.18, 0.14, 0.25, 0.16, 0.16], np.float32)
SPR_HEIGHT = np.asarray([0.75, 0.30, 0.35, 0.25, 0.55, 0.32, 0.40], np.float32)


def extract_cells(grid_np):
    """Static wall BOXES (x0, x1, y0, y1, type) from a numpy grid.

    Copied from the JAX package (numpy): same-type cells are greedily
    merged into maximal rectangles (horizontal runs, then vertical
    stacking of equal runs).
    """
    g = np.asarray(grid_np).copy()
    boxes = []
    h, w = g.shape
    used = np.zeros_like(g, bool)
    for y in range(h):
        x = 0
        while x < w:
            t = g[y, x]
            if t <= 0 or used[y, x]:
                x += 1
                continue
            # Horizontal run of type t.
            x1 = x
            while x1 + 1 < w and g[y, x1 + 1] == t and not used[y, x1 + 1]:
                x1 += 1
            # Extend downward while the whole run matches.
            y1 = y
            while y1 + 1 < h and np.all(
                (g[y1 + 1, x : x1 + 1] == t)
                & ~used[y1 + 1, x : x1 + 1]
            ):
                y1 += 1
            used[y : y1 + 1, x : x1 + 1] = True
            boxes.append((x, x1 + 1, y, y1 + 1, t))
            x = x1 + 1
    b = np.asarray(boxes, np.float32).reshape(-1, 5)
    return (b[:, 0], b[:, 1], b[:, 2], b[:, 3], b[:, 4])


@functools.lru_cache(maxsize=None)
def _gun(device: torch.device) -> torch.Tensor:
    """``[H, W]`` bool: the weapon's pixels."""
    gx = np.abs(np.arange(W)[None, :] - W / 2)
    gy = np.arange(H)[:, None]
    return torch.as_tensor(((gx < 3) & (gy > H - 14)) | ((gx < 7) & (gy > H - 6)),
                           device=device)


def _tan_half_fov(ref: torch.Tensor) -> torch.Tensor:
    return torch.tan(torch.full((), FOV / 2, dtype=ref.dtype, device=ref.device))


def _rays(px: torch.Tensor, ang: torch.Tensor):
    """Each column's ray angle ``[N, W]`` and direction, with components
    below 1e-6 in magnitude set to 1e-6."""
    cols = (torch.arange(W, dtype=px.dtype, device=px.device) * (1.0 / (W - 1)) - 0.5) * 2.0
    ra = ang[:, None] + torch.atan(cols * _tan_half_fov(px))
    dx, dy = torch.cos(ra), torch.sin(ra)
    dx = torch.where(torch.abs(dx) < 1e-6, 1e-6, dx)
    dy = torch.where(torch.abs(dy) < 1e-6, 1e-6, dy)
    return ra, dx, dy


def cast_rays_cells(cells, px, py, ang):
    """Per-column wall hit by slab tests against the static wall boxes
    ``cells`` (:func:`extract_cells`): → (dist, wtype, side), each
    ``[N, W]`` (perpendicular distance to the entry face, wall type, hit
    side), as the JAX package's closed-form caster."""
    cx0, cx1, cy0, cy1, ct = (torch.as_tensor(c, device=px.device).to(px.dtype)
                              for c in cells)
    ra, dx, dy = _rays(px, ang)
    inv_dx = (1.0 / dx)[..., None]
    inv_dy = (1.0 / dy)[..., None]
    x, y = px[:, None, None], py[:, None, None]
    tx1 = (cx0 - x) * inv_dx                      # [N, W, K]
    tx2 = (cx1 - x) * inv_dx
    ty1 = (cy0 - y) * inv_dy
    ty2 = (cy1 - y) * inv_dy
    txmin = torch.minimum(tx1, tx2)
    txmax = torch.maximum(tx1, tx2)
    tymin = torch.minimum(ty1, ty2)
    tymax = torch.maximum(ty1, ty2)
    tmin = torch.maximum(txmin, tymin)
    tmax = torch.minimum(txmax, tymax)
    ok = (tmax >= tmin) & (tmin > 1e-6)  # ahead of origin; start cell open
    t = torch.where(ok, tmin, torch.inf)
    k = first_argmin(t)[..., None]                # [N, W, 1]
    dist_e = t.min(-1).values
    hit = torch.isfinite(dist_e)
    wtype = torch.where(hit, ct[k[..., 0]], 1.0)
    side = torch.where(txmin > tymin, 0.0, 1.0).gather(-1, k)[..., 0]
    dist = dist_e * torch.cos(ra - ang[:, None])
    dist = torch.where(hit, torch.clamp(dist, min=0.05), 30.0)
    return dist, wtype, side


def cast_rays(walls, px, py, ang):
    """Per-column wall hit by the classic DDA grid traversal over
    ``walls`` (``[g, g]`` wall types), ``_MAX_DDA`` fixed iterations over
    all columns at once: → (dist, wtype, side), each ``[N, W]``."""
    g = walls.shape[0]
    flat = walls.reshape(-1).to(px.dtype)
    ra, dx, dy = _rays(px, ang)
    ddx, ddy = torch.abs(1.0 / dx), torch.abs(1.0 / dy)
    x, y = px[:, None], py[:, None]
    mapx = torch.floor(x).expand_as(dx)
    mapy = torch.floor(y).expand_as(dx)
    stepx = torch.where(dx < 0, -1.0, 1.0)
    stepy = torch.where(dy < 0, -1.0, 1.0)
    sdx = torch.where(dx < 0, (x - mapx) * ddx, (mapx + 1.0 - x) * ddx)
    sdy = torch.where(dy < 0, (y - mapy) * ddy, (mapy + 1.0 - y) * ddy)
    side = torch.zeros_like(dx)
    hit = torch.zeros_like(dx, dtype=torch.bool)
    wtype = torch.ones_like(dx)
    for _ in range(_MAX_DDA):
        go_x = sdx < sdy
        move_x, move_y = go_x & ~hit, ~go_x & ~hit
        mapx = torch.where(move_x, mapx + stepx, mapx)
        mapy = torch.where(move_y, mapy + stepy, mapy)
        sdx = torch.where(move_x, sdx + ddx, sdx)
        sdy = torch.where(move_y, sdy + ddy, sdy)
        side = torch.where(hit, side, torch.where(go_x, 0.0, 1.0))
        ix = torch.clamp(mapx.to(torch.int32), 0, g - 1)
        iy = torch.clamp(mapy.to(torch.int32), 0, g - 1)
        cell = flat[(iy * g + ix).long()]
        wtype = torch.where(hit, wtype, cell)
        hit = hit | (cell > 0)
    # Perpendicular distance (fisheye-corrected by construction).
    dist = torch.where(side == 0, sdx - ddx, sdy - ddy)
    dist = dist * torch.cos(ra - ang[:, None])
    dist = torch.where(hit, torch.clamp(dist, min=0.05), 30.0)
    return dist, wtype, side


def render_frame(walls, px, py, ang, spr_xy, spr_type, spr_alive,
                 flash, hurt, weapon_up: float = 1.0, wall_cells=None):
    """→ ``[N, H, W, 3]`` float frames (0..255) in the dtype of ``px``.

    ``spr_xy [N, S, 2]``, ``spr_type`` (``S`` static ints) and
    ``spr_alive [N, S]`` are the billboard entities; ``flash`` ``[N]`` is
    the muzzle-flash intensity, ``hurt`` ``[N]`` a red damage tint,
    ``weapon_up`` toggles the weapon overlay.  With ``wall_cells``
    (:func:`extract_cells`) the closed-form caster runs, else the DDA over
    ``walls``.
    """
    dt, dev = px.dtype, px.device
    if wall_cells is not None:
        dist, wtype, side = cast_rays_cells(wall_cells, px, py, ang)
    else:
        dist, wtype, side = cast_rays(walls, px, py, ang)

    rows = torch.arange(H, dtype=dt, device=dev)[:, None]     # [H, 1]
    line_h = torch.clamp(H / dist, max=4.0 * H)               # [N, W]
    top = ((H - line_h) / 2.0)[:, None, :]
    bot = ((H + line_h) / 2.0)[:, None, :]
    is_wall = (rows >= top) & (rows < bot)                    # [N, H, W]

    palette = const(_WALL_RGB, dev, dt)
    base = palette[torch.clamp(wtype.to(torch.int32), 0, 5).long()]  # [N, W, 3]
    shade = torch.where(side == 1, 0.72, 1.0) / (1.0 + 0.10 * dist)
    wall_rgb = base * shade[..., None]

    floor_fade = torch.clamp((rows[:, 0] - H / 2) * (1.0 / (H / 2)), 0.0, 1.0)
    floor_rgb = const((70.0, 58.0, 48.0), dev, dt)[None, :] * (0.5 + 0.5 * floor_fade[:, None])
    backdrop = torch.where(rows[..., None] < H / 2, const((52.0, 52.0, 56.0), dev, dt),
                           floor_rgb[:, None, :])             # [H, 1, 3]
    frame = torch.where(is_wall[..., None], wall_rgb[:, None, :, :], backdrop)

    # --- billboard sprites, nearest-first per column ---
    rx = spr_xy[..., 0] - px[:, None]
    ry = spr_xy[..., 1] - py[:, None]
    ca, sa = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    depth = rx * ca + ry * sa                                 # [N, S] fwd
    lat = -rx * sa + ry * ca                                  # [N, S] right
    visible = spr_alive & (depth > 0.15)
    depth_s = torch.clamp(depth, min=0.15)
    tan_h = _tan_half_fov(px)
    sx = (lat / (depth_s * tan_h)) * (W / 2) + W / 2
    kinds = tuple(int(t) for t in spr_type)
    rad = const(tuple(float(SPR_RADIUS[t]) for t in kinds), dev, dt)
    hgt = const(tuple(float(SPR_HEIGHT[t]) for t in kinds), dev, dt)
    body = const(tuple(tuple(map(float, SPR_RGB[t])) for t in kinds), dev, dt)  # [S, 3]
    half_w = (rad / depth_s) * (W / 2) * (1.0 / tan_h)
    spr_h = (hgt / depth_s) * H
    foot = H / 2 + (H / 2) / depth_s * 0.5                    # floor line
    s_top = foot - spr_h
    cols = torch.arange(W, dtype=dt, device=dev)
    in_x = ((torch.abs(cols - sx[..., None]) < half_w[..., None])
            & visible[..., None]
            & (depth_s[..., None] < dist[:, None, :]))        # [N, S, W]
    col_d = torch.where(in_x, depth_s[..., None], 1e9).transpose(1, 2)  # [N, W, S]
    # The first nearest covering sprite of each column (JAX's strict-<
    # tournament over the sprites in order).
    best = first_argmin(col_d)[..., None]                      # [N, W, 1]
    has = col_d.gather(-1, best)[..., 0] < 1e9
    top_c = s_top.gather(1, best[..., 0])
    foot_c = foot.gather(1, best[..., 0])
    spr_rgb = body / (1.0 + 0.08 * depth_s[..., None])         # [N, S, 3]
    rgb_c = spr_rgb.gather(1, best.expand(-1, -1, 3))          # [N, W, 3]
    pix = (has[:, None, :] & (rows >= top_c[:, None, :])
           & (rows <= foot_c[:, None, :]))                      # [N, H, W]
    frame = torch.where(pix[..., None], rgb_c[:, None, :, :], frame)

    # --- weapon overlay + muzzle flash + hurt tint ---
    if weapon_up > 0.5:
        frame = torch.where(_gun(dev)[..., None], const((90.0, 90.0, 100.0), dev, dt), frame)
    gx = cols[None, :] - W / 2
    gy = rows - (H - 16.0)
    r = (6.0 + 4 * flash)[:, None, None]
    fl = (gx * gx + gy * gy < r * r) & (flash > 0.05)[:, None, None]
    frame = torch.where(fl[..., None], const((255.0, 230.0, 120.0), dev, dt), frame)
    frame = frame + hurt[:, None, None, None] * const((80.0, -30.0, -30.0), dev, dt)
    return torch.clamp(frame, 0.0, 255.0)
