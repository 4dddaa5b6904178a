"""Shared procgen machinery, batched over ``[N]`` envs: action decoding,
the host maze bank, grid upsampling and disc drawing.

Counterpart of ``envpool_tpu/envs/procgen/core.py``.  The maze bank is the
same numpy generator with the same seeds (``_np_maze`` and ``maze_bank``
are copied), so the port's mazes equal JAX's bit for bit.  The JAX
package's ``gen_maze`` (an on-device DFS) is used by no game and is not
ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...ops.batched import const

RES = 64  # procgen native resolution
N_ACTIONS = 15
BANK_SIZE = 512


def decode_action(a: torch.Tensor):
    """``[N]`` action ids → ``(dx, dy, special)`` int32, dy > 0 = up,
    special 1 = fire/jump.  Procgen's 15-action combo set: ids 0..8 are
    (left/none/right) x (down/none/up), 9..14 the specials 1..6 (the JAX
    package's ``_AX``/``_AY``/``_SPECIAL`` tables, as arithmetic)."""
    a = torch.clamp(a.to(torch.int32), 0, N_ACTIONS - 1)
    pad = a < 9
    dx = torch.where(pad, a // 3 - 1, 0).to(torch.int32)
    dy = torch.where(pad, a % 3 - 1, 0).to(torch.int32)
    return dx, dy, torch.clamp(a - 8, min=0).to(torch.int32)


def gather_cell(grid: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``grid[i, r[i], c[i]]`` of an ``[N, n, m]`` grid."""
    n, m = grid.shape[1], grid.shape[2]
    flat = (r.long() * m + c.long())[:, None]
    return grid.reshape(grid.shape[0], n * m).gather(1, flat)[:, 0]


def set_cell(grid: torch.Tensor, r: torch.Tensor, c: torch.Tensor, value) -> torch.Tensor:
    """A copy of ``[N, n, m]`` ``grid`` with ``grid[i, r[i], c[i]] = value``."""
    n, m = grid.shape[1], grid.shape[2]
    flat = (r.long() * m + c.long())[:, None]
    return grid.reshape(grid.shape[0], n * m).scatter(1, flat, value).reshape(grid.shape)


def paint_cell(cells: torch.Tensor, r: torch.Tensor, c: torch.Tensor, rgb) -> None:
    """``cells[i, r[i], c[i]] = rgb`` (``[3]`` or ``[N, 3]``) in place, on
    ``[N, n, m, 3]`` float cells."""
    N, n, m, _ = cells.shape
    flat = (r.long() * m + c.long())[:, None, None].expand(N, 1, 3)
    val = rgb if isinstance(rgb, torch.Tensor) else const(tuple(rgb), cells.device)
    cells.view(N, n * m, 3).scatter_(1, flat, val.reshape(-1, 1, 3).expand(N, 1, 3))


# -- the host maze bank (copied from the JAX package, numpy) ----------------


def _np_maze(rng, n: int, extra_open: float):
    """Host-side recursive backtracker (same topology as ``gen_maze``)."""
    m = n // 2
    walls = np.ones((n, n), bool)
    visited = np.zeros((m, m), bool)
    stack = [(0, 0)]
    visited[0, 0] = True
    walls[1, 1] = False
    while stack:
        ci, cj = stack[-1]
        nbrs = []
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ni, nj = ci + di, cj + dj
            if 0 <= ni < m and 0 <= nj < m and not visited[ni, nj]:
                nbrs.append((ni, nj))
        if not nbrs:
            stack.pop()
            continue
        ni, nj = nbrs[rng.integers(len(nbrs))]
        visited[ni, nj] = True
        y0, x0 = 1 + 2 * ci, 1 + 2 * cj
        y1, x1 = 1 + 2 * ni, 1 + 2 * nj
        walls[(y0 + y1) // 2, (x0 + x1) // 2] = False
        walls[y1, x1] = False
        stack.append((ni, nj))
    if extra_open > 0:
        for y in range(1, n - 1):
            for x in range(1, n - 1):
                if (
                    walls[y, x]
                    and ((y % 2 == 1) != (x % 2 == 1))
                    and rng.random() < extra_open
                ):
                    # knock only walls between two open cells
                    if y % 2 == 1 and not walls[y, x - 1] and not walls[
                        y, x + 1
                    ]:
                        walls[y, x] = False
                    elif x % 2 == 1 and not walls[y - 1, x] and not walls[
                        y + 1, x
                    ]:
                        walls[y, x] = False
    return walls


@functools.lru_cache(maxsize=None)
def _bank(n: int, extra_open: float) -> np.ndarray:
    rng = np.random.default_rng(0x9E3779B9 ^ (n * 1000 + int(
        extra_open * 100
    )))
    bank = np.stack([_np_maze(rng, n, extra_open) for _ in range(BANK_SIZE)])
    bank.flags.writeable = False
    return bank


def maze_bank(n: int, extra_open: float = 0.0) -> np.ndarray:
    """``[BANK_SIZE, n, n]`` bool maze layouts (read-only numpy).

    A reset gathers one layout per env (the engine runs every row's reset
    branch on every step, so an on-device DFS per env per step would
    dominate the step); entity and goal placement stay random per level.
    """
    return _bank(n, round(float(extra_open), 3))


# -- rendering -------------------------------------------------------------


def render_grid(cells: torch.Tensor, res: int = RES) -> torch.Tensor:
    """``[N, n, n, 3]`` float cell colours → ``[N, res, res, 3]`` uint8
    (nearest upsample; exact, as JAX's one-hot products are)."""
    n = cells.shape[1]
    idx = const(tuple(np.arange(res) * n // res), cells.device, torch.int64)
    img = cells.index_select(1, idx).index_select(2, idx)
    return torch.clamp(img, 0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _stamp(r: float, device: torch.device):
    """Row and column offsets of the pixels within ``r`` of a centre."""
    R = int(np.ceil(r))
    dy, dx = np.mgrid[-R:R + 1, -R:R + 1]
    inside = (dy * dy + dx * dx) <= r * r
    return (torch.as_tensor(dy[inside], device=device),
            torch.as_tensor(dx[inside], device=device))


class Canvas:
    """A batch of ``[N, RES, RES, 3]`` float32 canvases, y down the rows.

    The storage holds one spare pixel after the last canvas: a stamp sends
    the pixels that JAX's ``mode="drop"`` scatter drops there, so a stamp is
    one ``index_put_`` with no host synchronisation.
    """

    def __init__(self, n: int, rgb: tuple, device: torch.device):
        self.n = n
        self.buf = const(tuple(rgb), device).expand(n * RES * RES + 1, 3).clone()
        self.img = self.buf[:-1].view(n, RES, RES, 3)

    def disc(self, x, y, r, rgb, cond=None) -> None:
        """Draw ``[N]`` discs at (``x``, ``y``) of radius ``r`` in colour
        ``rgb`` (``[3]`` or ``[N, 3]``), where ``cond`` (``[N]`` bool).

        As JAX's ``draw_disc``: a Python radius up to 6 stamps the pixels
        within ``r`` of ``(round(y), round(x))`` (negative indices wrap
        once, as JAX normalises them; the rest out of bounds are dropped);
        a tensor radius paints the pixels whose centres lie within ``r``.
        """
        dev = self.buf.device
        if not isinstance(rgb, torch.Tensor):
            rgb = const(tuple(rgb), dev)
        if isinstance(r, (int, float)) and r <= 6:
            oy, ox = _stamp(float(r), dev)
            yi = torch.round(y).long()[:, None] + oy
            xi = torch.round(x).long()[:, None] + ox
            if cond is not None:
                yi = torch.where(cond[:, None], yi, RES)
            yi = torch.where(yi < 0, yi + RES, yi)
            xi = torch.where(xi < 0, xi + RES, xi)
            ok = (yi >= 0) & (yi < RES) & (xi >= 0) & (xi < RES)
            base = torch.arange(self.n, device=dev)[:, None] * (RES * RES)
            flat = torch.where(ok, base + yi * RES + xi, self.n * RES * RES)
            val = rgb.reshape(-1, 1, 3).expand(self.n, flat.shape[1], 3)
            self.buf.index_put_((flat.reshape(-1),), val.reshape(-1, 3))
            return
        rows = torch.arange(RES, dtype=y.dtype, device=dev)[:, None]
        cols = torch.arange(RES, dtype=x.dtype, device=dev)[None, :]
        ry, rx = rows - y[:, None, None], cols - x[:, None, None]
        rr = r * r if isinstance(r, (int, float)) else (r * r)[:, None, None]
        mask = ry * ry + rx * rx <= rr
        if cond is not None:
            mask = mask & cond[:, None, None]
        self.img[:] = torch.where(mask[..., None], rgb.reshape(-1, 1, 1, 3), self.img)

    def frame(self) -> torch.Tensor:
        """The canvases as ``[N, RES, RES, 3]`` uint8."""
        return torch.clamp(self.img, 0, 255).to(torch.uint8)
