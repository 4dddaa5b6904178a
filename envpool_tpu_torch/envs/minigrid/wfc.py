"""Wave-function-collapse mazes (MiniGrid-WFC-*-v0), batched over ``[N]``
envs.

Counterpart of ``envpool_tpu/envs/minigrid/wfc.py`` (behavioural reference
``envpool/minigrid/impl/minigrid_wfc_tasks.cc``).  The WFC solve runs in
numpy at a pool's first reset (once per process and preset) and yields a
bank of ``bank_size`` maps; a reset picks a map and random goal and agent
cells.  The presets
and the numpy solver (``_patterns`` to ``_map_bank``) are copied from the
JAX package with its seed, so the port's banks equal JAX's bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import core as mg
from .minigrid_env import MiniGridEnv

# 1 = wall, 0 = floor.  Each preset is a small seed bitmap whose 2x2
# overlapping patterns define the texture WFC reproduces.
_PRESETS = {
    # Thin-wall maze with wide, connected corridors.
    "MazeSimple": [
        "11111111",
        "10000001",
        "10111101",
        "10100001",
        "10101111",
        "10100001",
        "10111101",
        "10000001",
    ],
    # Chunky rooms joined by 2-wide corridors.
    "DungeonMazeScaled": [
        "0000110000",
        "0000110000",
        "0000000000",
        "0000000000",
        "1100001100",
        "1100001100",
        "0000000000",
        "0000000000",
        "0000110000",
        "0000110000",
    ],
    # Fabric of rooms: wall lattice with door gaps in every segment.
    "RoomsFabric": [
        "10111011",
        "00000000",
        "10111011",
        "10111011",
        "00000000",
        "10111011",
    ],
    "ObstaclesBlackdots": [
        "00000000",
        "01000100",
        "00000000",
        "00010001",
        "00000000",
        "01000100",
        "00000000",
        "00010001",
    ],
    "ObstaclesAngular": [
        "000000000",
        "011000000",
        "001100000",
        "000000110",
        "000001100",
        "000000000",
        "011000000",
        "001100000",
    ],
    "ObstaclesHogs3": [
        "0000000000",
        "0110000110",
        "0110000110",
        "0000000000",
        "0000110000",
        "0000110000",
        "0000000000",
    ],
}

_PW = 2  # pattern width


def _patterns(bitmap: np.ndarray):
    """All 2x2 overlapping patterns (with rotations/reflections) + counts."""
    pats: dict[tuple, int] = {}
    variants = []
    b = bitmap
    for _ in range(4):
        variants.append(b)
        variants.append(b[:, ::-1])
        b = np.rot90(b)
    for v in variants:
        h, w = v.shape
        for y in range(h - _PW + 1):
            for x in range(w - _PW + 1):
                p = tuple(v[y : y + _PW, x : x + _PW].flatten())
                pats[p] = pats.get(p, 0) + 1
    plist = list(pats)
    weights = np.asarray([pats[p] for p in plist], np.float64)
    return np.asarray(plist, np.int8).reshape(-1, _PW, _PW), weights


def _compatible(pats):
    """adj[d, i, j]: pattern j may sit at offset d from pattern i.

    Two overlapping patterns agree iff every lattice pixel they share is
    equal: ``i[y, x] == j[y - dy, x - dx]`` for in-range coords.
    """
    n = len(pats)
    dirs = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    adj = np.zeros((4, n, n), bool)
    for d, (dy, dx) in enumerate(dirs):
        for i in range(n):
            for j in range(n):
                ok = True
                for y in range(_PW):
                    for x in range(_PW):
                        yy, xx = y - dy, x - dx
                        if 0 <= yy < _PW and 0 <= xx < _PW:
                            if pats[i][y, x] != pats[j][yy, xx]:
                                ok = False
                adj[d, i, j] = ok
    return adj, dirs


def _wfc_solve(pats, weights, adj, dirs, h, w, rng, max_restarts=32):
    """Min-entropy WFC over an h x w pattern lattice; returns bitmap."""
    n = len(pats)
    for _ in range(max_restarts):
        possible = np.ones((h, w, n), bool)
        ok = True
        for _step in range(h * w):
            counts = possible.sum(-1)
            if (counts == 0).any():
                ok = False
                break
            open_cells = counts > 1
            if not open_cells.any():
                break
            # Min-entropy cell.
            masked = np.where(open_cells, counts, np.iinfo(np.int32).max)
            y, x = np.unravel_index(np.argmin(masked), masked.shape)
            opts = np.flatnonzero(possible[y, x])
            wsel = weights[opts] / weights[opts].sum()
            choice = rng.choice(opts, p=wsel)
            possible[y, x] = False
            possible[y, x, choice] = True
            # Propagate.
            stack = [(y, x)]
            while stack:
                cy, cx = stack.pop()
                for d, (dy, dx) in enumerate(dirs):
                    ny, nx = cy + dy, cx + dx
                    if not (0 <= ny < h and 0 <= nx < w):
                        continue
                    allowed = adj[d][possible[cy, cx]].any(0)
                    new = possible[ny, nx] & allowed
                    if not new.any():
                        ok = False
                        stack = []
                        break
                    if (new != possible[ny, nx]).any():
                        possible[ny, nx] = new
                        stack.append((ny, nx))
                if not ok:
                    break
            if not ok:
                break
        if not ok:
            continue
        idx = possible.argmax(-1)
        return pats[idx][:, :, 0, 0]  # top-left pixel of each pattern
    return None


def _connected_floor(bitmap):
    """Largest floor component only; True if any floor exists."""
    from collections import deque

    h, w = bitmap.shape
    seen = np.zeros_like(bitmap, bool)
    best = None
    for y in range(h):
        for x in range(w):
            if bitmap[y, x] == 0 and not seen[y, x]:
                comp = []
                dq = deque([(y, x)])
                seen[y, x] = True
                while dq:
                    cy, cx = dq.popleft()
                    comp.append((cy, cx))
                    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                        ny, nx = cy + dy, cx + dx
                        if (
                            0 <= ny < h
                            and 0 <= nx < w
                            and bitmap[ny, nx] == 0
                            and not seen[ny, nx]
                        ):
                            seen[ny, nx] = True
                            dq.append((ny, nx))
                if best is None or len(comp) > len(best):
                    best = comp
    if not best or len(best) < (h * w) // 8:
        return None
    keep = np.ones_like(bitmap)
    for y, x in best:
        keep[y, x] = 0
    return keep


def _tile_fallback(bitmap, inner, rng):
    """Fallback map: random-offset tiling of the seed bitmap."""
    h, w = bitmap.shape
    oy, ox = rng.integers(h), rng.integers(w)
    reps = (inner // h + 2, inner // w + 2)
    big = np.tile(bitmap, reps)
    return big[oy : oy + inner, ox : ox + inner].copy()


@functools.lru_cache(maxsize=16)
def _map_bank(preset: str, size: int, bank: int, seed: int = 7):
    rows = _PRESETS[preset]
    bitmap = np.asarray(
        [[int(ch) for ch in row] for row in rows], np.int8
    )
    pats, weights = _patterns(bitmap)
    adj, dirs = _compatible(pats)
    rng = np.random.default_rng(seed)
    inner = size - 2
    maps = []
    attempts = 0
    while len(maps) < bank:
        attempts += 1
        if attempts > 3 * bank:
            m = _tile_fallback(bitmap, inner, rng)
        else:
            m = _wfc_solve(pats, weights, adj, dirs, inner, inner, rng,
                           max_restarts=4)
            if m is None:
                continue
        m2 = _connected_floor(m)
        if m2 is None:
            continue
        # Quality gate: enough walkable area for goal-reaching episodes
        # (relaxed after repeated rejections so the bank always fills).
        min_floor = 0.25 if attempts <= 6 * bank else 0.0
        if (m2 == 0).mean() < min_floor or (m2 == 0).sum() < 20:
            continue
        full = np.ones((size, size), np.int8)
        full[1:-1, 1:-1] = m2
        maps.append(full)
    return np.stack(maps)  # [bank, size, size] 1=wall


class WFCEnv(MiniGridEnv):
    """MiniGrid-WFC-* — goal-reaching in WFC-generated mazes."""

    DEFAULT_CONFIG = dict(MiniGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update(
        {"wfc_preset": "MazeSimple", "bank_size": 32, "size": 25}
    )

    @functools.cached_property
    def _maps(self) -> torch.Tensor:
        """The bank as ``[bank, size, size, 3]`` cells on the device (walls
        GREY, floor EMPTY), built at the pool's first reset."""
        m = torch.as_tensor(self._bank(), device=self.device) == 1
        return torch.stack([
            torch.where(m, mg.WALL, mg.EMPTY), torch.where(m, mg.GREY, 0),
            torch.zeros_like(m, dtype=torch.int64)], -1).to(torch.int8)

    def _bank(self) -> np.ndarray:
        return _map_bank(
            str(self.config["wfc_preset"]),
            int(self.config["size"]),
            int(self.config["bank_size"]),
        )

    def plan_reset(self, d):
        size = int(self.config["size"])
        d.randint("map", 0, int(self.config["bank_size"]))
        d.cells("goal", size * size)
        d.cells("agent", size * size)
        d.randint("dir", 0, 4)

    def _gen(self, dr):
        grid = self._maps[dr["map"].long()]
        gx, gy = mg.place_random(dr["goal"], grid)
        mg.put(grid, gx, gy, mg.cell((mg.GOAL, mg.GREEN, 0), grid.device))
        ax, ay = mg.place_random(dr["agent"], grid)
        return grid, torch.stack([ax, ay], 1), dr["dir"]
