"""Doom WAD geometry → occupancy grid (host-side, at make() time).

The reference runs real scenario WADs through the Doom engine
(``envpool/vizdoom/vizdoom_env.h:60-110``, cfg/wad pairs in
``vizdoom/registration.py:24-50``).  This image ships no WAD assets, so
the family defaults to the hand-authored layouts in ``scenarios.py`` —
but when a user provides a scenario WAD (``wad_path`` make-kwarg), this
module parses its map geometry (VERTEXES + LINEDEFS lumps, the
documented id-Software WAD format) and rasterizes the blocking lines
into the occupancy grid the DDA raycaster consumes, so the world
layout comes from the actual scenario file.

Format summary (doomwiki.org/wiki/WAD):
  header:    4s magic ("IWAD"/"PWAD"), int32 numlumps, int32 dirofs
  directory: numlumps × (int32 ofs, int32 size, 8s name)
  VERTEXES:  int16 x, int16 y per vertex
  LINEDEFS:  int16 v1, v2, flags, special, tag, sidefront, sideback
             (14 bytes; sideback == -1/0xFFFF → one-sided = solid wall)

Copied from ``envpool_tpu/envs/vizdoom/wad.py`` (``struct`` and numpy),
so that ``wad_path`` works as in the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np

_ML_BLOCKING = 0x0001

__all__ = ["parse_wad_map", "wad_to_grid"]


def parse_wad_map(path: str, map_name: str | None = None):
    """Read (vertices [N,2] int, blocking-lines [M,2,2]) from a WAD.

    ``map_name`` selects a map marker lump (e.g. ``"MAP01"``/``"E1M1"``);
    by default the first map in the file is used.
    """
    with open(path, "rb") as f:
        data = f.read()
    magic, numlumps, dirofs = struct.unpack_from("<4sii", data, 0)
    if magic not in (b"IWAD", b"PWAD"):
        raise ValueError(f"{path}: not a WAD file (magic {magic!r})")
    lumps = []
    for i in range(numlumps):
        ofs, size, raw = struct.unpack_from("<ii8s", data, dirofs + 16 * i)
        name = raw.rstrip(b"\x00").decode("ascii", "replace")
        lumps.append((name, ofs, size))

    # Locate the map marker, then its VERTEXES/LINEDEFS lumps (they
    # immediately follow the marker in the directory).
    start = None
    for i, (name, _, size) in enumerate(lumps):
        is_marker = size == 0 and (
            name.startswith(("MAP", "E")) if map_name is None
            else name == map_name
        )
        if is_marker:
            start = i
            break
    if start is None:
        raise ValueError(f"{path}: no map marker found ({map_name=})")

    map_lumps = {
        "THINGS", "LINEDEFS", "SIDEDEFS", "VERTEXES", "SEGS", "SSECTORS",
        "NODES", "SECTORS", "REJECT", "BLOCKMAP", "BEHAVIOR", "SCRIPTS",
    }
    verts = lines = None
    for name, ofs, size in lumps[start + 1 : start + 13]:
        if name not in map_lumps:
            break  # next map marker / unrelated lump
        if name == "VERTEXES":
            n = size // 4
            verts = np.frombuffer(
                data, "<i2", 2 * n, ofs
            ).reshape(n, 2).astype(np.int32)
        elif name == "LINEDEFS":
            n = size // 14
            raw = np.frombuffer(data, "<i2", 7 * n, ofs).reshape(n, 7)
            lines = raw.astype(np.int32)
    if verts is None or lines is None:
        raise ValueError(f"{path}: map has no VERTEXES/LINEDEFS")

    v1, v2 = lines[:, 0], lines[:, 1]
    flags = lines[:, 2] & 0xFFFF
    sideback = lines[:, 6]
    solid = ((flags & _ML_BLOCKING) != 0) | (sideback == -1)
    segs = np.stack([verts[v1], verts[v2]], axis=1)  # [M, 2, 2]
    return verts, segs[solid]


def wad_to_grid(
    path: str,
    g: int = 24,
    wall_type: int = 2,
    map_name: str | None = None,
) -> np.ndarray:
    """Rasterize a WAD map's blocking lines into a [g, g] uint8 grid.

    The map's bounding box is scaled to the grid (1-cell wall border);
    cells crossed by any blocking linedef become ``wall_type``.
    """
    verts, segs = parse_wad_map(path, map_name)
    grid = np.full((g, g), wall_type, np.uint8)
    if len(segs) == 0:
        grid[1:-1, 1:-1] = 0
        return grid
    lo = verts.min(axis=0).astype(np.float64)
    hi = verts.max(axis=0).astype(np.float64)
    span = np.maximum(hi - lo, 1.0)
    inner = g - 2  # border ring stays wall

    def to_cell(p):
        q = (p - lo) / span * (inner - 1e-6)
        return q + 1.0  # border offset

    grid[1:-1, 1:-1] = 0
    for seg in segs:
        a = to_cell(seg[0].astype(np.float64))
        b = to_cell(seg[1].astype(np.float64))
        # Supercover march along the segment at sub-cell resolution.
        steps = int(np.ceil(np.abs(b - a).max() * 4)) + 1
        for t in np.linspace(0.0, 1.0, steps):
            p = a + (b - a) * t
            x = min(max(int(p[0]), 0), g - 1)
            y = min(max(int(p[1]), 0), g - 1)
            grid[y, x] = wall_type
    return grid
