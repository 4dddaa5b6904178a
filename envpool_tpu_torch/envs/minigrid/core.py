"""MiniGrid core mechanics, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/minigrid/core.py`` (behavioural
reference ``envpool/minigrid/impl/minigrid_core.cc``).  World state is an
int8 ``[N, H, W, 3]`` grid of (object, color, state) plus the agent's pose;
the encodings are MiniGrid's.  The 7x7 egocentric view casts MiniGrid's
shadows row by row through a table (:func:`shadow_table`), which gives
exactly the JAX package's unrolled sweeps.

Randomness comes in as tensors drawn beforehand, in the order the JAX env
draws (:class:`Draws`).  A cell pick is JAX's ``categorical``: the first
argmax of per-cell noise plus the logits (``0`` on allowed cells, ``-inf``
or ``-1e9`` elsewhere).  The port's noise is uniform in ``[0, 1)``, made of
integer bits, so the card and the CPU pick alike; a test can hand in JAX's
Gumbel noise instead and gets JAX's pick.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core import rng
from ...core.rng import Draws  # noqa: F401  (the families' shared draw layout)
from ...ops.batched import const, first_argmax

# OBJECT_TO_IDX
UNSEEN, EMPTY, WALL, FLOOR, DOOR, KEY, BALL, BOX, GOAL, LAVA, AGENT = range(11)
# Door states.
OPEN, CLOSED, LOCKED = 0, 1, 2
# Colors.
RED, GREEN, BLUE, PURPLE, YELLOW, GREY = range(6)
# Actions.
LEFT, RIGHT, FORWARD, PICKUP, DROP, TOGGLE, DONE = range(7)

# DIR_TO_VEC: 0 → +x (right), 1 → +y (down), 2 → -x, 3 → -y.
DIR_VEC = ((1, 0), (0, 1), (-1, 0), (0, -1))

WALL_CELL = (WALL, GREY, 0)
EMPTY_CELL = (EMPTY, 0, 0)


def empty_grid(width: int, height: int) -> np.ndarray:
    """Walled-border grid of empty cells: ``[H, W, 3]`` int8 (numpy)."""
    grid = np.zeros((height, width, 3), np.int8)
    grid[:, :, 0] = EMPTY
    grid[0, :, 0] = WALL
    grid[-1, :, 0] = WALL
    grid[:, 0, 0] = WALL
    grid[:, -1, 0] = WALL
    grid[grid[:, :, 0] == WALL, 1] = GREY
    return grid


def batch(grid: np.ndarray, n: int, device) -> torch.Tensor:
    """``n`` copies of a host ``[H, W, 3]`` grid on ``device``."""
    base = torch.as_tensor(grid, dtype=torch.int8).to(device)
    return base.expand(n, *base.shape).clone()


def cell(values, device) -> torch.Tensor:
    """A constant int8 ``[3]`` cell on ``device``."""
    return const(tuple(int(v) for v in values), device, torch.int8)


def rows(grid: torch.Tensor) -> torch.Tensor:
    return torch.arange(grid.shape[0], device=grid.device)


def get(grid: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[N, 3]``: ``grid[i, y[i], x[i]]``."""
    return grid[rows(grid), y.long(), x.long()]


def put(grid: torch.Tensor, x, y, value, where: torch.Tensor | None = None) -> None:
    """``grid[i, y[i], x[i]] = value`` in place (``value`` ``[3]`` or
    ``[N, 3]``, or ``[N]`` for a ``[N, H, W]`` grid), only where ``where``
    holds when given.  ``x`` and ``y`` are ints or ``[N]`` tensors."""
    r = rows(grid)
    x = torch.as_tensor(x, device=grid.device).long()
    y = torch.as_tensor(y, device=grid.device).long()
    if where is not None:
        old = grid[r, y, x]
        cond = where.reshape(-1, *([1] * (old.ndim - 1)))
        value = torch.where(cond, value, old)
    grid[r, y, x] = value.to(grid.dtype) if isinstance(value, torch.Tensor) else value


def paint(grid: torch.Tensor, mask: torch.Tensor, values) -> torch.Tensor:
    """``where(mask[..., None], cell, grid)``; ``mask`` ``[H, W]`` or
    ``[N, H, W]``."""
    return torch.where(mask[..., None], cell(values, grid.device), grid)


def stack_cell(obj, color, state=0) -> torch.Tensor:
    """``[N, 3]`` int8 cells from ``[N]`` tensors or ints (one at least a
    tensor)."""
    parts = [obj, color, state]
    n = next(p.shape[0] for p in parts if isinstance(p, torch.Tensor))
    dev = next(p.device for p in parts if isinstance(p, torch.Tensor))
    return torch.stack([
        p.to(torch.int8) if isinstance(p, torch.Tensor)
        else torch.full((n,), int(p), dtype=torch.int8, device=dev) for p in parts], 1)


def iota2(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rows, cols)`` int32 ``[H, W]`` index grids."""
    r = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    c = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    return r, c


def pick(noise: torch.Tensor, allowed: torch.Tensor, masked: float = float("-inf")) -> torch.Tensor:
    """``jax.random.categorical`` as JAX computes it: the first argmax of
    ``noise + logits`` (``logits`` 0 where ``allowed``, ``masked``
    elsewhere) over the last axis."""
    logits = torch.where(allowed, 0.0, masked).to(torch.float32)
    return first_argmax(noise + logits)


def place_random(noise: torch.Tensor, grid: torch.Tensor, forbid: torch.Tensor | None = None):
    """A uniform free (EMPTY) cell, not in ``forbid`` (``[H, W]`` or
    ``[N, H, W]`` bool): ``(x, y)`` int32 ``[N]``."""
    n, _, w = grid.shape[:3]
    free = grid[..., 0] == EMPTY
    if forbid is not None:
        free = free & ~forbid
    idx = pick(noise, free.reshape(n, -1))
    return (idx % w).to(torch.int32), (idx // w).to(torch.int32)


def can_enter(c: torch.Tensor) -> torch.Tensor:
    obj, state = c[..., 0], c[..., 2]
    return ((obj == EMPTY) | (obj == FLOOR) | (obj == GOAL) | (obj == LAVA)
            | ((obj == DOOR) & (state == OPEN)))


def see_behind(obj: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    return ~((obj == WALL) | ((obj == DOOR) & (state != OPEN)))


def front(pos: torch.Tensor, d: torch.Tensor, w: int, h: int):
    """The clipped cell in front of the agent: ``(fx, fy)`` int32 ``[N]``."""
    fwd = pos + const(DIR_VEC, pos.device, torch.int32)[d.long()]
    return fwd[:, 0].clamp(0, w - 1), fwd[:, 1].clamp(0, h - 1)


def step_agent(grid, pos, d, carrying, action):
    """One MiniGrid action for every row; returns ``(grid, pos, dir,
    carrying, reached_goal, stepped_lava)``, the grid a new tensor.  The
    front cell takes pickup, drop, door toggle and box toggle one after
    another, as in the JAX package."""
    h, w = grid.shape[1], grid.shape[2]
    action = action.to(torch.int32)
    fx, fy = front(pos, d, w, h)
    fc = get(grid, fx, fy)
    new_dir = torch.where(action == LEFT, torch.remainder(d - 1, 4),
                          torch.where(action == RIGHT, torch.remainder(d + 1, 4), d))

    move = (action == FORWARD) & can_enter(fc)
    new_pos = torch.where(move[:, None], torch.stack([fx, fy], 1), pos)
    reached_goal = move & (fc[:, 0] == GOAL)
    stepped_lava = move & (fc[:, 0] == LAVA)

    obj = fc[:, 0]
    cur = fc
    do_pick = ((action == PICKUP) & ((obj == KEY) | (obj == BALL) | (obj == BOX))
               & (carrying[:, 0] == EMPTY))
    new_carrying = torch.where(do_pick[:, None], fc[:, :2], carrying)
    cur = torch.where(do_pick[:, None], cell(EMPTY_CELL, grid.device), cur)

    do_drop = (action == DROP) & (carrying[:, 0] != EMPTY) & (obj == EMPTY)
    dropped = torch.cat([carrying, torch.zeros_like(carrying[:, :1])], 1)
    cur = torch.where(do_drop[:, None], dropped, cur)
    new_carrying = torch.where(do_drop[:, None], const((EMPTY, 0), grid.device, torch.int8),
                               new_carrying)

    door_state = fc[:, 2]
    has_key = (carrying[:, 0] == KEY) & (carrying[:, 1] == fc[:, 1])
    opens = (door_state == CLOSED) | ((door_state == LOCKED) & has_key)
    closes = door_state == OPEN
    new_door_state = torch.where(opens, OPEN, torch.where(closes, CLOSED, door_state))
    do_toggle = (action == TOGGLE) & (obj == DOOR)
    cur = torch.cat([cur[:, :2], torch.where(do_toggle, new_door_state, cur[:, 2])[:, None]],
                    1).to(torch.int8)

    # A box toggled turns into its contents, ``1 + type*8 + color`` in the
    # state channel (0 = empty box).
    do_box = (action == TOGGLE) & (obj == BOX)
    enc = fc[:, 2].to(torch.int32)
    revealed = torch.where(
        (enc > 0)[:, None],
        torch.stack([torch.div(enc - 1, 8, rounding_mode="floor"), torch.remainder(enc - 1, 8),
                     torch.zeros_like(enc)], 1).to(torch.int8),
        cell(EMPTY_CELL, grid.device))
    cur = torch.where(do_box[:, None], revealed, cur)

    grid = grid.clone()
    put(grid, fx, fy, cur)
    return grid, new_pos, new_dir, new_carrying, reached_goal, stepped_lava


def box_contents(obj_type, color):
    """State-channel encoding of an object hidden inside a box."""
    return 1 + obj_type * 8 + color


@functools.lru_cache(maxsize=None)
def shadow_table(view: int) -> np.ndarray:
    """MiniGrid's shadow sweeps over one view row, for every input.

    Index ``m | s << view``: ``m`` the row's visibility bits before its
    sweeps (bit ``i`` is column ``i``), ``s`` its see-through bits.  Value
    ``row | up << view``: the row's bits after the left-to-right and
    right-to-left sweeps of ``Grid.process_vis`` (the JAX package's
    ``egocentric_view`` loops, run here over every input at once), and the
    bits they spill into the row above."""
    idx = np.arange(1 << (2 * view), dtype=np.int64)
    bit = 1 << np.arange(view)
    row = (idx[:, None] & bit) != 0
    seeb = ((idx[:, None] >> view) & bit) != 0
    up = np.zeros_like(row)
    for i in range(0, view - 1):
        prop = row[:, i] & seeb[:, i]
        row[:, i + 1] |= prop
        up[:, i + 1] |= prop
        up[:, i] |= prop
    for i in range(view - 1, 0, -1):
        prop = row[:, i] & seeb[:, i]
        row[:, i - 1] |= prop
        up[:, i - 1] |= prop
        up[:, i] |= prop
    return (row @ bit) | ((up @ bit) << view)


@functools.lru_cache(maxsize=None)
def _shadow(view: int, device) -> torch.Tensor:
    return torch.as_tensor(shadow_table(view), device=device)


@functools.lru_cache(maxsize=None)
def _view_offsets(view: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(forward, right)`` int32 ``[view, view]`` offsets of the view's
    cells (row ``j``, column ``i``) from the agent."""
    vj, vi = iota2(view, view, device)
    return (view - 1) - vj, vi - view // 2


def egocentric_view(grid, pos, d, carrying, view: int = 7) -> torch.Tensor:
    """MiniGrid ``gen_obs``: the rotated partial view with its shadows,
    ``[N, view, view, 3]`` uint8 in MiniGrid's ``[x, y, 3]`` layout.

    The agent sits at ``(view // 2, view - 1)`` facing up; cells outside
    the grid are walls; cells out of sight are zeros."""
    n, h, w = grid.shape[:3]
    dev = grid.device
    half = view // 2
    f, r = _view_offsets(view, dev)
    dirs = const(DIR_VEC, dev, torch.int32)
    fvec = dirs[d.long()][:, :, None, None]
    rvec = dirs[torch.remainder(d + 1, 4).long()][:, :, None, None]
    wx = pos[:, 0, None, None] + f * fvec[:, 0] + r * rvec[:, 0]
    wy = pos[:, 1, None, None] + f * fvec[:, 1] + r * rvec[:, 1]
    inside = (wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)
    cy, cx = wy.clamp(0, h - 1).long(), wx.clamp(0, w - 1).long()
    cells = grid[rows(grid)[:, None, None], cy, cx]
    cells = torch.where(inside[..., None], cells, cell(WALL_CELL, dev))
    # The agent's cell shows what it carries (EMPTY when its hands are free).
    agent = torch.where((carrying[:, 0] != EMPTY)[:, None],
                        torch.cat([carrying, torch.zeros_like(carrying[:, :1])], 1),
                        cell(EMPTY_CELL, dev))
    cells[:, view - 1, half] = agent

    seeb = see_behind(cells[..., 0], cells[..., 2]).to(torch.int64)
    bit = 1 << torch.arange(view, device=dev)
    seeb = (seeb * bit).sum(-1)  # [N, view]: row j's see-through bits
    table = _shadow(view, dev)
    m = torch.full((n,), 1 << half, dtype=torch.int64, device=dev)
    mask = [None] * view
    for j in range(view - 1, -1, -1):
        out = table[m | (seeb[:, j] << view)]
        mask[j] = out & ((1 << view) - 1)
        m = out >> view
    mask = (torch.stack(mask, 1)[..., None] & bit) != 0
    cells = torch.where(mask[..., None], cells, 0)
    return cells.permute(0, 2, 1, 3).to(torch.uint8)


def goal_reward(t: torch.Tensor, max_steps: int) -> torch.Tensor:
    """``1 - 0.9 * t / max_steps`` in float32, rounded as the JAX package's
    compiled program rounds it: XLA folds the constants to ``c = f32(0.9) *
    f32(1 / max_steps)`` and fuses ``1 - t * c`` into one multiply-add.  In
    float64 ``t * c`` and the subtraction are exact, so one final rounding
    remains, as in the multiply-add."""
    c = float(np.float32(0.9) * np.float32(1.0 / max_steps))
    return (1.0 - t.to(torch.float64) * c).to(torch.float32)
