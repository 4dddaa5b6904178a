"""RoomGrid levels, batched over ``[N]`` envs: the BabyAI level suite and
the multi-room MiniGrid tasks.

Counterpart of ``envpool_tpu/envs/minigrid/roomgrid.py`` (behavioural
reference ``envpool/minigrid/impl/babyai_*.cc`` and the Farama level
definitions).  A RoomGrid is ``num_rows x num_cols`` rooms of
``room_size``; doors sit on shared walls; a mission is ``[N, 7]`` int32
``(kind, type, color, kind2, type2, color2, stage)``, the second
instruction of a "then" level in the last four.  Every level draws in the
JAX level's order (``plan_reset``) and builds the same grid.

``connect_all`` (:meth:`RoomGridEnv._connect_doors_mask`) is JAX's
48-step scan for 3x3 rooms in closed form: the rooms' connectivity only
grows as doors are added, so the doors are the slot draws up to the first
prefix that connects the rooms, read from a table of every slot subset's
connectivity (:func:`connected_table`); all slots when no prefix does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from ...ops.batched import const, first_argmax
from . import core as mg
from .minigrid_env import MiniGridEnv

# Mission kinds.
GOTO, OPEN, PICKUP, PUTNEXT, REACH_GOAL, NONE = range(6)

_OBJ_TYPES = (mg.KEY, mg.BALL, mg.BOX)


def door_slots(rows: int, cols: int) -> list[tuple[int, int, bool]]:
    """``(r, c, horizontal)`` of every wall between two adjacent rooms: the
    wall right of room ``(r, c)`` (horizontal) or below it."""
    slots = [(r, c, True) for r in range(rows) for c in range(cols - 1)]
    return slots + [(r, c, False) for r in range(rows - 1) for c in range(cols)]


@functools.lru_cache(maxsize=None)
def connected_table(rows: int, cols: int) -> np.ndarray:
    """``[2**n]`` bool: whether the doors of a slot subset (bit ``i`` slot
    ``i`` of :func:`door_slots`) connect every room, by the JAX package's
    min-label propagation."""
    slots = door_slots(rows, cols)
    n, rooms = len(slots), rows * cols
    ea = np.array([r * cols + c for r, c, _ in slots])
    eb = np.array([r * cols + c + 1 if h else (r + 1) * cols + c for r, c, h in slots])
    present = ((np.arange(1 << n)[:, None] >> np.arange(n)) & 1).astype(bool)
    adj = np.zeros((1 << n, rooms, rooms), bool)
    adj[:, ea, eb] = present
    adj[:, eb, ea] |= present
    adj |= np.eye(rooms, dtype=bool)
    lab = np.broadcast_to(np.arange(rooms), (1 << n, rooms))
    for _ in range(rooms):
        lab = np.where(adj, lab[:, None, :], rooms).min(2)
    return (lab == 0).all(1)


@functools.lru_cache(maxsize=None)
def _connected(rows: int, cols: int, device) -> torch.Tensor:
    return torch.as_tensor(connected_table(rows, cols), device=device)


def mission(n: int, device, *parts) -> torch.Tensor:
    """``[N, 7]`` int32 ``(k1, t1, c1, k2, t2, c2, 0)`` from ints or
    ``[N]`` tensors (missing trailing parts are -1)."""
    parts = list(parts) + [-1] * (6 - len(parts)) + [0]
    return torch.stack([
        p.to(torch.int32) if isinstance(p, torch.Tensor)
        else torch.full((n,), int(p), dtype=torch.int32, device=device) for p in parts], 1)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i, idx[i]]`` of an ``[N, k]`` tensor."""
    return x.gather(1, idx.long()[:, None])[:, 0]


class RoomGridEnv(MiniGridEnv):
    """Base for room-grid levels with descriptor missions."""

    DEFAULT_CONFIG = dict(MiniGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update(
        {
            "room_size": 8,
            "num_rows": 3,
            "num_cols": 3,
            "num_dists": 18,
            "doors_open": False,
            "debug": False,
        }
    )

    # -- geometry ----------------------------------------------------------

    @property
    def _rs(self) -> int:
        return int(self.config["room_size"])

    @property
    def _rows(self) -> int:
        return int(self.config["num_rows"])

    @property
    def _cols(self) -> int:
        return int(self.config["num_cols"])

    @property
    def _wh(self):
        rs = self._rs
        return self._cols * (rs - 1) + 1, self._rows * (rs - 1) + 1

    @property
    def _cells(self) -> int:
        w, h = self._wh
        return w * h

    def _grid_with_walls(self, n: int) -> torch.Tensor:
        """``[N, H, W, 3]``: walls on every room boundary."""
        w, h = self._wh
        rs = self._rs
        grid = np.zeros((h, w, 3), np.int8)
        grid[:, :, 0] = mg.EMPTY
        for c in range(self._cols + 1):
            grid[:, c * (rs - 1), 0] = mg.WALL
        for r in range(self._rows + 1):
            grid[r * (rs - 1), :, 0] = mg.WALL
        grid[grid[:, :, 0] == mg.WALL, 1] = mg.GREY
        return mg.batch(grid, n, self.device)

    def _door_slots(self):
        return door_slots(self._rows, self._cols)

    def _slot_xy(self, v: torch.Tensor, slot):
        """The door cell of a wall slot, ``v`` its offset along the wall."""
        r, c, horiz = slot
        rs = self._rs
        off = r * (rs - 1) + 1 + v if horiz else c * (rs - 1) + 1 + v
        fixed = torch.full_like(v, ((c if horiz else r) + 1) * (rs - 1))
        return (fixed, off.to(torch.int32)) if horiz else (off.to(torch.int32), fixed)

    def _connect_doors_mask(self, conn: torch.Tensor) -> torch.Tensor:
        """``[N, n]`` bool: the wall slots that get a door, BabyAI's
        ``connect_all`` from the ``[N, 4n]`` slot draws ``conn``."""
        n = len(self._door_slots())
        dev = conn.device
        onehot = conn.long()[:, :, None] == torch.arange(n, device=dev)
        prefix = onehot.cumsum(1) > 0  # [N, 4n, n]: the slots drawn so far
        bits = (prefix.long() << torch.arange(n, device=dev)).sum(-1)
        joined = _connected(self._rows, self._cols, dev)[bits]
        first = first_argmax(joined.to(torch.int8))
        present = prefix[mg.rows(prefix), first]
        return torch.where(joined.any(1)[:, None], present, True)

    def _plan_doors(self, d) -> None:
        """The draws of :meth:`_add_all_doors`."""
        slots = self._door_slots()
        if len(slots) > 1:
            d.randint("conn", 0, len(slots), (4 * len(slots),))
        for i in range(len(slots)):
            d.randint(f"door{i}", 0, self._rs - 2)
            d.randint(f"door_color{i}", 0, 6)

    def _add_all_doors(self, dr, grid, open_: bool = False):
        """Doors on the ``connect_all`` slot subset; returns ``(xs, ys,
        colors, present)``, each ``[N, slots]``."""
        slots = self._door_slots()
        n = grid.shape[0]
        if not slots:
            return None
        if len(slots) > 1:
            present = self._connect_doors_mask(dr["conn"])
        else:
            present = torch.ones((n, len(slots)), dtype=torch.bool, device=grid.device)
        state = mg.OPEN if open_ else mg.CLOSED
        xs, ys, colors = [], [], []
        for i, slot in enumerate(slots):
            x, y = self._slot_xy(dr[f"door{i}"], slot)
            color = dr[f"door_color{i}"]
            mg.put(grid, x, y, mg.stack_cell(mg.DOOR, color, state), where=present[:, i])
            xs.append(x)
            ys.append(y)
            colors.append(color.to(torch.int8))
        return torch.stack(xs, 1), torch.stack(ys, 1), torch.stack(colors, 1), present

    @staticmethod
    def _pick_door(noise: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
        """A uniform index over the present doors (logits ``-1e9`` on the
        others, as in the JAX package)."""
        return mg.pick(noise, present, -1e9)

    def _room_mask(self, room_r, room_c) -> torch.Tensor:
        """Bool mask of a room's interior: ``[H, W]`` for int rooms,
        ``[N, H, W]`` for ``[N]`` tensors."""
        w, h = self._wh
        rs = self._rs
        Y, X = mg.iota2(h, w, self.device)

        def col(v):
            return v[:, None, None] if isinstance(v, torch.Tensor) else v

        x0, y0 = col(room_c * (rs - 1)), col(room_r * (rs - 1))
        return (X > x0) & (X < x0 + rs - 1) & (Y > y0) & (Y < y0 + rs - 1)

    def _place_in_room(self, noise, grid, room_r, room_c, obj, color, state=0):
        x, y = mg.place_random(noise, grid, ~self._room_mask(room_r, room_c))
        mg.put(grid, x, y, mg.stack_cell(obj, color, state) if any(
            isinstance(v, torch.Tensor) for v in (obj, color, state))
            else mg.cell((obj, color, state), grid.device))
        return x, y

    def _plan_dists(self, d, n: int) -> None:
        """The draws of :meth:`_add_distractors`."""
        for i in range(n):
            d.randint(f"dist_type{i}", 0, 3)
            d.randint(f"dist_color{i}", 0, 6)
            d.cells(f"dist{i}", self._cells)

    def _add_distractors(self, dr, grid, n: int, forbid=None):
        """``n`` random objects anywhere: ``(types, colors)`` int8 ``[N, n]``."""
        table = const(_OBJ_TYPES, grid.device, torch.int8)
        types, colors = [], []
        for i in range(n):
            t = table[dr[f"dist_type{i}"].long()]
            c = dr[f"dist_color{i}"].to(torch.int8)
            x, y = mg.place_random(dr[f"dist{i}"], grid, forbid)
            mg.put(grid, x, y, mg.stack_cell(t, c))
            types.append(t)
            colors.append(c)
        return torch.stack(types, 1), torch.stack(colors, 1)

    def _plan_agent(self, d) -> None:
        d.cells("agent", self._cells)
        d.randint("dir", 0, 4)

    def _agent(self, dr, grid, forbid=None):
        x, y = mg.place_random(dr["agent"], grid, forbid)
        return torch.stack([x, y], 1), dr["dir"]

    # -- mission machinery -------------------------------------------------

    def state_spec(self):
        spec = dict(super().state_spec())
        spec["info:mission_id"] = ArraySpec(np.int32, (), -1, 2**20, is_discrete=True)
        return spec

    @staticmethod
    def _mission_id(m):
        c = m.clamp(min=0)
        return ((m[:, 0] * 8 + c[:, 1]) * 8 + c[:, 2]) * 512 + (c[:, 3] * 8 + c[:, 4]) * 8 + c[:, 5]

    def _obs(self, st):
        obs = super()._obs(st)
        obs["info:mission_id"] = self._mission_id(st["mission"])
        return obs

    @staticmethod
    def _match(obj, color, t, c):
        """Cells matching a descriptor (``t``, ``c`` ``[N]``); -1 is a
        wildcard (over KEY, BALL and BOX for the type)."""
        obj, color = obj.to(torch.int32), color.to(torch.int32)
        shape = (-1,) + (1,) * (obj.ndim - 1)
        t, c = t.reshape(shape), c.reshape(shape)
        t_ok = torch.where(t < 0, (obj == mg.KEY) | (obj == mg.BALL) | (obj == mg.BOX), obj == t)
        return t_ok & ((c < 0) | (color == c))

    def _desc_done(self, st, goal, kind, t, c, t2, c2):
        """Whether an instruction is satisfied in state ``st`` (any
        matching object counts)."""
        grid = st["grid"]
        obj, col, dstate = (grid[..., i].to(torch.int32) for i in range(3))
        w, h = self._wh
        fc = mg.get(grid, *mg.front(st["pos"], st["dir"], w, h)).to(torch.int32)
        goto_ok = self._match(fc[:, 0], fc[:, 1], t, c) | (
            (t == mg.DOOR) & (fc[:, 0] == mg.DOOR) & ((c < 0) | (fc[:, 1] == c)))
        cc = c[:, None, None]
        open_ok = ((obj == mg.DOOR) & (dstate == mg.OPEN) & ((cc < 0) | (col == cc))).flatten(1).any(1)
        pickup_ok = self._match(st["carrying"][:, 0], st["carrying"][:, 1], t, c)
        a_mask = self._match(obj, col, t, c)
        b_mask = self._match(obj, col, t2, c2)
        near = (torch.roll(b_mask, 1, 1) | torch.roll(b_mask, -1, 1)
                | torch.roll(b_mask, 1, 2) | torch.roll(b_mask, -1, 2))
        putnext_ok = (a_mask & near).flatten(1).any(1)
        out = torch.zeros_like(goal)
        for k, ok in ((GOTO, goto_ok), (OPEN, open_ok), (PICKUP, pickup_ok),
                      (PUTNEXT, putnext_ok), (REACH_GOAL, goal)):
            out = out | ((kind == k) & ok)
        return out

    @staticmethod
    def _wrong_open(grid, c_ok):
        """Debug levels: any open door NOT of color ``c_ok``."""
        return ((grid[..., 0] == mg.DOOR) & (grid[..., 2] == mg.OPEN)
                & (grid[..., 1].to(torch.int32) != c_ok[:, None, None])).flatten(1).any(1)

    # -- env contract ------------------------------------------------------

    def plan_reset(self, d):
        raise NotImplementedError

    def generate(self, dr):
        """-> ``(grid, pos, dir, mission)``.  Override."""
        raise NotImplementedError

    def reset_env(self, draws):
        grid, pos, d, m = self.generate(draws)
        st = self._start(grid, pos, d)
        st["mission"] = m.to(torch.int32)
        st.update(self.extra_state(st))
        return st, self._obs(st)

    def extra_state(self, st):
        """Hook for levels that start carrying an object."""
        del st
        return {}

    def step_env(self, state, action, draws):
        del draws
        grid, pos, d, carrying, goal, lava = mg.step_agent(
            state["grid"], state["pos"], state["dir"], state["carrying"], action)
        t = state["t"] + 1
        m = state["mission"]
        st = {"grid": grid, "pos": pos, "dir": d, "carrying": carrying, "t": t}
        d1 = self._desc_done(st, goal, m[:, 0], m[:, 1], m[:, 2], m[:, 4], m[:, 5])
        has_second = m[:, 3] >= 0
        none = torch.full_like(m[:, 0], -1)
        d2 = self._desc_done(st, goal, m[:, 3], m[:, 4], m[:, 5], none, none)
        stage = m[:, 6]
        new_stage = torch.where((stage == 0) & d1, 1, stage)
        success = torch.where(has_second, (new_stage == 1) & d2, d1)
        fail = torch.zeros_like(success)
        if bool(self.config["debug"]):
            # Opening any door outside the current sub-goal fails.
            cur_c = torch.where(stage == 0, m[:, 2], m[:, 5])
            fail = (m[:, 0] == OPEN) & self._wrong_open(grid, cur_c) & ~success
        st["mission"] = torch.cat([m[:, :6], new_stage[:, None]], 1).to(torch.int32)
        reward = torch.where(success, mg.goal_reward(t, self.max_episode_steps), 0.0)
        return EnvOut(state=st, obs=self._obs(st), reward=reward.to(torch.float32),
                      terminated=success | lava | fail)


# ---------------------------------------------------------------------------
# Level generators
# ---------------------------------------------------------------------------


def _n(dr) -> int:
    return dr["rows"].shape[0]


class OneRoomEnv(RoomGridEnv):
    """BabyAI OneRoomS{8,12,16,20}: go to the red ball in one room."""

    def plan_reset(self, d):
        d.cells("ball", self._cells)
        self._plan_agent(d)

    def generate(self, dr):
        grid = self._grid_with_walls(_n(dr))
        self._place_in_room(dr["ball"], grid, 0, 0, mg.BALL, mg.RED)
        pos, d = self._agent(dr, grid)
        return grid, pos, d, mission(_n(dr), grid.device, GOTO, mg.BALL, mg.RED)


class FindObjEnv(RoomGridEnv):
    """BabyAI FindObjS{5,6,7}: one object in a random room; go to it."""

    def plan_reset(self, d):
        self._plan_doors(d)
        d.randint("room_r", 0, self._rows)
        d.randint("room_c", 0, self._cols)
        d.randint("type", 0, 3)
        d.randint("color", 0, 6)
        d.cells("obj", self._cells)
        self._plan_agent(d)

    def generate(self, dr):
        grid = self._grid_with_walls(_n(dr))
        self._add_all_doors(dr, grid)
        t = const(_OBJ_TYPES, grid.device, torch.int8)[dr["type"].long()]
        self._place_in_room(dr["obj"], grid, dr["room_r"], dr["room_c"], t, dr["color"])
        # The agent in the centre room.
        amask = self._room_mask(self._rows // 2, self._cols // 2)
        pos, d = self._agent(dr, grid, ~amask)
        return grid, pos, d, mission(_n(dr), grid.device, GOTO, t, -1)


class GoToMazeEnv(RoomGridEnv):
    """BabyAI GoTo / GoToOpen / GoToObjMaze*: maze GoTo with distractors."""

    def plan_reset(self, d):
        n = max(int(self.config["num_dists"]), 1)
        self._plan_doors(d)
        self._plan_dists(d, n)
        d.randint("target", 0, n)
        self._plan_agent(d)

    def generate(self, dr):
        n = max(int(self.config["num_dists"]), 1)
        grid = self._grid_with_walls(_n(dr))
        self._add_all_doors(dr, grid, open_=bool(self.config["doors_open"]))
        types, colors = self._add_distractors(dr, grid, n)
        t, c = take(types, dr["target"]), take(colors, dr["target"])
        pos, d = self._agent(dr, grid)
        return grid, pos, d, mission(_n(dr), grid.device, GOTO, t, c)


class GoToSeqEnv(GoToMazeEnv):
    """BabyAI GoToSeq(S5R2): go to A, then go to B."""

    def plan_reset(self, d):
        super().plan_reset(d)
        d.randint("type2", 0, 3)
        d.randint("color2", 0, 6)

    def generate(self, dr):
        grid, pos, d, m1 = super().generate(dr)
        # The second target drawn independently from the object support.
        t2 = const(_OBJ_TYPES, grid.device, torch.int8)[dr["type2"].long()]
        return grid, pos, d, mission(_n(dr), grid.device, GOTO, m1[:, 1], m1[:, 2], GOTO, t2,
                                     dr["color2"])


class WallDoorRoomEnv(RoomGridEnv):
    """A single room with doors on its outer walls (GoToObjDoor,
    ActionObjDoor, OpenDoor* families)."""

    N_DOORS = 4

    def _plan_outer_doors(self, d, distinct: bool = False) -> None:
        w, h = self._wh
        if distinct:
            d.perm("door_perm", 6)
        else:
            # One key for the four colours in the JAX package: one colour.
            for i in range(self.N_DOORS):
                d.randint(f"door_color{i}", 0, 6, share="door_color0" if i else None)
        d.randint("door_dy", 1, h - 1, (2,))
        d.randint("door_dx", 1, w - 1, (2,))

    def _outer_doors(self, dr, grid, distinct: bool = False, state=mg.CLOSED):
        """The doors on the outer walls; returns their colors ``[N, k]``."""
        w, h = self._wh
        if distinct:
            colors = dr["door_perm"][:, :self.N_DOORS].to(torch.int8)
        else:
            colors = torch.stack([dr[f"door_color{i}"] for i in range(self.N_DOORS)],
                                 1).to(torch.int8)
        dy, dx = dr["door_dy"], dr["door_dx"]
        zero = torch.zeros_like(dy[:, 0])
        slots = [(zero, dx[:, 0]), (zero + h - 1, dx[:, 1]), (dy[:, 0], zero), (dy[:, 1], zero + w - 1)]
        for i, (ry, rx) in enumerate(slots[:self.N_DOORS]):
            mg.put(grid, rx, ry, mg.stack_cell(mg.DOOR, colors[:, i], state))
        return colors


class GoToObjDoorEnv(WallDoorRoomEnv):
    """BabyAI GoToObjDoor: go to an object or a door in a single room."""

    def plan_reset(self, d):
        n = max(int(self.config["num_dists"]), 1)
        self._plan_outer_doors(d)
        self._plan_dists(d, n)
        d.bernoulli("pick_door")
        d.randint("target", 0, n)
        d.randint("door", 0, 4)
        self._plan_agent(d)

    def generate(self, dr):
        n = max(int(self.config["num_dists"]), 1)
        grid = self._grid_with_walls(_n(dr))
        door_colors = self._outer_doors(dr, grid)
        types, colors = self._add_distractors(dr, grid, n)
        pick = dr["pick_door"]
        t = torch.where(pick, mg.DOOR, take(types, dr["target"]).to(torch.int32))
        c = torch.where(pick, take(door_colors, dr["door"]).to(torch.int32),
                        take(colors, dr["target"]).to(torch.int32))
        pos, d = self._agent(dr, grid)
        return grid, pos, d, mission(_n(dr), grid.device, GOTO, t, c)


class ActionObjDoorEnv(GoToObjDoorEnv):
    """BabyAI ActionObjDoor: goto/pickup/open on objects or doors."""

    def plan_reset(self, d):
        super().plan_reset(d)
        d.bernoulli("open")
        d.bernoulli("pickup")

    def generate(self, dr):
        grid, pos, d, m = super().generate(dr)
        kind = torch.where(m[:, 1] == mg.DOOR, torch.where(dr["open"], OPEN, GOTO),
                           torch.where(dr["pickup"], PICKUP, GOTO))
        return grid, pos, d, mission(_n(dr), grid.device, kind, m[:, 1], m[:, 2])


class OpenDoorEnv(WallDoorRoomEnv):
    """BabyAI OpenDoor{,Color,Loc,Debug} and OpenRedDoor: open the
    described door (one room, four distinctly coloured doors)."""

    DEFAULT_CONFIG = dict(WallDoorRoomEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"fixed_color": -1})

    def plan_reset(self, d):
        self._plan_outer_doors(d, distinct=True)
        if int(self.config["fixed_color"]) < 0:
            d.randint("door", 0, self.N_DOORS)
        self._plan_agent(d)

    def generate(self, dr):
        grid = self._grid_with_walls(_n(dr))
        door_colors = self._outer_doors(dr, grid, distinct=True)
        fixed = int(self.config["fixed_color"])
        if fixed >= 0:
            # OpenRedDoor: the first door's colour becomes ``fixed``.
            recolor = (grid[..., 0] == mg.DOOR) & (grid[..., 1] == door_colors[:, :1, None])
            grid[..., 1] = torch.where(recolor, fixed, grid[..., 1])
            c = fixed
        else:
            c = take(door_colors, dr["door"])
        pos, d = self._agent(dr, grid)
        return grid, pos, d, mission(_n(dr), grid.device, OPEN, mg.DOOR, c)


class OpenTwoDoorsEnv(WallDoorRoomEnv):
    """BabyAI OpenTwoDoors / OpenDoorsOrderN{2,4} / OpenRedBlueDoors: open
    door A, then door B (the order enforced in debug mode)."""

    DEFAULT_CONFIG = dict(WallDoorRoomEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"n_doors": 2, "fixed_pair": False})

    @property
    def N_DOORS(self):  # type: ignore[override]
        return int(self.config["n_doors"])

    def plan_reset(self, d):
        self._plan_outer_doors(d, distinct=True)
        if not bool(self.config["fixed_pair"]):
            d.perm("order", self.N_DOORS)
        self._plan_agent(d)

    def generate(self, dr):
        n = _n(dr)
        grid = self._grid_with_walls(n)
        cs = self._outer_doors(dr, grid, distinct=True)
        if bool(self.config["fixed_pair"]):
            # OpenRedBlueDoors: the first two doors' colours become red,
            # then blue, one after the other.
            door = grid[..., 0] == mg.DOOR
            col = grid[..., 1]
            col = torch.where(door & (col == cs[:, :1, None]), mg.RED, col)
            col = torch.where(door & (col == cs[:, 1:2, None]), mg.BLUE, col)
            grid[..., 1] = col
            c1, c2 = mg.RED, mg.BLUE
        else:
            c1, c2 = take(cs, dr["order"][:, 0]), take(cs, dr["order"][:, 1])
        pos, d = self._agent(dr, grid)
        return grid, pos, d, mission(n, grid.device, OPEN, mg.DOOR, c1, OPEN, mg.DOOR, c2)


class OpenMazeEnv(RoomGridEnv):
    """BabyAI Open: open the <color> door in a 3x3 maze."""

    def plan_reset(self, d):
        self._plan_doors(d)
        d.cells("door", len(self._door_slots()))
        self._plan_agent(d)

    def generate(self, dr):
        grid = self._grid_with_walls(_n(dr))
        _, _, colors, present = self._add_all_doors(dr, grid)
        c = take(colors, self._pick_door(dr["door"], present))
        pos, d = self._agent(dr, grid)
        return grid, pos, d, mission(_n(dr), grid.device, OPEN, mg.DOOR, c)


class PickupEnv(GoToMazeEnv):
    """BabyAI Pickup / PickupDist / PickupLoc / UnblockPickup."""

    def generate(self, dr):
        grid, pos, d, m = super().generate(dr)
        return grid, pos, d, mission(_n(dr), grid.device, PICKUP, m[:, 1], m[:, 2])


class PickupAboveEnv(RoomGridEnv):
    """BabyAI PickupAbove: an object in the room above the centre."""

    def plan_reset(self, d):
        self._plan_doors(d)
        d.randint("type", 0, 3)
        d.randint("color", 0, 6)
        d.cells("obj", self._cells)
        self._plan_agent(d)

    def generate(self, dr):
        grid = self._grid_with_walls(_n(dr))
        self._add_all_doors(dr, grid)
        t = const(_OBJ_TYPES, grid.device, torch.int8)[dr["type"].long()]
        mid_r, mid_c = self._rows // 2, self._cols // 2
        self._place_in_room(dr["obj"], grid, mid_r - 1, mid_c, t, dr["color"])
        pos, d = self._agent(dr, grid, ~self._room_mask(mid_r, mid_c))
        return grid, pos, d, mission(_n(dr), grid.device, PICKUP, t, dr["color"])


class PutNextEnv(RoomGridEnv):
    """BabyAI PutNext* (and MiniGrid PutNear): put A next to B."""

    DEFAULT_CONFIG = dict(RoomGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"carrying": False})

    def plan_reset(self, d):
        n = max(int(self.config["num_dists"]), 2)
        if self._rows * self._cols > 1:
            self._plan_doors(d)
        self._plan_dists(d, n)
        d.randint("a", 0, n)
        d.randint("b", 0, n - 1)
        self._plan_agent(d)

    def generate(self, dr):
        n = max(int(self.config["num_dists"]), 2)
        grid = self._grid_with_walls(_n(dr))
        if self._rows * self._cols > 1:
            self._add_all_doors(dr, grid)
        types, colors = self._add_distractors(dr, grid, n)
        ia = dr["a"]
        ib = torch.remainder(ia + 1 + dr["b"], n)
        pos, d = self._agent(dr, grid)
        return grid, pos, d, mission(_n(dr), grid.device, PUTNEXT, take(types, ia),
                                     take(colors, ia), -1, take(types, ib), take(colors, ib))

    def extra_state(self, st):
        if not bool(self.config["carrying"]):
            return {}
        # Start with object A in hand: the first matching cell is emptied.
        m, grid = st["mission"], st["grid"]
        match = self._match(grid[..., 0], grid[..., 1], m[:, 1], m[:, 2])
        idx = first_argmax(match.flatten(1).to(torch.int8))
        w = grid.shape[2]
        grid = grid.clone()
        mg.put(grid, idx % w, idx // w, mg.cell(mg.EMPTY_CELL, grid.device))
        return {"grid": grid, "carrying": torch.stack([m[:, 1], m[:, 2]], 1).to(torch.int8)}


class UnlockRGEnv(RoomGridEnv):
    """BabyAI Unlock-class levels: a locked door, its key somewhere.

    Config: ``hidden_key`` (the key inside a box), ``blocked`` (a ball in
    front of the locked door), ``target`` ("open" | "pickup_box" |
    "pickup_ball" | "goto_ball")."""

    DEFAULT_CONFIG = dict(RoomGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update(
        {
            "hidden_key": False,
            "blocked": False,
            "target": "open",
            "num_rows": 1,
            "num_cols": 2,
            "room_size": 6,
            "num_dists": 0,
        }
    )

    def plan_reset(self, d):
        if len(self._door_slots()) > 1:
            self._plan_doors(d)
        d.randint("lock", 0, self._rs - 2)
        d.randint("lock_color", 0, 6)
        if bool(self.config["hidden_key"]):
            d.randint("box_color", 0, 6)
        d.cells("key", self._cells)
        target = str(self.config["target"])
        if target == "pickup_box":
            d.randint("target_color", 0, 6)
        if target in ("pickup_box", "pickup_ball", "goto_ball"):
            d.cells("target", self._cells)
        self._plan_dists(d, int(self.config["num_dists"]))
        self._plan_agent(d)

    def generate(self, dr):
        n = _n(dr)
        grid = self._grid_with_walls(n)
        slots = self._door_slots()
        # The first slot's door (between rooms (0, 0) and (0, 1)) is locked.
        if len(slots) > 1:
            self._add_all_doors(dr, grid)
        dx, dy = self._slot_xy(dr["lock"], slots[0])
        lock_c = dr["lock_color"]
        mg.put(grid, dx, dy, mg.stack_cell(mg.DOOR, lock_c, mg.LOCKED))
        if bool(self.config["hidden_key"]):
            self._place_in_room(dr["key"], grid, 0, 0, mg.BOX, dr["box_color"],
                                mg.box_contents(mg.KEY, lock_c))
        else:
            self._place_in_room(dr["key"], grid, 0, 0, mg.KEY, lock_c)
        if bool(self.config["blocked"]):
            mg.put(grid, dx - 1, dy, mg.cell((mg.BALL, mg.GREY, 0), grid.device))
        target = str(self.config["target"])
        dev = grid.device
        if target == "pickup_box":
            self._place_in_room(dr["target"], grid, 0, 1, mg.BOX, dr["target_color"])
            m = mission(n, dev, PICKUP, mg.BOX, -1)
        elif target == "pickup_ball":
            self._place_in_room(dr["target"], grid, 0, 1, mg.BALL, mg.BLUE)
            m = mission(n, dev, PICKUP, mg.BALL, mg.BLUE)
        elif target == "goto_ball":
            self._place_in_room(dr["target"], grid, 0, 1, mg.BALL, mg.BLUE)
            m = mission(n, dev, GOTO, mg.BALL, mg.BLUE)
        else:
            m = mission(n, dev, OPEN, mg.DOOR, lock_c)
        # Distractors outside the locked room.
        k = int(self.config["num_dists"])
        if k:
            self._add_distractors(dr, grid, k, self._room_mask(0, 1))
        pos, d = self._agent(dr, grid, ~self._room_mask(0, 0))
        return grid, pos, d, m


class KeyCorridorEnv(RoomGridEnv):
    """KeyCorridorS{n}R{m} (MiniGrid and BabyAI): a ball behind a locked
    door off a corridor; the key in another room."""

    DEFAULT_CONFIG = dict(RoomGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"num_cols": 3, "num_dists": 0})

    def plan_reset(self, d):
        rows, rs = self._rows, self._rs
        for r in range(rows - 1):
            d.randint(f"gap{r}", 0, rs - 2)
        for r in range(rows):
            for side in (0, 2):
                d.randint(f"door_y{r}_{side}", 0, rs - 2)
                d.randint(f"door_color{r}_{side}", 0, 6)
        d.randint("lock_row", 0, rows)
        d.cells("ball", self._cells)
        d.randint("key_row", 0, rows)
        d.cells("key", self._cells)
        self._plan_agent(d)

    def generate(self, dr):
        rows, rs = self._rows, self._rs
        n = _n(dr)
        grid = self._grid_with_walls(n)
        dev = grid.device
        # The corridor: the middle column's rooms joined through gaps.
        for r in range(rows - 1):
            mg.put(grid, (rs - 1) + 1 + dr[f"gap{r}"], (r + 1) * (rs - 1),
                   mg.cell(mg.EMPTY_CELL, dev))
        # A door from the corridor into each side room.
        right = []
        for r in range(rows):
            for side, wall in ((0, 0), (2, 1)):
                x = (wall + 1) * (rs - 1)
                y = r * (rs - 1) + 1 + dr[f"door_y{r}_{side}"]
                c = dr[f"door_color{r}_{side}"]
                mg.put(grid, x, y, mg.stack_cell(mg.DOOR, c, mg.CLOSED))
                if side == 2:
                    right.append((torch.full_like(y, x), y, c.to(torch.int8)))
        # Lock a random right-side door, the ball inside; the key in a
        # random left room.
        ri = dr["lock_row"]
        lx = take(torch.stack([p[0] for p in right], 1), ri)
        ly = take(torch.stack([p[1] for p in right], 1), ri)
        lc = take(torch.stack([p[2] for p in right], 1), ri)
        r_ = mg.rows(grid)
        grid[r_, ly.long(), lx.long(), 2] = mg.LOCKED
        bx, by = mg.place_random(dr["ball"], grid, ~self._room_mask(ri, 2))
        mg.put(grid, bx, by, mg.cell((mg.BALL, mg.BLUE, 0), dev))
        kx, ky = mg.place_random(dr["key"], grid, ~self._room_mask(dr["key_row"], 0))
        mg.put(grid, kx, ky, mg.stack_cell(mg.KEY, lc))
        # The agent in the corridor.
        amask = torch.zeros_like(grid[..., 0], dtype=torch.bool)
        for r in range(rows):
            amask = amask | self._room_mask(r, 1)
        pos, d = self._agent(dr, grid, ~amask)
        return grid, pos, d, mission(n, dev, PICKUP, mg.BALL, mg.BLUE)


class ObstructedMazeEnv(RoomGridEnv):
    """MiniGrid ObstructedMaze family: locked doors, keys in boxes,
    blocking balls; the target is the blue ball."""

    DEFAULT_CONFIG = dict(RoomGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update(
        {
            "room_size": 6,
            "num_rows": 1,
            "num_cols": 2,
            "hidden_key": True,
            "blocked": True,
            "num_dists": 0,
        }
    )

    def plan_reset(self, d):
        if len(self._door_slots()) > 1:
            self._plan_doors(d)
        d.randint("lock", 0, self._rs - 2)
        d.randint("lock_color", 0, 6)
        if bool(self.config["hidden_key"]):
            d.randint("box_color", 0, 6)
        d.cells("key", self._cells)
        d.cells("ball", self._cells)
        self._plan_agent(d)

    def generate(self, dr):
        n = _n(dr)
        grid = self._grid_with_walls(n)
        dev = grid.device
        slots = self._door_slots()
        if len(slots) > 1:
            self._add_all_doors(dr, grid)
        dx, dy = self._slot_xy(dr["lock"], slots[0])
        lock_c = dr["lock_color"]
        mg.put(grid, dx, dy, mg.stack_cell(mg.DOOR, lock_c, mg.LOCKED))
        if bool(self.config["blocked"]):
            mg.put(grid, dx - 1, dy, mg.cell((mg.BALL, mg.GREY, 0), dev))
        if bool(self.config["hidden_key"]):
            self._place_in_room(dr["key"], grid, 0, 0, mg.BOX, dr["box_color"],
                                mg.box_contents(mg.KEY, lock_c))
        else:
            self._place_in_room(dr["key"], grid, 0, 0, mg.KEY, lock_c)
        self._place_in_room(dr["ball"], grid, self._rows - 1, self._cols - 1, mg.BALL, mg.BLUE)
        pos, d = self._agent(dr, grid, ~self._room_mask(0, 0))
        return grid, pos, d, mission(n, dev, PICKUP, mg.BALL, mg.BLUE)


class MultiRoomEnv(RoomGridEnv):
    """MiniGrid MultiRoom-N{n}: a chain of rooms ending at a goal (a snake
    over the room grid; door colours and positions random)."""

    def _path(self) -> list[tuple[int, int]]:
        path = []
        for r in range(self._rows):
            cs = range(self._cols) if r % 2 == 0 else range(self._cols - 1, -1, -1)
            path.extend((r, c) for c in cs)
        return path

    def plan_reset(self, d):
        for i in range(len(self._path()) - 1):
            d.randint(f"door{i}", 0, self._rs - 2)
            d.randint(f"door_color{i}", 0, 6)
        d.cells("goal", self._cells)
        self._plan_agent(d)

    def generate(self, dr):
        n = _n(dr)
        grid = self._grid_with_walls(n)
        path = self._path()
        for i in range(len(path) - 1):
            (r0, c0), (r1, c1) = path[i], path[i + 1]
            slot = (r0, min(c0, c1), True) if r0 == r1 else (min(r0, r1), c0, False)
            x, y = self._slot_xy(dr[f"door{i}"], slot)
            mg.put(grid, x, y, mg.stack_cell(mg.DOOR, dr[f"door_color{i}"], mg.CLOSED))
        # The goal in the last room, the agent in the first.
        self._place_in_room(dr["goal"], grid, *path[-1], mg.GOAL, mg.GREEN)
        pos, d = self._agent(dr, grid, ~self._room_mask(*path[0]))
        return grid, pos, d, mission(n, grid.device, REACH_GOAL, -1, -1)


class LockedRoomEnv(RoomGridEnv):
    """MiniGrid LockedRoom: six rooms off a corridor; the goal in a locked
    room, the matching key in another."""

    DEFAULT_CONFIG = dict(RoomGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"num_rows": 3, "num_cols": 3, "room_size": 7})

    def plan_reset(self, d):
        for r in range(self._rows):
            for side in (0, 2):
                d.randint(f"door_y{r}_{side}", 0, self._rs - 2)
                d.randint(f"door_color{r}_{side}", 0, 6)
        k = 2 * self._rows
        d.randint("lock", 0, k)
        d.cells("goal", self._cells)
        d.randint("key_room", 0, k - 1)
        d.cells("key", self._cells)
        self._plan_agent(d)

    def generate(self, dr):
        n = _n(dr)
        rs = self._rs
        w, h = self._wh
        grid = self._grid_with_walls(n)
        dev = grid.device
        # The middle column is the corridor: no walls across it.
        Y, X = mg.iota2(h, w, dev)
        corridor = (X > rs - 1) & (X < 2 * (rs - 1))
        clear = corridor & (Y % (rs - 1) == 0) & (Y > 0) & (Y < h - 1)
        grid = mg.paint(grid, clear, mg.EMPTY_CELL)
        # A door from the corridor into each side room.
        info = []
        for r in range(self._rows):
            for side, wall in ((0, 0), (2, 1)):
                x = (wall + 1) * (rs - 1)
                y = r * (rs - 1) + 1 + dr[f"door_y{r}_{side}"]
                c = dr[f"door_color{r}_{side}"]
                mg.put(grid, x, y, mg.stack_cell(mg.DOOR, c, mg.CLOSED))
                info.append((torch.full_like(y, x), y, c.to(torch.int8), r, side))
        xs = torch.stack([p[0] for p in info], 1)
        ys = torch.stack([p[1] for p in info], 1)
        cs = torch.stack([p[2] for p in info], 1)
        rr = const(tuple(p[3] for p in info), dev, torch.int32)
        cc = const(tuple(p[4] for p in info), dev, torch.int32)
        # Lock a random door, the goal behind it, the key in another room.
        idx = dr["lock"].long()
        grid[mg.rows(grid), take(ys, idx).long(), take(xs, idx).long(), 2] = mg.LOCKED
        self._place_in_room(dr["goal"], grid, rr[idx], cc[idx], mg.GOAL, mg.GREEN)
        kidx = torch.remainder(idx + 1 + dr["key_room"], len(info))
        self._place_in_room(dr["key"], grid, rr[kidx], cc[kidx], mg.KEY, take(cs, idx))
        # The agent in the corridor.
        amask = corridor & (grid[..., 0] == mg.EMPTY)
        pos, d = self._agent(dr, grid, ~amask)
        return grid, pos, d, mission(n, dev, REACH_GOAL, -1, -1)


class PlaygroundEnv(RoomGridEnv):
    """MiniGrid Playground: 3x3 rooms of random objects, no mission."""

    def plan_reset(self, d):
        self._plan_doors(d)
        self._plan_dists(d, int(self.config["num_dists"]))
        self._plan_agent(d)

    def generate(self, dr):
        grid = self._grid_with_walls(_n(dr))
        self._add_all_doors(dr, grid)
        self._add_distractors(dr, grid, int(self.config["num_dists"]))
        pos, d = self._agent(dr, grid)
        return grid, pos, d, mission(_n(dr), grid.device, NONE, -1, -1)


class SynthEnv(RoomGridEnv):
    """BabyAI Synth / SynthLoc / SynthSeq / MiniBossLevel / BossLevel.

    The instruction kind is uniform over {goto, open, pickup, putnext};
    the Seq and Boss levels chain a second instruction.  The JAX package
    draws an instruction's first object and its door from one key; here
    they are two draws (a reference approximation)."""

    DEFAULT_CONFIG = dict(RoomGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"seq": False})

    def _plan_instr(self, d, p: str, n: int) -> None:
        d.randint(p + "kind", 0, 4)
        d.randint(p + "a", 0, n)
        d.randint(p + "b", 0, n - 1)
        d.cells(p + "door", len(self._door_slots()))

    def plan_reset(self, d):
        n = max(int(self.config["num_dists"]), 2)
        self._plan_doors(d)
        self._plan_dists(d, n)
        self._plan_instr(d, "i1_", n)
        if bool(self.config["seq"]):
            self._plan_instr(d, "i2_", n)
        self._plan_agent(d)

    def generate(self, dr):
        n = max(int(self.config["num_dists"]), 2)
        grid = self._grid_with_walls(_n(dr))
        _, _, door_colors, present = self._add_all_doors(dr, grid)
        types, colors = self._add_distractors(dr, grid, n)
        types, colors = types.to(torch.int32), colors.to(torch.int32)

        def instr(p):
            kind = dr[p + "kind"]
            ia = dr[p + "a"]
            ib = torch.remainder(ia + 1 + dr[p + "b"], n)
            di = self._pick_door(dr[p + "door"], present)
            t = torch.where(kind == OPEN, mg.DOOR, take(types, ia))
            c = torch.where(kind == OPEN, take(door_colors, di).to(torch.int32), take(colors, ia))
            t2 = torch.where(kind == PUTNEXT, take(types, ib), -1)
            c2 = torch.where(kind == PUTNEXT, take(colors, ib), -1)
            return kind, t, c, t2, c2

        k1, t1, c1, t12, c12 = instr("i1_")
        if bool(self.config["seq"]):
            # The second instruction is goto, open or pickup; the first
            # avoids putnext too.
            k2, t2, c2, _, _ = instr("i2_")
            k2 = torch.where(k2 == PUTNEXT, GOTO, k2)
            k1 = torch.where(k1 == PUTNEXT, PICKUP, k1)
            m = mission(_n(dr), grid.device, k1, t1, c1, k2, t2, c2)
        else:
            m = mission(_n(dr), grid.device, k1, t1, c1, -1, t12, c12)
        pos, d = self._agent(dr, grid)
        return grid, pos, d, m
