"""Lane-network core of the highway family's curved-road scenarios.

Counterpart of ``envpool_tpu/envs/highway/network.py`` (reference:
``envpool/highway/official_{lane,road,vehicle,scene}.cc``).  The road is a
static table of lanes built once per scenario in numpy
(:class:`RoadBuilder`, copied from the JAX package: straight, circular and
sine lanes, the route successors and the segment grouping), held on the
device as :class:`LaneTable`.

Every query of the JAX env projects positions into lanes' frames
(``lane_local``); within one substep the positions do not move until the
bicycle step, so the port computes the frame of every vehicle in every
lane once (:func:`lane_frame`, ``[N, V, K]``) and gathers from it, where
the JAX env evaluates the same formula per query.  The values are the
same per element.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from ...ops.batched import asin, atan, atan2, cos, f32, mod, pow, sin, tan

_PI = math.pi
LANE_W = 4.0
VEH_LEN = 5.0
VEH_WID = 2.0
MAX_SPEED = 40.0
MIN_SPEED = -40.0
PERCEPTION = 5.0 * MAX_SPEED

_KP_A = 1.0 / 0.6
_KP_HEADING = 1.0 / 0.2
_KP_LATERAL = 1.0 / 0.6
_TAU_PURSUIT = 0.5 * 0.2
_MAX_STEER = _PI / 3.0
_LC_DELAY = 1.0
_LC_MAX_BRAKING = 2.0
_LC_MIN_ACC_GAIN = 0.2

STRAIGHT, CIRCULAR, SINE = 0, 1, 2
K_MDP, K_IDM, K_OBSTACLE, K_PLAIN = 0, 1, 2, 3


def notzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() > f32(1e-2), x,
                       torch.where(x >= 0, f32(1e-2), f32(-1e-2)))


def wrap_pi(x: torch.Tensor) -> torch.Tensor:
    """``(x + pi) % (2 pi) - pi`` with ``jnp``'s float remainder."""
    return mod(x + f32(_PI), f32(2.0 * _PI)) - f32(_PI)


def lmap(v, x0, x1, y0, y1):
    """``y0 + (v - x0) * (y1 - y0) / (x1 - x0)``; with constant bounds the
    division is a multiplication by the reciprocal, as XLA folds it."""
    if isinstance(x0, (int, float)) and isinstance(x1, (int, float)):
        return y0 + (v - x0) * f32(y1 - y0) * f32(1.0 / (x1 - x0))
    return y0 + (v - x0) * (y1 - y0) / (x1 - x0)


# ---------------------------------------------------------------------------
# Static road construction (numpy; copied from the JAX package)
# ---------------------------------------------------------------------------


class RoadBuilder:
    """Builds the static lane table (``official_road.cc::AddLane``)."""

    def __init__(self):
        self._lanes = []          # list of per-lane param dicts
        self._edges = OrderedDict()   # (from,to) -> [lane indices]

    # -- lane constructors (official_lane.cc:45-95) --

    def straight(self, frm, to, start, end, width=LANE_W, forbidden=False,
                 speed_limit=20.0, priority=0):
        start = np.asarray(start, np.float64)
        end = np.asarray(end, np.float64)
        length = float(np.linalg.norm(end - start))
        d = (end - start) / length
        self._add(frm, to, dict(
            kind=STRAIGHT, start=start, direction=d,
            dirlat=np.array([-d[1], d[0]]), heading=math.atan2(d[1], d[0]),
            length=length, width=width, forbidden=forbidden,
            speed_limit=speed_limit, priority=priority,
            amp=0.0, puls=0.0, phase=0.0,
            center=np.zeros(2), radius=1.0, sphase=0.0, cdir=1.0))
        return self

    def sine(self, frm, to, start, end, amplitude, pulsation, phase,
             width=LANE_W, forbidden=False, speed_limit=20.0, priority=0):
        self.straight(frm, to, start, end, width, forbidden, speed_limit,
                      priority)
        self._lanes[-1].update(kind=SINE, amp=amplitude, puls=pulsation,
                               phase=phase)
        return self

    def circular(self, frm, to, center, radius, start_phase, end_phase,
                 clockwise, width=LANE_W, forbidden=False, speed_limit=20.0,
                 priority=0):
        cdir = 1.0 if clockwise else -1.0
        length = radius * (end_phase - start_phase) * cdir
        self._add(frm, to, dict(
            kind=CIRCULAR, start=np.zeros(2), direction=np.array([1.0, 0.0]),
            dirlat=np.array([0.0, 1.0]), heading=0.0, length=length,
            width=width, forbidden=forbidden, speed_limit=speed_limit,
            priority=priority, amp=0.0, puls=0.0, phase=0.0,
            center=np.asarray(center, np.float64), radius=radius,
            sphase=start_phase, cdir=cdir))
        return self

    def _add(self, frm, to, lane):
        self._edges.setdefault((frm, to), []).append(len(self._lanes))
        lane["edge"] = (frm, to)
        self._lanes.append(lane)

    # -- numpy geometry for build-time route resolution --

    def _np_position(self, k, s, lat=0.0):
        ln = self._lanes[k]
        if ln["kind"] == CIRCULAR:
            phi = ln["cdir"] * s / ln["radius"] + ln["sphase"]
            r = ln["radius"] - lat * ln["cdir"]
            return ln["center"] + r * np.array([math.cos(phi), math.sin(phi)])
        off = ln["amp"] * math.sin(ln["puls"] * s + ln["phase"]) \
            if ln["kind"] == SINE else 0.0
        return ln["start"] + s * ln["direction"] + (lat + off) * ln["dirlat"]

    def _np_heading(self, k, s):
        ln = self._lanes[k]
        if ln["kind"] == CIRCULAR:
            phi = ln["cdir"] * s / ln["radius"] + ln["sphase"]
            return phi + _PI / 2.0 * ln["cdir"]
        if ln["kind"] == SINE:
            return ln["heading"] + math.atan(
                ln["amp"] * ln["puls"]
                * math.cos(ln["puls"] * s + ln["phase"]))
        return ln["heading"]

    def _np_distance(self, k, pos):
        ln = self._lanes[k]
        if ln["kind"] == CIRCULAR:
            delta = pos - ln["center"]
            phi = math.atan2(delta[1], delta[0])
            phi = ln["sphase"] + _np_wrap_pi(phi - ln["sphase"])
            s = ln["cdir"] * (phi - ln["sphase"]) * ln["radius"]
            lat = ln["cdir"] * (ln["radius"] - np.linalg.norm(delta))
        else:
            delta = pos - ln["start"]
            s = float(delta @ ln["direction"])
            lat = float(delta @ ln["dirlat"])
            if ln["kind"] == SINE:
                lat -= ln["amp"] * math.sin(ln["puls"] * s + ln["phase"])
        return abs(lat) + max(s - ln["length"], 0.0) + max(-s, 0.0)

    def shortest_path(self, start, goal):
        """BFS over edge nodes (official_road.cc:228-251)."""
        queue = [[start]]
        while queue:
            path = queue.pop(0)
            for (f, t) in self._edges:
                if f != path[-1] or t in path:
                    continue
                if t == goal:
                    return path + [t]
                queue.append(path + [t])
        return []

    def default_next(self, k):
        """Geometric successor of lane k (official_road.cc:93-135)."""
        _, to = self._lanes[k]["edge"]
        end = self._np_position(k, self._lanes[k]["length"], 0.0)
        best, best_d = k, None
        for (f, t), ids in self._edges.items():
            if f != to:
                continue
            cur = self._edges[self._lanes[k]["edge"]]
            if len(ids) == len(cur):
                cand = [ids[cur.index(k)]]
            else:
                cand = ids
            for c in cand:
                d = self._np_distance(c, end)
                if best_d is None or d < best_d:
                    best, best_d = c, d
        return best

    def route_next(self, k, dest):
        """Successor of lane k on the shortest path to node ``dest``."""
        _, to = self._lanes[k]["edge"]
        path = self.shortest_path(to, dest)
        if len(path) < 2:
            return self.default_next(k)
        nxt_edge = (path[0], path[1])
        ids = self._edges[nxt_edge]
        cur = self._edges[self._lanes[k]["edge"]]
        if len(ids) == len(cur):
            return ids[cur.index(k)]
        end = self._np_position(k, self._lanes[k]["length"], 0.0)
        return min(ids, key=lambda c: self._np_distance(c, end))

    def lane_table(self):
        """Pack the lane list into a struct-of-arrays dict (numpy)."""
        K = len(self._lanes)
        tab = {
            "kind": np.array([l["kind"] for l in self._lanes], np.int32),
            "start": np.stack([l["start"] for l in self._lanes]),
            "dir": np.stack([l["direction"] for l in self._lanes]),
            "dirlat": np.stack([l["dirlat"] for l in self._lanes]),
            "heading": np.array([l["heading"] for l in self._lanes]),
            "length": np.array([l["length"] for l in self._lanes]),
            "width": np.array([l["width"] for l in self._lanes]),
            "speed_limit": np.array(
                [l["speed_limit"] for l in self._lanes]),
            "priority": np.array(
                [l["priority"] for l in self._lanes], np.int32),
            "forbidden": np.array(
                [l["forbidden"] for l in self._lanes], bool),
            "amp": np.array([l["amp"] for l in self._lanes]),
            "puls": np.array([l["puls"] for l in self._lanes]),
            "phase": np.array([l["phase"] for l in self._lanes]),
            "center": np.stack([l["center"] for l in self._lanes]),
            "radius": np.array([l["radius"] for l in self._lanes]),
            "sphase": np.array([l["sphase"] for l in self._lanes]),
            "cdir": np.array([l["cdir"] for l in self._lanes]),
        }
        # Segment (edge) grouping for side-lane moves / AllSideLanes.
        lane_id = np.zeros(K, np.int32)
        seg_count = np.zeros(K, np.int32)
        seg_idx = np.zeros(K, np.int32)
        for si, ((f, t), ids) in enumerate(self._edges.items()):
            for j, k in enumerate(ids):
                lane_id[k] = j
                seg_count[k] = len(ids)
                seg_idx[k] = si
        max_ids = max(len(ids) for ids in self._edges.values())
        seg_lane = -np.ones((K, max_ids), np.int32)
        for (f, t), ids in self._edges.items():
            for k in ids:
                for j, kk in enumerate(ids):
                    seg_lane[k, j] = kk
        tab["lane_id"] = lane_id
        tab["seg_count"] = seg_count
        tab["seg_idx"] = seg_idx
        tab["seg_lane"] = seg_lane
        # Segment-level connectivity within 3 hops (IsConnectedRoad,
        # official_road.cc:170-196, route arg over-approximated by all
        # outgoing edges).
        S = len(self._edges)
        edges = list(self._edges)
        adj = np.zeros((S, S), bool)
        for i, (f1, t1) in enumerate(edges):
            for j, (f2, t2) in enumerate(edges):
                if t1 == f2:
                    adj[i, j] = True
        conn = np.eye(S, dtype=bool) | adj
        reach = conn.copy()
        for _ in range(2):
            reach = reach | (reach @ adj)
        conn_seg = reach | adj
        tab["conn_seg"] = conn_seg
        return tab


def _np_wrap_pi(x: float) -> float:
    """``wrap_pi`` of one Python float, in float64."""
    return (x + _PI) % (2.0 * _PI) - _PI


# ---------------------------------------------------------------------------
# The lane table on a device, and the lane geometry (official_lane.cc:97-160)
# ---------------------------------------------------------------------------

# The float columns of LaneTable.geo.
_GEO = ("start_x", "start_y", "dir_x", "dir_y", "dirlat_x", "dirlat_y", "heading",
        "length", "width", "speed_limit", "amp", "puls", "phase", "center_x",
        "center_y", "radius", "sphase", "cdir")
_COL = {k: i for i, k in enumerate(_GEO)}


class LaneTable:
    """The static lane table of one road on ``device``: the float columns
    in float32 (JAX's ``_static`` casts them so) as one ``[K, 18]`` tensor,
    gathered per lane at once, and the integer tables."""

    def __init__(self, tab: dict, device: torch.device):
        cols = {
            "start_x": tab["start"][:, 0], "start_y": tab["start"][:, 1],
            "dir_x": tab["dir"][:, 0], "dir_y": tab["dir"][:, 1],
            "dirlat_x": tab["dirlat"][:, 0], "dirlat_y": tab["dirlat"][:, 1],
            "center_x": tab["center"][:, 0], "center_y": tab["center"][:, 1],
        }
        geo = np.stack([np.asarray(cols.get(k, tab.get(k)), np.float64) for k in _GEO], 1)
        self.geo = torch.as_tensor(geo.astype(np.float32), device=device)
        self.K = geo.shape[0]

        def i32(name):
            return torch.as_tensor(np.asarray(tab[name], np.int32), device=device)

        self.kind = i32("kind")
        self.priority = i32("priority")
        self.lane_id = i32("lane_id")
        self.seg_count = i32("seg_count")
        self.seg_idx = i32("seg_idx")
        self.seg_lane = i32("seg_lane")
        self.forbidden = torch.as_tensor(np.asarray(tab["forbidden"]), device=device)
        self.conn_seg = torch.as_tensor(np.asarray(tab["conn_seg"]), device=device)
        self.kinds = set(int(k) for k in np.asarray(tab["kind"]))

    def col(self, name: str) -> torch.Tensor:
        """``[K]``: one float column."""
        return self.geo[:, _COL[name]]


class Lanes:
    """The float columns of the lanes ``lane`` (any index shape), gathered
    once, as attributes of that shape; ``lane=None``: all ``K`` lanes, as
    ``[K]`` columns."""

    def __init__(self, T: LaneTable, lane: torch.Tensor | None):
        g = T.geo if lane is None else T.geo[lane.long()]
        self.kind = T.kind if lane is None else T.kind[lane.long()]
        self.T = T
        for k, i in _COL.items():
            setattr(self, k, g[..., i])


def lane_frame(T: LaneTable, pos: torch.Tensor):
    """``(s, lat)``, each ``[..., K]``: every point of ``pos`` ``[..., 2]``
    in the frame of every lane (``lane_local`` of the JAX package, for all
    lanes at once)."""
    ln = Lanes(T, None)
    px, py = pos[..., 0, None], pos[..., 1, None]
    dx, dy = px - ln.start_x, py - ln.start_y
    s = dx * ln.dir_x + dy * ln.dir_y
    lat = dx * ln.dirlat_x + dy * ln.dirlat_y
    if SINE in T.kinds:
        off = ln.amp * sin(ln.puls * s + ln.phase)
        lat = lat - torch.where(ln.kind == SINE, off, 0.0)
    if CIRCULAR in T.kinds:
        cx, cy = px - ln.center_x, py - ln.center_y
        phi = atan2(cy, cx)
        phi = ln.sphase + wrap_pi(phi - ln.sphase)
        s_c = ln.cdir * (phi - ln.sphase) * ln.radius
        lat_c = ln.cdir * (ln.radius - torch.sqrt(cx * cx + cy * cy))
        circ = ln.kind == CIRCULAR
        s = torch.where(circ, s_c, s)
        lat = torch.where(circ, lat_c, lat)
    return s, lat


def frame_at(frame, lane: torch.Tensor, rows: torch.Tensor | None = None):
    """``(s, lat)`` of vehicle ``rows`` in lane ``lane`` (both ``[N, ...]``;
    ``rows`` None: the query's own row, the last axis being the ``V``
    rows), gathered from a :func:`lane_frame` of ``[N, V, K]``."""
    s, lat = frame
    n, v, k = s.shape
    if rows is None:
        rows = torch.arange(v, device=lane.device).expand_as(lane)
    flat = (rows.long() * k + lane.long()).reshape(n, -1)
    shape = lane.shape
    return (s.reshape(n, v * k).gather(1, flat).reshape(shape),
            lat.reshape(n, v * k).gather(1, flat).reshape(shape))


def frame_pairs(frame, lane: torch.Tensor):
    """``(s, lat)`` ``[N, ..., V]``: every vehicle in the lane of each query
    (``lane`` ``[N, ...]``), from a :func:`lane_frame`."""
    s, lat = frame
    n, v, _ = s.shape
    idx = lane.long().reshape(n, -1, 1).expand(n, lane[0].numel(), v)
    shape = (*lane.shape, v)
    return (s.transpose(1, 2).gather(1, idx).reshape(shape),
            lat.transpose(1, 2).gather(1, idx).reshape(shape))


def lane_position(T: LaneTable, lane: torch.Tensor | None, s: torch.Tensor,
                  lat: torch.Tensor) -> torch.Tensor:
    """``[..., 2]``: the point at ``(s, lat)`` of ``lane`` (None: every lane,
    on the last axis of ``s``)."""
    ln = Lanes(T, lane)
    kinds = T.kinds
    lat_s = lat
    if SINE in kinds:
        off = ln.amp * sin(ln.puls * s + ln.phase)
        lat_s = lat + torch.where(ln.kind == SINE, off, 0.0)
    px = ln.start_x + s * ln.dir_x + lat_s * ln.dirlat_x
    py = ln.start_y + s * ln.dir_y + lat_s * ln.dirlat_y
    if CIRCULAR in kinds:
        phi = ln.cdir * s / ln.radius + ln.sphase
        r = ln.radius - lat * ln.cdir
        circ = ln.kind == CIRCULAR
        px = torch.where(circ, ln.center_x + r * cos(phi), px)
        py = torch.where(circ, ln.center_y + r * sin(phi), py)
    return torch.stack([px, py], -1)


def lane_heading_at(T: LaneTable, lane: torch.Tensor | None, s: torch.Tensor) -> torch.Tensor:
    ln = Lanes(T, lane)
    kinds = T.kinds
    h = ln.heading
    if SINE in kinds:
        h_sine = ln.heading + atan(
            ln.amp * ln.puls * cos(ln.puls * s + ln.phase))
        h = torch.where(ln.kind == SINE, h_sine, h)
    if CIRCULAR in kinds:
        phi = ln.cdir * s / ln.radius + ln.sphase
        h = torch.where(ln.kind == CIRCULAR, phi + f32(_PI / 2.0) * ln.cdir, h)
    return h.expand_as(s) if h.shape != s.shape else h


def closest_lane(T: LaneTable, frame, heading: torch.Tensor) -> torch.Tensor:
    """``[N, V]`` int32: argmin over the K lanes of the distance with
    heading (``GetClosestLaneIndex``), the first lane on ties; ``frame`` is
    the :func:`lane_frame` of the positions."""
    s, lat = frame
    d = (lat.abs() + torch.clamp_min(s - T.col("length"), 0.0)
         + torch.clamp_min(-s, 0.0))
    angle = wrap_pi(heading[..., None] - lane_heading_at(T, None, s)).abs()
    return torch.argmin(d + angle, -1).to(torch.int32)


def on_lane(T: LaneTable, lane: torch.Tensor, s: torch.Tensor, lat: torch.Tensor,
            margin: float = 0.0) -> torch.Tensor:
    width = T.col("width")[lane.long()]
    length = T.col("length")[lane.long()]
    return ((lat.abs() <= width / 2.0 + margin)
            & (s >= -VEH_LEN) & (s < length + VEH_LEN))


def is_reachable(T: LaneTable, lane: torch.Tensor, s: torch.Tensor,
                 lat: torch.Tensor) -> torch.Tensor:
    width = T.col("width")[lane.long()]
    length = T.col("length")[lane.long()]
    return (~T.forbidden[lane.long()] & (lat.abs() <= 2.0 * width)
            & (s >= 0.0) & (s < length + VEH_LEN))


def after_end(T: LaneTable, lane: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return s > T.col("length")[lane.long()] - VEH_LEN / 2.0


# ---------------------------------------------------------------------------
# Controls (official_vehicle.cc:229-263)
# ---------------------------------------------------------------------------


def steering_control(T: LaneTable, target_lane, s, lat, heading, speed):
    """Pure-pursuit steering toward ``target_lane``, from the vehicle's
    ``(s, lat)`` in it."""
    lane_future_heading = lane_heading_at(
        T, target_lane.long(), s + speed * f32(_TAU_PURSUIT))
    lat_cmd = f32(-_KP_LATERAL) * lat
    heading_cmd = asin(torch.clamp(lat_cmd / notzero(speed), -1.0, 1.0))
    heading_ref = lane_future_heading + torch.clamp(heading_cmd, f32(-_PI / 4.0),
                                                    f32(_PI / 4.0))
    rate_cmd = f32(_KP_HEADING) * wrap_pi(heading_ref - heading)
    slip = asin(torch.clamp(
        f32(VEH_LEN / 2.0) / notzero(speed) * rate_cmd, -1.0, 1.0))
    return torch.clamp(atan(2.0 * tan(slip)), f32(-_MAX_STEER), f32(_MAX_STEER))


def speed_to_index(target_speeds: tuple, speed: torch.Tensor) -> torch.Tensor:
    lo, hi = np.float32(target_speeds[0]), np.float32(target_speeds[-1])
    x = (speed - float(lo)) * f32(1.0 / float(hi - lo))  # XLA folds / span
    n = len(target_speeds)
    return torch.clamp(torch.round(x * (n - 1)).to(torch.int32), 0, n - 1)


# ---------------------------------------------------------------------------
# Collision (rotated-rect SAT, the shape of straight.py's)
# ---------------------------------------------------------------------------


def collide(x, y, heading, vx, vy, length, width, dt, eye):
    """``[N, V]`` crashed now, by batched SAT with velocity lookahead over
    every pair (``BoxesCollide``, official_scene.cc:150-220), the four
    separating axes stacked on one axis; ``length`` and ``width`` ``[V]``
    per row, ``eye`` the ``[V, V]`` diagonal."""
    n, v = x.shape
    c, s = cos(heading), sin(heading)
    hl, hw = length / 2.0, width / 2.0
    dispx, dispy = vx * dt, vy * dt
    dxm = x[:, None, :] - x[:, :, None]
    dym = y[:, None, :] - y[:, :, None]
    ddx = dispx[:, :, None] - dispx[:, None, :]
    ddy = dispy[:, :, None] - dispy[:, None, :]
    ci, si = c[:, :, None], s[:, :, None]
    cj, sj = c[:, None, :], s[:, None, :]
    acosd = (ci * cj + si * sj).abs()
    asind = (si * cj - ci * sj).abs()
    hli, hwi = hl[:, None], hw[:, None]
    hlj, hwj = hl[None, :], hw[None, :]
    def cat(*ts):
        return torch.cat([t.expand(n, v, v)[:, None] for t in ts], 1)

    # (axis, r_i, r_j) of the axes dir_i, perp_i, dir_j, perp_j
    ux = cat(ci, -si, cj, -sj)
    uy = cat(si, ci, sj, cj)
    ri = cat(hli, hwi, hli * acosd + hwi * asind, hli * asind + hwi * acosd)
    rj = cat(hlj * acosd + hwj * asind, hlj * asind + hwj * acosd, hlj, hwj)
    p = ux * dxm[:, None] + uy * dym[:, None]
    vp = ux * ddx[:, None] + uy * ddy[:, None]
    al = -ri + torch.clamp_max(vp, 0.0)
    ah = ri + torch.clamp_min(vp, 0.0)
    dist = torch.where(al < p - rj, p - rj - ah, al - (p + rj))
    will = (dist <= 0.0).all(1)
    diag = torch.sqrt(length * length + width * width)
    dist_centers = torch.sqrt(dxm * dxm + dym * dym)
    near = (dist_centers
            <= (diag[:, None] + diag[None, :]) / 2.0
            + torch.sqrt(dispx * dispx + dispy * dispy)[:, :, None] + 1.0)
    return (will & near & ~eye).any(-1)
