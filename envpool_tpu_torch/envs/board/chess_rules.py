"""Chess rules on ``[N, S]`` boards of any square size, batched: the
move tables, attack maps by shift flood fills, checkers and pins, and
the pseudo-legal move mask with king safety, check evasion and pins.

Shared by ``chess.py`` (8x8, 73 planes) and ``gardner_chess.py`` (5x5, 49
planes), counterparts of ``envpool_tpu/envs/board/chess.py`` and
``gardner_chess.py``, whose analytic legality (no make/unmake per move)
this follows step for step.  A board is int8, current-player-positive
(1 P, 2 N, 3 B, 4 R, 5 Q, 6 K), ``sq = row * n + col`` with row 0 the
mover's back rank.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...ops.batched import first_argmax
from .common import rows

P, N, B, R, Q, K = 1, 2, 3, 4, 5, 6

QUEEN_DIRS = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))
KNIGHT_D = ((2, 1), (1, 2), (-1, 2), (-2, 1), (-2, -1), (-1, -2), (1, -2), (2, -1))
_UNDER_DIRS = ((1, 0), (1, -1), (1, 1))
_UNDER_PIECES = (N, B, R)


class Geometry:
    """The static move tables of an ``n`` x ``n`` board: ``planes`` =
    8 queen directions x (n - 1) distances, 8 knight jumps, 9
    underpromotions (from row n - 2)."""

    def __init__(self, n: int):
        self.n = n
        self.nsq = n * n
        ride = n - 1
        self.knight0 = 8 * ride
        self.under0 = self.knight0 + 8
        self.planes = self.under0 + 9
        to_sq = np.full((self.nsq, self.planes), -1, np.int64)
        path = np.zeros((self.nsq, self.planes, self.nsq), bool)
        for sq in range(self.nsq):
            r, c = divmod(sq, n)
            for d, (dr, dc) in enumerate(QUEEN_DIRS):
                for dist in range(1, n):
                    rr, cc = r + dr * dist, c + dc * dist
                    if not (0 <= rr < n and 0 <= cc < n):
                        break
                    plane = d * ride + (dist - 1)
                    to_sq[sq, plane] = rr * n + cc
                    for mid in range(1, dist):
                        path[sq, plane, (r + dr * mid) * n + (c + dc * mid)] = True
            for kd, (dr, dc) in enumerate(KNIGHT_D):
                rr, cc = r + dr, c + dc
                if 0 <= rr < n and 0 <= cc < n:
                    to_sq[sq, self.knight0 + kd] = rr * n + cc
            if r == n - 2:
                for ui, (dr, dc) in enumerate(_UNDER_DIRS):
                    for pi in range(3):
                        rr, cc = r + dr, c + dc
                        if 0 <= cc < n:
                            to_sq[sq, self.under0 + ui * 3 + pi] = rr * n + cc
        plane_dir = np.full(self.planes, -1, np.int64)
        plane_dist = np.zeros(self.planes, np.int64)
        for d in range(8):
            for dist in range(1, n):
                plane_dir[d * ride + dist - 1] = d
                plane_dist[d * ride + dist - 1] = dist
        is_knight = np.zeros(self.planes, bool)
        is_knight[self.knight0:self.under0] = True
        is_under = np.zeros(self.planes, bool)
        is_under[self.under0:] = True
        under_piece = np.zeros(self.planes, np.int64)
        under_dir = np.zeros(self.planes, np.int64)
        for ui in range(3):
            for pi in range(3):
                under_piece[self.under0 + ui * 3 + pi] = _UNDER_PIECES[pi]
                under_dir[self.under0 + ui * 3 + pi] = ui
        self.np = {"to_sq": to_sq, "path": path, "plane_dir": plane_dir,
                   "plane_dist": plane_dist, "is_knight": is_knight, "is_under": is_under,
                   "under_piece": under_piece, "under_dir": under_dir}

    @functools.lru_cache(maxsize=None)
    def on(self, device: torch.device) -> dict:
        """The tables as tensors on ``device`` (``path`` as a float
        ``[S * planes, S]`` matrix for one product per board)."""
        t = {k: torch.as_tensor(v).to(device) for k, v in self.np.items()}
        t["path_f"] = t["path"].reshape(-1, self.nsq).to(torch.float32)
        return t

    # -- attack maps -----------------------------------------------------

    def shift(self, mask: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
        """``[N, S]``: the mask moved by ``(dr, dc)`` (``jnp.roll`` with
        the wrapped rows and columns cleared)."""
        n = self.n
        m = mask.reshape(-1, n, n)
        out = torch.zeros_like(m)
        rs = slice(0, n - dr) if dr >= 0 else slice(-dr, n)
        rd = slice(dr, n) if dr >= 0 else slice(0, n + dr)
        cs = slice(0, n - dc) if dc >= 0 else slice(-dc, n)
        cd = slice(dc, n) if dc >= 0 else slice(0, n + dc)
        out[:, rd, cd] = m[:, rs, cs]
        return out.reshape(mask.shape)

    def _slide(self, source, empty, dr, dc):
        att = torch.zeros_like(source)
        frontier = source
        for _ in range(self.n - 1):
            frontier = self.shift(frontier, dr, dc)
            att = att | frontier
            frontier = frontier & empty
        return att

    def attacked_by_them(self, board: torch.Tensor) -> torch.Tensor:
        """``[N, S]``: the squares the opponent's pieces attack."""
        empty = board == 0
        rooks = (board == -R) | (board == -Q)
        bishops = (board == -B) | (board == -Q)
        att = torch.zeros_like(empty)
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            att = att | self._slide(rooks, empty, dr, dc)
        for dr, dc in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            att = att | self._slide(bishops, empty, dr, dc)
        kn = board == -N
        for dr, dc in KNIGHT_D:
            att = att | self.shift(kn, dr, dc)
        kg = board == -K
        for dr, dc in QUEEN_DIRS:
            att = att | self.shift(kg, dr, dc)
        pw = board == -P
        return att | self.shift(pw, -1, -1) | self.shift(pw, -1, 1)

    def checkers_and_pins(self, board: torch.Tensor, king_sq: torch.Tensor):
        """``(checkers [N, S], pinned [N, S], pin_line [N, S, S],
        check_line [N, S])``: the squares that block or capture a single
        check, and for a piece pinned at ``p`` its allowed destinations."""
        b, s = board.shape
        empty = board == 0
        sq = torch.arange(s, device=board.device)
        king = sq == king_sq[:, None]
        checkers = torch.zeros_like(empty)
        check_line = torch.zeros_like(empty)
        pinned = torch.zeros_like(empty)
        pin_line = torch.zeros((b, s, s), dtype=torch.bool, device=board.device)
        for dr, dc in KNIGHT_D:
            checkers = checkers | (self.shift(king, dr, dc) & (board == -N))
        for dc in (-1, 1):
            checkers = checkers | (self.shift(king, 1, dc) & (board == -P))
        for dr, dc in QUEEN_DIRS:
            diag = dr != 0 and dc != 0
            slider = (board == -Q) | (board == (-B if diag else -R))
            frontier = king
            own_seen = torch.zeros_like(empty)
            own_count = torch.zeros(b, dtype=torch.int32, device=board.device)
            line = torch.zeros_like(empty)
            done = torch.zeros(b, dtype=torch.bool, device=board.device)
            checker_here = torch.zeros_like(empty)
            pin_here = torch.zeros_like(empty)
            for _ in range(self.n - 1):
                frontier = self.shift(frontier, dr, dc)
                occ_own = frontier & (board > 0)
                occ_opp = frontier & (board < 0)
                hit_slider = occ_opp & slider
                any_own, any_opp, any_slider = (x.any(1) for x in (occ_own, occ_opp, hit_slider))
                is_check = (any_slider & (own_count == 0) & ~done)[:, None]
                checker_here = checker_here | (is_check & hit_slider)
                check_line = check_line | (is_check & line)
                is_pin = (any_slider & (own_count == 1) & ~done)[:, None]
                pin_here = pin_here | (is_pin & own_seen)
                pin_line_d = is_pin & (line | hit_slider)
                pin_line = pin_line | (is_pin[:, :, None] & own_seen[:, :, None]
                                       & pin_line_d[:, None, :])
                own_count = own_count + (any_own & ~done).to(torch.int32)
                own_seen = torch.where((any_own & ~done & (own_count == 1))[:, None], occ_own,
                                       own_seen)
                line = line | (~done[:, None] & frontier & empty)
                done = done | (any_opp & ~any_slider) | any_slider | (own_count >= 2)
                frontier = frontier & (empty | occ_own)
            checkers = checkers | checker_here
            pinned = pinned | pin_here
        return checkers, pinned, pin_line, check_line | checkers

    def pseudo_mask(self, board: torch.Tensor, double_push: bool, ep_sq=None):
        """``(mask [N, S, planes], info)``: moves legal but for castling and
        the en passant discovered check (``legal_action_mask`` up to its
        castling lines), with what the callers need in ``info``."""
        t = self.on(board.device)
        b, s = board.shape
        n = self.n
        king_sq = first_argmax((board == K).to(torch.int8))
        no_king = board.clone()
        no_king[rows(board), king_sq] = 0
        attacked_xray = self.attacked_by_them(no_king)
        checkers, pinned, pin_line, check_line = self.checkers_and_pins(board, king_sq)
        n_checkers = checkers.sum(1)
        in_check = (n_checkers > 0)[:, None, None]
        double_check = (n_checkers > 1)[:, None, None]
        to = t["to_sq"]                                              # [S, planes]
        valid_to = to >= 0
        to_c = to.clamp(0, s - 1)
        frm = torch.arange(s, device=board.device)[:, None]
        pc = board[:, :, None].expand(b, s, self.planes)            # piece on the from square
        dest = board[:, to_c]
        occ = (board != 0).to(torch.float32)
        path_clear = (occ @ t["path_f"].T).reshape(b, s, self.planes) == 0
        plane_dir, plane_dist = t["plane_dir"], t["plane_dist"]
        is_knightp, is_underp, under_dir = t["is_knight"], t["is_under"], t["under_dir"]
        row = frm // n
        diag = (plane_dir % 2) == 1
        ortho = (plane_dir % 2) == 0
        qmove = (((pc == Q) & (plane_dir >= 0)) | ((pc == R) & ortho & (plane_dir >= 0))
                 | ((pc == B) & diag & (plane_dir >= 0))
                 | ((pc == K) & (plane_dir >= 0) & (plane_dist == 1)))
        fwd1 = (pc == P) & (plane_dir == 0) & (plane_dist == 1)
        cap = (pc == P) & ((plane_dir == 1) | (plane_dir == 7)) & (plane_dist == 1)
        info = {"king_sq": king_sq}
        if double_push:
            fwd2 = (pc == P) & (plane_dir == 0) & (plane_dist == 2) & (row == 1)
            ep_to = torch.where(ep_sq >= 0, ep_sq, 0)[:, None, None]
            is_ep = cap & (to_c == ep_to) & (ep_sq >= 0)[:, None, None]
            pawn_ok = ((fwd1 & (dest == 0)) | (fwd2 & (dest == 0) & path_clear)
                       | (cap & ((dest < 0) | is_ep)))
            info.update(is_ep=is_ep, ep_to=ep_to[:, 0, 0])
        else:
            pawn_ok = (fwd1 & (dest == 0)) | (cap & (dest < 0))
        under_ok = (is_underp & (pc == P) & (row == n - 2)
                    & torch.where(under_dir == 0, dest == 0, dest < 0))
        knight_ok = is_knightp & (pc == N)
        pseudo = valid_to & ~(dest > 0) & (
            (qmove & path_clear & ~(pc == P)) | pawn_ok | knight_ok | under_ok)
        pseudo = pseudo & (pc > 0)
        if double_push:
            pseudo = pseudo & ~((pc != P) & is_underp)
        king_move = pc == K
        pseudo = pseudo & torch.where(king_move, ~attacked_xray[:, to_c], True)
        on_line = check_line[:, to_c] | checkers[:, to_c]
        if double_push:
            ep_capture_sq = (info["ep_to"] - n).clamp(0, s - 1)
            ep_evades = info["is_ep"] & checkers[rows(board), ep_capture_sq][:, None, None]
            on_line = on_line | ep_evades
        pseudo = pseudo & torch.where(in_check & ~king_move, on_line, True)
        pseudo = pseudo & torch.where(double_check, king_move, True)
        pin_dest_ok = pin_line[:, frm, to_c]                         # [N, S, planes]
        pseudo = pseudo & torch.where(pinned[:, :, None], pin_dest_ok, True)
        info["in_check"] = in_check[:, 0, 0]
        return pseudo, info
