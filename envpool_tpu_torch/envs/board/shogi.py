"""Shogi, batched over ``[N]`` boards.

Counterpart of ``envpool_tpu/envs/board/shogi.py`` (pgx surface;
reference ``envpool/pgx/shogi.h``): obs ``(9, 9, 119)`` bool, 2187
actions = 27 planes x 81 destinations (planes 0-9 board moves by the
direction from the destination to the mover, 10-19 the same with
promotion, 20-26 drops of P/L/N/S/G/B/R), +-1 at checkmate or an illegal
move, 0 on fourfold repetition and the ply limit.  Legality is the JAX
game's closed masked form step for step: nearest-piece scans per
destination, analytic checks and pins, mandatory promotion, nifu, the
last-rank drops and drop-pawn mate.

The repetition window holds JAX's uint32 position hashes as int32 of the
same bits (``chess.py``'s note); the tables come from the same
``np.random.default_rng`` seed.  The seats are drawn at the reset.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from ...ops.batched import const, first_argmax
from .common import BoardEnv, first_row_action, rows, seat_rewards, shift2d, u32_table, uint32_hash

__all__ = ["ShogiEnv", "legal_action_mask", "apply_action", "flip", "board_hash"]

_N = 9
_NSQ = 81
NUM_ACTIONS = 27 * 81  # 2187

P, L, NK, S, G, B, R, K = 1, 2, 3, 4, 5, 6, 7, 8
PP, PL, PN, PS, PB, PR = 9, 10, 11, 12, 13, 14
_GOLD_LIKE = (G, PP, PL, PN, PS)
_HAND_ORDER = (P, L, NK, S, G, B, R)  # drop planes 20..26
_RAY = ((-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1))
_KNIGHT_SRC = ((-2, -1), (-2, 1))
_KING_STEPS = ((1, 0), (1, 1), (1, -1), (0, 1), (0, -1), (-1, 0), (-1, 1), (-1, -1))


def _build_can():
    """CAN[piece, plane_dir (0..9), dist (1..8)] (``shogi.py::_build_can``)."""
    can = np.zeros((15, 10, 9), bool)

    def allow(piece, move_dr, move_dc, max_dist):
        for d in range(8):
            if _RAY[d] == (-move_dr, -move_dc):
                for dist in range(1, max_dist + 1):
                    can[piece, d, dist] = True

    for piece, moves, slides in (
        (P, [(1, 0)], []),
        (L, [], [(1, 0)]),
        (S, [(1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)], []),
        (B, [], [(1, 1), (1, -1), (-1, 1), (-1, -1)]),
        (R, [], [(1, 0), (-1, 0), (0, 1), (0, -1)]),
        (K, [(1, 0), (1, 1), (1, -1), (0, 1), (0, -1), (-1, 0), (-1, 1), (-1, -1)], []),
        (PB, [(1, 0), (-1, 0), (0, 1), (0, -1)], [(1, 1), (1, -1), (-1, 1), (-1, -1)]),
        (PR, [(1, 1), (1, -1), (-1, 1), (-1, -1)], [(1, 0), (-1, 0), (0, 1), (0, -1)]),
    ):
        for mv in moves:
            allow(piece, mv[0], mv[1], 1)
        for sl in slides:
            allow(piece, sl[0], sl[1], 8)
    for piece in _GOLD_LIKE:
        for mv in ((1, 0), (1, 1), (1, -1), (0, 1), (0, -1), (-1, 0)):
            allow(piece, mv[0], mv[1], 1)
    can[NK, 8, 1] = True
    can[NK, 9, 1] = True
    return can


_CAN = _build_can()

_INIT = np.zeros(_NSQ, np.int8)
_INIT[0:9] = [L, NK, S, G, K, G, S, NK, L]
_INIT[10] = B
_INIT[16] = R
_INIT[18:27] = P
_INIT[54:63] = -P
_INIT[64] = -R
_INIT[70] = -B
_INIT[72:81] = [-L, -NK, -S, -G, -K, -G, -S, -NK, -L]

_REP_HIST = 64
_rng = np.random.default_rng(9999)
_HASH_PIECE = _rng.integers(1, 2**32, size=(29, _NSQ), dtype=np.uint32)
_HASH_HAND = _rng.integers(1, 2**32, size=(2, 7, 19), dtype=np.uint32)

_BASE = (0, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 4, 6, 7)
_HAND_IDX = (0, 0, 1, 2, 3, 4, 5, 6, 0)
_PROMOTED = (0, PP, PL, PN, PS, 0, PB, PR, 0, 0, 0, 0, 0, 0, 0)


@functools.lru_cache(maxsize=None)
def _t(device: torch.device) -> dict:
    out = {k: torch.as_tensor(np.asarray(v, np.int64)).to(device) for k, v in (
        ("base", _BASE), ("hand_idx", _HAND_IDX), ("promoted", _PROMOTED),
        ("hand_order", _HAND_ORDER))}
    out["can"] = torch.as_tensor(_CAN).to(device)
    out["hash_piece"] = u32_table(_HASH_PIECE).to(device)
    out["hash_hand"] = u32_table(_HASH_HAND).to(device)
    return out


def _shift(mask: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """``[N, 81]`` mask moved by ``(dr, dc)`` (``jnp.roll`` with the
    wrapped rows and columns cleared)."""
    return shift2d(mask.reshape(-1, _N, _N), -dr, -dc, False).reshape(mask.shape)


def _slide(source, empty, dr, dc):
    att = torch.zeros_like(source)
    frontier = source
    for _ in range(_N - 1):
        frontier = _shift(frontier, dr, dc)
        att = att | frontier
        frontier = frontier & empty
    return att


def _has(board, pieces, sign=-1):
    m = torch.zeros_like(board, dtype=torch.bool)
    for p in pieces:
        m = m | (board == sign * p)
    return m


def attacked_by_them(board: torch.Tensor) -> torch.Tensor:
    """``[N, 81]``: the squares the opponent's pieces (moving down) attack."""
    empty = board == 0
    att = _shift(_has(board, (P,)), -1, 0)
    kn = _has(board, (NK,))
    att = att | _shift(kn, -2, -1) | _shift(kn, -2, 1)
    sil = _has(board, (S,))
    for dr, dc in ((-1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1)):
        att = att | _shift(sil, dr, dc)
    gold = _has(board, _GOLD_LIKE)
    for dr, dc in ((-1, 0), (-1, -1), (-1, 1), (0, -1), (0, 1), (1, 0)):
        att = att | _shift(gold, dr, dc)
    kng = _has(board, (K,))
    for dr, dc in ((-1, 0), (-1, -1), (-1, 1), (0, -1), (0, 1), (1, 0), (1, -1), (1, 1)):
        att = att | _shift(kng, dr, dc)
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        att = att | _shift(_has(board, (PB,)), dr, dc)
    for dr, dc in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        att = att | _shift(_has(board, (PR,)), dr, dc)
    att = att | _slide(_has(board, (L,)), empty, -1, 0)
    bish = _has(board, (B, PB))
    for dr, dc in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        att = att | _slide(bish, empty, dr, dc)
    rook = _has(board, (R, PR))
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        att = att | _slide(rook, empty, dr, dc)
    return att


_RAY_SLIDERS = (((1, 0), (L, R, PR)), ((-1, 0), (R, PR)), ((0, 1), (R, PR)),
                ((0, -1), (R, PR)), ((1, 1), (B, PB)), ((1, -1), (B, PB)),
                ((-1, 1), (B, PB)), ((-1, -1), (B, PB)))


def checkers_and_pins(board: torch.Tensor, king_sq: torch.Tensor):
    """``(checkers, pinned, pin_line [N, 81, 81], check_line)``; the check
    line holds the blocking squares only (a checker is captured)."""
    n = board.shape[0]
    empty = board == 0
    sq = torch.arange(_NSQ, device=board.device)
    king = sq == king_sq[:, None]
    checkers = torch.zeros_like(empty)
    check_line = torch.zeros_like(empty)
    pinned = torch.zeros_like(empty)
    pin_line = torch.zeros((n, _NSQ, _NSQ), dtype=torch.bool, device=board.device)
    for pieces, offsets in (
        ((P,), ((-1, 0),)),
        ((NK,), ((-2, -1), (-2, 1))),
        ((S,), ((-1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1))),
        (_GOLD_LIKE, ((-1, 0), (-1, -1), (-1, 1), (0, -1), (0, 1), (1, 0))),
        ((PB,), ((-1, 0), (1, 0), (0, -1), (0, 1))),
        ((PR,), ((-1, -1), (-1, 1), (1, -1), (1, 1))),
    ):
        m = _has(board, pieces)
        for dr, dc in offsets:
            checkers = checkers | (_shift(king, -dr, -dc) & m)
    for (dr, dc), pieces in _RAY_SLIDERS:
        slider = _has(board, pieces)
        frontier = king
        own_seen = torch.zeros_like(empty)
        own_count = torch.zeros(n, dtype=torch.int32, device=board.device)
        line = torch.zeros_like(empty)
        done = torch.zeros(n, dtype=torch.bool, device=board.device)
        for _ in range(_N - 1):
            frontier = _shift(frontier, dr, dc)
            occ_own = frontier & (board > 0)
            occ_opp = frontier & (board < 0)
            hit = occ_opp & slider
            any_own, any_opp, any_hit = (x.any(1) for x in (occ_own, occ_opp, hit))
            is_check = (any_hit & (own_count == 0) & ~done)[:, None]
            checkers = checkers | (is_check & hit)
            check_line = check_line | (is_check & line)
            is_pin = (any_hit & (own_count == 1) & ~done)[:, None]
            pinned = pinned | (is_pin & own_seen)
            pl_d = is_pin & (line | hit)
            pin_line = pin_line | (is_pin[:, :, None] & own_seen[:, :, None] & pl_d[:, None, :])
            own_count = own_count + (any_own & ~done).to(torch.int32)
            own_seen = torch.where((any_own & ~done & (own_count == 1))[:, None], occ_own,
                                   own_seen)
            line = line | (~done[:, None] & frontier & empty)
            done = done | (any_opp & ~any_hit) | any_hit | (own_count >= 2)
            frontier = frontier & (empty | occ_own)
    return checkers, pinned, pin_line, check_line


def _attacked_by_us_square(board, sq, pinned, pin_line) -> torch.Tensor:
    """``[N]``: can a piece of the mover (positive) capture on ``sq`` ``[N]``
    with its pin honoured (the drop-pawn-mate test)."""
    r = rows(board)
    target = torch.arange(_NSQ, device=board.device) == sq[:, None]
    empty = board == 0
    attackers = torch.zeros_like(empty)
    for pieces, offsets in (
        ((P,), ((1, 0),)),
        ((NK,), ((2, -1), (2, 1))),
        ((S,), ((1, 0), (1, -1), (1, 1), (-1, -1), (-1, 1))),
        (_GOLD_LIKE, ((1, 0), (1, -1), (1, 1), (0, -1), (0, 1), (-1, 0))),
        ((PB,), ((1, 0), (-1, 0), (0, -1), (0, 1))),
        ((PR,), ((1, -1), (1, 1), (-1, -1), (-1, 1))),
    ):
        m = _has(board, pieces, 1)
        for dr, dc in offsets:
            attackers = attackers | (_shift(target, -dr, -dc) & m)
    for (dr, dc), pieces in (((-1, 0), (L, R, PR)), ((1, 0), (R, PR)), ((0, 1), (R, PR)),
                             ((0, -1), (R, PR)), ((1, 1), (B, PB)), ((1, -1), (B, PB)),
                             ((-1, 1), (B, PB)), ((-1, -1), (B, PB))):
        attackers = attackers | (_slide(target, empty, -dr, -dc) & _has(board, pieces, 1))
    legal = attackers & (~pinned | pin_line[r, :, sq])
    return legal.any(1)


def _ray_scan(board: torch.Tensor, dr: int, dc: int):
    """``(piece, square, dist)`` ``[N, 81]`` each: the first non-empty
    square from every destination along ``(dr, dc)`` (square -1 and
    dist 0 where none)."""
    b2 = board.reshape(-1, _N, _N)
    to = torch.arange(_NSQ, device=board.device)
    piece = torch.zeros_like(board)
    src = torch.full(board.shape, -1, dtype=torch.int64, device=board.device)
    dist_arr = torch.zeros(board.shape, dtype=torch.int64, device=board.device)
    found = torch.zeros_like(board, dtype=torch.bool)
    inside = torch.ones((1, _N, _N), dtype=torch.bool, device=board.device)
    for dist in range(1, _N):
        shifted = shift2d(b2, dr * dist, dc * dist, 0).reshape(board.shape)
        valid = shift2d(inside, dr * dist, dc * dist, False).reshape(1, _NSQ)
        nonzero = (shifted != 0) & valid
        newly = nonzero & ~found
        piece = torch.where(newly, shifted, piece)
        src = torch.where(newly, to + (dr * _N + dc) * dist, src)
        dist_arr = torch.where(newly, dist, dist_arr)
        found = found | nonzero
    return piece, src, dist_arr


def legal_action_mask(board: torch.Tensor, hand: torch.Tensor) -> torch.Tensor:
    """``[N, 2187]`` legality, planes ``[27, 81]`` flattened plane-major."""
    t = _t(board.device)
    n = board.shape[0]
    r = rows(board)
    empty = board == 0
    occ_own = board > 0
    king_sq = first_argmax((board == K).to(torch.int8))
    no_king = board.clone()
    no_king[r, king_sq] = 0
    attacked_xray = attacked_by_them(no_king)
    checkers, pinned, pin_line, check_line = checkers_and_pins(board, king_sq)
    n_check = checkers.sum(1)
    in_check = (n_check > 0)[:, None]
    double_check = (n_check > 1)[:, None]
    to_idx = torch.arange(_NSQ, device=board.device)
    to_row = to_idx // _N
    move_masks, promo_masks = [], []
    for d in range(10):
        if d < 8:
            dr, dc = _RAY[d]
            src_piece, src_sq, dist_arr = _ray_scan(board, dr, dc)
            pc = src_piece.clamp(0, 14).long()
            ok = (src_piece > 0) & t["can"][pc, d, dist_arr.clamp(0, 8)] & ~occ_own
        else:
            dr, dc = _KNIGHT_SRC[d - 8]
            shifted = shift2d(board.reshape(-1, _N, _N), dr, dc, 0).reshape(board.shape)
            valid = shift2d(torch.ones((1, _N, _N), dtype=torch.bool, device=board.device),
                            dr, dc, False).reshape(1, _NSQ)
            ok = (shifted == NK) & valid & ~occ_own
            pc = torch.full(board.shape, NK, dtype=torch.int64, device=board.device)
            src_sq = torch.where(ok, to_idx + dr * _N + dc, -1)
        src_c = src_sq.clamp(0, _NSQ - 1)
        is_king = pc == K
        ok = ok & torch.where(is_king, ~attacked_xray, True)
        ok = ok & torch.where(in_check & ~is_king, check_line | checkers, True)
        ok = ok & torch.where(double_check, is_king, True)
        ok = ok & torch.where(pinned.gather(1, src_c), pin_line[r[:, None], src_c, to_idx], True)
        in_zone = (to_row >= 6) | (src_c // _N >= 6)
        promotable = (pc == P) | (pc == L) | (pc == NK) | (pc == S) | (pc == B) | (pc == R)
        promo_masks.append(ok & promotable & in_zone)
        dead = (((pc == P) | (pc == L)) & (to_row == 8)) | ((pc == NK) & (to_row >= 7))
        move_masks.append(ok & ~dead)

    pawn_files = (board == P).reshape(n, _N, _N).any(1)                 # [N, 9] per column
    drop_evade = torch.where(in_check, check_line, True) & ~double_check
    # Drop-pawn mate: the only checking square is right below the enemy
    # king; after the drop, can the opponent escape or capture?
    opp_k = first_argmax((board == -K).to(torch.int8))
    check_sq = opp_k - _N
    check_c = check_sq.clamp(0, _NSQ - 1)
    gives_check = (check_sq >= 0) & empty[r, check_c]
    b2 = board.clone()
    b2[r, check_c] = P
    fb = flip(b2)
    fk = first_argmax((fb == K).to(torch.int8))
    fb_no_king = fb.clone()
    fb_no_king[r, fk] = 0
    f_att = attacked_by_them(fb_no_king)
    kingm = to_idx == fk[:, None]
    esc = torch.zeros(n, dtype=torch.bool, device=board.device)
    for dr, dc in _KING_STEPS:
        esc = esc | (_shift(kingm, dr, dc) & (fb <= 0) & ~f_att).any(1)
    pawn_sq_f = (fk + _N).clamp(0, _NSQ - 1)
    _, fpin, fpinline, _ = checkers_and_pins(fb, fk)
    their_att_on_pawn = _attacked_by_us_square(fb_no_king, pawn_sq_f, fpin, fpinline)
    king_can_take = ~f_att[r, pawn_sq_f]
    mate = gives_check & ~esc & ~their_att_on_pawn & ~king_can_take
    drop_masks = []
    for hi, piece in enumerate(_HAND_ORDER):
        ok = empty & (hand[:, 0, hi] > 0)[:, None] & drop_evade
        if piece == P:
            ok = ok & ~pawn_files[:, to_idx % _N] & (to_row < 8)
            ok = ok & ~((to_idx == check_c[:, None]) & (mate & gives_check)[:, None])
        elif piece == L:
            ok = ok & (to_row < 8)
        elif piece == NK:
            ok = ok & (to_row < 7)
        drop_masks.append(ok)
    return torch.cat(move_masks + promo_masks + drop_masks, 1)


def apply_action(board: torch.Tensor, hand: torch.Tensor, action: torch.Tensor):
    """``(board, hand [N, 2, 7], was_drop)`` after ``action`` ``[N]``."""
    t = _t(board.device)
    r = rows(board)
    a = action.long()
    plane, to = a // _NSQ, a % _NSQ
    is_drop = plane >= 20
    promo = (plane >= 10) & (plane < 20)
    d = torch.where(is_drop, 0, plane % 10)
    r0, c0 = to // _N, to % _N
    src = torch.full_like(a, -1)
    for dd in range(10):
        if dd < 8:
            dr, dc = _RAY[dd]
            found = torch.zeros_like(is_drop)
            s = torch.full_like(a, -1)
            for dist in range(1, _N):
                rr, cc = r0 + dr * dist, c0 + dc * dist
                inb = (rr >= 0) & (rr < _N) & (cc >= 0) & (cc < _N)
                sq = (rr * _N + cc).clamp(0, _NSQ - 1)
                nonzero = inb & (board[r, sq] != 0)
                s = torch.where(nonzero & ~found, sq, s)
                found = found | nonzero
        else:
            dr, dc = _KNIGHT_SRC[dd - 8]
            rr, cc = r0 + dr, c0 + dc
            inb = (rr >= 0) & (rr < _N) & (cc >= 0) & (cc < _N)
            s = torch.where(inb, (rr * _N + cc).clamp(0, _NSQ - 1), -1)
        src = torch.where(d == dd, s, src)
    src_c = src.clamp(0, _NSQ - 1)
    pc = board[r, src_c]
    captured = board[r, to]
    base = t["base"][captured.abs().long().clamp(0, 14)]
    hand_idx = t["hand_idx"][base.clamp(0, 8)]
    gains = (captured != 0) & (base != K)
    hand0 = hand[:, 0].clone()
    hand0[r, hand_idx] += (gains & ~is_drop).to(hand0.dtype)
    promoted = t["promoted"][pc.long().clamp(0, 14)]
    moved = torch.where(promo, promoted, pc.long())
    b = board.clone()
    b[r, src_c] = torch.where(is_drop, board[r, src_c], 0).to(board.dtype)
    b[r, to] = torch.where(is_drop, board[r, to], moved.to(board.dtype))
    drop_slot = (plane - 20).clamp(0, 6)
    bd = board.clone()
    bd[r, to] = t["hand_order"][drop_slot].to(board.dtype)
    b = torch.where(is_drop[:, None], bd, b)
    hd = hand[:, 0].clone()
    hd[r, drop_slot] -= 1
    hand0 = torch.where(is_drop[:, None], hd, hand0)
    return b, torch.stack([hand0, hand[:, 1]], 1), is_drop


def flip(board: torch.Tensor) -> torch.Tensor:
    """A half turn of the board, negated."""
    return (-board.flip(-1)).to(board.dtype)


def board_hash(board: torch.Tensor, hand: torch.Tensor) -> torch.Tensor:
    """``[N]`` int32: the bits of JAX's uint32 position hash."""
    t = _t(board.device)
    sq = torch.arange(_NSQ, device=board.device)
    h = uint32_hash(t["hash_piece"][board.long() + 14, sq])
    p = torch.arange(2, device=board.device)[:, None]
    k = torch.arange(7, device=board.device)[None, :]
    words = t["hash_hand"][p, k, hand.long().clamp(0, 18)]             # [N, 2, 7]
    return h ^ uint32_hash(words.reshape(-1, 14))


class ShogiEnv(BoardEnv):
    """Shogi-v1 (pgx surface)."""

    DEFAULT_CONFIG = {"max_termination_steps": 512}

    def state_spec(self):
        return {
            "obs": ArraySpec(np.bool_, (-1, _N, _N, 119)),
            "info:board": ArraySpec(np.int32, (_N, _N), -1, 27),
            "info:current_player": ArraySpec(np.int32, (), 0, 1),
            "info:hand": ArraySpec(np.int32, (2, 7)),
            "info:legal_action_mask": ArraySpec(np.bool_, (NUM_ACTIONS,)),
            "info:turn": ArraySpec(np.int32, (), 0, 1),
        }

    def action_spec(self):
        shape = (-1,) if self.max_num_players > 1 else ()
        return {"action": ArraySpec(np.int32, shape, 0, NUM_ACTIONS - 1, is_discrete=True)}

    def plan_reset(self, d):
        d.perm("seats", 2)

    def _obs(self, st):
        """``[N, 9, 9, 119]``: 28 piece planes, 56 of the mover's hand, 35
        of the opponent's."""
        b, hand = st["board"], st["hand"]
        n = b.shape[0]
        pieces = torch.arange(1, 15, device=b.device, dtype=b.dtype)
        board_planes = torch.cat([b[..., None] == pieces, b[..., None] == -pieces], -1)
        mine = hand[:, 0, :, None] > torch.arange(8, device=b.device)   # [N, 7, 8]
        theirs = hand[:, 1, :, None] > torch.arange(5, device=b.device)  # [N, 7, 5]
        hand_planes = torch.cat([mine.reshape(n, 56), theirs.reshape(n, 35)], 1)
        obs = torch.cat([board_planes, hand_planes[:, None].expand(n, _NSQ, 91)], -1)
        obs = obs.reshape(n, _N, _N, 119)
        if self.max_num_players > 1:
            obs = torch.stack([obs, obs], 1)
        return obs

    def _obs_dict(self, st, mask):
        r = rows(st["turn"])
        return {
            "obs": self._obs(st),
            "info:board": st["board"].to(torch.int32).reshape(-1, _N, _N),
            "info:current_player": st["shuffled"][r, (st["turn"] % 2).long()],
            "info:hand": st["hand"],
            "info:legal_action_mask": mask,
            "info:turn": st["turn"] % 2,
        }

    def reset_env(self, draws):
        n = draws["rows"].shape[0]
        dev = self.device
        board = const(tuple(_INIT.tolist()), dev, torch.int8).expand(n, _NSQ).contiguous()
        hand = torch.zeros((n, 2, 7), dtype=torch.int32, device=dev)
        zero = torch.zeros(n, dtype=torch.int32, device=dev)
        rep_hash = torch.zeros((n, _REP_HIST), dtype=torch.int32, device=dev)
        rep_hash[:, 0] = board_hash(board, hand)
        st = {"board": board, "hand": hand, "turn": zero, "ply": zero,
              "shuffled": draws["seats"].to(torch.int32), "rep_hash": rep_hash,
              "rep_len": zero + 1}
        return st, self._obs_dict(st, legal_action_mask(board, hand))

    def step_env(self, state, action, draws):
        st = state
        a = first_row_action(action, self.max_num_players).to(torch.int32).clamp(
            0, NUM_ACTIONS - 1).long()
        r = rows(a)
        mover = st["shuffled"][r, (st["turn"] % 2).long()]
        illegal = ~legal_action_mask(st["board"], st["hand"])[r, a]
        board, hand, _ = apply_action(st["board"], st["hand"], a)
        next_board = flip(board)
        next_hand = hand.flip(1)
        turn = (st["turn"] + 1).to(torch.int32)
        h = board_hash(next_board, next_hand)
        rep_hash = torch.roll(st["rep_hash"], 1, dims=1)
        rep_hash[:, 0] = h
        rep_len = (st["rep_len"] + 1).clamp(max=_REP_HIST).to(torch.int32)
        st2 = {"board": next_board, "hand": next_hand, "turn": turn,
               "ply": (st["ply"] + 1).to(torch.int32), "shuffled": st["shuffled"],
               "rep_hash": rep_hash, "rep_len": rep_len}
        next_mask = legal_action_mask(next_board, next_hand)
        mate = ~next_mask.any(1)
        valid = torch.arange(_REP_HIST, device=a.device) < rep_len[:, None]
        reps = ((rep_hash == h[:, None]) & valid).sum(1)
        draw = (reps >= 4) | (st2["ply"] >= int(self.config["max_termination_steps"]))
        done = mate | draw | illegal
        loser = st["shuffled"][r, (turn % 2).long()]
        won = torch.zeros((a.shape[0], 2), dtype=torch.float32, device=a.device)
        won[r, mover.long()] = 1.0
        won[r, loser.long()] = -1.0
        rewards = torch.where(mate[:, None], won, 0.0)
        rewards = torch.where(illegal[:, None], seat_rewards(mover, 1.0, -1.0), rewards)
        next_mask = next_mask | done[:, None]
        reward = rewards if self.max_num_players > 1 else rewards[r, mover.long()]
        return EnvOut(state=st2, obs=self._obs_dict(st2, next_mask), reward=reward,
                      terminated=done)
