"""Chess, batched over ``[N]`` boards.

Counterpart of ``envpool_tpu/envs/board/chess.py`` (pgx surface): obs
``(8, 8, 119)`` AlphaZero planes, 4672 actions = 64 from-squares x 73
planes (56 queen rides, 8 knight jumps, 9 underpromotions), +-1 at
checkmate, 0 on the draws (stalemate, insufficient material, 50 moves,
threefold repetition, the ply limit).  The board sits in the mover's
frame and flips every ply; legality is analytic (``chess_rules.py``).

The repetition window holds the Zobrist hashes of the positions since
the last capture or pawn move.  JAX keeps them as uint32; the port keeps
the same bits as int32 (XOR and equality are the same on either view;
``interop`` carries them across).  The hash tables are JAX's: the same
``np.random.default_rng`` seed gives the same words.  The seats are a
permutation drawn at the reset.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from ...ops.batched import const, first_argmax
from .chess_rules import B, Geometry, K, N, P, Q, R
from .common import BoardEnv, first_row_action, rows, seat_rewards, u32_table, uint32_hash

__all__ = ["ChessEnv", "legal_action_mask", "apply_action", "flip", "board_hash"]

NUM_ACTIONS = 4672  # 64 * 73
GEO = Geometry(8)

_INIT_BOARD = np.zeros(64, np.int8)
_INIT_BOARD[:8] = [R, N, B, Q, K, B, N, R]
_INIT_BOARD[8:16] = P
_INIT_BOARD[48:56] = -P
_INIT_BOARD[56:64] = [-R, -N, -B, -Q, -K, -B, -N, -R]

_HIST = 8          # obs history steps
_REP_HIST = 101    # position-hash window for threefold detection

# Zobrist-style hash basis: JAX's tables (chess.py:112-115).
_rng = np.random.default_rng(20260821)
_HASH_PIECE = _rng.integers(1, 2**32, size=(13, 64), dtype=np.uint32)
_HASH_CASTLE = _rng.integers(1, 2**32, size=(4,), dtype=np.uint32)
_HASH_EP = _rng.integers(1, 2**32, size=(65,), dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _hash_tables(device: torch.device):
    return tuple(u32_table(t).to(device) for t in (_HASH_PIECE, _HASH_CASTLE, _HASH_EP))


def board_hash(board, castling, opp_castling, ep_sq) -> torch.Tensor:
    """``[...]`` int32: the bits of JAX's uint32 position hash of boards
    ``[..., 64]`` (castling ``[..., 2]``, en passant ``[...]``)."""
    hp, hc, he = _hash_tables(board.device)
    sq = torch.arange(64, device=board.device)
    h = uint32_hash(hp[(board.to(torch.int64) + 6), sq])
    zero = torch.zeros((), dtype=torch.int32, device=board.device)
    h = h ^ torch.where(castling[..., 0], hc[0], zero)
    h = h ^ torch.where(castling[..., 1], hc[1], zero)
    h = h ^ torch.where(opp_castling[..., 0], hc[2], zero)
    h = h ^ torch.where(opp_castling[..., 1], hc[3], zero)
    return h ^ he[ep_sq.clamp(-1, 63).to(torch.int64) + 1]


def _ep_legal(board, from_sq, ep_to, ep_capture_sq):
    """``[N]``: after the en passant capture from ``from_sq``, the mover's
    king is not attacked (the rank may open on it)."""
    r = rows(board)
    b2 = board.clone()
    b2[r, from_sq] = 0
    b2[r, ep_to] = P
    b2[r, ep_capture_sq] = 0
    att = GEO.attacked_by_them(b2)
    return ~att[r, first_argmax((b2 == K).to(torch.int8))]


def legal_action_mask(board, castling, ep_sq) -> torch.Tensor:
    """``[N, 4672]`` legality under the full rules, in the mover's frame."""
    mask, info = GEO.pseudo_mask(board, True, ep_sq)
    r = rows(board)
    ep_to = info["ep_to"]
    ep_capture_sq = (ep_to - 8).clamp(0, 63)
    ep_from_l = (ep_to - 9).clamp(0, 63)
    ep_from_r = (ep_to - 7).clamp(0, 63)
    ep_l_ok = _ep_legal(board, ep_from_l, ep_to, ep_capture_sq)
    ep_r_ok = _ep_legal(board, ep_from_r, ep_to, ep_capture_sq)
    ep_legal_from = torch.zeros_like(board, dtype=torch.bool)
    ep_legal_from[r, ep_from_l] = ep_l_ok
    ep_legal_from[r, ep_from_r] = ep_r_ok
    mask = mask & torch.where(info["is_ep"], ep_legal_from[:, :, None], True)

    # Castling: the king's E and W rides of 2 from e1 (planes 15 and 43).
    empty = board == 0
    attacked = GEO.attacked_by_them(board)
    e1, f1, g1, d1, c1, b1 = 4, 5, 6, 3, 2, 1
    king_home = board[:, e1] == K
    ks_clear = empty[:, f1] & empty[:, g1]
    qs_clear = empty[:, d1] & empty[:, c1] & empty[:, b1]
    ks_safe = ~attacked[:, e1] & ~attacked[:, f1] & ~attacked[:, g1]
    qs_safe = ~attacked[:, e1] & ~attacked[:, d1] & ~attacked[:, c1]
    ks_ok = castling[:, 0] & king_home & (board[:, 7] == R) & ks_clear & ks_safe
    qs_ok = castling[:, 1] & king_home & (board[:, 0] == R) & qs_clear & qs_safe
    in_check = info["in_check"]
    mask = mask.clone()
    mask[:, e1, 15] = mask[:, e1, 15] | (ks_ok & ~in_check)
    mask[:, e1, 43] = mask[:, e1, 43] | (qs_ok & ~in_check)
    return mask.reshape(board.shape[0], -1)


def apply_action(board, castling, opp_castling, ep_sq, action):
    """``action`` ``[N]`` in the mover's frame: ``(board, my castling, the
    opponent's castling, the new en passant square, capture or pawn move)``."""
    t = GEO.on(board.device)
    r = rows(board)
    a = action.long()
    from_sq, plane = a // 73, a % 73
    to = t["to_sq"][from_sq, plane].clamp(0, 63)
    pc = board[r, from_sq]
    is_under = t["is_under"][plane]
    under_piece = t["under_piece"][plane]
    promo_q = (pc == P) & (to // 8 == 7) & ~is_under
    new_piece = torch.where(is_under, under_piece, torch.where(promo_q, Q, pc.long()))
    captured = board[r, to]
    ep_to = torch.where(ep_sq >= 0, ep_sq, -2)
    is_ep = (pc == P) & (to == ep_to)
    ep_victim = (to - 8).clamp(0, 63)
    b = board.clone()
    b[r, from_sq] = 0
    b[r, ep_victim] = torch.where(is_ep, 0, b[r, ep_victim]).to(b.dtype)
    b[r, to] = new_piece.to(board.dtype)
    is_ks = (pc == K) & (from_sq == 4) & (to == 6)
    is_qs = (pc == K) & (from_sq == 4) & (to == 2)
    ks, qs = is_ks[:, None], is_qs[:, None]
    b2 = b.clone()
    b2[:, 7] = 0
    b2[:, 5] = R
    b = torch.where(ks, b2, b)
    b3 = b.clone()
    b3[:, 0] = 0
    b3[:, 3] = R
    b = torch.where(qs, b3, b)
    my_castle = torch.stack([castling[:, 0] & ~(pc == K) & ~(from_sq == 7),
                             castling[:, 1] & ~(pc == K) & ~(from_sq == 0)], 1)
    opp_castle = torch.stack([opp_castling[:, 0] & ~(to == 63),
                              opp_castling[:, 1] & ~(to == 56)], 1)
    dbl = (pc == P) & (to - from_sq == 16)
    new_ep = torch.where(dbl, from_sq + 8, -1).to(torch.int32)
    was_cap_or_pawn = (captured != 0) | (pc == P) | is_ep
    return b, my_castle, opp_castle, new_ep, was_cap_or_pawn


def flip(board: torch.Tensor) -> torch.Tensor:
    """Mirror the ranks into the opponent's frame and negate."""
    return (-board.reshape(-1, 8, 8).flip(1).reshape(board.shape)).to(board.dtype)


def flip_sq(sq: torch.Tensor) -> torch.Tensor:
    return torch.where(sq >= 0, sq ^ 56, -1).to(torch.int32)


def insufficient_material(board: torch.Tensor) -> torch.Tensor:
    """K vs K, K+N vs K, K+B vs K."""
    n_my = ((board > 0) & (board != K)).sum(1)
    n_opp = ((board < 0) & (board != -K)).sum(1)
    minor_my = (n_my == 1) & (((board == N) | (board == B)).sum(1) == 1)
    minor_opp = (n_opp == 1) & (((board == -N) | (board == -B)).sum(1) == 1)
    bare = (n_my == 0) & (n_opp == 0)
    return bare | ((n_my == 0) & minor_opp) | ((n_opp == 0) & minor_my)


def repetitions(rep_hash, rep_len, h) -> torch.Tensor:
    """``[N, ...]``: how often each hash ``h`` ``[N, ...]`` stands in the
    window's first ``rep_len`` entries."""
    valid = torch.arange(rep_hash.shape[1], device=h.device) < rep_len[:, None]
    hit = (rep_hash[:, None, :] == h.reshape(h.shape[0], -1, 1)) & valid[:, None, :]
    return hit.sum(-1).reshape(h.shape)


class ChessEnv(BoardEnv):
    """Chess-v1 (pgx surface)."""

    DEFAULT_CONFIG = {"max_termination_steps": 512}

    def state_spec(self):
        return {
            "obs": ArraySpec(np.float32, (-1, 8, 8, 119)),
            "info:board": ArraySpec(np.int32, (8, 8)),
            "info:castling_rights": ArraySpec(np.bool_, (2, 2)),
            "info:current_player": ArraySpec(np.int32, (), 0, 1),
            "info:en_passant": ArraySpec(np.int32, (), -1, 63),
            "info:fullmove_count": ArraySpec(np.int32, ()),
            "info:halfmove_count": ArraySpec(np.int32, ()),
            "info:legal_action_mask": ArraySpec(np.bool_, (NUM_ACTIONS,)),
            "info:turn": ArraySpec(np.int32, (), 0, 1),
        }

    def action_spec(self):
        shape = (-1,) if self.max_num_players > 1 else ()
        return {"action": ArraySpec(np.int32, shape, 0, NUM_ACTIONS - 1, is_discrete=True)}

    def plan_reset(self, d):
        d.perm("seats", 2)

    def _obs(self, st):
        """AlphaZero planes ``[N, 8, 8, 119]`` in the mover's frame."""
        hist = st["hist"]                                              # [N, 8, 64]
        n = hist.shape[0]
        pieces = torch.arange(1, 7, device=hist.device, dtype=hist.dtype)
        own = hist[:, :, :, None] == pieces                            # [N, 8, 64, 6]
        opp = hist[:, :, :, None] == -pieces
        ep = torch.cat([st["ep"][:, None],
                        torch.full((n, _HIST - 1), -1, dtype=torch.int32,
                                   device=hist.device)], 1)
        h = board_hash(hist, st["castling"][:, None], st["opp_castling"][:, None], ep)
        reps = repetitions(st["rep_hash"], st["rep_len"], h)          # [N, 8]
        rep_planes = torch.stack([reps >= 2, reps >= 3], -1)[:, :, None, :].expand(
            n, _HIST, 64, 2)
        per_t = torch.cat([own, opp, rep_planes], -1).to(torch.float32)  # [N, 8, 64, 14]
        per_t = per_t.permute(0, 2, 1, 3).reshape(n, 64, _HIST * 14)
        tail = torch.stack([st["turn"].to(torch.float32), st["fullmove"].to(torch.float32),
                            st["castling"][:, 0].to(torch.float32),
                            st["castling"][:, 1].to(torch.float32),
                            st["opp_castling"][:, 0].to(torch.float32),
                            st["opp_castling"][:, 1].to(torch.float32),
                            st["halfmove"].to(torch.float32)], 1)
        obs = torch.cat([per_t, tail[:, None, :].expand(n, 64, 7)], -1).reshape(n, 8, 8, 119)
        if self.max_num_players > 1:
            obs = torch.stack([obs, obs], 1)
        return obs

    def _obs_dict(self, st, mask):
        r = rows(st["turn"])
        return {
            "obs": self._obs(st),
            "info:board": st["board"].to(torch.int32).reshape(-1, 8, 8),
            "info:castling_rights": torch.stack([st["castling"], st["opp_castling"]], 1),
            "info:current_player": st["shuffled"][r, (st["turn"] % 2).long()],
            "info:en_passant": st["ep"],
            "info:fullmove_count": st["fullmove"],
            "info:halfmove_count": st["halfmove"],
            "info:legal_action_mask": mask,
            "info:turn": st["turn"] % 2,
        }

    def reset_env(self, draws):
        n = draws["rows"].shape[0]
        dev = self.device
        board = const(tuple(_INIT_BOARD.tolist()), dev, torch.int8).expand(n, 64).contiguous()
        ones = torch.ones((n, 2), dtype=torch.bool, device=dev)
        ep = torch.full((n,), -1, dtype=torch.int32, device=dev)
        zero = torch.zeros(n, dtype=torch.int32, device=dev)
        rep_hash = torch.zeros((n, _REP_HIST), dtype=torch.int32, device=dev)
        rep_hash[:, 0] = board_hash(board, ones, ones, ep)
        st = {"board": board, "castling": ones, "opp_castling": ones.clone(), "ep": ep,
              "turn": zero, "halfmove": zero, "fullmove": zero + 1, "ply": zero,
              "shuffled": draws["seats"].to(torch.int32),
              "hist": board[:, None].expand(n, _HIST, 64).contiguous(),
              "rep_hash": rep_hash, "rep_len": zero + 1,
              "terminated": torch.zeros(n, dtype=torch.bool, device=dev)}
        return st, self._obs_dict(st, legal_action_mask(board, ones, ep))

    def step_env(self, state, action, draws):
        st = state
        a = first_row_action(action, self.max_num_players).to(torch.int32).clamp(
            0, NUM_ACTIONS - 1).long()
        r = rows(a)
        mover = st["shuffled"][r, (st["turn"] % 2).long()]
        mask = legal_action_mask(st["board"], st["castling"], st["ep"])
        illegal = ~mask[r, a]
        board, my_c, opp_c, new_ep, zero_clock = apply_action(
            st["board"], st["castling"], st["opp_castling"], st["ep"], a)
        next_board = flip(board)
        next_castling, next_opp_castling = opp_c, my_c
        next_ep = flip_sq(new_ep)
        halfmove = torch.where(zero_clock, 0, st["halfmove"] + 1).to(torch.int32)
        fullmove = (st["fullmove"] + st["turn"] % 2).to(torch.int32)
        turn = (st["turn"] + 1).to(torch.int32)
        h = board_hash(next_board, next_castling, next_opp_castling, next_ep)
        rep_len = torch.where(zero_clock, 0, st["rep_len"].clamp(max=_REP_HIST - 1))
        rep_hash = torch.where(zero_clock[:, None], 0, st["rep_hash"])
        rep_hash = torch.roll(rep_hash, 1, dims=1)
        rep_hash[:, 0] = h
        rep_len = (rep_len + 1).to(torch.int32)
        hist = torch.cat([next_board[:, None], st["hist"][:, :-1]], 1)
        st2 = {"board": next_board, "castling": next_castling,
               "opp_castling": next_opp_castling, "ep": next_ep, "turn": turn,
               "halfmove": halfmove, "fullmove": fullmove, "ply": (st["ply"] + 1).to(torch.int32),
               "shuffled": st["shuffled"], "hist": hist, "rep_hash": rep_hash,
               "rep_len": rep_len, "terminated": st["terminated"]}
        next_mask = legal_action_mask(next_board, next_castling, next_ep)
        no_moves = ~next_mask.any(1)
        king_sq = first_argmax((next_board == K).to(torch.int8))
        in_check = GEO.attacked_by_them(next_board)[r, king_sq]
        checkmate = no_moves & in_check
        stalemate = no_moves & ~in_check
        reps = repetitions(rep_hash, rep_len, h)
        draw = (stalemate | (halfmove >= 100) | (reps >= 3) | insufficient_material(next_board)
                | (st2["ply"] >= int(self.config["max_termination_steps"])))
        done = checkmate | draw | illegal
        loser = st["shuffled"][r, (turn % 2).long()]
        mate = torch.zeros((a.shape[0], 2), dtype=torch.float32, device=a.device)
        mate[r, mover.long()] = 1.0
        mate[r, loser.long()] = -1.0
        rewards = torch.where(checkmate[:, None], mate, 0.0)
        rewards = torch.where(illegal[:, None], seat_rewards(mover, 1.0, -1.0), rewards)
        next_mask = next_mask | done[:, None]
        reward = rewards if self.max_num_players > 1 else rewards[r, mover.long()]
        return EnvOut(state=st2, obs=self._obs_dict(st2, next_mask), reward=reward,
                      terminated=done)
