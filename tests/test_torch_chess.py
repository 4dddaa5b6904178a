"""The port's chess family (Chess, GardnerChess, AnimalShogi) against
the JAX package and the perft oracle (Shogi: ``test_torch_shogi.py``).

Perft counts through the port's ``legal_action_mask`` / ``apply_action``
(the frontier of each depth runs as one batch) are the public counts of
``tests/test_chess.py`` and ``tests/test_gardner_chess.py``; they need no
JAX compile.  Each game's 8-env rollout by legal moves runs across
auto-reset against JAX's engine step, equal in every field (the uint32
position hashes as int32 of the same bits, carried by ``interop``).
"""

import numpy as np
import pytest
import torch

from envpool_tpu.envs.board import chess as jax_chess
from envpool_tpu_torch import interop
from envpool_tpu_torch.envs.board import chess, gardner_chess
from test_chess import KIWIPETE, POS3, POS4, POS5, START, fen_board
from test_torch_board import check_rollout


def perft(board, castling, opp, ep, depth):
    """Leaf count ``depth`` plies below a batch of positions."""
    mask = chess.legal_action_mask(board, castling, ep)
    if depth == 1:
        return int(mask.sum())
    row, act = mask.nonzero(as_tuple=True)
    b, mc, oc, new_ep, _ = chess.apply_action(board[row], castling[row], opp[row], ep[row], act)
    return perft(chess.flip(b), oc, mc, chess.flip_sq(new_ep), depth - 1)


@pytest.mark.parametrize("fen,depth,expect", [
    (START, 1, 20), (START, 2, 400), (KIWIPETE, 1, 48), (KIWIPETE, 2, 2039),
    (POS3, 1, 14), (POS3, 2, 191), (POS4, 1, 6), (POS5, 1, 44)])
def test_chess_perft(fen, depth, expect):
    b, c, oc, ep = (torch.as_tensor(np.asarray(x))[None] for x in fen_board(fen))
    assert perft(b, c, oc, ep.to(torch.int32), depth) == expect


def test_gardner_perft():
    def count(board, depth):
        mask = gardner_chess.legal_action_mask(board)
        if depth == 1:
            return int(mask.sum())
        row, act = mask.nonzero(as_tuple=True)
        b, _ = gardner_chess.apply_action(board[row], act)
        return count(gardner_chess.flip(b), depth - 1)

    b0 = torch.as_tensor(gardner_chess._INIT_BOARD)[None]
    assert count(b0, 1) == 7
    assert count(b0, 2) == 53


def test_chess_hash_tables_and_hash_match_jax():
    """The Zobrist tables are JAX's (same seed), and the hash of random
    positions is JAX's uint32 word read as int32."""
    for name in ("_HASH_PIECE", "_HASH_CASTLE", "_HASH_EP"):
        np.testing.assert_array_equal(getattr(chess, name), getattr(jax_chess, name))
    gen = np.random.default_rng(0)
    boards = gen.integers(-6, 7, (64, 64)).astype(np.int8)
    cast = gen.random((64, 2)) < 0.5
    opp = gen.random((64, 2)) < 0.5
    ep = gen.integers(-1, 64, 64).astype(np.int32)
    import jax
    want = np.asarray(jax.jit(jax.vmap(jax_chess.board_hash))(boards, cast, opp, ep))
    got = chess.board_hash(*(torch.as_tensor(x) for x in (boards, cast, opp, ep)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_interop_uint32_leaves_round_trip():
    """A JAX pool state with uint32 leaves goes to the port as int32 of the
    same bits and comes back as the same uint32 words."""
    words = np.array([[0, 1, 2**31, 2**32 - 1]], np.uint32)
    tree = {"env_state": {"rep_hash": words, "board": np.zeros((1, 4), np.int8)},
            "key": np.zeros((1, 2), np.uint32), "elapsed": np.zeros(1, np.int32),
            "autoreset": np.zeros(1, bool), "full_reset": np.zeros(1, bool)}
    ps = interop.pool_state_from_numpy(tree, "cpu")
    assert ps.env_state["rep_hash"].dtype == torch.int32
    assert ps.env_state["rep_hash"].tolist() == [[0, 1, -2**31, -1]]
    back = interop.pool_state_to_numpy(ps, like=tree)
    assert back["env_state"]["rep_hash"].dtype == np.uint32
    np.testing.assert_array_equal(back["env_state"]["rep_hash"], words)
    assert interop.pool_state_to_numpy(ps)["env_state"]["rep_hash"].dtype == np.int32


@pytest.mark.parametrize("task,cfg", [
    ("Chess-v1", {"steps": 16, "episode": 12}),
    ("GardnerChess-v1", {"steps": 24, "episode": 20, "max_num_players": 2}),
    ("AnimalShogi-v1", {"steps": 24, "episode": 20}),
])
def test_rollout_matches_jax(task, cfg, monkeypatch):
    cfg = dict(cfg)
    depth = {k: cfg.pop(k) for k in ("steps", "episode")}
    check_rollout(task, monkeypatch, **depth, **cfg)
