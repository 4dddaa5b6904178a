"""The port's Shogi against the JAX package: an 8-env rollout by legal
moves across auto-reset, equal to JAX's engine step in every field (the
uint32 position hashes as int32 of the same bits).  Alone in its file:
JAX's Shogi step (three unrolled legality passes) takes ~100 s to
compile on the CPU."""

import numpy as np

from envpool_tpu.envs.board import shogi as jax_shogi
from envpool_tpu_torch.envs.board import shogi
from test_torch_board import check_rollout


def test_tables_match_jax():
    for name in ("_CAN", "_INIT", "_HASH_PIECE", "_HASH_HAND"):
        np.testing.assert_array_equal(getattr(shogi, name), getattr(jax_shogi, name))


def test_rollout_matches_jax(monkeypatch):
    check_rollout("Shogi-v1", monkeypatch, steps=16, episode=12, max_num_players=2)
