"""The port's RoomGrid levels (the BabyAI suite and the multi-room
MiniGrid tasks) against the JAX package.

Each level class (and each of its generation options) runs an 8-env
rollout across auto-reset with JAX's draws handed to the port, as in
``tests/test_torch_minigrid.py``: the state and the timestep equal in
every field.  The mission step (its detectors, two-stage missions and
the debug failure) is held to JAX's on random states, and
``connect_all``'s door mask, which the port reads from a table of every
slot subset's connectivity, to JAX's 4n-step scan on the same draws, its
fallback (all doors when no prefix connects the rooms) included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.envs.minigrid import core as mg
from envpool_tpu_torch.envs.minigrid import roomgrid
from test_torch_minigrid import _ON, _REC, _random_grids, check_rollout, record_draws
from test_torch_toy_text import assert_trees_equal, assert_uniform

# One id of each level class and generation option of roomgrid.py.
ROLLOUTS = [
    "BabyAI-OneRoomS8-v0",
    "BabyAI-FindObjS5-v0",
    "BabyAI-GoToObjMazeOpen-v0",
    "BabyAI-GoToSeqS5R2-v0",
    "BabyAI-GoToObjDoor-v0",
    "BabyAI-ActionObjDoor-v0",
    "BabyAI-OpenRedDoor-v0",
    "BabyAI-OpenDoorDebug-v0",
    "BabyAI-OpenDoorsOrderN4Debug-v0",
    "BabyAI-OpenRedBlueDoors-v0",
    "BabyAI-Open-v0",
    "BabyAI-PickupDist-v0",
    "BabyAI-PickupAbove-v0",
    "BabyAI-PutNextS5N2Carrying-v0",
    "MiniGrid-PutNear-6x6-N2-v0",
    "BabyAI-KeyInBox-v0",
    "BabyAI-BlockedUnlockPickup-v0",
    "BabyAI-UnlockToUnlock-v0",
    "BabyAI-GoToImpUnlock-v0",
    "BabyAI-UnlockLocalDist-v0",
    "MiniGrid-KeyCorridorS3R3-v0",
    "MiniGrid-ObstructedMaze-1Dl-v0",
    "MiniGrid-ObstructedMaze-2Q-v0",
    "MiniGrid-MultiRoom-N6-v0",
    "MiniGrid-LockedRoom-v0",
    "MiniGrid-Playground-v0",
    "BabyAI-SynthS5R2-v0",
    "BabyAI-BossLevel-v0",
]


@pytest.mark.parametrize("task", ROLLOUTS)
def test_rollout_matches_jax(task, monkeypatch):
    check_rollout(task, monkeypatch)


def test_mission_step_matches_jax():
    """``RoomGridEnv.step_env`` (the ``_desc_done`` detectors, the
    two-stage missions and the debug failure) against JAX's from random
    states: objects and doors in every state around the agent, missions of
    every kind with wildcards and second instructions at either stage,
    empty or full hands, every action and ``t``."""
    task = "BabyAI-OpenDoorDebug-v0"  # debug: opening the wrong door fails
    jenv = envpool_tpu.make_spec(task, num_envs=1).env
    tenv = envpool_tpu_torch.make_spec(task, num_envs=1, device="cpu").env
    rng_ = np.random.default_rng(6)
    b = 4096
    w, h = tenv._wh
    grid = _random_grids(rng_, b, h, w)
    pos = np.stack([rng_.integers(1, w - 1, b), rng_.integers(1, h - 1, b)], 1).astype(np.int32)
    kinds = rng_.integers(-1, 6, (b, 2))
    kinds[rng_.random(b) < 0.5, 1] = -1
    types = rng_.choice([-1, mg.KEY, mg.BALL, mg.BOX, mg.DOOR], (b, 2))
    colors = rng_.integers(-1, 6, (b, 2))
    mission = np.stack([kinds[:, 0], types[:, 0], colors[:, 0], kinds[:, 1], types[:, 1],
                        colors[:, 1], rng_.integers(0, 2, b)], 1).astype(np.int32)
    st = {
        "grid": grid,
        "pos": pos,
        "dir": rng_.integers(0, 4, b).astype(np.int32),
        "carrying": np.stack([rng_.choice([mg.EMPTY, mg.KEY, mg.BALL, mg.BOX], b),
                              rng_.integers(0, 6, b)], 1).astype(np.int8),
        "t": rng_.integers(0, tenv.max_episode_steps, b).astype(np.int32),
        "mission": mission,
    }
    act = rng_.integers(0, 7, b).astype(np.int32)

    def step(s, a, k):
        out = jenv.step_env(s, a, k)
        return out.state, out.obs, out.reward, out.terminated

    want = jax.jit(jax.vmap(step))(st, act, jax.random.split(jax.random.PRNGKey(0), b))
    out = tenv.step_env({k: torch.as_tensor(v) for k, v in st.items()}, torch.as_tensor(act),
                        {"rows": torch.zeros((b, 0))})
    got = (out.state, out.obs, out.reward, out.terminated)
    for i, (a, g) in enumerate(zip(jax.device_get(want), got)):
        assert_trees_equal(a, g, f"output {i}")
    done = np.asarray(want[3])
    stage = np.asarray(want[0]["mission"][:, 6]) > mission[:, 6]
    assert done.mean() > 0.02 and stage.any() and (np.asarray(want[2]) > 0).any()


def _jax_masks(env, keys):
    """JAX's door masks for ``keys`` and the slot draws its scan made."""

    def one(key):
        _REC.clear()
        _ON[0] = True
        try:
            mask = env._connect_doors_mask(key)
        finally:
            _ON[0] = False
        (kind, draws), = _REC
        _REC.clear()
        assert kind == "randint"
        return mask, draws

    return jax.device_get(jax.jit(jax.vmap(one))(keys))


@pytest.mark.parametrize("rows, cols", [(3, 3), (2, 2), (2, 3), (1, 3)])
def test_connect_doors_mask_matches_jax(rows, cols, monkeypatch):
    record_draws(monkeypatch)
    task = {(3, 3): "BabyAI-GoTo-v0", (2, 2): "BabyAI-GoToObjMazeS4R2-v0",
            (2, 3): "MiniGrid-ObstructedMaze-2Q-v0", (1, 3): "BabyAI-UnlockToUnlock-v0"}
    jenv = envpool_tpu.make_spec(task[rows, cols], num_envs=1).env
    tenv = envpool_tpu_torch.make_spec(task[rows, cols], num_envs=1, device="cpu").env
    keys = jax.random.split(jax.random.PRNGKey(rows * 10 + cols), 2048)
    want, draws = _jax_masks(jenv, keys)
    got = tenv._connect_doors_mask(torch.as_tensor(np.array(draws)))
    np.testing.assert_array_equal(got.numpy(), want)
    n = len(roomgrid.door_slots(rows, cols))
    assert draws.shape == (2048, 4 * n)
    assert want.sum(1).min() >= rows * cols - 1  # a spanning set at least


def test_connect_doors_mask_fallback_matches_jax(monkeypatch):
    """Draws that never connect the rooms (every draw slot 0): JAX opens
    every slot, and so does the port."""
    jenv = envpool_tpu.make_spec("BabyAI-GoTo-v0", num_envs=1).env
    tenv = envpool_tpu_torch.make_spec("BabyAI-GoTo-v0", num_envs=1, device="cpu").env
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.int32(0))
    want = np.asarray(jenv._connect_doors_mask(jax.random.PRNGKey(0)))
    got = tenv._connect_doors_mask(torch.zeros((1, 48), dtype=torch.int32))
    assert want.all() and got.all()


def test_connected_table():
    """The table against a breadth-first search over the room lattice."""
    for rows, cols in ((3, 3), (2, 3), (2, 2), (1, 3)):
        slots = roomgrid.door_slots(rows, cols)
        table = roomgrid.connected_table(rows, cols)
        for mask in range(1 << len(slots)):
            seen, todo = {0}, [0]
            while todo:
                a = todo.pop()
                for i, (r, c, h) in enumerate(slots):
                    if mask >> i & 1:
                        x, y = r * cols + c, r * cols + c + 1 if h else (r + 1) * cols + c
                        for p, q in ((x, y), (y, x)):
                            if p == a and q not in seen:
                                seen.add(q)
                                todo.append(q)
            assert table[mask] == (len(seen) == rows * cols), (rows, cols, mask)


def test_port_boss_level_draws():
    """The port's own BossLevel resets: 18 distractors on distinct free
    cells, the agent on a free cell, doors that connect every room, and
    missions of the seq kinds."""
    n = 256
    env = envpool_tpu_torch.make_spec("BabyAI-BossLevel-v0", num_envs=n, seed=3,
                                      device="cpu").env
    st, obs = env.reset_env(env.reset_draws(rng.split(env.keys())[1]))
    g = st["grid"]
    obj = g[..., 0]
    objs = ((obj == mg.KEY) | (obj == mg.BALL) | (obj == mg.BOX)).sum((1, 2))
    assert (objs == 18).all()
    assert (obj[torch.arange(n), st["pos"][:, 1], st["pos"][:, 0]] == mg.EMPTY).all()
    # The slots that hold a door: a door on the wall between two rooms.
    rs = env._rs - 1
    mask = torch.zeros(n, dtype=torch.int64)
    for i, (r, c, h) in enumerate(roomgrid.door_slots(3, 3)):
        wall = obj[:, r * rs + 1:(r + 1) * rs, (c + 1) * rs] if h else \
            obj[:, (r + 1) * rs, c * rs + 1:(c + 1) * rs]
        mask |= (wall == mg.DOOR).any(1).long() << i
    assert roomgrid.connected_table(3, 3)[mask.numpy()].all()
    m = st["mission"]
    assert set(m[:, 0].tolist()) <= {0, 1, 2} and set(m[:, 3].tolist()) <= {0, 1, 2}
    assert_uniform(st["dir"].numpy(), 0, 3, "dir")
    assert (obs["info:mission_id"] >= 0).all()
