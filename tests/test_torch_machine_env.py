"""The port's Machine2600 env against the JAX package's.

* Per-ROM presets: score, lives and game-over decoded from random RAM,
  and the joystick inputs of every action index, for every preset.
* ``Machine2600-v0`` through the port's engine against the JAX engine
  across an auto-reset, on the hand-assembled pong cart: JAX runs the
  first steps, its ``PoolState`` is carried into the port through
  ``interop``, and both engines take the steps in which env 1 scores and
  env 0 (paddle held down) loses its only life, terminates and resets.
  Game state, reward, done and every info field must be bit-exact; obs
  follow the tie rule.  The game takes no random draws (console power-on
  is deterministic, and ``noop_max=1`` draws only 0), so the port's own
  draws equal JAX's.
* The ``rom_path`` errors, and the registered ids.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
import machine_carts as carts
from envpool_tpu.core.engine import Engine as JaxEngine
from envpool_tpu.core.engine import PoolState as JaxPoolState
from envpool_tpu.envs.atari import machine_env as jme
from envpool_tpu.envs.atari import rom_presets as jpresets
from envpool_tpu_torch import interop
from envpool_tpu_torch.core.engine import Engine
from envpool_tpu_torch.envs.atari import machine_env, rom_presets
from envpool_tpu_torch.envs.atari.obs_ties import ObsTies
from envpool_tpu_torch.ops.image import tie_rule_violations

SCORE, LIVES = 0x81, 0x87  # the pong cart's score and lives bytes


@pytest.fixture(scope="module")
def rom_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("roms") / "pong_like.bin"
    p.write_bytes(carts.pong_rom().tobytes())
    return str(p)


@pytest.mark.parametrize("name", jpresets.list_presets())
def test_preset_decode_matches_jax(name):
    assert rom_presets.list_presets() == jpresets.list_presets()
    preset = rom_presets.get_preset(name)
    assert preset == jpresets.get_preset(name)
    rom = carts.pong_rom()
    jgame = jme.Machine2600Game(rom, preset=jpresets.get_preset(name))
    tgame = machine_env.Machine2600Game(torch.device("cpu"), rom, preset=preset)
    assert tgame.action_set_size == jgame.action_set_size
    assert tgame.minimal_set == jgame.minimal_set

    ram = np.random.default_rng(len(name)).integers(0, 256, (64, 128)).astype(np.int32)
    ram[:8, :] = 0  # no lives left, zero score
    g = {"ram": torch.as_tensor(ram), "pc": torch.zeros(64, dtype=torch.int32)}
    for fn in ("_score", "lives", "over"):
        want = np.asarray(jax.vmap(lambda r: getattr(jgame, fn)({"ram": r}))(jnp.asarray(ram)))
        got = getattr(tgame, fn)(g).numpy()
        assert got.dtype == want.dtype, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)

    actions = np.arange(tgame.action_set_size)
    table = np.asarray(jgame.minimal_set)
    want = [np.asarray(jme._action_to_inputs(jnp.int32(table[a]))) for a in actions]
    swcha, inpt4 = tgame.inputs(torch.as_tensor(actions))
    np.testing.assert_array_equal(swcha.numpy(), [w[0] for w in want])
    np.testing.assert_array_equal(inpt4.numpy(), [w[1] for w in want])


def _host(ps):
    return dataclasses.asdict(jax.device_get(ps))


def test_engine_matches_jax_across_auto_reset(rom_path):
    n = 2
    cfg = dict(
        num_envs=n, seed=5, rom_path=rom_path, ram_reward_addr=SCORE,
        ram_lives_addr=LIVES, frame_skip=1, noop_max=1, use_fire_reset=False,
    )
    jeng = JaxEngine(envpool_tpu.make_spec("Machine2600-v0", **cfg).env)
    tenv = envpool_tpu_torch.make_spec("Machine2600-v0", device="cpu", **cfg).env
    teng = Engine(tenv)
    ties = ObsTies(tenv)
    act = np.array([5, 0], np.int32)  # env 0 holds DOWN, env 1 stands still

    # JAX alone up to shortly before env 1's point and env 0's miss.
    jps, _ = jeng.step(jeng.init(), {"action": jnp.zeros(n, jnp.int32)})
    for _ in range(6):
        jps, _ = jeng.step(jps, {"action": jnp.asarray(act)})
    tree = _host(jps)
    game = tree["env_state"]["game"]
    assert game["wrapped"].dtype == np.bool_ and game["lines"].shape == (n, 192, 24)
    back = interop.pool_state_to_numpy(interop.pool_state_from_numpy(tree, "cpu"))
    flat_a, def_a = jax.tree_util.tree_flatten(tree)
    flat_b, def_b = jax.tree_util.tree_flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jps = JaxPoolState(**jax.tree_util.tree_map(jnp.asarray, tree))
    tps = interop.pool_state_from_numpy(tree, "cpu")
    ties.assume_equal(n)

    seen = {"reward": 0, "terminated": 0, "reset": 0}
    for t in range(6):
        jps, jts = jeng.step(jps, {"action": jnp.asarray(act)})
        tps, tts = teng.step(tps, {"action": torch.as_tensor(act)})
        mask = ties.after_step(tts["step_type"] == 0)
        jts = jax.device_get(jts)
        assert set(jts) == set(tts)
        for k, v in jts.items():
            if k == "obs":
                bad, _ = tie_rule_violations(torch.as_tensor(np.array(v)), tts[k], mask)
                assert bad == 0, f"obs outside the tie rule at step {t}"
            else:
                np.testing.assert_array_equal(np.asarray(v), tts[k].numpy(), err_msg=f"{k} {t}")
        tree = _host(jps)
        got = interop.pool_state_to_numpy(tps)
        for k in ("elapsed", "autoreset", "full_reset"):
            np.testing.assert_array_equal(tree[k], got[k], err_msg=k)
        for k, v in tree["env_state"]["game"].items():
            assert got["env_state"]["game"][k].dtype == v.dtype, k
            np.testing.assert_array_equal(v, got["env_state"]["game"][k], err_msg=f"{k} {t}")
        seen["reward"] += int((tts["reward"] > 0).sum())
        seen["terminated"] += int((tts["done"] & ~tts["trunc"]).sum())
        seen["reset"] += int((tts["step_type"] == 0).sum())
    assert seen == {"reward": 1, "terminated": 1, "reset": 1}, seen


def test_rom_path_errors(tmp_path):
    with pytest.raises(ValueError, match="rom_path"):
        envpool_tpu_torch.make("Machine2600-v0", env_type="gymnasium", num_envs=1, device="cpu")
    bad = tmp_path / "odd.bin"
    bad.write_bytes(bytes(3000))
    for make in (envpool_tpu.make_spec, envpool_tpu_torch.make_spec):
        with pytest.raises(ValueError, match="2K/4K/8K"):
            make("Machine2600-v0", rom_path=str(bad))
    # A 2K cart mirrors into 4K.
    half = tmp_path / "half.bin"
    half.write_bytes(carts.pong_rom()[:2048].tobytes())
    env = envpool_tpu_torch.make_spec("Machine2600-v0", rom_path=str(half), device="cpu").env
    np.testing.assert_array_equal(env.game.rom_np, np.tile(carts.pong_rom()[:2048], 2))


def test_registered_ids_match_jax(rom_path):
    ids = [i for i in envpool_tpu.list_all_envs() if i.startswith("Machine2600")]
    assert len(ids) == 13
    assert set(ids) <= set(envpool_tpu_torch.list_all_envs())
    for task in ids:
        j = envpool_tpu.make_spec(task, rom_path=rom_path)
        t = envpool_tpu_torch.make_spec(task, rom_path=rom_path, device="cpu")
        assert t.action_space.n == j.action_space.n, task
        assert t.env.max_episode_steps == j.env.config["max_episode_steps"] == 27000
        assert t.env.config["game"] == j.env.config["game"], task
