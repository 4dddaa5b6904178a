"""The port's ``from_pixels`` path against the JAX package.

Frames are held by the frame rule (``ops.rasterize.frame_rule_violations``,
``ROADMAP.md`` Queue 3): equal everywhere except at pixels that float
rounding decides, which a float64 render of the same state marks
(``rounding_pixels``): within 1e-4 world units of a geom's edge, of a
depth tie or of the floor's or a checker's line (any difference there),
and where a shaded geom's luma lies within 1e-2 of an integer (a
difference of 1, the uint8 cast's truncation).  The share of pixels that
differ at all is bounded by ``MAX_DIFFER``.  The non-frame fields of a
pixel env's step are held as the physics tests hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
from envpool_tpu.envs.mujoco_dmc.base import _load_dmc_model
from envpool_tpu.ops.rasterize import render_scene as jax_render_scene
from envpool_tpu_torch.ops import rasterize
from test_torch_classic import EnginePair, assert_ts_close, host
from test_torch_mujoco_gym import STEP_TOL, _cheetah_draws

# JAX against the port at 64 random states of five models: 1-3 of 451,584
# pixels differed, every one under the rule.
MAX_DIFFER = 1e-3


def _states(task, n, seed):
    model = envpool_tpu_torch.make_spec(task, device="cpu").env.model
    r = np.random.default_rng(seed)
    q = np.tile(np.asarray(model.qpos0, np.float32), (n, 1))
    return model, q + r.uniform(-0.5, 0.5, q.shape).astype(np.float32)


def _check_rule(got, want, model, qpos, **view):
    edge, trunc = rasterize.rounding_pixels(model, torch.as_tensor(qpos), **view)
    v = rasterize.frame_rule_violations(got, want, edge, trunc)
    assert v["violations"] == 0, v
    assert v["differ"] <= MAX_DIFFER * v["pixels"], v
    return v


@pytest.mark.parametrize("task", ["HalfCheetah-v4", "CheetahRun-v1"])
def test_render_scene_matches_jax(task):
    model, q = _states(task, 12, seed=len(task))
    # The JAX model without its env (the JAX cheetah settles a bank when made).
    jmodel = (_load_dmc_model("cheetah")[0] if task == "CheetahRun-v1"
              else envpool_tpu.make_spec(task).env.model)
    want = jax.jit(jax.vmap(
        lambda x: jnp.clip(jax_render_scene(jmodel, x), 0, 255).astype(jnp.uint8)))(q)
    luma = rasterize.render_scene(model, torch.as_tensor(q))
    assert luma.dtype == torch.float32 and luma.shape == (12, 84, 84)
    got = torch.clamp(luma, 0, 255).to(torch.uint8)
    _check_rule(got, torch.as_tensor(np.array(want)), model, q)
    vals = set(got.unique().tolist())
    assert {168} <= vals and vals & {90, 110} and len(vals) > 4  # sky, floor, body


def test_pixel_grid_within_an_ulp_of_jax():
    for num in (84, 64, 100):
        want = np.asarray(jnp.linspace(-1.0, 1.0, num))
        got = rasterize.pixel_grid(2.0, num, num)[0]
        assert np.abs(got - want).max() <= np.spacing(np.float32(1.0))


def test_from_pixels_reset_and_step_match_jax():
    """HalfCheetah-v4 from pixels, 2 envs, 4 steps from JAX's states with
    episodes cut at 2 steps: the stacked frames under the frame rule, the
    rest of the timestep as the physics tests hold it."""
    n, steps = 2, 4
    pair = EnginePair("HalfCheetah-v4", n, _cheetah_draws(0.1), max_episode_steps=2,
                      from_pixels=True)
    model = pair.tenv.inner.model
    r = np.random.default_rng(5)
    acts = r.uniform(-1.0, 1.0, (steps + 1, n, 6)).astype(np.float32)
    tree = host(pair.jeng.step(pair.jeng.init(), {"action": jnp.asarray(acts[0])})[0])
    resets = 0
    for t in range(1, steps + 1):
        tree, jts, tts = pair.step(tree, acts[t])
        frames = jts.pop("obs")
        got = tts.pop("obs")
        assert got.shape == (n, 3, 84, 84) and got.dtype == torch.uint8
        assert_ts_close(jts, tts, STEP_TOL)
        qpos = tree["env_state"]["inner"]["qpos"]
        # The older slots are JAX's own frames, carried in the state.
        np.testing.assert_array_equal(got[:, :2].numpy(), frames[:, :2])
        _check_rule(got[:, 2], torch.as_tensor(np.array(frames[:, 2])), model, qpos)
        first = jts["step_type"] == 0
        resets += int(first.sum())
        assert (frames[first, 0] == frames[first, 2]).all()  # a reset fills every slot
    assert resets == n


def test_pixel_obs_shape_and_stacking():
    env = envpool_tpu_torch.make("HalfCheetah-v4", env_type="gymnasium", num_envs=2, seed=0,
                                 from_pixels=True, device="cpu")
    obs, info = env.reset()
    assert obs.shape == (2, 3, 84, 84) and obs.dtype == np.uint8
    np.testing.assert_array_equal(obs[0, 0], obs[0, 1])  # the first frame in every slot
    prev = obs.copy()
    stacks = [obs]
    for _ in range(4):
        obs, rew, term, trunc, info = env.step(
            np.random.default_rng(0).uniform(-1, 1, (2, 6)).astype(np.float32))
        stacks.append(obs)
    assert (obs[0, -1] != prev[0, -1]).any()  # the robot moved
    np.testing.assert_array_equal(stacks[-1][:, :2], stacks[-2][:, 1:])  # the stack rolls
    assert "qpos0" in info


def test_pixel_scene_content_and_sizes():
    env = envpool_tpu_torch.make("Hopper-v4", env_type="gymnasium", num_envs=1, seed=0,
                                 from_pixels=True, height=64, width=64, device="cpu")
    obs, _ = env.reset()
    vals = set(np.unique(obs[0, -1]).tolist())
    assert 168 in vals and (90 in vals or 110 in vals) and len(vals) > 4
    dm = envpool_tpu_torch.make_dm("WalkerWalk-v1", num_envs=2, seed=1, from_pixels=True,
                                   height=48, width=40, stack=2, device="cpu")
    ts = dm.reset()
    assert ts.observation.obs.shape == (2, 2, 48, 40)
    spec = envpool_tpu_torch.make_spec("CheetahRun-v1", from_pixels=True, device="cpu")
    jspec = envpool_tpu.make_spec("CheetahRun-v1", from_pixels=True)
    assert set(spec.state_array_spec) == set(jspec.state_array_spec)
    for k, js in jspec.state_array_spec.items():
        ts_ = spec.state_array_spec[k]
        assert (ts_.shape, ts_.dtype) == (js.shape, js.dtype), k


def test_from_pixels_rejects_non_physics_envs():
    for make, kw in ((envpool_tpu.make, {}), (envpool_tpu_torch.make, {"device": "cpu"})):
        with pytest.raises(ValueError, match="physics-backed env with a geom table "
                                             r"\(CartPoleEnv has none\)"):
            make("CartPole-v1", env_type="gymnasium", num_envs=1, seed=0, from_pixels=True,
                 **kw)


def test_pixel_keys_are_env_config_without_from_pixels():
    """Without ``from_pixels`` the pixel keys stay the env's own config
    (Catch's board size)."""
    env = envpool_tpu_torch.make_spec("Catch-v0", height=7, width=6, device="cpu").env
    assert (env.config["height"], env.config["width"]) == (7, 6)
