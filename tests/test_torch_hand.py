"""The port's HandManipulate envs (Block, Egg and Pen, every rotation
mode, both touch-sensor modes) against the JAX package, and the Shadow
Hand's rotation helpers.

The harness is ``test_torch_robotics.py``'s: both engines step from one
JAX pool state with JAX's draws (``uniform``, ``randint``, ``normal``)
recorded inside its jitted step and handed to the port by position, every
step held by the rule of ``envpool_tpu_torch/ops/thresholds.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu_torch
from envpool_tpu.envs.robotics import hand as jax_hand
from envpool_tpu_torch.envs.robotics import hand
from test_torch_robotics import check_rollout


@pytest.mark.parametrize("task", [
    "HandManipulateBlock-v1",                                   # random, xyz
    "HandManipulateBlockRotateParallel_BooleanTouchSensors-v1",  # parallel, boolean
    "HandManipulateBlockRotateXYZ_ContinuousTouchSensorsDense-v1",
    "HandManipulateBlockRotateZ-v1",                             # z
    "HandManipulateEgg_BooleanTouchSensorsDense-v0",
    "HandManipulateEggRotate_ContinuousTouchSensors-v1",
    "HandManipulatePenDense-v1",                                 # ignore_z, no initial turn
    "HandManipulatePenRotate_BooleanTouchSensors-v1",
])
def test_manipulate_matches_jax(task, monkeypatch):
    check_rollout(task, monkeypatch)


def _quats(n, seed):
    q = np.random.default_rng(seed).standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_rotation_helpers_match_jax():
    """quat_mul, quat_conj, quat_from_angle_axis, quat2euler and
    euler2quat against the JAX package's on random inputs; the 24 parallel
    quaternions equal."""
    a, b = _quats(256, 0), _quats(256, 1)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    rtol = dict(rtol=0, atol=2e-6)
    jit = jax.jit
    np.testing.assert_allclose(hand.quat_mul(ta, tb).numpy(),
                               np.asarray(jit(jax_hand.quat_mul)(a, b)), **rtol)
    np.testing.assert_array_equal(hand.quat_conj(ta).numpy(),
                                  np.asarray(jit(jax_hand.quat_conj)(a)))
    e = np.asarray(jit(jax_hand.quat2euler)(a))
    np.testing.assert_allclose(hand.quat2euler(ta).numpy(), e, **rtol)
    np.testing.assert_allclose(hand.euler2quat(torch.as_tensor(e)).numpy(),
                               np.asarray(jit(jax_hand.euler2quat)(e)), **rtol)
    angle = np.random.default_rng(2).uniform(-np.pi, np.pi, 256).astype(np.float32)
    axis = np.random.default_rng(3).uniform(-1, 1, (256, 3)).astype(np.float32)
    want = np.asarray(jit(jax.vmap(jax_hand.quat_from_angle_axis))(angle, axis))
    got = hand.quat_from_angle_axis(torch.as_tensor(angle), torch.as_tensor(axis)).numpy()
    np.testing.assert_allclose(got, want, **rtol)
    np.testing.assert_array_equal(hand.PARALLEL_QUATS, jax_hand.PARALLEL_QUATS)


def test_goal_distance_and_reward_match_jax():
    """goal_distance (the ``ignore_z`` path through Euler angles too),
    is_success and compute_reward, sparse and dense.  Where the rotation is
    achieved (the difference quaternion's ``w`` within float32 rounding of
    1), ``2 acos(w)`` turns an ulp of ``w`` into ~1e-3 of angle: there the
    two agree within 2e-3."""
    import envpool_tpu

    gen = np.random.default_rng(4)
    pos = gen.uniform(0.9, 1.1, (256, 3)).astype(np.float32)
    a = np.concatenate([pos, _quats(256, 5)], 1)
    b = np.concatenate([pos + gen.normal(0, 0.01, (256, 3)).astype(np.float32),
                        _quats(256, 6)], 1)
    b[:64, 3:] = a[:64, 3:]  # some achieved rotations
    for task in ("HandManipulateBlockDense-v1", "HandManipulatePen-v1",
                 "HandManipulateEggRotate-v1"):
        jenv = envpool_tpu.make_spec(task, num_envs=2).env
        tenv = envpool_tpu_torch.make_spec(task, num_envs=2, device="cpu").env
        want = [np.asarray(x) for x in jax.jit(jenv.goal_distance)(jnp.asarray(a),
                                                                   jnp.asarray(b))]
        got = [x.numpy() for x in tenv.goal_distance(torch.as_tensor(a), torch.as_tensor(b))]
        # |w| within rounding of 1: an angle near 0 (or 2 pi, where the
        # Euler round trip of ignore_z flips the quaternion's sign).
        achieved = (want[1] < 2e-3) | (want[1] > 2 * np.pi - 2e-3)
        assert achieved[:64].all() and not achieved[64:].any()
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[1][~achieved], want[1][~achieved], rtol=0,
                                   atol=1e-5 * (1 + np.abs(want[1])).max())
        np.testing.assert_allclose(got[1][achieved], want[1][achieved], rtol=0, atol=2e-3)
        succ = tenv.is_success(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        np.testing.assert_array_equal(succ, np.asarray(jax.jit(jenv.is_success)(a, b)))
        np.testing.assert_allclose(
            tenv.compute_reward(torch.as_tensor(a), torch.as_tensor(b)).numpy()[~achieved],
            np.asarray(jax.jit(jenv.compute_reward)(a, b))[~achieved], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tenv.W, jenv.W)
