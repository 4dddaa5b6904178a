"""The port's highway lane-network ids against the JAX package: Merge,
Exit, TwoWay, UTurn, Roundabout, the four Intersection ids and the three
racetracks.

The harness is ``test_torch_highway``'s: both engines step from one JAX
pool state, the port with the draws recorded inside JAX's jitted engine
step, every step held by the rule of ``envpool_tpu_torch/ops/thresholds.py``
(fields within 1e-5 * (1 + |x|), an env whose step lies within that of a
threshold excused, at most 1% of the env steps; a reset, the scenario's
fixed start with Merge's noise, has no excuse).  The packed lane and
vehicle tables of every scenario equal ``net_scenarios._pack_scenario``'s
exactly.
"""

import numpy as np
import pytest

from envpool_tpu.envs.highway import net_scenarios as jax_net
from envpool_tpu_torch.envs.highway import net_scenarios
from test_torch_highway import check_rollout
from test_torch_toy_text import assert_trees_equal


@pytest.mark.parametrize("name", sorted(jax_net._BUILDERS))
def test_pack_scenario_matches_jax(name):
    want = jax_net._pack_scenario(name)
    got = net_scenarios._pack_scenario(name)
    for w, g in zip(want[:2], got[:2]):
        assert_trees_equal(w, g, name)
    assert set(want[2]) == set(got[2])
    for k in want[2]:
        np.testing.assert_array_equal(np.asarray(got[2][k]), np.asarray(want[2][k]), k)


# (task, steps, episode cut, config): each crosses an auto-reset.
CASES = [
    ("Merge-v0", 6, 4, {}),
    ("Exit-v0", 6, 4, {}),
    ("TwoWay-v0", 6, 4, {}),
    ("UTurn-v0", 6, 4, {}),
    ("Roundabout-v0", 6, 4, {}),
    ("Intersection-v0", 6, 4, {}),
    ("Intersection-v1", 6, 4, {}),
    ("IntersectionMultiAgent-v0", 6, 4, {"max_num_players": 2}),
    ("Racetrack-v0", 8, 6, {}),
    ("RacetrackLarge-v0", 8, 6, {}),
    ("RacetrackOval-v0", 8, 6, {}),
]


@pytest.mark.parametrize("task,steps,episode,cfg", CASES, ids=[c[0] for c in CASES])
def test_rollout_matches_jax(task, steps, episode, cfg, monkeypatch):
    _, trees, seen, _ = check_rollout(task, monkeypatch, steps, episode, **cfg)
    rewards = np.stack([np.asarray(ts["reward"]) for ts in seen])
    assert np.isfinite(rewards).all()
    # the reset is the scenario's start (with Merge's noise), bit for bit
    jax_first, port_first = (t["env_state"] for t in trees[0])
    assert_trees_equal(jax_first, port_first, f"{task} reset")
