"""The port's vizdoom family against the JAX package.

Both engines step from one JAX pool state, carried into the port by
``envpool_tpu_torch.interop``, and the port is handed the draws the JAX
env makes from its threefry keys, in the port's draw layout.  Each case
runs a rollout of 8 envs that crosses auto-reset, held by the rule of
``envpool_tpu_torch/ops/thresholds.py`` (the raycaster's ``sin``, ``cos``,
``atan`` and the reward's sum differ by an ulp between XLA and ATen):
fields within 1e-5 * (1 + |x|), an env whose step lies within that of a
threshold excused (at most 1% of the env steps), frames equal but at
pixels float rounding decides (at most 1e-3 of the pixels).  The cases:
Basic-v1 (float buttons), DefendTheCenter-v1 (chasing, biting, respawning
monsters), MyWayHome-v1 (a goal), D3Battle-v1 on the combined action set
(items, ranged monsters), D1Basic-v1 at 48x64 (the area resize),
RocketBasic-v1 (rockets), TakeCover-v1 (fireballs) and
HealthGatheringSupreme-v1 (medkits and poison on an acid floor).
"""

import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
import jax
import jax.numpy as jnp
from envpool_tpu.core.engine import Engine as JaxEngine
from envpool_tpu.core.registry import registry as jax_registry
from envpool_tpu.envs.vizdoom import raycast as jax_raycast
from envpool_tpu.envs.vizdoom import wad as jax_wad
from envpool_tpu.envs.vizdoom.doom_env import shaped_reward as jax_shaped_reward
from envpool_tpu_torch import interop
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.core.engine import Engine
from envpool_tpu_torch.envs.vizdoom import raycast, wad
from envpool_tpu_torch.envs.vizdoom.doom_env import shaped_reward
from envpool_tpu_torch.ops import thresholds
from test_torch_classic import host, to_jax
from test_torch_procgen import _tensors, assert_same_layout
from test_torch_toy_text import assert_trees_equal, assert_uniform
from test_vizdoom import _build_wad

VIZDOOM = [t for t, (path, _, _) in jax_registry.specs.items() if path.endswith(".vizdoom")]
N = 8


def _cells(key, n, nf):
    return jax.vmap(lambda k: jax.random.randint(k, (), 0, nf))(jax.random.split(key, n))


def _reset_draws(jenv, sub):
    """JAX's reset draws (``_init_world``) in the port's layout."""
    k1, k2, k3, _ = jax.random.split(sub, 4)
    nf = jenv.free_cells.shape[0]
    return {
        "spawn_cell": jax.random.randint(k1, (), 0, nf),
        "spawn_ang": jax.random.uniform(k1, (), minval=0.0, maxval=2 * np.pi),
        "monster_u": jax.random.uniform(k2, (jenv.nm,)),
        "monster_cell": _cells(k2, jenv.nm, nf),
        "item_cell": _cells(k3, jenv.ni, nf),
    }


def _step_draws(jenv, sub):
    """JAX's step draws (``step_env``) in the port's layout."""
    ks = jax.random.split(sub, 6)
    nf = jenv.free_cells.shape[0]
    return {
        "respawn_u": jax.random.uniform(ks[1], (jenv.nm,)),
        "respawn_cell": _cells(ks[1], jenv.nm, nf),
        "fb_dx": jax.random.uniform(ks[2], (), minval=-1.5, maxval=1.5),
        "item_cell": _cells(ks[3], jenv.ni, nf),
    }


class DoomPair:
    """A JAX engine and a port engine over one vizdoom id, the port with
    JAX's draws (one jitted JAX program for a step's draws)."""

    def __init__(self, task, n=N, **cfg):
        jenv = envpool_tpu.make_spec(task, num_envs=n, seed=5, **cfg).env
        self.jeng = JaxEngine(jenv)
        self.tenv = envpool_tpu_torch.make_spec(task, num_envs=n, seed=5, device="cpu",
                                                **cfg).env
        self.teng = Engine(self.tenv)

        def one(key):
            sub = jax.random.split(key)[1]
            return _reset_draws(jenv, sub), _step_draws(jenv, sub)

        self.draws = jax.jit(jax.vmap(one))

    def step(self, tree, action):
        reset, step = (_tensors(d) for d in jax.device_get(self.draws(jnp.asarray(tree["key"]))))
        self.tenv.reset_draws = lambda sub: reset
        self.tenv.step_draws = lambda sub: step
        jps, jts = self.jeng.step(to_jax(tree), {"action": jnp.asarray(action)})
        tps, tts = self.teng.step(interop.pool_state_from_numpy(tree, "cpu"),
                                  {"action": torch.as_tensor(action)})
        return host(jps), jax.device_get(jts), interop.pool_state_to_numpy(tps), tts, step


def _actions(spec, steps, seed):
    r = np.random.default_rng(seed)
    if spec.is_discrete:
        return r.integers(spec.minimum, spec.maximum + 1, (steps + 1, N)).astype(np.int32)
    return r.random((steps + 1, N, *spec.shape)).astype(np.float32)


def run_doom(pair, steps, seed):
    """``steps`` steps of both engines from the JAX pool's first reset,
    each held by the rule; returns the JAX timesteps and the rule's
    totals."""
    acts = _actions(pair.tenv.action_spec()["action"], steps, seed)
    tree = host(pair.jeng.step(pair.jeng.init(), {"action": jnp.asarray(acts[0])})[0])
    seen, totals = [], {}
    for t in range(1, steps + 1):
        before = tree
        tree, jts, ttree, tts, draws = pair.step(tree, acts[t])
        for k in ("elapsed", "autoreset", "full_reset"):
            assert_trees_equal(tree[k], ttree[k], f"step {t} {k}")
        want = {"state": _tensors(tree["env_state"]), "ts": _tensors(dict(jts))}
        got = {"state": _tensors(ttree["env_state"]), "ts": dict(tts)}
        assert_same_layout(want, got, f"step {t}")
        v = thresholds.hold_step(pair.tenv, _tensors(before["env_state"]),
                                 torch.as_tensor(acts[t]), draws,
                                 torch.as_tensor(before["autoreset"]), want, got)
        assert v["failed"] == 0 and v["violations"] == 0, (t, v)
        for k, x in v.items():
            totals[k] = totals.get(k, 0) + x
        seen.append(jts)
    return seen, totals


CASES = [
    ("Basic-v1", {}),
    ("DefendTheCenter-v1", {}),
    ("MyWayHome-v1", {}),
    ("D3Battle-v1", {"use_combined_action": True}),
    ("D1Basic-v1", {"use_combined_action": True, "img_height": 48, "img_width": 64}),
    ("RocketBasic-v1", {}),
    ("TakeCover-v1", {}),
    ("HealthGatheringSupreme-v1", {}),
]


@pytest.mark.parametrize("task, cfg", CASES, ids=[c[0] + ("+" if c[1] else "") for c in CASES])
def test_rollout_matches_jax(task, cfg):
    """8 envs, 20 steps, episodes cut at 7 steps."""
    pair = DoomPair(task, max_episode_steps=7, **cfg)
    seen, totals = run_doom(pair, 20, seed=len(task))
    first = np.stack([ts["step_type"] == 0 for ts in seen])
    assert first[1:].any(), "no auto-reset"
    assert totals["excused"] <= thresholds.MAX_EXCUSED_SHARE * totals["envs"], totals
    assert totals["differ"] <= thresholds.MAX_PIXEL_SHARE * totals["pixels"], totals
    if task == "Basic-v1":  # the shot monster dies, and that ends the episode
        rewards = np.stack([ts["reward"] for ts in seen])
        assert (rewards != 0).any()


def test_every_vizdoom_id_is_ported():
    ids = [t for t, (path, _, _) in envpool_tpu_torch.core.registry.registry.specs.items()
           if path.endswith(".vizdoom")]
    assert ids == VIZDOOM and len(ids) == 21 and "VizdoomCustom-v1" in ids


def test_config_and_spec_match_jax():
    for task in VIZDOOM:
        for cfg in ({}, {"use_combined_action": True, "force_speed": True}):
            jspec = envpool_tpu.make_spec(task, num_envs=2, **cfg)
            tspec = envpool_tpu_torch.make_spec(task, num_envs=2, device="cpu", **cfg)
            assert dict(tspec.env.config, device="cuda") == dict(jspec.env.config, device="cuda")
            assert repr(tspec.action_array_spec) == repr(jspec.action_array_spec), task
            assert repr(tspec.state_array_spec) == repr(jspec.state_array_spec), task
            np.testing.assert_array_equal(tspec.env.action_set.numpy(),
                                          np.asarray(jspec.env.action_set))


def test_wad_matches_jax(tmp_path):
    """``wad_to_grid`` on the synthetic WAD of ``tests/test_vizdoom.py``
    (a room and a blocking divider with a gap) equals JAX's, and an env
    made with ``wad_path`` walks that grid as JAX's does."""
    verts = [(0, 0), (512, 0), (512, 512), (0, 512), (0, 256), (384, 256)]
    lines = [(0, 1, 0, 0, 0, 0, -1), (1, 2, 0, 0, 0, 0, -1), (2, 3, 0, 0, 0, 0, -1),
             (3, 0, 0, 0, 0, 0, -1), (4, 5, 1, 0, 0, 0, 1)]
    path = tmp_path / "scenario.wad"
    _build_wad(path, verts, lines)
    for fn in ("parse_wad_map",):
        for a, b in zip(getattr(wad, fn)(str(path)), getattr(jax_wad, fn)(str(path))):
            np.testing.assert_array_equal(a, b)
    for g in (16, 24):
        np.testing.assert_array_equal(wad.wad_to_grid(str(path), g=g),
                                      jax_wad.wad_to_grid(str(path), g=g))
    cfg = {"wad_path": str(path), "use_combined_action": True}
    jenv = envpool_tpu.make_spec("Basic-v1", num_envs=2, **cfg).env
    tenv = envpool_tpu_torch.make_spec("Basic-v1", num_envs=2, device="cpu", **cfg).env
    np.testing.assert_array_equal(tenv.sc.grid, jenv.sc.grid)
    assert (tenv.walls.numpy() == np.asarray(jenv.walls)).all()
    pool = envpool_tpu_torch.make_gymnasium("Basic-v1", num_envs=2, device="cpu", **cfg)
    obs, _ = pool.reset()
    for _ in range(4):
        obs, rew, term, trunc, info = pool.step(np.array([1, 2], np.int32))
    assert obs.shape == (2, 12, 84, 84) and np.isfinite(rew).all()


def test_dda_caster_matches_jax():
    """The DDA caster (used without wall boxes; not on the scenarios'
    path) against JAX's over random poses in two arenas: wall type and
    side equal in at least 99% of the columns, and the distance within
    1e-5 * (1 + d) wherever they are."""
    from envpool_tpu_torch.envs.vizdoom.scenarios import SCENARIOS

    r = np.random.default_rng(3)
    for name in ("basic", "my_way_home", "deathmatch"):
        grid = SCENARIOS[name].grid
        free = np.argwhere(grid == 0)
        pts = free[r.integers(0, len(free), 16)][:, ::-1] + r.random((16, 2)) * 0.8 + 0.1
        ang = r.random(16) * 2 * np.pi
        px, py, an = (x.astype(np.float32) for x in (pts[:, 0], pts[:, 1], ang))
        want = jax.vmap(lambda x, y, a: jax_raycast.cast_rays(jnp.asarray(grid), x, y, a))(
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(an))
        got = raycast.cast_rays(torch.as_tensor(grid), *(torch.as_tensor(x) for x in (px, py, an)))
        want = [np.asarray(w) for w in want]
        got = [g.numpy() for g in got]
        same = (want[1] == got[1]) & (want[2] == got[2])
        assert same.mean() >= 0.99, name
        np.testing.assert_allclose(got[0][same], want[0][same], rtol=1e-5, atol=1e-5)
        boxes = raycast.extract_cells(grid)
        for a, b in zip(boxes, jax_raycast.extract_cells(grid)):
            np.testing.assert_array_equal(a, b)


def test_shaped_reward_matches_jax():
    r = np.random.default_rng(0)
    gvs = r.normal(0, 50, (256, 16)).astype(np.float32)
    last = gvs + r.normal(0, 30, (256, 16)).astype(np.float32)
    gvs[:, 13] = r.integers(-1, 9, 256)
    sel = r.integers(0, 8, 256).astype(np.int32)
    want = np.asarray(jax.vmap(lambda g, l, s: jax_shaped_reward(g, l, s, 5))(gvs, last, sel))
    got = shaped_reward(*(torch.as_tensor(x) for x in (gvs, last, sel)), 5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_port_draws_range():
    env = envpool_tpu_torch.make_spec("D3Battle-v1", num_envs=20000, device="cpu").env
    _, sub = rng.split(env.keys())
    d = env.reset_draws(sub)
    nf = env.free_cells.shape[0]
    for k in ("spawn_cell", "monster_cell", "item_cell"):
        assert_uniform(d[k].numpy(), 0, nf - 1, k)
    ang = d["spawn_ang"].numpy()
    assert 0 <= ang.min() and ang.max() < 2 * np.pi and ang.max() > 6.2
    s = env.step_draws(sub)
    assert -1.5 <= s["fb_dx"].min() and s["fb_dx"].max() < 1.5
    assert abs(np.corrcoef(d["monster_u"][:, 0], d["monster_u"][:, 1])[0, 1]) < 0.05
