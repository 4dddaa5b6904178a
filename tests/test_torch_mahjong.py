"""The port's Sparrow Mahjong against the JAX package.

JAX deals again with ``fold_in`` keys inside a ``lax.while_loop`` until
the dealer holds no completed hand; the port cannot reproduce that key
chain, so the tests hand it JAX's final deal (the seats and the wall,
which JAX's state holds): the reset from it must equal JAX's in every
field, and ``step_env`` from JAX's states, by legal discards, must equal
JAX's ``step_env`` in every field, across finished games.  The port's own
redeal leaves no completed dealer's hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import envpool_tpu
import envpool_tpu_torch
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.envs.board import sparrow_mahjong
from test_torch_toy_text import assert_trees_equal, assert_uniform

N = 8


def _tree(x):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in x.items()}


def test_reset_from_jax_deal_and_steps_match_jax():
    jenv = envpool_tpu.make_spec("SparrowMahjong-v1", num_envs=N).env
    tenv = envpool_tpu_torch.make_spec("SparrowMahjong-v1", num_envs=N, device="cpu").env
    keys = jax.random.split(jax.random.PRNGKey(7), 64)
    reset = jax.jit(jax.vmap(jenv.reset_env))

    def step_one(s, a, k):
        out = jenv.step_env(s, a, k)
        return out.state, out.obs, out.reward, out.terminated

    step = jax.jit(jax.vmap(step_one))
    bank_st, bank_obs = jax.device_get(reset(keys))
    # the resets: the port's from JAX's final deals
    draws = {"rows": torch.zeros((64, 0), dtype=torch.int8),
             "seats": torch.as_tensor(bank_st["shuffled"]),
             "wall": torch.as_tensor(bank_st["wall"])}
    st, obs = tenv.reset_env(draws)
    assert_trees_equal(bank_st, st, "reset state")
    assert_trees_equal(bank_obs, obs, "reset obs")
    # the steps: legal discards (and a few uniform ones) from JAX's states
    gen = np.random.default_rng(0)
    state = jax.tree.map(lambda x: x[:N], bank_st)
    fresh, ends, rewarded = N, 0, 0
    for t in range(40):
        legal = np.asarray(state["legal"])
        act = np.where(legal, gen.random(legal.shape), -1).argmax(1)
        act = np.where(gen.random(N) < 0.05, gen.integers(0, 11, N), act).astype(np.int32)
        act = np.repeat(act[:, None], 3, 1)
        w_state, w_obs, w_reward, w_term = jax.device_get(
            step(state, jnp.asarray(act), keys[:N]))
        got = tenv.step_env(_tree(state), torch.as_tensor(act), {})
        assert_trees_equal(w_state, got.state, f"step {t} state")
        assert_trees_equal(w_obs, got.obs, f"step {t} obs")
        assert_trees_equal(w_reward, got.reward, f"step {t} reward")
        assert_trees_equal(w_term, got.terminated, f"step {t} terminated")
        done = np.asarray(w_term)
        ends += int(done.sum())
        # (a won hand's score / 26, not the +-1 of an illegal discard)
        rewarded += int(((np.abs(np.asarray(w_reward)) != 1) & (np.asarray(w_reward) != 0))
                        .any(1).sum())
        state = jax.tree.map(np.array, w_state)
        for i in np.flatnonzero(done):  # a finished game: a fresh deal of the bank
            for k in state:
                state[k][i] = bank_st[k][fresh % 64]
            fresh += 1
    assert ends > 0 and rewarded > 0


def test_port_redeal_and_draws():
    """The port's deals: no dealer holds a completed hand after its first
    draw, the wall and the seats are permutations, the seats uniform."""
    n = 20000
    env = envpool_tpu_torch.make_spec("SparrowMahjong-v1", num_envs=n, seed=3,
                                      device="cpu").env
    draws = env.reset_draws(rng.split(env.keys())[1])
    assert (np.sort(draws["wall"].numpy(), 1) == np.arange(44)).all()
    assert (np.sort(draws["seats"].numpy(), 1) == np.arange(3)).all()
    assert_uniform(draws["seats"][:, 0].numpy(), 0, 2, "dealer")
    st, _ = env.reset_env(draws)
    assert not sparrow_mahjong.is_completed(st["hands"][:, 0]).any()
    # the first deal alone: some rows were dealt again
    d = rng.Draws(rng.split(env.keys())[1])
    env.plan_reset(d)
    first = sparrow_mahjong.deal(d.out["seats"], d.out["wall"])
    redealt = sparrow_mahjong.is_completed(first["hands"][:, 0])
    assert 0 < int(redealt.sum()) < n // 10
    assert not torch.equal(d.out["wall"], draws["wall"])
