"""The port's 2600 frame (plain version of K2) against the JAX package.

The same carts and power-on states go through JAX's batched frame
(``machine_kernel._run_frame_batched``, which the JAX Machine2600 env runs
on the CPU: ``frame_batched`` + ``scatter_lines``) and through the port's
``machine_kernel.frame``.  Every state leaf, the collision latches and
the ``[N, 192, 24]`` lines buffer must be bit-equal.  The JAX frame is
jitted once per cart size, with the cart's tables as arguments, so every
4K cart shares one compile.

Also: the port's collision bits against JAX ``_collisions`` on random
register files, ``render_frame`` against JAX ``tia.render_frame``, and,
on the card only, K2 against the plain version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import machine_carts as carts
from envpool_tpu.envs.atari import cpu6502 as jcpu
from envpool_tpu.envs.atari import machine_kernel as jmk
from envpool_tpu.envs.atari import tia as jtia
from envpool_tpu_torch.envs.atari import cpu6502, machine_kernel, tia
from envpool_tpu_torch.ops.cuda_machine import machine_frame

CARTS = {
    "pong": carts.pong_rom,
    "f8": carts.f8_rom,
    "f6": carts.f6_rom,
    # Seed 0 reaches decimal ADC/SBC, (zp,X), (zp),Y, the stack, the 4K
    # window's last bytes and PCs in the $E000 mirror; seed 1 the window
    # edge and mirrors; seed 2 runs from RAM and TIA space.
    "random0": functools.partial(carts.random_rom, 0),
    "random1": functools.partial(carts.random_rom, 1),
    "random2": functools.partial(carts.random_rom, 2),
}
# (lanes, frames, different inputs per lane).  Random carts run identical
# lanes: JAX picks its fetch path for the whole batch at once, and only
# lanes in lockstep make it the per-lane rule the port implements (see
# the port's machine_kernel docstring).
SHAPE = {"pong": (4, 3, True), "f8": (2, 2, True), "f6": (2, 2, True)}


@functools.lru_cache(maxsize=None)
def _jax_frame(nbanks):
    def run(m, rom2d, decode, meta, indpair):
        return jmk._run_frame_batched(m, rom2d, decode, meta, indpair, nbanks)

    return jax.jit(run)


def _boot(rom, n, seed, differ=True):
    """Power-on machines with per-lane joystick inputs, JAX and port."""
    swcha, inpt4 = carts.lane_inputs(n, seed)
    if not differ:
        swcha, inpt4 = swcha[:1].repeat(n), inpt4[:1].repeat(n)
    m = jtia.attach_tia(jcpu.make_machine(rom))
    m = jax.tree_util.tree_map(lambda x: jnp.stack([x] * n), m)
    m = {**m, "swcha": jnp.asarray(swcha), "inpt4": jnp.asarray(inpt4)}
    g = tia.attach_tia(cpu6502.make_machine(rom, n, "cpu"))
    g.update(swcha=torch.as_tensor(swcha), inpt4=torch.as_tensor(inpt4))
    return m, g


def _assert_same(m, g, where):
    assert set(m) == set(g)
    for k, v in m.items():
        v = np.asarray(v)
        got = g[k].numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, (where, k)
        np.testing.assert_array_equal(got, v, err_msg=f"{where}: {k}")


@pytest.mark.parametrize("cart", list(CARTS))
def test_frame_matches_jax(cart):
    rom = CARTS[cart]()
    n, frames, differ = SHAPE.get(cart, (4, 1, False))
    tables = jmk.build_tables(rom)
    args = [jnp.asarray(tables[k]) for k in ("rom2d", "decode", "meta", "indpair")]
    ref = _jax_frame(tables["nbanks"])
    m, g = _boot(rom, n, seed=len(cart), differ=differ)
    _assert_same(m, g, "power-on")
    ttables = machine_kernel.build_tables(rom, "cpu")
    for f in range(frames):
        m = ref(m, *args)
        g = machine_kernel.frame(g, ttables)
        _assert_same(jax.device_get(m), g, f"{cart} frame {f}")
    if cart == "pong":  # the game ran: lines hold the paddle and ball
        assert int(g["lines"].sum()) != 0
        assert len(set(g["ram"][:, 0x82 & 0x7F].tolist())) > 1  # inputs differ


def test_diverging_lanes_match_jax_one_lane_at_a_time():
    """Lanes with their own inputs and RAM on a random cart: each lane of
    the port's batch equals JAX run on that lane alone (B=1), where JAX's
    batch-wide fetch rule is the lane's own.  This is the per-lane rule the
    port implements."""
    rom = carts.random_rom(0)
    n = 4
    tables = jmk.build_tables(rom)
    args = [jnp.asarray(tables[k]) for k in ("rom2d", "decode", "meta", "indpair")]
    ref = _jax_frame(tables["nbanks"])
    m, g = _boot(rom, n, seed=5)
    ram = np.random.default_rng(5).integers(0, 256, (n, 128)).astype(np.int32)
    m = {**m, "ram": jnp.asarray(ram)}
    g["ram"] = torch.as_tensor(ram)
    g = machine_kernel.frame(g, machine_kernel.build_tables(rom, "cpu"))
    for i in range(n):
        lane = jax.device_get(ref(jax.tree_util.tree_map(lambda x: x[i:i + 1], m), *args))
        _assert_same(lane, {k: v[i:i + 1] for k, v in g.items()}, f"lane {i}")
    assert len(set(g["pc"].tolist())) > 1  # the lanes took different paths


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors K2's wrapper is the plain frame and launches nothing;
    it fills the instruction counts it is given, and refuses a state or a
    counts buffer of the wrong dtype."""
    rom = carts.pong_rom()
    g = tia.attach_tia(cpu6502.make_machine(rom, 2, "cpu"))
    tables = machine_kernel.build_tables(rom, "cpu")
    before = machine_frame.launches
    counts = torch.zeros(2, dtype=torch.int32)
    got = machine_frame(g, tables, counts)
    want = machine_kernel.frame(g, tables)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert machine_frame.launches == before
    assert int(counts.min()) > 0
    with pytest.raises(ValueError, match="ram"):
        machine_frame({**g, "ram": g["ram"].to(torch.int64)}, tables)
    with pytest.raises(ValueError, match="counts"):
        machine_frame(g, tables, counts.to(torch.int64))


@pytest.mark.parametrize("cart", ["pong", "f8", "f6", "random0"])
def test_fetch_words_are_jax_meta_rows(cart):
    """K2's per-offset fetch word, read as little-endian bytes, is the JAX
    package's meta row (b0, b1, b2, mode, op, size, cycles, 0)."""
    rom = CARTS[cart]()
    want = jmk.build_tables(rom)["meta"].reshape(-1, 8)
    fetch = machine_kernel.build_tables(rom, "cpu")["fetch"]
    assert fetch.dtype == torch.int64 and fetch.shape == (want.shape[0],)
    got = fetch.numpy().view(np.uint8).reshape(-1, 8)
    np.testing.assert_array_equal(got, want.astype(np.uint8))


def _random_records(seed, n):
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 256, (n, tia.NREG)).astype(np.int32)
    for i in (tia.R_POSP0, tia.R_POSP1, tia.R_POSM0, tia.R_POSM1, tia.R_POSBL):
        rec[:, i] = rng.integers(0, 160, n)
    return rec


def test_collisions_match_jax():
    """All NUSIZ modes, reflections, scales, VDEL'd patterns and widths:
    512 random register files (seed 7, as the JAX package's own test)."""
    rec = _random_records(7, 512)
    want = np.asarray(jmk._collisions(jnp.asarray(rec.T))).T
    got = machine_kernel.collisions(torch.as_tensor(rec)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()


def test_render_matches_jax():
    """Random line records and the pong cart's lines after two frames."""
    rom = carts.pong_rom()
    g = tia.attach_tia(cpu6502.make_machine(rom, 1, "cpu"))
    tables = machine_kernel.build_tables(rom, "cpu")
    for _ in range(2):
        g = machine_kernel.frame(g, tables)
    lines = np.concatenate([
        _random_records(3, 2 * tia.VISIBLE_LINES).reshape(2, tia.VISIBLE_LINES, -1),
        g["lines"].numpy(),
    ])
    want = np.asarray(jax.vmap(jtia.render_frame)(jnp.asarray(lines)))
    got = tia.render_frame(torch.as_tensor(lines)).numpy()
    assert got.dtype == np.uint8 and got.shape == (3, 192, 160)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[2])) > 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 runs only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cart,n", [
    ("pong", 1), ("pong", 9), ("pong", 32), ("pong", 100), ("pong", 257),
    ("f8", 4), ("f8", 20), ("f6", 4), ("f6", 20), ("random0", 4),
    ("random0", 20),
])
def test_k2_matches_plain_on_card(cuda_device, cart, n):
    """K2 against the plain version over three frames, every leaf and each
    machine's instruction count, with lanes that differ.  K2 runs blocks of
    8 machines: 9, 20, 100 and 257 lanes span several blocks and leave the
    last one partly full."""
    rom = CARTS[cart]()
    swcha, inpt4 = carts.lane_inputs(n, 1)
    tables = machine_kernel.build_tables(rom, cuda_device)
    g = tia.attach_tia(cpu6502.make_machine(rom, n, cuda_device))
    g.update(swcha=torch.as_tensor(swcha, device=cuda_device),
             inpt4=torch.as_tensor(inpt4, device=cuda_device))
    plain = g
    got, want = (torch.zeros(n, dtype=torch.int32, device=cuda_device)
                 for _ in range(2))
    before = machine_frame.launches
    for f in range(3):
        g = machine_frame(g, tables, got)
        plain = machine_kernel.frame(plain, tables, want)
        torch.cuda.synchronize()
        for k in plain:
            assert torch.equal(g[k], plain[k]), f"frame {f}: {k}"
        assert torch.equal(got, want), f"frame {f}: instruction counts"
    assert machine_frame.launches == before + 3


@pytest.mark.gpu
def test_k2_collisions_match_plain_on_card(cuda_device):
    rec = torch.as_tensor(_random_records(7, 512))
    got = machine_frame.collisions(rec.to(cuda_device)).cpu()
    assert torch.equal(got, machine_kernel.collisions(rec).to(torch.int32))
