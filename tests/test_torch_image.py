"""K1 and its plain version in envpool_tpu_torch against the JAX package.

The port's plain ``resize_area(maxpool2(...))`` and the K1 wrapper are
held against JAX ``resize_area(maxpool2(...))`` and the Pallas kernel in
interpret mode, on the same numpy frames.  Tolerance (the tie rule): equal
everywhere except at pixels whose exact float64 value is a ``k + 0.5`` tie
(within 1e-4), where the two float32 summation orders may differ by 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envpool_tpu.ops import image as jax_image
from envpool_tpu.ops.pallas_image import fused_pool_resize as pallas_pool_resize
from envpool_tpu_torch.ops import image as torch_image
from envpool_tpu_torch.ops.cuda_image import fused_pool_resize


def _frames(seed, shape, integer=True):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(0, 256, shape).astype(np.float32)
    return rng.uniform(0, 255, shape).astype(np.float32)


def _assert_tie_rule(port, ref, frames, out_hw):
    """``frames`` [N, 2, ..., H, W]: port/ref u8 results of the pooled resize."""
    f = torch.as_tensor(frames)
    ties = torch_image.area_ties(f[:, 0], f[:, 1], out_hw)
    bad, _ = torch_image.tie_rule_violations(
        torch.as_tensor(np.array(port)), torch.as_tensor(np.array(ref)), ties
    )
    assert bad == 0


def _jax_pool_resize(frames, out_hw):
    f = jnp.asarray(frames)
    return np.asarray(
        jax_image.resize_area(jax_image.maxpool2(f[:, 0], f[:, 1]), out_hw, jnp.uint8)
    )


def test_area_weights_copied_unchanged():
    for n_in, n_out in ((210, 84), (160, 84), (210, 42), (160, 200), (7, 3)):
        np.testing.assert_array_equal(
            torch_image._area_weights(n_in, n_out),
            jax_image._area_weights(n_in, n_out),
        )


@pytest.mark.parametrize(
    "n_in,n_out", [(210, 84), (160, 84), (210, 50), (160, 37), (84, 210), (3, 8)]
)
def test_area_bands_match_dense_weights(n_in, n_out):
    start, count, weight = torch_image.area_bands(n_in, n_out)
    dense = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        dense[o, start[o] : start[o] + count[o]] = weight[o, : count[o]]
    np.testing.assert_array_equal(dense, jax_image._area_weights(n_in, n_out))
    # Each output reads at most ceil(n_in / n_out) + 1 inputs.
    assert count.max() <= -(-n_in // n_out) + 1


@pytest.mark.parametrize(
    "out_hw,rgb,integer",
    [
        ((84, 84), False, True),
        ((84, 84), True, True),
        ((84, 84), False, False),
        ((50, 37), False, True),
        ((50, 37), True, True),
    ],
)
def test_plain_pool_resize_matches_jax(out_hw, rgb, integer):
    shape = (3, 2, 3, 210, 160) if rgb else (6, 2, 210, 160)
    frames = _frames(11, shape, integer)
    f = torch.as_tensor(frames)
    port = torch_image.resize_area(torch_image.maxpool2(f[:, 0], f[:, 1]), out_hw)
    ref = _jax_pool_resize(frames, out_hw)
    assert port.dtype == torch.uint8 and tuple(port.shape) == ref.shape
    _assert_tie_rule(port, ref, frames, out_hw)


def test_wrapper_on_cpu_matches_pallas_interpret():
    frames = _frames(12, (2, 2, 210, 160))
    port = fused_pool_resize(torch.as_tensor(frames), (84, 84))
    ref = np.asarray(pallas_pool_resize(jnp.asarray(frames), (84, 84), interpret=True))
    _assert_tie_rule(port, ref, frames, (84, 84))
    np.testing.assert_array_equal(
        port.numpy(), torch_image.pool_resize(torch.as_tensor(frames), (84, 84)).numpy()
    )


def test_ties_occur_and_are_detected():
    """Integer frames hit exact .5 ties; the float64 test finds them."""
    frames = torch.as_tensor(_frames(13, (4, 2, 210, 160)))
    ties = torch_image.area_ties(frames[:, 0], frames[:, 1], (84, 84))
    assert 0 < int(ties.sum()) < ties.numel() // 10
    exact = torch_image.resize_area(
        torch.maximum(frames[:, 0], frames[:, 1]).double(), (84, 84), torch.float64
    )
    frac = (exact - exact.floor())[ties]
    assert bool(((frac - 0.5).abs() < 1e-4).all())


def test_tie_rule_rejects_off_tie_and_large_differences():
    a = torch.full((1, 2, 2), 10, dtype=torch.uint8)
    ties = torch.tensor([[[True, False], [False, False]]])
    b = a.clone()
    b[0, 0, 0] = 11
    assert torch_image.tie_rule_violations(a, b, ties) == (0, 1)
    b[0, 0, 1] = 11
    assert torch_image.tie_rule_violations(a, b, ties)[0] == 1
    b = a.clone()
    b[0, 0, 0] = 12
    assert torch_image.tie_rule_violations(a, b, ties)[0] == 1


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        fused_pool_resize(torch.zeros(2, 3, 10, 10), (5, 5))
    with pytest.raises(TypeError):
        fused_pool_resize(torch.zeros(2, 2, 10, 10, dtype=torch.float64), (5, 5))
    with pytest.raises(ValueError):
        fused_pool_resize(torch.zeros(2, 2, 10, 10, device="meta"), (5, 5))


def test_cpu_path_does_not_count_launches():
    before = fused_pool_resize.launches
    fused_pool_resize(torch.zeros(2, 2, 21, 16), (8, 8))
    assert fused_pool_resize.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 runs only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("out_hw", [(84, 84), (50, 37), (300, 200)])
def test_k1_kernel_matches_plain_on_card(cuda_device, out_hw):
    frames = torch.as_tensor(_frames(14, (64, 2, 210, 160))).to(cuda_device)
    before = fused_pool_resize.launches
    got = fused_pool_resize(frames, out_hw)
    torch.cuda.synchronize()
    assert fused_pool_resize.launches == before + 1
    ref = torch_image.pool_resize(frames, out_hw)
    ties = torch_image.area_ties(frames[:, 0], frames[:, 1], out_hw)
    assert torch_image.tie_rule_violations(got, ref, ties)[0] == 0


def _exact_tie_frames():
    """4x4 -> 2x2 has weights 1/2, so these pooled blocks average to exactly
    k + 0.5 in float32: 2.5, 3.5, 254.5 and 0.5."""
    pooled = np.array(
        [[2, 3, 3, 4], [2, 3, 3, 4], [254, 255, 0, 1], [254, 255, 0, 1]],
        np.float32,
    )
    frames = np.stack([pooled, pooled - 1])[None]  # max() picks `pooled`
    return frames, np.array([[[2, 4], [254, 0]]], np.uint8)


def test_rounds_half_to_even_like_jax():
    frames, expect = _exact_tie_frames()
    port = fused_pool_resize(torch.as_tensor(frames), (2, 2))
    np.testing.assert_array_equal(port.numpy(), expect)
    np.testing.assert_array_equal(_jax_pool_resize(frames, (2, 2)), expect)


@pytest.mark.gpu
def test_k1_rounds_half_to_even_on_card(cuda_device):
    frames, expect = _exact_tie_frames()
    got = fused_pool_resize(torch.as_tensor(frames).to(cuda_device), (2, 2))
    np.testing.assert_array_equal(got.cpu().numpy(), expect)
