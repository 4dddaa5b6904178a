"""The rule that holds a float env of the port to a reference that
computes the same floats by other instructions (the card against the
CPU, the port against the JAX package): procgen's scroller and platformer
games, vizdoom and highway.

Their state is float (positions, speeds, angles), a float comparison
decides a hit, a pickup or a block, and rounding decides a pixel.  Two
devices whose ``sin``, ``atan2`` or summation order differ by an ulp land
on different sides of such a threshold now and then.  So one step from the
same state is held as follows:

* Every field but the frames (uint8 leaves) is equal, floats within
  ``STATE_TOL * (1 + |want|)``, except in an env whose outcome lies within
  that tolerance of a threshold: one whose step from its state nudged by
  ``STATE_TOL`` (``NUDGES`` sign patterns over every float leaf) changes an
  integer or boolean field, or a float one by more than ``FLIP_TOL``.  Such
  envs are counted and left out; a caller allows at most
  ``MAX_EXCUSED_SHARE`` of its env steps.  A reset (the level or world
  drawn from integer draws) has no excuse.
* A frame may differ only at pixels that float rounding decides
  (:func:`threshold_pixels`, in float64), and at most
  ``MAX_PIXEL_SHARE`` of all pixels may differ
  (:func:`envpool_tpu_torch.ops.rasterize.frame_rule_violations`).

An env that is integer throughout (procgen's grid games) has no float leaf
to nudge, so the rule asks it to be equal in every field.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .rasterize import frame_rule_violations

__all__ = [
    "FLIP_TOL",
    "MAX_EXCUSED_SHARE",
    "MAX_PIXEL_SHARE",
    "NUDGES",
    "ROUND_EPS",
    "STATE_TOL",
    "close_rows",
    "hold_step",
    "near_threshold",
    "nudged",
    "threshold_pixels",
]

STATE_TOL = 1e-5
NUDGES = 8
FLIP_TOL = 1e-3
MAX_EXCUSED_SHARE = 0.01
MAX_PIXEL_SHARE = 1e-3
# A float64 frame value within ROUND_EPS of a rounding boundary (k + 0.5)
# may round either way in float32.
ROUND_EPS = 1e-4


def _leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rows(tree: Any, idx: torch.Tensor) -> Any:
    """The rows ``idx`` of every leaf."""
    return _map(lambda t: t[idx], tree)


def nudged(tree: Any, tol: float = STATE_TOL, k: int = NUDGES) -> list:
    """``k`` copies of ``tree`` with every float leaf ``x`` moved by
    ``s * tol * (1 + |x|)``, ``s`` = +1 everywhere, -1 everywhere, then
    ``k - 2`` patterns of random signs (a fixed generator)."""
    gen = torch.Generator().manual_seed(0)
    out = []
    for j in range(k):
        def move(x):
            if not x.is_floating_point():
                return x
            if j < 2:
                s = 1.0 - 2.0 * j
            else:
                s = (torch.randint(0, 2, x.shape, generator=gen) * 2 - 1).to(x)
            return x + s * tol * (1 + torch.abs(x))
        out.append(_map(move, tree))
    return out


def close_rows(got: Any, want: Any, tol: float) -> torch.Tensor:
    """``[N]`` bool: every non-frame (non-uint8) leaf of row ``i`` of
    ``got`` equals ``want``'s, floats within ``tol * (1 + |want|)``."""
    ok = None
    wants = dict(_leaves(want))
    for path, g in _leaves(got):
        w = wants[path]
        if g.dtype == torch.uint8:
            continue
        g, w = g.cpu(), w.cpu()
        if g.is_floating_point():
            same = (torch.abs(g - w) <= tol * (1 + torch.abs(w))) | (g == w)
        else:
            same = g == w
        same = same.reshape(same.shape[0], -1).all(1)
        ok = same if ok is None else ok & same
    return ok


def near_threshold(step: Callable, state: Any, tol: float = STATE_TOL,
                   k: int = NUDGES) -> torch.Tensor:
    """``[N]`` bool: the rows whose ``step(state)`` outcome (any tree)
    changes under a nudge of ``state`` (:func:`nudged`): an integer or
    boolean field, or a float one by more than ``FLIP_TOL``."""
    base = step(state)
    flips = torch.zeros(next(_leaves(base))[1].shape[0], dtype=torch.bool)
    for s in nudged(state, tol, k):
        flips |= ~close_rows(step(s), base, FLIP_TOL)
    return flips


def threshold_pixels(frame_float: Callable, state: Any, tol: float = STATE_TOL,
                     k: int = NUDGES):
    """``(edge, trunc)`` bool masks over the frame ``frame_float(state)``
    (the frame before rounding, rendered in float64): ``edge`` where a
    float64 render of a nudged state rounds to another value, ``trunc``
    where the value lies within ``ROUND_EPS`` of a rounding boundary."""
    s64 = _map(lambda x: x.double() if x.is_floating_point() else x, state)

    def pixels(f):
        return torch.clamp(torch.round(f), 0, 255)

    f = frame_float(s64)
    base = pixels(f)
    edge = torch.zeros_like(base, dtype=torch.bool)
    for s in nudged(s64, tol, k):
        edge |= pixels(frame_float(s)) != base
    trunc = torch.abs(f - torch.floor(f) - 0.5) < ROUND_EPS
    return edge, trunc


def hold_step(env, state: Any, action: torch.Tensor, draws: dict, reset: torch.Tensor,
              want: dict, got: dict, tol: float = STATE_TOL) -> dict:
    """One engine step of ``env`` (a CPU env of the port) from ``state``
    with ``action`` and the step branch's ``draws``, as a reference
    computed it (``want``) and as the port did (``got``); ``reset`` marks
    the rows that took the reset branch.  ``want`` and ``got`` are
    ``{"state": new env state, "ts": timestep dict}`` on the CPU.

    Returns the counts: ``mismatched`` rows, ``excused`` ones (near a
    threshold, :func:`near_threshold`), ``failed`` (mismatched and not
    excused) and the frame rule's counts over the other rows."""
    ok = close_rows(got, want, tol)
    bad = ~ok
    excused = torch.zeros_like(bad)
    stepped = bad & ~reset
    if bool(stepped.any()):
        idx = stepped.nonzero()[:, 0]

        def step(s):
            out = env.step_env(s, action[idx], _rows(draws, idx))
            return {"state": out.state, "obs": out.obs, "reward": out.reward,
                    "terminated": out.terminated}

        excused[idx] = near_threshold(step, _rows(state, idx), tol)
    # The frame rule, on the rows not excused whose frames differ (an env
    # whose obs is not a uint8 frame has none: its obs is held above).
    g_obs, w_obs = got["ts"].get("obs"), want["ts"].get("obs")
    if w_obs is None or w_obs.dtype != torch.uint8:
        v = dict(pixels=0, differ=0, at_edge=0, at_trunc=0, violations=0, max_diff=0)
    else:
        edge = torch.zeros_like(w_obs, dtype=torch.bool)
        trunc = torch.zeros_like(edge)
        differ = (g_obs != w_obs).reshape(g_obs.shape[0], -1).any(1) & ~excused
        if bool(differ.any()):
            idx = differ.nonzero()[:, 0]
            masks = threshold_pixels(env.frame_float, _rows(want["state"], idx), tol)
            edge[idx], trunc[idx] = (env.frame_mask(m, reset[idx]) for m in masks)
        keep = ~excused
        v = frame_rule_violations(g_obs[keep], w_obs[keep], edge[keep], trunc[keep])
    v.update(envs=int(bad.numel()), mismatched=int(bad.sum()), excused=int(excused.sum()),
             failed=int((bad & ~excused).sum()))
    return v
