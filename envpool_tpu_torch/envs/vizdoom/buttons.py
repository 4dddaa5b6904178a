"""ViZDoom button ids and the construction of the combined action set.

Mirrors the semantics of ``envpool/vizdoom/utils.h:33-127``
(BuildActionSet): the combined discrete action space is the cartesian
product over button groups — each plain button contributes {off, on},
each exclusive pair (MOVE_RIGHT/MOVE_LEFT, MOVE_BACKWARD/MOVE_FORWARD,
TURN_RIGHT/TURN_LEFT, ...) contributes {none, first, second}, the
SELECT_WEAPONx block contributes {none} ∪ {each available}, and SPEED
is forced on when ``force_speed``.  Re-implemented from the observed
behavior (recursion over button ids 0..42), not translated.

Copied from ``envpool_tpu/envs/vizdoom/buttons.py`` (numpy only), so that
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

# ViZDoom Button enum order (ViZDoomTypes.h public API).
ATTACK = 0
USE = 1
JUMP = 2
CROUCH = 3
TURN180 = 4
ALT_ATTACK = 5
RELOAD = 6
ZOOM = 7
SPEED = 8
STRAFE = 9
MOVE_RIGHT = 10
MOVE_LEFT = 11
MOVE_BACKWARD = 12
MOVE_FORWARD = 13
TURN_RIGHT = 14
TURN_LEFT = 15
LOOK_UP = 16
LOOK_DOWN = 17
MOVE_UP = 18
MOVE_DOWN = 19
LAND = 20
SELECT_WEAPON1 = 21
SELECT_WEAPON2 = 22
SELECT_WEAPON3 = 23
SELECT_WEAPON4 = 24
SELECT_WEAPON5 = 25
SELECT_WEAPON6 = 26
SELECT_WEAPON7 = 27
SELECT_WEAPON8 = 28
SELECT_WEAPON9 = 29
SELECT_WEAPON0 = 30
SELECT_NEXT_WEAPON = 31
SELECT_PREV_WEAPON = 32
DROP_SELECTED_WEAPON = 33
ACTIVATE_SELECTED_ITEM = 34
SELECT_NEXT_ITEM = 35
SELECT_PREV_ITEM = 36
DROP_SELECTED_ITEM = 37
# 38..42 are delta buttons (LOOK_UP_DOWN_DELTA etc.) — unused here.

N_BUTTON_IDS = 43

# Groups where at most one of (id, id+1) may be active (utils.h:79-103).
_PAIR_HEADS = (10, 12, 14, 16, 18, 31, 35)


def build_action_set(
    button_list: list[int], force_speed: bool = False
) -> np.ndarray:
    """→ [n_actions, len(button_list)] float button-press matrix.

    Enumerates combined actions in the same group order as the
    reference BuildActionSet (ids ascending; pairs expand none/first/second;
    weapon-select expands after id 21 and jumps to 31).
    """
    idx = {b: i for i, b in enumerate(button_list)}
    n = len(button_list)
    results: list[np.ndarray] = []
    cur = np.zeros(n, np.float64)

    def rec(cur_id: int) -> None:
        if cur_id >= N_BUTTON_IDS:
            results.append(cur.copy())
            return
        if 38 <= cur_id <= 42:  # delta buttons unsupported → skip
            rec(cur_id + 1)
            return
        if 21 <= cur_id <= 30:
            if cur_id != 21:
                rec(31)
                return
            rec(31)  # no weapon selected
            for b in range(21, 31):
                if b in idx:
                    cur[idx[b]] = 1
                    rec(31)
                    cur[idx[b]] = 0
            return
        if cur_id in _PAIR_HEADS and cur_id in idx and (cur_id + 1) in idx:
            rec(cur_id + 2)
            cur[idx[cur_id]] = 1
            rec(cur_id + 2)
            cur[idx[cur_id]] = 0
            cur[idx[cur_id + 1]] = 1
            rec(cur_id + 2)
            cur[idx[cur_id + 1]] = 0
            return
        if cur_id in idx:
            if cur_id == SPEED and force_speed:
                cur[idx[cur_id]] = 1
                rec(cur_id + 1)
                cur[idx[cur_id]] = 0
                return
            rec(cur_id + 1)
            cur[idx[cur_id]] = 1
            rec(cur_id + 1)
            cur[idx[cur_id]] = 0
            return
        rec(cur_id + 1)

    rec(0)
    return np.stack(results, 0)
