"""Per-ROM integration presets for Machine2600 — the ALE-settings analog.

Counterpart of ``envpool_tpu/envs/atari/rom_presets.py``: ``PRESETS``,
``_DEFAULTS``, ``list_presets`` and ``get_preset`` are copied so the port
imports nothing of the JAX package.  Each preset gives the machine env:

* ``score``: RIOT-RAM offsets (0-127) of the score bytes, least-significant
  first, decoded per ``mode`` (``"bcd"``: two packed digits per byte;
  ``"raw"``: base-256);
* ``mult``: score multiplier applied after decode;
* ``lives``: RAM offset of the lives counter (-1: no lives), masked by
  ``lives_mask``;
* ``opponent_score``: optional RAM offset subtracted from the score;
* ``minimal_actions``: the game's ALE minimal action set.
"""

from __future__ import annotations

# ALE action ids: 0 NOOP, 1 FIRE, 2 UP, 3 RIGHT, 4 LEFT, 5 DOWN,
# 6 UPRIGHT, 7 UPLEFT, 8 DOWNRIGHT, 9 DOWNLEFT, 10 UPFIRE, 11 RIGHTFIRE,
# 12 LEFTFIRE, 13 DOWNFIRE, 14 UPRIGHTFIRE, 15 UPLEFTFIRE,
# 16 DOWNRIGHTFIRE, 17 DOWNLEFTFIRE.

PRESETS: dict[str, dict] = {
    # --- well-documented single-score games -----------------------------
    "breakout": {
        "score": (77, 76), "mode": "bcd", "lives": 57, "lives_mask": 0x7,
        "minimal_actions": (0, 1, 3, 4),
    },
    "pong": {
        "score": (14,), "mode": "raw", "opponent_score": 13,
        "lives": -1,
        "minimal_actions": (0, 1, 3, 4, 11, 12),
    },
    "freeway": {
        "score": (103,), "mode": "bcd", "lives": -1,
        "minimal_actions": (0, 2, 5),
    },
    "space_invaders": {
        "score": (104, 102), "mode": "bcd", "lives": 73,
        "minimal_actions": (0, 1, 3, 4, 11, 12),
    },
    "seaquest": {
        "score": (0x3A, 0x39, 0x38), "mode": "bcd",
        "lives": 0x3B, "minimal_actions": tuple(range(18)),
    },
    "boxing": {
        "score": (0x12,), "mode": "raw",
        "opponent_score": 0x13, "lives": -1,
        "minimal_actions": tuple(range(18)),
    },
    "asteroids": {
        "score": (62, 61), "mode": "bcd", "mult": 10, "lives": 60,
        "minimal_actions": (0, 1, 2, 3, 4, 5, 10, 11, 12, 13, 14, 15),
    },
    "ms_pacman": {
        "score": (0xFA - 0x80, 0xF9 - 0x80, 0xF8 - 0x80), "mode": "bcd",
        "lives": 0xFB - 0x80, "lives_mask": 0x7,
        "minimal_actions": (0, 2, 3, 4, 5, 6, 7, 8, 9),
    },
    "qbert": {
        "score": (0xDB - 0x80, 0xDA - 0x80, 0xD9 - 0x80), "mode": "bcd",
        "lives": 0x88 - 0x80,
        "minimal_actions": (0, 1, 2, 3, 4, 5),
    },
    "bowling": {
        "score": (33, 38), "mode": "bcd", "lives": -1,
        "minimal_actions": (0, 1, 2, 5, 10, 13),
    },
    "frostbite": {
        "score": (0xCA - 0x80, 0xC9 - 0x80, 0xC8 - 0x80), "mode": "bcd",
        "lives": 0xCC - 0x80,
        "minimal_actions": tuple(range(18)),
    },
    "battle_zone": {
        # Score nibbles packed across two bytes (x10 display factor).
        "score": (29, 30), "mode": "bcd", "mult": 1000, "lives": 58,
        "minimal_actions": tuple(range(18)),
    },
}

# Fields every preset resolves to (defaults merged in get_preset).
_DEFAULTS = {
    "score": (),
    "mode": "bcd",
    "mult": 1,
    "opponent_score": -1,
    "lives": -1,
    "lives_mask": 0xFF,
    "minimal_actions": tuple(range(18)),
}


def list_presets() -> list[str]:
    return sorted(PRESETS)


def get_preset(name: str) -> dict:
    """Resolved preset dict (defaults filled; RAM offsets 0-127)."""
    key = name.lower()
    if key not in PRESETS:
        raise ValueError(
            f"no Machine2600 preset for {name!r}; available: "
            f"{', '.join(list_presets())} (or use ram_reward_addr/"
            "ram_lives_addr for a custom map)"
        )
    out = {**_DEFAULTS, **PRESETS[key]}
    out["score"] = tuple(a & 0x7F for a in out["score"])
    if out["opponent_score"] >= 0:
        out["opponent_score"] &= 0x7F
    if out["lives"] >= 0:
        out["lives"] &= 0x7F
    return out
