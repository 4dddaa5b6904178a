"""Scenario table for the Doom-like family.

Each entry mirrors a reference ``maps/*.cfg`` scenario (the reference
registers one task id per cfg/wad pair, ``envpool/vizdoom/
registration.py:24-50``): button list (→ action space), screen channel
count, arena layout, monster/item/projectile behavior, and episode-end
condition.  The interaction dynamics are a documented surrogate (grid
arena + hitscan/projectile combat) standing in for the Doom engine;
the observation/action/reward *surface* matches the reference env.

Copied from ``envpool_tpu/envs/vizdoom/scenarios.py`` (numpy only), so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import buttons as B


def _room(g: int, w: int, h: int, wtype: int = 1) -> np.ndarray:
    """[g, g] grid: empty w×h room centered, walls elsewhere."""
    m = np.full((g, g), wtype, np.uint8)
    x0 = (g - w) // 2
    y0 = (g - h) // 2
    m[y0:y0 + h, x0:x0 + w] = 0
    return m


def _corridor(g: int, length: int, width: int = 3) -> np.ndarray:
    m = np.full((g, g), 2, np.uint8)
    y0 = (g - width) // 2
    m[y0:y0 + width, 2:2 + length] = 0
    m[y0:y0 + width, 2 + length] = 5  # visible goal wall at the far end
    return m


def _nine_rooms(g: int = 22) -> np.ndarray:
    """3×3 rooms joined by door gaps (my_way_home-style layout)."""
    m = np.full((g, g), 2, np.uint8)
    rs = 6  # room interior size
    for ry in range(3):
        for rx in range(3):
            x0 = 1 + rx * (rs + 1)
            y0 = 1 + ry * (rs + 1)
            m[y0:y0 + rs, x0:x0 + rs] = 0
    # door gaps between adjacent rooms (fixed passable layout)
    doors = [
        (0, 0, "e"), (0, 1, "e"), (1, 1, "e"), (2, 0, "e"), (2, 2, "e"),
        (0, 0, "s"), (1, 1, "s"), (0, 2, "s"), (1, 2, "s"),
    ]
    for ry, rx, side in doors:
        x0 = 1 + rx * (rs + 1)
        y0 = 1 + ry * (rs + 1)
        if side == "e":
            m[y0 + rs // 2, x0 + rs] = 0
        else:
            m[y0 + rs, x0 + rs // 2] = 0
    return m


def _arena(g: int = 20) -> np.ndarray:
    """Battle arena: big room with 4 pillars."""
    m = _room(g, g - 2, g - 2, wtype=4)
    for py, px in ((5, 5), (5, g - 7), (g - 7, 5), (g - 7, g - 7)):
        m[py:py + 2, px:px + 2] = 4
    return m


_MOVE_TURN_ATTACK = [B.MOVE_LEFT, B.MOVE_RIGHT, B.ATTACK]
_NAV = [B.TURN_LEFT, B.TURN_RIGHT, B.MOVE_FORWARD]
_BATTLE = [
    B.MOVE_FORWARD, B.MOVE_BACKWARD, B.MOVE_RIGHT, B.MOVE_LEFT,
    B.TURN_RIGHT, B.TURN_LEFT, B.ATTACK, B.SPEED,
]
_DEATHMATCH = _BATTLE + [
    B.SELECT_WEAPON2, B.SELECT_WEAPON3, B.SELECT_WEAPON4, B.SELECT_WEAPON5,
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    grid: np.ndarray
    buttons: tuple
    channels: int = 3
    spawn: tuple = (0.0, 0.0)        # player spawn (x, y); (0,0) → center
    spawn_ang: float = 0.0
    random_spawn: bool = False       # random empty cell + angle
    n_monsters: int = 0
    monster_hp: float = 30.0
    monster_speed: float = 0.0       # cells / step toward player
    monster_melee: float = 0.0       # hp damage within 1.2 cells
    monster_ranged: float = 0.0      # hp damage per volley within sight
    monster_respawn: bool = False
    monster_wall: str = ""           # "east"|"north"|"ring": spawn band
    monster_lateral: float = 0.0     # lateral patrol speed (predict_position)
    n_items: int = 0
    item_kinds: tuple = ()           # cycled over item slots
    item_respawn: bool = False
    weapon: int = 2                  # selected weapon slot (2=pistol)
    ammo0: float = 50.0              # starting ammo in that slot
    attack_dmg: float = 40.0
    projectile: bool = False         # rocket-style travel time
    fireballs: int = 0               # incoming-projectile spawners
    fireball_dmg: float = 20.0
    health_drain: float = 0.0        # hp lost per step (acid floor)
    goal: tuple = ()                 # (x, y) vest; reach → episode end
    kill_all_ends: bool = False
    frags: bool = False              # kills count as FRAGCOUNT (mp surrogate)


def _basic(name: str, channels: int = 1) -> Scenario:
    return Scenario(
        name=name, grid=_room(16, 12, 8), buttons=tuple(_MOVE_TURN_ATTACK),
        channels=channels, spawn=(3.5, 8.0), spawn_ang=0.0,
        n_monsters=1, monster_hp=30.0, monster_wall="east",
        kill_all_ends=True, ammo0=50.0,
    )


SCENARIOS: dict[str, Scenario] = {
    "basic": _basic("basic", channels=3),
    "simpler_basic": _basic("simpler_basic", channels=3),
    "basic_audio": _basic("basic_audio", channels=3),
    "basic_notifications": _basic("basic_notifications", channels=3),
    "d1_basic": _basic("d1_basic", channels=1),
    "rocket_basic": dataclasses.replace(
        _basic("rocket_basic", channels=3),
        weapon=5, ammo0=10.0, projectile=True, attack_dmg=60.0,
    ),
    "predict_position": dataclasses.replace(
        _basic("predict_position", channels=3),
        weapon=5, ammo0=1.0, projectile=True, attack_dmg=80.0,
        monster_lateral=0.25, grid=_room(18, 14, 10), spawn=(3.5, 9.0),
    ),
    "deadly_corridor": Scenario(
        name="deadly_corridor", grid=_corridor(24, 20), buttons=tuple(
            [B.MOVE_LEFT, B.MOVE_RIGHT, B.ATTACK, B.MOVE_FORWARD,
             B.MOVE_BACKWARD, B.TURN_LEFT, B.TURN_RIGHT]
        ),
        spawn=(3.0, 11.5), spawn_ang=0.0, n_monsters=6,
        monster_hp=30.0, monster_ranged=2.0, monster_wall="corridor",
        weapon=3, ammo0=52.0, attack_dmg=60.0, goal=(20.5, 11.5),
    ),
    "defend_the_center": Scenario(
        name="defend_the_center", grid=_room(20, 16, 16),
        buttons=(B.TURN_LEFT, B.TURN_RIGHT, B.ATTACK),
        spawn=(10.0, 10.0), n_monsters=5, monster_hp=30.0,
        monster_speed=0.12, monster_melee=4.0, monster_respawn=True,
        monster_wall="ring", ammo0=26.0,
    ),
    "defend_the_line": Scenario(
        name="defend_the_line", grid=_room(20, 12, 16),
        buttons=(B.TURN_LEFT, B.TURN_RIGHT, B.ATTACK),
        spawn=(10.0, 16.5), spawn_ang=-np.pi / 2, n_monsters=6,
        monster_hp=30.0, monster_speed=0.08, monster_melee=4.0,
        monster_respawn=True, monster_wall="north", ammo0=999.0,
    ),
    "health_gathering": Scenario(
        name="health_gathering", grid=_room(20, 16, 16, wtype=3),
        buttons=tuple(_NAV), spawn=(10.0, 10.0), random_spawn=True,
        n_items=10, item_kinds=("medkit",), item_respawn=True,
        health_drain=1.75, ammo0=0.0,
    ),
    "health_gathering_supreme": Scenario(
        name="health_gathering_supreme", grid=_nine_rooms(22),
        buttons=tuple(_NAV), random_spawn=True,
        n_items=12, item_kinds=("medkit", "medkit", "poison"),
        item_respawn=True, health_drain=1.75, ammo0=0.0,
    ),
    "my_way_home": Scenario(
        name="my_way_home", grid=_nine_rooms(22),
        buttons=(B.TURN_LEFT, B.TURN_RIGHT, B.MOVE_FORWARD, B.MOVE_LEFT,
                 B.MOVE_RIGHT),
        random_spawn=True, goal=(4.0, 4.0), ammo0=0.0,
    ),
    "take_cover": Scenario(
        name="take_cover", grid=_room(20, 16, 12),
        buttons=(B.MOVE_LEFT, B.MOVE_RIGHT),
        spawn=(10.0, 14.5), spawn_ang=-np.pi / 2,
        fireballs=2, fireball_dmg=18.0, ammo0=0.0,
    ),
    "d2_navigation": Scenario(
        name="d2_navigation", grid=_nine_rooms(22), buttons=tuple(_NAV),
        channels=1, random_spawn=True, goal=(18.0, 18.0), ammo0=0.0,
    ),
    "d3_battle": Scenario(
        name="d3_battle", grid=_arena(20), buttons=tuple(_BATTLE),
        channels=1, random_spawn=True, n_monsters=8, monster_hp=30.0,
        monster_speed=0.10, monster_melee=3.0, monster_ranged=1.5,
        monster_respawn=True, monster_wall="ring",
        n_items=8, item_kinds=("medkit", "ammo", "armor"),
        item_respawn=True, ammo0=40.0,
    ),
    "d4_battle2": Scenario(
        name="d4_battle2", grid=_arena(24), buttons=tuple(_BATTLE),
        channels=1, random_spawn=True, n_monsters=12, monster_hp=45.0,
        monster_speed=0.12, monster_melee=4.0, monster_ranged=2.0,
        monster_respawn=True, monster_wall="ring",
        n_items=10, item_kinds=("medkit", "ammo", "armor"),
        item_respawn=True, ammo0=40.0,
    ),
    "deathmatch": Scenario(
        name="deathmatch", grid=_arena(24), buttons=tuple(_DEATHMATCH),
        channels=3, random_spawn=True, n_monsters=8, monster_hp=40.0,
        monster_speed=0.10, monster_melee=4.0, monster_ranged=1.5,
        monster_respawn=True, monster_wall="ring",
        n_items=10, item_kinds=("medkit", "ammo", "armor"),
        item_respawn=True, ammo0=60.0,
    ),
    "cig": Scenario(
        name="cig", grid=_arena(24), buttons=tuple(_DEATHMATCH),
        channels=3, random_spawn=True, n_monsters=7, monster_hp=60.0,
        monster_speed=0.10, monster_melee=3.0, monster_ranged=2.0,
        monster_respawn=True, monster_wall="ring",
        n_items=8, item_kinds=("medkit", "ammo", "armor"),
        item_respawn=True, ammo0=60.0, frags=True,
    ),
    "multi_duel": Scenario(
        name="multi_duel", grid=_room(16, 12, 12), buttons=tuple(_BATTLE),
        channels=3, random_spawn=True, n_monsters=1, monster_hp=80.0,
        monster_speed=0.10, monster_melee=3.0, monster_ranged=2.0,
        monster_respawn=True, monster_wall="ring", ammo0=60.0, frags=True,
    ),
}

# Reference id derivation: CamelCase of the cfg stem + "-v1"
# (envpool/vizdoom/registration.py:36).
def camel(name: str) -> str:
    return "".join(p.capitalize() for p in name.split("_"))
