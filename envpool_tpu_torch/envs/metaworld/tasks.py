"""Per-task scene and reward configs of the 50 MetaWorld v3 tasks: the
table of ``envpool_tpu/envs/metaworld/tasks.py``, copied.

Categories drive the shared Sawyer interaction model (sawyer.py):

* ``reach``    — no object manipulation; success on tcp-to-target.
* ``push``     — quasi-static tabletop push (object z fixed).
* ``pick``     — grasp + free 3D placement.
* ``press``    — 1-dof button/plate along ``axis`` driven by tcp pushing.
* ``turn``     — 1-dof rotary (dial/faucet/door) driven by tcp engagement.
* ``slide``    — 1-dof prismatic (drawer/window/handle) along ``axis``.

Values follow the public MetaWorld task definitions (object/goal ranges
in the robot's table frame, x right, y forward from the robot, z up;
table at z≈0.0 with the hand box z∈[0.05, 0.5]).
"""

# (category, obj_low, obj_high, goal_low, goal_high, threshold, axis)
# axis: motion direction for press/slide, rotation sign for turn.
_T = {
    "reach-v3": ("reach", (-0.1, 0.6, 0.02), (0.1, 0.7, 0.02),
                 (-0.1, 0.8, 0.05), (0.1, 0.9, 0.3), 0.05, None),
    "reach-wall-v3": ("reach", (-0.1, 0.6, 0.02), (0.1, 0.7, 0.02),
                      (-0.1, 0.8, 0.05), (0.1, 0.9, 0.3), 0.05, None),
    "push-v3": ("push", (-0.1, 0.6, 0.02), (0.1, 0.7, 0.02),
                (-0.1, 0.8, 0.01), (0.1, 0.9, 0.02), 0.05, None),
    "push-wall-v3": ("push", (-0.05, 0.6, 0.02), (0.05, 0.65, 0.02),
                     (-0.05, 0.85, 0.01), (0.05, 0.9, 0.02), 0.05, None),
    "push-back-v3": ("push", (-0.1, 0.7, 0.02), (0.1, 0.8, 0.02),
                     (-0.1, 0.6, 0.01), (0.1, 0.7, 0.02), 0.07, None),
    "pick-place-v3": ("pick", (-0.1, 0.6, 0.02), (0.1, 0.7, 0.02),
                      (-0.1, 0.8, 0.05), (0.1, 0.9, 0.3), 0.07, None),
    "pick-place-wall-v3": ("pick", (-0.05, 0.6, 0.02), (0.05, 0.65, 0.02),
                           (-0.05, 0.85, 0.05), (0.05, 0.9, 0.3), 0.07, None),
    "pick-out-of-hole-v3": ("pick", (0.0, 0.75, -0.1), (0.0, 0.75, -0.1),
                            (-0.1, 0.5, 0.15), (0.1, 0.6, 0.3), 0.07, None),
    "bin-picking-v3": ("pick", (-0.21, 0.65, 0.02), (-0.12, 0.75, 0.02),
                       (0.12, 0.65, 0.02), (0.21, 0.75, 0.02), 0.05, None),
    "basketball-v3": ("pick", (-0.1, 0.6, 0.03), (0.1, 0.7, 0.03),
                      (-0.1, 0.85, 0.3), (0.1, 0.9, 0.3), 0.08, None),
    "shelf-place-v3": ("pick", (-0.1, 0.6, 0.02), (0.1, 0.7, 0.02),
                       (-0.1, 0.85, 0.25), (0.1, 0.9, 0.3), 0.07, None),
    "sweep-v3": ("push", (-0.1, 0.6, 0.02), (0.1, 0.7, 0.02),
                 (0.4, 0.6, 0.01), (0.5, 0.7, 0.02), 0.05, None),
    "sweep-into-v3": ("push", (-0.1, 0.6, 0.02), (0.1, 0.7, 0.02),
                      (-0.02, 0.83, 0.01), (0.02, 0.85, 0.02), 0.05, None),
    "soccer-v3": ("push", (-0.1, 0.6, 0.03), (0.1, 0.7, 0.03),
                  (-0.1, 0.85, 0.03), (0.1, 0.9, 0.03), 0.07, None),
    "coffee-push-v3": ("push", (-0.05, 0.6, 0.02), (0.05, 0.65, 0.02),
                       (-0.05, 0.75, 0.02), (0.05, 0.8, 0.02), 0.05, None),
    "coffee-pull-v3": ("push", (-0.05, 0.75, 0.02), (0.05, 0.8, 0.02),
                       (-0.05, 0.6, 0.02), (0.05, 0.65, 0.02), 0.05, None),
    "plate-slide-v3": ("push", (0.0, 0.6, 0.0), (0.0, 0.6, 0.0),
                       (-0.1, 0.85, 0.0), (0.1, 0.9, 0.0), 0.07, None),
    "plate-slide-side-v3": ("push", (0.0, 0.6, 0.0), (0.0, 0.6, 0.0),
                            (-0.3, 0.54, 0.0), (-0.25, 0.6, 0.0), 0.07, None),
    "plate-slide-back-v3": ("push", (0.0, 0.85, 0.0), (0.0, 0.85, 0.0),
                            (-0.1, 0.6, 0.0), (0.1, 0.6, 0.0), 0.07, None),
    "plate-slide-back-side-v3": ("push", (-0.25, 0.6, 0.0), (-0.25, 0.6, 0.0),
                                 (-0.05, 0.6, 0.0), (0.05, 0.6, 0.0),
                                 0.07, None),
    "hand-insert-v3": ("push", (-0.1, 0.6, 0.05), (0.1, 0.7, 0.05),
                       (-0.04, 0.8, -0.08), (0.04, 0.88, -0.06), 0.05, None),
    # stick-push: the STICK is grasped and carried (pick dynamics); the
    # pushed container is the second body (sawyer.py two-body surrogate).
    "stick-push-v3": ("pick", (-0.1, 0.58, 0.02), (0.1, 0.62, 0.02),
                      (0.35, 0.6, 0.01), (0.45, 0.7, 0.02), 0.08, None),
    "stick-pull-v3": ("pick", (-0.1, 0.58, 0.02), (0.1, 0.62, 0.02),
                      (0.3, 0.5, 0.01), (0.4, 0.6, 0.02), 0.08, None),
    "hammer-v3": ("pick", (-0.1, 0.4, 0.02), (0.1, 0.5, 0.02),
                  (0.0, 0.75, 0.05), (0.0, 0.8, 0.08), 0.05, None),
    "assembly-v3": ("pick", (-0.1, 0.6, 0.02), (0.1, 0.7, 0.02),
                    (-0.1, 0.75, 0.1), (0.1, 0.85, 0.1), 0.05, None),
    "disassemble-v3": ("pick", (-0.1, 0.7, 0.12), (0.1, 0.75, 0.12),
                       (-0.1, 0.7, 0.25), (0.1, 0.75, 0.3), 0.05, None),
    "box-close-v3": ("pick", (-0.05, 0.55, 0.02), (0.05, 0.6, 0.02),
                     (-0.05, 0.75, 0.13), (0.05, 0.8, 0.13), 0.08, None),
    "peg-insert-side-v3": ("pick", (-0.1, 0.6, 0.02), (0.1, 0.7, 0.02),
                           (-0.35, 0.65, 0.13), (-0.25, 0.7, 0.13),
                           0.07, None),
    "peg-unplug-side-v3": ("pick", (-0.35, 0.6, 0.13), (-0.25, 0.7, 0.13),
                           (-0.15, 0.6, 0.02), (-0.05, 0.7, 0.1), 0.07, None),
    "button-press-v3": ("press", (0.0, 0.85, 0.115), (0.0, 0.9, 0.115),
                        None, None, 0.024, (0.0, 1.0, 0.0)),
    "button-press-wall-v3": ("press", (0.0, 0.85, 0.115), (0.0, 0.9, 0.115),
                             None, None, 0.024, (0.0, 1.0, 0.0)),
    "button-press-topdown-v3": ("press", (0.0, 0.7, 0.115), (0.0, 0.8, 0.115),
                                None, None, 0.024, (0.0, 0.0, -1.0)),
    "button-press-topdown-wall-v3": ("press", (0.0, 0.7, 0.115),
                                     (0.0, 0.8, 0.115), None, None, 0.024,
                                     (0.0, 0.0, -1.0)),
    "coffee-button-v3": ("press", (0.0, 0.85, 0.3), (0.0, 0.9, 0.3),
                         None, None, 0.02, (0.0, 1.0, 0.0)),
    "handle-press-v3": ("slide", (0.0, 0.8, 0.14), (0.0, 0.85, 0.14),
                        None, None, 0.04, (0.0, 0.0, -1.0)),
    "handle-press-side-v3": ("slide", (-0.35, 0.65, 0.14), (-0.25, 0.7, 0.14),
                             None, None, 0.04, (0.0, 0.0, -1.0)),
    "handle-pull-v3": ("slide", (0.0, 0.8, 0.04), (0.0, 0.85, 0.04),
                       None, None, 0.04, (0.0, 0.0, 1.0)),
    "handle-pull-side-v3": ("slide", (-0.35, 0.65, 0.04), (-0.25, 0.7, 0.04),
                            None, None, 0.04, (0.0, 0.0, 1.0)),
    "door-open-v3": ("turn", (0.0, 0.85, 0.15), (0.1, 0.95, 0.15),
                     None, None, 0.08, (0.0, 0.0, -1.0)),
    "door-close-v3": ("turn", (0.2, 0.65, 0.15), (0.3, 0.75, 0.15),
                      None, None, 0.08, (0.0, 0.0, 1.0)),
    "door-lock-v3": ("turn", (0.0, 0.85, 0.15), (0.1, 0.9, 0.15),
                     None, None, 0.02, (0.0, 0.0, -1.0)),
    "door-unlock-v3": ("turn", (0.0, 0.85, 0.15), (0.1, 0.9, 0.15),
                       None, None, 0.02, (0.0, 0.0, 1.0)),
    "drawer-open-v3": ("slide", (-0.1, 0.9, 0.04), (0.1, 0.9, 0.04),
                       None, None, 0.06, (0.0, -1.0, 0.0)),
    "drawer-close-v3": ("slide", (-0.1, 0.75, 0.04), (0.1, 0.8, 0.04),
                        None, None, 0.055, (0.0, 1.0, 0.0)),
    "window-open-v3": ("slide", (-0.1, 0.78, 0.16), (0.1, 0.8, 0.16),
                       None, None, 0.05, (1.0, 0.0, 0.0)),
    "window-close-v3": ("slide", (0.1, 0.78, 0.16), (0.3, 0.8, 0.16),
                        None, None, 0.05, (-1.0, 0.0, 0.0)),
    "faucet-open-v3": ("turn", (-0.05, 0.8, 0.12), (0.05, 0.85, 0.12),
                       None, None, 0.07, (0.0, 0.0, 1.0)),
    "faucet-close-v3": ("turn", (-0.05, 0.8, 0.12), (0.05, 0.85, 0.12),
                        None, None, 0.07, (0.0, 0.0, -1.0)),
    "dial-turn-v3": ("turn", (-0.05, 0.7, 0.09), (0.05, 0.75, 0.09),
                     None, None, 0.03, (0.0, 0.0, 1.0)),
    "lever-pull-v3": ("turn", (-0.05, 0.7, 0.05), (0.05, 0.75, 0.05),
                      None, None, 0.04, (1.0, 0.0, 0.0)),
}

assert len(_T) == 50, len(_T)

TASKS = _T

# Reference reset-law goal offsets (target − articulated-handle start)
# for 1-dof tasks, from metaworld_env.h's per-task Reset cases; the
# surrogate articulation axis/travel derive from these so the goal
# geometry matches the reference instead of the generic category
# magnitudes.  (faucet: ±0.175 x / +0.125 z, case 20/21; doors: cases
# 13-16; windows ±0.2 x, cases 48/49; drawers cases 18/19; dial case
# 11; lever case 27.)
GOAL_DELTA = {
    "door-open-v3": (-0.3, -0.45, 0.0),
    "door-close-v3": (0.2, -0.2, 0.0),
    "door-lock-v3": (0.0, -0.04, -0.1),
    "door-unlock-v3": (0.1, -0.04, 0.0),
    "dial-turn-v3": (0.0, 0.03, 0.03),
    "lever-pull-v3": (0.0, 0.2, 0.2),
    "window-open-v3": (0.2, 0.0, 0.0),
    "window-close-v3": (-0.2, 0.0, 0.0),
    "drawer-open-v3": (0.0, -0.2, 0.0),
    "drawer-close-v3": (0.0, 0.15, 0.0),
    "faucet-open-v3": (0.175, 0.0, 0.125),
    "faucet-close-v3": (-0.175, 0.0, 0.125),
}
