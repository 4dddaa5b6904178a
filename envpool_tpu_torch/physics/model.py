"""Physics model: static description extracted from an MJCF model.

The ``PhysModel`` of ``envpool_tpu/physics/model.py`` (numpy only), and
:func:`load_model`, which reads the committed data file of a model so that
the port runs without ``mujoco``, ``gymnasium`` or ``dm_control``.  The
reference's extractors, ``from_mjcf`` and ``from_mj_model``, need the
host-side ``mujoco`` bindings and live in
``envpool_tpu_torch/tools/export_models.py``; the simulation itself never
calls MuJoCo.

Supported joint types: free (3 translation + quaternion), ball, hinge,
slide.  Contacts are geom-vs-ground-plane (sphere and
capsule geoms contribute endpoint spheres).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

# Models whose constants are committed under ``assets/`` (written by
# ``envpool_tpu_torch/tools/export_models.py``): model name -> data file.
# A gymnasium XML goes by its file name; a dm_control suite model by
# ``dmc:<domain>``, a procedural one (``cartpole._make_model(n)``,
# ``swimmer._make_model(n)``) by ``dmc:<domain>_<n>``, and one that a suite
# module generates for a task (lqr, quadruped, manipulator, stacker, dog) by
# ``dmc:<domain>_<task>`` (``tools/export_models._GENERATED``; the four dog
# locomotion tasks share ``dmc:dog``).  A gymnasium_robotics model goes by
# its path under that package's ``envs/assets/`` (``hand/reach.xml``).
ASSETS = {
    "hand/reach.xml": "gr_hand_reach.npz",
    "ant.xml": "ant.npz",
    "half_cheetah.xml": "half_cheetah.npz",
    "hopper.xml": "hopper.npz",
    "humanoid.xml": "humanoid.npz",
    "humanoidstandup.xml": "humanoidstandup.npz",
    "inverted_double_pendulum.xml": "inverted_double_pendulum.npz",
    "inverted_pendulum.xml": "inverted_pendulum.npz",
    "pusher.xml": "pusher.npz",
    "pusher_v5.xml": "pusher_v5.npz",
    "reacher.xml": "reacher.npz",
    "swimmer.xml": "swimmer.npz",
    "walker2d.xml": "walker2d.npz",
    **{
        f"dmc:{name}": f"dmc_{name}.npz"
        for name in (
            "acrobot", "cartpole", "cartpole_2", "cartpole_3", "cheetah",
            "hopper", "humanoid", "humanoid_CMU", "pendulum", "reacher",
            "swimmer_6", "swimmer_15", "walker",
            "point_mass", "ball_in_cup", "fish", "finger", "lqr_2_1", "lqr_6_2",
            "quadruped_walk", "quadruped_run", "quadruped_escape", "quadruped_fetch",
            "manipulator_bring_ball", "manipulator_bring_peg",
            "manipulator_insert_ball", "manipulator_insert_peg",
            "stacker_2", "stacker_4", "dog", "dog_fetch",
        )
    },
}
ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

# MuJoCo joint type enum values (mjtJoint).
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class PhysModel:
    """Static (numpy) model constants; hashable by id for jit closures."""

    nq: int
    nv: int
    nu: int
    nbody: int

    # Per body (index 0 is the world).
    body_parent: np.ndarray    # [nb] int
    body_pos: np.ndarray       # [nb, 3] frame offset in parent frame
    body_quat: np.ndarray      # [nb, 4] frame rotation in parent frame
    body_mass: np.ndarray      # [nb]
    body_inertia: np.ndarray   # [nb, 3] diagonal inertia in inertial frame
    body_ipos: np.ndarray      # [nb, 3] CoM offset in body frame
    body_iquat: np.ndarray     # [nb, 4] inertial frame rotation

    # Per joint, in model order (joints of a body apply in sequence).
    jnt_type: np.ndarray       # [nj] int
    jnt_body: np.ndarray       # [nj] body the joint moves
    jnt_axis: np.ndarray       # [nj, 3]
    jnt_pos: np.ndarray        # [nj, 3] anchor in body frame
    jnt_qposadr: np.ndarray    # [nj]
    jnt_dofadr: np.ndarray     # [nj]
    jnt_range: np.ndarray      # [nj, 2]
    jnt_limited: np.ndarray    # [nj] bool
    jnt_stiffness: np.ndarray  # [nj]
    qpos_spring: np.ndarray    # [nq] spring reference

    # Per dof.
    dof_damping: np.ndarray    # [nv]
    dof_armature: np.ndarray   # [nv]

    # Actuators (motor/general on joints).
    act_trnid: np.ndarray      # [nu] joint id
    act_gear: np.ndarray       # [nu]
    act_ctrlrange: np.ndarray  # [nu, 2]
    act_ctrllimited: np.ndarray  # [nu] bool

    # Contact geoms vs ground plane: contributing spheres.
    con_body: np.ndarray       # [nc] body id
    con_pos: np.ndarray        # [nc, 3] sphere center in body frame
    con_radius: np.ndarray     # [nc]
    con_friction: np.ndarray   # [nc] sliding friction coefficient

    # Sites (for fingertip/tip observations).
    site_body: np.ndarray      # [ns] body id
    site_pos: np.ndarray       # [ns, 3] offset in body frame
    site_names: tuple          # [ns] str
    body_names: tuple          # [nb] str

    # Options.
    timestep: float
    gravity: np.ndarray        # [3]
    density: float             # fluid density (inertia-box drag model)
    viscosity: float           # fluid viscosity
    qpos0: np.ndarray          # [nq] default pose
    integrator: int            # 0 = Euler (implicit damping), 1 = RK4

    # Actuator gain (MuJoCo gainprm[0]; force = gear · gain · ctrl for
    # fixed-gain motors/general actuators) and transmission type
    # (0 = joint, 3 = tendon; mjtTrn).
    act_gain: np.ndarray = None       # [nu]
    act_trntype: np.ndarray = None    # [nu]
    # Affine bias (mjBIAS_AFFINE, position servos):
    # force = gain·ctrl + biasprm[1]·length + biasprm[2]·velocity.
    act_biastype: np.ndarray = None   # [nu] (0 none, 1 affine)
    act_biasprm: np.ndarray = None    # [nu, 3]
    # First-order activation filter (mjDYN_FILTER/FILTEREXACT/MUSCLE):
    # act' = (ctrl - act)/tau.  Integrated analytically per control step
    # at the env layer (documented approximation).
    act_dyntype: np.ndarray = None    # [nu] (0 none, 2/3 filter, 4 muscle)
    act_dynprm: np.ndarray = None     # [nu] tau

    # Raw geom tables (for the device rasterizer / from_pixels path).
    geom_body: np.ndarray = None   # [ng] body id
    geom_type: np.ndarray = None   # [ng] mjtGeom
    geom_size: np.ndarray = None   # [ng, 3]
    geom_pos: np.ndarray = None    # [ng, 3] body-frame offset
    geom_quat: np.ndarray = None   # [ng, 4]
    geom_rgba: np.ndarray = None   # [ng, 4]

    # Fixed tendons: length = Σ coef_j · qpos[j] over hinge/slide joints.
    # Per tendon: tuple of (qposadr, dofadr, coef) triples, plus passive
    # spring/damping constants (MuJoCo tendon_stiffness/damping applied to
    # the tendon length/velocity, mapped back through the coefs).
    ten_fixed: tuple = ()             # ((qadr, dadr, coef), ...) per tendon
    ten_fixed_stiffness: np.ndarray = None  # [nt_fixed]
    ten_fixed_damping: np.ndarray = None    # [nt_fixed]
    ten_fixed_springlen: np.ndarray = None  # [nt_fixed]

    # Spatial tendons (site-to-site strings): limit-range penalty only
    # (MuJoCo routes these through the constraint solver; the penalty
    # mirrors the ground-contact approximation).
    ten_spatial_sites: np.ndarray = None    # [nt_sp, 2] site ids
    ten_spatial_range: np.ndarray = None    # [nt_sp, 2]
    ten_spatial_limited: np.ndarray = None  # [nt_sp] bool
    ten_spatial_stiffness: np.ndarray = None  # [nt_sp]
    ten_spatial_damping: np.ndarray = None    # [nt_sp]

    # Body-body contact pairs: sphere/capsule geoms on different bodies
    # that pass MuJoCo's collision filter.  Each geom is a segment
    # (p0 == p1 for spheres) + radius in its body frame.
    pair_body: np.ndarray = None      # [np, 2] body ids (a, b)
    pair_seg_a: np.ndarray = None     # [np, 2, 3] local endpoints of a
    pair_seg_b: np.ndarray = None     # [np, 2, 3]
    pair_radius: np.ndarray = None    # [np, 2] radii (a, b)
    pair_friction: np.ndarray = None  # [np] sliding friction

    # Constraint-solver parameters (the ``solver="mujoco"`` contact path):
    # per-contact solref/solimp mixed per mj_contactParam (geom ⊕ plane),
    # MuJoCo's diagApprox row weight, contact margin; per-joint limit
    # solref/solimp; per-dof inverse weight (dof_invweight0).
    con_solref: np.ndarray = None     # [nc, 2] (timeconst, dampratio)
    con_solimp: np.ndarray = None     # [nc, 5] (dmin,dmax,width,mid,power)
    con_invw: np.ndarray = None       # [nc] diagApprox of the facet rows
    con_margin: np.ndarray = None     # [nc]
    con_axis: np.ndarray = None       # [nc, 3] capsule axis (0 = none)
    jnt_solref_lim: np.ndarray = None  # [nj, 2]
    jnt_solimp_lim: np.ndarray = None  # [nj, 5]
    jnt_margin: np.ndarray = None     # [nj]
    dof_invweight: np.ndarray = None  # [nv] dof_invweight0

    def __hash__(self) -> int:  # cache-key friendliness
        return id(self)

    def __eq__(self, other) -> bool:
        return self is other


# -- committed model data ----------------------------------------------------

_NAME_FIELDS = ("site_names", "body_names")


_CONST = "const_"


def save_npz(
    model: PhysModel, path: str, constants: dict[str, np.ndarray] | None = None
) -> None:
    """Write every field of ``model`` to an ``.npz`` that needs no pickle.

    Scalars become 0-d arrays, name tuples string arrays, and the fixed
    tendons one ``[k, 4]`` array of ``(tendon, qposadr, dofadr, coef)``
    rows; fields that are ``None`` are left out.  ``constants`` are a
    task's own numbers read from the same model (:func:`load_constants`).
    """
    arrays = {_CONST + k: np.asarray(v) for k, v in (constants or {}).items()}
    for f in dataclasses.fields(PhysModel):
        v = getattr(model, f.name)
        if v is None:
            continue
        if f.name == "ten_fixed":
            rows = [
                (t, qadr, dadr, coef)
                for t, triples in enumerate(v)
                for qadr, dadr, coef in triples
            ]
            v = np.asarray(rows, np.float64).reshape(-1, 4)
        elif f.name in _NAME_FIELDS:
            v = np.asarray(list(v), dtype=np.str_)
        arrays[f.name] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_npz(path: str) -> PhysModel:
    """Read a model written by :func:`save_npz`."""
    kwargs = {}
    with np.load(path, allow_pickle=False) as data:
        for name in data.files:
            if name.startswith(_CONST):
                continue
            v = data[name]
            if name == "ten_fixed":
                tendons: dict[int, list] = {}
                for t, qadr, dadr, coef in v:
                    tendons.setdefault(int(t), []).append(
                        (int(qadr), int(dadr), float(coef))
                    )
                v = tuple(tuple(tendons[t]) for t in sorted(tendons))
            elif name in _NAME_FIELDS:
                v = tuple(str(x) for x in v)
            elif v.ndim == 0:
                v = v.item()
            kwargs[name] = v
    return PhysModel(**kwargs)


def load_constants(name: str) -> dict[str, np.ndarray]:
    """The task constants committed beside the model ``name`` of
    :data:`ASSETS` (e.g. swimmer's nose and target geoms)."""
    with np.load(os.path.join(ASSET_DIR, ASSETS[name]), allow_pickle=False) as data:
        return {
            k[len(_CONST):]: data[k] for k in data.files if k.startswith(_CONST)
        }


@functools.lru_cache(maxsize=32)
def load_model(xml_file: str) -> PhysModel:
    """The PhysModel of a name in :data:`ASSETS`, read from its committed
    data file, or of an ``.npz`` written by
    ``python -m envpool_tpu_torch.tools.export_models --xml MODEL.xml
    --out MODEL.npz`` (the port's runtime reads no MJCF itself)."""
    if xml_file in ASSETS:
        return load_npz(os.path.join(ASSET_DIR, ASSETS[xml_file]))
    if xml_file.endswith(".npz"):
        return load_npz(xml_file)
    raise ValueError(
        f"{xml_file!r} is not a committed model ({', '.join(sorted(ASSETS))}); "
        "write its data with `python -m envpool_tpu_torch.tools.export_models "
        f"--xml {xml_file} --out MODEL.npz` (needs `mujoco`) and pass MODEL.npz"
    )
