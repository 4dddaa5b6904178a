"""Write the committed model data of the port's default MJCF models.

Each model in ``physics.model.ASSETS`` is extracted by :func:`from_mj_model`
(the reference's extractor, a copy of ``envpool_tpu/physics/model.py``'s;
it reads a loaded ``mujoco.MjModel``) and written to
``envpool_tpu_torch/physics/assets/`` as an ``.npz`` that loads without
pickle, ``mujoco``, ``gymnasium`` or ``dm_control``:

* an XML name: from gymnasium's MuJoCo assets
  (``gymnasium/envs/mujoco/assets/``, MIT-licensed: every XML the
  Gym-MuJoCo ids use);
* ``hand/reach.xml``: gymnasium_robotics' Shadow Hand model
  (``gymnasium_robotics/envs/assets/hand/``, MIT-licensed; version 1.4.1
  wrote the committed data), its XML files copied with the
  ``apirate`` attribute that mujoco 3 refuses stripped, as the JAX
  package's ``envs/robotics/hand.py`` loads it (:func:`robotics_xml`);
* ``dmc:<domain>``: the dm_control suite's ``<domain>.xml`` with the
  suite's shared assets (``suite.common.ASSETS``), as the JAX package's
  ``envs/mujoco_dmc/base.py`` loads it (Apache-2.0);
* ``dmc:<domain>_<n>``: the suite's procedural model
  ``<domain>._make_model(n)`` (cartpole's poles, swimmer's links);
* ``dmc:lqr_<b>_<a>``, ``dmc:quadruped_<task>``,
  ``dmc:manipulator_<task>``, ``dmc:stacker_<n>``, ``dmc:dog`` and
  ``dmc:dog_fetch``: the model a suite module's generator builds for that
  task (``_GENERATED``), lqr's from ``RandomState(42)``.

Swimmer's data also holds the ``nose`` geom's offset and body and the
``target`` geom's height, which its task reads (``load_constants``); the
cheetah's holds CheetahRun's bank of settled reset states
(:func:`cheetah_bank`); the models of ``NAMED`` hold the joint and geom
names, site sizes and the like that their tasks read
(:func:`named_constants`).  It needs ``mujoco``, ``gymnasium``,
``gymnasium_robotics`` and ``dm_control``::

    python -m envpool_tpu_torch.tools.export_models

Any other MJCF file becomes an ``.npz`` that a Gym-MuJoCo env takes as its
``xml_file`` (this needs ``mujoco`` alone)::

    python -m envpool_tpu_torch.tools.export_models --xml model.xml --out model.npz
"""

from __future__ import annotations

import argparse
import importlib
import os
import re
import shutil
import tempfile

import numpy as np

from envpool_tpu_torch.physics.model import (
    ASSET_DIR,
    ASSETS,
    BALL,
    PhysModel,
    load_model,
    save_npz,
)


# -- the reference's extractors (``envpool_tpu/physics/model.py``) ----------


def from_mjcf(xml_path: str) -> PhysModel:
    """Extract a PhysModel from an MJCF file via host-side mujoco."""
    try:
        import mujoco
    except ImportError as e:
        raise ImportError(
            f"loading {xml_path!r} needs the `mujoco` package, which is not "
            "installed; only the models under envpool_tpu_torch/physics/"
            f"assets/ ({', '.join(sorted(ASSETS))}) load without it"
        ) from e

    m = mujoco.MjModel.from_xml_path(xml_path)
    return from_mj_model(m)


def from_mj_model(m) -> PhysModel:
    """Extract from a loaded ``mujoco.MjModel``."""
    import mujoco

    for j in range(m.njnt):
        if m.jnt_type[j] == BALL and m.jnt_limited[j]:
            raise NotImplementedError(
                "ball-joint limits not supported (cone limits need the "
                "rotation-angle constraint row)"
            )

    # Ground-contact spheres from sphere/capsule geoms on moving bodies.
    # Contacts exist only against a world-attached plane geom, honoring
    # contype/conaffinity masks and the global contact-disable flag
    # (e.g. inverted_pendulum.xml has no floor: no contacts at all).
    contacts_enabled = not (
        m.opt.disableflags & mujoco.mjtDisableBit.mjDSBL_CONTACT
    )
    planes = [
        g
        for g in range(m.ngeom)
        if m.geom_bodyid[g] == 0
        and m.geom_type[g] == int(mujoco.mjtGeom.mjGEOM_PLANE)
    ]
    plane_contype = int(m.geom_contype[planes[0]]) if planes else 0
    plane_conaffinity = int(m.geom_conaffinity[planes[0]]) if planes else 0

    con_body, con_pos, con_radius, con_fric = [], [], [], []
    con_solref, con_solimp, con_invw, con_margin = [], [], [], []
    con_axis = []

    def _mix_solparams(g, p):
        """mj_contactParam: priority override, else solmix-weighted mix;
        friction/margin combine elementwise-max."""
        pr_g, pr_p = int(m.geom_priority[g]), int(m.geom_priority[p])
        if pr_g != pr_p:
            src = g if pr_g > pr_p else p
            return m.geom_solref[src].copy(), m.geom_solimp[src].copy()
        s1, s2 = float(m.geom_solmix[g]), float(m.geom_solmix[p])
        if s1 > 0 and s2 > 0:
            w1 = s1 / (s1 + s2)
        elif s1 == 0 and s2 == 0:
            w1 = 0.5
        else:
            w1 = 0.0 if s1 == 0 else 1.0
        solref = w1 * m.geom_solref[g] + (1 - w1) * m.geom_solref[p]
        solimp = w1 * m.geom_solimp[g] + (1 - w1) * m.geom_solimp[p]
        return solref, solimp

    for g in range(m.ngeom):
        b = int(m.geom_bodyid[g])
        if b == 0 or not planes or not contacts_enabled:
            continue
        compatible = (int(m.geom_contype[g]) & plane_conaffinity) or (
            plane_contype & int(m.geom_conaffinity[g])
        )
        if not compatible:
            continue
        gtype = int(m.geom_type[g])
        size = m.geom_size[g]
        pos = m.geom_pos[g]
        quat = m.geom_quat[g]
        # Contact friction combines per mj_contactParam: the higher-
        # priority geom wins outright, else elementwise max.
        pr_g = int(m.geom_priority[g])
        pr_p = int(m.geom_priority[planes[0]])
        if pr_g != pr_p:
            fric = float(
                m.geom_friction[g if pr_g > pr_p else planes[0]][0]
            )
        else:
            fric = max(
                float(m.geom_friction[g][0]),
                float(m.geom_friction[planes[0]][0]),
            )
        solref, solimp = _mix_solparams(g, planes[0])
        # Contact margin is the SUM of the two geoms' margins (observed:
        # ant.xml margin 0.01+0.01 → includemargin 0.02).
        margin = (
            float(m.geom_margin[g]) + float(m.geom_margin[planes[0]])
        )
        # diagApprox of one pyramid facet row:
        #   Σ body translational invweight0 · 2μ²(1+μ²) / impratio
        # with μ the combined contact friction — identified numerically
        # against efc_diagA over (μ, impratio) sweeps of plane-sphere
        # probes and confirmed on the articulated gym models.
        invw = (
            float(m.body_invweight0[b][0])
            * 2.0 * fric**2 * (1.0 + fric**2)
            / max(float(m.opt.impratio), 1e-12)
        )

        def _add(p_local, radius, axis=None, b=b, fric=fric, solref=solref,
                 solimp=solimp, margin=margin, invw=invw):
            con_body.append(b)
            con_pos.append(np.asarray(p_local, np.float64))
            con_radius.append(float(radius))
            con_fric.append(fric)
            con_solref.append(np.asarray(solref, np.float64))
            con_solimp.append(np.asarray(solimp, np.float64))
            con_margin.append(margin)
            con_invw.append(invw)
            con_axis.append(
                np.zeros(3) if axis is None else np.asarray(axis, np.float64)
            )

        if gtype == int(mujoco.mjtGeom.mjGEOM_SPHERE):
            _add(pos.copy(), size[0])
        elif gtype == int(mujoco.mjtGeom.mjGEOM_CAPSULE):
            # Endpoint spheres at ±half-length along the local z axis.
            # The capsule's body-frame axis is kept: MuJoCo's plane-capsule
            # contact frame aligns tangent 1 with the capsule axis
            # projected onto the plane (anisotropic friction pyramid).
            half = float(size[1])
            zdir = _quat_rotate_np(quat, np.array([0.0, 0.0, 1.0]))
            for sgn in (-1.0, 1.0):
                _add(pos + sgn * half * zdir, size[0], axis=zdir)
        elif gtype == int(mujoco.mjtGeom.mjGEOM_BOX):
            # Corner point contacts (radius 0): the standard
            # corner-sphere approximation of box-plane contact (so
            # stacker/manipulator boxes rest stably on the floor).
            for sx in (-1.0, 1.0):
                for sy in (-1.0, 1.0):
                    for sz in (-1.0, 1.0):
                        corner = np.array(
                            [sx * size[0], sy * size[1], sz * size[2]]
                        )
                        _add(pos + _quat_rotate_np(quat, corner), 0.0)
        # Ellipsoids/planes/other types: skipped (not needed for the suite).

    # Body-body contact pairs (sphere/capsule only), following MuJoCo's
    # default broadphase filter: contype/conaffinity compatibility,
    # different bodies, parent-child excluded unless the parent is the
    # world (engine_collision_driver.c mj_collision filterparent).
    def _segment(g):
        gtype = int(m.geom_type[g])
        pos = m.geom_pos[g].copy()
        if gtype == int(mujoco.mjtGeom.mjGEOM_SPHERE):
            return np.stack([pos, pos]), float(m.geom_size[g][0])
        if gtype == int(mujoco.mjtGeom.mjGEOM_CAPSULE):
            half = float(m.geom_size[g][1])
            zdir = _quat_rotate_np(m.geom_quat[g], np.array([0.0, 0.0, 1.0]))
            return (
                np.stack([pos - half * zdir, pos + half * zdir]),
                float(m.geom_size[g][0]),
            )
        return None, None

    pair_body, pair_sa, pair_sb, pair_rad, pair_fric = [], [], [], [], []
    if contacts_enabled:
        for g1 in range(m.ngeom):
            s1, r1 = _segment(g1)
            if s1 is None:
                continue
            b1 = int(m.geom_bodyid[g1])
            if b1 == 0:
                continue
            for g2 in range(g1 + 1, m.ngeom):
                s2, r2 = _segment(g2)
                if s2 is None:
                    continue
                b2 = int(m.geom_bodyid[g2])
                if b2 == 0 or b1 == b2:
                    continue
                compat = (
                    int(m.geom_contype[g1]) & int(m.geom_conaffinity[g2])
                ) or (int(m.geom_contype[g2]) & int(m.geom_conaffinity[g1]))
                if not compat:
                    continue
                # filterparent: skip parent-child body pairs.
                if (
                    int(m.body_parentid[b1]) == b2
                    or int(m.body_parentid[b2]) == b1
                ):
                    continue
                pair_body.append([b1, b2])
                pair_sa.append(s1)
                pair_sb.append(s2)
                pair_rad.append([r1, r2])
                pair_fric.append(
                    max(float(m.geom_friction[g1][0]),
                        float(m.geom_friction[g2][0]))
                )

    act_trnid = (
        m.actuator_trnid[:, 0].copy()
        if m.nu
        else np.zeros(0, np.int32)
    )
    act_gear = m.actuator_gear[:, 0].copy() if m.nu else np.zeros(0)
    act_gain = (
        m.actuator_gainprm[:, 0].copy() if m.nu else np.zeros(0)
    )
    act_trntype = (
        m.actuator_trntype.copy() if m.nu else np.zeros(0, np.int32)
    )
    act_biastype = (
        m.actuator_biastype.copy() if m.nu else np.zeros(0, np.int32)
    )
    act_biasprm = (
        m.actuator_biasprm[:, :3].copy() if m.nu else np.zeros((0, 3))
    )
    act_dyntype = (
        m.actuator_dyntype.copy() if m.nu else np.zeros(0, np.int32)
    )
    act_dynprm = (
        m.actuator_dynprm[:, 0].copy() if m.nu else np.zeros(0)
    )

    # Tendons.  Fixed tendons (mjWRAP_JOINT wraps) become joint-coef
    # lists; spatial ones (mjWRAP_SITE) become site pairs.
    ten_fixed, tf_k, tf_d, tf_l = [], [], [], []
    ts_sites, ts_range, ts_lim, ts_k, ts_d = [], [], [], [], []
    for t in range(m.ntendon):
        adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
        wraps = [
            (int(m.wrap_type[i]), int(m.wrap_objid[i]), float(m.wrap_prm[i]))
            for i in range(adr, adr + num)
        ]
        if all(wt == int(mujoco.mjtWrap.mjWRAP_JOINT) for wt, _, _ in wraps):
            triples = tuple(
                (
                    int(m.jnt_qposadr[j]),
                    int(m.jnt_dofadr[j]),
                    coef,
                )
                for _, j, coef in wraps
            )
            ten_fixed.append(triples)
            tf_k.append(float(m.tendon_stiffness[t]))
            tf_d.append(float(m.tendon_damping[t]))
            # lengthspring is [lo, hi] in mujoco >= 2.3; use the midpoint.
            ls = np.atleast_1d(m.tendon_lengthspring[t])
            tf_l.append(float(ls.mean()))
        elif all(wt == int(mujoco.mjtWrap.mjWRAP_SITE) for wt, _, _ in wraps):
            if num != 2:
                continue  # multi-site routing unsupported (vis-only in dmc)
            ts_sites.append([wraps[0][1], wraps[1][1]])
            ts_range.append(m.tendon_range[t].copy())
            ts_lim.append(bool(m.tendon_limited[t]))
            ts_k.append(float(m.tendon_stiffness[t]))
            ts_d.append(float(m.tendon_damping[t]))

    return PhysModel(
        nq=int(m.nq),
        nv=int(m.nv),
        nu=int(m.nu),
        nbody=int(m.nbody),
        body_parent=m.body_parentid.copy(),
        body_pos=m.body_pos.copy(),
        body_quat=m.body_quat.copy(),
        body_mass=m.body_mass.copy(),
        body_inertia=m.body_inertia.copy(),
        body_ipos=m.body_ipos.copy(),
        body_iquat=m.body_iquat.copy(),
        jnt_type=m.jnt_type.copy(),
        jnt_body=m.jnt_bodyid.copy(),
        jnt_axis=m.jnt_axis.copy(),
        jnt_pos=m.jnt_pos.copy(),
        jnt_qposadr=m.jnt_qposadr.copy(),
        jnt_dofadr=m.jnt_dofadr.copy(),
        jnt_range=m.jnt_range.copy(),
        jnt_limited=m.jnt_limited.astype(bool).copy(),
        jnt_stiffness=m.jnt_stiffness.copy(),
        qpos_spring=m.qpos_spring.copy(),
        dof_damping=m.dof_damping.copy(),
        dof_armature=m.dof_armature.copy(),
        act_trnid=act_trnid,
        act_gear=act_gear,
        act_ctrlrange=m.actuator_ctrlrange.copy()
        if m.nu
        else np.zeros((0, 2)),
        act_ctrllimited=m.actuator_ctrllimited.astype(bool).copy()
        if m.nu
        else np.zeros(0, bool),
        con_body=np.asarray(con_body, np.int32),
        con_pos=np.asarray(con_pos, np.float64).reshape(-1, 3),
        con_radius=np.asarray(con_radius, np.float64),
        con_friction=np.asarray(con_fric, np.float64),
        con_solref=np.asarray(con_solref, np.float64).reshape(-1, 2),
        con_solimp=np.asarray(con_solimp, np.float64).reshape(-1, 5),
        con_invw=np.asarray(con_invw, np.float64),
        con_margin=np.asarray(con_margin, np.float64),
        con_axis=np.asarray(con_axis, np.float64).reshape(-1, 3),
        jnt_solref_lim=m.jnt_solref.copy(),
        jnt_solimp_lim=m.jnt_solimp.copy(),
        jnt_margin=m.jnt_margin.copy(),
        dof_invweight=m.dof_invweight0.copy(),
        site_body=m.site_bodyid.copy()
        if m.nsite
        else np.zeros(0, np.int32),
        site_pos=m.site_pos.copy() if m.nsite else np.zeros((0, 3)),
        site_names=tuple(m.site(i).name for i in range(m.nsite)),
        geom_body=m.geom_bodyid.copy(),
        geom_type=m.geom_type.copy(),
        geom_size=m.geom_size.copy(),
        geom_pos=m.geom_pos.copy(),
        geom_quat=m.geom_quat.copy(),
        geom_rgba=m.geom_rgba.copy(),
        body_names=tuple(m.body(i).name for i in range(m.nbody)),
        timestep=float(m.opt.timestep),
        gravity=m.opt.gravity.copy(),
        density=float(m.opt.density),
        viscosity=float(m.opt.viscosity),
        qpos0=m.qpos0.copy(),
        integrator=int(m.opt.integrator),
        act_gain=act_gain,
        act_trntype=act_trntype,
        act_biastype=act_biastype,
        act_biasprm=act_biasprm,
        act_dyntype=act_dyntype,
        act_dynprm=act_dynprm,
        ten_fixed=tuple(ten_fixed),
        ten_fixed_stiffness=np.asarray(tf_k),
        ten_fixed_damping=np.asarray(tf_d),
        ten_fixed_springlen=np.asarray(tf_l),
        ten_spatial_sites=np.asarray(ts_sites, np.int32).reshape(-1, 2),
        ten_spatial_range=np.asarray(ts_range, np.float64).reshape(-1, 2),
        ten_spatial_limited=np.asarray(ts_lim, bool),
        ten_spatial_stiffness=np.asarray(ts_k),
        ten_spatial_damping=np.asarray(ts_d),
        pair_body=np.asarray(pair_body, np.int32).reshape(-1, 2),
        pair_seg_a=np.asarray(pair_sa, np.float64).reshape(-1, 2, 3),
        pair_seg_b=np.asarray(pair_sb, np.float64).reshape(-1, 2, 3),
        pair_radius=np.asarray(pair_rad, np.float64).reshape(-1, 2),
        pair_friction=np.asarray(pair_fric, np.float64),
    )


def _quat_rotate_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    r = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    return r @ v


# -- the committed data ------------------------------------------------------


def gymnasium_xml(name: str) -> str:
    """The path of one of gymnasium's MuJoCo model files."""
    import gymnasium

    return os.path.join(
        os.path.dirname(gymnasium.__file__), "envs", "mujoco", "assets", name
    )


def robotics_xml(name: str, workdir: str) -> str:
    """The path of gymnasium_robotics' model ``name`` (``hand/reach.xml``)
    in a copy of its assets under ``workdir`` whose XML files have the
    ``apirate`` attribute stripped, as ``envpool_tpu/envs/robotics/hand.py``
    strips it."""
    import gymnasium_robotics

    base = os.path.join(os.path.dirname(gymnasium_robotics.__file__), "envs", "assets")
    copy = os.path.join(workdir, "assets")
    shutil.copytree(base, copy)
    for root, _, files in os.walk(copy):
        for f in files:
            if f.endswith(".xml"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    text = fh.read()
                stripped = re.sub(r'\sapirate="[^"]*"', "", text)
                if stripped != text:
                    with open(path, "w") as fh:
                        fh.write(stripped)
    return os.path.join(copy, name)


# dm_control models built by a suite module's generator rather than read
# from ``<domain>.xml``: name -> (module, generator, arguments).  The JAX
# package builds them with these arguments (``envs/mujoco_dmc/tasks2.py``,
# ``tasks3.py``); lqr's with ``RandomState(LQR_SEED)``, its ``gen_seed``.
LQR_SEED = 42
_GENERATED = {
    "lqr_2_1": ("lqr", "_make_model", (2, 1, "rng")),
    "lqr_6_2": ("lqr", "_make_model", (6, 2, "rng")),
    "quadruped_walk": ("quadruped", "make_model", {"floor_size": 20 * 0.5}),
    "quadruped_run": ("quadruped", "make_model", {"floor_size": 20 * 5.0}),
    "quadruped_escape": ("quadruped", "make_model",
                         {"floor_size": 40, "terrain": True, "rangefinders": True}),
    "quadruped_fetch": ("quadruped", "make_model", {"walls_and_ball": True}),
    "manipulator_bring_ball": ("manipulator", "make_model", (False, False)),
    "manipulator_bring_peg": ("manipulator", "make_model", (True, False)),
    "manipulator_insert_ball": ("manipulator", "make_model", (False, True)),
    "manipulator_insert_peg": ("manipulator", "make_model", (True, True)),
    "stacker_2": ("stacker", "make_model", (2,)),
    "stacker_4": ("stacker", "make_model", (4,)),
    # DogStand, DogWalk, DogTrot and DogRun build the dog on floors of 15,
    # 15, 45 and 135 m; nothing else differs and no task of the port reads
    # the floor's size, so the four share this one (stand's floor).
    "dog": ("dog", "get_model_and_assets", {"floor_size": 15}),
    "dog_fetch": ("dog", "get_model_and_assets", {"remove_ball": False}),
}


def dmc_mj_model(name: str):
    """The ``mujoco.MjModel`` of ``dmc:<domain>``, ``dmc:<domain>_<n>`` or
    one of the generated models of ``_GENERATED``."""
    import mujoco
    from dm_control import suite
    from dm_control.suite import common
    from dm_control.utils import io as dmc_io

    key = name.removeprefix("dmc:")
    assets = common.ASSETS
    if key in _GENERATED:
        module, fn, args = _GENERATED[key]
        make = getattr(importlib.import_module(f"dm_control.suite.{module}"), fn)
        if isinstance(args, dict):
            xml = make(**args)
        else:
            xml = make(*(np.random.RandomState(LQR_SEED) if a == "rng" else a for a in args))
        if isinstance(xml, tuple):  # (xml, assets)
            xml, assets = xml
        return mujoco.MjModel.from_xml_string(
            xml.decode() if isinstance(xml, bytes) else xml, assets)
    domain, _, n = key.rpartition("_")
    if not n.isdigit():
        domain, n = key, ""
    if n:
        module = importlib.import_module(f"dm_control.suite.{domain}")
        xml = module._make_model(int(n))
    else:
        path = os.path.join(os.path.dirname(suite.__file__), f"{domain}.xml")
        xml = dmc_io.GetResource(path)
    return mujoco.MjModel.from_xml_string(xml.decode(), assets)


def named_constants(m) -> dict[str, np.ndarray]:
    """What the dm_control tasks of the second slice read from their
    ``mujoco.MjModel`` beyond the PhysModel: joint and geom names, site
    sizes, the heightfield's size and the rangefinder count."""
    import mujoco

    return {
        "joint_names": np.asarray([m.joint(j).name for j in range(m.njnt)], np.str_),
        "geom_names": np.asarray([m.geom(g).name for g in range(m.ngeom)], np.str_),
        "site_size": np.asarray(m.site_size, np.float64).reshape(-1, 3),
        "hfield_size": np.asarray(m.hfield_size, np.float64).reshape(-1, 4),
        "n_rangefinder": np.asarray(
            int(np.sum(m.sensor_type == mujoco.mjtSensor.mjSENS_RANGEFINDER)), np.int64),
    }


# The models whose tasks read named_constants.
NAMED = ("dmc:point_mass", "dmc:ball_in_cup", "dmc:fish", "dmc:finger",
         *(f"dmc:{k}" for k in _GENERATED))


def swimmer_constants(m) -> dict[str, np.ndarray]:
    """The nose geom's offset in its body and that body, and the target
    geom's height (``envs/mujoco_dmc/tasks.py`` in the JAX package)."""
    import mujoco

    nose = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, "nose")
    target = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, "target")
    return {
        "nose_offset": np.asarray(m.geom_pos[nose], np.float64),
        "nose_body": np.asarray(m.geom_bodyid[nose], np.int64),
        "target_z": np.asarray(m.geom_pos[target][2], np.float64),
    }


def cheetah_bank() -> dict[str, np.ndarray]:
    """CheetahRun's reset bank: the env's ``start_states`` settled by its
    ``settle`` in float64 on the CPU (``envs/mujoco_dmc/tasks.py``)."""
    import envpool_tpu_torch

    load_model.cache_clear()  # the model file was just written
    env = envpool_tpu_torch.make_spec("CheetahRun-v1", device="cpu").env
    q, v = env.settle(env.start_states().double())
    return {"bank_qpos": q.numpy(), "bank_qvel": v.numpy()}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--xml", help="write this MJCF file's model instead")
    p.add_argument("--out", help="where --xml's .npz goes (pass it as `xml_file`)")
    args = p.parse_args(argv)
    if args.xml:
        save_npz(from_mjcf(args.xml), args.out or os.path.splitext(args.xml)[0] + ".npz")
        return
    for name, data in sorted(ASSETS.items()):
        path = os.path.join(ASSET_DIR, data)
        if name.startswith("hand/"):
            with tempfile.TemporaryDirectory() as work:
                save_npz(from_mjcf(robotics_xml(name, work)), path)
        elif name.startswith("dmc:"):
            m = dmc_mj_model(name)
            consts = (swimmer_constants(m) if name.startswith("dmc:swimmer")
                      else named_constants(m) if name in NAMED else None)
            model = from_mj_model(m)
            save_npz(model, path, consts)
            if name == "dmc:cheetah":
                save_npz(model, path, cheetah_bank())
        else:
            save_npz(from_mjcf(gymnasium_xml(name)), path)
        print(f"{name} -> {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
