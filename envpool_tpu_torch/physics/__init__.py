"""Batched rigid-body physics of the port (counterpart of
``envpool_tpu/physics``): hinge and slide joints, penalty contacts against
the ground plane, Euler with implicit damping and RK4, over ``[N, ...]``
tensors."""

from .dynamics import ContactParams, bias_forces, mass_matrix, step
from .model import PhysModel, from_mj_model, from_mjcf, load_model

__all__ = [
    "ContactParams",
    "PhysModel",
    "bias_forces",
    "from_mj_model",
    "from_mjcf",
    "load_model",
    "mass_matrix",
    "step",
]
