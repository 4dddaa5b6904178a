"""Batched rigid-body physics of the port (counterpart of
``envpool_tpu/physics``): hinge, slide, ball and free joints, penalty
contacts against the ground plane or MuJoCo's soft constraints solved by
projected Gauss–Seidel (``solver.py``), fluid drag, fixed tendons, Euler
with implicit damping and RK4, over ``[N, ...]`` tensors."""

from .dynamics import ContactParams, bias_forces, mass_matrix, step
from .model import PhysModel, load_model

__all__ = [
    "ContactParams",
    "PhysModel",
    "bias_forces",
    "load_model",
    "mass_matrix",
    "step",
]
