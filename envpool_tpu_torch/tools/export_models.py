"""Write the committed model data of the port's default MJCF models.

Each model in ``physics.model.ASSETS`` is extracted from gymnasium's MuJoCo
assets (``gymnasium/envs/mujoco/assets/``, MIT-licensed: every XML the
Gym-MuJoCo ids use) through the port's own ``physics.model.from_mjcf``
and written to ``envpool_tpu_torch/physics/assets/`` as an ``.npz`` that
loads without pickle, ``mujoco`` or ``gymnasium``.  It needs ``mujoco``
and ``gymnasium``::

    python -m envpool_tpu_torch.tools.export_models
"""

from __future__ import annotations

import os

from envpool_tpu_torch.physics.model import ASSET_DIR, ASSETS, from_mjcf, save_npz


def gymnasium_xml(name: str) -> str:
    """The path of one of gymnasium's MuJoCo model files."""
    import gymnasium

    return os.path.join(
        os.path.dirname(gymnasium.__file__), "envs", "mujoco", "assets", name
    )


def main() -> None:
    for xml, data in sorted(ASSETS.items()):
        path = os.path.join(ASSET_DIR, data)
        save_npz(from_mjcf(gymnasium_xml(xml)), path)
        print(f"{xml} -> {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
