"""Per-episode action recording (the ``.lmp`` analog).

Counterpart of ``envpool_tpu/adapters/record.py`` (reference
``envpool/vizdoom/vizdoom_env.h:65,182-188,330-336``).  With the
``record_dir`` config (or vizdoom's ``lmp_save_dir``) the pool writes one
``env_<id>_<episode>.npz`` per finished episode: the env's actions, one
row per step, and its seed, so that a fresh pool with the same seed
replays the episode through the port's own per-env random streams.
Recording happens at the adapter's ``send``/``recv``; the functional
rollout does not record.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["EpisodeRecorder"]


class EpisodeRecorder:
    """Accumulates per-env actions; dumps one npz per finished episode."""

    def __init__(self, out_dir: str, num_envs: int, seeds: np.ndarray):
        self.dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.num_envs = num_envs
        self.seeds = np.asarray(seeds)
        self._actions: list[list[dict]] = [[] for _ in range(num_envs)]
        self._episode = np.zeros(num_envs, np.int64)

    def on_send(self, env_ids: np.ndarray, tree: dict) -> None:
        host = {k: np.asarray(v) for k, v in tree.items()}
        for row, eid in enumerate(np.asarray(env_ids)):
            self._actions[int(eid)].append({k: v[row] for k, v in host.items()})

    def on_reset(self, env_ids: np.ndarray) -> None:
        """An explicit reset cuts the episode short: its buffered actions
        would otherwise start the next finished episode's trace and make it
        unreplayable.  Drop them and advance the episode counter of any env
        mid-episode."""
        for eid in np.asarray(env_ids):
            eid = int(eid)
            if self._actions[eid]:
                self._actions[eid] = []
                self._episode[eid] += 1

    def on_recv(self, env_ids: np.ndarray, dones: np.ndarray) -> None:
        for eid, done in zip(np.asarray(env_ids), np.asarray(dones)):
            if not done:
                continue
            eid = int(eid)
            steps = self._actions[eid]
            self._actions[eid] = []
            ep = int(self._episode[eid])
            self._episode[eid] += 1
            if not steps:
                continue
            payload = {key: np.stack([s[key] for s in steps]) for key in steps[0]}
            payload["__seed__"] = np.asarray(self.seeds[eid])
            payload["__env_id__"] = np.asarray(eid)
            np.savez(os.path.join(self.dir, f"env_{eid}_{ep}.npz"), **payload)
