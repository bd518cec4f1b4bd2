"""Driver of the frontend cells: slam2d_tpu_torch.run.frontend.run_frontend.

A session is one robot's log from a fresh state, delivered chunk by
chunk: each chunk is one call of `run_frontend` on the chunk's scans with
the state the previous call returned (on CUDA one replay of the config's
ChunkGraph), and its poses come back to the host when the call returns.

The check (`judge`) follows the program scan by scan with the plain
reference (benchmark/reference/frontend.py) over each kept chunk, from the
program's state at the chunk's start (the empty map at a session's
start), and compares two numbers:

- `pose_miss`: the share of the chunk's scans whose pose lies more than
  1 mm or 1 mrad from the reference's, whose prior is the program's
  previous pose;
- `cell_miss`: the share of the map cells that either side changed in
  the chunk whose log-odds differ by more than 1e-4 at its end, the
  reference having integrated each scan at the program's pose.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import traffic
from benchmark.port import program_config
from benchmark.reference.frontend import FrontendReference

TOL_XY = 1e-3     # m
TOL_THETA = 1e-3  # rad
CELL_TOL = 1e-4   # log-odds
STATE_FIELDS = ("logodds", "pose", "prev_odom", "dist", "last_map_pose",
                "since_match")


def pose_gap_miss(a, b):
    """[N] bool: poses more than TOL_XY / TOL_THETA apart."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dxy = np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1])
    dth = np.abs((a[:, 2] - b[:, 2] + np.pi) % (2 * np.pi) - np.pi)
    return ~((dxy <= TOL_XY) & (dth <= TOL_THETA))


class System:
    """The program's frontend under one configuration and one mix."""

    step_counters = ("matches", "updates")

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from slam2d_tpu_torch.run import frontend
        self._frontend = frontend
        self.cfg, self.device = cfg, torch.device(device)
        self.pcfg = program_config(cfg)
        self.K = cfg["frontend"]["chunk"]
        self.log = traffic.session_log(mix, cfg["sensor"], self.K, seed)
        self.n_chunks = len(self.log["odom"]) // self.K

    def chunk_log(self, c: int) -> dict:
        sl = slice(c * self.K, (c + 1) * self.K)
        return {"odom": self.log["odom"][sl], "ranges": self.log["ranges"][sl]}

    def new_session(self) -> dict:
        return {"state": None}

    def run_chunk(self, sess: dict, c: int) -> np.ndarray:
        """Chunk c of the session: [K, 4] poses and match scores (-1 where
        the scan was not matched) on the host."""
        state, traj, scores = self._frontend.run_frontend(
            self.chunk_log(c), self.pcfg, self.device, state=sess["state"])
        sess["state"] = state
        return np.concatenate([traj, scores[:, None]], axis=1)

    def snapshot(self, sess: dict) -> dict:
        """A copy of the state the last chunk returned."""
        st = sess["state"]._asdict()
        return {k: st[k].clone() for k in STATE_FIELDS}

    def counters(self) -> dict:
        step = self._frontend.frontend_step
        return {"host_reads": step.host_syncs, "matches": step.matches,
                "updates": step.updates}

    def judge(self, keeps, device) -> dict:
        """The check's numbers over the kept chunks (module docstring)."""
        ref = FrontendReference(self.cfg, device)
        odom = torch.as_tensor(self.log["odom"], device=device)
        ranges = torch.as_tensor(self.log["ranges"], device=device)
        n_scans = n_pose = n_touched = n_cells = 0
        for keep in keeps:
            c, K = keep["chunk"], self.K
            if keep["start"] is None:
                st = ref.fresh(self.log["odom"][0])
            else:
                st = ref.resume(*(keep["start"][k] for k in STATE_FIELDS))
            start_map = st["logodds"].clone()
            prog = torch.as_tensor(
                np.asarray(keep["out"][:, :3], np.float32), device=device)
            poses = []
            for k in range(K):
                t = c * K + k
                prev = None if k == 0 else prog[k - 1]
                pose, _ = ref.step(st, odom[t], ranges[t], prev_pose=prev,
                                   update_pose=prog[k])
                poses.append(pose)
            got = torch.stack(poses).cpu().numpy()
            n_pose += int(pose_gap_miss(got, keep["out"][:, :3]).sum())
            n_scans += K
            end = keep["end"]["logodds"].to(device, torch.float32)
            touched = (end != start_map) | (st["logodds"] != start_map)
            n_touched += int(touched.sum())
            n_cells += int((touched & ((end - st["logodds"]).abs()
                                       > CELL_TOL)).sum())
        return {
            "pose_miss": n_pose / max(n_scans, 1),
            "cell_miss": n_cells / max(n_touched, 1),
        }, {"scans": n_scans, "scans_missed": n_pose,
            "cells_touched": n_touched, "cells_missed": n_cells}


class Control(System):
    """The control: the plain reference computed in bfloat16, the nearest
    precision below the configuration's float32 (its map, search space and
    scores rounded to it), running free in the program's place."""

    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        self._ref = FrontendReference(cfg, self.device,
                                      dtype=torch.bfloat16)

    def run_chunk(self, sess, c):
        if sess["state"] is None:
            sess["state"] = self._ref.fresh(self.log["odom"][0])
        st = sess["state"]
        odom = torch.as_tensor(self.chunk_log(c)["odom"], device=self.device)
        ranges = torch.as_tensor(self.chunk_log(c)["ranges"],
                                 device=self.device)
        rows = [torch.cat([pose, score.reshape(1)]) for pose, score in (
            self._ref.step(st, odom[k], ranges[k]) for k in range(self.K))]
        return torch.stack(rows).cpu().numpy()

    def snapshot(self, sess):
        st = sess["state"]
        return {k: st[k].clone() for k in STATE_FIELDS}

    def counters(self):
        return {"host_reads": 0, "matches": 0, "updates": 0}
