"""Driver of the FastSLAM cells: slam2d_tpu_torch.run.fastslam_run.
run_fastslam with `host_gated=None` (below 512 particles the device-gated
steps, on CUDA one PFChunkGraph replay a chunk).

A session is one robot's log from a fresh state, delivered chunk by
chunk: each chunk is one call of `run_fastslam` on the chunk's scans with
the state the previous call returned and the chunk's draws, and its best
poses, N_eff and best scores come back to the host when the call returns.
The draws (standard normal proposal noise [T, P, 3], the resample's
uniforms [T]) are made on the device from the seed by a torch.Generator,
and both the program and the reference take them.

The check (`judge`) runs each kept chunk's steps with the plain reference
(benchmark/reference/fastslam.py) from the program's state at the chunk's
start (a fresh state at a session's start) with the same draws, and
compares three numbers at the chunk's end:

- `particle_miss`: the share of particles whose pose lies more than 5 mm
  or 5 mrad from the reference's;
- `cell_miss`: the share of the map cells (over every particle) that
  either side changed in the chunk whose log-odds differ by more than
  1e-3;
- `best_miss`: the share of the chunk's scans whose reported best pose
  lies more than 5 mm or 5 mrad from the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import traffic
from benchmark.port import pf_config, program_config
from benchmark.reference.fastslam import FIELDS, FastSlamReference

TOL_XY = 5e-3     # m
TOL_THETA = 5e-3  # rad
CELL_TOL = 1e-3   # log-odds


def pose_miss(a, b):
    """[N] bool: poses more than TOL_XY / TOL_THETA apart."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dxy = np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1])
    dth = np.abs((a[:, 2] - b[:, 2] + np.pi) % (2 * np.pi) - np.pi)
    return ~((dxy <= TOL_XY) & (dth <= TOL_THETA))


class System:
    """The program's FastSLAM under one configuration and one mix."""

    step_counters = ("refines", "updates", "resamples")

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from slam2d_tpu_torch.pf import fastslam
        from slam2d_tpu_torch.run import fastslam_run
        self._run, self._step = fastslam_run.run_fastslam, fastslam.fastslam_step
        self.cfg, self.device = cfg, torch.device(device)
        self.pcfg, self.pf = program_config(cfg), pf_config(cfg)
        self.K = cfg["frontend"]["chunk"]
        self.log = traffic.session_log(mix, cfg["sensor"], self.K, seed)
        self.n_chunks = len(self.log["odom"]) // self.K
        T, P = len(self.log["odom"]), self.pf.n_particles
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.noise = torch.randn((T, P, 3), generator=gen, device=self.device)
        self.u = torch.rand(T, generator=gen, device=self.device)

    def chunk_log(self, c: int) -> dict:
        sl = slice(c * self.K, (c + 1) * self.K)
        return {"odom": self.log["odom"][sl], "ranges": self.log["ranges"][sl]}

    def draws(self, c: int):
        sl = slice(c * self.K, (c + 1) * self.K)
        return self.noise[sl], self.u[sl]

    def new_session(self) -> dict:
        return {"state": None}

    def run_chunk(self, sess: dict, c: int) -> np.ndarray:
        """Chunk c of the session: [K, 5] best pose, N_eff, best score."""
        state, traj, n_eff, scores = self._run(
            self.chunk_log(c), self.pcfg, self.pf, self.device,
            state=sess["state"], draws=self.draws(c), host_gated=None)
        sess["state"] = state
        return np.concatenate([traj, n_eff[:, None], scores[:, None]], axis=1)

    def snapshot(self, sess: dict) -> dict:
        st = sess["state"]._asdict()
        return {k: st[k].clone() for k in FIELDS}

    def counters(self) -> dict:
        s = self._step
        return {"host_reads": s.host_syncs, "refines": s.refines,
                "updates": s.updates, "resamples": s.resamples}

    def judge(self, keeps, device) -> dict:
        """The check's numbers over the kept chunks (module docstring)."""
        ref = FastSlamReference(self.cfg, device)
        odom = torch.as_tensor(self.log["odom"], device=device)
        ranges = torch.as_tensor(self.log["ranges"], device=device)
        noise, u = self.noise.to(device), self.u.to(device)
        n = dict(particles=0, particles_missed=0, cells_touched=0,
                 cells_missed=0, scans=0, scans_missed=0)
        for keep in keeps:
            c, K = keep["chunk"], self.K
            st = (ref.fresh(self.log["odom"][0]) if keep["start"] is None
                  else ref.resume(keep["start"]))
            start_maps = st["logodds"].clone()
            best = []
            for k in range(K):
                t = c * K + k
                bp, _, _ = ref.step(st, odom[t], ranges[t], noise[t], u[t])
                best.append(bp)
            end = keep["end"]
            n["particles"] += len(st["poses"])
            n["particles_missed"] += int(pose_miss(
                st["poses"].cpu().numpy(), end["poses"].cpu().numpy()).sum())
            got = torch.stack(best).cpu().numpy()
            n["scans"] += K
            n["scans_missed"] += int(pose_miss(got, keep["out"][:, :3]).sum())
            pm = end["logodds"].to(device)
            touched = (pm != start_maps) | (st["logodds"] != start_maps)
            diff = (pm.float() - st["logodds"].float()).abs() > CELL_TOL
            n["cells_touched"] += int(touched.sum())
            n["cells_missed"] += int((touched & diff).sum())
            del st, start_maps, pm, touched, diff
        return {
            "particle_miss": n["particles_missed"] / max(n["particles"], 1),
            "cell_miss": n["cells_missed"] / max(n["cells_touched"], 1),
            "best_miss": n["scans_missed"] / max(n["scans"], 1),
        }, n


class Control(System):
    """The control: the plain reference computed in float8 (e4m3), the
    nearest precision below the configuration's bfloat16 (every map write,
    the fields and the splats rounded to it), running free in the
    program's place with the same draws."""

    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        self._ref = FastSlamReference(cfg, self.device,
                                      low=torch.float8_e4m3fn)

    def run_chunk(self, sess, c):
        if sess["state"] is None:
            sess["state"] = self._ref.fresh(self.log["odom"][0])
        st = sess["state"]
        odom = torch.as_tensor(self.chunk_log(c)["odom"], device=self.device)
        ranges = torch.as_tensor(self.chunk_log(c)["ranges"],
                                 device=self.device)
        noise, u = self.draws(c)
        rows = []
        for k in range(self.K):
            bp, ne, sc = self._ref.step(st, odom[k], ranges[k], noise[k], u[k])
            rows.append(torch.cat([bp, ne.reshape(1), sc.reshape(1)]))
        return torch.stack(rows).cpu().numpy()

    def snapshot(self, sess):
        return {k: sess["state"][k].clone() for k in FIELDS}

    def counters(self):
        return {"host_reads": 0, "refines": 0, "updates": 0, "resamples": 0}
