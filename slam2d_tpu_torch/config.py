"""Frozen config dataclasses of the port.

A copy of the JAX package's SensorConfig, GridConfig, MatcherConfig,
PFConfig, GraphConfig and FrontendConfig (slam2d_tpu/config.py): the same field names,
defaults, properties and methods, so a configuration reads the same in
both packages. The port keeps its own copy and imports nothing of
slam2d_tpu. Settings that only the JAX package's TPU paths read
(chunking, dispatch, diagnostics) are kept so the fields line up; the
port's functions raise on the ones they do not implement.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """2D planar laser model (CARMEN FLASER-style: 180deg FOV, 1deg steps)."""

    n_beams: int = 180
    fov_rad: float = math.pi          # 180 degrees
    min_range: float = 0.10           # ranges below this are invalid
    max_range: float = 12.0           # clip; CARMEN logs report 81.9 for no-hit
    # Angle of beam 0 relative to robot heading (CARMEN: -90 deg).
    angle_min: float = -math.pi / 2.0

    def beam_angles(self):
        """[B] float64 numpy beam angles. The kernels cast this table to
        float32 once: a float32 rebuild differs by one ulp, enough to move
        a boundary endpoint into the neighbouring cell."""
        import numpy as np

        step = self.fov_rad / max(self.n_beams - 1, 1)
        return self.angle_min + step * np.arange(self.n_beams)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Fixed-capacity world-anchored log-odds grid [H, W]; rows = y,
    cols = x."""

    height: int = 1024
    width: int = 1024
    resolution: float = 0.10          # meters per cell
    # World coordinate of the *center* cell (H//2, W//2).
    center_x: float = 0.0
    center_y: float = 0.0
    l_occ: float = 0.85               # log-odds increment for an endpoint hit
    l_free: float = -0.40             # log-odds increment per free-space sample
    l_clamp: float = 10.0             # |log-odds| clamp
    # Free-space samples per beam of the sampled-ray update; the exact-ray
    # update ("pallas_ray") weighs its chords by max(res, range / samples).
    ray_samples: int = 192
    # Scan-integration update: "auto" resolves per call site (the
    # frontend's hybrid update, the particle filter's inverse-sensor-model
    # update; the sampled-ray update past a field of view of pi);
    # "pallas" (ISM), "pallas_hybrid" (ISM free carve + exact endpoint
    # cells), "pallas_ray" (exact chords + exact endpoint cells), "sparse"
    # and "sparse_mxu" (sampled rays, scatter-added), "dense" (the
    # elementwise inverse sensor model).
    update_impl: str = "auto"

    @property
    def origin_x(self) -> float:
        return self.center_x - (self.width // 2) * self.resolution

    @property
    def origin_y(self) -> float:
        return self.center_y - (self.height // 2) * self.resolution


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Correlative scan matcher: a (theta, y, x) window around the prior,
    a max-pooled coarse pass and a bilinear fine pass."""

    # Translation search half-window, meters (full window = 2*r + 1 cells).
    search_xy: float = 0.4
    # Rotation half-window and step, radians.
    search_theta: float = 0.20
    n_theta: int = 17                 # odd: includes delta-theta = 0
    coarse_factor: int = 4            # coarse grid pooling factor
    # Gaussian blur sigma of the search space, in METERS.
    sigma_m: float = 0.10
    # Candidate scorer: "auto" (the gather scorer), "auto_refine" (the
    # per-particle refine's correlation scorer "cmx"), "gather", "pallas",
    # "cmx", "emx"; see match/correlative.py:resolve_score_impl.
    score_impl: str = "auto"
    # bf16 splat weights (float32 accumulate) in the correlation scorer.
    score_bf16: bool = True
    # Fine-pass theta restriction (pyramid path only): +-fine_theta_bins
    # bins around the coarse theta winner. <0 = full grid.
    fine_theta_bins: int = 2
    occ_threshold: float = 0.5        # p(cell) above this counts as occupied
    occ_evidence_sat: float = 2.0     # log-odds at which a cell counts as a full wall
    free_threshold: float = 0.45      # p(cell) below this counts as known-free
    free_penalty: float = 0.6         # negative field value deep in free space
    min_score: float = 0.15           # below: distrust match, keep prior
    # Weight of the Gaussian motion prior penalty subtracted from the score
    # surface (score units per m^2 / rad^2).
    prior_xy_weight: float = 2.0
    prior_theta_weight: float = 2.0

    def n_xy(self, resolution: float) -> int:
        """Fine-resolution full window size (odd) in cells."""
        r = int(round(self.search_xy / resolution))
        return 2 * r + 1


@dataclasses.dataclass(frozen=True)
class PFConfig:
    """FastSLAM particle filter."""

    n_particles: int = 32
    # Odometry proposal noise (std-dev) on x, y, theta per step.
    noise_xy: float = 0.04
    noise_theta: float = 0.02
    # Per-particle refinement matcher overrides (None = inherit).
    refine_xy: float | None = None
    refine_theta: float | None = None
    refine_n_theta: int | None = None
    refine_prior_weight: float | None = None
    refine_score_impl: str | None = None
    # "shared" (one product against a scan-shared shift stack),
    # "per_particle" (the matcher per particle), "auto" (shared from
    # refine_shared_min_particles particles on).
    refine_mode: str = "auto"
    refine_shared_min_particles: int = 32
    # Extra global-theta slots on each side of the shared refine's grid.
    refine_theta_pad: int = 3
    resample_threshold: float = 0.5   # resample when N_eff < threshold * N
    # Log-weight increment = sharpness * match score.
    weight_sharpness: float = 30.0
    # Per-particle map storage dtype: "float32" or "bfloat16".
    map_dtype: str = "float32"
    # Chunking of the JAX package's vmapped refine (not read by the port,
    # which batches every particle in one launch).
    refine_chunk: int = 0
    # "shared" (G scan images on a theta grid, added per particle at its
    # anchor cell), "per_particle" (the ISM update per particle), "auto"
    # (shared from update_shared_min_particles particles on).
    update_mode: str = "auto"
    update_theta_slots: int = 16
    update_shared_min_particles: int = 256
    # Shared-update settings; the port implements the production mode
    # (update_subcell 1, update_bilinear False, exact fused endpoints,
    # dither "off", carve shrink 0) and raises on the others.
    update_subcell: int = 1
    update_bilinear: bool = False
    update_exact_endpoints: bool = True
    update_fused_endpoints: bool = True
    update_anchor_dither: str = "off"
    # Keep the shared update's image stack float32 past the 4 MiB bf16
    # cast threshold.
    update_images_f32: bool = False
    update_carve_shrink: float = 0.0
    # Dispatch settings of the JAX package's run loop (not read by the port).
    fuse_light_prefix: int = 8
    # Rotation quantization of the shared update: the theta-slot step is
    # 2 * update_qstep_cells * res / max_range.
    update_qstep_cells: float = 0.5
    host_gate_min_particles: int = 512


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Pose-graph backend and full SLAM's keyframe and loop gates."""

    keyframe_dist: float = 0.5        # admit a keyframe every d meters ...
    keyframe_angle: float = 0.5       # ... or psi radians
    max_nodes: int = 512              # static node capacity
    max_edges: int = 2048             # static edge capacity
    gn_iters: int = 10
    loop_radius: float = 3.0          # spatial gate for loop candidates
    loop_min_gap: int = 20            # min keyframe index gap for a loop
    # Accept gates, from the JAX package's precision/recall sweep of loop
    # attempts labelled against ground truth (precision 1.0, recall ~0.91).
    loop_score_accept: float = 0.45   # matcher score to accept a loop edge
    # Plausibility gate: reject a loop whose implied correction of the
    # current estimate exceeds these bounds (corridor aliases shifted by
    # the structure's period); raised for long-drift logs.
    loop_max_correction_xy: float = 1.0
    loop_max_correction_theta: float = 0.4
    # Drift-relative relaxation of that gate: the bound is max(fixed,
    # rate * keyframe path length since max(matched keyframe, last
    # accept)); 0 disables.
    loop_correction_drift_xy: float = 0.03    # m of bound per m travelled
    loop_correction_drift_theta: float = 0.012  # rad of bound per m
    # Post-solve consistency prune: after an accepted loop's solve, loop
    # edges whose whitened residual^2 exceeds this (or an accept that
    # raises the converged chi^2 by more) are disabled for good and the
    # graph solved again. 0 disables.
    loop_prune_chi2: float = 9.0
    # Skip loop attempts for this many keyframes after an accepted loop.
    loop_cooldown: int = 3
    # Peak-dominance gate: reject loops whose coarse score surface has a
    # second peak (beyond 0.5 m of the best) within this margin of the
    # best. 0 disables.
    loop_min_peak_margin: float = 0.05
    # Robust kernel on edge residuals, reweighted each Gauss-Newton
    # iteration: "none" (quadratic), "huber" or "dcs" (Dynamic Covariance
    # Scaling); delta in whitened-residual units.
    robust_kind: str = "none"
    robust_delta: float = 3.0
    # Graduated non-convexity: iteration k < robust_gnc_iters uses delta *
    # 10^(robust_gnc_iters - k). 0 = robust from the first iteration.
    robust_gnc_iters: int = 2
    damping: float = 1e-6             # Levenberg damping on H diagonal
    # Matrix-free and hierarchical solvers (graph/sparse.py): the loop-edge
    # capacity of the preconditioner and the anchor graph, the anchor
    # stride, PCG iterations a Gauss-Newton step, the capacity up to which
    # the V-cycle solves dense, and the number of V-cycles.
    sparse_max_loops: int = 64
    sparse_coarse_stride: int = 16
    sparse_cg_iters: int = 48
    hier_dense_max: int = 512
    sparse_hier_cycles: int = 2


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Everything the scan-matching frontend needs."""

    sensor: SensorConfig = SensorConfig()
    grid: GridConfig = GridConfig()
    matcher: MatcherConfig = MatcherConfig()
    # Scans per chunk that run_frontend copies to the device at once.
    chunk: int = 32
    # Bootstrap: trust odometry (no matching) until this much travel, while
    # integrating every scan.
    bootstrap_dist: float = 3.0
    # Localization-only mode: a fixed map, no bootstrap, no map update.
    localize_only: bool = False
    # Motion filter of the map update.
    map_update_min_motion: float = 0.30
    map_update_min_rot: float = 0.25
    # Match gate: match only after this much motion / rotation.
    match_min_motion: float = 0.15
    match_min_rot: float = 0.10
    # Dispatch settings of the JAX package's run loop (not read by the port).
    scan_unroll: int = 1
    chunks_per_dispatch: int = 2
