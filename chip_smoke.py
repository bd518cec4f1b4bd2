#!/usr/bin/env python3
"""Drive the PyTorch port (slam2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only | --multi-device-only |
                           --pf-graph-only | --twins-only]

from the repository root (--kernels-only: phases 1-3 alone;
--multi-device-only: phases 1, 2 and 22; --pf-graph-only: phases 1, 2
and 23; --twins-only: phases 1, 2 and 24). It needs a
CUDA card, PyTorch built for CUDA and nvcc; it imports nothing of JAX.
Phases, each of which raises on failure:

1. the card: its name and power limit (nvidia-smi);
2. the build of every kernel in slam2d_tpu_torch/csrc/ (nvcc, sm_90a, one
   nvcc per source, all started together) and of the native CARMEN
   parser (native/carmen_parser.cpp, c++) into slam2d_tpu_torch/_build/;
3. each of the ten kernels against its plain PyTorch version on the card,
   at its main path's shapes (the frontend's, FastSLAM-100's,
   FastSLAM-1000's, FastSLAM-16's and the exact-ray frontend's), with
   inputs made from a seed, every variant of the row gather and of the
   window field at small shapes whose alignment selects it, and the apply
   (kernel 8) at a small shape with anchors at every edge and off the map
   for maps and images in float32 and bfloat16 each (apply_edge_operands);
   the exact-ray update, the correlation and the search-space build must
   be one device activity a call (counted in a torch.profiler trace), the
   scorer, the correlation, the hybrid update and the search-space build
   must give the same bits twice, the search-space build runs at the full
   1024^2 map too and, with 0 cells off its plain version, on small
   operands at the edges of its design (search_space_edge_operands:
   shapes that are no multiple of a tile, 3, 9, 13 and 63 taps, log-odds
   at the clips and at the free threshold), the
   ISM update, held to every cell in every form (it computes a cell's
   bearing as the reference kernel does), runs at FastSLAM-1000's
   carve-image shape too and on small operands that reach the corners of
   its candidate boxes (ism_edge_operands), and the correlation and the
   hybrid update run on small operands at the edges of their designs
   (corr_edge_operands: every R, both E dtypes, the vector and scalar
   forms; hybrid_edge_operands: windows clamped into each corner of the
   map, every kind of range, stacked and on-edge endpoints); the hybrid
   update and the search-space build also at the tiled frontend's 544^2
   window, and at full SLAM's shapes (fullslam_kernel_checks): the
   hybrid update on a whole 1152^2 loop-attempt submap and on the 496^2
   rebuild window, the search-space build on the submap, the scorer's
   loop-matcher passes [41, 9, 9] over the 144^2 pooled submap and
   [5, 17, 17] over the submap, and the same kernels at phase 16's
   test_killian_scale config's shapes; and the frontend step's forms of kernels
   1 `hybrid`, 3 and 2, which read their gate and window origin from
   device memory (gated_checks): kernel 1 in place on the 520^2 update
   window and kernel 3 on its kept rectangle, at origins clamped into
   each corner of the map and inside it, with gate 1 against their plain
   versions and against the host-origin path (extract, the out-of-place
   kernel, write back): 0 cells off; with gate 0 the map and S
   bit-identical; kernel 2 with gate 0 leaves its output as it was; kernel
   1 `ray` in place on the exact-ray frontend's 520^2 window at the same
   origins (ray_window_check: 0 cells off its plain version and the
   host-origin path with gate 1, the map bit-identical with gate 0, the
   gate-0 launch timed) and kernel 1 `ism`'s window form at the same
   origins against its plain version (0 cells off at gate 1, both maps
   bit-identical at gate 0) and its pose-placed launch (the
   same bits), under update_ism.frontend_window (the `ray` and `hybrid`
   forms take each entry's top level, the host-origin forms go under
   "out_of_place"). Timed three
   ways: `ms`, `plain_ms`, `library_ms`, one call alone between two CUDA
   events (median of 30; the host's enqueue time sits inside);
   `device_ms`, `library_device_ms`, 50 calls back to back between two
   events, or the device activities of 50 calls in a torch.profiler trace
   where the host enqueues more slowly than the device runs (`device_by`);
   beside them the least time the card could take (bytes at 3.35 TB/s or
   operations at the float32 peak), `device_ms`'s share of it, and, where
   one PyTorch call computes the same function, that call's times; the
   scorer's coarse and fine passes each so; beside the bounds that lie
   under it, `launch_floor_ms`, an empty kernel of the library timed as
   `device_ms` is;
4. the frontend at bench.py's config and log (1024^2 grid at 0.05 m, 180
   beams, 1078 scans, chunk 64) as run_frontend runs it on CUDA, one CUDA
   graph replay a chunk, then the same steps eagerly, then the graph path
   again: finite trajectory, ATE below odometry (printed beside the
   0.16099 m of the host-gated step), no host read during the scans, the
   eager run's bits and device counters, one update, one search-space
   build and two scorer launches a scan run (+1 build at the start), the
   first run's returned map untouched by the second; scans/s of both
   paths, capture time, peak memory;
   (b) scripts/bench_ate_torch.py (the twin of scripts/bench_ate.py:
   bench.py's world and config with its own matcher settings, the hybrid
   update, the chunk graph) at seeds 0, 1 and 2, 1024 scans each, the
   frontend's counts set to 0 just before each run: finite trajectory,
   phase 4's launches a scan run, the three ATEs held as a set against
   the JAX package's runs of bench_ate.py on the same seeds
   (scripts/bench_ate_reference.json, made by
   scripts/bench_ate_reference.py) through held_as_set: the median at
   most JAX's median + 0.1 m, each run at most JAX's worst + 0.1 m;
5. the first 256 scans again with every kernel replaced by its plain
   version on the card: the poses must agree within 5e-3 m / 5e-3 rad;
6. FastSLAM at bench_pf.py's default config and log (100 particles, bf16
   512^2 maps at 0.1 m, 653 scans), host-gated (run_fastslam's
   host_gated=True, as in phases 8 and 10; phase 23 runs the
   device-gated graph that host_gated=None picks at 100 and 16
   particles): finite trajectory and N_eff, ATE at
   most 1 m, at least one resample, every PF kernel launched as often as
   the gates decided (ISM update once per update event, field and stack
   once per refine event, row gather once per resample); scans/s, ATE
   against odometry's, host reads per scan;
7. the first 8 refine events of that run, each from the same state with
   the same draws through the kernels and through their plain versions:
   poses, log-weights and maps must agree within the stated tolerances;
8. FastSLAM-1000 (`bench_pf.py --particles 1000`: the shared update,
   kernel 8, and the shared refine) over the same log: the phase 6 checks,
   with the apply and the image build (one ISM launch) once per update
   event; scans/s, seconds, peak device memory;
9. its first 4 update events after the bootstrap, kernel step against
   plain step from the same state and draws (phase 7's tolerances);
10. FastSLAM-16 (`bench_pf.py --particles 16`: the per-particle refine,
   kernel 5) over the same log: the phase 6 checks, with one field launch
   and one correlation launch per pass per refine event; the same run
   again with every correlation call held to its plain version (and the
   calls whose best candidate differs counted), and once more with the
   plain version in its place, each run's ATE at most 1 m; then kernel
   step against plain step at its first 8 refine events;
11. the frontend with update_impl="pallas_ray" (kernel 1 "ray" in place
   with its gate on the device) over bench.py's log, one ChunkGraph
   replay a chunk, then eagerly: finite trajectory, the eager run's bits,
   no host read during the scans, one ray and one search-space launch a
   scan run (+1 build) and two scorer launches, ATE at most 1 m, printed
   beside odometry's and phase 4's; then the first 256 scans with
   update_impl "pallas" (kernel 1 `ism`'s window form) and "dense"
   through the graph and eagerly: the same bits, no host read;
12. localization (run_localization) on phase 4's final map over a second
   traversal of bench.py's world (its route reversed, twice its odometry
   noise): finite trajectory, ATE below odometry's and at most phase 4's
   + 0.1 m, the map unchanged, one search-space build, no update, two
   scorer launches a scan run and no host read; scans/s; the first
   256 scans again through the plain versions (phase 5's tolerances);
   peak_uniqueness (over a 1.2 m window) at 8 matched poses through the
   kernels and through the plain versions: finite, within 2e-6;
13. the tiled frontend (run_tiled_frontend) at the CLI's tile defaults
   (512^2 tiles, 64 slots, 0.05 m) with bench.py's sensor, matcher and
   chunk over a lap of the 60 m corridor world (4,551 scans; one 544^2
   window for the match and the update), one TiledChunkGraph replay a
   chunk (gates, window origins and tile slots on the device): finite
   trajectory, ATE below odometry's, 4 to 64 active tiles; its first 1024
   scans through the graph and eagerly through the same steps: the same
   bits (trajectory, scores and both pools); one update and one
   search-space build a scan run and two
   scorer launches, one host read a chunk (the forecast's pose) and none
   a scan; scans/s, capture s, peak memory; the first 256 scans again
   through the plain versions (phase 5's tolerances); region round trips
   on the final pool through the host-origin and the device-origin ops,
   bit-exact against numpy on the stitched pool, a gated-off scatter
   leaving it bit-identical; kernels 1 `hybrid` and `ray` on the
   gathered window at its device lattice cell against the out-of-place
   kernel (the same bits);
14. relocalization on phase 4's final map: global_localize from 8 scans of
   phase 12's log drawn with the seed, each within 0.15 m and 0.1 rad of
   the pose phase 12 tracked for it on the same map (the ground truth's
   error printed beside it) with a score above 0.4
   (tests/test_global_loc.py's limits), or else an alias (a pose that
   scores at least as well as the refine from the tracked pose) or a miss
   that the JAX package makes too (on this map, by its sha256, JAX's sweep
   peaks at the same cell and heading and its refine ends within 1e-3 m
   and rad: scripts/relocalization_reference.json, made by
   scripts/relocalization_reference.py); the same coarse cell and heading
   through the plain versions and the refined pose within 1e-3 m and
   1e-3 rad, ms a call and peak memory; then
   run_localization(recover=True) over a kidnap log in bench.py's world
   (two traversals, the odometry spliced): at least one event, median
   position error after the last below 0.5 m, on the reference's map the
   same event and skipped scans as JAX's, event poses within 1e-3, scores
   within 1e-4 and ATE within 5 mm; one
   search-space build, two scorer launches a scan run and one a
   relocalization, one host read a chunk and one a relocalization;
   scans/s;
15. full SLAM (run_full_slam) at the CLI's `--mode full` defaults
   (bench.py's frontend config; 512 keyframe slots, keyframes every 1 m,
   loop radius 3 m, accept score 0.35) over two laps of bench.py's world
   (715 scans): finite trajectory, at least one accepted loop, keyframe
   ATE below odometry's at the same scans and at most the JAX package's
   + 0.1 m (scripts/fullslam_reference.json, made by
   scripts/fullslam_reference.py; keyframes and loop decisions compared
   and printed), every launch accounted for (kernel 1 `hybrid`: one a
   scan run of the frontend and the scans of the submaps and of the
   rebuilds; kernel 3: one a scan run + 1, a submap and a correction
   each; kernel 2: a match's passes a scan run and three an attempt), no
   host read of the frontend's; scans/s, keyframes,
   attempts, loops, chi2, ATEs, host reads a scan, peak memory; the first
   512 scans again through the kernels and through the plain versions:
   the same keyframes and (i, j, accepted) decisions, poses within 5e-3
   m / rad; then the same route with the noise of seeds 4 to 7, each
   with run_full_slam's checks (at least one loop, kf ATE below
   odometry's, every launch accounted for) and its keyframes and
   decisions printed beside the JAX package's run
   (scripts/fullslam_reference_seed4.json to _seed7.json); the five
   seeds 3-7 held as a set: the port's median kf ATE at most JAX's
   median over the same seeds + 0.1 m, and each run's at most the worst
   of JAX's five + 0.1 m (one run of this log is a draw: ROADMAP queue 3
   item 2);
16. full SLAM on the tiled world (run_full_slam_tiled) over
   tests/test_killian_scale.py's lap of the 60 m corridor (911 scans,
   odometry drifting to 10.7 m), at the CLI's tile defaults
   (fullslam_tiled_bench_config: 512^2 tiles at 0.05 m, bench.py's
   sensor, matcher and chunk 64, phase 15's graph settings) and at the
   test's own config (256^2 tiles at 0.1 m, chunk 32), each beside the
   JAX package's run at that config (scripts/fullslam_tiled_reference
   .json, fullslam_tiled_killian_reference.json); at the CLI's defaults
   over the lap with the noise of seeds 3 to 7 (fullslam_tiled_reference
   _seed4.json to _seed7.json), held as phase 15's set (one run of the
   lap is a draw: ROADMAP queue 3 item 5), at the test's config the one
   run held to kf ATE at most JAX's + 0.1 m; each run:
   finite trajectory, keyframe ATE below odometry's and trajectory ATE
   below odometry's / 3 where JAX's run over the log meets them (at
   seeds 5-7 the odometry drifts 2.0-2.8 m and JAX's ends above it; the
   set's run limit, the worst of JAX's five + 0.1 m, holds every run), at
   least 6 active tiles, at least one loop where JAX's run closed one
   (over the set for the set; at the test's config also the test's
   bounds: kf ATE below 2 m and odometry's / 5), every launch accounted
   for (the tracking replays a TiledChunkGraph a chunk, its kernels
   launched once a scan run and none of its reads on the host; kernel 1
   `hybrid`: a scan run, the submaps' and the rebuilds' scans; kernel 3:
   a scan run, a submap each, the rebuilds' builds; kernel 2: a match's
   passes a scan run and an attempt's three); scans/s, host reads a scan,
   peak memory; the test's config again with
   every solve, accept and rebuild synced and timed; the first 256 scans
   at the CLI's defaults, and the whole lap at the test's config (its
   loop attempts and the accept's tiled rebuild), through the kernels
   and through the plain versions: the same keyframes and decisions,
   poses within 5e-3 m / rad; phase 3 also checks kernels 1 `hybrid`, 3
   and 2 at the test's config's shapes (the 288^2 tiled window at 0.1 m,
   the 640^2 submap, the tracking pass [13, 7, 7] and the loop passes
   [41, 5, 5] over 80^2 and [5, 17, 17]);
17. full SLAM with optimizer="schur" (graph/schur.py, 4 blocks) over
   phase 15's config and log: phase 15's checks, held to the JAX
   package's Schur run (scripts/fullslam_reference_schur.json; kf ATE at
   most JAX's + 0.1 m); then optimize_schur with 2 and 4 blocks on phase
   15's final graph against the dense optimize: poses within 5e-3 m /
   rad, each solve's ms (synced, median of 5), the host's plan and
   tables timed apart from the iterations;
18. the frontend with the sampled-ray update (update_impl="sparse", the
   JAX package's CPU "auto") at bench.py's config and log, as
   run_frontend runs it on CUDA (one graph replay a chunk, the update in
   place with its gate on the device, grid/occupancy.py:raycast_window),
   twice: finite trajectory, ATE below odometry's, no host read during
   the scans, the same bits twice, kernel 3 one launch a scan run + 1 and
   kernel 2 two, kernel 1 none; scans/s; the first 256 scans through the
   plain versions (phase 5's tolerances);
19. full SLAM with the sampled-ray update and optimizer="hier" at
   fullslam_bench_config with hier_dense_max 64 over phase 15's log:
   phase 15's checks (kernel 1 launches none), the V-cycle and the PCG
   polish run by every solve (graph/sparse.py's stages printed),
   tridiag_factor launched once a polish's Gauss-Newton iteration, held
   to the JAX package's run of the same config (keyframe ATE at most
   JAX's + 0.1 m, scripts/fullslam_reference_sparse_hier.json); then the
   solvers alone: optimize_hier on tests/test_sparse_graph.py's serpentine
   graph at 4096 and 16384 nodes (error 5x below odometry's and chi2 < 1,
   the JAX test's bounds, and at most 2x the JAX package's own error,
   scripts/hier_reference.json; ms a solve, peak device memory) and
   optimize_cg on phase 15's final graph against the dense solve (1e-3);
20. the frontend with a 270-degree scanner (1081 beams, 30 m: a Hokuyo
   UTM-30LX's geometry; bench_configs.wide_fov_config) over bench.py's
   route, update_impl="auto" resolving to the sampled-ray update:
   phase 18's checks (the 30 m update window is wider than the map: the
   update and kernel 3 run on the whole map);
21. the command line (slam2d_tpu_torch.run.cli.main, in this
   process) at its defaults (1024^2 at 0.05 m, 180 beams, chunk 64) on
   `--log synth` (1264 scans), every run's scans/s printed with the
   card's name and power limit and its launches counted: (a) the
   frontend with --gt-ate --out: ATE below odometry's, the trajectory
   bit-equal to run_frontend's on the same log and config, phase 4's
   launches, the ROS pair and grid.json written; (b) localization on
   (a)'s map.yaml with --global-init --recover (the global-init pose
   within 0.15 m / 0.1 rad of the true start) and on its
   map_logodds.npy: ATE below odometry's; (c) full SLAM bounded and
   --tiled, each with --save-state: at least one loop, keyframe ATE (from
   the saved state) below odometry's; (d) FastSLAM with 100 particles
   (the ISM update), then 16 with --update-impl sparse, pallas_hybrid and
   pallas_ray (the particle forms of kernels 1 hybrid and ray), each with
   --seed 0 to 4, all in run_fastslam's device-gated strategy as JAX's
   CLI (at 100 particles every run replays the PF chunk graph a whole
   chunk, each capture launch once a scan, no host read): finite ATEs,
   their median at most JAX's CLI median over the same seeds + 0.1 m;
   and, for pallas_hybrid and pallas_ray at the CLI's FastSLAM-16
   config, its first 8 map updates after the bootstrap also made through
   the plain version on the same inputs (`ray` bit for bit, `hybrid` to
   phase 3's map tolerance); (e) the log written as .clf and .json by
   the port's
   writers: the native parser reads the .clf (its arrays equal the
   Python parser's), the frontend runs on both, the .clf run scored with
   --relations against relative poses of the ground truth; (f) a split
   run at scan 640 with --scan-range, --save-state and --resume-state,
   frontend (1e-4) and full SLAM (the same keyframes and loops, the rows
   after the cut within 1e-3), against (a) and (c); (g) the video hook:
   one frame a chunk through VideoRecorder.add.
22. multi-device (slam2d_tpu_torch/parallel/): (a) run_sharded_fastslam
   at FastSLAM-1000 over bench_pf's log on one rank over NCCL, against
   the single-device run with the same seed (5e-3 at every scan that does
   not resample: there the sharded step reports the best particle before
   the resample, as JAX's does), its scans/s, resamples, d_max histogram
   and peak memory; (b) four ranks sharing the card over gloo, the first
   512 scans: the modes as they resolve at 250 particles a rank (the
   rank's own mean heading, as JAX's), the trajectory the same on every
   rank, ATE within PF_MAX_ATE_M, at least one ring hop, the bytes staged
   a scan; the modes pinned per particle, held to the single-device run:
   the same resample scans, the same bits at every other scan (at a
   resample scan the sharded step reports the best particle before the
   resample, as JAX's does: (a)'s exception) and the ATE within
   MD_RUN_ATE_TOL_M; (c) the first 8 heavy steps after the
   bootstrap, and then the first whose resample takes a ring hop, also
   through the plain versions on the same inputs (poses 2e-4, 0.05% of
   cells); (d) run_sharded_tiled_frontend at tiled_bench_config, 1 rank
   (NCCL, 2048 scans) and 4 ranks (gloo, 1024 scans), against phase 13's
   trajectory (5e-3; the bits are printed), and 4 ranks on a pool of 16
   slots whose tiles span two ranks, held to phase 13's bits;
   (e) the three sharded solvers at 4 ranks: the edge-sharded dense and
   the Schur solve on phase 15's final graph against the dense solve
   (5e-3), optimize_cg_sharded on it against optimize_cg (1e-3) and on
   phase 19's 4096-node serpentine against optimize_cg (1e-2 m, its
   error within 1% of optimize_cg's);
   (f) the CLI's --shard at FastSLAM-100 and --mode full --optimizer
   schur_sharded, one rank a card through its spawn path; (g)
   dryrun_multichip(4) over gloo on the card (four ranks share it);
   (h) NCCL across min(4, cards) cards, or a line saying it was skipped, and what NCCL
   does with two ranks on one card. The four-rank parts run in one world
   of spawned processes; each rank's kernel launches are counted against
   its decisions.
23. FastSLAM's device-gated single program (run/fastslam_run.py:
   PFChunkGraph, one CUDA graph replay a chunk of 32 scans; the log's
   13-scan tail eagerly through the same steps): (a) at FastSLAM-100 and
   FastSLAM-16 over bench_pf's log, run_fastslam(host_gated=None) takes
   the graph (a replay a whole chunk), 0 host reads, every kernel of the
   capture launched once a step, finite trajectory and N_eff, ATE at
   most 1 m, at least one resample; scans/s beside phases 6's and 10's
   host-gated rates, capture s, peak memory; (b) the first 128 scans
   through the graph and through the same device-gated steps one by one,
   with the same draws: the same bits; (c) the whole log through the
   graph and host-gated (host_gated=True), with the same draws: the same
   bits; (d) each gated PF kernel (kernel 1 `ism` and the particle forms
   of `hybrid` and `ray`, kernels 4-8) at its path's shapes: gate 0
   leaves an in-place output bit-identical, gate 1 equals the ungated
   launch, the gate-0 launch's device time (each kernel's entry,
   `gate0_device_ms`); (e) FastSLAM-1000 with host_gated=False over its
   first 128 scans (kernel 8's gated form in the graph): scans/s, peak
   memory; (f) the frontend with score_impl "cmx" (the CLI's --score-impl
   cmx) over bench.py's first 256 scans: graph replay = eager bits, the
   correlation kernel launched twice a scan; (g) FastSLAM-16 with
   update_impl "pallas_hybrid", "pallas_ray", "sparse" and "dense" over
   the first 128 scans: graph = host-gated bits with the same draws.
24. the twins of two JAX benchmark scripts: (a)
   scripts/bench_fullslam_torch.py (config 5's throughput:
   run_full_slam_tiled at bench_configs.fullslam_script_config, 256^2
   tiles at 0.1 m, corrections up to 2.5 m, over fullslam_bench_log's two
   laps, 715 scans), for incremental_rebuild True and False: a whole warm
   run with every solve, finalize and rebuild synced and timed (their
   medians printed), the twin's timed run and JSON line (scans/s), then
   the route with the noise of seeds 3 to 7 through phase 16's checks
   (every launch accounted for, the rebuilds' scans among them) beside
   the JAX package's runs of the same config, variant and log
   (scripts/fullslam_script_reference{,_seed4.._seed7}{,_full_rebuild}
   .json), each variant's five held as phase 15's set; (b)
   scripts/bench_graph_scale_torch.py's table (the dense solve to 2048
   nodes, Schur with 8 blocks to 4096, optimize_hier to 16384, on the
   serpentine with one rung closure per ~34 nodes; each solver first
   runs on the graph with every node's x but the anchor's moved by -2,
   -1, 1 and 2 float32 ulps, which stands for the script's first,
   untimed call, then one timed call on the graph itself, where the
   script takes the mean of three), the five runs of each solver at
   each size held as a set against the JAX package's five on the CPU
   (scripts/graph_scale_reference.json; one ulp moves JAX's own dense
   and Schur errors 5-60x, its V-cycle's at 4096 nodes to NaN): a run
   solved where finite and below the error before the solve, the
   port's unsolved runs at most JAX's, the median error of its solved
   runs at most 2x the median of JAX's, its run on the graph itself
   finite where JAX's is; printed beside where no JAX run solved it.
Phase 3 also holds kernel 2 at a 1081-beam scan and kernel 3 in place on
the whole 1024^2 map (phase 20's shapes), and the block-Thomas factor
(csrc/tridiag_factor.cu, the sparse solvers' sequential recurrence; it
replaces a lax.scan, no Pallas kernel) against its plain K-step loop on
the serpentine's chain matrix at 4096 and 16384 blocks; after phase 19
the factor is held the same way at its main path's input, the chain
matrix of phase 19's final 512-slot graph, and its row's times and bound
are those of that input. And it holds the particle filter's forms of
kernels 1 `hybrid` and `ray` (one launch over every particle's update
window) against their plain loops over the particles, at their main
path's inputs, phase 21 (d)'s (float32 1024^2 maps at 0.05 m, [16,
496^2] windows), whose times and bound their rows carry, and at
FastSLAM-100's and FastSLAM-16's bench_pf shapes (bf16 512^2 maps, 256^2
windows): `ray` bit for bit, `hybrid` to phase 3's map tolerance. Kernel
7 (the shift stack) is timed beside its library form, F.unfold over the
splats padded at the low edges with its channels reversed, after that
form is held equal to the plain version (`library_ms`).

Prints one JSON line with the kernels' numbers, then as its last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
from torch.multiprocessing.spawn import ProcessException
import torch.nn.functional as F

from slam2d_tpu_torch.config import (
    GraphConfig,
    GridConfig,
    MatcherConfig,
    SensorConfig,
)
from slam2d_tpu_torch.data import native
from slam2d_tpu_torch.graph import schur, se2_graph, sparse
from slam2d_tpu_torch.grid import occupancy
from slam2d_tpu_torch.grid.tiles import (
    FREE_SLOT,
    TileTable,
    TiledGrid,
    gather_region,
    gather_region_t,
    scatter_region,
    scatter_region_t,
    stitch_tiles,
    world_to_cell_global,
)
from slam2d_tpu_torch.grid.window import (
    blur_halo_cells,
    extract_window,
    scan_window_cells,
    take_window as window_take,
    update_window_cells,
    window_origin,
    window_origin_t,
    window_origin_xy_t,
    write_window,
    write_window_blur_exact,
)
from slam2d_tpu_torch.match import correlative
from slam2d_tpu_torch.match.global_loc import (
    global_localize,
    refine_matcher,
    sweep_cell,
)
from slam2d_tpu_torch.metrics import ate_rmse
from slam2d_tpu_torch.ops import _build
from slam2d_tpu_torch.ops import field as field_ops
from slam2d_tpu_torch.ops import gather as gather_ops
from slam2d_tpu_torch.ops.apply import shared_apply
from slam2d_tpu_torch.ops.corr import corr_scores
from slam2d_tpu_torch.ops.field import window_field
from slam2d_tpu_torch.ops.gather import gather_rows
from slam2d_tpu_torch.ops.score import score_window
from slam2d_tpu_torch.ops.search_space import search_space, search_space_window
from slam2d_tpu_torch.ops.stack import shift_stack
from slam2d_tpu_torch.ops.tridiag import tridiag_factor
from slam2d_tpu_torch.ops.update import (
    ism_occ_tol,
    update_hybrid,
    update_hybrid_particles,
    update_ism,
    update_ray,
    update_ray_particles,
)
from slam2d_tpu_torch.parallel import dryrun
from slam2d_tpu_torch.parallel import mesh as pmesh
from slam2d_tpu_torch.pf import fastslam
from slam2d_tpu_torch.pf import sharded
from slam2d_tpu_torch.pf.shared_refine import endpoint_splat
from slam2d_tpu_torch.pf.shared_update import apply_operands, carve_operands
from slam2d_tpu_torch.run.bench_configs import (
    bench_config,
    bench_log,
    card,
    fullslam_bench_config,
    fullslam_bench_log,
    fullslam_script_config,
    fullslam_tiled_bench_config,
    fullslam_tiled_bench_log,
    fullslam_tiled_killian_config,
    GRAPH_ULPS,
    kidnap_log,
    localization_log,
    pf1000_bench_config,
    pf_bench_config,
    pf_bench_log,
    pf_per_particle_bench_config,
    hier_bench_graph,
    ray_bench_config,
    tiled_bench_config,
    tiled_bench_log,
    ulp_moved,
    wide_fov_config,
)
from slam2d_tpu_torch.run import fastslam_run
from slam2d_tpu_torch.run.fastslam_run import run_fastslam
from slam2d_tpu_torch.run.frontend import (
    frontend_step,
    run_frontend,
    run_localization,
)
from slam2d_tpu_torch.run.frontend_tiled import (
    _np_between,
    run_tiled_frontend,
    tiled_frontend_step,
    tiled_window_cells,
)
from slam2d_tpu_torch.run.full_slam import (
    default_loop_matcher,
    default_submap_grid,
    fetch,
    run_full_slam,
)
from slam2d_tpu_torch.run import frontend_tiled_sharded
from slam2d_tpu_torch.run.sharded_run import run_sharded_fastslam

SEED = 0
KERNEL_TIMING_RUNS = 30
PARITY_SCANS = 256
POSE_TOL_M = 5e-3
POSE_TOL_RAD = 5e-3
BENCH_ATE_REFERENCE = "scripts/bench_ate_reference.json"  # phase 4 (b):
                          # JAX's scripts/bench_ate.py on the CPU, seeds 0-2
BENCH_ATE_SEEDS = (0, 1, 2)
SLICE_ATE_REFERENCE_M = 0.16099  # phase 4's ATE with the gates read on the
                                 # host, printed beside
PF_MAX_ATE_M = 1.0        # phase 6: above this the filter diverged
LOC_ATE_SLACK_M = 0.1     # phase 12: the map carries phase 4's own error
PEAK_SCANS = 8            # phase 12: peak_uniqueness held at 8 scans
PEAK_TOL = 2e-6           # phase 12: the coarse scores' tolerance
PEAK_SEARCH_XY = 1.2      # phase 12: a loop-closure window for the margin
                          # (at bench.py's 0.3 m every offset lies within
                          # the 0.5 m exclusion and the margin is +inf)
GLOBAL_SCANS = 8          # phase 14: global_localize at 8 drawn scans
GLOBAL_ERR_M = 0.15       # phase 14: tests/test_global_loc.py's limits
GLOBAL_ERR_RAD = 0.1
GLOBAL_MIN_SCORE = 0.4
RELOC_REFERENCE = "scripts/relocalization_reference.json"  # phase 14: the
                          # JAX package's relocalization on phase 4's map
                          # (scripts/relocalization_reference.py)
GLOBAL_PROFILE_CALLS = 3  # phase 14: calls traced for the device time
RECOVER_TAIL_M = 0.5      # phase 14: median error after the last event
PF_PARITY_REFINES = 8     # phase 7
PF_POSE_TOL = 2e-4        # phase 7, m and rad
PF_LOGW_TOL = 3e-3        # phase 7: 30 x score 5e-5 on two particles
MAP_CELL_SHARE = 0.0005   # cells an update may flip (one l_free / l_occ)
BF16_STEP_ATOL = 0.07     # a flipped bf16 cell: the step +- one bf16 ulp
PF1000_PARITY_UPDATES = 4  # phase 9
FULLSLAM_POSE_TOL = 5e-3   # phase 15: kernel run against plain run, m, rad
FULLSLAM_PARITY_SCANS = 512  # phase 15: the plain run's scans (8 chunks)
FULLSLAM_REFERENCE = "scripts/fullslam_reference.json"  # phase 15: JAX's
# run at the same config and log (scripts/fullslam_reference.py)
FULLSLAM_JAX_ATE_SLACK_M = 0.1  # phase 15: kf ATE at most JAX's + this
FULLSLAM_EXTRA_SEEDS = (4, 5, 6, 7)  # phases 15, 16: the logs' other
                                     # seeds, held with seed 3 as a set
FULLSLAM_TILED_REFERENCE = "scripts/fullslam_tiled_reference.json"  # 16
FULLSLAM_TILED_KILLIAN_REFERENCE = (
    "scripts/fullslam_tiled_killian_reference.json")                 # 16
FULLSLAM_SCHUR_REFERENCE = "scripts/fullslam_reference_schur.json"  # 17
FULLSLAM_SPARSE_HIER_REFERENCE = "scripts/fullslam_reference_sparse_hier.json"
PHASE19_HIER_DENSE_MAX = 64  # phase 19: below the 512 slots, so every solve
                             # runs the V-cycle (the JAX reference's too)
HIER_REFERENCE = "scripts/hier_reference.json"  # phase 19: JAX's
                             # optimize_hier on the serpentine
HIER_ODOM_FACTOR = 5.0       # its bound: error 5x below odometry's
HIER_ERR_JAX_FACTOR = 2.0    # phase 19: error at most 2x JAX's
CG_DENSE_TOL = 1e-3          # phase 19: optimize_cg against the dense solve
TRIDIAG_SIZES = (4096, 16384)  # phase 19's solver sizes
TRIDIAG_RTOL = 1e-6          # tridiag_factor against its plain version, x
                             # max |Cinv| (the same operations; a 3-term sum
                             # may add in another order)
FULLSLAM_COUNTS = ("attempts", "submaps", "submap_scans", "rebuilt_scans",
                   "corrections")
GRAPH_SCALE_REFERENCE = "scripts/graph_scale_reference.json"  # phase 24
                             # (b): JAX's solver table on the CPU
SOLVER_TABLE_REPS = 1        # phase 24 (b): timed calls after the first
CORR_RTOL = 1e-5          # kernel 5: |err| <= this x sum|E| x max|Sp|
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): the
# least time of a call is the larger of bytes / HBM rate and operations /
# float32 rate (no kernel here runs on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_BYTES = 50e6
DEVICE_TIMING_CALLS = 50  # back-to-back calls between two events
HOST_BOUND_SHARE = 0.8    # enqueue time above this share of the quotient:
                          # the host sets the pace, take the profiler's time
EDGE_SPINS = 16           # spin kernels launched on each side of a trace's
EDGE_SPIN_CYCLES = 250_000  # calls (_device_events), ~0.13 ms each
EDGE_TRACES = 5           # traces taken for one that kept both edges


def _cuda_ms(fn, runs: int = KERNEL_TIMING_RUNS, warmup: int = 3) -> float:
    """Median milliseconds of one call of `fn`, timed alone with CUDA events
    (the host's enqueue time sits inside the events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _cuda_device_ms(fn, n: int = DEVICE_TIMING_CALLS, runs: int = 5,
                    profiler: bool = False):
    """(milliseconds of device time of one call of `fn`, how it was taken).

    "events": one CUDA event, `n` calls back to back, one event, the
    elapsed time over `n`; median of `runs` such runs. Where the host
    enqueues the calls more slowly than the device runs them that quotient
    is the host's time, so there the device time is the sum of the
    durations of the device activities of `n` calls in a torch.profiler
    trace, over `n`: "profiler" (`profiler=True`: taken so in any case, to
    stand beside another number taken so)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    quotients, enqueue = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        enqueue.append((time.perf_counter() - t0) * 1e3 / n)
        end.synchronize()
        quotients.append(start.elapsed_time(end) / n)
    quotient = statistics.median(quotients)
    if not profiler and statistics.median(enqueue) < HOST_BOUND_SHARE * quotient:
        return quotient, "events"
    device_us = sum(
        e.time_range.end - e.time_range.start for e in _device_events(fn, n)
    )
    return device_us / n / 1e3, "profiler"


def _device_events(fn, n: int) -> list:
    """The device activities of `n` calls of `fn` in a torch.profiler trace,
    without the profiler's own "ProfilerStep*" records. A trace can lose a
    run of device records at either edge, of no set length (seen: the
    first of 20 calls in three traces of one run; up to all 16 spins of
    ~10 us, and 15 of ~0.13 ms, at one edge). So `EDGE_SPINS` spin
    kernels (torch.cuda._sleep) are launched before the calls and after
    them, and their records are dropped: a trace that kept a spin on each
    side kept every record of the calls between them. A trace that lost
    every spin of an edge, or came back without device records (seen once
    in some ten runs of this script), is taken again, at most
    `EDGE_TRACES` times; then the last trace with records is used."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    last = None
    for _ in range(EDGE_TRACES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(EDGE_SPINS):
                torch.cuda._sleep(EDGE_SPIN_CYCLES)
            for _ in range(n):
                fn()
            for _ in range(EDGE_SPINS):
                torch.cuda._sleep(EDGE_SPIN_CYCLES)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
        spins = [e for e in events if "spin_kernel" in e.name]
        events = [e for e in events if "spin_kernel" not in e.name]
        if not events:
            continue
        last = events
        if len(spins) == 2 * EDGE_SPINS:
            return events
        first = min(e.time_range.start for e in events)
        before = sum(e.time_range.start < first for e in spins)
        after = len(spins) - before
        print(f"trace edges: {before} of {EDGE_SPINS} spin kernels recorded "
              f"before the calls, {after} of {EDGE_SPINS} after")
        if before and after:
            return events
    if last is None:
        raise AssertionError("torch.profiler recorded no device activity")
    print(f"trace edges: no trace of {EDGE_TRACES} kept a spin on each side; "
          "the last is used")
    return last


def _bound(n_bytes: float, n_ops: float) -> dict:
    """bound_ms, bound_by: the larger of the bytes at the HBM rate and the
    operations at the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return dict(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=n_bytes, operations=n_ops,
    )


def _times(kernel, plain, bound: dict, library=None,
           plain_runs: int = KERNEL_TIMING_RUNS) -> dict:
    """The timing fields of one kernel's entry: `ms`, `plain_ms` and
    `library_ms` of lone calls (_cuda_ms; the plain version's median of
    `plain_runs`), `device_ms` of back-to-back calls (_cuda_device_ms)
    with how it was taken, its share of the bound, and whether the
    operands fit the L2 cache (then the back-to-back calls found them
    there: the number is no cold-cache time)."""
    device_ms, by = _cuda_device_ms(kernel)
    out = dict(
        ms=_cuda_ms(kernel),
        plain_ms=_cuda_ms(plain, runs=plain_runs,
                          warmup=3 if plain_runs >= KERNEL_TIMING_RUNS else 1),
        library_ms=None if library is None else _cuda_ms(library),
        device_ms=device_ms, device_by=by,
        bound_share=bound["bound_ms"] / device_ms,
        operands_fit_l2=bound["bytes"] <= L2_BYTES, **bound,
    )
    if library is not None:
        out["library_device_ms"], out["library_device_by"] = _cuda_device_ms(
            library, profiler=by == "profiler"
        )
    return out


def launch_floor(device):
    """(ms, how taken): an empty kernel of the port's library timed as the
    kernels are (_cuda_device_ms), the floor under any launch; the bounds
    of the frontend's kernels lie under it."""
    lib = _build.load_library()
    stream = _build.stream_handle(device)

    def empty():
        _build.check(lib.slam2d_empty_launch(stream), "slam2d_empty_launch")

    return _cuda_device_ms(empty)


def _hybrid_cells_ok(a, b, g, name):
    """Phase 3's tolerance of kernel 1 "hybrid" against its plain version:
    at most 0.05% of the cells differ, each by one l_free or l_occ (its
    atan2f, sinf and cosf against PyTorch's). Returns (cells differing,
    max |err|)."""
    diff = (a - b).abs()
    n_diff = int((diff != 0).sum())
    off = diff[diff != 0]
    one_step = ((off - abs(g.l_free)).abs() < 1e-5) | (
        (off - g.l_occ).abs() < 1e-5
    )
    print(f"{name}: {n_diff} of {a.numel()} cells differ (tolerance: "
          "<= 0.05%, each by one l_free or l_occ)")
    if n_diff > 0.0005 * a.numel() or not bool(one_step.all()):
        raise AssertionError(f"{name}: disagrees with its plain version")
    return n_diff, float(diff.max())


def corr_tolerance(E, Sp):
    """[P, T, 1]: the largest |err| kernel 5 may have against its plain
    version on E [P, T, H, W], Sp [P, H+R, W+R], per (p, t): CORR_RTOL x
    sum|E| x max|Sp| (float32 summation-order rounding), plus 1e-6."""
    scale = E.float().abs().sum(dim=(-2, -1)) * Sp.abs().amax(dim=(-2, -1))[:, None]
    return CORR_RTOL * scale[..., None] + 1e-6


def _corr_check(E, Sp, R, name):
    """Kernel 5 against its plain version on E [P, T, H, W], Sp [P, H+R,
    W+R], within corr_tolerance; a second call must give the same bits.
    Returns (max |err|, kernel out)."""
    out = corr_scores(E, Sp, R, R)
    ref = corr_scores(E, Sp, R, R, plain=True)
    err = (out - ref).abs()
    ok = bool((err <= corr_tolerance(E, Sp)).all())
    same = torch.equal(out, corr_scores(E, Sp, R, R))
    print(f"corr_scores {name} {list(E.shape)} R={R}: max |err| "
          f"{float(err.max()):.3g} (tolerance {CORR_RTOL} x sum|E| x max|Sp|),"
          f" same bits twice {same}")
    if not ok:
        raise AssertionError(f"corr_scores {name} disagrees with its plain version")
    if not same:
        raise AssertionError(f"corr_scores {name} is not deterministic")
    return float(err.max()), out


def _conv_corr(E, Sp, R):
    """The same lag correlation as one grouped torch.nn.functional.conv2d
    (TF32 off): the library call kernel 5 is timed against."""
    P, T, H, W = E.shape
    return F.conv2d(
        Sp[None, :, : H + R - 1, : W + R - 1], E.reshape(P * T, 1, H, W),
        groups=P,
    ).reshape(P, T, R * R)


# kernel 5's edge operands (corr_edge_operands): H, W, R and whether E's
# base sits one element past a 16-byte boundary
CORR_EDGE_CASES = {
    "vector": (29, 40, 1, False),      # whole 16-byte units a row
    "straddle": (30, 36, 3, False),    # bf16 units across row ends
    "odd_width": (37, 33, 5, False),   # H * W odd: the scalar form
    "misaligned": (29, 40, 7, True),   # the scalar form
    "tall": (40, 24, 9, False),
    "narrow": (32, 5, 11, False),      # a unit spans several rows
}


def corr_edge_operands(case: str, dtype: str) -> dict:
    """Numpy operands of kernel 5 (corr_scores) at the edges of its design,
    E [2, 3, H, W] and Sp [2, H+R, W+R] for CORR_EDGE_CASES[case] (every
    R of ops/corr.py's _SIZES among the cases): E sparse (5% of its cells
    nonzero, of either sign) with nonzeros on every cell of its first and
    last rows and columns, one image dense (a nonzero in every 16-byte
    unit, across every boundary between blocks), one all zero; E's values
    rounded to `dtype` ("bfloat16" or "float32"); Sp drawn from [-0.6, 1]
    over all of it. `misaligned`: the card check reads E from a base one
    element past a 16-byte boundary (_misaligned). Used here
    (corr_edge_check) and by the CPU tests (tests/test_torch_corr.py)."""
    H, W, R, misaligned = CORR_EDGE_CASES[case]
    rng = np.random.default_rng(100 * len(case) + R)
    P, T = 2, 3
    E = rng.uniform(-1.0, 1.0, (P, T, H, W)).astype(np.float32)
    E[rng.uniform(size=E.shape) > 0.05] = 0.0
    edge = rng.uniform(0.1, 1.0, (4, P, T, max(H, W))).astype(np.float32)
    E[:, :, 0, :], E[:, :, -1, :] = edge[0, ..., :W], edge[1, ..., :W]
    E[:, :, :, 0], E[:, :, :, -1] = edge[2, ..., :H], edge[3, ..., :H]
    E[0, 0] = rng.uniform(0.1, 1.0, (H, W))
    E[1, 2] = 0.0
    if dtype == "bfloat16":
        E = torch.from_numpy(E).to(torch.bfloat16).float().numpy()
    Sp = rng.uniform(-0.6, 1.0, (P, H + R, W + R)).astype(np.float32)
    return dict(E=E, Sp=Sp, R=R, misaligned=misaligned)


def corr_bound(E, Sp, R: int) -> dict:
    """Kernel 5's bound on E [P, T, H, W], Sp [P, H+R, W+R]: E read whole
    (the kernel streams every cell to find the nonzero ones), the distinct
    cells of Sp under the R x R lags of the nonzero E cells of any theta of
    their particle (Sp[p, h + dr, w + dc] for dr, dc < R) read once, the
    scores written once; a multiply-add per nonzero E cell and lag."""
    P, T, H, W = E.shape
    nonzero = E != 0
    any_theta = nonzero.any(dim=1)
    need = torch.zeros((P, H + R, W + R), dtype=torch.bool, device=E.device)
    for dr in range(R):
        for dc in range(R):
            need[:, dr:dr + H, dc:dc + W] |= any_theta
    cells = int(need.sum())
    return _bound(E.numel() * E.element_size() + 4 * cells + 4 * P * T * R * R,
                  2 * int(nonzero.sum()) * R * R)


def corr_edge_check(device) -> list:
    """Phase 3, kernel 5 on every case of corr_edge_operands in both E
    dtypes: within corr_tolerance of its plain version, the same bits
    twice. Returns the cases checked."""
    checked = []
    for case in CORR_EDGE_CASES:
        for dtype in ("bfloat16", "float32"):
            op = corr_edge_operands(case, dtype)
            E = torch.as_tensor(op["E"], device=device).to(getattr(torch, dtype))
            if op["misaligned"]:
                E = _misaligned(E)
            Sp = torch.as_tensor(op["Sp"], device=device)
            _corr_check(E, Sp, op["R"], f"edge operands {case} {dtype}")
            checked.append(f"{case} {dtype}")
    return checked


# kernel 1 hybrid's edge operands (hybrid_edge_operands): the sensor's
# cell (row, col) on a 160^2 map, which clamps its 123 x 131 window into
# each corner of the map; the window's sides are multiples of neither the
# kernel's 8-row nor its 64-column tiles, so its last tiles are partial
HYBRID_EDGE_WINDOW = (123, 131)
HYBRID_EDGE_CORNERS = {
    "low_left": (3, 5), "low_right": (6, 110),
    "high_left": (120, 2), "high_right": (110, 125),
}


def hybrid_edge_operands(corner: str) -> dict:
    """Operands of the hybrid update (kernel 1 hybrid) at the edges of its
    design: a HYBRID_EDGE_WINDOW window (float32, drawn from [-10.5,
    10.5]) of a 160^2 map at 0.125 m clamped into
    HYBRID_EDGE_CORNERS[corner], the sensor on a cell corner and 180
    beams at 12 m whose ranges are NaN, +-inf, at and below min_range,
    just above it, at and beyond max_range (no hit), or reach past the
    window; six neighbouring beams at 0.26 m (endpoint
    counts of 2 or more); beam 90 along +x exactly (its angle plus the
    heading is 0), so that its endpoint falls exactly on a cell corner
    (the resolution is a power of two: every step is exact). Returns the
    port's GridConfig and SensorConfig, `grid` [123, 131], `pose` [3],
    `ranges` [180] (numpy float32) and the window's `origin_rc`. Used here
    (hybrid_edge_check) and by the CPU tests
    (tests/test_torch_update.py)."""
    sensor = SensorConfig(n_beams=180, max_range=12.0)
    cfg = GridConfig(height=160, width=160, resolution=0.125, center_x=8.0,
                     center_y=8.0, update_impl="pallas_hybrid")
    (win_h, win_w), res = HYBRID_EDGE_WINDOW, cfg.resolution
    row, col = HYBRID_EDGE_CORNERS[corner]
    rng = np.random.default_rng(row * 1000 + col)
    angles = np.asarray(sensor.beam_angles(), np.float32)
    pose = np.array([cfg.origin_x + col * res, cfg.origin_y + row * res,
                     -angles[90]], np.float32)
    origin_rc = (min(max(row - win_h // 2, 0), cfg.height - win_h),
                 min(max(col - win_w // 2, 0), cfg.width - win_w))
    B = sensor.n_beams
    ranges = rng.uniform(0.3, 11.0, B).astype(np.float32)
    ranges[3::29] = np.nan
    ranges[5::31] = np.inf
    ranges[8::37] = -np.inf
    ranges[9::41] = sensor.max_range            # valid, no hit
    ranges[17::43] = 1.5 * sensor.max_range     # beyond it: no hit
    ranges[11::47] = sensor.min_range           # invalid
    ranges[13::53] = 0.5 * sensor.min_range     # invalid
    ranges[15::59] = np.nextafter(np.float32(sensor.min_range), np.float32(1))
    ranges[40:46] = 0.26                        # one endpoint cell
    ranges[90] = 1.5 + 0.25 * (row % 4)         # on a cell corner
    grid = rng.uniform(-10.5, 10.5, (win_h, win_w)).astype(np.float32)
    return dict(cfg=cfg, sensor=sensor, grid=grid, pose=pose, ranges=ranges,
                origin_rc=origin_rc)


def hybrid_edge_check(device) -> list:
    """Phase 3, kernel 1 hybrid on every corner of hybrid_edge_operands:
    phase 3's tolerance against its plain version. Returns the corners
    checked."""
    checked = []
    for corner in HYBRID_EDGE_CORNERS:
        op = hybrid_edge_operands(corner)
        grid, pose, ranges = (torch.as_tensor(op[k], device=device)
                              for k in ("grid", "pose", "ranges"))
        a, b = (occupancy.integrate_scan(
            grid, pose, ranges, op["cfg"], op["sensor"],
            origin_rc=op["origin_rc"], plain=plain) for plain in (False, True))
        _hybrid_cells_ok(a, b, op["cfg"], f"update_hybrid edge operands {corner}")
        checked.append(corner)
    return checked


def kernel_checks(cfg, log, device):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    rng = np.random.default_rng(SEED)
    g, m, s = cfg.grid, cfg.matcher, cfg.sensor
    uwin = update_window_cells(g, s, m)
    win = scan_window_cells(g, s, m)
    i = len(log["odom"]) // 2
    pose_np = np.asarray(log["gt_poses"][i], np.float32)
    pose = torch.as_tensor(pose_np, device=device)
    ranges = torch.as_tensor(log["ranges"][i], device=device)
    full = torch.as_tensor(
        rng.uniform(-6.0, 6.0, (g.height, g.width)).astype(np.float32),
        device=device,
    )
    center = occupancy.world_to_cell(pose[:2], g).tolist()
    results = {}

    # kernel 1: hybrid update of the 520^2 update window
    gw, origin_rc = extract_window(full, center, uwin)

    def update(plain):
        return occupancy.integrate_scan(
            gw, pose, ranges, g, s, origin_rc=origin_rc, plain=plain
        )

    a, b = update(False), update(True)
    n_diff, max_err = _hybrid_cells_ok(a, b, g, f"update_hybrid [{uwin}x{uwin}]")
    # one thread a cell, integer endpoint counts: same bits every call
    same = torch.equal(a, update(False))
    print(f"update_hybrid same bits twice {same}")
    if not same:
        raise AssertionError("update_hybrid is not deterministic")
    results["update_hybrid"] = dict(
        max_abs_err=max_err, cells_differing=n_diff,
        tolerance="<=0.05% of cells, each by one l_free or l_occ",
        same_bits_twice=same, shape=[uwin, uwin],
        edge_operands_checked=hybrid_edge_check(device),
        # the window read and written once, the scan; ~30 operations a cell
        **_times(lambda: update(False), lambda: update(True), _bound(
            2 * gw.numel() * 4 + 8 * ranges.numel() + 12, 30 * gw.numel())),
    )

    # kernel 1 on the tiled frontend's one window (match and update), 544^2
    tcfg = tiled_bench_config()[1]
    twin = tiled_window_cells(tcfg, s, m)
    tw, t_origin = extract_window(full, center, twin)

    def update_t(plain):
        return occupancy.integrate_scan(
            tw, pose, ranges, g, s, origin_rc=t_origin, plain=plain
        )

    n_diff_t, err_t = _hybrid_cells_ok(update_t(False), update_t(True), g,
                                       f"update_hybrid [{twin}x{twin}]")
    results["update_hybrid"]["at_tiled_window"] = dict(
        shape=[twin, twin], max_abs_err=err_t, cells_differing=n_diff_t,
        **_times(lambda: update_t(False), lambda: update_t(True), _bound(
            2 * tw.numel() * 4 + 8 * ranges.numel() + 12, 30 * tw.numel())),
    )

    # kernel 3: search-space build of the update window, of the tiled
    # window and of the full map
    def field(x, plain):
        return correlative.build_search_space(x, m, g.resolution, plain=plain)

    errs, same = {}, {}
    for name, x in (("window", gw), ("tiled", tw), ("full", full)):
        out = field(x, False)
        errs[name] = _search_space_cells_ok(
            out, field(x, True), f"search_space [{x.shape[0]}x{x.shape[1]}]")
        # one thread a cell, a fixed sum order: the same bits every call
        same[name] = torch.equal(out, field(x, False))
    print(f"search_space same bits twice {same}")
    if not all(same.values()):
        raise AssertionError(f"search_space is not deterministic: {same}")
    per_call = _device_activities(lambda: field(gw, False),
                                  "search_space_kernel")
    print(f"search_space device activities a call: {per_call}")
    n_taps = 2 * blur_halo_cells(m, g.resolution) + 1

    def field_bound(x):
        # read and write the map once; two blur passes and ~8 more
        # operations a cell
        return _bound(2 * x.numel() * 4, x.numel() * (4 * n_taps + 8))

    results["search_space"] = dict(
        max_abs_err=max(e for e, _ in errs.values()),
        cells_differing=sum(c for _, c in errs.values()),
        tolerance="atol 1e-6", same_bits_twice=all(same.values()),
        shape=[uwin, uwin], device_kernels_per_call=sum(per_call.values()),
        edge_operands_checked=search_space_edge_check(device),
        full_map=dict(
            shape=list(full.shape), max_abs_err=errs["full"][0],
            **_times(lambda: field(full, False), lambda: field(full, True),
                     field_bound(full)),
        ),
        at_tiled_window=dict(
            shape=list(tw.shape), max_abs_err=errs["tiled"][0],
            **_times(lambda: field(tw, False), lambda: field(tw, True),
                     field_bound(tw)),
        ),
        **_times(lambda: field(gw, False), lambda: field(gw, True),
                 field_bound(gw)),
    )

    # kernel 2: coarse [13, 5, 5] on the 136^2 pooled window, fine
    # [5, 9, 9] bilinear on the 544^2 scan window
    S = field(full, False)
    Sw, org = extract_window(S, center, win)
    origin = occupancy.window_origin_xy(g, org)
    Sc = correlative.coarse_space(Sw, m.coarse_factor)
    pts, valid = occupancy.scan_endpoints_local(ranges, s)
    prior = pose + torch.as_tensor(
        rng.uniform(-0.1, 0.1, 3).astype(np.float32), device=device
    )
    dth = torch.as_tensor(correlative._theta_offsets(m), device=device)
    r_fine = int(round(m.search_xy / g.resolution))
    r_coarse = -(-r_fine // m.coarse_factor)
    pos_c = correlative.endpoint_positions(
        prior, pts, valid, dth, g.resolution * m.coarse_factor, origin)
    pos_f = correlative.endpoint_positions(
        prior, pts, valid, dth[4:9], g.resolution, origin)
    passes = {
        "coarse": lambda plain: score_window(
            Sc, *pos_c, valid, r_coarse, False, plain=plain),
        "fine": lambda plain: score_window(
            Sw, *pos_f, valid, m.coarse_factor, True, plain=plain),
    }
    errs, same = {}, {}
    for name, fn in passes.items():
        out = fn(False)
        errs[name] = float((out - fn(True)).abs().max())
        # the slices' partial sums are added in a fixed order: same bits
        same[name] = torch.equal(out, fn(False))
        print(f"score_offsets {name} {list(out.shape)}: max |err| "
              f"{errs[name]:.3g} (tolerance 1e-5), same bits twice "
              f"{same[name]}")
    if max(errs.values()) > 1e-5:
        raise AssertionError("score_offsets disagrees with its plain version")
    if not all(same.values()):
        raise AssertionError(f"score_offsets is not deterministic: {same}")

    n_f, n_c = 2 * m.coarse_factor + 1, 2 * r_coarse + 1
    results["score_offsets"] = dict(
        max_abs_err=max(errs.values()), tolerance="atol 1e-5",
        same_bits_twice=all(same.values()), shape=[5, 9, 9],
        # the coarse pass, [13, 5, 5] rounded taps on the pooled window
        coarse=dict(
            max_abs_err=errs["coarse"], shape=[pos_c[0].shape[0], n_c, n_c],
            **_times(lambda: passes["coarse"](False),
                     lambda: passes["coarse"](True),
                     score_bound(Sc, pos_c, valid, n_c, False)),
        ),
        # the fine pass, [5, 9, 9] bilinear taps on the scan window
        **_times(lambda: passes["fine"](False), lambda: passes["fine"](True),
                 score_bound(Sw, pos_f, valid, n_f, True)),
    )

    # kernel 5 on the two passes of bench.py's matcher, as a config that
    # pins score_impl="cmx" would run them
    corr = {}
    for name, S_, pos, R, bil in (("coarse", Sc, pos_c, n_c, False),
                                  ("fine", Sw, pos_f, n_f, True)):
        sp = correlative.splat_inputs(S_.shape, *pos, valid, R, R, bil)
        E = correlative.splat_image(*sp, S_.shape, torch.bfloat16)[None]
        Sp = F.pad(S_, (0, R, 0, R))[None].contiguous()
        err, _ = _corr_check(E, Sp, R, f"bench.py {name} pass")
        corr[name] = dict(
            max_abs_err=err, shape=list(E.shape), R=R,
            ms=_cuda_ms(lambda: corr_scores(E, Sp, R, R)),
            plain_ms=_cuda_ms(lambda: corr_scores(E, Sp, R, R, plain=True)),
        )
    results["corr_frontend"] = corr
    return results


# the frontend step's window centers (row, col) on bench.py's 1024^2 map:
# its update window clamped into each corner, and inside (the log's scan)
GATED_CENTERS = {
    "top_left": (37, 21), "top_right": (12, 1003), "bottom_left": (1019, 40),
    "bottom_right": (990, 1010),
}


def gated_checks(cfg, log, device):
    """Phase 3, the frontend step's forms of kernels 1 `hybrid`, 3 and 2,
    which read their gate and window origin from device memory: kernel 1
    in place on the 520^2 update window and kernel 3 on its kept
    rectangle, at origins clamped into each corner of the 1024^2 map and
    inside it (the log's middle scan), each with gate 1 against its plain
    version and against the host-origin path (extract_window, the
    out-of-place kernel, write_window / write_window_blur_exact): 0 cells
    off; with gate 0 the map and S bit-identical; kernel 2's fine pass
    with gate 0 leaves `out` as it was and with gate 1 gives the ungated
    bits. Each form timed as phase 3 times the kernels (gate 1), and its
    gate-0 launch's device time beside it. Returns the three entries."""
    rng = np.random.default_rng(SEED + 11)
    g, m, s = cfg.grid, cfg.matcher, cfg.sensor
    H, W = g.height, g.width
    uwin, win = update_window_cells(g, s, m), scan_window_cells(g, s, m)
    halo = blur_halo_cells(m, g.resolution)
    taps = correlative.gaussian_kernel_1d(m.sigma_m / g.resolution, halo)
    fkw = dict(occ_sat=m.occ_evidence_sat, free_threshold=m.free_threshold,
               free_penalty=m.free_penalty)
    i = len(log["odom"]) // 2
    scan_pose = np.asarray(log["gt_poses"][i], np.float32)
    ranges = torch.as_tensor(log["ranges"][i], device=device)
    full = torch.as_tensor(
        rng.uniform(-6.0, 6.0, (H, W)).astype(np.float32), device=device)
    S_full = search_space(full, taps, **fkw)
    on, off = (torch.tensor(v, device=device) for v in (True, False))
    res = np.float32(g.resolution)
    centers = dict(GATED_CENTERS)
    centers["interior"] = tuple(int(v) for v in occupancy.world_to_cell(
        torch.as_tensor(scan_pose[:2]), g).tolist())
    checked, off_plain = [], {"update_hybrid": 0, "search_space": 0}
    max_err = {"update_hybrid": 0.0, "search_space": 0.0}
    for name, (row, col) in centers.items():
        pose = torch.tensor(
            [np.float32(g.origin_x) + (np.float32(col) + np.float32(0.5)) * res,
             np.float32(g.origin_y) + (np.float32(row) + np.float32(0.5)) * res,
             scan_pose[2]], dtype=torch.float32, device=device)
        center = occupancy.world_to_cell(pose[:2], g)
        origin = window_origin_t(center, uwin, H, W)
        orc = tuple(origin.tolist())
        if orc != window_origin(center.tolist(), uwin, H, W):
            raise AssertionError(f"{name}: device origin {orc}")
        for gate in (on, off):
            a, b = full.clone(), full.clone()
            for plain, m_ in ((False, a), (True, b)):
                occupancy.integrate_scan_window(
                    m_, pose, ranges, g, s, origin=origin, size=(uwin, uwin),
                    gate=gate, plain=plain)
            # both fields from the kernel's map
            Sa, Sb = S_full.clone(), S_full.clone()
            for plain, S_ in ((False, Sa), (True, Sb)):
                search_space_window(a, S_, taps, origin=origin,
                                    size=(uwin, uwin), margin=halo,
                                    gate=gate, plain=plain, **fkw)
            today, S_today = full.clone(), S_full.clone()
            if bool(gate):
                gw, _ = extract_window(today, center.tolist(), uwin)
                write_window(today, occupancy.integrate_scan(
                    gw, pose, ranges, g, s, origin_rc=orc), orc)
                Sw = search_space(extract_window(today, center.tolist(),
                                                 uwin)[0], taps, **fkw)
                write_window_blur_exact(S_today, Sw, orc, halo)
            n_map = int((a != today).sum())
            n_s = int((Sa != S_today).sum())
            off_plain["update_hybrid"] += int((a != b).sum())
            off_plain["search_space"] += int(((Sa - Sb).abs() > 1e-6).sum())
            for key, (x, y) in (("update_hybrid", (a, b)),
                                ("search_space", (Sa, Sb))):
                max_err[key] = max(max_err[key], float((x - y).abs().max()))
            print(f"gated {name} origin {orc} gate {int(gate)}: "
                  f"update_hybrid {n_map} cells off the host-origin path, "
                  f"{int((a != b).sum())} off plain; search_space {n_s} off "
                  f"the host-origin path, {int((Sa != Sb).sum())} off plain")
            if n_map or n_s:
                raise AssertionError(f"gated {name}: the in-place forms "
                                     "part from the host-origin path")
            if not bool(gate) and not (torch.equal(a, full)
                                       and torch.equal(Sa, S_full)):
                raise AssertionError(f"gated {name}: gate 0 changed a map")
            _hybrid_cells_ok(a, b, g, f"update_hybrid in place {name}")
            _search_space_cells_ok(Sa, Sb, f"search_space kept {name}")
        checked.append(name)

    # timings at the interior origin (the log's scan)
    pose = torch.as_tensor(scan_pose, device=device)
    origin = window_origin_t(occupancy.world_to_cell(pose[:2], g), uwin, H, W)
    buf, S_buf = full.clone(), S_full.clone()

    def upd(gate, plain=False):
        return occupancy.integrate_scan_window(
            buf, pose, ranges, g, s, origin=origin, size=(uwin, uwin),
            gate=gate, plain=plain)

    def field(gate, plain=False):
        return search_space_window(buf, S_buf, taps, origin=origin,
                                   size=(uwin, uwin), margin=halo, gate=gate,
                                   plain=plain, **fkw)

    n_cells = uwin * uwin
    hybrid = dict(
        shape=[uwin, uwin], in_place_of=[H, W], origins_checked=checked,
        cells_off_host_origin_path=0,
        cells_off_plain=off_plain["update_hybrid"],
        max_abs_err=max_err["update_hybrid"],
        gate_off_device_ms=_cuda_device_ms(lambda: upd(off))[0],
        **_times(lambda: upd(on), lambda: upd(on, True),
                 _bound(2 * n_cells * 4 + 8 * ranges.numel() + 12 + 9,
                        30 * n_cells)),
    )
    kept = (uwin - 2 * halo) ** 2
    n_taps = len(taps)
    space = dict(
        shape=[uwin, uwin], in_place_of=[H, W], origins_checked=checked,
        cells_off_host_origin_path=0,
        cells_off_plain=off_plain["search_space"],
        max_abs_err=max_err["search_space"],
        gate_off_device_ms=_cuda_device_ms(lambda: field(off))[0],
        # the window read once, the kept cells written once
        **_times(lambda: field(on), lambda: field(on, True),
                 _bound(n_cells * 4 + kept * 4 + 9,
                        kept * (4 * n_taps + 8))),
    )

    # kernel 2: the fine pass over the 544^2 match window, gated
    Sw = window_take(S_full, window_origin_t(
        occupancy.world_to_cell(pose[:2], g), win, H, W), (win, win))
    org = window_origin_xy_t(g.origin_x, g.origin_y, g.resolution,
                             window_origin_t(occupancy.world_to_cell(
                                 pose[:2], g), win, H, W))
    pts, valid = occupancy.scan_endpoints_local(ranges, s)
    dth = torch.as_tensor(correlative._theta_offsets(m), device=device)
    pos = correlative.endpoint_positions(pose, pts, valid, dth[4:9],
                                         g.resolution, org)
    n_f = 2 * m.coarse_factor + 1
    ref = score_window(Sw, *pos, valid, m.coarse_factor, True)
    sentinel = torch.full_like(ref, 123.0)
    out = sentinel.clone()
    score_window(Sw, *pos, valid, m.coarse_factor, True, gate=off, out=out)
    kept_out = torch.equal(out, sentinel)
    score_window(Sw, *pos, valid, m.coarse_factor, True, gate=on, out=out)
    same = torch.equal(out, ref)
    print(f"score_offsets gated fine pass: gate 0 left out {kept_out}, gate 1 "
          f"the ungated bits {same}")
    if not (kept_out and same):
        raise AssertionError("score_offsets: the gated form misbehaves")

    def sc(gate, plain=False):
        return score_window(Sw, *pos, valid, m.coarse_factor, True,
                            plain=plain, gate=gate, out=out)

    score = dict(
        shape=[5, n_f, n_f], gate_off_kept_out=kept_out,
        gate_on_same_bits=same, max_abs_err=float(
            (sc(on) - score_window(Sw, *pos, valid, m.coarse_factor, True,
                                   plain=True)).abs().max()),
        gate_off_device_ms=_cuda_device_ms(lambda: sc(off))[0],
        **_times(lambda: sc(on), lambda: sc(on, True),
                 score_bound(Sw, pos, valid, n_f, True)),
    )
    # the float origin of every update window origin, on the device
    c0 = torch.arange(W - uwin + 1, dtype=torch.int32, device=device)
    got = window_origin_xy_t(g.origin_x, g.origin_y, g.resolution,
                             torch.stack([c0, c0], 1)).cpu().numpy()
    want = np.array([occupancy.window_origin_xy(g, (c, c))
                     for c in range(W - uwin + 1)], np.float32)
    if not np.array_equal(got, want):
        raise AssertionError("window_origin_xy_t differs on the card")
    return {"update_hybrid": hybrid, "search_space": space,
            "score_offsets": score}


# the top-level fields of a kernel entry that the frontend step's form
# takes over; the host-origin form's move under "out_of_place"
FORM_FIELDS = (
    "ms", "plain_ms", "library_ms", "device_ms", "device_by", "bound_share",
    "operands_fit_l2", "bound_ms", "bound_by", "bytes", "operations",
    "library_device_ms", "library_device_by", "max_abs_err", "shape",
    "cells_differing",
)


def _search_space_cells_ok(a, b, name):
    """(max |a - b|, cells differing by more than 1e-6) of a search space
    built by the kernel (a) and by its plain version (b); raises if any
    cell differs."""
    d = (a - b).abs()
    err, n_diff = float(d.max()), int((d > 1e-6).sum())
    print(f"{name}: max |err| {err:.3g}, {n_diff} cells differ "
          "(tolerance 1e-6)")
    if n_diff:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err, n_diff


SEARCH_EDGE_SHAPES = {"123x131": (123, 131), "1x517": (1, 517),
                      "520x7": (520, 7)}
SEARCH_EDGE_HALOS = (1, 4, 6, 31)   # 3, 9, 13 and 63 taps


def search_space_edge_operands(seed: int = 0) -> dict:
    """name -> dict(logodds [H, W] float32, halo, taps) for kernel 3 at the
    edges of its design: shapes that are not a multiple of any tile, and
    windows narrower than the halo (1 x 517, 520 x 7), with 3, 9, 13
    (the count compiled in) and 63 taps, a Gaussian of sigma
    halo / 3 cells, peak-normalized (correlative.gaussian_kernel_1d).
    A third of the cells hold log-odds at +-occ_evidence_sat, at twice
    it, at 0, and at logit(free_threshold) and up to 4 float32 ulps either
    side of it; the rest are uniform in [-4, 4]. The matcher's other
    settings are MatcherConfig's defaults."""
    mcfg = MatcherConfig()
    sat, thr = np.float32(mcfg.occ_evidence_sat), mcfg.free_threshold
    logit = np.float32(np.log(thr / (1.0 - thr)))
    special = [sat, -sat, 2 * sat, -2 * sat, np.float32(0.0), logit]
    up = down = logit
    for _ in range(4):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        special += [up, down]
    special = np.array(special, np.float32)
    rng = np.random.default_rng(seed)
    ops = {}
    for shape_name, shape in SEARCH_EDGE_SHAPES.items():
        for hw in SEARCH_EDGE_HALOS:
            lo = rng.uniform(-4.0, 4.0, shape).astype(np.float32)
            pick = rng.random(shape) < 1 / 3
            lo[pick] = rng.choice(special, int(pick.sum()))
            ops[f"{shape_name} {2 * hw + 1} taps"] = dict(
                logodds=lo, halo=hw,
                taps=correlative.gaussian_kernel_1d(hw / 3, hw),
            )
    return ops


def search_space_edge_check(device) -> list:
    """Phase 3, kernel 3 on search_space_edge_operands: 0 cells may differ
    from the plain version (atol 1e-6). Returns the operands checked."""
    mcfg = MatcherConfig()
    kw = dict(occ_sat=mcfg.occ_evidence_sat,
              free_threshold=mcfg.free_threshold,
              free_penalty=mcfg.free_penalty)
    ops = search_space_edge_operands()
    for name, op in ops.items():
        lo = torch.as_tensor(op["logodds"], device=device)
        _search_space_cells_ok(search_space(lo, op["taps"], **kw),
                               search_space(lo, op["taps"], plain=True, **kw),
                               f"search_space {name}")
    return list(ops)


def score_bound(S, pos, valid, n: int, bilinear: bool) -> dict:
    """The distinct cells of S under the valid beams' taps read once
    (a beam's (n + 1)^2 patch from floor(pos) when bilinear, else its
    n^2 patch around round(pos), cells inside S only), the positions
    and `valid` read once, the scores written once; 2 operations a
    tap, valid beam and candidate."""
    T, B = pos[0].shape
    H, W = S.shape
    span = n + 1 if bilinear else n
    offs = torch.arange(span, device=S.device) - n // 2
    base = [(torch.floor(p) if bilinear else torch.round(p))[:, valid]
            .long() for p in pos]
    rows = base[0][..., None, None] + offs[:, None]       # [T, Bv, s, 1]
    cols = base[1][..., None, None] + offs[None, :]       # [T, Bv, 1, s]
    rows, cols = torch.broadcast_tensors(rows, cols)
    inside = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    cells = torch.unique(rows[inside] * W + cols[inside]).numel()
    nv = int(valid.sum())
    return _bound(cells * 4 + 2 * T * B * 4 + B + T * n * n * 4,
                  T * n * n * nv * 2 * (4 if bilinear else 1))


def _counters():
    return {
        "update_hybrid": update_hybrid,
        "score_offsets": score_window,
        "search_space": search_space,
    }


def _reset_frontend_counts():
    for fn in _counters().values():
        fn.launches = 0
    for name in ("host_syncs", "matches", "updates"):
        setattr(frontend_step, name, 0)


def _timed_frontend(cfg, log, device, graph):
    """One run_frontend over `log` with the counts set to 0 just before
    it: (state, traj, scores, result dict)."""
    _reset_frontend_counts()
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    state, traj, scores = run_frontend(log, cfg, device, graph=graph)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    elapsed = start.elapsed_time(end) / 1e3
    T = len(traj)
    result = dict(
        scans=T, scans_run=-(-T // cfg.chunk) * cfg.chunk,
        scans_per_sec=T / elapsed, seconds_cuda_events=elapsed,
        seconds_host=wall,
        launches={k: fn.launches for k, fn in _counters().items()},
        host_syncs=frontend_step.host_syncs, matches=frontend_step.matches,
        updates=frontend_step.updates,
        peak_memory_bytes=torch.cuda.max_memory_allocated(device),
    )
    return state, traj, scores, result


def run_slice(cfg, log, device):
    """Phase 4: the frontend over the whole bench log through the kernels,
    as run_frontend runs it on CUDA (one CUDA graph replay a chunk), then
    the same steps enqueued one by one (graph=False), then the graph path
    again: no host read a scan; the eager run's bits and counts; one
    update_hybrid, one search_space and two score_offsets launches a scan
    run (the gates are on the device: a gated-off launch returns at once),
    and one search_space more, the start's; the first run's returned map
    untouched by the second."""
    warm = {k: np.asarray(v)[: cfg.chunk] for k, v in log.items()}
    t0 = time.perf_counter()
    run_frontend(warm, cfg, device)   # builds the chunk graph
    capture_s = time.perf_counter() - t0
    run_frontend(warm, cfg, device, graph=False)
    torch.cuda.synchronize()

    state, traj, scores, result = _timed_frontend(cfg, log, device, None)
    _, traj_e, scores_e, eager = _timed_frontend(cfg, log, device, False)
    kept = state.logodds.clone()
    state2, traj2, _, again = _timed_frontend(cfg, log, device, None)
    T, scans_run = len(traj), result["scans_run"]
    if not np.isfinite(traj).all():
        raise AssertionError("trajectory is not finite")
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    if not ate < ate_odom:
        raise AssertionError(f"ATE {ate} is not below odometry's {ate_odom}")
    same_bits = bool(np.array_equal(traj, traj_e)
                     and np.array_equal(scores, scores_e))
    twice = bool(np.array_equal(traj, traj2)
                 and torch.equal(state.logodds, kept)
                 and torch.equal(state2.logodds, kept))
    result.update(
        ate_m=ate, ate_odom_m=ate_odom, ate_reference_m=SLICE_ATE_REFERENCE_M,
        capture_s=capture_s, host_reads_per_scan=result["host_syncs"] / T,
        eager_scans_per_sec=eager["scans_per_sec"],
        eager_seconds_host=eager["seconds_host"],
        eager_launches=eager["launches"],
        eager_matches=eager["matches"], eager_updates=eager["updates"],
        graph_again_scans_per_sec=again["scans_per_sec"],
        same_bits_as_eager=same_bits, same_run_twice=twice,
    )
    print("slice:", json.dumps(result))
    if result["host_syncs"] or again["host_syncs"] or eager["host_syncs"]:
        raise AssertionError("the frontend read the host during its scans")
    if not same_bits:
        raise AssertionError("the graph and eager trajectories differ")
    if not twice:
        raise AssertionError("a second graph run changed the first's map or "
                             "gave another trajectory")
    expect = {"update_hybrid": scans_run, "search_space": scans_run + 1,
              "score_offsets": 2 * scans_run}
    for r in (result, eager, again):
        if r["launches"] != expect:
            raise AssertionError(f"launches {r['launches']}, expected "
                                 f"{expect}")
    counts = (result["matches"], result["updates"])
    if counts != (eager["matches"], eager["updates"]) or min(counts) <= 0:
        raise AssertionError(f"device counters {counts} against the eager "
                             f"run's {(eager['matches'], eager['updates'])}")
    # skipped scans report exactly -1; a matched score is >= -free_penalty
    if int((scores != -1.0).sum()) > result["matches"]:
        raise AssertionError("more matched scores than matches counted")
    return traj, result["launches"], state


def run_bench_ate(device):
    """Phase 4 (b): scripts/bench_ate_torch.py's frontend at seeds 0, 1 and
    2 (update_impl "pallas_hybrid", the reference's), each run with the
    frontend's counts set to 0 just before it, held as a set against the
    JAX package's runs of scripts/bench_ate.py (held_as_set; its
    `kf_ate_m` is here the trajectory's unaligned ATE, and neither side
    closes loops). Returns the launches summed over the three runs."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "scripts"))
    from bench_ate_torch import bench_ate

    with open(os.path.join(root, BENCH_ATE_REFERENCE)) as f:
        reference = {r["seed"]: r for r in json.load(f)["runs"]}
    runs, total = {}, {}
    for seed in BENCH_ATE_SEEDS:
        r = bench_ate("pallas_hybrid", seed, device=device,
                      before_run=_reset_frontend_counts)
        launches = {k: fn.launches for k, fn in _counters().items()}
        T = r["scans"]
        expect = {"update_hybrid": T, "search_space": T + 1,
                  "score_offsets": 2 * T}
        if T % 64 or launches != expect or frontend_step.host_syncs:
            raise AssertionError(
                f"bench_ate seed {seed}: launches {launches}, expected "
                f"{expect}; host reads {frontend_step.host_syncs}")
        ref = reference[seed]
        print(f"phase 4 (b) bench_ate seed {seed}:", json.dumps(
            {**r, "jax_ate_slam_m": ref["ate_slam_m"],
             "jax_ate_odom_m": ref["ate_odom_m"]}))
        runs[seed] = dict(kf_ate_m=r["ate_slam_m"],
                          jax_kf_ate_m=ref["ate_slam_m"], n_loops=0,
                          jax_n_loops=0)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    held_as_set("phase 4 (b) bench_ate.py's frontend (trajectory ATE)",
                runs)
    return total


def parity_run(cfg, log, device, traj):
    """Phase 5: the first scans with every kernel's plain version."""
    part = {k: np.asarray(v)[:PARITY_SCANS] for k, v in log.items()}
    _, traj_plain, _ = run_frontend(part, cfg, device, plain=True)
    dxy, dth = _pose_errors(traj[:PARITY_SCANS], traj_plain)
    print(f"plain-version slice, {PARITY_SCANS} scans: max |dxy| {dxy:.3g} m, "
          f"max |dtheta| {dth:.3g} rad (tolerance {POSE_TOL_M} / {POSE_TOL_RAD})")
    if dxy > POSE_TOL_M or dth > POSE_TOL_RAD:
        raise AssertionError("kernel and plain slices disagree")


def run_localize(cfg, log, device, logodds, slice_ate):
    """Phase 12: localization (run_localization) on phase 4's final map
    over a second traversal of bench.py's world through the kernels; the
    first scans again through the plain versions; peak_uniqueness at
    matched poses through the kernels and through the plain versions."""
    warm = {k: np.asarray(v)[: cfg.chunk] for k, v in log.items()}
    run_localization(warm, cfg, logodds, device)
    torch.cuda.synchronize()
    keep = logodds.clone()
    for fn in _counters().values():
        fn.launches = 0
    for name in ("host_syncs", "matches", "updates"):
        setattr(frontend_step, name, 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, traj, scores, events = run_localization(log, cfg, logodds, device)
    end.record()
    end.synchronize()
    launches = {k: fn.launches for k, fn in _counters().items()}
    T = len(traj)
    scans_run = -(-T // cfg.chunk) * cfg.chunk
    counts = dict(host_syncs=frontend_step.host_syncs,
                  matches=frontend_step.matches, updates=frontend_step.updates)
    if not np.isfinite(traj).all():
        raise AssertionError("localization: trajectory is not finite")
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    elapsed = start.elapsed_time(end) / 1e3
    result = dict(
        scans=T, scans_run=scans_run, scans_per_sec=T / elapsed,
        seconds_cuda_events=elapsed, ate_m=ate, ate_odom_m=ate_odom,
        ate_slice_m=slice_ate, launches=launches, events=events, **counts,
    )
    print("localization:", json.dumps(result))
    if not (ate < ate_odom and ate <= slice_ate + LOC_ATE_SLACK_M):
        raise AssertionError(
            f"localization ATE {ate} not below odometry's {ate_odom} and "
            f"within {LOC_ATE_SLACK_M} m of the map's run ({slice_ate})")
    if not (torch.equal(logodds, keep) and torch.equal(state.logodds, keep)):
        raise AssertionError("localization changed the map")
    # the match gate is on the device: both scorer passes launch every
    # scan run (returning at once where it is 0); one CUDA graph replay a
    # chunk, no host read
    expect = {"update_hybrid": 0, "search_space": 1,
              "score_offsets": 2 * scans_run}
    if launches != expect or counts["matches"] <= 0 or counts["updates"]:
        raise AssertionError(f"localization: launches {launches}, "
                             f"expected {expect}; {counts}")
    if counts["host_syncs"] != 0:
        raise AssertionError(f"localization: {counts['host_syncs']} host "
                             f"reads for {scans_run} scans, expected none")

    part = {k: np.asarray(v)[:PARITY_SCANS] for k, v in log.items()}
    _, traj_plain, _, _ = run_localization(part, cfg, logodds, device,
                                           plain=True)
    dxy, dth = _pose_errors(traj[:PARITY_SCANS], traj_plain)
    print(f"plain-version localization, {PARITY_SCANS} scans: max |dxy| "
          f"{dxy:.3g} m, max |dtheta| {dth:.3g} rad (tolerance {POSE_TOL_M} / "
          f"{POSE_TOL_RAD})")
    if dxy > POSE_TOL_M or dth > POSE_TOL_RAD:
        raise AssertionError("kernel and plain localizations disagree")

    g, s = cfg.grid, cfg.sensor
    m = dataclasses.replace(cfg.matcher, search_xy=PEAK_SEARCH_XY)
    matched = np.flatnonzero(scores != -1.0)
    picks = matched[np.linspace(0, len(matched) - 1, PEAK_SCANS).astype(int)]
    diffs = []
    for i in picks:
        pose = torch.as_tensor(traj[i], device=device)
        ranges = torch.as_tensor(log["ranges"][i], device=device)
        a, b = (float(correlative.peak_uniqueness(
            logodds, ranges, pose, g, m, s, plain=plain))
            for plain in (False, True))
        diffs.append(abs(a - b))
        print(f"peak_uniqueness at scan {i}: kernels {a:.7g}, plain {b:.7g}")
    if not np.isfinite(diffs).all() or max(diffs) > PEAK_TOL:
        raise AssertionError(f"peak_uniqueness: kernel and plain margins "
                             f"differ by {max(diffs)} > {PEAK_TOL}")
    return {"search_space": launches["search_space"],
            "score_offsets": launches["score_offsets"]}, traj


def _tiled_region_check(state, tcfg, table, win, pose, device):
    """Region round trips on a tiled frontend's final log-odds pool, held
    bit for bit against numpy on the stitched pool (stitch_tiles): the
    host-origin ops (gather_region / scatter_region with the host table)
    and the device-origin ops (gather_region_t / scatter_region_t, the
    slots from the device coords, the frontend's), at the window of the
    final pose: the gathered window is the stitched slice (0 in tiles
    that are not active); after a scatter of a seeded window into a copy
    of the pool, each active tile's piece holds t + (w - t) in float32
    and every other cell is as it was; a gated-off device scatter leaves
    the pool bit-identical."""
    dense, (ox, oy) = stitch_tiles(state.grid, tcfg)
    active = np.zeros_like(dense, dtype=bool)
    coords = state.grid.coords[:-1].cpu().numpy()
    act = coords[coords[:, 0] > FREE_SLOT]
    r_min, c_min = act[:, 0].min(), act[:, 1].min()
    t = tcfg.tile
    for r, c in act:
        active[(r - r_min) * t:(r - r_min + 1) * t,
               (c - c_min) * t:(c - c_min + 1) * t] = True
    center = world_to_cell_global(torch.as_tensor(pose[:2], device=device),
                                  tcfg).cpu().tolist()
    orc = (center[0] - win // 2, center[1] - win // 2)
    orc_t = torch.tensor(orc, dtype=torch.int32, device=device)
    r0, c0 = orc[0] - r_min * t, orc[1] - c_min * t
    if not (0 <= r0 and 0 <= c0 and r0 + win <= dense.shape[0]
            and c0 + win <= dense.shape[1]):
        raise AssertionError(f"tiled region check: window {orc} outside the "
                             f"stitched pool {dense.shape}")
    ref = dense[r0:r0 + win, c0:c0 + win]
    w = np.random.default_rng(SEED).normal(0.0, 3.0, (win, win)).astype(
        np.float32)
    expect = dense.copy()
    sl = (slice(r0, r0 + win), slice(c0, c0 + win))
    piece = expect[sl]
    expect[sl] = np.where(active[sl], piece + (w - piece), piece)
    w_t = torch.as_tensor(w, device=device)
    out = {}
    for form, gather, scatter in (
            ("host_origin",
             lambda g: gather_region(g, tcfg, orc, win, table),
             lambda g: scatter_region(g, tcfg, w_t, orc, table)),
            ("device_origin",
             lambda g: gather_region_t(g, tcfg, orc_t, win),
             lambda g: scatter_region_t(g, tcfg, w_t, orc_t,
                                        gate=torch.tensor(True,
                                                          device=device)))):
        gather_ok = np.array_equal(gather(state.grid).cpu().numpy(), ref)
        grid = TiledGrid(state.grid.tiles.clone(), state.grid.coords)
        scatter(grid)
        scatter_ok = np.array_equal(stitch_tiles(grid, tcfg)[0], expect)
        print(f"tiled region round trip ({form}), {win}^2 at {orc}: gather "
              f"bit-exact {gather_ok}, scatter bit-exact {scatter_ok}")
        if not (gather_ok and scatter_ok):
            raise AssertionError(f"{form} region ops disagree with the "
                                 "stitched numpy reference")
        out[form] = dict(gather_bit_exact=True, scatter_bit_exact=True)
    grid = TiledGrid(state.grid.tiles.clone(), state.grid.coords)
    scatter_region_t(grid, tcfg, w_t, orc_t,
                     gate=torch.tensor(False, device=device))
    kept = torch.equal(grid.tiles[:-1].view(torch.int32),
                       state.grid.tiles[:-1].view(torch.int32))
    print(f"tiled region gated-off scatter: pool bit-identical {kept}")
    if not kept:
        raise AssertionError("a gated-off scatter_region_t moved a tile")
    return dict(window=[win, win], origin_rc=list(orc), gate_off_kept=kept,
                **out)


def _tiled_cell_check(cfg, tcfg, state, log, device):
    """Kernel 1 `hybrid` and `ray` on the tiled frontend's gathered window
    (`cell=`: the window's float origin from its device lattice cell)
    against the out-of-place kernel at window_origin_xy's host floats: the
    same bits; gate 0 bit-identical."""
    win = tiled_window_cells(tcfg, cfg.sensor, cfg.matcher)
    i = len(log["odom"]) // 2
    pose = torch.as_tensor(np.asarray(log["gt_poses"][i], np.float32),
                           device=device)
    ranges = torch.as_tensor(log["ranges"][i], device=device)
    orc_t = world_to_cell_global(pose[:2], tcfg) - win // 2
    orc = tuple(orc_t.tolist())
    gw = gather_region_t(state.grid, tcfg, orc_t, win)
    out = {}
    for impl in ("pallas_hybrid", "pallas_ray"):
        g = dataclasses.replace(cfg.grid, resolution=tcfg.resolution,
                                update_impl=impl)
        ref = occupancy.integrate_scan(
            gw, pose, ranges, g, cfg.sensor,
            origin_xy=occupancy.window_origin_xy(tcfg, orc))
        res = []
        for gate in (True, False):
            a = gw.clone()
            occupancy.integrate_scan_window(
                a, pose, ranges, g, cfg.sensor, origin=None, cell=orc_t,
                size=(win, win), gate=torch.tensor(gate, device=device),
                origin_xy=(tcfg.origin_x, tcfg.origin_y))
            res.append(torch.equal(a, ref if gate else gw))
        print(f"{impl} on the tiled window at cell {orc}: the out-of-place "
              f"bits {res[0]}, gate 0 bit-identical {res[1]}")
        if not all(res):
            raise AssertionError(f"{impl}: the tiled window form parts from "
                                 "the out-of-place kernel")
        out[impl] = dict(shape=[win, win], cell=list(orc),
                         same_bits_as_out_of_place=True, gate_off_kept=True)
    return out


def _tiled_run(cfg, tcfg, log, device, graph):
    """run_tiled_frontend over `log` with the counts set to 0 just before
    it: (state, traj, scores, result dict)."""
    for fn in _counters().values():
        fn.launches = 0
    for name in ("host_syncs", "matches", "updates"):
        setattr(tiled_frontend_step, name, 0)
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    state, traj, scores = run_tiled_frontend(log, cfg, tcfg, device,
                                             graph=graph)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    elapsed = start.elapsed_time(end) / 1e3
    T = len(traj)
    result = dict(
        scans=T, scans_per_sec=T / elapsed, seconds_cuda_events=elapsed,
        seconds_host=wall,
        launches={k: fn.launches for k, fn in _counters().items()},
        host_syncs=tiled_frontend_step.host_syncs,
        matches=tiled_frontend_step.matches,
        updates=tiled_frontend_step.updates,
        peak_memory_bytes=torch.cuda.max_memory_allocated(device),
    )
    return state, traj, scores, result


TILED_EAGER_SCANS = 1024   # phase 13: graph against eager (16 chunks)


def run_tiled(cfg, tcfg, log, device):
    """Phase 13: the tiled frontend (run_tiled_frontend) over a lap of the
    corridor world through the kernels, as it runs on CUDA (one
    TiledChunkGraph replay a chunk, the gates, window origins and tile
    slots on the device): one host read a chunk (the forecast's pose) and
    none a scan, one update and one search-space build a scan run and two
    scorer launches; the first TILED_EAGER_SCANS scans through the graph
    and through the same device-gated steps eagerly: the same bits
    (trajectory, scores, both pools) and counts; the first scans again
    through the plain versions; the region ops and the tiled window's
    kernel forms held bit for bit."""
    warm = {k: np.asarray(v)[: cfg.chunk] for k, v in log.items()}
    t0 = time.perf_counter()
    run_tiled_frontend(warm, cfg, tcfg, device)   # builds the chunk graph
    capture_s = time.perf_counter() - t0
    run_tiled_frontend(warm, cfg, tcfg, device, graph=False)
    torch.cuda.synchronize()
    state, traj, scores, result = _tiled_run(cfg, tcfg, log, device, None)
    T = len(traj)
    n_chunks = -(-T // cfg.chunk)
    scans_run = n_chunks * cfg.chunk
    if not np.isfinite(traj).all():
        raise AssertionError("tiled frontend: trajectory is not finite")
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    coords = state.grid.coords[:-1].cpu().numpy()
    n_active = int((coords[:, 0] > FREE_SLOT).sum())
    head = {k: np.asarray(v)[:TILED_EAGER_SCANS] for k, v in log.items()}
    runs = [_tiled_run(cfg, tcfg, head, device, g) for g in (None, False)]
    (st_g, tr_g, sc_g, head_g), (st_e, tr_e, sc_e, eager) = runs
    same = bool(np.array_equal(tr_g, tr_e) and np.array_equal(sc_g, sc_e)
                and np.array_equal(tr_g, traj[:TILED_EAGER_SCANS])
                and torch.equal(st_g.grid.coords, st_e.grid.coords)
                and torch.equal(st_g.grid.tiles[:-1], st_e.grid.tiles[:-1])
                and torch.equal(st_g.sgrid.tiles[:-1], st_e.sgrid.tiles[:-1]))
    result.update(
        scans_run=scans_run, ate_m=ate, ate_odom_m=ate_odom,
        active_tiles=n_active,
        window=tiled_window_cells(tcfg, cfg.sensor, cfg.matcher),
        capture_s=capture_s, host_reads_per_scan=result["host_syncs"] / T,
        host_reads_per_chunk=result["host_syncs"] / n_chunks,
        eager_scans=TILED_EAGER_SCANS,
        eager_scans_per_sec=eager["scans_per_sec"],
        eager_launches=eager["launches"], same_bits_as_eager=same,
    )
    print("tiled frontend:", json.dumps(result))
    if not ate < ate_odom:
        raise AssertionError(f"tiled frontend: ATE {ate} not below "
                             f"odometry's {ate_odom}")
    if not 4 <= n_active <= tcfg.n_slots:
        raise AssertionError(f"tiled frontend: {n_active} active tiles")
    if not same:
        raise AssertionError("tiled frontend: the graph and eager runs "
                             "differ")
    passes = _match_passes(cfg.matcher, tcfg.resolution)
    for r, n in ((result, scans_run), (head_g, TILED_EAGER_SCANS),
                 (eager, TILED_EAGER_SCANS)):
        expect = {"update_hybrid": n, "search_space": n,
                  "score_offsets": passes * n}
        if r["launches"] != expect:
            raise AssertionError(f"tiled frontend: launches {r['launches']}, "
                                 f"expected {expect}")
        if r["host_syncs"] != n // cfg.chunk:
            raise AssertionError(f"tiled frontend: {r['host_syncs']} host "
                                 "reads, expected one a chunk")
    counts = (head_g["matches"], head_g["updates"])
    if counts != (eager["matches"], eager["updates"]) or min(counts) <= 0:
        raise AssertionError(f"tiled frontend: device counters {counts}")

    part = {k: np.asarray(v)[:PARITY_SCANS] for k, v in log.items()}
    _, traj_plain, _ = run_tiled_frontend(part, cfg, tcfg, device, plain=True)
    dxy, dth = _pose_errors(traj[:PARITY_SCANS], traj_plain)
    print(f"plain-version tiled frontend, {PARITY_SCANS} scans: max |dxy| "
          f"{dxy:.3g} m, max |dtheta| {dth:.3g} rad (tolerance {POSE_TOL_M} / "
          f"{POSE_TOL_RAD})")
    if dxy > POSE_TOL_M or dth > POSE_TOL_RAD:
        raise AssertionError("kernel and plain tiled frontends disagree")
    table = TileTable.from_coords(tcfg, state.grid.coords)
    _tiled_region_check(state, tcfg, table, result["window"], traj[-1],
                        device)
    _tiled_cell_check(cfg, tcfg, state, log, device)
    return result["launches"], traj


def run_global(cfg, loc_log, loc_traj, kidnap, device, logodds):
    """Phase 14: (a) global_localize on phase 4's final map from
    GLOBAL_SCANS scans of the localization log (a seeded draw), through the
    kernels and through the plain versions, each held to the pose phase 12
    tracked for that scan on the same map (`loc_traj`: the map carries
    phase 4's own error, so the ground truth is printed beside it); (b)
    run_localization with recover=True over a kidnap log in bench.py's
    world."""
    g, m, s = cfg.grid, cfg.matcher, cfg.sensor
    ref, sha = relocalization_reference(logodds)
    print(f"phase 4's map: sha256 {sha}; the JAX reference "
          f"({RELOC_REFERENCE}) {'applies' if ref else 'was made on another map'}")
    picks = global_picks(len(loc_log["odom"]))
    global_localize(logodds, torch.as_tensor(loc_log["ranges"][0],
                                             device=device), g, m, s)
    torch.cuda.synchronize()
    for fn in _counters().values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    base_mem = torch.cuda.memory_allocated(device)
    rows, times = [], []
    for i in picks:
        ranges = torch.as_tensor(loc_log["ranges"][i], device=device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pose, score, margin = global_localize(logodds, ranges, g, m, s,
                                              return_margin=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        pose, score = pose.cpu().numpy(), float(score)
        dxy, dth = _pose_errors(pose[None], loc_traj[i][None])
        gxy, gth = _pose_errors(pose[None], loc_log["gt_poses"][i][None])
        rows.append(dict(scan=int(i), pose=pose.tolist(), score=score,
                         margin=float(margin), err_m=dxy, err_rad=dth,
                         gt_err_m=gxy, gt_err_rad=gth))
    peak = torch.cuda.max_memory_allocated(device) - base_mem
    a_launches = {k: fn.launches for k, fn in _counters().items()}
    last = torch.as_tensor(loc_log["ranges"][picks[-1]], device=device)
    events = _device_events(lambda: global_localize(logodds, last, g, m, s),
                            GLOBAL_PROFILE_CALLS)
    device_ms = sum(e.time_range.end - e.time_range.start
                    for e in events) / GLOBAL_PROFILE_CALLS / 1e3
    S = correlative.build_search_space(logodds, m, g.resolution)
    fine = refine_matcher(m, g)
    for row, i in zip(rows, picks):
        ranges = torch.as_tensor(loc_log["ranges"][i], device=device)
        # the refine from the tracked pose: the score a correct answer
        # reaches, which the global maximum may not fall below
        _, at_tracked = correlative.match_scan(
            logodds, ranges, torch.as_tensor(loc_traj[i], device=device), g,
            fine, s, search_space=S)
        row["score_at_tracked"] = float(at_tracked)
        coarse = [global_localize(logodds, ranges, g, m, s, refine=False,
                                  plain=plain)[0].cpu().numpy()
                  for plain in (False, True)]
        cells = [sweep_cell(c, g) for c in coarse]
        plain_pose = global_localize(logodds, ranges, g, m, s,
                                     plain=True)[0].cpu().numpy()
        row["plain_dxy"], row["plain_dth"] = _pose_errors(
            np.array(row["pose"])[None], plain_pose[None])
        row["coarse_cell"], row["coarse_cell_plain"] = cells
    ms = statistics.median(times)
    jax_rows = {r["scan"]: r for r in ref["global_localize"]} if ref else {}
    for row in rows:
        row["within_limits"] = bool(
            row["err_m"] < GLOBAL_ERR_M and row["err_rad"] < GLOBAL_ERR_RAD
            and row["score"] > GLOBAL_MIN_SCORE)
        # an alias: the pose found scores at least as well as the refine
        # from the tracked pose, so the scan cannot tell the two apart
        row["alias"] = bool(not row["within_limits"]
                            and row["score"] >= row["score_at_tracked"])
        jr = jax_rows.get(row["scan"])
        if jr is not None:
            row["jax_coarse_cell"] = jr["coarse_cell"]
            row["jax_dxy"], row["jax_dth"] = _pose_errors(
                np.array(row["pose"])[None], np.array(jr["pose"])[None])
            row["jax_score"] = jr["score"]
        # the reference's own miss: on this map JAX's sweep peaks at the
        # same cell and heading, and its refine ends within 1e-3 m and rad
        row["reference_miss"] = bool(
            not row["within_limits"] and not row["alias"] and jr is not None
            and list(row["coarse_cell"]) == jr["coarse_cell"]
            and max(row["jax_dxy"], row["jax_dth"]) <= 1e-3)
    result = dict(scans=rows, ms_per_call_median=ms, ms_per_call=times,
                  device_ms_per_call=device_ms,
                  device_kernels_per_call=len(events) / GLOBAL_PROFILE_CALLS,
                  peak_memory_bytes_above_map=peak, launches=a_launches,
                  map_sha256=sha, reference_applies=ref is not None,
                  within_limits=sum(r["within_limits"] for r in rows),
                  aliases=sum(r["alias"] for r in rows),
                  reference_misses=sum(r["reference_miss"] for r in rows),
                  coarse_cells_as_jax=sum(
                      list(r["coarse_cell"]) == r.get("jax_coarse_cell")
                      for r in rows))
    print("global_localize:", json.dumps(result))
    for row in rows:
        # a miss must be an alias or one that the reference makes too; a
        # miss that scores lower than the tracked pose and that JAX does
        # not share is a search failure
        if not (row["within_limits"] or row["alias"]
                or row["reference_miss"]):
            raise AssertionError(f"global_localize missed scan {row['scan']}: "
                                 f"{row}")
        if row["coarse_cell"] != row["coarse_cell_plain"]:
            raise AssertionError(f"global_localize: kernel and plain sweeps "
                                 f"peak apart at scan {row['scan']}")
        if row["plain_dxy"] > 1e-3 or row["plain_dth"] > 1e-3:
            raise AssertionError(f"global_localize: kernel and plain refines "
                                 f"disagree at scan {row['scan']}")
    # one search-space build (no search space given) and one scorer pass
    # (the refine's window fits one fine pass) a call
    if a_launches != {"update_hybrid": 0, "search_space": GLOBAL_SCANS,
                      "score_offsets": GLOBAL_SCANS}:
        raise AssertionError(f"global_localize: launches {a_launches}")

    # (b) the entry point: localization with relocalization on a kidnap
    warm = {k: np.asarray(v)[: cfg.chunk] for k, v in kidnap.items()}
    run_localization(warm, cfg, logodds, device, recover=True)
    torch.cuda.synchronize()
    for fn in _counters().values():
        fn.launches = 0
    for name in ("host_syncs", "matches", "updates"):
        setattr(frontend_step, name, 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, traj, scores, events = run_localization(kidnap, cfg, logodds, device,
                                               recover=True)
    end.record()
    end.synchronize()
    launches = {k: fn.launches for k, fn in _counters().items()}
    counts = dict(host_syncs=frontend_step.host_syncs,
                  matches=frontend_step.matches, updates=frontend_step.updates)
    T = len(traj)
    K = cfg.chunk
    n_chunks = -(-T // K)
    attempts = 0
    for c in range(n_chunks):
        sc = scores[c * K:(c + 1) * K]
        mt = sc[sc != -1.0]
        attempts += int(len(mt) >= 3 and float(np.median(mt)) < 0.25)
    elapsed = start.elapsed_time(end) / 1e3
    gt = kidnap["gt_poses"]
    k0 = events[-1]["scan"] + 1 if events else T
    tail = float(np.median(np.hypot(*(traj[k0:, :2] - gt[k0:, :2]).T))) \
        if k0 < T else float("nan")
    ate = ate_rmse(traj, gt, align=False)
    result = dict(
        scans=T, scans_run=n_chunks * K, scans_per_sec=T / elapsed,
        seconds_cuda_events=elapsed, events=events, relocalizations=attempts,
        median_err_after_last_event_m=tail, ate_m=ate, launches=launches,
        **counts,
    )
    if ref:
        # the JAX package's run on this map (tests/test_torch_global_loc.py's
        # tolerances): the same event scans and skipped scans, event poses
        # within 1e-3 m and rad, scores within 1e-4, ATE within 5 mm
        jrec = ref["recovery"]
        skipped = np.flatnonzero(scores == -1.0).tolist()
        result.update(
            jax_events=jrec["events"], jax_ate_m=jrec["ate_m"],
            skipped_as_jax=skipped == jrec["skipped"],
            event_pose_diffs=[_pose_errors(np.array(a["pose"])[None],
                                           np.array(b["pose"])[None])
                              for a, b in zip(events, jrec["events"])])
    print("relocalization:", json.dumps(result))
    if not events or not tail < RECOVER_TAIL_M:
        raise AssertionError(f"relocalization: events {events}, median error "
                             f"after the last {tail} m")
    if ref:
        jev = ref["recovery"]["events"]
        if ([e["scan"] for e in events] != [e["scan"] for e in jev]
                or not result["skipped_as_jax"]
                or any(max(d) > 1e-3 for d in result["event_pose_diffs"])
                or any(abs(a["score"] - b["score"]) > 1e-4
                       for a, b in zip(events, jev))
                or abs(ate - ref["recovery"]["ate_m"]) > 5e-3):
            raise AssertionError(f"relocalization disagrees with the JAX "
                                 f"package's on this map: {result}")
    expect = {"update_hybrid": 0, "search_space": 1,
              "score_offsets": 2 * n_chunks * K + attempts}
    if launches != expect:
        raise AssertionError(f"relocalization: launches {launches}, "
                             f"expected {expect}")
    if counts["host_syncs"] != n_chunks + attempts:
        raise AssertionError(f"relocalization: {counts['host_syncs']} host "
                             "reads, expected one a chunk (its scores) and "
                             "one a relocalization")
    return {"search_space": launches["search_space"],
            "score_offsets": launches["score_offsets"]}


def global_picks(n_scans):
    """Phase 14's GLOBAL_SCANS scans of a log of `n_scans`, a seeded draw
    (scripts/relocalization_reference.py draws the same)."""
    return np.sort(np.random.default_rng(SEED).choice(
        n_scans, GLOBAL_SCANS, replace=False))


def map_sha256(logodds) -> str:
    """sha256 of a map's float32 cells in C order."""
    a = logodds.detach().float().contiguous().cpu().numpy() if isinstance(
        logodds, torch.Tensor) else np.asarray(logodds, np.float32)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def relocalization_reference(logodds):
    """(the JAX package's relocalization results on this map, or None when
    they were made on another map; the map's sha256)."""
    sha = map_sha256(logodds)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        RELOC_REFERENCE)
    with open(path) as f:
        ref = json.load(f)
    return (ref if ref["map"]["sha256"] == sha else None), sha


def _pose_errors(a, b):
    """(max |dxy|, max |dtheta|) between two [T, 3] trajectories."""
    dxy = float(np.max(np.hypot(*(a[:, :2] - b[:, :2]).T)))
    dth = float(np.max(np.abs(np.angle(np.exp(1j * (a[:, 2] - b[:, 2]))))))
    return dxy, dth


def _map_cells_ok(a, b, gcfg, name):
    """Maps that an update produced twice: at most MAP_CELL_SHARE of the
    cells differ, each by one l_free or l_occ (in the map's dtype).
    Returns (cells differing, max |err|)."""
    diff = (a.float() - b.float()).abs()
    off = diff[diff != 0]
    one_step = ((off - abs(gcfg.l_free)).abs() <= BF16_STEP_ATOL) | (
        (off - gcfg.l_occ).abs() <= BF16_STEP_ATOL
    )
    if off.numel() > MAP_CELL_SHARE * diff.numel() or not bool(one_step.all()):
        raise AssertionError(
            f"{name}: {off.numel()} of {diff.numel()} cells differ "
            f"(max {float(diff.max())})"
        )
    return off.numel(), float(diff.max())


def _cells_exact(a, b, name):
    """An update and its plain version: every cell the same bits (kernel 1
    `ism`, which computes a cell's bearing as the reference kernel does,
    the same float32 operations on both). Returns (0, 0.0)."""
    n_diff = int((a.float() != b.float()).sum())
    if n_diff:
        raise AssertionError(
            f"{name}: {n_diff} of {a.numel()} cells differ (max "
            f"{float((a.float() - b.float()).abs().max())}; tolerance 0)")
    return 0, 0.0


def _gather_entry(flat, anc, dtype_name):
    """Kernel 4 on rows `flat` [P, N] with ancestors `anc`: bit-exact
    against its plain version, timed beside index_select. The bound counts
    each distinct ancestor row read once and every row written once."""
    P = flat.shape[0]
    distinct = len(set(anc.tolist()))
    if distinct == P:
        raise AssertionError("the gather check needs repeated ancestors")
    same = torch.equal(gather_rows(flat, anc), gather_rows(flat, anc, plain=True))
    variant = gather_ops.last_variant()
    print(f"gather_rows {list(flat.shape)} {dtype_name}, {distinct} distinct "
          f"ancestors: {variant} bit-exact {same}")
    if not same:
        raise AssertionError("gather_rows disagrees with its plain version")
    anc64 = anc.to(torch.int64)
    row_bytes = flat.shape[1] * flat.element_size()
    return dict(
        max_abs_err=0.0, tolerance="bit-exact", shape=list(flat.shape),
        distinct_ancestors=distinct, library_call="index_select",
        variant=variant,
        **_times(lambda: gather_rows(flat, anc),
                 lambda: gather_rows(flat, anc, plain=True),
                 _bound((distinct + P) * row_bytes + 4 * P, 0),
                 library=lambda: flat.index_select(0, anc64)),
    )


def _field_args(mcfg, res):
    """(taps, keyword arguments) of window_field for a matcher config."""
    taps = correlative.gaussian_kernel_1d(
        mcfg.sigma_m / res, blur_halo_cells(mcfg, res)
    )
    thr = mcfg.free_threshold
    return taps, dict(
        inv_sat=1.0 / mcfg.occ_evidence_sat,
        free_logit=float(np.log(thr / (1.0 - thr))),
        free_penalty=mcfg.free_penalty,
    )


def _field_origins(rng, P, g, win, device):
    """Unclamped window origins [P, 2] all over the map and off every edge."""
    org = rng.integers(-win // 2 - 60, g.height - win // 2 + 60, (P, 2))
    org[:6] = [[-100, 10], [10, -100], [g.height - 100, 10],
               [10, g.width - 100], [-win - 5, 40], [g.height + 3, -3]]
    return torch.as_tensor(org.astype(np.int32), device=device)


def _field_check(maps, origins, win, taps, out_dtype, fkw):
    """Kernel 6 against its plain version: at most 0.01% of the cells may
    differ, each by one ulp of the out dtype (the float32 sums agree; nvcc
    and PyTorch may round a last bit apart in the bf16 cast's input).
    Returns (cells differing, max |err|, the kernel variant that ran)."""
    a = window_field(maps, origins, win, taps, out_dtype=out_dtype, **fkw).float()
    variant = field_ops.last_variant()
    b = window_field(maps, origins, win, taps, out_dtype=out_dtype, plain=True,
                     **fkw).float()
    diff = (a - b).abs()
    n_diff = int((diff != 0).sum())
    ulp = 2.0 ** -7 if out_dtype == torch.bfloat16 else 2.0 ** -22
    one_ulp = bool(((diff == 0) | (diff <= ulp * b.abs())).all())
    print(f"window_field {list(maps.shape)} {maps.dtype} -> [{maps.shape[0]}, "
          f"{win}x{win}] {out_dtype}, {len(taps)} taps, {variant}: {n_diff} cells differ, "
          f"max |err| {float(diff.max()):.3g} (tolerance: <= 0.01% of cells, "
          "each by one ulp)")
    if n_diff > 1e-4 * diff.numel() or not one_ulp:
        raise AssertionError("window_field disagrees with its plain version")
    return n_diff, float(diff.max()), variant


def _field_entry(maps, origins, win, taps, out_dtype, fkw):
    """Kernel 6 checked and timed at one of its paths' shapes."""
    P, H, W = maps.shape
    n_diff, err, variant = _field_check(maps, origins, win, taps, out_dtype, fkw)
    on_map = sum(
        max(0, min(H, r + win) - max(0, r)) * max(0, min(W, c + win) - max(0, c))
        for r, c in origins.cpu().tolist()
    )

    def field(plain):
        return window_field(maps, origins, win, taps, out_dtype=out_dtype,
                            plain=plain, **fkw)

    return dict(
        max_abs_err=err, cells_differing=n_diff,
        tolerance="<=0.01% of cells, each by one ulp of the out dtype",
        shape=[P, win, win], out_dtype=str(out_dtype), variant=variant,
        # the window cells on the map read once, the field written once;
        # two blur passes and ~8 more operations a cell
        **_times(lambda: field(False), lambda: field(True), _bound(
            on_map * maps.element_size()
            + P * win * win * torch.finfo(out_dtype).bits // 8,
            P * win * win * (4 * len(taps) + 8))),
    )


def _misaligned(t):
    """A contiguous copy of `t` whose base sits one element past a 16-byte
    aligned address (a slice of a larger buffer)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def variant_checks(cfg, pf, device):
    """Phase 3: every variant of kernels 4 and 6 against the plain version,
    at small shapes whose alignment selects it. Returns the variants seen."""
    rng = np.random.default_rng(SEED + 7)
    _, fkw = _field_args(fastslam.refine_matcher(cfg, pf), cfg.grid.resolution)
    P, Hm = 5, 160
    pairs = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16))
    seen = set()
    # (map width, window): row pitch a multiple of 16 bytes or not, field
    # rows 16-byte aligned or not
    for Wm, win in ((256, 96), (203, 100), (128, 44)):
        maps = torch.as_tensor(
            rng.uniform(-4.0, 4.0, (P, Hm, Wm)).astype(np.float32), device=device
        )
        # inside, off the top left, off the bottom right, half off the
        # bottom, wholly off the map
        origins = torch.as_tensor(np.array(
            [[10, 20], [-20, -30], [Hm - 40, Wm - 40], [Hm - win // 2, 5],
             [-win - 4, Wm - 8]], np.int32), device=device)
        for n_taps in (9, 13):
            taps = correlative.gaussian_kernel_1d(1.5, n_taps // 2)
            for in_dtype, out_dtype in pairs:
                m = maps.to(in_dtype)
                for mm in (m, _misaligned(m)) if Wm == 256 else (m,):
                    seen.add(_field_check(mm, origins, win, taps, out_dtype,
                                          fkw)[2])
    if seen != set(field_ops.VARIANTS):
        raise AssertionError(f"window_field variants run: {sorted(seen)}")

    # kernel 4: rows of 16 k, 4 k and odd bytes, a misaligned base; sorted,
    # identical, collapsed and unsorted ancestors
    P = 37
    ancestors = {
        "sorted": np.sort(rng.integers(0, P, P)), "identity": np.arange(P),
        "collapsed": np.full(P, 7), "unsorted": rng.integers(0, P, P),
    }
    gathers = set()
    for n_bytes in (3 * 16384 + 16, 4004, 1001):
        x = torch.as_tensor(
            rng.integers(0, 256, (P, n_bytes)).astype(np.uint8), device=device
        )
        for xx in (x, _misaligned(x)) if n_bytes % 16 == 0 else (x,):
            for name, a in ancestors.items():
                anc = torch.as_tensor(a.astype(np.int32), device=device)
                ok = torch.equal(gather_rows(xx, anc),
                                 gather_rows(xx, anc, plain=True))
                variant = gather_ops.last_variant()
                gathers.add(variant)
                if not ok:
                    raise AssertionError(
                        f"gather_rows {variant} [{P}, {n_bytes}] bytes, {name} "
                        "ancestors: disagrees with its plain version")
    print(f"gather_rows variants, each bit-exact: {sorted(gathers)}")
    if gathers != set(gather_ops.VARIANTS):
        raise AssertionError(f"gather_rows variants run: {sorted(gathers)}")
    return dict(window_field=sorted(seen), gather_rows=sorted(gathers))


def pf_kernel_checks(cfg, pf, log, device, big_particles):
    """Phase 3 for the particle filter's kernels, at FastSLAM-100 shapes."""
    rng = np.random.default_rng(SEED + 1)
    g, s = cfg.grid, cfg.sensor
    P, res = pf.n_particles, g.resolution
    mdt = getattr(torch, pf.map_dtype)
    maps = torch.as_tensor(
        rng.uniform(-6.0, 6.0, (P, g.height, g.width)).astype(np.float32),
        device=device,
    ).to(mdt)
    ranges = torch.as_tensor(log["ranges"][len(log["odom"]) // 2], device=device)
    results = {}

    # kernel 1, variant ism: every particle's 256^2 update window, with
    # poses all over the map so that windows clamp at every edge
    uwin = update_window_cells(g, s)
    xy = rng.uniform(0.0, g.width * res, (P, 2)) + (g.origin_x, g.origin_y)
    poses = torch.as_tensor(
        np.column_stack([xy, rng.uniform(-np.pi, np.pi, P)]).astype(np.float32),
        device=device,
    )

    def ism(m, plain):
        return update_ism(
            m, poses, ranges, region=(uwin, uwin),
            origin_xy=(g.origin_x, g.origin_y), plain=plain,
            **occupancy.update_constants(g, s),
        )

    n_diff, err = _cells_exact(
        ism(maps.clone(), False), ism(maps.clone(), True), "update_ism"
    )
    print(f"update_ism [{P}, {uwin}x{uwin}] of {pf.map_dtype} "
          f"[{g.height}x{g.width}] maps: {n_diff} cells differ (tolerance 0 "
          f"of {P * uwin * uwin})")
    scratch = maps.clone()
    results["update_ism"] = dict(
        max_abs_err=err, cells_differing=n_diff, tolerance="bit-exact",
        shape=[P, uwin, uwin],
        # every window read and written once in the map dtype, the scan and
        # the poses; ~30 operations a cell
        **_times(lambda: ism(scratch, False), lambda: ism(scratch, True),
                 _bound(2 * P * uwin * uwin * maps.element_size()
                        + 4 * ranges.numel() + 12 * P, 30 * P * uwin * uwin)),
    )

    # kernel 1, variant ism, on FastSLAM-1000's carve images, with the
    # operands of pf/shared_update.py:carve_operands: 16 float32 256^2
    # windows as large as their image, the sensor at the center cell with
    # one heading a slot, l_occ = 0 (the occupied channel skipped); the
    # images drawn from [-6, 6] so that the clamp is exercised
    G = pf.update_theta_slots
    slot_poses, carve_origin, carve_consts = carve_operands(
        torch.linspace(-0.3, 0.3, G, device=device), cfg, uwin
    )
    images = torch.as_tensor(
        np.random.default_rng(SEED + 7).uniform(-6.0, 6.0, (G, uwin, uwin))
        .astype(np.float32),
        device=device,
    )

    def carve(m, plain):
        return update_ism(
            m, slot_poses, ranges, region=(uwin, uwin),
            origin_xy=carve_origin, plain=plain, **carve_consts,
        )

    n_diff, err = _cells_exact(
        carve(images.clone(), False), carve(images.clone(), True),
        "update_ism carve images",
    )
    print(f"update_ism carve images [{G}, {uwin}x{uwin}] float32, l_occ 0: "
          f"{n_diff} cells differ (tolerance 0 of {G * uwin * uwin})")
    results["update_ism"]["carve_images"] = dict(
        max_abs_err=err, cells_differing=n_diff, shape=[G, uwin, uwin],
        **_times(lambda: carve(images, False), lambda: carve(images, True),
                 _bound(2 * images.numel() * 4 + 4 * ranges.numel() + 12 * G,
                        30 * images.numel())),
    )
    del images
    results["update_ism"]["edge_operands_checked"] = ism_edge_check(device)

    # kernel 4: the resample's row gather, with sorted, repeated ancestors
    # (systematic resampling's), at FastSLAM-100's and FastSLAM-1000's shapes
    flat = maps.reshape(P, -1)
    anc = torch.as_tensor(
        np.sort(rng.integers(0, P, P)).astype(np.int32), device=device
    )
    results["gather_rows"] = _gather_entry(flat, anc, pf.map_dtype)

    # kernel 6: every particle's field over its unclamped 288^2 window,
    # origins off every edge of the map
    mcfg = fastslam.refine_matcher(cfg, pf)
    win = scan_window_cells(g, s, mcfg)
    cdtype = torch.bfloat16 if mcfg.score_bf16 else torch.float32
    taps, fkw = _field_args(mcfg, res)
    origins = _field_origins(rng, P, g, win, device)
    results["window_field"] = _field_entry(maps, origins, win, taps, cdtype, fkw)

    # both again at FastSLAM-1000's particle count (524 MB of maps)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 6)
    big = (torch.rand((big_particles, g.height, g.width), generator=gen,
                      device=device) * 12 - 6).to(mdt)
    anc = torch.as_tensor(
        np.sort(rng.integers(0, big_particles, big_particles)).astype(np.int32),
        device=device,
    )
    results["gather_rows"]["at_fastslam1000"] = _gather_entry(
        big.reshape(big_particles, -1), anc, pf.map_dtype
    )
    origins = _field_origins(rng, big_particles, g, win, device)
    results["window_field"]["at_fastslam1000"] = _field_entry(
        big, origins, win, taps, cdtype, fkw
    )
    # the same maps at a misaligned base: the tiles loaded by the threads
    shifted = _misaligned(big)
    del big
    coop_ms, _ = _cuda_device_ms(
        lambda: window_field(shifted, origins, win, taps, out_dtype=cdtype, **fkw)
    )
    results["window_field"]["at_fastslam1000"].update(
        coop_device_ms=coop_ms, coop_variant=field_ops.last_variant()
    )
    del shifted
    torch.cuda.empty_cache()

    # kernel 7: the shift stack of the scan's endpoint splats
    G = mcfg.n_theta + 2 * pf.refine_theta_pad
    R = 2 * int(round(mcfg.search_xy / res)) + 1
    thetas = torch.linspace(-0.2, 0.2, G, device=device)
    E = endpoint_splat(ranges, s, thetas, win, R, R, res, cdtype)
    same = torch.equal(shift_stack(E, R, R), shift_stack(E, R, R, plain=True))
    print(f"shift_stack {list(E.shape)} -> [{G}, {R * R}, {win}, {win}] "
          f"{cdtype}: bit-exact {same}")
    if not same:
        raise AssertionError("shift_stack disagrees with its plain version")
    # the library's form: F.unfold over E padded by R-1 rows and columns
    # at the low edges gives channel kr*R+kc = E shifted by (R-1-kr,
    # R-1-kc), the stack's channel reversed
    library = lambda: F.unfold(  # noqa: E731
        F.pad(E[:, None], (R - 1, 0, R - 1, 0)), (R, R)).flip(1).view(
            G, R * R, win, win)
    lib_same = torch.equal(library(), shift_stack(E, R, R, plain=True))
    print(f"shift_stack: padded F.unfold with its channels reversed "
          f"bit-exact {lib_same}")
    if not lib_same:
        raise AssertionError("the unfold form of the shift stack disagrees "
                             "with its plain version")
    results["shift_stack"] = dict(
        max_abs_err=0.0, tolerance="bit-exact",
        shape=[G, R * R, win, win],
        library="F.unfold(F.pad(E, low edges)).flip(1)",
        **_times(lambda: shift_stack(E, R, R),
                 lambda: shift_stack(E, R, R, plain=True),
                 _bound((1 + R * R) * E.numel() * E.element_size(), 0),
                 library=library),
    )
    return results


# the ISM kernel's edge operands (ism_edge_operands)
ISM_EDGE_SENSORS = {
    # bench_pf.py's 180 degrees; ranges at and just above min_range
    "fov180": SensorConfig(n_beams=180, max_range=5.0),
    # 270 degrees from -135: beams with b * step > pi; ranges under occ_tol
    "fov270": SensorConfig(n_beams=271, fov_rad=1.5 * np.pi, max_range=5.0,
                           angle_min=-0.75 * np.pi, min_range=0.02),
}
# (map side, window side, pose cells): windows clamped at the low edges,
# inside, clamped at the high edges; a window as large as the map
ISM_EDGE_WINDOWS = {
    "clamped": (96, 48, [(3, 5), (44, 50), (92, 90), (2, 93)]),
    "whole_map": (64, 64, [(10, 50), (32, 31)]),
}
ISM_EDGE_RES = 0.1
ISM_EDGE_ORIGIN = (-2.0, 1.5)


def ism_edge_operands(sensor_name: str, window: str) -> dict:
    """Numpy operands of the ISM update (kernel 1 ism) that reach the
    corners of its occupied channel's candidate boxes: one pose in each
    cell of ISM_EDGE_WINDOWS[window] (headings from -pi to 1.3 pi), whose
    windows clamp at each edge of the map or are as large as it, and a
    scan of ISM_EDGE_SENSORS[sensor_name] with ranges just above
    min_range, at occ_tol above it, under occ_tol, invalid, without a hit
    and below min_range. Used here (ism_edge_check) and by the CPU tests
    (tests/test_torch_pf_kernels.py)."""
    sensor = ISM_EDGE_SENSORS[sensor_name]
    side, win, cells = ISM_EDGE_WINDOWS[window]
    rng = np.random.default_rng(len(sensor_name) * 10 + side)
    res, origin_xy = ISM_EDGE_RES, ISM_EDGE_ORIGIN
    B, P = sensor.n_beams, len(cells)
    rc = np.asarray(cells, np.float64)
    poses = np.column_stack([
        origin_xy[0] + (rc[:, 1] + rng.uniform(0, 1, P)) * res,
        origin_xy[1] + (rc[:, 0] + rng.uniform(0, 1, P)) * res,
        rng.uniform(-np.pi, 1.3 * np.pi, P),
    ]).astype(np.float32)
    occ_tol = ism_occ_tol(res)
    ranges = rng.uniform(0.3, 4.0, B).astype(np.float32)
    near = np.arange(B) % 5 == 1
    ranges[near] = (sensor.min_range + rng.uniform(1e-4, occ_tol, near.sum())
                    ).astype(np.float32)
    ranges[4] = np.float32(sensor.min_range + occ_tol)
    ranges[6] = np.nextafter(np.float32(sensor.min_range), np.float32(1))
    ranges[3::29] = np.inf                              # invalid
    ranges[7::31] = np.float32(sensor.max_range)        # no hit
    ranges[11::37] = np.float32(0.5 * sensor.min_range)  # below min_range
    return dict(sensor=sensor, side=side, win=win, poses=poses,
                ranges=ranges, origin_xy=origin_xy, resolution=res)


def ism_edge_check(device) -> list:
    """Phase 3, kernel 1 ism on every pair of ism_edge_operands, on float32
    maps drawn from [-6, 6]: every cell as its plain version gives it."""
    checked = []
    for sensor_name in sorted(ISM_EDGE_SENSORS):
        for window in sorted(ISM_EDGE_WINDOWS):
            op = ism_edge_operands(sensor_name, window)
            side, win = op["side"], op["win"]
            poses = torch.as_tensor(op["poses"], device=device)
            rng = np.random.default_rng(SEED + side)
            maps = torch.as_tensor(
                rng.uniform(-6.0, 6.0, (poses.shape[0], side, side))
                .astype(np.float32), device=device,
            )
            kw = dict(
                occupancy.update_constants(
                    GridConfig(resolution=op["resolution"]), op["sensor"]),
                region=(win, win), origin_xy=op["origin_xy"],
            )
            ranges = torch.as_tensor(op["ranges"], device=device)
            a = update_ism(maps.clone(), poses, ranges, **kw)
            b = update_ism(maps.clone(), poses, ranges, plain=True, **kw)
            n_diff = int((a != b).sum())
            print(f"update_ism edge operands {sensor_name} {window} "
                  f"[{poses.shape[0]}, {win}x{win}] of [{side}x{side}]: "
                  f"{n_diff} cells differ (tolerance 0)")
            if n_diff:
                raise AssertionError(
                    f"update_ism on its {sensor_name} {window} edge operands "
                    "disagrees with its plain version")
            checked.append(f"{sensor_name} {window}")
    return checked


def apply_edge_operands(seed: int = 0) -> dict:
    """Numpy operands of the apply (kernel 8) at a small shape that holds
    the cases of its band split: maps [8, 128, 256] near the clamp, 4
    images of 48^2 (a window that is not a multiple of the kernel's 32-row
    band), anchors within win/2 of every edge and off the map (one image
    wholly off it), 180 beams whose live marks lie in each particle's
    window clamped into the map (pf/shared_update.py:endpoint_operands),
    among them marks on rows of that window the image does not cover, a
    cell hit by beams 5, 100 and 170, zero-weight beams on cells of live
    ones (one before its cell's first live beam), and a cell marked on
    either side of the band edge. Used here and by the CPU tests
    (tests/test_torch_shared_update.py)."""
    rng = np.random.default_rng(seed)
    P, H, W, win, G, B = 8, 128, 256, 48, 4, 180
    maps = rng.uniform(-9.7, 9.7, (P, H, W)).astype(np.float32)
    images = rng.uniform(-2.0, 2.0, (G, win, win)).astype(np.float32)
    anchors = np.array(
        [[10, 128], [120, 128], [64, 5], [64, 250], [-5, -7], [140, 300],
         [-60, 100], [64, 128]], np.int32,
    )
    slots = np.array([0, 1, 2, 3, 1, 0, 2, 3], np.int32)
    r0 = np.clip(anchors[:, 0] - win // 2, 0, H - win)
    c0 = np.clip(anchors[:, 1] - win // 2, 0, W - win)
    ep_r = r0[:, None] + rng.integers(0, win, (P, B))
    ep_c = c0[:, None] + rng.integers(0, win, (P, B))
    # rows of the clamped window that the image leaves uncovered
    ar = anchors[:, 0] - win // 2
    lo = np.clip(ar, r0, r0 + win)          # first covered row
    hi = np.clip(ar + win, r0, r0 + win)    # one past the last
    for p in range(P):
        free_rows = [r for r in range(r0[p], r0[p] + win)
                     if not lo[p] <= r < hi[p]]
        if free_rows:
            ep_r[p, 60:80] = rng.choice(free_rows, 20)
    ep_r[:, [100, 170]] = ep_r[:, [5, 5]]   # one cell, non-adjacent beams
    ep_c[:, [100, 170]] = ep_c[:, [5, 5]]
    ep_r[:, 2], ep_c[:, 2] = ep_r[:, 120], ep_c[:, 120]   # w = 0 first
    ep_r[:, 50], ep_c[:, 50] = ep_r[:, 5], ep_c[:, 5]     # w = 0 between
    ep_r[:, 30], ep_r[:, 31] = r0 + 31, r0 + 32             # band edge
    ep_c[:, 30] = ep_c[:, 31] = ep_c[:, 29]
    ep_w = np.full((P, B), 0.85, np.float32)
    ep_w[:, 3::11] = 0.3
    ep_w[:, [2, 50]] = 0.0
    ep_w[:, 17::29] = 0.0
    return dict(maps=maps, images=images, anchors=anchors, slots=slots,
                ep=(ep_r.astype(np.int32), ep_c.astype(np.int32), ep_w),
                win=win)


def apply_edge_check(device):
    """Phase 3, kernel 8 at apply_edge_operands' small shape, for maps and
    images in float32 and bfloat16 each: the kernel against its plain
    version, bit-exact. Returns the dtype pairs checked."""
    a = apply_edge_operands(SEED)
    to = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    anchors, slots = to(a["anchors"]), to(a["slots"])
    ep = [to(t) for t in a["ep"]]
    pairs = []
    for map_dt in (torch.float32, torch.bfloat16):
        for img_dt in (torch.float32, torch.bfloat16):
            maps = to(a["maps"]).to(map_dt)
            images = to(a["images"]).to(img_dt)
            out = [shared_apply(maps.clone(), anchors, slots, images, 10.0,
                                *ep, plain=plain) for plain in (False, True)]
            if not torch.equal(*out):
                raise AssertionError(
                    f"shared_apply disagrees with its plain version on the "
                    f"edge operands, maps {map_dt}, images {img_dt}"
                )
            pairs.append(f"{str(map_dt)[6:]} maps, {str(img_dt)[6:]} images")
    print(f"shared_apply edge operands {list(a['maps'].shape)}, win "
          f"{a['win']}: bit-exact for {', '.join(pairs)}")
    return pairs


def apply_check(cfg, pf, log, device):
    """Phase 3, kernel 8: the shared update's apply at FastSLAM-1000's
    shapes (1000 bf16 512^2 maps, 16 float32 256^2 images, 180 beams),
    with real images and endpoint marks of a scan; bit-exact."""
    g, s = cfg.grid, cfg.sensor
    P, H, W = pf.n_particles, g.height, g.width
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    maps = (torch.rand((P, H, W), generator=gen, device=device) * 12 - 6).to(
        getattr(torch, pf.map_dtype)
    )
    i = len(log["odom"]) // 2
    ranges = torch.as_tensor(log["ranges"][i], device=device)
    # a cloud around the log's pose, and a tenth of the particles all over
    # the map, so that images run off every edge
    rng = np.random.default_rng(SEED + 3)
    poses = np.tile(log["gt_poses"][i], (P, 1)).astype(np.float64)
    poses[:, :2] += rng.normal(0, 0.3, (P, 2))
    poses[:, 2] += rng.normal(0, 0.1, P)
    far = P // 10
    poses[:far, :2] = rng.uniform(0, g.width * g.resolution, (far, 2)) + (
        g.origin_x, g.origin_y
    )
    poses = torch.as_tensor(poses.astype(np.float32), device=device)
    win = min(update_window_cells(g, s), H, W)
    anchors, slot, images, ep = apply_operands(poses, ranges, cfg, pf, H, W)

    def apply(m, plain):
        return shared_apply(m, anchors, slot, images, float(g.l_clamp), *ep,
                            plain=plain)

    edge_pairs = apply_edge_check(device)
    a, b = apply(maps.clone(), False), apply(maps.clone(), True)
    same = torch.equal(a, b)
    print(f"shared_apply [{P}, {H}x{W}] {pf.map_dtype} maps, images "
          f"{list(images.shape)} {images.dtype}, {ep[0].shape[1]} beams: "
          f"bit-exact {same}")
    if not same:
        raise AssertionError("shared_apply disagrees with its plain version")
    del a, b
    ar = anchors.cpu().numpy().astype(np.int64) - win // 2
    rows = np.clip(ar[:, 0] + win, 0, H) - np.clip(ar[:, 0], 0, H)
    cols = np.clip(ar[:, 1] + win, 0, W) - np.clip(ar[:, 1], 0, W)
    on_map = int((rows * cols).sum())
    scratch = maps.clone()
    return dict(
        max_abs_err=0.0, tolerance="bit-exact",
        shape=[P, H, W, win], edge_operands_checked=edge_pairs,
        # each window's cells on the map read and written once, the images
        # and the endpoint operands read once; an add and a clip a cell
        **_times(lambda: apply(scratch, False), lambda: apply(scratch, True),
                 _bound(2 * on_map * maps.element_size()
                        + images.numel() * images.element_size()
                        + 12 * ep[0].numel() + 12 * P, 3 * on_map)),
    )


def corr_check(cfg, pf, log, device, frontend):
    """Phase 3, kernel 5: the per-particle refine's correlation at
    FastSLAM-16's shapes (E [16, 9, 288^2] bf16, Sp [16, 293^2]), with real
    splats of a scan and fields of random maps; beside it one grouped
    conv2d (TF32 off) computing the same function."""
    g, s = cfg.grid, cfg.sensor
    P, res = pf.n_particles, g.resolution
    mcfg = fastslam.refine_matcher(cfg, pf)
    win = scan_window_cells(g, s, mcfg)
    R = 2 * int(round(mcfg.search_xy / res)) + 1
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    maps = (torch.rand((P, g.height, g.width), generator=gen, device=device)
            * 12 - 6).to(getattr(torch, pf.map_dtype))
    i = len(log["odom"]) // 2
    ranges = torch.as_tensor(log["ranges"][i], device=device)
    priors = torch.as_tensor(log["gt_poses"][i], device=device) + 0.02 * (
        torch.randn((P, 3), generator=gen, device=device)
    )
    S, origin_xy = fastslam.per_particle_fields(maps, priors, cfg, mcfg)
    # kernel 6 at this path's shape: float32 fields at clamped origins
    size, origins, _ = fastslam.per_particle_windows(
        priors, cfg, mcfg, g.height, g.width
    )
    taps, fkw = _field_args(mcfg, res)
    field_entry = _field_entry(maps, origins, size, taps, torch.float32, fkw)
    pts, valid = occupancy.scan_endpoints_local(ranges, s)
    dth = torch.as_tensor(correlative._theta_offsets(mcfg), device=device)
    pos = correlative.endpoint_positions_batched(
        priors, pts, valid, dth[None, :].expand(P, -1), res, origin_xy
    )
    sp = correlative.splat_inputs(S.shape[1:], *pos, valid, R, R, True)
    E = correlative.splat_image(*sp, S.shape[1:], torch.bfloat16)
    Sp = F.pad(S, (0, R, 0, R)).contiguous()
    err, out = _corr_check(E, Sp, R, "FastSLAM-16 refine")
    per_call = _device_activities(lambda: corr_scores(E, Sp, R, R),
                                  "corr_kernel")
    print(f"corr_scores device activities a call: {per_call}")

    Ef = E.float()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_err = float((_conv_corr(Ef, Sp, R) - out).abs().max())
        print(f"conv2d (TF32 off) on the same inputs: max |diff| {lib_err:.3g}")
        times = _times(
            lambda: corr_scores(E, Sp, R, R),
            lambda: corr_scores(E, Sp, R, R, plain=True),
            corr_bound(E, Sp, R), library=lambda: _conv_corr(Ef, Sp, R),
        )
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return dict(
        max_abs_err=err, tolerance=f"{CORR_RTOL} x sum|E| x max|Sp| per (p, t)",
        same_bits_twice=True, device_kernels_per_call=sum(per_call.values()),
        edge_operands_checked=corr_edge_check(device),
        library_call="torch.nn.functional.conv2d, groups=P, "
                     "cudnn.allow_tf32=False, E widened to float32 beforehand",
        library_max_abs_diff=lib_err, shape=list(E.shape) + [R, R],
        frontend_passes=frontend, field=field_entry, **times,
    )


def _device_activities(fn, kernel: str, n: int = 20) -> dict:
    """{device activity name: count a call} of `fn`, from a torch.profiler
    trace of `n` calls (kernels, copies and fills alike), which must hold
    the kernel whose name contains `kernel` once a call and nothing else.
    Any other activity, or more than `n` of the kernel, fails at once. A
    trace with fewer than `n` (records lost in spite of _device_events'
    edge spins) is taken again, at most three times."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        counts = {}
        for e in _device_events(fn, n):
            counts[e.name] = counts.get(e.name, 0) + 1
        per_call = {k: v / n for k, v in counts.items()}
        mine = sum(v for k, v in counts.items() if kernel in k)
        if mine > n or any(kernel not in k for k in counts):
            raise AssertionError(f"{kernel}: {per_call} device activities a "
                                 "call, expected the one kernel")
        if mine == n:
            return per_call
    raise AssertionError(f"{kernel}: {mine} records of {n} calls in each of "
                         "three traces")


def ray_check(cfg, log, device):
    """Phase 3, kernel 1 "ray": the exact-ray update of bench.py's 520^2
    update window. The kernel builds its beam tables and clips each tile's
    beams itself; it must agree bit for bit with the plain version, which
    reads the tables of ray_tables and sums every chunk. One device
    activity a call."""
    g, m, s = cfg.grid, cfg.matcher, cfg.sensor
    rng = np.random.default_rng(SEED + 5)
    uwin = update_window_cells(g, s, m)
    i = len(log["odom"]) // 2
    pose = torch.as_tensor(np.asarray(log["gt_poses"][i], np.float32),
                           device=device)
    ranges = torch.as_tensor(log["ranges"][i], device=device)
    full = torch.as_tensor(
        rng.uniform(-6.0, 6.0, (g.height, g.width)).astype(np.float32),
        device=device,
    )
    center = occupancy.world_to_cell(pose[:2], g).tolist()
    gw, origin_rc = extract_window(full, center, uwin)

    def update(plain):
        return occupancy.integrate_scan(
            gw, pose, ranges, g, s, origin_rc=origin_rc, plain=plain
        )

    a, b = update(False), update(True)
    same = torch.equal(a, b)
    print(f"update_ray [{uwin}x{uwin}]: bit-exact {same} "
          f"({int((a != gw).sum())} cells updated)")
    if not same:
        d = (a - b).abs()
        print(f"update_ray: {int((d != 0).sum())} cells differ, max "
              f"{float(d.max()):.3g}")
        raise AssertionError("update_ray disagrees with its plain version")
    per_call = _device_activities(lambda: update(False), "update_ray_kernel")
    print(f"update_ray device activities a call: {per_call}")
    B = ranges.numel()
    # the touched (cell, beam) pairs: a chord crosses at most
    # (|dx| + |dy|) * r_free / res + 2 cells
    r_free = torch.clamp(ranges.clamp(max=s.max_range) - g.resolution, min=0)
    pairs = float((r_free / g.resolution * 1.5 + 2).sum())
    return dict(
        max_abs_err=0.0, tolerance="bit-exact",
        shape=[uwin, uwin], device_kernels_per_call=sum(per_call.values()),
        # the window read and written once, the scan and its angles read
        # once, the pose; the chord (16 operations) of every touched pair,
        # ~10 a cell
        **_times(lambda: update(False), lambda: update(True),
                 _bound(2 * gw.numel() * 4 + 8 * B + 12,
                        16 * pairs + 10 * gw.numel())),
    )


def ray_window_check(cfg, log, device):
    """Phase 3, the frontend step's form of kernel 1 `ray`
    (update_ray_window: in place on the 520^2 update window, the gate and
    the window origin read from device memory), at origins clamped into
    each corner of the 1024^2 map and inside it (the log's middle scan),
    each with gate 1 against its plain version and against the
    host-origin path (extract_window, the out-of-place kernel,
    write_window): 0 cells off (the kernel is bit-exact); with gate 0 the
    map bit-identical. Timed as phase 3 times the kernels (gate 1), with
    the gate-0 launch's device time beside it. Kernel 1 `ism`'s form
    (update_ism with origin=, the frontend's update_impl="pallas") at the
    same origins and gates against its plain version: at gate 1 at most
    0.05% of the window's cells off, each by one l_free or l_occ, and
    nothing outside the window; at gate 0 both maps bit-identical. At the
    interior origin it is also held to the pose-placed launch of the same
    window: the same bits. Returns (the `ray` entry, the `ism` form's)."""
    rng = np.random.default_rng(SEED + 12)
    g, m, s = cfg.grid, cfg.matcher, cfg.sensor
    H, W = g.height, g.width
    uwin = update_window_cells(g, s, m)
    i = len(log["odom"]) // 2
    scan_pose = np.asarray(log["gt_poses"][i], np.float32)
    ranges = torch.as_tensor(log["ranges"][i], device=device)
    full = torch.as_tensor(
        rng.uniform(-6.0, 6.0, (H, W)).astype(np.float32), device=device)
    on, off = (torch.tensor(v, device=device) for v in (True, False))
    res = np.float32(g.resolution)
    centers = dict(GATED_CENTERS)
    centers["interior"] = tuple(int(v) for v in occupancy.world_to_cell(
        torch.as_tensor(scan_pose[:2]), g).tolist())
    ism_cfg = dataclasses.replace(g, update_impl="pallas")
    checked, off_plain, ism_off, ism_err = [], 0, 0, 0.0
    for name, (row, col) in centers.items():
        pose = torch.tensor(
            [np.float32(g.origin_x) + (np.float32(col) + np.float32(0.5)) * res,
             np.float32(g.origin_y) + (np.float32(row) + np.float32(0.5)) * res,
             scan_pose[2]], dtype=torch.float32, device=device)
        center = occupancy.world_to_cell(pose[:2], g)
        origin = window_origin_t(center, uwin, H, W)
        orc = tuple(origin.tolist())
        for gate in (on, off):
            a, b = full.clone(), full.clone()
            for plain, m_ in ((False, a), (True, b)):
                occupancy.integrate_scan_window(
                    m_, pose, ranges, g, s, origin=origin, size=(uwin, uwin),
                    gate=gate, plain=plain)
            today = full.clone()
            if bool(gate):
                gw, _ = extract_window(today, center.tolist(), uwin)
                write_window(today, occupancy.integrate_scan(
                    gw, pose, ranges, g, s, origin_rc=orc), orc)
            n_host, n_plain = int((a != today).sum()), int((a != b).sum())
            off_plain += n_plain
            print(f"ray window {name} origin {orc} gate {int(gate)}: "
                  f"{n_host} cells off the host-origin path, {n_plain} off "
                  "plain")
            if n_host or n_plain:
                raise AssertionError(f"update_ray window {name}: the in-place "
                                     "form parts from the host-origin path "
                                     "or its plain version")
            if not bool(gate) and not torch.equal(a, full):
                raise AssertionError(f"update_ray window {name}: gate 0 "
                                     "changed the map")
            # kernel 1 `ism` at the same device origin and gate
            a, b = full.clone(), full.clone()
            for plain, m_ in ((False, a), (True, b)):
                occupancy.integrate_scan_window(
                    m_, pose, ranges, ism_cfg, s, origin=origin,
                    size=(uwin, uwin), gate=gate, plain=plain)
            if not bool(gate):
                kept = torch.equal(a, full) and torch.equal(b, full)
                print(f"ism window {name} origin {orc} gate 0: both maps "
                      f"bit-identical {kept}")
                if not kept:
                    raise AssertionError(f"update_ism window {name}: gate 0 "
                                         "changed the map")
                continue
            win_sl = (slice(orc[0], orc[0] + uwin),
                      slice(orc[1], orc[1] + uwin))
            outside = a != b
            outside[win_sl] = False
            if outside.any():
                raise AssertionError(f"update_ism window {name}: cells "
                                     "outside the window differ")
            n_diff, err = _cells_exact(a[win_sl], b[win_sl],
                                       f"update_ism window {name}")
            print(f"ism window {name} origin {orc} gate 1: {n_diff} of "
                  f"{uwin * uwin} cells off plain (tolerance 0)")
            ism_off, ism_err = ism_off + n_diff, max(ism_err, err)
        checked.append(name)

    pose = torch.as_tensor(scan_pose, device=device)
    origin = window_origin_t(occupancy.world_to_cell(pose[:2], g), uwin, H, W)
    buf = full.clone()

    def upd(gate, plain=False):
        return occupancy.integrate_scan_window(
            buf, pose, ranges, g, s, origin=origin, size=(uwin, uwin),
            gate=gate, plain=plain)

    B = ranges.numel()
    r_free = torch.clamp(ranges.clamp(max=s.max_range) - g.resolution, min=0)
    pairs = float((r_free / g.resolution * 1.5 + 2).sum())
    n_cells = uwin * uwin
    ray = dict(
        shape=[uwin, uwin], in_place_of=[H, W], origins_checked=checked,
        cells_off_host_origin_path=0, cells_off_plain=off_plain,
        max_abs_err=0.0, tolerance="bit-exact",
        gate_off_device_ms=_cuda_device_ms(lambda: upd(off))[0],
        # ray_check's bound: the window read and written once, the scan,
        # its angles and the pose read once; ~16 operations a touched
        # (cell, beam) pair and ~10 a cell
        **_times(lambda: upd(on), lambda: upd(on, True),
                 _bound(2 * n_cells * 4 + 8 * B + 12 + 9,
                        16 * pairs + 10 * n_cells)),
    )

    # kernel 1 `ism` at a device origin against its pose-placed launch
    consts = occupancy.update_constants(ism_cfg, s)
    a, b = full.clone(), full.clone()
    occupancy.integrate_scan_window(a, pose, ranges, ism_cfg, s,
                                    origin=origin, size=(uwin, uwin),
                                    gate=on)
    update_ism(b[None], pose[None], ranges, region=(uwin, uwin),
               origin_xy=(g.origin_x, g.origin_y), **consts)
    same = torch.equal(a, b)
    c = full.clone()
    occupancy.integrate_scan_window(c, pose, ranges, ism_cfg, s,
                                    origin=origin, size=(uwin, uwin),
                                    gate=off)
    kept = torch.equal(c, full)
    print(f"update_ism window at {tuple(origin.tolist())}: the pose-placed "
          f"launch's bits {same}, gate 0 bit-identical {kept}")
    if not (same and kept):
        raise AssertionError("update_ism: the frontend's window form "
                             "misbehaves")
    ism = dict(shape=[uwin, uwin], in_place_of=[H, W], origins_checked=checked,
               cells_off_plain=ism_off, max_abs_err=ism_err,
               tolerance="bit-exact; gate 0 bit-identical",
               same_bits_as_pose_placed=same, gate_off_kept=kept)
    return ray, ism


PARTICLE_PLAIN_RUNS = 3  # phase 3: lone calls timed for the plain loop of
                         # the particle-batched kernel 1 forms (P windows)


def particle_update_checks(cfg, pf, log, device, seed: int):
    """Phase 3, the particle filter's forms of kernels 1 `hybrid` and `ray`
    (ops/update.py:update_hybrid_particles, update_ray_particles): every
    particle's update window of a [P, H, W] stack of pf.map_dtype maps in
    one launch, at the window and pitch that cfg's FastSLAM gives them,
    with poses all over the map so that windows clamp at every edge,
    against the plain version (a loop over the particles of the
    single-window plain function on each particle's tables): `ray` bit for
    bit, `hybrid` with at most 0.05% of the cells off by one l_free or
    l_occ (the bearing is atan2_ref on both sides, so only the card's sinf
    and cosf, moving an endpoint across a cell edge, can part them). Each
    form is timed, and timed again at a device gate of 0, which must leave
    the maps bit-identical. Returns {name: entry}."""
    rng = np.random.default_rng(seed)
    g, s = cfg.grid, cfg.sensor
    P, res = pf.n_particles, g.resolution
    mdt = getattr(torch, pf.map_dtype)
    maps = torch.as_tensor(
        rng.uniform(-6.0, 6.0, (P, g.height, g.width)).astype(np.float32),
        device=device,
    ).to(mdt)
    ranges = torch.as_tensor(log["ranges"][len(log["odom"]) // 3],
                             device=device)
    uwin = update_window_cells(g, s)
    xy = rng.uniform(0.0, g.width * res, (P, 2)) + (g.origin_x, g.origin_y)
    poses = torch.as_tensor(
        np.column_stack([xy, rng.uniform(-np.pi, np.pi, P)]).astype(np.float32),
        device=device,
    )
    angles = occupancy.beam_angles(s, device)
    consts = occupancy.update_constants(g, s)
    kw = dict(region=(uwin, uwin), origin_xy=(g.origin_x, g.origin_y))

    def hybrid(m, plain, gate=None):
        return update_hybrid_particles(m, poses, ranges, angles, plain=plain,
                                       gate=gate, **kw, **consts)

    def ray(m, plain, gate=None):
        return update_ray_particles(
            m, poses, ranges, angles, resolution=res, min_range=s.min_range,
            max_range=s.max_range, angle_min=s.angle_min,
            step=consts["step"], l_free=g.l_free, l_occ=g.l_occ,
            l_clamp=g.l_clamp, ray_samples=g.ray_samples, plain=plain,
            gate=gate, **kw)

    B = ranges.numel()
    cells = P * uwin * uwin
    window_bytes = 2 * cells * maps.element_size() + 8 * B + 12 * P
    r_free = torch.clamp(ranges.clamp(max=s.max_range) - res, min=0)
    pairs = float((r_free / res * 1.5 + 2).sum()) * P
    gate0 = torch.zeros(1, dtype=torch.bool, device=device)
    results = {}
    for name, fn, bound in (
        # every window read and written once in the map dtype, the scan,
        # the angles and the poses; ~30 operations a cell
        ("update_hybrid_particles", hybrid, _bound(window_bytes, 30 * cells)),
        # the chord (16 operations) of every touched (cell, beam) pair,
        # ~10 a cell (ray_check's count, for P windows)
        ("update_ray_particles", ray,
         _bound(window_bytes, 16 * pairs + 10 * cells)),
    ):
        a, b = fn(maps.clone(), False), fn(maps.clone(), True)
        if name == "update_ray_particles":
            n_diff = int((a != b).sum())
            err = float((a.float() - b.float()).abs().max())
            tol = "bit-exact"
            if n_diff:
                raise AssertionError(f"{name}: {n_diff} cells differ from "
                                     "its plain version")
        else:
            n_diff, err = _map_cells_ok(a, b, g, name)
            tol = "<=0.05% of window cells, each by one l_free or l_occ"
        print(f"{name} [{P}, {uwin}x{uwin}] of {pf.map_dtype} "
              f"[{g.height}x{g.width}] maps: {n_diff} cells differ "
              f"(tolerance: {tol}; {int((a != maps).sum())} cells updated)")
        scratch = maps.clone()
        times = _times(lambda: fn(scratch, False), lambda: fn(scratch, True),
                       bound, plain_runs=PARTICLE_PLAIN_RUNS)
        before = scratch.clone()
        gate0_ms, gate0_by = _cuda_device_ms(
            lambda: fn(scratch, False, gate0))
        if not _same_bits(scratch, before):
            raise AssertionError(f"{name}: a gate of 0 changed the maps")
        results[name] = dict(
            max_abs_err=err, cells_differing=n_diff, tolerance=tol,
            shape=[P, uwin, uwin], map_dtype=pf.map_dtype,
            gate0_device_ms=gate0_ms, gate0_device_by=gate0_by, **times)
        print(f"{name}: ms {times['ms']:.4g}, device_ms "
              f"{times['device_ms']:.4g} ({times['device_by']}), plain_ms "
              f"{times['plain_ms']:.4g}, bound_ms {times['bound_ms']:.4g} "
              f"({times['bound_by']}), gate 0 device_ms {gate0_ms:.4g} "
              f"({gate0_by}, the maps bit-identical)")
        del before, scratch
    return results


def _pf_counters():
    return {
        "update_ism": update_ism,
        "window_field": window_field,
        "shift_stack": shift_stack,
        "gather_rows": gather_rows,
        "shared_apply": shared_apply,
        "corr_scores": corr_scores,
    }


def _reset_pf_counts():
    for fn in _pf_counters().values():
        fn.launches = 0
    for name in ("host_syncs", "refines", "updates", "resamples"):
        setattr(fastslam.fastslam_step, name, 0)


def _pf_expected(cfg, pf, counts):
    """The launches of each PF kernel that the gate decisions call for,
    as the refine and update modes resolve at this particle count."""
    P = pf.n_particles
    mcfg = fastslam.refine_matcher(cfg, pf)
    shared_refine = fastslam._resolve_refine_mode(pf, mcfg, P) == "shared"
    mode = pf.update_mode
    if mode == "auto":
        mode = "shared" if P >= pf.update_shared_min_particles else "per_particle"
    r_fine = int(round(mcfg.search_xy / cfg.grid.resolution))
    passes = 1 if r_fine <= mcfg.coarse_factor else 2
    return {
        # the shared update builds its images with one ISM launch
        "update_ism": counts["updates"],
        "window_field": counts["refines"],
        "shift_stack": counts["refines"] if shared_refine else 0,
        "gather_rows": counts["resamples"],
        "shared_apply": counts["updates"] if mode == "shared" else 0,
        "corr_scores": 0 if shared_refine else passes * counts["refines"],
    }


def run_pf(cfg, pf, log, device, label):
    """Phases 6, 8 and 10: FastSLAM over the whole bench_pf log through
    the kernels, host-gated (host_gated=True; phase 23 runs the device-gated
    graph), every launch counted against the gate decisions. Returns the
    launches of the kernels the path runs, the ATE and the scans/s."""
    warm = {k: np.asarray(v)[:64] for k, v in log.items()}
    run_fastslam(warm, cfg, pf, device, seed=SEED, host_gated=True)
    torch.cuda.synchronize()

    _reset_pf_counts()
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    _, traj, n_eff, _ = run_fastslam(log, cfg, pf, device, seed=SEED,
                                     host_gated=True)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _pf_counters().items()}
    step = fastslam.fastslam_step
    counts = dict(
        host_syncs=step.host_syncs, refines=step.refines,
        updates=step.updates, resamples=step.resamples,
    )
    T = len(traj)

    if not (np.isfinite(traj).all() and np.isfinite(n_eff).all()):
        raise AssertionError(f"{label}: trajectory or N_eff is not finite")
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    expect = _pf_expected(cfg, pf, counts)
    elapsed = start.elapsed_time(end) / 1e3
    result = dict(
        scans=T, particles=pf.n_particles, map_dtype=pf.map_dtype,
        scans_per_sec=T / elapsed, seconds_cuda_events=elapsed,
        seconds_host=wall, ate_m=ate, ate_odom_m=ate_odom,
        host_reads_per_scan=counts["host_syncs"] / T, launches=launches,
        min_n_eff=float(n_eff.min()),
        peak_memory_bytes=torch.cuda.max_memory_allocated(device), **counts,
    )
    print(f"{label}:", json.dumps(result))
    if not ate <= PF_MAX_ATE_M:
        raise AssertionError(f"{label}: ATE {ate} m above {PF_MAX_ATE_M} m")
    if counts["resamples"] < 1:
        raise AssertionError(f"{label}: no resample event")
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected {expect}")
    if counts["host_syncs"] > counts["refines"]:
        raise AssertionError(f"{label}: more than one host read per refine")
    return ({k: v for k, v in launches.items() if expect[k] > 0}, ate,
            result["scans_per_sec"])


def pf_parity(cfg, pf, log, device, gate: int, n_events: int, label,
              after_boot: bool = False):
    """Phases 7, 9 and 10: at each of the first `n_events` scans whose gate
    column `gate` fires (0 refine, 1 update; after the bootstrap if asked),
    the same state and the same draws through the kernel step and through
    the plain step: poses, log-weights and maps must agree."""
    odom = torch.as_tensor(np.asarray(log["odom"], np.float32), device=device)
    ranges = torch.as_tensor(np.asarray(log["ranges"], np.float32), device=device)
    flags = fastslam.host_gate_flags(
        log["odom"], cfg, log["odom"][0], 0.0, np.inf, 0.0
    )
    fire = flags[:, gate] & (~flags[:, 2] if after_boot else True)
    events = set(np.nonzero(fire)[0][:n_events].tolist())
    last = max(events) + 1
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    P = pf.n_particles
    noise = torch.randn((last, P, 3), generator=gen, device=device)
    u = torch.rand(last, generator=gen, device=device)
    state = fastslam.fastslam_init(cfg, pf, device, start_pose=log["odom"][0])
    worst = dict(pose=0.0, log_w=0.0, score=0.0, cells=0)
    for t in range(last):
        kw = dict(gates=flags[t], noise=noise[t], u=u[t])
        if t in events:
            twin = state._replace(logodds=state.logodds.clone())
            ref, (_, _, ref_sc) = fastslam.fastslam_step(
                twin, odom[t], ranges[t], cfg, pf, plain=True, **kw
            )
        state, (_, _, sc) = fastslam.fastslam_step(
            state, odom[t], ranges[t], cfg, pf, **kw
        )
        if t in events:
            dpose = (state.poses - ref.poses).abs()
            dpose[:, 2] = torch.remainder(dpose[:, 2] + np.pi, 2 * np.pi) - np.pi
            worst["pose"] = max(worst["pose"], float(dpose.abs().max()))
            worst["log_w"] = max(
                worst["log_w"], float((state.log_w - ref.log_w).abs().max())
            )
            worst["score"] = max(worst["score"], abs(float(sc - ref_sc)))
            cells, _ = _map_cells_ok(
                state.logodds, ref.logodds, cfg.grid, f"{label}: maps at scan {t}"
            )
            worst["cells"] = max(worst["cells"], cells)
            del twin, ref
    what = ("refine", "update")[gate]
    print(f"{label}: plain-version FastSLAM steps at the first {n_events} "
          f"{what} events{' after the bootstrap' if after_boot else ''} "
          f"(scans {min(events)}-{last - 1}): max |dpose| {worst['pose']:.3g}, "
          f"max |dlog_w| {worst['log_w']:.3g}, max |dscore| "
          f"{worst['score']:.3g}, at most {worst['cells']} map cells differ "
          f"(tolerance {PF_POSE_TOL} m and rad, {PF_LOGW_TOL}, "
          f"{MAP_CELL_SHARE:.2%} of cells)")
    if worst["pose"] > PF_POSE_TOL or worst["log_w"] > PF_LOGW_TOL:
        raise AssertionError(f"{label}: kernel and plain FastSLAM steps disagree")
    return worst


def corr_held_runs(cfg, pf, log, device, ate):
    """Phase 10: FastSLAM-16's run twice more. First with every call of
    kernel 5 also made through its plain version on the same inputs: each
    must lie within corr_tolerance of it, and the calls and particles whose
    best candidate (the first maximum over thetas and lags of the raw
    scores) differs between the two are counted. Then with the plain
    version in place of the kernel. Each run's ATE beside `ate`, the
    measured run's: the two sum orders give two filters, both of which
    must stay within PF_MAX_ATE_M."""
    held = dict(calls=0, calls_best_differs=0, particles_best_differs=0,
                max_err_over_tolerance=0.0)

    def checked(E, Sp, R, C, plain=False, gate=None):
        out = corr_scores(E, Sp, R, C, gate=gate)
        ref = corr_scores(E, Sp, R, C, plain=True, gate=gate)
        over = float(((out - ref).abs() / corr_tolerance(E, Sp)).max())
        P = E.shape[0]
        best = out.reshape(P, -1).argmax(1) != ref.reshape(P, -1).argmax(1)
        n_best = int(best.sum())
        held["calls"] += 1
        held["calls_best_differs"] += int(n_best > 0)
        held["particles_best_differs"] += n_best
        held["max_err_over_tolerance"] = max(held["max_err_over_tolerance"],
                                             over)
        return out

    def plain(E, Sp, R, C, plain=False, gate=None):
        return corr_scores(E, Sp, R, C, plain=True, gate=gate)

    ates = {}
    try:
        for name, fn in (("held", checked), ("plain", plain)):
            correlative.corr_scores = fn
            _, traj, _, _ = run_fastslam(log, cfg, pf, device, seed=SEED,
                                         host_gated=True)
            if not np.isfinite(traj).all():
                raise AssertionError(f"fastslam-16 {name} run: not finite")
            ates[name] = ate_rmse(traj, log["gt_poses"], align=False)
    finally:
        correlative.corr_scores = corr_scores
    result = dict(ate_m=ate, ate_m_held_run=ates["held"],
                  ate_m_plain_run=ates["plain"], **held)
    print("fastslam-16, kernel 5 held to its plain version at every call:",
          json.dumps(result))
    if held["max_err_over_tolerance"] > 1.0:
        raise AssertionError("fastslam-16: a correlation call of the run "
                             "disagrees with its plain version")
    if max(ates.values()) > PF_MAX_ATE_M:
        raise AssertionError(f"fastslam-16: ATE {ates} m above {PF_MAX_ATE_M} m")
    return result


RAY_GRAPH_SCANS = 256   # phase 11: the ISM and dense frontends' scans


def _frontend_run(cfg, log, device, graph, counters):
    """run_frontend over `log` with the counts set to 0 just before it:
    (traj, scores, final state, dict of launches, counters and times)."""
    for fn in counters.values():
        fn.launches = 0
    for name in ("host_syncs", "matches", "updates"):
        setattr(frontend_step, name, 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, traj, scores = run_frontend(log, cfg, device, graph=graph)
    end.record()
    end.synchronize()
    elapsed = start.elapsed_time(end) / 1e3
    return traj, scores, state, dict(
        scans=len(traj), scans_per_sec=len(traj) / elapsed,
        seconds_cuda_events=elapsed,
        launches={k: fn.launches for k, fn in counters.items()},
        host_syncs=frontend_step.host_syncs, matches=frontend_step.matches,
        updates=frontend_step.updates)


def run_ray(cfg, log, device, hybrid_ate):
    """Phase 11: the frontend with update_impl="pallas_ray" over bench.py's
    log through the kernels, as run_frontend runs it on CUDA (one
    ChunkGraph replay a chunk: kernel 1 `ray` in place with its gate and
    window origin on the device), then the same steps eagerly: no host
    read a scan, the eager run's bits, one `ray` and one search-space
    launch a scan run (+1 build at the start) and two scorer launches;
    then the first RAY_GRAPH_SCANS scans with update_impl "pallas" (kernel
    1 `ism`'s window form) and "dense" through the graph and eagerly: the
    same bits, no host read. Returns {path: launches}."""
    counters = {"update_ray": update_ray, "update_ism": update_ism,
                "update_hybrid": update_hybrid, "search_space": search_space,
                "score_offsets": score_window}
    warm = {k: np.asarray(v)[: cfg.chunk] for k, v in log.items()}
    t0 = time.perf_counter()
    run_frontend(warm, cfg, device)   # builds the chunk graph
    capture_s = time.perf_counter() - t0
    run_frontend(warm, cfg, device, graph=False)
    torch.cuda.synchronize()
    traj, scores, _, res = _frontend_run(cfg, log, device, None, counters)
    traj_e, scores_e, _, eager = _frontend_run(cfg, log, device, False,
                                               counters)
    if not np.isfinite(traj).all():
        raise AssertionError("ray frontend: trajectory is not finite")
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    same = bool(np.array_equal(traj, traj_e)
                and np.array_equal(scores, scores_e))
    T = len(traj)
    scans_run = -(-T // cfg.chunk) * cfg.chunk
    res.update(ate_m=ate, ate_odom_m=ate_odom, ate_hybrid_m=hybrid_ate,
               capture_s=capture_s, host_reads_per_scan=res["host_syncs"] / T,
               eager_scans_per_sec=eager["scans_per_sec"],
               eager_launches=eager["launches"], same_bits_as_eager=same)
    print("ray frontend:", json.dumps(res))
    expect = {"update_ray": scans_run, "update_ism": 0, "update_hybrid": 0,
              "search_space": scans_run + 1, "score_offsets": 2 * scans_run}
    for r in (res, eager):
        if r["launches"] != expect:
            raise AssertionError(f"ray frontend: launches {r['launches']}, "
                                 f"expected {expect}")
        if r["host_syncs"]:
            raise AssertionError("ray frontend: the host read during the "
                                 "scans")
    if not same:
        raise AssertionError("ray frontend: the graph and eager runs differ")
    if (res["matches"], res["updates"]) != (eager["matches"],
                                            eager["updates"]):
        raise AssertionError("ray frontend: device counters differ")
    if not ate <= PF_MAX_ATE_M:
        raise AssertionError(f"ray frontend: ATE {ate} m above {PF_MAX_ATE_M} m")
    paths = {"11 ray frontend": {"update_ray": res["launches"]["update_ray"]}}

    part = {k: np.asarray(v)[:RAY_GRAPH_SCANS] for k, v in log.items()}
    for impl, kernel in (("pallas", "update_ism"), ("dense", None)):
        c = dataclasses.replace(
            cfg, grid=dataclasses.replace(cfg.grid, update_impl=impl))
        run_frontend(warm, c, device)
        t, sc, st, r = _frontend_run(c, part, device, None, counters)
        t_e, sc_e, st_e, r_e = _frontend_run(c, part, device, False,
                                             counters)
        same = bool(np.array_equal(t, t_e) and np.array_equal(sc, sc_e)
                    and torch.equal(st.logodds, st_e.logodds))
        r.update(update_impl=impl, same_bits_as_eager=same,
                 eager_scans_per_sec=r_e["scans_per_sec"])
        print(f"{impl} frontend, {RAY_GRAPH_SCANS} scans:", json.dumps(r))
        want = {k: 0 for k in ("update_ray", "update_ism", "update_hybrid")}
        if kernel:
            want[kernel] = RAY_GRAPH_SCANS
        got = {k: r["launches"][k] for k in want}
        if not same or r["host_syncs"] or r_e["host_syncs"] or got != want:
            raise AssertionError(f"{impl} frontend: graph bits {same}, "
                                 f"launches {got} (expected {want}), host "
                                 f"reads {r['host_syncs']}")
        if kernel:
            paths[f"11 {impl} frontend"] = {kernel: got[kernel]}
    return paths


def fullslam_kernel_checks(cfg, gcfg, log, device, tcfg=None, tag=""):
    """Phase 3 at full SLAM's shapes, each kernel against its plain version
    with seeded random maps: kernel 1 `hybrid` on a whole loop-attempt
    submap (default_submap_grid: 1152^2 at 0.05 m, a scan at its pose
    relative to an anchor keyframe) and on the rebuild window (without
    `tcfg`: the 496^2 update_window_cells of the 1024^2 map; with a
    TileConfig `tcfg`: the tiled window of tracking and rebuild,
    tiled_window_cells, at the tiles' resolution, its origin rounded as
    the tiled step's); kernel 3 on the submap with the loop matcher's blur
    (and with `tcfg` on the tiled window with the tracking matcher's);
    kernel 2's loop-matcher passes, coarse rounded over the pooled submap
    and fine bilinear over the submap (at 0.05 m [41, 9, 9] over 144^2 and
    [5, 17, 17] over 1152^2), and with `tcfg` the tracking match's passes
    over the tiled window. Entry names start with `tag`. Returns {kernel:
    {shape name: entry}}."""
    rng = np.random.default_rng(SEED + 15)
    g, s = cfg.grid, cfg.sensor
    sub = default_submap_grid(cfg)
    lm = default_loop_matcher(gcfg)
    i = len(log["odom"]) // 2
    gt = np.asarray(log["gt_poses"], np.float32)
    pose = torch.as_tensor(np.asarray(_np_between(gt[i - 40], gt[i]),
                                      np.float32), device=device)
    ranges = torch.as_tensor(log["ranges"][i], device=device)
    submap = torch.as_tensor(
        rng.uniform(-6.0, 6.0, (sub.height, sub.width)).astype(np.float32),
        device=device)
    out = {"update_hybrid": {}, "search_space": {}, "score_offsets": {}}

    def hybrid_entry(name, grid, at, gcfg_, origin_rc=None, origin_xy=None):
        def update(plain):
            return occupancy.integrate_scan(grid, at, ranges, gcfg_, s,
                                            origin_rc=origin_rc,
                                            origin_xy=origin_xy, plain=plain)

        n_diff, err = _hybrid_cells_ok(
            update(False), update(True), gcfg_,
            f"update_hybrid {name} [{grid.shape[0]}x{grid.shape[1]}]")
        same = torch.equal(update(False), update(False))
        if not same:
            raise AssertionError(f"update_hybrid {name} is not deterministic")
        out["update_hybrid"][name] = dict(
            shape=list(grid.shape), max_abs_err=err, cells_differing=n_diff,
            same_bits_twice=same,
            **_times(lambda: update(False), lambda: update(True), _bound(
                2 * grid.numel() * 4 + 8 * ranges.numel() + 12,
                30 * grid.numel())),
        )

    def field_entry(name, x, mcfg, res):
        def field(plain):
            return correlative.build_search_space(x, mcfg, res, plain=plain)

        S = field(False)
        err, n_diff = _search_space_cells_ok(
            S, field(True), f"search_space {name} [{x.shape[0]}x{x.shape[1]}]")
        same = torch.equal(S, field(False))
        if not same:
            raise AssertionError(f"search_space {name} is not deterministic")
        n_taps = 2 * blur_halo_cells(mcfg, res) + 1
        out["search_space"][name] = dict(
            shape=list(S.shape), max_abs_err=err, cells_differing=n_diff,
            same_bits_twice=same,
            **_times(lambda: field(False), lambda: field(True), _bound(
                2 * S.numel() * 4, S.numel() * (4 * n_taps + 8))),
        )
        return S

    def score_entries(mcfg, S, prior, res, origin, names):
        """The passes of one match_scan of `mcfg` over the search space S:
        coarse and fine, or one bilinear pass where the translation window
        fits the fine pass (as correlative.match_scan runs them)."""
        f = mcfg.coarse_factor
        r_fine = int(round(mcfg.search_xy / res))
        pts, valid = occupancy.scan_endpoints_local(ranges, s)
        dth = torch.as_tensor(correlative._theta_offsets(mcfg), device=device)
        if r_fine <= f:
            passes = {names[1]: (S, correlative.endpoint_positions(
                prior, pts, valid, dth, res, origin), r_fine, True)}
        else:
            n_fine = 2 * mcfg.fine_theta_bins + 1
            t0 = (len(dth) - n_fine) // 2
            passes = {
                names[0]: (correlative.coarse_space(S, f), correlative
                           .endpoint_positions(prior, pts, valid, dth,
                                               res * f, origin),
                           -(-r_fine // f), False),
                names[1]: (S, correlative.endpoint_positions(
                    prior, pts, valid, dth[t0:t0 + n_fine], res, origin),
                    f, True),
            }
        for name, (S_, pos, R, bil) in passes.items():
            def score(plain, S_=S_, pos=pos, R=R, bil=bil):
                return score_window(S_, *pos, valid, R, bil, plain=plain)

            a = score(False)
            err = float((a - score(True)).abs().max())
            same = torch.equal(a, score(False))
            print(f"score_offsets {name} {list(a.shape)} over "
                  f"{list(S_.shape)}: max |err| {err:.3g} (tolerance 1e-5), "
                  f"same bits twice {same}")
            if err > 1e-5:
                raise AssertionError(f"score_offsets {name} disagrees with "
                                     "its plain version")
            if not same:
                raise AssertionError(f"score_offsets {name} is not "
                                     "deterministic")
            n = 2 * R + 1
            out["score_offsets"][name] = dict(
                shape=list(a.shape), over=list(S_.shape), max_abs_err=err,
                same_bits_twice=same,
                **_times(lambda: score(False), lambda: score(True),
                         score_bound(S_, pos, valid, n, bil)),
            )

    hybrid_entry(tag + "at_submap", submap, pose, sub)
    wpose = torch.as_tensor(gt[i], device=device)
    if tcfg is None:
        full = torch.as_tensor(
            rng.uniform(-6.0, 6.0, (g.height, g.width)).astype(np.float32),
            device=device)
        gw, orc = extract_window(full, occupancy.world_to_cell(wpose[:2], g)
                                 .tolist(), update_window_cells(g, s))
        hybrid_entry(tag + "at_rebuild_window", gw, wpose, g, orc)
    else:
        # the tiled step's window: origin from the tile lattice
        twin = tiled_window_cells(tcfg, s, cfg.matcher)
        gparam = dataclasses.replace(g, resolution=tcfg.resolution)
        orc = [int(v) - twin // 2
               for v in world_to_cell_global(wpose[:2], tcfg).tolist()]
        origin_xy = occupancy.window_origin_xy(tcfg, orc)
        tw = torch.as_tensor(
            rng.uniform(-6.0, 6.0, (twin, twin)).astype(np.float32),
            device=device)
        hybrid_entry(tag + "at_tiled_window", tw, wpose, gparam,
                     origin_xy=origin_xy)
        Sw = field_entry(tag + "at_tiled_window", tw, cfg.matcher,
                         tcfg.resolution)
        prior = wpose + torch.as_tensor(
            rng.uniform(-0.1, 0.1, 3).astype(np.float32), device=device)
        score_entries(cfg.matcher, Sw, prior, tcfg.resolution, origin_xy,
                      (tag + "track_coarse", tag + "track_fine"))

    S = field_entry(tag + "at_submap", submap, lm, sub.resolution)
    prior = pose + torch.as_tensor(
        rng.uniform(-0.3, 0.3, 3).astype(np.float32), device=device)
    score_entries(lm, S, prior, sub.resolution, (sub.origin_x, sub.origin_y),
                  (tag + "loop_coarse", tag + "loop_fine"))
    return out


def _reset_fullslam_counts():
    for fn in (*_counters().values(), tridiag_factor):
        fn.launches = 0
    for name in ("host_syncs", "matches", "updates"):
        setattr(frontend_step, name, 0)
    for name in FULLSLAM_COUNTS:
        setattr(run_full_slam, name, 0)
    fetch.reads = 0


def run_fullslam(cfg, gcfg, log, device, optimizer="auto",
                 label="full SLAM"):
    """Phase 15 (and 17 with optimizer="schur"): full SLAM (run_full_slam)
    at the CLI's `--mode full` defaults over two laps of bench.py's world
    through the kernels: at least one accepted loop, keyframe ATE below
    odometry's at the same scans, every launch accounted for (kernel 1
    `hybrid`: one a scan run of the frontend, whose gates are on the
    device, the submaps' and the rebuilds' scans; kernel 3: one a scan
    run + 1, a submap and a correction each; kernel 2: a match's passes a
    scan run (two at this config) and an attempt's match and peak margin
    (three)), and no host read of the frontend's. Returns (launches,
    result)."""
    warm = {k: np.asarray(v)[: cfg.chunk] for k, v in log.items()}
    run_full_slam(warm, cfg, gcfg, device=device, optimizer=optimizer)
    # cuSOLVER's first call sets it up: take it before the timed run
    g = se2_graph.HostGraph(gcfg)
    g.add_node(np.zeros(3))
    g.add_node(np.ones(3))
    g.add_edge(0, 1, np.ones(3), np.eye(3))
    se2_graph.optimize(g.to_device(device), gcfg)
    torch.cuda.synchronize()
    _reset_fullslam_counts()
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = run_full_slam(log, cfg, gcfg, device=device, optimizer=optimizer)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _counters().items()}
    peak = torch.cuda.max_memory_allocated(device)
    counts = dict(host_syncs=frontend_step.host_syncs,
                  matches=frontend_step.matches,
                  updates=frontend_step.updates, fetch_reads=fetch.reads,
                  **{n: getattr(run_full_slam, n) for n in FULLSLAM_COUNTS})
    T = len(res.traj)
    scans_run = -(-T // cfg.chunk) * cfg.chunk
    gt = np.asarray(log["gt_poses"])
    idx = res.kf_scan_idx
    att = res.loop_attempts
    elapsed = start.elapsed_time(end) / 1e3
    reads = counts["host_syncs"] + counts["fetch_reads"]
    result = dict(
        scans=T, scans_run=scans_run, scans_per_sec=T / elapsed,
        seconds_cuda_events=elapsed, seconds_host=wall,
        keyframes=len(idx), attempts_recorded=len(att),
        accepted=int(att[:, 6].sum()) if len(att) else 0,
        n_loops=res.n_loops, chi2=res.chi2,
        kf_ate_m=ate_rmse(res.kf_poses, gt[idx], align=False),
        kf_ate_odom_m=ate_rmse(log["odom"][idx], gt[idx], align=False),
        ate_m=ate_rmse(res.traj, gt, align=False),
        ate_odom_m=ate_rmse(log["odom"], gt, align=False),
        host_reads=reads, host_reads_per_scan=reads / T,
        peak_memory_bytes=peak, launches=launches, optimizer=optimizer,
        **counts,
    )
    print(f"{label}:", json.dumps(result))
    if not np.isfinite(res.traj).all():
        raise AssertionError(f"{label}: trajectory is not finite")
    if res.n_loops < 1:
        raise AssertionError(f"{label}: no loop was accepted")
    if not result["kf_ate_m"] < result["kf_ate_odom_m"]:
        raise AssertionError(
            f"{label}: keyframe ATE {result['kf_ate_m']} not below "
            f"odometry's {result['kf_ate_odom_m']}")
    res_m = cfg.grid.resolution
    sampled = occupancy.resolve_update_impl(cfg.grid, cfg.sensor) in (
        "sparse", "sparse_mxu")
    # the frontend's gates are on the device: its kernels launch every
    # scan run, returning at once where their gate is 0; the sampled-ray
    # update has no kernel
    expect = {
        "update_hybrid": 0 if sampled else scans_run
        + counts["submap_scans"] + counts["rebuilt_scans"],
        "search_space": scans_run + 1 + counts["submaps"]
        + counts["corrections"],
        "score_offsets": _match_passes(cfg.matcher, res_m) * scans_run
        + (_match_passes(default_loop_matcher(gcfg), res_m) + 1)
        * counts["attempts"],
    }
    if launches != expect or min(v for k, v in launches.items()
                                 if k != "update_hybrid" or not sampled) <= 0:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect}")
    launches = {k: v for k, v in launches.items() if v}
    if counts["host_syncs"] != 0:
        raise AssertionError(f"{label}: the frontend read the host "
                             f"{counts['host_syncs']} times")
    if counts["corrections"] != res.n_loops:
        raise AssertionError(f"{label}: {counts['corrections']} "
                             f"corrections for {res.n_loops} loops")
    return launches, res


def _match_passes(mcfg, resolution):
    """Scorer launches of one match_scan: one pass where the whole
    translation window fits the fine pass, else coarse and fine."""
    return 1 if round(mcfg.search_xy / resolution) <= mcfg.coarse_factor else 2


def _decisions(attempts):
    """The (i, j, accepted) columns of loop attempts, as int tuples."""
    a = np.asarray(attempts, np.float64).reshape(-1, 10)
    return [tuple(int(v) for v in row) for row in a[:, [0, 1, 6]]]


def fullslam_held(cfg, gcfg, log, device, res):
    """Phase 15, held: (a) the first FULLSLAM_PARITY_SCANS scans run twice,
    through the kernels and through their plain versions: the same
    keyframes and (i, j, accepted) attempt decisions, the tracked poses
    (frame_cb's, before corrections) and keyframe poses within 5e-3 m /
    rad; (b) the whole run beside the JAX package's at the same config
    and log (scripts/fullslam_reference.json): keyframe ATE at most JAX's
    + 0.1 m; the keyframes and decisions compared and printed. Over the
    whole log neither is held equal: the map update's atan2f flips cells
    on a beam slot's edge against the JAX package's polynomial, and the
    scorer sums in another order than its plain version, and in this log
    such differences grow into other anchors and decisions late in the
    second lap (PERF.md §6)."""
    part = {k: np.asarray(v)[:FULLSLAM_PARITY_SCANS] for k, v in log.items()}
    runs = {}
    for plain in (False, True):
        chunks = []
        r = run_full_slam(part, cfg, gcfg, device=device, plain=plain,
                          frame_cb=lambda m, tr, c=chunks: c.append(tr))
        runs[plain] = (r, np.concatenate(chunks))
    (k_res, k_tr), (p_res, p_tr) = runs[False], runs[True]
    out = dict(
        parity_scans=FULLSLAM_PARITY_SCANS,
        plain_keyframes=len(p_res.kf_scan_idx),
        plain_attempts=len(p_res.loop_attempts),
        plain_loops=p_res.n_loops,
        plain_same_keyframes=bool(np.array_equal(p_res.kf_scan_idx,
                                                 k_res.kf_scan_idx)),
        plain_same_decisions=_decisions(p_res.loop_attempts)
        == _decisions(k_res.loop_attempts),
    )
    out["plain_tracked_dxy_m"], out["plain_tracked_dth_rad"] = _pose_errors(
        k_tr, p_tr)
    if out["plain_same_keyframes"]:
        out["plain_kf_dxy_m"], out["plain_kf_dth_rad"] = _pose_errors(
            k_res.kf_poses, p_res.kf_poses)
    if out["plain_same_decisions"] and len(k_res.loop_attempts):
        out["plain_score_err"] = float(np.abs(
            p_res.loop_attempts[:, 2] - k_res.loop_attempts[:, 2]).max())

    jax_out, ref = beside_reference(res, log, FULLSLAM_REFERENCE,
                                    "full SLAM")
    out.update(jax_out)
    print("full SLAM held:", json.dumps(out))
    if out["kf_ate_m"] > ref["kf_ate_m"] + FULLSLAM_JAX_ATE_SLACK_M:
        raise AssertionError(
            f"full SLAM: keyframe ATE {out['kf_ate_m']} above the JAX "
            f"package's {ref['kf_ate_m']} + {FULLSLAM_JAX_ATE_SLACK_M} m")
    if not (out["plain_same_keyframes"] and out["plain_same_decisions"]):
        raise AssertionError("full SLAM: over the first "
                             f"{FULLSLAM_PARITY_SCANS} scans the plain "
                             "versions' run took other keyframes or loop "
                             "decisions")
    worst = max(out["plain_tracked_dxy_m"], out["plain_tracked_dth_rad"],
                out["plain_kf_dxy_m"], out["plain_kf_dth_rad"])
    if worst > FULLSLAM_POSE_TOL:
        raise AssertionError("full SLAM: kernel and plain poses differ by "
                             f"{worst} > {FULLSLAM_POSE_TOL}")
    return out


def beside_reference(res, log, ref_file, label):
    """A run beside the JAX package's at the same config and log (a JSON
    file of scripts/fullslam_reference.py): its keyframes, attempt
    decisions, loops and ATEs beside the port's (where the two first
    part). Returns (the comparison's dict, the reference)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ref_file)) as fh:
        ref = json.load(fh)
    dj, dk = _decisions(ref["loop_attempts"]), _decisions(res.loop_attempts)
    first = next((n for n, (a, b) in enumerate(zip(dj, dk)) if a != b),
                 min(len(dj), len(dk)))
    ref_idx = np.asarray(ref["kf_scan_idx"])
    n = min(len(ref_idx), len(res.kf_scan_idx))
    gt = np.asarray(log["gt_poses"])
    kf_ate = ate_rmse(res.kf_poses, gt[res.kf_scan_idx], align=False)
    out = dict(
        reference=ref_file, kf_ate_m=kf_ate, keyframes=len(res.kf_scan_idx),
        attempts=len(dk), n_loops=res.n_loops,
        jax_keyframes=len(ref_idx), jax_attempts=len(dj),
        jax_n_loops=ref["n_loops"], jax_chi2=ref["chi2"],
        jax_kf_ate_m=ref["kf_ate_m"], jax_ate_m=ref["traj_ate_m"],
        jax_kf_ate_odom_m=ref["kf_ate_odom_m"],
        jax_ate_odom_m=ref["traj_ate_odom_m"],
        jax_same_keyframes=bool(np.array_equal(ref_idx, res.kf_scan_idx)),
        jax_same_keyframes_first=int(np.argmax(
            np.r_[ref_idx[:n] != res.kf_scan_idx[:n], True])),
        jax_same_decisions=dj == dk, jax_same_decisions_first=first,
        decisions=dk, jax_decisions=dj,
    )
    return out, ref


def held_to_jax(res, log, ref_file, label, hold=True):
    """The port's run beside the JAX package's (beside_reference),
    printed; with `hold`, held to keyframe ATE at most JAX's + 0.1 m
    (raises past it). A run of a five-seed set is held with its set
    instead (held_as_set). Returns the dict."""
    out, ref = beside_reference(res, log, ref_file, label)
    limit = ref["kf_ate_m"] + FULLSLAM_JAX_ATE_SLACK_M
    if hold:
        out["held_to_jax"] = out["kf_ate_m"] <= limit
    print(f"{label} beside JAX:", json.dumps(out))
    if hold and not out["held_to_jax"]:
        raise AssertionError(
            f"{label}: keyframe ATE {out['kf_ate_m']} above the JAX "
            f"package's {ref['kf_ate_m']} + {FULLSLAM_JAX_ATE_SLACK_M} m")
    return out


def held_as_set(label, runs):
    """A set of runs over one route with the noise of several seeds,
    beside the JAX package's runs over the same logs: `runs` maps a seed
    to its beside_reference dict. Held: the port's median keyframe ATE
    at most JAX's median over the same seeds + FULLSLAM_JAX_ATE_SLACK_M,
    phase 21 (d)'s FastSLAM-16 form (on these logs one run is a draw: one
    float32 ulp of the first beam angle moved JAX's own seed-4 kf ATE
    between 0.189 and 0.319 m; ROADMAP queue 3 items 2 and 5); every
    run's keyframe ATE at most the worst of JAX's runs over the set + the
    same slack (a run of the set is a draw from that distribution, so one
    past its reach is a fault of the run, at every seed); and at least one
    loop over the set where JAX's runs close one (on the corridor lap,
    whether the end of a lap drifted by 3-4.5 m falls within the 3 m loop
    radius of its start is a draw too). Prints each seed's pair; raises
    past the limits. Returns the set's dict."""
    seeds = sorted(runs)
    port = [runs[k]["kf_ate_m"] for k in seeds]
    jax_ = [runs[k]["jax_kf_ate_m"] for k in seeds]
    out = dict(seeds=seeds, kf_ate_m=port, jax_kf_ate_m=jax_,
               median_kf_ate_m=float(np.median(port)),
               jax_median_kf_ate_m=float(np.median(jax_)),
               limit_m=float(np.median(jax_)) + FULLSLAM_JAX_ATE_SLACK_M,
               run_limit_m=max(jax_) + FULLSLAM_JAX_ATE_SLACK_M,
               n_loops=[runs[k]["n_loops"] for k in seeds],
               jax_n_loops=[runs[k]["jax_n_loops"] for k in seeds])
    loops = sum(out["n_loops"]) >= min(1, sum(out["jax_n_loops"]))
    worst = max(port)
    out["held"] = (out["median_kf_ate_m"] <= out["limit_m"]
                   and worst <= out["run_limit_m"] and loops)
    print(f"{label}, seeds {seeds} as a set:", json.dumps(out))
    if not out["median_kf_ate_m"] <= out["limit_m"]:
        raise AssertionError(
            f"{label}: median keyframe ATE {out['median_kf_ate_m']} over "
            f"seeds {seeds} above the JAX package's median "
            f"{out['jax_median_kf_ate_m']} + {FULLSLAM_JAX_ATE_SLACK_M} m")
    if not worst <= out["run_limit_m"]:
        raise AssertionError(
            f"{label}: seed {seeds[port.index(worst)]}'s keyframe ATE "
            f"{worst} above the worst of the JAX package's runs "
            f"{max(jax_)} + {FULLSLAM_JAX_ATE_SLACK_M} m")
    if not loops:
        raise AssertionError(f"{label}: no loop over seeds {seeds} (JAX's "
                             f"runs closed {sum(out['jax_n_loops'])})")
    return out


def fullslam_seeds(cfg, gcfg, device, seed3):
    """Phase 15's set: full SLAM over fullslam_bench_log's route with the
    noise of seeds 4 to 7, each with run_fullslam's checks (a loop, kf ATE
    below odometry's, the launches) and beside the JAX package's run
    (scripts/fullslam_reference_seed4.json to _seed7.json); with seed 3's
    (`seed3`, fullslam_held's dict) held as a set (held_as_set). Returns
    {seed: beside_reference dict, "set": the set's dict}."""
    out = {3: seed3}
    for seed in FULLSLAM_EXTRA_SEEDS:
        log = fullslam_bench_log(cfg.sensor, seed=seed)
        label = f"full SLAM seed {seed}"
        _, res = run_fullslam(cfg, gcfg, log, device, label=label)
        out[seed] = held_to_jax(
            res, log, f"scripts/fullslam_reference_seed{seed}.json", label,
            hold=False)
    out["set"] = held_as_set("full SLAM", out)
    return out


def _accept_timers():
    """Wrappers that time, each between two synchronizes, every graph
    solve (LoopCloser._dispatch_optimize: the graph's copy, the solve, the
    chi2 prune), every accept's finalize (LoopCloser._finalize_accept:
    the read, the correction tail and the map rebuild) and every tiled
    rebuild (IncrementalTiledRebuilder.__call__). Returns (times, undo)."""
    from slam2d_tpu_torch.run import full_slam, full_slam_tiled

    targets = {
        "solve": (full_slam.LoopCloser, "_dispatch_optimize"),
        "finalize": (full_slam.LoopCloser, "_finalize_accept"),
        "rebuild": (full_slam_tiled.IncrementalTiledRebuilder, "__call__"),
    }
    times = {k: [] for k in targets}
    orig = {k: getattr(c, n) for k, (c, n) in targets.items()}

    def timed(fn, out):
        def wrap(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            return r
        return wrap

    for k, (c, n) in targets.items():
        setattr(c, n, timed(orig[k], times[k]))

    def undo():
        for k, (c, n) in targets.items():
            setattr(c, n, orig[k])

    return times, undo


def _tiled_fullslam_run(cfg, tcfg, gcfg, log, device, ref_file, label,
                        hold=True, incremental_rebuild=True):
    """One timed run_full_slam_tiled over `log` through the kernels with
    the counts set to 0 just before it, beside the JAX package's run
    (held_to_jax, holding its kf ATE when `hold`; a run of a set is held
    with the set): a finite trajectory, keyframe ATE below odometry's and
    trajectory ATE below odometry's / 3 (each where JAX's run over the log
    meets it: over the lap with the noise of seeds 5-7 the odometry
    drifts 2.0-2.8 m and JAX's tracking ends above it; such a run is held
    to its set's worst JAX run instead, held_as_set), at least 6 active
    tiles, with `hold` at least one loop where JAX's run closed one (a
    run of a set: over the set), every launch accounted for (kernel 1
    `hybrid`:
    the tracking's updates, the submaps' and the rebuilds' scans; kernel
    3: the tracking's updates, a submap each and the rebuilds' builds;
    kernel 2: a match's passes and an attempt's three). With
    `incremental_rebuild=False` each accept's rebuild replays every
    keyframe whose pose moved at all (eps 0). Returns (launches, result,
    FullSLAMResult, held_to_jax's dict)."""
    from slam2d_tpu_torch.run import full_slam_tiled as fst

    warm = {k: np.asarray(v)[: cfg.chunk] for k, v in log.items()}
    fst.run_full_slam_tiled(warm, cfg, tcfg, gcfg, device=device,
                            incremental_rebuild=incremental_rebuild)
    torch.cuda.synchronize()
    _reset_tiled_fullslam_counts(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = fst.run_full_slam_tiled(log, cfg, tcfg, gcfg, device=device,
                                  incremental_rebuild=incremental_rebuild)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    return _tiled_fullslam_checks(
        cfg, tcfg, gcfg, log, device, res, start.elapsed_time(end) / 1e3,
        wall, ref_file, label, hold)


def _reset_tiled_fullslam_counts(device):
    """The counts _tiled_fullslam_checks reads, and the peak memory, to 0."""
    from slam2d_tpu_torch.run import full_slam_tiled as fst

    for fn in _counters().values():
        fn.launches = 0
    for name in ("host_syncs", "matches", "updates"):
        setattr(tiled_frontend_step, name, 0)
    for name in ("attempts", "submaps", "submap_scans"):
        setattr(run_full_slam, name, 0)
    for name in ("rebuilt_scans", "rebuilt_fields", "corrections"):
        setattr(fst.run_full_slam_tiled, name, 0)
    fetch.reads = 0
    torch.cuda.reset_peak_memory_stats(device)


def _tiled_fullslam_checks(cfg, tcfg, gcfg, log, device, res, elapsed, wall,
                           ref_file, label, hold=True):
    """_tiled_fullslam_run's checks of a run `res` over `log` made with
    the counts set to 0 just before it (_reset_tiled_fullslam_counts),
    `elapsed` its seconds on the device's clock, `wall` on the host's."""
    from slam2d_tpu_torch.run import full_slam_tiled as fst

    launches = {k: fn.launches for k, fn in _counters().items()}
    peak = torch.cuda.max_memory_allocated(device)
    counts = dict(
        host_syncs=tiled_frontend_step.host_syncs,
        matches=tiled_frontend_step.matches,
        updates=tiled_frontend_step.updates, fetch_reads=fetch.reads,
        **{n: getattr(run_full_slam, n)
           for n in ("attempts", "submaps", "submap_scans")},
        **{n: getattr(fst.run_full_slam_tiled, n)
           for n in ("rebuilt_scans", "rebuilt_fields", "corrections")},
    )
    T = len(res.traj)
    gt = np.asarray(log["gt_poses"])
    idx = res.kf_scan_idx
    coords = res.grid.coords[:-1].cpu().numpy()
    n_active = int((coords[:, 0] > FREE_SLOT).sum())
    reads = counts["host_syncs"] + counts["fetch_reads"]
    result = dict(
        scans=T, scans_per_sec=T / elapsed, seconds_cuda_events=elapsed,
        seconds_host=wall, tile=tcfg.tile, resolution=tcfg.resolution,
        window=tiled_window_cells(tcfg, cfg.sensor, cfg.matcher),
        keyframes=len(idx), attempts_recorded=len(res.loop_attempts),
        n_loops=res.n_loops, chi2=res.chi2,
        kf_ate_m=ate_rmse(res.kf_poses, gt[idx], align=False),
        kf_ate_odom_m=ate_rmse(log["odom"][idx], gt[idx], align=False),
        ate_m=ate_rmse(res.traj, gt, align=False),
        ate_odom_m=ate_rmse(log["odom"], gt, align=False),
        active_tiles=n_active, host_reads=reads,
        host_reads_per_scan=reads / T, peak_memory_bytes=peak,
        launches=launches, **counts,
    )
    print(f"{label}:", json.dumps(result))
    if not np.isfinite(res.traj).all():
        raise AssertionError(f"{label}: trajectory is not finite")
    held = held_to_jax(res, log, ref_file, label, hold=hold)
    if res.n_loops < min(1, held["jax_n_loops"]):
        if hold:
            raise AssertionError(f"{label}: no loop was accepted (JAX's "
                                 "run closed one)")
        print(f"{label}: no loop, where JAX's run closed "
              f"{held['jax_n_loops']}: held over the set")
    bounds = (
        ("keyframe ATE", result["kf_ate_m"], result["kf_ate_odom_m"],
         held["jax_kf_ate_m"] < held["jax_kf_ate_odom_m"]),
        ("trajectory ATE", result["ate_m"], result["ate_odom_m"] / 3.0,
         held["jax_ate_m"] < held["jax_ate_odom_m"] / 3.0),
    )
    for what, got, bound, jax_meets in bounds:
        if not jax_meets:
            print(f"{label}: {what} {got} beside its odometry bound "
                  f"{bound}, which JAX's run over this log does not meet: "
                  "held by its set's worst run instead (held_as_set)")
        elif not got < bound:
            raise AssertionError(f"{label}: {what} {got} not below its "
                                 f"odometry bound {bound}")
    if n_active < 6:
        raise AssertionError(f"{label}: {n_active} active tiles")
    # the tracking's kernels launch once a scan run (their gates are on
    # the device, a gated-off launch returns at once)
    scans_run = -(-T // cfg.chunk) * cfg.chunk
    expect = {
        "update_hybrid": scans_run + counts["submap_scans"]
        + counts["rebuilt_scans"],
        "search_space": scans_run + counts["submaps"]
        + counts["rebuilt_fields"],
        "score_offsets": _match_passes(cfg.matcher, tcfg.resolution)
        * scans_run
        + (_match_passes(default_loop_matcher(gcfg), cfg.grid.resolution)
           + 1) * counts["attempts"],
    }
    if launches != expect or min(launches.values()) <= 0:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect}")
    if counts["host_syncs"]:
        raise AssertionError(f"{label}: the tracking read the host")
    if counts["corrections"] != res.n_loops:
        raise AssertionError(f"{label}: {counts['corrections']} "
                             f"corrections for {res.n_loops} loops")
    return launches, result, res, held


def run_fullslam_tiled(log, device):
    """Phase 16: full SLAM on the tiled world (run_full_slam_tiled) over
    tests/test_killian_scale.py's lap of the 60 m corridor, through the
    kernels (_tiled_fullslam_run's checks): (a) at the CLI's tile
    defaults (fullslam_tiled_bench_config: 512^2 tiles at 0.05 m), over
    `log` (seed 3, the timed run) beside
    scripts/fullslam_tiled_reference.json and over the lap with the noise
    of seeds 4 to 7 beside fullslam_tiled_reference_seed4.json to
    _seed7.json, the five held as a set (held_as_set); (b) at the test's
    own config
    (fullslam_tiled_killian_config: 256^2 tiles at 0.1 m), where the JAX
    package closes the lap, beside fullslam_tiled_killian_reference.json,
    also held to the test's bounds (at least one loop, kf ATE below 2 m
    and odometry's / 5). Then (b) again with each solve, finalize and
    rebuild synced and timed; (a)'s first 256 scans through the kernels
    and through the plain versions (phase 5's tolerances); (b) whole
    through the plain versions, its loop attempts and the accept's tiled
    rebuild included: the same keyframes, decisions and tiles, poses
    within 5e-3 m / rad, the map's cells off printed. Returns {path:
    launches}."""
    from slam2d_tpu_torch.run import full_slam_tiled as fst

    cfg, tcfg, gcfg = fullslam_tiled_bench_config()
    launches, _, _, beside = _tiled_fullslam_run(
        cfg, tcfg, gcfg, log, device, FULLSLAM_TILED_REFERENCE,
        "tiled full SLAM", hold=False)
    runs = {3: beside}
    for seed in FULLSLAM_EXTRA_SEEDS:
        runs[seed] = _tiled_fullslam_run(
            cfg, tcfg, gcfg, fullslam_tiled_bench_log(cfg.sensor, seed=seed),
            device, f"scripts/fullslam_tiled_reference_seed{seed}.json",
            f"tiled full SLAM seed {seed}", hold=False)[3]
    held_as_set("tiled full SLAM", runs)
    kcfg, ktcfg, kgcfg = fullslam_tiled_killian_config()
    k_launches, k_out, k_res, _ = _tiled_fullslam_run(
        kcfg, ktcfg, kgcfg, log, device, FULLSLAM_TILED_KILLIAN_REFERENCE,
        "tiled full SLAM, test_killian_scale config")
    if not (k_res.n_loops >= 1 and k_out["kf_ate_m"] < 2.0
            and k_out["kf_ate_m"] < k_out["ate_odom_m"] / 5.0):
        raise AssertionError("tiled full SLAM at test_killian_scale's "
                             "config: outside the test's bounds")

    times, undo = _accept_timers()
    try:
        t0 = time.perf_counter()
        synced = fst.run_full_slam_tiled(log, kcfg, ktcfg, kgcfg,
                                         device=device)
        sec = time.perf_counter() - t0
    finally:
        undo()
    accept = [a + b for a, b in zip(times["solve"], times["finalize"])]
    timing = dict(
        scans_per_sec_synced=len(synced.traj) / sec, n_loops=synced.n_loops,
        same_keyframes=bool(np.array_equal(synced.kf_scan_idx,
                                           k_res.kf_scan_idx)),
        same_decisions=_decisions(synced.loop_attempts)
        == _decisions(k_res.loop_attempts),
        solve_ms=times["solve"], finalize_ms=times["finalize"],
        rebuild_ms=times["rebuild"], accept_ms=accept,
        **{f"{k}_ms_median": statistics.median(v or [0.0])
           for k, v in dict(times, accept=accept).items()},
    )
    print("tiled full SLAM, test_killian_scale config, synced accepts:",
          json.dumps(timing))

    part = {k: np.asarray(v)[:PARITY_SCANS] for k, v in log.items()}
    k_part = fst.run_full_slam_tiled(part, cfg, tcfg, gcfg, device=device)
    p_part = fst.run_full_slam_tiled(part, cfg, tcfg, gcfg, device=device,
                                     plain=True)
    dxy, dth = _pose_errors(k_part.traj, p_part.traj)
    print(f"plain-version tiled full SLAM, {PARITY_SCANS} scans: max |dxy| "
          f"{dxy:.3g} m, max |dtheta| {dth:.3g} rad (tolerance {POSE_TOL_M} "
          f"/ {POSE_TOL_RAD}); keyframes {len(k_part.kf_scan_idx)} and "
          f"{len(p_part.kf_scan_idx)}")
    if dxy > POSE_TOL_M or dth > POSE_TOL_RAD:
        raise AssertionError("kernel and plain tiled full SLAM disagree")

    # (b) whole, loop attempts and the tiled rebuild of the accept
    # included, through the plain versions
    p_res = fst.run_full_slam_tiled(log, kcfg, ktcfg, kgcfg, device=device,
                                    plain=True)
    same_kf = bool(np.array_equal(p_res.kf_scan_idx, k_res.kf_scan_idx))
    same_dec = _decisions(p_res.loop_attempts) == _decisions(
        k_res.loop_attempts)
    dxy, dth = _pose_errors(k_res.traj, p_res.traj)
    kf_dxy, kf_dth = (_pose_errors(k_res.kf_poses, p_res.kf_poses)
                      if same_kf else (np.inf, np.inf))
    plain_out = dict(
        scans=len(log["odom"]), keyframes=len(p_res.kf_scan_idx),
        same_keyframes=same_kf, same_decisions=same_dec,
        n_loops=p_res.n_loops, decisions=_decisions(p_res.loop_attempts),
        traj_dxy_m=dxy, traj_dth_rad=dth, kf_dxy_m=kf_dxy, kf_dth_rad=kf_dth,
        same_tiles=bool(torch.equal(k_res.grid.coords, p_res.grid.coords)),
    )
    if plain_out["same_tiles"]:
        d = (k_res.grid.tiles - p_res.grid.tiles).abs()
        plain_out["map_cells_off_share"] = float((d > 1e-4).float().mean())
        plain_out["map_max_abs_err"] = float(d.max())
    print("plain-version tiled full SLAM, test_killian_scale config:",
          json.dumps(plain_out))
    if not (same_kf and same_dec and p_res.n_loops >= 1):
        raise AssertionError("kernel and plain tiled full SLAM at "
                             "test_killian_scale's config took other "
                             "keyframes or loop decisions")
    if max(dxy, dth, kf_dxy, kf_dth) > FULLSLAM_POSE_TOL:
        raise AssertionError("kernel and plain tiled full SLAM at "
                             "test_killian_scale's config disagree")
    return {"16 tiled full SLAM": launches,
            "16 tiled full SLAM, test_killian_scale config": k_launches}


def schur_checks(cfg, gcfg, log, device, graph):
    """Phase 17: (a) full SLAM with optimizer="schur" over phase 15's
    config and log (run_fullslam's checks), held to the JAX package's
    Schur run (scripts/fullslam_reference_schur.json; held_to_jax); (b)
    on phase 15's final graph, optimize_schur
    with 2 and 4 blocks against the dense optimize: poses within 5e-3 m /
    rad (tests/test_schur.py's tolerance), each solve's ms (synced,
    median of 5). Returns (launches, result)."""
    launches, res = run_fullslam(cfg, gcfg, log, device, optimizer="schur",
                                 label="Schur full SLAM")
    out = dict(beside_jax=held_to_jax(res, log, FULLSLAM_SCHUR_REFERENCE,
                                      "Schur full SLAM"))
    host = se2_graph.HostGraph.from_arrays(gcfg, graph)
    n = host.n_nodes
    g = host.to_device(device)

    def solve(fn):
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r, _ = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return r.poses[:n].cpu().numpy(), statistics.median(ms)

    dense, out["dense_ms"] = solve(lambda: se2_graph.optimize(g, gcfg))
    out.update(nodes=n, edges=host.n_edges,
               active_edges=int(host.edge_mask[:host.n_edges].sum()))
    worst = 0.0
    for nb in (2, 4):
        # the host's plan and tables apart from the iterations on the card
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = schur.build_plan(host, nb)
            t1 = time.perf_counter()
            tables = schur.schur_tables(plan, device)
            torch.cuda.synchronize()
            ms.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        out[f"schur{nb}_plan_ms"] = statistics.median(m[0] for m in ms)
        out[f"schur{nb}_tables_ms"] = statistics.median(m[1] for m in ms)
        p, out[f"schur{nb}_ms"] = solve(
            lambda: schur.optimize_schur(g, gcfg, nb, plan=plan))
        _, out[f"schur{nb}_iterations_ms"] = solve(
            lambda: schur.optimize_schur(g, gcfg, nb, plan=plan,
                                         tables=tables))
        dxy, dth = _pose_errors(p, dense)
        out[f"schur{nb}_separators"] = plan.n_sep
        out[f"schur{nb}_dxy_m"], out[f"schur{nb}_dth_rad"] = dxy, dth
        worst = max(worst, dxy, dth)
    print("Schur solver:", json.dumps(out))
    if not worst <= FULLSLAM_POSE_TOL:
        raise AssertionError(f"optimize_schur and the dense optimize differ "
                             f"by {worst} > {FULLSLAM_POSE_TOL}")
    return launches, out

def _tridiag_entry(D, O, label):
    """tridiag_factor on D, O [K, 3, 3] against its plain version (the
    K-step PyTorch loop), the same bits twice; timed as phase 3 times the
    kernels, the plain version once (a long K-step loop takes seconds)."""
    K = D.shape[0]
    a = tridiag_factor(D, O)
    b = tridiag_factor(D, O, plain=True)
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    same = torch.equal(a, tridiag_factor(D, O))
    print(f"tridiag_factor {label} K={K}: max |err| {err:.3g} (tolerance "
          f"{TRIDIAG_RTOL} x max |Cinv| = {TRIDIAG_RTOL * scale:.3g}), "
          f"same bits twice {same}")
    if not err <= TRIDIAG_RTOL * scale:
        raise AssertionError(f"tridiag_factor disagrees at {label} K={K}")
    if not same:
        raise AssertionError("tridiag_factor is not deterministic")
    device_ms, by = _cuda_device_ms(lambda: tridiag_factor(D, O), n=10)
    # D and O read once, Cinv written once; ~140 operations a block
    bound = _bound(3 * K * 9 * 4, 140 * K)
    return dict(
        max_abs_err=err, max_abs=scale,
        tolerance=f"atol {TRIDIAG_RTOL} x max |Cinv|",
        same_bits_twice=same, shape=[K, 3, 3], input=label,
        ms=_cuda_ms(lambda: tridiag_factor(D, O)),
        plain_ms=_cuda_ms(lambda: tridiag_factor(D, O, plain=True),
                          runs=1, warmup=0),
        library_ms=None, device_ms=device_ms, device_by=by,
        bound_share=bound["bound_ms"] / device_ms,
        operands_fit_l2=bound["bytes"] <= L2_BYTES, **bound,
    )


def tridiag_checks(device):
    """Phase 3's rows of the block-Thomas factor (ops/tridiag.py, no Pallas
    counterpart: it replaces a lax.scan) on the chain matrix that
    optimize_cg assembles for the serpentine graph at K = 4096 and 16384
    (phase 19's solver-alone sizes, every node active). The row of its
    main path, phase 19's full SLAM, is tridiag_path_check's. Returns
    {"at_serpentine_K": entry}."""
    out = {}
    for K in TRIDIAG_SIZES:
        arrays, _, _, ckw = hier_bench_graph(K)
        gcfg = GraphConfig(**ckw)
        g = se2_graph.PoseGraph(**{k: torch.as_tensor(v, device=device)
                                   for k, v in arrays.items()})
        plan = sparse.sparse_plan(g, gcfg, device, hier=False)
        D, O, *_ = sparse._assemble_sparse(g.poses, g, None, gcfg.damping,
                                           plan.levels[0])
        out[f"at_serpentine_{K}"] = _tridiag_entry(D, O, "serpentine")
    return out


def tridiag_path_check(device, gcfg, graph):
    """tridiag_factor at its main path's input: the chain matrix of phase
    19's final 512-slot graph (`graph`, the checkpoint's arrays, at
    `gcfg` with hier_dense_max 64), as the PCG polish assembles it in its
    last Gauss-Newton iteration: the slots past the live nodes clamped
    (identity diagonal, zero coupling). Returns the entry."""
    host = se2_graph.HostGraph.from_arrays(gcfg, graph)
    g = host.to_device(device)
    plan = sparse.sparse_plan(host, gcfg, device, hier=True)
    D, O, *_ = sparse._assemble_sparse(
        g.poses, g, se2_graph._robust_of(gcfg, gcfg.gn_iters - 1),
        gcfg.damping, plan.levels[0])
    entry = _tridiag_entry(D, O, "phase 19 full SLAM's final graph")
    entry["active_nodes"] = host.n_nodes
    return entry


def wide_fov_kernel_checks(cfg, log, device):
    """Phase 3 at phase 20's new shapes: kernel 2's coarse and fine passes
    with a 1081-beam scan (the 270-degree sensor) over bench.py's scan
    window, and kernel 3's in-place form over the whole 1024^2 map (the
    30 m update window is wider than the map: origin None, no halo trim),
    gate 1 against its plain version. Returns {kernel: {"at_wide_fov":
    entry}}."""
    rng = np.random.default_rng(SEED + 20)
    g, m, s = cfg.grid, cfg.matcher, cfg.sensor
    win = scan_window_cells(g, s, m)
    i = len(log["odom"]) // 2
    pose = torch.as_tensor(np.asarray(log["gt_poses"][i], np.float32),
                           device=device)
    ranges = torch.as_tensor(log["ranges"][i], device=device)
    full = torch.as_tensor(
        rng.uniform(-6.0, 6.0, (g.height, g.width)).astype(np.float32),
        device=device)
    S = correlative.build_search_space(full, m, g.resolution)
    center = occupancy.world_to_cell(pose[:2], g).tolist()
    Sw, org = extract_window(S, center, win)
    origin = occupancy.window_origin_xy(g, org)
    Sc = correlative.coarse_space(Sw, m.coarse_factor)
    pts, valid = occupancy.scan_endpoints_local(ranges, s)
    prior = pose + torch.as_tensor(
        rng.uniform(-0.1, 0.1, 3).astype(np.float32), device=device)
    dth = torch.as_tensor(correlative._theta_offsets(m), device=device)
    r_fine = int(round(m.search_xy / g.resolution))
    r_coarse = -(-r_fine // m.coarse_factor)
    pos_c = correlative.endpoint_positions(
        prior, pts, valid, dth, g.resolution * m.coarse_factor, origin)
    pos_f = correlative.endpoint_positions(
        prior, pts, valid, dth[4:9], g.resolution, origin)
    passes = {
        "coarse": (lambda plain: score_window(
            Sc, *pos_c, valid, r_coarse, False, plain=plain),
            Sc, pos_c, 2 * r_coarse + 1, False),
        "fine": (lambda plain: score_window(
            Sw, *pos_f, valid, m.coarse_factor, True, plain=plain),
            Sw, pos_f, 2 * m.coarse_factor + 1, True),
    }
    score = {}
    for name, (fn, S_, pos, n, bil) in passes.items():
        out = fn(False)
        err = float((out - fn(True)).abs().max())
        same = torch.equal(out, fn(False))
        print(f"score_offsets wide-FOV {name} {list(out.shape)} B="
              f"{pos[0].shape[1]}: max |err| {err:.3g} (tolerance 1e-5), "
              f"same bits twice {same}")
        if err > 1e-5 or not same:
            raise AssertionError(f"score_offsets at B={pos[0].shape[1]}")
        score[name] = dict(max_abs_err=err, beams=pos[0].shape[1],
                           shape=list(out.shape),
                           **_times(lambda: fn(False), lambda: fn(True),
                                    score_bound(S_, pos, valid, n, bil)))
    score["fine"]["coarse"] = score.pop("coarse")

    taps = correlative.gaussian_kernel_1d(
        m.sigma_m / g.resolution, blur_halo_cells(m, g.resolution))
    fkw = dict(occ_sat=m.occ_evidence_sat, free_threshold=m.free_threshold,
               free_penalty=m.free_penalty)
    gate = torch.ones((), dtype=torch.bool, device=device)
    S0 = torch.zeros_like(full)

    def field(plain):
        S_ = S0.clone()
        search_space_window(full, S_, taps, origin=None, size=tuple(
            full.shape), margin=0, gate=gate, plain=plain, **fkw)
        return S_

    err, n_diff = _search_space_cells_ok(field(False), field(True),
                                         "search_space wide-FOV full map")
    n_taps = len(taps)
    field_entry = dict(
        max_abs_err=err, cells_differing=n_diff, shape=list(full.shape),
        form="in place, origin None, gate on the device",
        **_times(lambda: field(False), lambda: field(True),
                 _bound(2 * full.numel() * 4,
                        full.numel() * (4 * n_taps + 8))),
    )
    return {"score_offsets": {"at_wide_fov": score["fine"]},
            "search_space": {"at_wide_fov": field_entry}}


def run_sampled_ray_frontend(cfg, log, device, label):
    """Phases 18 and 20: the frontend with the sampled-ray update
    (update_impl "sparse", or "auto" past a field of view of pi), as
    run_frontend runs it on CUDA: one CUDA graph replay a chunk, the update
    in place with its gate on the device (no kernel of its own). Runs the
    whole log twice through the graph: no host read during the scans, ATE
    below odometry's, the same bits twice, kernel 3 one launch a scan run
    + 1 and kernel 2 a match's passes a scan run, kernel 1 none; then the
    first 256 scans through the plain versions (phase 5's tolerances).
    Returns the launches of the first run."""
    if occupancy.resolve_update_impl(cfg.grid, cfg.sensor) not in (
            "sparse", "sparse_mxu"):
        raise AssertionError(f"{label}: the update is not the sampled-ray one")
    warm = {k: np.asarray(v)[: cfg.chunk] for k, v in log.items()}
    t0 = time.perf_counter()
    run_frontend(warm, cfg, device)   # builds the chunk graph
    capture_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    state, traj, scores, result = _timed_frontend(cfg, log, device, None)
    kept = state.logodds.clone()
    state2, traj2, scores2, again = _timed_frontend(cfg, log, device, None)
    T, scans_run = len(traj), result["scans_run"]
    if not np.isfinite(traj).all():
        raise AssertionError(f"{label}: trajectory is not finite")
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    twice = bool(np.array_equal(traj, traj2)
                 and np.array_equal(scores, scores2)
                 and torch.equal(state2.logodds, kept))
    part = {k: np.asarray(v)[:PARITY_SCANS] for k, v in log.items()}
    _, traj_plain, _ = run_frontend(part, cfg, device, plain=True)
    dxy, dth = _pose_errors(traj[:PARITY_SCANS], traj_plain)
    result.update(
        beams=cfg.sensor.n_beams, fov_rad=cfg.sensor.fov_rad,
        max_range_m=cfg.sensor.max_range,
        update_impl=occupancy.resolve_update_impl(cfg.grid, cfg.sensor),
        ate_m=ate, ate_odom_m=ate_odom, capture_s=capture_s,
        host_reads_per_scan=result["host_syncs"] / T,
        graph_again_scans_per_sec=again["scans_per_sec"],
        same_run_twice=twice, plain_scans=PARITY_SCANS,
        plain_dxy_m=dxy, plain_dth_rad=dth,
    )
    print(f"{label}:", json.dumps(result))
    if not ate < ate_odom:
        raise AssertionError(f"{label}: ATE {ate} not below odometry's "
                             f"{ate_odom}")
    if result["host_syncs"] or again["host_syncs"]:
        raise AssertionError(f"{label}: the frontend read the host")
    if not twice:
        raise AssertionError(f"{label}: two graph runs gave other bits")
    if dxy > POSE_TOL_M or dth > POSE_TOL_RAD:
        raise AssertionError(f"{label}: kernel and plain runs disagree")
    passes = _match_passes(cfg.matcher, cfg.grid.resolution)
    expect = {"update_hybrid": 0, "search_space": scans_run + 1,
              "score_offsets": passes * scans_run}
    for r in (result, again):
        if r["launches"] != expect:
            raise AssertionError(f"{label}: launches {r['launches']}, "
                                 f"expected {expect}")
    return {k: v for k, v in result["launches"].items() if v}


CLI_DIR = "chip_smoke_out"  # phase 21's outputs (git-ignored; removed
                            # after a run whose holds all pass)
CLI_SPLIT = 640           # phase 21 (f): the split scan, a multiple of 64
CLI_LOADER_SCANS = 512    # phase 21 (e): the scans written as .clf / .json
CLI_GLOBAL_TOL = (0.15, 0.1)  # phase 21 (b): global-init pose, m and rad
CLI_FASTSLAM_MAX_ATE_M = 1.0  # phase 22 (f): the --shard FastSLAM-100 run
CLI_PF_SEEDS = (0, 1, 2, 3, 4)  # phase 21 (d): proposal seeds a config
# phase 21 (d): JAX's CLI at FastSLAM-16 (`python -m slam2d_tpu.run.cli
# --mode fastslam --log synth --particles 16 --update-impl sparse --seed
# k`, k = 0-4, on the CPU; PERF.md §6). A run's median ATE over
# CLI_PF_SEEDS is held to at most their median + 0.1 m, phase 15's
# margin over JAX's run: single draws reach 1.84 m in JAX
JAX_CLI_PF16_ATES_M = (0.5768, 0.5066, 1.8436, 0.9822, 1.1312)
# and at FastSLAM-100 (`python -m slam2d_tpu.run.cli --mode fastslam
# --log synth --particles 100 --update-impl pallas --seed k --gt-ate`,
# k = 0-4, on the CPU, JAX 0.9.0, five at once: the ISM update the
# port's "auto" runs on the card, the JAX kernel in interpret mode;
# 2009.7-2017.2 s a run; PERF.md §6, PR 18)
JAX_CLI_PF100_ATES_M = (0.8742, 0.966, 0.5019, 0.4734, 0.3075)
JAX_CLI_PF_ATES_M = {100: JAX_CLI_PF100_ATES_M, 16: JAX_CLI_PF16_ATES_M}
CLI_PF_MARGIN_M = 0.1
CLI_PF_PARITY_UPDATES = 8  # phase 21 (d): map updates after the bootstrap
                           # held to the plain version at the CLI's
                           # FastSLAM-16
CLI_PF16 = ["--log", "synth", "--mode", "fastslam", "--particles", "16"]
CLI_PF_RUNS = (           # phase 21 (d): (particles, update_impl)
    (100, "auto"), (16, "sparse"), (16, "pallas_hybrid"), (16, "pallas_ray"),
)
CLI_VIDEO_SCANS = 320     # phase 21 (g): 5 chunks of 64


def _all_counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    return {**_counters(), **_pf_counters(),
            "update_ray": update_ray, "tridiag_factor": tridiag_factor,
            "update_hybrid_particles": update_hybrid_particles,
            "update_ray_particles": update_ray_particles}


def _cli(argv, label, device):
    """slam2d_tpu_torch.run.cli.main(argv) in this process on `device`,
    with every kernel count set to 0 just before it: (its metrics line,
    the kernels it launched)."""
    import contextlib
    import io

    from slam2d_tpu_torch.run import cli

    for fn in _all_counters().values():
        fn.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--device", str(device), *argv])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if rc != 0:
        raise AssertionError(f"CLI {label}: returned {rc}")
    metrics = json.loads(buf.getvalue().strip().splitlines()[-1])
    launches = {k: fn.launches for k, fn in _all_counters().items()
                if fn.launches}
    print(f"CLI {label}: {json.dumps(metrics)}")
    print(f"CLI {label}: {metrics['scans_per_sec']} scans/s on {card()}; "
          f"launches {launches}")
    return metrics, launches


def _cli_config(argv):
    """(log, FrontendConfig) the CLI builds from `argv`."""
    from slam2d_tpu_torch.run import cli

    return cli.load_run(cli.build_parser().parse_args(argv))


def _cli_pf_config(argv):
    """(log, FrontendConfig, PFConfig) the CLI's fastslam mode builds from
    `argv`."""
    from slam2d_tpu_torch.run import cli

    args = cli.build_parser().parse_args(argv)
    return (*cli.load_run(args), cli.pf_config(args))


def _saved_keyframes(ck_dir, template):
    """(poses, scan indices) of the keyframes in a full SLAM checkpoint
    that the CLI's --save-state wrote."""
    from slam2d_tpu_torch.utils.checkpoint import load_state

    ck = load_state(ck_dir, template)
    n = int(ck["kf_count"])
    return ck["kf_poses"][:n], ck["kf_scan_idx"][:n]


def update_path_parity(cfg, pf, log, device, n_updates, label):
    """Phase 21 (d): FastSLAM through the kernels over `log` up to its
    `n_updates`-th map update after the bootstrap, and each of those
    updates (fastslam._update_all) also made through its plain version on
    clones of the same inputs: the maps, the poses the refine gave, the
    scan. `ray` must agree bit for bit, the others to phase 3's map
    tolerance. (The whole step's parity, pf_parity, cannot
    hold `ray`'s maps: kernel 5 moves a refined pose by ~5e-7 m from the
    plain step's, and the exact-ray update weighs each cell by its chord,
    so such a move changes thousands of cells by up to ~2e-3.) Returns
    {updates, cells_differing, max_abs_err}."""
    real = fastslam._update_all
    bitwise = occupancy.resolve_update_impl(
        cfg.grid, cfg.sensor, auto_ctx="pf") == "pallas_ray"
    flags = fastslam.host_gate_flags(
        log["odom"], cfg, log["odom"][0], 0.0, np.inf, 0.0)
    scans = np.nonzero(flags[:, 1])[0]          # the scans that update
    first = int(flags[scans, 2].sum())          # the bootstrap's updates
    last = first + n_updates
    log = {k: v[: scans[last - 1] + 1] for k, v in log.items()}
    calls = [0]
    worst = dict(updates=0, cells_differing=0, max_abs_err=0.0)

    def held(logodds, poses, ranges, cfg_, pf_, plain=False):
        calls[0] += 1
        if plain or calls[0] <= first:
            return real(logodds, poses, ranges, cfg_, pf_, plain=plain)
        ref = real(logodds.clone(), poses, ranges, cfg_, pf_, plain=True)
        out = real(logodds, poses, ranges, cfg_, pf_)
        what = f"{label}: update at scan {scans[calls[0] - 1]}"
        if bitwise:
            cells = int((out != ref).sum())
            err = float((out.float() - ref.float()).abs().max())
            if cells:
                raise AssertionError(f"{what}: {cells} cells differ from "
                                     "the plain version")
        else:
            cells, err = _map_cells_ok(out, ref, cfg_.grid, what)
        worst["updates"] += 1
        worst["cells_differing"] = max(worst["cells_differing"], cells)
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        return out

    fastslam._update_all = held
    try:
        run_fastslam(log, cfg, pf, device, seed=SEED, host_gated=True)
    finally:
        fastslam._update_all = real
    print(f"{label}: the first {n_updates} map updates after the bootstrap "
          f"(scans {scans[first]}-{scans[last - 1]}) against the plain "
          f"version on the same inputs: at most {worst['cells_differing']} "
          f"cells differ, max |err| {worst['max_abs_err']:.3g} (tolerance: "
          f"{'bit-exact' if bitwise else 'phase 3 map tolerance'})")
    if calls[0] != last or worst["updates"] != n_updates:
        raise AssertionError(f"{label}: {calls[0]} map updates, expected "
                             f"{last} ({n_updates} held)")
    return worst


def run_cli(device):
    """Phase 21: the command line, slam2d_tpu_torch.run.cli.main,
    in this process on the card, at its defaults (1024^2 at 0.05 m, 180
    beams, chunk 64) on `--log synth`. Returns (the launches of each run
    by path name, update_path_parity's results by update_impl)."""
    from slam2d_tpu_torch.config import GraphConfig
    from slam2d_tpu_torch.data import load_carmen_log
    from slam2d_tpu_torch.data.carmen import (
        load_carmen_log as load_carmen_py,
        save_carmen_log,
        save_json_log,
    )
    from slam2d_tpu_torch.grid.tiles import TileConfig
    from slam2d_tpu_torch.run.full_slam import fullslam_ckpt_template
    from slam2d_tpu_torch.run.full_slam_tiled import (
        fullslam_tiled_ckpt_template,
    )
    from slam2d_tpu_torch.viz.video import VideoRecorder

    import shutil

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    by_path = {}
    synth = ["--log", "synth", "--gt-ate"]
    log, cfg = _cli_config(synth)
    gt, T = log["gt_poses"], len(log["odom"])

    def d(name):
        return os.path.join(CLI_DIR, name)

    # (a) the frontend, against run_frontend called directly; its chunk
    # graph captured first (a capture counts launches), as phase 4 does
    run_frontend({k: v[: cfg.chunk] for k, v in log.items()}, cfg, device)
    m, by_path["21a CLI frontend"] = _cli([*synth, "--out", d("front")],
                                          "frontend", device)
    if not m["ate_m"] < m["ate_odom_m"]:
        raise AssertionError(f"CLI frontend: ATE {m['ate_m']} not below "
                             f"odometry's {m['ate_odom_m']}")
    traj = np.load(d("front/trajectory.npy"))
    _, direct, _ = run_frontend(log, cfg, device)
    if not np.array_equal(traj, direct):
        raise AssertionError("CLI frontend: the trajectory differs from "
                             "run_frontend's on the same log and config")
    scans_run = -(-T // cfg.chunk) * cfg.chunk
    expect = {"update_hybrid": scans_run, "search_space": scans_run + 1,
              "score_offsets": 2 * scans_run}
    # (a CPU rehearsal runs the plain versions: nothing to count)
    if device.type == "cuda" and by_path["21a CLI frontend"] != expect:
        raise AssertionError(f"CLI frontend: launches "
                             f"{by_path['21a CLI frontend']}, expected "
                             f"{expect}")
    for f in ("map.pgm", "map.yaml", "grid.json", "map_logodds.npy",
              "metrics.json", "metrics.jsonl"):
        if not os.path.exists(d(f"front/{f}")):
            raise AssertionError(f"CLI frontend: {f} not written")

    # (b) localization on the map (a) wrote, as a ROS pair and as .npy
    for tag, extra in (
        ("yaml", ["--map", d("front/map.yaml"), "--global-init",
                  "--recover"]),
        ("npy", ["--map", d("front/map_logodds.npy")]),
    ):
        m, by_path[f"21b CLI localize {tag}"] = _cli(
            [*synth, "--mode", "localize", *extra], f"localize {tag}", device)
        if not m["ate_m"] < m["ate_odom_m"]:
            raise AssertionError(f"CLI localize {tag}: ATE {m['ate_m']} not "
                                 f"below odometry's {m['ate_odom_m']}")
        if tag == "yaml":
            dxy, dth = _pose_errors(np.asarray([m["global_init_pose"]]),
                                    gt[:1])
            print(f"CLI global init: {dxy:.4f} m, {dth:.4f} rad from the "
                  "true start")
            if dxy > CLI_GLOBAL_TOL[0] or dth > CLI_GLOBAL_TOL[1]:
                raise AssertionError("CLI global init: pose off the true "
                                     "start")

    # (c) full SLAM, bounded and tiled, each with its state saved: at
    # least one loop, keyframe ATE below odometry's at the same scans
    gcfg = GraphConfig()
    for tag, extra, template in (
        ("bounded", [], fullslam_ckpt_template(cfg, gcfg)),
        ("tiled", ["--tiled"], fullslam_tiled_ckpt_template(
            cfg, TileConfig(resolution=cfg.grid.resolution), gcfg)),
    ):
        ck = d(f"full_{tag}_state")
        m, by_path[f"21c CLI full {tag}"] = _cli(
            [*synth, "--mode", "full", *extra, "--save-state", ck,
             "--out", d(f"full_{tag}")], f"full {tag}", device)
        kf, idx = _saved_keyframes(ck, template)
        kf_ate = ate_rmse(kf, gt[idx], align=False)
        kf_odom = ate_rmse(log["odom"][idx], gt[idx], align=False)
        print(f"CLI full {tag}: {m['n_loops']} loops, {len(idx)} keyframes, "
              f"kf ATE {kf_ate:.4f} against odometry's {kf_odom:.4f}")
        if m["n_loops"] < 1 or not kf_ate < kf_odom:
            raise AssertionError(f"CLI full {tag}: no loop, or kf ATE not "
                                 "below odometry's")

    # (d) FastSLAM: the ISM update at 100 particles, then the sampled-ray
    # update and the particle forms of kernels 1 hybrid and ray at 16; one
    # run a proposal seed, every ATE finite, the median at most JAX's CLI
    # median over the same seeds + CLI_PF_MARGIN_M (a single draw here
    # spans 0.4-1.8 m at 16 particles in both packages and passes 1 m at
    # 100 in 3 of 38 runs). Below 512 particles the CLI takes the
    # device-gated strategy, as JAX's: at 100 particles each run is held
    # to replay the config's PF chunk graph once a whole chunk, each
    # capture launch once a scan, no host read (phase 23's accounting).
    # The particle forms' path is held to its plain version: the first
    # CLI_PF_PARITY_UPDATES map updates after the bootstrap of the CLI's
    # FastSLAM-16 made both ways on the same inputs (update_path_parity)
    parity = {}
    for P, impl in CLI_PF_RUNS:
        label = f"FastSLAM-{P} {impl}"
        argv = [*synth, "--mode", "fastslam", "--particles", str(P),
                "--update-impl", impl]
        graph = None
        if P == 100 and device.type == "cuda":
            plog, pcfg, ppf = _cli_pf_config(argv)
            graph = _pf_graph_launches(pcfg, ppf, device, label)
        ates, rates = [], []
        for seed in CLI_PF_SEEDS:
            replays = graph[0].replays if graph else 0
            _reset_pf_graph_counts()
            m, launches = _cli([*argv, "--seed", str(seed)],
                               f"{label} seed {seed}", device)
            by_path.setdefault(f"21d CLI {label}", launches)
            ates.append(m["ate_m"])
            rates.append(m["scans_per_sec"])
            want = {"pallas_hybrid": "update_hybrid_particles",
                    "pallas_ray": "update_ray_particles",
                    "auto": "update_ism"}.get(impl)
            if (device.type == "cuda" and want is not None
                    and not launches.get(want)):
                raise AssertionError(f"CLI {label}: {want} was not launched")
            if graph:
                _pf_graph_held(graph, replays, len(plog["odom"]),
                               f"CLI {label} seed {seed}",
                               others=sum(launches.values())
                               - sum(_pf_launch_counts().values()))
        median = float(np.median(ates))
        jax_ates = JAX_CLI_PF_ATES_M[P]
        limit = float(np.median(jax_ates)) + CLI_PF_MARGIN_M
        print(f"CLI {label}: ATE by seed {ates}, median {median:.4f} "
              f"(odometry {m['ate_odom_m']}; JAX's CLI {list(jax_ates)}; "
              f"held: median at most JAX's median + {CLI_PF_MARGIN_M}, "
              f"{limit:.4f} m); scans/s by seed {rates} on {card()}")
        if not (np.isfinite(ates).all() and median <= limit):
            raise AssertionError(f"CLI {label}: ATEs {ates}: not finite, or "
                                 f"the median above {limit:.4f}")
        if impl in ("pallas_hybrid", "pallas_ray"):
            plog, pcfg, ppf = _cli_pf_config(
                [*CLI_PF16, "--update-impl", impl])
            parity[impl] = update_path_parity(
                pcfg, ppf, plog, device, CLI_PF_PARITY_UPDATES,
                f"CLI {label}")

    # (e) the loaders: the log written by the port's writers as .clf (the
    # native parser reads it) and .json; the .clf run scored against a
    # relations file built from the ground truth
    part = {k: v[:CLI_LOADER_SCANS] for k, v in log.items()}
    clf, js = d("synth.clf"), d("synth.json")
    save_carmen_log(clf, part)
    save_json_log(js, part)
    nat = load_carmen_log(clf)
    if load_carmen_log.last_parser != "native":
        raise AssertionError("the native CARMEN parser did not run")
    py = load_carmen_py(clf)
    for k in ("odom", "ranges", "stamps"):
        if not np.array_equal(nat[k], py[k]):
            raise AssertionError(f"native parser: {k} differs from the "
                                 "Python parser's")
    rel = []
    for a in range(0, CLI_LOADER_SCANS - 100, 50):
        b = a + 100
        c, sn = np.cos(gt[a, 2]), np.sin(gt[a, 2])
        dd = gt[b, :2] - gt[a, :2]
        rel.append(f"{a:.6f} {b:.6f} {c * dd[0] + sn * dd[1]:.9f} "
                   f"{-sn * dd[0] + c * dd[1]:.9f} 0 0 0 "
                   f"{gt[b, 2] - gt[a, 2]:.9f}\n")
    with open(d("relations.txt"), "w") as f:
        f.writelines(rel)
    m, by_path["21e CLI frontend .clf"] = _cli(
        ["--log", clf, "--relations", d("relations.txt")], "frontend .clf",
        device)
    print(f"CLI relations: {m['relations_used']} of "
          f"{m['relations_total']} used, translation "
          f"{m['relations_trans_rmse_m']} m, rotation "
          f"{m['relations_rot_rmse_rad']} rad")
    if m["relations_used"] != len(rel):
        raise AssertionError("CLI relations: not every relation was used")
    _, by_path["21e CLI frontend .json"] = _cli(["--log", js],
                                               "frontend .json", device)

    # (f) resume: a split run against the single one, for the frontend
    # (1e-4, tests/test_resume.py's) and full SLAM (the keyframes and
    # loops, the rows after the cut within 1e-3)
    for mode, single in (("frontend", d("front")),
                         ("full", d("full_bounded"))):
        ck = d(f"split_{mode}_state")
        _cli([*synth, "--mode", mode, "--scan-range", "0", str(CLI_SPLIT),
              "--save-state", ck, "--out", d(f"split_{mode}_a")],
             f"{mode} split, first part", device)
        b, _ = _cli([*synth, "--mode", mode, "--scan-range", str(CLI_SPLIT),
                     str(T), "--resume-state", ck, "--out",
                     d(f"split_{mode}_b")], f"{mode} split, resumed", device)
        one = np.load(os.path.join(single, "trajectory.npy"))
        tb = np.load(d(f"split_{mode}_b/trajectory.npy"))
        if mode == "frontend":
            ta = np.load(d(f"split_{mode}_a/trajectory.npy"))
            err = float(np.abs(np.concatenate([ta, tb]) - one).max())
            ok = err <= 1e-4
        else:
            with open(os.path.join(single, "metrics.json")) as f:
                ref = json.load(f)
            err = float(np.abs(tb - one[CLI_SPLIT:]).max())
            ok = (err <= 1e-3 and (b["n_keyframes"], b["n_loops"])
                  == (ref["n_keyframes"], ref["n_loops"]))
        print(f"CLI {mode} split at {CLI_SPLIT}: max |split - single| "
              f"{err:.3g}")
        if not ok:
            raise AssertionError(f"CLI {mode}: the split run differs from "
                                 "the single run")

    # (g) the video hook: frames through VideoRecorder.add, one a chunk
    # (numpy only; saving a GIF needs PIL, tested on the CPU)
    rec = VideoRecorder(d("unsaved.gif"), cfg.grid)
    rec.set_ground_truth(gt)
    vlog = {k: v[:CLI_VIDEO_SCANS] for k, v in log.items()}
    run_frontend(vlog, cfg, device, frame_cb=rec.add)
    n_chunks = -(-CLI_VIDEO_SCANS // cfg.chunk)
    shapes = {f.shape for f in rec.frames}
    print(f"CLI video hook: {len(rec.frames)} frames of {shapes}")
    if len(rec.frames) != n_chunks or any(
            f.dtype != np.uint8 or f.ndim != 3 for f in rec.frames):
        raise AssertionError("video hook: not one uint8 RGB frame a chunk")
    shutil.rmtree(CLI_DIR)
    return by_path, parity


def _xy_err(poses, gt) -> float:
    p = np.asarray(poses, np.float64)
    return float(np.sqrt(np.mean(np.sum((p[:, :2] - gt[:, :2]) ** 2, 1))))


def sparse_solver_checks(device, fs_gcfg, fs_graph):
    """Phase 19, the solvers alone: (a) optimize_hier on the serpentine at
    K = 4096 and 16384 (tests/test_sparse_graph.py's graph, one rung
    closure per ~34 nodes): finite, error at least 5x below odometry's,
    chi2 < 1 (the JAX test's bounds) and at most 2x the JAX package's own
    error on the same graph (scripts/hier_reference.json); ms a solve
    (synced, the plan included and apart) and peak device memory; (b)
    optimize_cg on phase 15's final graph against the dense solve: poses
    within 1e-3 (tests/test_sparse_graph.py's). Returns the dict."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           HIER_REFERENCE)) as fh:
        ref = json.load(fh)["sizes"]
    out = {}
    for K in TRIDIAG_SIZES:
        arrays, gt, est, ckw = hier_bench_graph(K)
        gcfg = GraphConfig(**ckw)
        g = se2_graph.PoseGraph(**{k: torch.as_tensor(v, device=device)
                                   for k, v in arrays.items()})
        sparse.optimize_hier(g, gcfg)   # cuSOLVER and cuBLAS set up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ms, plan_ms = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = sparse.sparse_plan(g, gcfg, device, hier=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            g2, chi = sparse.optimize_hier(g, gcfg, plan=plan)
            poses = g2.poses.cpu().numpy()
            ms.append((time.perf_counter() - t0) * 1e3)
            plan_ms.append((t1 - t0) * 1e3)
        err, err_odom = _xy_err(poses, gt), _xy_err(est, gt)
        jax_err = ref[str(K)]["err_m"]
        r = dict(nodes=K, loops=int(arrays["n_edges"]) - (K - 1),
                 levels=[lv.K for lv in plan.levels], err_m=err,
                 err_odom_m=err_odom, chi2=float(chi), jax_err_m=jax_err,
                 jax_chi2=ref[str(K)]["chi2"],
                 ms=statistics.median(ms), plan_ms=statistics.median(plan_ms),
                 peak_memory_bytes=torch.cuda.max_memory_allocated(device),
                 dense_h_bytes=(3 * K) ** 2 * 4)
        out[f"hier_{K}"] = r
        print(f"optimize_hier K={K}:", json.dumps(r))
        if not (np.isfinite(poses).all() and err < err_odom / HIER_ODOM_FACTOR
                and float(chi) < 1.0):
            raise AssertionError(f"optimize_hier K={K}: the JAX test's "
                                 "bounds fail")
        if not err <= HIER_ERR_JAX_FACTOR * jax_err:
            raise AssertionError(
                f"optimize_hier K={K}: error {err} above {HIER_ERR_JAX_FACTOR}"
                f" x the JAX package's {jax_err}")

    host = se2_graph.HostGraph.from_arrays(fs_gcfg, fs_graph)
    n = host.n_nodes
    g = host.to_device(device)
    dense, _ = se2_graph.optimize(g, fs_gcfg)
    cg, _ = sparse.optimize_cg(
        g, fs_gcfg, plan=sparse.sparse_plan(host, fs_gcfg, device, hier=False))
    dxy, dth = _pose_errors(cg.poses[:n].cpu().numpy(),
                            dense.poses[:n].cpu().numpy())
    out["cg_vs_dense"] = dict(nodes=n, edges=host.n_edges, dxy_m=dxy,
                              dth_rad=dth, tolerance=CG_DENSE_TOL)
    print("optimize_cg on phase 15's graph:", json.dumps(out["cg_vs_dense"]))
    if max(dxy, dth) > CG_DENSE_TOL:
        raise AssertionError(f"optimize_cg and the dense solve differ by "
                             f"{max(dxy, dth)} > {CG_DENSE_TOL}")
    return out


def run_sparse_hier_fullslam(cfg, gcfg, log, device):
    """Phase 19, full SLAM: run_full_slam at fullslam_bench_config with the
    sampled-ray update and optimizer="hier" at hier_dense_max 64, so that
    every solve runs the V-cycle (32 anchors solved dense, the rigid
    prolongation, optimize_cg's PCG polish over the 512 slots):
    run_fullslam's checks, the stages each solve ran, and the hold to the
    JAX package's run of the same config (keyframe ATE at most JAX's +
    0.1 m, scripts/fullslam_reference_sparse_hier.json). Returns
    (launches, result dict, (graph config, final graph's arrays))."""
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, update_impl="sparse"))
    gcfg = dataclasses.replace(gcfg, hier_dense_max=PHASE19_HIER_DENSE_MAX)
    stages = dict(sparse.optimize_hier.stages)
    launches, res = run_fullslam(cfg, gcfg, log, device, optimizer="hier",
                                 label="sparse-update full SLAM (hier)")
    ran = {k: sparse.optimize_hier.stages[k] - v for k, v in stages.items()}
    # the polish factors the chain matrix once a Gauss-Newton iteration
    launches["tridiag_factor"] = tridiag_factor.launches
    if tridiag_factor.launches != gcfg.gn_iters * ran["polish"]:
        raise AssertionError(f"tridiag_factor launched {tridiag_factor.launches}"
                             f" times for {ran['polish']} polishes")
    out = dict(stages=ran, accepts=res.n_loops,
               beside_jax=held_to_jax(res, log, FULLSLAM_SPARSE_HIER_REFERENCE,
                                      "sparse-update full SLAM (hier)"))
    print("sparse-update full SLAM (hier) stages:", json.dumps(ran))
    if not ran["vcycle"] == ran["polish"] >= res.n_loops:
        raise AssertionError(f"hier stages {ran} for {res.n_loops} accepts")
    return launches, out, (gcfg, res.ckpt["graph"])


# ---- phase 22: multi-device (parallel/mesh.py) -----------------------------

MD_RANKS = 4              # (b), (d), (e), (g): ranks sharing the card (gloo)
MD_SCANS = 512            # (b): the first 512 scans of bench_pf's log
MD_PLAIN_STEPS = 8        # (c): heavy steps after the bootstrap, plain too
#                           (and then the first whose resample takes a hop)
MD_TILED_SCANS = 1024     # (d): the 4-rank tiled run's scans (16 chunks)
MD_TILED_SCANS_1 = 2048   # (d): the 1-rank tiled run's scans (32 chunks)
# (d): a second 4-rank run on a pool of 16 slots, 4 a rank, so that the 8
# tiles the first MD_TILED_SCANS activate span two ranks and the window
# gather's psum merges pieces of two owners
MD_SPREAD_SLOTS = 16
MD_TIMEOUT_S = 300        # a collective's wait, and 4x it a whole run
# (b): with the modes pinned per particle the four ranks run the one-rank
# port's filter (the same draws, resamples and poses); the reported best
# pose differs at the resample scans alone (before against after the
# resample), by a draw of the particles' spread (0.18-0.47 m), so the
# trajectories are held bit for bit at the other scans and the ATE, which
# takes every scan, within 0.03 m (tests/test_torch_fastslam.py's)
MD_RUN_ATE_TOL_M = 0.03
# (e): optimize_cg_sharded on the 4096-node serpentine against the
# single-device optimize_cg (which does not converge there: 2.098 m of
# error against odometry's 3.368 m), from the readings of 2.77e-3 m and
# an error ratio of 1.0001: an unsolved graph lies metres off
MD_SERP_CG_TOL_M = 1e-2
MD_SERP_CG_ERR_RATIO = 1.01
# (f): the CLI's FastSLAM-100 and full SLAM runs of phase 21, split
MD_CLI_PF = ["--log", "synth", "--gt-ate", "--mode", "fastslam",
             "--particles", "100", "--shard"]
MD_CLI_FULL = ["--log", "synth", "--gt-ate", "--mode", "full",
               "--optimizer", "schur_sharded"]


def _md_sync_peak(dev):
    """Wait for `dev`; its peak memory so far (0 on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev)
    return 0


def _md_launches_held(label, got, expect, device):
    """Raise unless a run launched each kernel as its decisions call for
    (on the card; a rehearsal on the CPU launches none)."""
    if device.type == "cuda" and got != expect:
        raise AssertionError(f"{label}: launches {got}, expected {expect}")


def _md_reset():
    for fn in _all_counters().values():
        fn.launches = 0
    for name in ("host_syncs", "refines", "updates", "resamples"):
        setattr(sharded.sharded_step, name, 0)
    sharded.ring_exchange.hops = 0
    sharded.ring_exchange.d_max.clear()
    for name in ("host_syncs", "matches", "updates"):
        setattr(frontend_tiled_sharded.sharded_tiled_step, name, 0)


def _md_launches():
    return {k: fn.launches for k, fn in _all_counters().items() if fn.launches}


def _resample_scans(log, cfg, pf, n_eff):
    """The scans of a run that resampled: the refine scans whose reported
    N_eff fell below the threshold."""
    odom = np.asarray(log["odom"], np.float32)
    flags = fastslam.host_gate_flags(odom, cfg, odom[0], 0.0, np.inf, 0.0)
    return flags[:, 0] & (n_eff < pf.resample_threshold * pf.n_particles)


def _md_held(traj, ref, skip, label):
    """Max pose error of `traj` against `ref` at the scans not in `skip`
    (the resample scans, where the sharded step reports the best particle
    before the resample, as JAX's sharded step does, and the single-device
    step one after); raises past POSE_TOL."""
    keep = ~np.asarray(skip)
    dxy, dth = _pose_errors(traj[keep], ref[keep])
    print(f"{label}: max |dxy| {dxy:.3g} m, max |dtheta| {dth:.3g} rad over "
          f"{int(keep.sum())} scans ({int((~keep).sum())} resample scans "
          f"apart; tolerance {POSE_TOL_M} / {POSE_TOL_RAD})")
    if dxy > POSE_TOL_M or dth > POSE_TOL_RAD:
        raise AssertionError(f"{label}: the runs disagree")
    return dict(dxy_m=dxy, dth_rad=dth, resample_scans=int((~keep).sum()))


def _md_run_held(traj, ref, skip, ref_skip, gt, label):
    """(b)'s hold of a run against the one-rank port's (MD_RUN_ATE_TOL_M):
    the same resample scans (`skip`, `ref_skip`), the same bits at every
    other scan, the ATE within the tolerance; raises past it."""
    keep = ~np.asarray(skip)
    same_scans = bool(np.array_equal(skip, ref_skip))
    same_bits = bool(np.array_equal(traj[keep], ref[keep]))
    dxy, dth = _pose_errors(traj, ref)
    ate, ate_ref = (ate_rmse(t, gt, align=False) for t in (traj, ref))
    print(f"{label}: the same {int((~keep).sum())} resample scans "
          f"{same_scans}, the same bits at the other {int(keep.sum())} "
          f"{same_bits}; max |dxy| {dxy:.4g} m (at a resample scan), ATE "
          f"{ate:.5f} m against {ate_ref:.5f} (tolerance "
          f"{MD_RUN_ATE_TOL_M} m)")
    if (not (same_scans and same_bits)
            or abs(ate - ate_ref) > MD_RUN_ATE_TOL_M):
        raise AssertionError(f"{label}: the runs disagree")
    return dict(dxy_m=dxy, dth_rad=dth, ate_m=ate, ate_ref_m=ate_ref,
                resample_scans=int((~keep).sum()))


def _md_fastslam(mesh, log, cfg, pf, seed):
    """Rank body of (a) and (b): run_sharded_fastslam, timed, with the
    kernel launches, the counts of the step and the ring, the bytes staged
    through the host and the peak memory of this rank."""
    _md_reset()
    dev = mesh.device
    staged0 = mesh.staged_bytes
    _md_sync_peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, traj, n_eff, _ = run_sharded_fastslam(log, cfg, pf, seed=seed,
                                                 mesh=mesh)
    peak = _md_sync_peak(dev)
    wall = time.perf_counter() - t0
    st = sharded.sharded_step
    T = len(traj)
    return dict(
        traj=traj, n_eff=n_eff, scans=T, seconds=wall, scans_per_sec=T / wall,
        refines=st.refines, updates=st.updates, resamples=st.resamples,
        host_syncs=st.host_syncs, d_max=list(sharded.ring_exchange.d_max),
        hops=sharded.ring_exchange.hops, local_particles=state.poses.shape[0],
        staged_bytes=mesh.staged_bytes - staged0,
        staged_bytes_per_scan=(mesh.staged_bytes - staged0) / T,
        peak_memory_bytes=peak, launches=_md_launches(),
    )


def _md_expected(cfg, pf, r, ranks):
    """The launches of each PF kernel a rank's run calls for: _pf_expected
    at the rank's particle count, the row gather once a resample and once
    a ring hop."""
    local = dataclasses.replace(pf, n_particles=pf.n_particles // ranks)
    expect = _pf_expected(cfg, local, r)
    expect["gather_rows"] = r["resamples"] + r["hops"]
    return {k: v for k, v in expect.items() if v}


def _md_plain_steps(mesh, log, cfg, pf, seed, n_steps):
    """(c): sharded_step over the log until `n_steps` heavy steps after the
    bootstrap, and at least one heavy step whose resample moved maps
    through the ring (d_max >= 1), have run, each of those also from a
    copy of the same state with the same draws through every kernel's
    plain version: the worst pose difference of this rank's particles,
    the share of its map cells that differ, and the ring hops both
    versions ran. Raises if the log ends first."""
    dev = mesh.device
    odom = torch.as_tensor(np.asarray(log["odom"], np.float32), device=dev)
    ranges = torch.as_tensor(np.asarray(log["ranges"], np.float32),
                             device=dev)
    odom_np = np.asarray(log["odom"], np.float32)
    flags = fastslam.host_gate_flags(odom_np, cfg, odom_np[0], 0.0, np.inf,
                                     0.0)
    state = sharded.sharded_fastslam_init(cfg, pf, mesh,
                                          start_pose=odom_np[0])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    _, ne = sharded._global_log_normalize(state.log_w, mesh)
    worst_pose, worst_cells, worst_best, done = 0.0, 0.0, 0.0, 0
    ring_steps, ring_hops, ring_d_max = 0, 0, []
    ring = sharded.ring_exchange
    for t in range(len(odom_np)):
        r, u_, b = (bool(x) for x in flags[t])
        noise = (torch.randn((pf.n_particles, 3), generator=gen, device=dev)
                 if r or b else None)
        u = torch.rand((), generator=gen, device=dev) if r else None
        kw = dict(gates=flags[t], n_eff=ne, noise=noise, u=u)
        if not ((r or u_) and not b):
            state, (_, _, _, ne) = sharded.sharded_step(
                state, odom[t], ranges[t], cfg, pf, mesh, **kw)
            continue
        # the kernels' step first; past the first n_steps the plain
        # version runs only where the resample took a ring hop (every
        # rank takes the same branch: d_max is a pmax)
        copy = fastslam.PFState(*(x.clone() for x in state))
        h0, d0 = ring.hops, len(ring.d_max)
        state, (bp, _, _, ne_next) = sharded.sharded_step(
            state, odom[t], ranges[t], cfg, pf, mesh, **kw)
        hops = ring.hops - h0
        if done >= n_steps and hops == 0:
            ne = ne_next
            continue
        d_max = ring.d_max[d0:]
        h1 = ring.hops
        plain, (bp_p, _, _, _) = sharded.sharded_step(
            copy, odom[t], ranges[t], cfg, pf, mesh, plain=True, **kw)
        if ring.hops - h1 != hops:
            raise AssertionError(f"22c: {hops} ring hops with the kernels, "
                                 f"{ring.hops - h1} plain")
        ne = ne_next
        dxy, dth = _pose_errors(state.poses.cpu().numpy(),
                                plain.poses.cpu().numpy())
        bxy, bth = _pose_errors(bp.cpu().numpy()[None],
                                bp_p.cpu().numpy()[None])
        cells = float((state.logodds != plain.logodds).float().mean())
        worst_pose = max(worst_pose, dxy, dth)
        worst_best = max(worst_best, bxy, bth)
        worst_cells = max(worst_cells, cells)
        done += 1
        if hops:
            ring_steps += 1
            ring_hops += hops
            ring_d_max += d_max
        if done >= n_steps and ring_steps:
            break
    if not ring_steps:
        raise AssertionError(f"22c: no resample took a ring hop in "
                             f"{len(odom_np)} scans ({done} steps checked)")
    return dict(steps=done, max_pose_diff=worst_pose,
                max_best_pose_diff=worst_best, max_cell_share=worst_cells,
                ring_steps=ring_steps, ring_hops=ring_hops,
                ring_d_max=ring_d_max)


def _md_four(mesh, pf_args, tiled_args, solver_args):
    """Rank body of the four-rank parts, one world for all of them: (c)
    the kernel-against-plain steps, (b) the run at `pf` (the modes as they
    resolve at P / 4) and at `pinned`, (d) the tiled frontend on the
    bench pool and on one of MD_SPREAD_SLOTS slots, (e) the solvers."""
    log, cfg, pf, pinned, seed, n_plain = pf_args
    out = dict(plain=_md_plain_steps(mesh, log, cfg, pf, seed, n_plain),
               auto=_md_fastslam(mesh, log, cfg, pf, seed),
               pinned=_md_fastslam(mesh, log, cfg, pinned, seed))
    tlog, tcfg_f, tcfg = tiled_args
    out["tiled"] = _md_tiled(mesh, tlog, tcfg_f, tcfg)
    out["tiled_spread"] = _md_tiled(
        mesh, tlog, tcfg_f,
        dataclasses.replace(tcfg, n_slots=MD_SPREAD_SLOTS))
    out["solvers"] = _md_solvers(mesh, *solver_args)
    return out


def _md_tiled(mesh, log, cfg, tcfg):
    """Rank body of (d): run_sharded_tiled_frontend, timed, with its
    launches and counts."""
    _md_reset()
    dev = mesh.device
    staged0 = mesh.staged_bytes
    _md_sync_peak(dev)
    t0 = time.perf_counter()
    state, traj, _ = frontend_tiled_sharded.run_sharded_tiled_frontend(
        log, cfg, tcfg, mesh=mesh)
    _md_sync_peak(dev)
    wall = time.perf_counter() - t0
    st = frontend_tiled_sharded.sharded_tiled_step
    T = len(traj)
    return dict(traj=traj, scans=T, seconds=wall, scans_per_sec=T / wall,
                matches=st.matches, updates=st.updates,
                host_syncs=st.host_syncs, launches=_md_launches(),
                local_tiles_with_content=int(
                    (state.tiles.abs().sum((1, 2)) > 0).sum()),
                local_slots=state.tiles.shape[0],
                active_tiles=int((state.coords[:-1, 0] > int(FREE_SLOT))
                                 .sum()),
                staged_bytes_per_scan=(mesh.staged_bytes - staged0) / T)


def _md_solvers(mesh, fs_arrays, fs_gcfg, serp_arrays, serp_gcfg):
    """Rank body of (e): the three sharded solvers, each timed (synced):
    make_optimize_sharded and optimize_schur_sharded (4 blocks) on phase
    15's graph, optimize_cg_sharded on phase 19's 4096-node serpentine."""
    dev = mesh.device
    _md_reset()
    g = se2_graph.PoseGraph(**{k: torch.as_tensor(v, device=dev)
                               for k, v in fs_arrays.items()})
    gs = se2_graph.PoseGraph(**{k: torch.as_tensor(v, device=dev)
                                for k, v in serp_arrays.items()})
    out = {}
    for name, fn in (
        ("dense", lambda: se2_graph.make_optimize_sharded(fs_gcfg, mesh)(g)),
        ("schur", lambda: schur.optimize_schur_sharded(g, fs_gcfg, mesh,
                                                       MD_RANKS)),
        ("cg_fs", lambda: sparse.optimize_cg_sharded(g, fs_gcfg, mesh)),
        ("cg", lambda: sparse.optimize_cg_sharded(gs, serp_gcfg, mesh)),
    ):
        _md_sync_peak(dev)
        t0 = time.perf_counter()
        g2, chi = fn()
        poses = g2.poses.cpu().numpy()
        out[name] = dict(poses=poses, chi2=float(chi),
                         ms=(time.perf_counter() - t0) * 1e3)
    out["launches"] = _md_launches()
    out["staged_bytes"] = mesh.staged_bytes
    return out


def _md_nccl_probe(mesh):
    """(h): one all_gather over NCCL."""
    x = torch.full((4,), float(mesh.rank), device=mesh.device)
    return mesh.all_gather(x).cpu().numpy()


def run_multidevice(device, pf_log, cfg1k, pf1k, tiled_cfg, tcfg, tiled_log,
                    tiled_traj, fs_gcfg, fs_graph, one_rank="nccl"):
    """Phase 22: parallel/mesh.py's worlds on the card (module docstring),
    the one-rank worlds over `one_rank` (gloo for a rehearsal on the CPU).
    Returns (the launches of each path, the results)."""
    by_path, out = {}, {}
    n_cards = torch.cuda.device_count()
    t_start = time.perf_counter()

    def part_done(name):
        out.setdefault("seconds", {})[name] = time.perf_counter() - t_start
        print(f"22{name} done at {out['seconds'][name]:.1f} s")

    # (a) one rank over NCCL, FastSLAM-1000 over bench_pf's log, against
    # the single-device port's run with the same seed
    _md_reset()
    (a,) = pmesh.spawn(_md_fastslam, 1, one_rank, device,
                       args=(pf_log, cfg1k, pf1k, SEED))
    _, ref, ref_neff, _ = run_fastslam(pf_log, cfg1k, pf1k, device, seed=SEED)
    skip = _resample_scans(pf_log, cfg1k, pf1k, a["n_eff"])
    a["held"] = _md_held(a["traj"], ref, skip, "22a FastSLAM-1000, 1 rank")
    _md_launches_held("22a", a["launches"], _md_expected(cfg1k, pf1k, a, 1),
                      device)
    by_path["22a sharded FastSLAM-1000, 1 rank (NCCL)"] = a["launches"]
    d_hist = {d: a["d_max"].count(d) for d in sorted(set(a["d_max"]))}
    out["a"] = {k: v for k, v in a.items() if k not in ("traj", "n_eff")}
    out["a"]["d_max_hist"] = d_hist
    print(f"22a: {a['scans_per_sec']:.2f} scans/s, {a['resamples']} "
          f"resamples, d_max histogram {d_hist}, peak memory "
          f"{a['peak_memory_bytes']} B on {card()}")

    part_done("a")

    # (b), (c) four ranks sharing the card over gloo, the first MD_SCANS
    # scans; the modes as they resolve at P / 4 (auto) and pinned per
    # particle, the pinned run against the single-device port's
    part = {k: np.asarray(v)[:MD_SCANS] for k, v in pf_log.items()}
    pinned = dataclasses.replace(pf1k, refine_mode="per_particle",
                                 update_mode="per_particle")
    tpart = {k: np.asarray(v)[:MD_TILED_SCANS] for k, v in tiled_log.items()}
    host = se2_graph.HostGraph.from_arrays(fs_gcfg, fs_graph)
    fs_arrays = {f: np.asarray(getattr(host, f)) for f in (
        "poses", "node_mask", "edges_ij", "edges_z", "edges_omega",
        "edge_mask")}
    fs_arrays["n_nodes"] = np.int32(host.n_nodes)
    fs_arrays["n_edges"] = np.int32(host.n_edges)
    serp, serp_gt, _, ckw = hier_bench_graph(TRIDIAG_SIZES[0])
    serp_gcfg = GraphConfig(**ckw)
    four = pmesh.spawn(
        _md_four, MD_RANKS, "gloo", device, args=(
            (part, cfg1k, pf1k, pinned, SEED, MD_PLAIN_STEPS),
            (tpart, tiled_cfg, tcfg),
            (fs_arrays, fs_gcfg, serp, serp_gcfg)),
        timeout_s=MD_TIMEOUT_S)
    part_done("bcde 4-rank world")
    b = four
    auto = [r["auto"] for r in b]
    for r in auto[1:]:
        if not np.array_equal(r["traj"], auto[0]["traj"]):
            raise AssertionError("22b: the ranks' trajectories differ")
    ate = ate_rmse(auto[0]["traj"], part["gt_poses"], align=False)
    hops = auto[0]["hops"]
    launches_b = {}
    for r in auto:
        _md_launches_held("22b", r["launches"],
                          _md_expected(cfg1k, pf1k, r, MD_RANKS), device)
        for k, v in r["launches"].items():
            launches_b[k] = launches_b.get(k, 0) + v
    by_path["22b sharded FastSLAM-1000, 4 ranks (gloo)"] = launches_b
    _, ref_p, ref_p_neff, _ = run_fastslam(part, cfg1k, pinned, device,
                                           seed=SEED)
    pin = b[0]["pinned"]
    held_p = _md_run_held(
        pin["traj"], ref_p, _resample_scans(part, cfg1k, pinned,
                                            pin["n_eff"]),
        _resample_scans(part, cfg1k, pinned, ref_p_neff), part["gt_poses"],
        "22b per-particle FastSLAM-1000, 4 ranks")
    out["b"] = dict(
        auto={k: v for k, v in auto[0].items() if k not in ("traj", "n_eff")},
        ate_m=ate, pinned_held=held_p,
        pinned={k: v for k, v in pin.items() if k not in ("traj", "n_eff")},
        staged_bytes_per_scan=[r["staged_bytes_per_scan"] for r in auto],
        d_max_hist={d: auto[0]["d_max"].count(d)
                    for d in sorted(set(auto[0]["d_max"]))},
    )
    print(f"22b: {auto[0]['scans_per_sec']:.2f} scans/s, ATE {ate:.4f} m, "
          f"{auto[0]['resamples']} resamples, {hops} ring hops, "
          f"{auto[0]['staged_bytes_per_scan']:.0f} B staged a scan a rank, "
          f"d_max histogram {out['b']['d_max_hist']}")
    # beside (a) over the same scans (printed, not held: at P / 4 the
    # shared refine and update take their rank's means, as JAX's do)
    dxy_a, _ = _pose_errors(auto[0]["traj"], a["traj"][:MD_SCANS])
    out["b"]["auto_vs_a"] = dict(
        dxy_m=dxy_a, ate_a_m=ate_rmse(a["traj"][:MD_SCANS],
                                      part["gt_poses"], align=False))
    print(f"22b beside 22a: max |dxy| {dxy_a:.4g} m, ATE {ate:.5f} against "
          f"{out['b']['auto_vs_a']['ate_a_m']:.5f}")
    if not ate <= PF_MAX_ATE_M:
        raise AssertionError(f"22b: ATE {ate} above {PF_MAX_ATE_M} m")
    if hops < 1:
        raise AssertionError("22b: no ring hop")
    plain = [r["plain"] for r in b]
    out["c"] = dict(
        steps=plain[0]["steps"], ring_steps=plain[0]["ring_steps"],
        ring_hops=plain[0]["ring_hops"], ring_d_max=plain[0]["ring_d_max"],
        max_pose_diff=max(r["max_pose_diff"] for r in plain),
        max_best_pose_diff=max(r["max_best_pose_diff"] for r in plain),
        max_cell_share=max(r["max_cell_share"] for r in plain),
        tolerance=dict(pose=PF_POSE_TOL, cells=MAP_CELL_SHARE))
    print("22c kernels against plain:", json.dumps(out["c"]))
    if (out["c"]["steps"] < MD_PLAIN_STEPS or out["c"]["ring_hops"] < 1
            or out["c"]["max_pose_diff"] > PF_POSE_TOL
            or out["c"]["max_best_pose_diff"] > PF_POSE_TOL
            or out["c"]["max_cell_share"] > MAP_CELL_SHARE):
        raise AssertionError("22c: kernel and plain sharded steps disagree")


    # (d) the tiled frontend on the split pool: one rank (NCCL) over the
    # first MD_TILED_SCANS_1 scans of the lap, four (gloo) over the first
    # MD_TILED_SCANS on the bench pool and on MD_SPREAD_SLOTS slots, each
    # against phase 13's single-device run
    _md_reset()
    (d1,) = pmesh.spawn(_md_tiled, 1, one_rank, device, args=(
        {k: np.asarray(v)[:MD_TILED_SCANS_1] for k, v in tiled_log.items()},
        tiled_cfg, tcfg))
    d4 = [r["tiled"] for r in four]
    ds = [r["tiled_spread"] for r in four]
    for rs in (d4, ds):
        if not all(np.array_equal(r["traj"], rs[0]["traj"]) for r in rs):
            raise AssertionError("22d: the ranks' trajectories differ")
    out["d"] = {}
    for key, r, ref_t in (("1 rank", d1, tiled_traj[:MD_TILED_SCANS_1]),
                          ("4 ranks", d4[0], tiled_traj[:MD_TILED_SCANS]),
                          (f"4 ranks, {MD_SPREAD_SLOTS} slots", ds[0],
                           tiled_traj[:MD_TILED_SCANS])):
        dxy, dth = _pose_errors(r["traj"], ref_t)
        same = bool(np.array_equal(r["traj"], ref_t))
        out["d"][key] = dict(
            {k: v for k, v in r.items() if k != "traj"},
            same_bits=same, dxy_m=dxy, dth_rad=dth)
        print(f"22d tiled frontend, {key}: {r['scans_per_sec']:.2f} scans/s, "
              f"same bits as phase 13: {same}, max |dxy| {dxy:.3g} m")
        if dxy > POSE_TOL_M or dth > POSE_TOL_RAD:
            raise AssertionError(f"22d {key}: the sharded tiled frontend "
                                 "parts from the single-device run")
        _md_launches_held(f"22d {key}", r["launches"], {
            "update_hybrid": r["updates"], "search_space": r["updates"],
            "score_offsets": 2 * r["matches"]}, device)
    # the slots fill in order: on the bench pool (16 slots a rank) every
    # tile of these scans sits on rank 0; on the small pool they must span
    # two ranks, and that run must give phase 13's bits
    for key, rs in (("4 ranks", d4),
                    (f"4 ranks, {MD_SPREAD_SLOTS} slots", ds)):
        spread = sum(r["local_tiles_with_content"] > 0 for r in rs)
        out["d"][key]["ranks_with_content"] = spread
        print(f"22d {key}: {rs[0]['active_tiles']} active tiles, "
              f"{rs[0]['local_slots']} slots a rank, content on {spread} "
              "ranks")
    spread_d = out["d"][f"4 ranks, {MD_SPREAD_SLOTS} slots"]
    if spread_d["ranks_with_content"] < 2:
        raise AssertionError("22d: the small pool's map did not spread "
                             "over the ranks")
    if not spread_d["same_bits"]:
        raise AssertionError("22d: the spread run differs from phase 13's "
                             "bits")
    by_path["22d sharded tiled frontend, 1 rank (NCCL)"] = d1["launches"]


    # (e) the three sharded solvers at 4 ranks
    e = [r["solvers"] for r in four]
    g = host.to_device(device)
    n = host.n_nodes
    dense = se2_graph.optimize(g, fs_gcfg)[0].poses[:n].cpu().numpy()
    gs = se2_graph.PoseGraph(**{k: torch.as_tensor(v, device=device)
                                for k, v in serp.items()})
    cg1 = sparse.optimize_cg(gs, serp_gcfg)[0].poses.cpu().numpy()
    cg_fs = sparse.optimize_cg(g, fs_gcfg)[0].poses[:n].cpu().numpy()
    out["e"] = {}
    for name, ref_e, k, tol in (("dense", dense, n, FULLSLAM_POSE_TOL),
                                ("schur", dense, n, FULLSLAM_POSE_TOL),
                                ("cg_fs", cg_fs, n, CG_DENSE_TOL)):
        for r in e[1:]:
            if not np.array_equal(r[name]["poses"], e[0][name]["poses"]):
                raise AssertionError(f"22e {name}: the ranks differ")
        dxy, dth = _pose_errors(e[0][name]["poses"][:k], ref_e[:k])
        out["e"][name] = dict(dxy_m=dxy, dth_rad=dth, tolerance=tol,
                              ms=e[0][name]["ms"], chi2=e[0][name]["chi2"])
        print(f"22e {name} sharded over {MD_RANKS} ranks: "
              f"{json.dumps(out['e'][name])}")
        if max(dxy, dth) > tol:
            raise AssertionError(f"22e {name}: {max(dxy, dth)} > {tol}")
    # the 4096-node serpentine: optimize_cg alone does not converge there
    # (phase 19 solves it with optimize_hier), and f32 PCG from another
    # sum order lands a little off the single-device optimize_cg's
    # iterate, so the sharded solve is held to that iterate within
    # MD_SERP_CG_TOL_M and to its error against the truth within
    # MD_SERP_CG_ERR_RATIO
    cg4 = e[0]["cg"]["poses"]
    for r in e[1:]:
        if not np.array_equal(r["cg"]["poses"], cg4):
            raise AssertionError("22e cg: the ranks differ")
    err, err1 = _xy_err(cg4, serp_gt), _xy_err(cg1, serp_gt)
    dxy, dth = _pose_errors(cg4, cg1)
    out["e"]["cg"] = dict(nodes=len(cg1), err_m=err, single_err_m=err1,
                          dxy_m=dxy, dth_rad=dth,
                          chi2=e[0]["cg"]["chi2"], ms=e[0]["cg"]["ms"])
    print(f"22e cg sharded over {MD_RANKS} ranks, serpentine: "
          f"{json.dumps(out['e']['cg'])}")
    if not (np.isfinite(cg4).all() and dxy <= MD_SERP_CG_TOL_M
            and err <= MD_SERP_CG_ERR_RATIO * err1):
        raise AssertionError(f"22e cg: {out['e']['cg']}")
    launches_e = {}
    for r in e:
        for k, v in r["launches"].items():
            launches_e[k] = launches_e.get(k, 0) + v
    # one factor a Gauss-Newton iteration of each CG solve, on every rank
    if (device.type == "cuda" and launches_e.get("tridiag_factor", 0)
            != (fs_gcfg.gn_iters + serp_gcfg.gn_iters) * MD_RANKS):
        raise AssertionError(f"22e: launches {launches_e}")
    by_path["22e sharded solvers, 4 ranks (gloo)"] = launches_e

    part_done("de")

    # (f) the CLI's --shard and --optimizer schur_sharded, one rank a card
    m, by_path["22f CLI --shard FastSLAM-100"] = _cli(
        [*MD_CLI_PF, "--out", os.path.join(CLI_DIR, "shard")],
        "--shard FastSLAM-100", device)
    if not m["ate_m"] <= CLI_FASTSLAM_MAX_ATE_M:
        raise AssertionError(f"22f --shard: ATE {m['ate_m']}")
    out["f"] = dict(fastslam=m)
    m, by_path["22f CLI full schur_sharded"] = _cli(
        [*MD_CLI_FULL, "--out", os.path.join(CLI_DIR, "schur_sharded")],
        "full --optimizer schur_sharded", device)
    if not (m["n_loops"] >= 1 and m["ate_m"] < m["ate_odom_m"]):
        raise AssertionError(f"22f schur_sharded: {m}")
    out["f"]["full"] = m

    part_done("f")

    # (g) the dry run over gloo at 4 ranks on the card
    g_res = dryrun.dryrun_multichip(MD_RANKS, "gloo", device)
    out["g"] = g_res[0]["line"]
    print(f"22g: {g_res[0]['line']}")

    part_done("g")

    # (h) NCCL across cards, and NCCL with two ranks on one card
    if n_cards >= 2:
        k = min(4, n_cards)
        res = pmesh.spawn(_md_nccl_probe, k, "nccl", None,
                          timeout_s=MD_TIMEOUT_S)
        ok = all(np.array_equal(r, np.repeat(np.arange(k), 4).reshape(k, 4))
                 for r in res)
        out["h"] = f"NCCL across {k} cards: all_gather {'ok' if ok else 'WRONG'}"
        if not ok:
            raise AssertionError(out["h"])
    else:
        out["h"] = ("NCCL across cards skipped: this machine has "
                    f"{n_cards} card")
    print(f"22h: {out['h']}")
    try:
        pmesh.spawn(_md_nccl_probe, 2, "nccl", device, timeout_s=60,
                    run_timeout_s=120)
        out["nccl_two_ranks_one_card"] = "accepted"
    except (ProcessException, TimeoutError, RuntimeError) as exc:
        # the expected refusal, recorded
        msg = str(exc).strip().splitlines()
        out["nccl_two_ranks_one_card"] = "refused: " + (
            next((x for x in msg if "uplicate" in x), msg[-1] if msg else ""))
    print(f"22h: NCCL with two ranks on one card: "
          f"{out['nccl_two_ranks_one_card'][:300]}")
    part_done("h")
    return by_path, out


# ---- phase 23: FastSLAM's device-gated chunk as one CUDA graph ----------

PF_GRAPH_PARITY_SCANS = 128   # (b), (e), (g): the first 128 scans (4 chunks)
PF_GRAPH_CMX_SCANS = 256      # (f): the frontend under cmx, 4 chunks
PF_GRAPH_UPDATES = ("pallas_hybrid", "pallas_ray", "sparse", "dense")  # (g)


def _pf_launch_counts():
    """Every PF kernel wrapper's launch count, by kernel name."""
    return {fn.__name__: fn.launches for fn in fastslam_run._KERNELS}


def _reset_pf_graph_counts():
    for fn in fastslam_run._KERNELS:
        fn.launches = 0
    for name in ("host_syncs", "refines", "updates", "resamples"):
        setattr(fastslam.fastslam_step, name, 0)


def _same_bits(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))


def _pf_draws(P, n, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return (torch.randn((n, P, 3), generator=gen, device=device),
            torch.rand(n, generator=gen, device=device))


def _pf_graph_launches(cfg, pf, device, label):
    """(the PF chunk graph of (cfg, pf) at cfg.chunk, built now, its
    launches a step by kernel name)."""
    K = cfg.chunk
    g = fastslam_run.pf_chunk_graph(cfg, pf, device, K)
    torch.cuda.synchronize(device)
    per_step = {}
    for fn, n in g.launches:
        if n % K:
            raise AssertionError(f"{label}: {fn.__name__} launched {n} "
                                 f"times in a capture of {K} steps")
        per_step[fn.__name__] = n // K
    return g, per_step


def _pf_graph_held(graph, replays, T, label, others=0):
    """A run of T scans, its PF counts set to 0 just before it, replayed
    `graph` (_pf_graph_launches's pair) once a whole chunk (`replays`
    its count before the run), launched each capture kernel once a scan
    (the tail runs the same steps eagerly) and no other kernel
    (`others`), and read nothing back a step. Returns the PF kernels'
    launches."""
    g, per_step = graph
    got = g.replays - replays
    launches = {k: v for k, v in _pf_launch_counts().items() if v}
    expect = {k: v * T for k, v in per_step.items()}
    if got != T // g.K:
        raise AssertionError(f"{label}: {got} replays for {T} scans in "
                             f"chunks of {g.K}")
    if fastslam.fastslam_step.host_syncs:
        raise AssertionError(f"{label}: {fastslam.fastslam_step.host_syncs}"
                             " host reads")
    if launches != expect or others:
        raise AssertionError(f"{label}: launches {launches} and {others} "
                             f"others, expected {expect} (each capture "
                             "launch once a step)")
    return launches


def _pf_graph_timed(cfg, pf, log, device, label, host_gated=None):
    """One run_fastslam over `log` that must take the chunk graph, its
    counts set to 0 just before it: (traj, n_eff, result dict)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g, per_step = graph = _pf_graph_launches(cfg, pf, device, label)
    capture_s = time.perf_counter() - t0
    _reset_pf_graph_counts()
    replays = g.replays
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    _, traj, n_eff, _ = run_fastslam(log, cfg, pf, device, seed=SEED,
                                     host_gated=host_gated)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    elapsed = start.elapsed_time(end) / 1e3
    T = len(traj)
    step = fastslam.fastslam_step
    launches = _pf_graph_held(graph, replays, T, label)
    result = dict(
        scans=T, particles=pf.n_particles, replays=g.replays - replays,
        scans_per_sec=T / elapsed, seconds_cuda_events=elapsed,
        seconds_host=wall, capture_s=capture_s,
        host_reads_per_scan=step.host_syncs / T, refines=step.refines,
        updates=step.updates, resamples=step.resamples,
        launches_per_step=per_step, launches=launches,
        peak_memory_bytes=torch.cuda.max_memory_allocated(device),
        min_n_eff=float(n_eff.min()),
    )
    if not (np.isfinite(traj).all() and np.isfinite(n_eff).all()):
        raise AssertionError(f"{label}: trajectory or N_eff is not finite")
    return traj, n_eff, result


def _pf_graph_replay_equals_eager(cfg, pf, log, device, label):
    """(b): the first PF_GRAPH_PARITY_SCANS scans through the graph and
    through the same device-gated steps one by one, with the same draws:
    the same bits. Returns the number of scans held."""
    n = PF_GRAPH_PARITY_SCANS
    part = {k: np.asarray(v)[:n] for k, v in log.items()}
    noise, u = _pf_draws(pf.n_particles, n, device, SEED + 23)
    st_g, *out_g = run_fastslam(part, cfg, pf, device, draws=(noise, u),
                                host_gated=False)
    state = fastslam.fastslam_init(cfg, pf, device,
                                   start_pose=part["odom"][0])
    odom = torch.as_tensor(part["odom"], dtype=torch.float32, device=device)
    ranges = torch.as_tensor(part["ranges"], dtype=torch.float32,
                             device=device)
    out = torch.empty((n, 5), dtype=torch.float32, device=device)
    for t in range(n):
        state, (bp, ne, sc) = fastslam.fastslam_step(
            state, odom[t], ranges[t], cfg, pf, noise=noise[t], u=u[t])
        out[t, :3], out[t, 3], out[t, 4] = bp, ne, sc
    out = out.cpu().numpy()
    eager = (out[:, :3], out[:, 3], out[:, 4])
    for name, a, b in zip(("trajectory", "N_eff", "scores"), out_g, eager):
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: replay and eager {name} differ")
    for name, a, b in zip(fastslam.PFState._fields, st_g, state):
        if not _same_bits(a, b):
            raise AssertionError(f"{label}: replay and eager {name} differ")
    return n


def _pf_graph_equals_host_gated(cfg, pf, log, device, label):
    """(c), (g): the log through the graph and through the host-gated
    eager loop, with the same explicit draws: the same bits."""
    T = len(log["odom"])
    draws = _pf_draws(pf.n_particles, T, device, SEED + 24)
    st_g, *out_g = run_fastslam(log, cfg, pf, device, draws=draws,
                                host_gated=False)
    st_h, *out_h = run_fastslam(log, cfg, pf, device, draws=draws,
                                host_gated=True)
    for name, a, b in zip(("trajectory", "N_eff", "scores"), out_g, out_h):
        if not np.array_equal(a, b):
            bad = np.nonzero((a != b).reshape(T, -1).any(1))[0]
            raise AssertionError(f"{label}: graph and host-gated {name} "
                                 f"differ first at scan {bad[0]}")
    for name, a, b in zip(fastslam.PFState._fields, st_g, st_h):
        if not _same_bits(a, b):
            raise AssertionError(f"{label}: graph and host-gated {name} "
                                 "differ")
    return T


def pf_gate_checks(cfg, pf, cfg16, pf16, cfg1k, pf1k, log, device):
    """(d): each gated PF kernel at its path's shapes, random operands from
    the seed: gate 0 leaves an in-place output bit-identical, gate 1
    equals the ungated launch, and the gate-0 launch's device time.
    Returns {kernel: {gate0_device_ms, gate0_device_by, ...}}."""
    rng = np.random.default_rng(SEED + 23)
    g, s = cfg.grid, cfg.sensor
    g0 = torch.zeros((), dtype=torch.bool, device=device)
    g1 = torch.ones((), dtype=torch.bool, device=device)
    odom = np.asarray(log["odom"], np.float32)
    ranges = torch.as_tensor(np.asarray(log["ranges"][200], np.float32),
                             device=device)

    def maps_poses(P):
        maps = torch.tensor(rng.normal(0, 1.5, (P, g.height, g.width))
                            .clip(-5, 5), dtype=torch.bfloat16, device=device)
        poses = torch.tensor(odom[200] + rng.normal(0, [0.3, 0.3, 0.1],
                                                    (P, 3)),
                             dtype=torch.float32, device=device)
        return maps, poses

    maps, poses = maps_poses(pf.n_particles)
    maps16, poses16 = maps[:pf16.n_particles].clone(), poses[:pf16.n_particles]
    win = update_window_cells(g, s)
    consts = occupancy.update_constants(g, s)
    o = (g.origin_x, g.origin_y)
    angles = occupancy.beam_angles(s, device)
    ray_kw = dict(resolution=g.resolution, min_range=s.min_range,
                  max_range=s.max_range, angle_min=s.angle_min,
                  step=consts["step"], l_free=g.l_free, l_occ=g.l_occ,
                  l_clamp=g.l_clamp, ray_samples=g.ray_samples)
    anc = torch.tensor(np.sort(rng.integers(0, pf.n_particles,
                                            pf.n_particles)),
                       dtype=torch.int32, device=device)
    scratch = torch.empty_like(maps)
    maps1k, poses1k = maps_poses(pf1k.n_particles)
    a1k = apply_operands(poses1k, ranges, cfg1k, pf1k, g.height, g.width)
    anchors, slots, images, ep = a1k
    in_place = {
        "update_ism": (maps, lambda m, gate: update_ism(
            m, poses, ranges, region=(win, win), origin_xy=o, gate=gate,
            **consts)),
        "update_hybrid_particles": (maps16, lambda m, gate:
            update_hybrid_particles(m, poses16, ranges, angles,
                                    region=(win, win), origin_xy=o,
                                    gate=gate, **consts)),
        "update_ray_particles": (maps16, lambda m, gate: update_ray_particles(
            m, poses16, ranges, angles, region=(win, win), origin_xy=o,
            gate=gate, **ray_kw)),
        "gather_rows": (scratch, lambda m, gate: gather_rows(
            maps, anc, gate=gate, out=m)),
        "shared_apply": (maps1k, lambda m, gate: shared_apply(
            m, anchors, slots, images, float(g.l_clamp), *ep, gate=gate)),
    }
    mcfg = fastslam.refine_matcher(cfg, pf)
    swin = scan_window_cells(g, s, mcfg)
    taps, fkw = _field_args(mcfg, g.resolution)
    origins = torch.tensor(rng.integers(-16, g.height - swin + 16,
                                        (pf.n_particles, 2)),
                           dtype=torch.int32, device=device)
    E = torch.zeros((15, swin, swin), dtype=torch.bfloat16, device=device)
    E.view(-1)[torch.as_tensor(rng.integers(0, E.numel(), 4 * 180 * 15),
                               device=device)] = 0.25
    E16 = torch.zeros((pf16.n_particles, 9, swin, swin),
                      dtype=torch.bfloat16, device=device)
    E16.view(-1)[torch.as_tensor(rng.integers(0, E16.numel(),
                                              4 * 180 * 9 * 16),
                                 device=device)] = 0.25
    Sp = torch.tensor(rng.random((pf16.n_particles, swin + 5, swin + 5)),
                      dtype=torch.float32, device=device)
    out_of_place = {
        "window_field": lambda gate: window_field(
            maps, origins, swin, taps, out_dtype=torch.bfloat16, gate=gate,
            **fkw),
        "shift_stack": lambda gate: shift_stack(E, 5, 5, gate=gate),
        "corr_scores": lambda gate: corr_scores(E16, Sp, 5, 5, gate=gate),
    }
    results = {}
    for name, (target, call) in in_place.items():
        before = target.clone()
        call(target, g0)
        kept = _same_bits(target, before)
        on, off = target.clone(), target.clone()
        call(on, g1)
        call(off, None)
        same = _same_bits(on, off) and not _same_bits(on, before)
        ms, by = _cuda_device_ms(lambda: call(target, g0))
        results[name] = dict(gate0_device_ms=ms, gate0_device_by=by,
                             gate0_bit_identical=kept,
                             gate1_equals_ungated=same)
        del before, on, off
    for name, call in out_of_place.items():
        same = _same_bits(call(g1), call(None))
        ms, by = _cuda_device_ms(lambda: call(g0))
        results[name] = dict(gate0_device_ms=ms, gate0_device_by=by,
                             gate1_equals_ungated=same)
    torch.cuda.synchronize()
    print("phase 23 (d), the gated PF kernels at their paths' shapes:",
          json.dumps(results))
    for name, r in results.items():
        if not (r.get("gate0_bit_identical", True)
                and r["gate1_equals_ungated"]):
            raise AssertionError(f"{name}: gated form {r}")
    return results


def run_pf_graph(device, pf_log, host_rates):
    """Phase 23 (module docstring). `host_rates`: phase 6's and 10's
    host-gated scans/s by label, printed beside (None: not run). Returns
    (the launches of each path, the gate checks by kernel)."""
    t_start = time.perf_counter()
    by_path, out = {}, {}
    configs = (("FastSLAM-100", pf_bench_config()),
               ("FastSLAM-16", pf_per_particle_bench_config()))
    for label, (cfg, pf) in configs:
        if pf.n_particles >= pf.host_gate_min_particles:
            raise AssertionError(f"{label}: host_gated=None would not pick "
                                 "the graph")
        traj, _, res = _pf_graph_timed(cfg, pf, pf_log, device, label)
        res["ate_m"] = ate_rmse(traj, pf_log["gt_poses"], align=False)
        res["host_gated_scans_per_sec"] = host_rates.get(label)
        res["replay_equals_eager_scans"] = _pf_graph_replay_equals_eager(
            cfg, pf, pf_log, device, label)
        res["equals_host_gated_scans"] = _pf_graph_equals_host_gated(
            cfg, pf, pf_log, device, label)
        print(f"phase 23 (a-c) {label} graph on {card()}:", json.dumps(res))
        if not res["ate_m"] <= PF_MAX_ATE_M:
            raise AssertionError(f"{label}: ATE {res['ate_m']} m")
        if res["resamples"] < 1:
            raise AssertionError(f"{label}: no resample event")
        by_path[f"23a {label} graph"] = res["launches"]
        out[label] = res
    # (e) FastSLAM-1000 through the graph: kernel 8's gated form
    cfg1k, pf1k = pf1000_bench_config()
    part = {k: np.asarray(v)[:PF_GRAPH_PARITY_SCANS]
            for k, v in pf_log.items()}
    _, _, res = _pf_graph_timed(cfg1k, pf1k, part, device, "FastSLAM-1000",
                                host_gated=False)
    print(f"phase 23 (e) FastSLAM-1000 graph, host_gated=False, on {card()}:",
          json.dumps(res))
    if not res["launches"].get("shared_apply"):
        raise AssertionError("FastSLAM-1000 graph: the apply never launched")
    by_path["23e FastSLAM-1000 graph"] = res["launches"]
    out["FastSLAM-1000"] = res
    # (g) FastSLAM-16 with the other particle updates: graph = host-gated
    cfg16, pf16 = pf_per_particle_bench_config()
    for impl in PF_GRAPH_UPDATES:
        icfg = dataclasses.replace(cfg16, grid=dataclasses.replace(
            cfg16.grid, update_impl=impl))
        for fn in fastslam_run._KERNELS:
            fn.launches = 0
        n = _pf_graph_equals_host_gated(icfg, pf16, part, device,
                                        f"FastSLAM-16 {impl}")
        launches = {k: v for k, v in _pf_launch_counts().items() if v}
        print(f"phase 23 (g) FastSLAM-16 with update_impl {impl}: graph = "
              f"host-gated bits over {n} scans; launches {launches}")
        want = {"pallas_hybrid": "update_hybrid_particles",
                "pallas_ray": "update_ray_particles"}.get(impl)
        if want is not None and not launches.get(want):
            raise AssertionError(f"FastSLAM-16 {impl}: {want} not launched")
    # (d) the gated kernels, alone
    cfg, pf = pf_bench_config()
    cfg16, pf16 = pf_per_particle_bench_config()
    gates = pf_gate_checks(cfg, pf, cfg16, pf16, cfg1k, pf1k, pf_log, device)
    # (f) the frontend with --score-impl cmx: graph replay = eager bits
    fcfg = bench_config()
    fcfg = dataclasses.replace(fcfg, matcher=dataclasses.replace(
        fcfg.matcher, score_impl="cmx"))
    flog = {k: np.asarray(v)[:PF_GRAPH_CMX_SCANS]
            for k, v in bench_log(fcfg.sensor).items()}
    run_frontend({k: v[: fcfg.chunk] for k, v in flog.items()}, fcfg,
                 device)   # the capture
    corr_scores.launches = 0
    st_g, tr_g, sc_g = run_frontend(flog, fcfg, device)
    n_corr = corr_scores.launches
    st_e, tr_e, sc_e = run_frontend(flog, fcfg, device, graph=False)
    same = (np.array_equal(tr_g, tr_e) and np.array_equal(sc_g, sc_e)
            and all(_same_bits(a, b) for a, b in zip(st_g, st_e)))
    ate = ate_rmse(tr_g, flog["gt_poses"], align=False)
    print(f"phase 23 (f) frontend with score_impl cmx, {PF_GRAPH_CMX_SCANS} "
          f"scans: graph replay = eager bits {same}, corr_scores launches "
          f"{n_corr} (two passes a scan), ATE {ate}")
    if not same or n_corr != 2 * PF_GRAPH_CMX_SCANS:
        raise AssertionError("cmx frontend: graph and eager differ, or the "
                             "correlation kernel not launched twice a scan")
    by_path["23f cmx frontend graph"] = {"corr_scores": n_corr}
    print(f"phase 23 took {time.perf_counter() - t_start:.1f} s")
    return by_path, gates

# ---- phase 24: the twins of scripts/bench_fullslam.py and
# scripts/bench_graph_scale.py ------------------------------------------------


def script_reference(seed: int, variant: str) -> str:
    """The JAX package's run of scripts/bench_fullslam.py's `variant` over
    the log of `seed` (scripts/fullslam_reference.py --run script...)."""
    return ("scripts/fullslam_script_reference"
            + ("" if seed == 3 else f"_seed{seed}")
            + ("" if variant == "incremental" else "_full_rebuild") + ".json")


def _scripts_dir():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))


def run_script_fullslam(device):
    """Phase 24 (a): scripts/bench_fullslam_torch.py, for each variant
    (incremental_rebuild True and False): the twin's whole warm run with
    each solve, finalize and rebuild synced and timed (_accept_timers),
    its timed run with the counts set to 0 just before it, and its JSON
    line; that run (seed 3) and one over the log of each of seeds 4-7
    through _tiled_fullslam_run's checks at that variant (every launch
    accounted for, the rebuilds' scans among them), beside the JAX
    package's run of the script's config over the same log and variant
    (script_reference), the five held as a set (held_as_set). Returns
    ({path: launches}, {variant: its dict})."""
    _scripts_dir()
    from bench_fullslam_torch import VARIANTS, bench_fullslam, script_log

    cfg, tcfg, gcfg = fullslam_script_config()
    paths, out = {}, {}
    for variant, inc in VARIANTS.items():
        # the twin's warm run with its accepts synced and timed; its timed
        # run, untimed accepts and the counts from 0, seed 3's of the set
        times, undo = _accept_timers()

        def start():
            undo()
            _reset_tiled_fullslam_counts(device)

        try:
            line, res, log = bench_fullslam(variant, device=device,
                                            before_run=start)
        finally:
            undo()
        accept = [a + b for a, b in zip(times["solve"], times["finalize"])]
        synced = dict(
            accepts=len(times["finalize"]), rebuilds=len(times["rebuild"]),
            **{f"{k}_ms_median": statistics.median(v or [0.0])
               for k, v in dict(times, accept=accept).items()})
        print(f"phase 24 (a) bench_fullslam_torch.py {variant}:",
              json.dumps(line))
        print(f"phase 24 (a) {variant}, the warm run's synced accepts:",
              json.dumps(synced))
        runs = {}
        launches, result, _, runs[3] = _tiled_fullslam_checks(
            cfg, tcfg, gcfg, log, device, res, line["wall_s"],
            line["wall_s"], script_reference(3, variant),
            f"script full SLAM {variant} seed 3", hold=False)
        paths[f"24 script full SLAM, {variant}"] = launches
        rebuilt = {3: result["rebuilt_scans"]}
        for seed in FULLSLAM_EXTRA_SEEDS:
            _, result, _, runs[seed] = _tiled_fullslam_run(
                cfg, tcfg, gcfg, script_log(cfg.sensor, seed), device,
                script_reference(seed, variant),
                f"script full SLAM {variant} seed {seed}", hold=False,
                incremental_rebuild=inc)
            rebuilt[seed] = result["rebuilt_scans"]
        out[variant] = dict(
            line=line, synced=synced, rebuilt_scans=rebuilt,
            set=held_as_set(f"script full SLAM, {variant}", runs))
    return paths, out


def _solver_set_held(K, name, port, jax_runs, err0):
    """One (K, solver) set of phase 24 (b): `port` and `jax_runs` the five
    runs' dicts (err_m, finite; or failed) at bench_configs.GRAPH_ULPS,
    a run solved where it is finite with its error below err0. Held: (i)
    the graph itself (k = 0): the port's run finite where JAX's is; (ii)
    the port's unsolved runs at most as many as JAX's; (iii) the median
    error of the port's solved runs at most HIER_ERR_JAX_FACTOR x the
    median of JAX's solved runs. Where no JAX run solved the graph, (i)
    alone. Returns the set's dict (`held`)."""
    def finite(r):
        return "failed" not in r and r["finite"] and bool(
            np.isfinite(r["err_m"]))

    def solved(runs):
        return [r["err_m"] for r in runs if finite(r) and r["err_m"] < err0]

    i0 = GRAPH_ULPS.index(0)
    out = dict(K=K, solver=name, ulps=list(GRAPH_ULPS),
               err_m=[r.get("err_m", r.get("failed")) for r in port],
               jax_err_m=[r.get("err_m", r.get("failed")) for r in jax_runs],
               err0=err0)
    held = finite(port[i0]) or not finite(jax_runs[i0])
    ok, jok = solved(port), solved(jax_runs)
    out.update(unsolved=len(port) - len(ok), jax_unsolved=len(jax_runs)
               - len(jok))
    if jok:
        held = held and out["unsolved"] <= out["jax_unsolved"]
        jmed = float(np.median(jok))
        out.update(median_err_m=float(np.median(ok)) if ok else None,
                   jax_median_err_m=jmed,
                   limit_m=HIER_ERR_JAX_FACTOR * jmed)
        held = held and bool(ok) and out["median_err_m"] <= out["limit_m"]
    else:
        out["note"] = "no JAX run solved the graph: printed beside"
    out["held"] = held
    return out


def run_solver_table(device):
    """Phase 24 (b): scripts/bench_graph_scale_torch.py's table (the
    device= line and one row a K, printed as made), where before each
    solver is timed at K it runs once on each of the graphs with the x of
    every node but the anchor moved by k float32 ulps, k in GRAPH_ULPS
    but 0 (the table's first, untimed call: the same solver on the same
    shapes); the table's run is k = 0. The five runs are held as a set
    against the JAX package's five on the CPU
    (scripts/graph_scale_reference.json, made by
    scripts/graph_scale_reference.py; _solver_set_held). A float32
    solve's error on these graphs is a draw of its rounding: one ulp moves
    JAX's own dense and Schur errors 5-60x, and the V-cycle's at 4096
    nodes to NaN, so one run against one run measures the draw. A port
    solve of the graph itself that raises or gives NaN where JAX's is
    finite fails the phase. Returns ({path: launches}, the rows and the
    sets)."""
    _scripts_dir()
    from bench_graph_scale_torch import (
        SOLVERS,
        scale_graph,
        script_row,
        table,
        xy_err,
    )

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           GRAPH_SCALE_REFERENCE)) as fh:
        ref = json.load(fh)["sizes"]
    moved = {}     # (K, solver): the runs at each k but 0
    gts = {}

    def first(K, name, arrays, cfg):
        if K not in gts:
            gts[K] = scale_graph(K)[1]
        gt = gts[K]
        runs = {}
        for k in GRAPH_ULPS:
            if k == 0:
                continue
            g = se2_graph.PoseGraph(**{
                f: torch.as_tensor(v, device=device)
                for f, v in ulp_moved(arrays, k).items()})
            try:
                out, _ = SOLVERS[name](g, cfg)
                poses = out.poses.cpu().numpy()
            except Exception as e:  # noqa: BLE001 — a failed run
                runs[k] = dict(failed=f"failed: {type(e).__name__}")
                continue
            runs[k] = dict(err_m=xy_err(poses, gt),
                           finite=bool(np.isfinite(poses).all()))
        moved[K, name] = runs

    print(f"phase 24 (b) device={card()}")
    tridiag_factor.launches = 0
    t0 = time.perf_counter()
    # one timed call, where the script takes the mean of three: the
    # phase's time budget
    rows = table(device, reps=SOLVER_TABLE_REPS, first=first,
                 on_row=lambda r: print("phase 24 (b)",
                                        json.dumps(script_row(r))))
    seconds = time.perf_counter() - t0
    launches = {"tridiag_factor": tridiag_factor.launches}
    sets, bad = [], []
    for row in rows:
        K = row["K"]
        jr = ref[str(K)]
        if abs(row["err0"] - jr["err0"]) > 1e-9:
            raise AssertionError(f"K={K}: the graph's error before the "
                                 f"solve {row['err0']}, JAX's {jr['err0']}")
        for name in (n for n in SOLVERS if f"{n}_ms" in row):
            at0 = (dict(err_m=row[f"{name}_err"],
                        finite=row[f"{name}_finite"])
                   if f"{name}_err" in row else dict(failed=row[f"{name}_ms"]))
            port = [at0 if k == 0 else moved[K, name][k] for k in GRAPH_ULPS]
            h = _solver_set_held(K, name, port, jr[name]["runs"], jr["err0"])
            h["ms"] = row[f"{name}_ms"]
            print("phase 24 (b) beside JAX:", json.dumps(h))
            sets.append(h)
            if not h["held"]:
                bad.append(h)
    print(f"phase 24 (b) took {seconds:.1f} s; tridiag_factor launched "
          f"{launches['tridiag_factor']} times")
    if bad:
        raise AssertionError(f"solver table against JAX's: {bad}")
    if launches["tridiag_factor"] <= 0:
        raise AssertionError("the hierarchical solves launched no "
                             "tridiag_factor")
    return {"24 solver table": launches}, dict(rows=rows, sets=sets,
                                               seconds=seconds)


def run_twins(device):
    """Phase 24: (a) run_script_fullslam, (b) run_solver_table. Returns
    ({path: launches}, {"fullslam": ..., "graph_scale": ...})."""
    t0 = time.perf_counter()
    paths, fs = run_script_fullslam(device)
    t1 = time.perf_counter()
    table_paths, gs = run_solver_table(device)
    paths.update(table_paths)
    print(f"phase 24 took {time.perf_counter() - t0:.1f} s ((a) "
          f"{t1 - t0:.1f} s)")
    return paths, {"fullslam": fs, "graph_scale": gs}


def main(kernels_only: bool = False, multi_device_only: bool = False,
         pf_graph_only: bool = False, twins_only: bool = False):
    """Every phase; with `kernels_only` (--kernels-only) phases 1-3 alone,
    for work on a kernel: the last line is then the checks' JSON, not the
    {"ok": ...} line of a whole run; with `multi_device_only`
    (--multi-device-only) phases 1, 2 and 22 alone (the single-device
    runs phase 22 compares with made first), for work on parallel/: the
    last line is then phase 22's JSON; likewise `pf_graph_only`
    (--pf-graph-only, phase 23) and `twins_only` (--twins-only, phase
    24)."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs only on a GPU")
    device = torch.device("cuda", 0)
    print(card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib_path}")
    t0 = time.perf_counter()
    native.load_library()
    print(f"CARMEN parser built in {time.perf_counter() - t0:.1f} s: "
          f"{native.library_path()}")

    cfg = bench_config()
    log = bench_log(cfg.sensor)
    pf_cfg, pf = pf_bench_config()
    pf_log = pf_bench_log(pf_cfg.sensor)
    cfg1k, pf1k = pf1000_bench_config()
    cfg16, pf16 = pf_per_particle_bench_config()
    ray_cfg = ray_bench_config()
    if pf_graph_only:
        paths, gates = run_pf_graph(device, pf_log, {})
        print(json.dumps({"pf_graph": gates, "launches": paths}))
        return
    if twins_only:
        paths, twins = run_twins(device)
        print(json.dumps({"twins": twins, "launches": paths}, default=str))
        return
    if multi_device_only:
        tiled_cfg, tcfg = tiled_bench_config()
        tiled_log = tiled_bench_log(tiled_cfg.sensor)
        _, tiled_traj, _ = run_tiled_frontend(tiled_log, tiled_cfg, tcfg,
                                              device)
        fs_cfg, fs_gcfg = fullslam_bench_config()
        fs_res = run_full_slam(fullslam_bench_log(fs_cfg.sensor), fs_cfg,
                               fs_gcfg, device=device)
        os.makedirs(CLI_DIR, exist_ok=True)
        t0 = time.perf_counter()
        paths, out = run_multidevice(
            device, pf_log, cfg1k, pf1k, tiled_cfg, tcfg, tiled_log,
            tiled_traj, fs_gcfg, fs_res.ckpt["graph"])
        print(f"phase 22 took {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"multi_device": out, "launches": paths},
                         default=str))
        return

    # phase 3: every kernel against its plain version
    t0 = time.perf_counter()
    checks = kernel_checks(cfg, log, device)
    # the frontend step's forms take the entries' top level; the
    # host-origin forms, which full SLAM, the tiles and the checks call,
    # move under "out_of_place"
    for name, entry in gated_checks(cfg, log, device).items():
        e = checks[name]
        e["out_of_place"] = {k: e.pop(k) for k in FORM_FIELDS if k in e}
        e.update(entry)
    variants = variant_checks(pf_cfg, pf, device)
    checks.update(pf_kernel_checks(pf_cfg, pf, pf_log, device,
                                   pf1k.n_particles))
    checks["window_field"]["variants_checked"] = variants["window_field"]
    checks["gather_rows"]["variants_checked"] = variants["gather_rows"]
    checks["shared_apply"] = apply_check(cfg1k, pf1k, pf_log, device)
    checks["corr_scores"] = corr_check(
        cfg16, pf16, pf_log, device, checks.pop("corr_frontend")
    )
    checks["window_field"]["at_fastslam16"] = checks["corr_scores"].pop("field")
    checks["update_ray"] = ray_check(ray_cfg, log, device)
    # the frontend step's form takes the entry's top level, as `hybrid`'s
    e = checks["update_ray"]
    e["out_of_place"] = {k: e.pop(k) for k in FORM_FIELDS if k in e}
    e["out_of_place"]["device_kernels_per_call"] = e.pop(
        "device_kernels_per_call")
    ray_form, checks["update_ism"]["frontend_window"] = ray_window_check(
        ray_cfg, log, device)
    e.update(ray_form)
    fs_cfg, fs_gcfg = fullslam_bench_config()
    fs_log = fullslam_bench_log(fs_cfg.sensor)
    at_fullslam = fullslam_kernel_checks(fs_cfg, fs_gcfg, fs_log, device)
    kcfg, ktcfg, kgcfg = fullslam_tiled_killian_config()
    for name, entries in fullslam_kernel_checks(
            kcfg, kgcfg, fullslam_tiled_bench_log(kcfg.sensor), device,
            tcfg=ktcfg, tag="killian_").items():
        at_fullslam[name].update(entries)
    for name, entries in at_fullslam.items():
        checks[name].update(entries)
    wide_cfg = wide_fov_config()
    wide_log = bench_log(wide_cfg.sensor)
    for name, entries in wide_fov_kernel_checks(wide_cfg, wide_log,
                                                device).items():
        checks[name].update(entries)
    checks["tridiag_factor"] = tridiag_checks(device)
    # the particle filter's forms of kernels 1 `hybrid` and `ray` at
    # their main path's inputs, phase 21 (d)'s FastSLAM-16 (float32 1024^2
    # maps at 0.05 m, [16, 496^2] windows, the CLI's sensor and log); at
    # bench_pf's FastSLAM-100 and -16 (bf16 512^2 maps, 256^2 windows)
    # under "at_fastslam100" and "at_fastslam16"
    cli_log, cli_cfg, cli_pf = _cli_pf_config(CLI_PF16)
    checks.update(particle_update_checks(cli_cfg, cli_pf, cli_log, device,
                                         SEED + 11))
    for key, (c, p, sd) in (("at_fastslam100", (pf_cfg, pf, SEED + 9)),
                            ("at_fastslam16", (cfg16, pf16, SEED + 10))):
        for name, entry in particle_update_checks(c, p, pf_log, device,
                                                  sd).items():
            checks[name][key] = entry
    floor_ms, floor_by = launch_floor(device)
    print(f"launch floor, an empty kernel: {floor_ms:.4g} ms ({floor_by})")
    for name in ("update_hybrid", "update_ray", "score_offsets",
                 "search_space"):
        checks[name].update(launch_floor_ms=floor_ms, launch_floor_by=floor_by)
    checks["search_space"]["full_map"].update(launch_floor_ms=floor_ms,
                                              launch_floor_by=floor_by)
    for name, entries in at_fullslam.items():
        for key in entries:
            checks[name][key].update(launch_floor_ms=floor_ms,
                                     launch_floor_by=floor_by)
    torch.cuda.synchronize()
    print(f"kernel checks took {time.perf_counter() - t0:.1f} s")
    if kernels_only:
        print(json.dumps({"kernel_checks": checks}))
        return

    # the paths, each with its counts set to 0 just before it
    by_path = {}
    traj, by_path["4 frontend"], slice_state = run_slice(cfg, log, device)
    by_path["4b bench_ate seeds 0-2"] = run_bench_ate(device)
    parity_run(cfg, log, device, traj)
    host_rates = {}
    by_path["6 FastSLAM-100"], _, host_rates["FastSLAM-100"] = run_pf(
        pf_cfg, pf, pf_log, device, "fastslam-100")
    pf_parity(pf_cfg, pf, pf_log, device, 0, PF_PARITY_REFINES,
              "fastslam-100")
    by_path["8 FastSLAM-1000"], _, _ = run_pf(cfg1k, pf1k, pf_log, device,
                                              "fastslam-1000")
    pf_parity(cfg1k, pf1k, pf_log, device, 1, PF1000_PARITY_UPDATES,
              "fastslam-1000", after_boot=True)
    by_path["10 FastSLAM-16"], ate16, host_rates["FastSLAM-16"] = run_pf(
        cfg16, pf16, pf_log, device, "fastslam-16")
    checks["corr_scores"]["fastslam16_runs_held"] = corr_held_runs(
        cfg16, pf16, pf_log, device, ate16
    )
    pf_parity(cfg16, pf16, pf_log, device, 0, PF_PARITY_REFINES,
              "fastslam-16")
    hybrid_ate = ate_rmse(traj, log["gt_poses"], align=False)
    by_path.update(run_ray(ray_cfg, log, device, hybrid_ate))
    loc_log = localization_log(cfg.sensor)
    by_path["12 localization"], loc_traj = run_localize(
        cfg, loc_log, device, slice_state.logodds, hybrid_ate)
    tiled_cfg, tcfg = tiled_bench_config()
    tiled_log = tiled_bench_log(tiled_cfg.sensor)
    by_path["13 tiled frontend"], tiled_traj = run_tiled(
        tiled_cfg, tcfg, tiled_log, device)
    by_path["14 relocalization"] = run_global(
        cfg, loc_log, loc_traj, kidnap_log(cfg.sensor), device,
        slice_state.logodds)
    by_path["15 full SLAM"], fs_res = run_fullslam(fs_cfg, fs_gcfg, fs_log,
                                                   device)
    fullslam_seeds(fs_cfg, fs_gcfg, device,
                   fullslam_held(fs_cfg, fs_gcfg, fs_log, device, fs_res))
    by_path.update(run_fullslam_tiled(
        fullslam_tiled_bench_log(fs_cfg.sensor), device))
    by_path["17 Schur full SLAM"], _ = schur_checks(
        fs_cfg, fs_gcfg, fs_log, device, fs_res.ckpt["graph"])
    sr_cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, update_impl="sparse"))
    by_path["18 sampled-ray frontend"] = run_sampled_ray_frontend(
        sr_cfg, log, device, "sampled-ray frontend")
    by_path["19 sampled-ray full SLAM (hier)"], phase19, (gcfg19, graph19) = (
        run_sparse_hier_fullslam(fs_cfg, fs_gcfg, fs_log, device))
    # the factor's row at its main path's input, the serpentine's beside it
    checks["tridiag_factor"] = {
        **tridiag_path_check(device, gcfg19, graph19),
        **checks["tridiag_factor"]}
    phase19.update(sparse_solver_checks(device, fs_gcfg,
                                        fs_res.ckpt["graph"]))
    by_path["20 270-degree frontend"] = run_sampled_ray_frontend(
        wide_cfg, wide_log, device, "270-degree frontend")
    cli_paths, cli_parity = run_cli(device)
    by_path.update(cli_paths)
    checks["update_hybrid_particles"]["cli_fastslam16_path_held"] = (
        cli_parity["pallas_hybrid"])
    checks["update_ray_particles"]["cli_fastslam16_path_held"] = (
        cli_parity["pallas_ray"])
    md_paths, _ = run_multidevice(
        device, pf_log, cfg1k, pf1k, tiled_cfg, tcfg, tiled_log, tiled_traj,
        fs_gcfg, fs_res.ckpt["graph"])
    by_path.update(md_paths)
    graph_paths, gates = run_pf_graph(device, pf_log, host_rates)
    by_path.update(graph_paths)
    for name, entry in gates.items():
        checks[name].update(entry)
    twin_paths, _ = run_twins(device)
    by_path.update(twin_paths)

    sources = {
        "update_hybrid": ("slam2d_tpu_torch/csrc/update_hybrid.cu",
                          "slam2d_tpu/ops/pallas_update.py:97"),
        "update_ism": ("slam2d_tpu_torch/csrc/update_ism.cu",
                       "slam2d_tpu/ops/pallas_update.py:97"),
        "update_ray": ("slam2d_tpu_torch/csrc/update_ray.cu",
                       "slam2d_tpu/ops/pallas_update.py:97"),
        "score_offsets": ("slam2d_tpu_torch/csrc/score.cu",
                          "slam2d_tpu/ops/pallas_score.py:29"),
        "search_space": ("slam2d_tpu_torch/csrc/search_space.cu",
                         "slam2d_tpu/ops/pallas_blur.py:34"),
        "gather_rows": ("slam2d_tpu_torch/csrc/gather_rows.cu",
                        "slam2d_tpu/ops/pallas_gather.py:27"),
        "corr_scores": ("slam2d_tpu_torch/csrc/corr.cu",
                        "slam2d_tpu/ops/pallas_corr.py:36"),
        "window_field": ("slam2d_tpu_torch/csrc/window_field.cu",
                         "slam2d_tpu/ops/pallas_field.py:46"),
        "shift_stack": ("slam2d_tpu_torch/csrc/shift_stack.cu",
                        "slam2d_tpu/ops/pallas_stack.py:31"),
        "shared_apply": ("slam2d_tpu_torch/csrc/shared_apply.cu",
                         "slam2d_tpu/ops/pallas_apply.py:42"),
        # kernel 1's particle filter forms: a grid axis over the particles
        "update_hybrid_particles": ("slam2d_tpu_torch/csrc/update_hybrid.cu",
                                    "slam2d_tpu/ops/pallas_update.py:97"),
        "update_ray_particles": ("slam2d_tpu_torch/csrc/update_ray.cu",
                                 "slam2d_tpu/ops/pallas_update.py:97"),
        # a lax.scan of the JAX package, no Pallas kernel
        "tridiag_factor": ("slam2d_tpu_torch/csrc/tridiag_factor.cu",
                           "slam2d_tpu/graph/sparse.py:138"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        paths = {k: v[name] for k, v in by_path.items() if name in v}
        if not paths or min(paths.values()) <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        # `launches`: the first path that runs the kernel (its main path)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=next(iter(paths.values())), launches_by_path=paths,
            **checks[name],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main(kernels_only="--kernels-only" in sys.argv[1:],
         multi_device_only="--multi-device-only" in sys.argv[1:],
         pf_graph_only="--pf-graph-only" in sys.argv[1:],
         twins_only="--twins-only" in sys.argv[1:])
