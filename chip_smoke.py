"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints one line or a short block, and ends in
``torch.cuda.synchronize()`` so a fault shows where it happened):

1. device        the card, torch/CUDA/nvcc versions, name and power limit;
2. build         nvcc builds every kernel in icp_proposal_tpu_torch/csrc into
                 build/, one compiler per source, all started together;
3. kernels       K1–K4 and K8 against their plain PyTorch twins on the card
                 at the femur path's per-chain shapes on 256 and on 2,048
                 chains, with times (K3, K4 and K8 ids and K4's winner
                 corners bitwise); K1 timed in turns against
                 torch.linalg.cholesky_ex (the factor only); its tile size,
                 shared memory per chain and CTAs per SM; the launches of K3
                 in both modes and of K8 (queries a lane, threads, blocks,
                 shared memory, CTAs per SM) and of K4 (lanes a query,
                 blocks, registers, CTAs per SM, face table); K8's anchors
                 against K3's under a rounding bound;
4. main          the stand-in femur GPMM-100 (rank 101) flagship ICP-proposal
                 MH step at 2,048 chains through the kernels: warm-up, then
                 timed steps, with each kernel's launch count;
5. check         8 chains stepped on the card and on the CPU (plain twins)
                 from the same carry with the same noise must agree;
6. main:registration  the femur registration entry point
                 (``run_icp_proposal_registration``, flagship setup, coarse
                 pass K8) at 2,048 chains: a warm-up run, a timed run of 3
                 segments of 20 steps with a JSON log, reconstruction
                 metrics (K5) and diagnostics, a resume from the log; then
                 the step with coarse="exact" against coarse="dot";
7. check:dot     as 5, for the flagship setup with coarse="dot";
8. setup:bfm     the synthetic face stand-in at rank 200 (host build timed)
                 and the BFM partial-face fitting setup;
9. kernels:bfm   K5 (shared and per-chain surfaces; culled, the dense scan
                 and the twin bitwise equal; the share of tiles and pairs the
                 culled kernel visits), K6 and K7 at r = 200 against their
                 twins at the BFM path's shapes on 256 and on 2,048 chains;
                 K6 timed in turns against cholesky_ex, with its launch
                 configuration; K1 (4 warps) at r = 200 timed beside K6;
9b. kernels:index  K9 (the shortlist index build) and K10 (the full d²
                 matrix) against their twins on the card, ids and d²
                 bitwise, on the inputs the index build gives them: the
                 femur target at K = 16, 32, 64, 128, the face target and
                 the partial face at K = 64, K10 at the femur shape, and an
                 open patch whose faces span many tiles; then whole
                 build_target_context calls on the card (femur and face),
                 timed, each launching K9 once.  Every context built with
                 an index launches K9 once: the main phases' launch tables
                 count it;
10. main:bfm-partial  the BFM partial-face step at 2,048 chains: warm-up,
                 timed steps, launch counts;
11. check:bfm    as 5, for the BFM partial setup;
12. main:hybrid, main:mala, main:rw-adapt  the stand-in femur's adaptive
                 setups (ICP + MALA + random walk; MALA alone; the random
                 walk), scale adaptation on, at 2,048 chains: warm-up, timed
                 steps, launch counts, the scales' range after the run and
                 the MALA gradient entries zeroed as non-finite;
13. check:hybrid, check:mala  as 5, with MALA's gradient on the card (K3,
                 K4 supply the winners) against the CPU's;
14. main:bfm-fitting  the BFM entry point ``run_bfm_fitting(partial=True)``
                 on the rank-200 face at 2,048 chains: a warm-up run, a
                 timed run of 5 steps with a JSON log read back;
15. main:face-pipeline  the face user pipeline, files in a temporary
                 directory: ``prepare_bfm_dataset`` on binary-PLY scans of
                 the face stand-in's target (×1,000, moved rigidly, landmarks
                 with the nose tip), ``create_gp_model face`` at the
                 reference's defaults on the open patch of subdivision 5
                 (7,925 vertices decimated to 2,000; 800 Nyström points;
                 rank 200), ``load_bfm_data`` and ``run_bfm_fitting(partial=
                 True)`` at 2,048 chains × 5 steps: seconds per stage,
                 launches;
16. setup:femur200  the stand-in femur GPMM-200 (rank 201) and GPMM-50
                 (rank 51), host build timed;
17. main:icp     the deterministic ICP entry point ``run_deterministic_icp``
                 (100 iterations, 1,622 model ids and target points, σ =
                 1e-15, both directions) on the GPMM-50: its ICP-Timing
                 line, ms per iteration, non-finite iterations, launch
                 counts, reconstruction against the mean shape's;
18. check:icp    4 inits × 3 iterations of the deterministic ICP on the card
                 and on the CPU plain twins at ranks 51 and 201 from the same
                 inits, target points, model ids and flips: correspondence
                 ids on the same instance points equal, coefficients within
                 rtol 1e-4 and atol 1e-4·max|α|, fallbacks counted;
19. kernels:harness  K5 (both modes) at the Hausdorff evaluator's femur
                 widths (1,622 model vertices against 3,240 target faces;
                 the target's vertices against each chain's faces), K6 and
                 K7 at r = 201, each against its twin on 100 chains;
20. main:experiments  the paper's harness ``run_std_icp_vs_chain_comparison``
                 on the GPMM-200 with one target, 100 inits × 1,000 samples,
                 Dice on: seconds, launches and samples/s per stage, the
                 deterministic ICP batch's peak memory, the mean metrics per
                 method and the experiment log read back;
21. check:experiments-euclidean, check:experiments-hausdorff  as 5, for the
                 harness's two MH setups at r = 201 from its own inits;
22. main:random-init  ``run_random_init_comparison`` on the GPMM-100 with 5
                 inits at full-resolution point counts, 200 ICP samples and
                 5 × as many random-walk samples: per-method avg and
                 Hausdorff distance and accepted steps, beside the inits'
                 own distances;
23. check:random-init-icp, check:random-init-rnd  as 5, for its two MH
                 setups at r = 101 from its own inits;
24. main:config  ``build_from_config(RunConfig(), …)`` (the flagship recipe
                 on the reference's seeded ICP subsets) on the GPMM-100 at
                 2,048 chains, timed like 4; check:config: RunConfig() builds
                 the flagship recipe, both sides' ICP ids are fused into the
                 evaluator's pass, each side steps from its own carry and
                 takes every decision of the recipe written by hand on the
                 same seeded subsets with equal carries, and as 5 against
                 the CPU twins;
25. main:femur-pipeline  the femur user pipeline, files in a temporary
                 directory: ``align_shapes`` on a moved copy of the target,
                 ``create_gp_model femur`` (GPMM-100), ``load_femur_data``,
                 the registration entry point at 2,048 chains × 1,200
                 samples with chain 0's JSON log, and ``apps.replay``
                 ``replay`` and ``posterior`` at the JAX CLI's defaults:
                 seconds per stage, launches, the decode of the replayed
                 states and the variability maps timed; check:replay: the
                 replayed and posterior points and maps on the card against
                 the CPU from the same log;
26. main:pod     ``apps.pod_chains`` at its defaults in this process: 1,024
                 chains x 1,000 steps of the stand-in GPMM-100 flagship with
                 records, pooled acceptance, R-hat and ESS (one process, no
                 collective): samples/s, launches; then the bare step
                 (store_params=False) at 1,024 chains: the ratio is the
                 runner's overhead;
27. check:pod    64 chains x 100 steps (a) with no group, (b) in an NCCL
                 group of one rank (the all-reduces on the card; equal to (a)
                 bitwise), (c) as two gloo rank processes sharing the card
                 (decisions equal to (a)'s away from |log a - log u| <= 1e-3,
                 pooled stats within 1e-5 of |x| + the field's max|x|), (d)
                 pooled R-hat and ESS
                 against split_rhat/ess of the gathered traces (rtol 1e-4);
28. main:dryrun  ``graft_entry.dryrun_multichip(torch.cuda.device_count())``:
                 one NCCL rank process per card, 64 chains x 100 steps of the
                 stand-in GPMM-50 flagship, pooled by all-reduce;
29. main:evidence  the posterior-evidence tools (``icp_proposal_tpu_torch.
                 tools``) through their ``main()`` at cut sizes (``EV_ARGS``)
                 on the stand-in GPMM-50: the index sweep at K = 16, 32, 64,
                 128 (and K8's coarse pass at 64), the quick mixing sweep,
                 the three long-run samplers, the quality rows (femur and
                 face), two rounds of the converged run (one process) and the
                 numpy sampler against the port: seconds, launches, a JSON
                 summary each; the sweep's K = 64 errors against the CPU
                 twins', the converged run's pooled R-hat against the
                 gathered traces';
30. kernels:evidence  K4 at each of those K on the sweep's queries against
                 its twin (ids and winner corners bitwise).

Each main path is driven with every launch count set to 0 just before it
and read just after.  Then one JSON line with every kernel's numbers, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero.  Without a CUDA device it exits non-zero before doing anything.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

N_CHAINS = 2048
WARMUP_STEPS = 3
TIMED_STEPS = 20
BFM_RANK, BFM_SUBDIV = 200, 4
BFM_WARMUP_STEPS = 2
BFM_TIMED_STEPS = 10
REG_WARMUP_STEPS = 3
REG_SEGMENT, REG_SEGMENTS = 20, 3  # the timed registration run: 3 segments of 20
REG_CMP_STEPS = 10  # steps per turn of the coarse="exact" / "dot" comparison
CMP_CHAINS = 256
KERNEL_REPS = 20
TOL = 1e-4  # K1/K2/K6/K7: |got − want| ≤ TOL + TOL·|want|; K3/K4/K5/K8 ids, values: exact
# K8 against K3: a K8 anchor's true d² may exceed the exact minimum by at
# most GAP_ULPS·(‖q‖ + maxᵥ‖v‖)², a rounding bound for the dot form's six
# float32 operations (about 0.1 mm² at femur scale)
GAP_ULPS = 2.0 ** -21
BUILD = Path(__file__).resolve().parent / "build"

# the H100 SXM's published peaks (NVIDIA H100 datasheet): FP32 and FP64
# outside the tensor cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12
# arithmetic operations the point→triangle cascade (_tile_dist2) executes for
# every pair whatever the region: 15 edge/offset differences, 30 for the six
# dot products, 9 for va/vb/vc, 3 for the denominator, 2 for v/w, 3 for the
# clamp-scale, 15 for the closest point and 5 for d²; the branch-dependent
# edge and vertex terms and all comparisons are left out, so bounds built on
# it are lower bounds
PAIR_FLOPS = 82
NV_PAIR_FLOPS = 8  # nearest vertex: 3 differences, 3 products, 2 sums
DOT_PAIR_FLOPS = 6  # dot-form nearest vertex: 3 products, 3 sums

# every target context built with its shortlist index launches K9 once (the
# index build); a step launches none, nor K10 (the full d² matrix, which no
# path uses, as in the reference)
CONTEXT_LAUNCHES = {"shortlist_topk": 1}
FEMUR_STEP_LAUNCHES = {"chol_solve": 2, "tri_solve_lt": 2, "nearest_vertices[shared]": 1,
                       "nearest_vertices[per_chain]": 1, "refine_shortlist": 1,
                       "surface_distances[shared]": 0,
                       "surface_distances[per_chain]": 0, "chol_solve_blocked": 0,
                       "tri_solve_lt_blocked": 0, "coarse_nearest_dot": 0,
                       "shortlist_topk": 0, "point_tri_d2": 0}
BFM_STEP_LAUNCHES = {"chol_solve": 0, "tri_solve_lt": 0, "nearest_vertices[shared]": 1,
                     "nearest_vertices[per_chain]": 0, "refine_shortlist": 1,
                     "surface_distances[shared]": 1, "surface_distances[per_chain]": 1,
                     "chol_solve_blocked": 1, "tri_solve_lt_blocked": 1,
                     "coarse_nearest_dot": 0, "shortlist_topk": 0, "point_tri_d2": 0}
# the adaptive femur setups: MALA's gradient runs the evaluator once more,
# with its own index pass (K3 shared + K4; the backward pass launches no
# kernel); hybrid keeps the flagship's fused pass and ICP factors
HYBRID_STEP_LAUNCHES = dict(FEMUR_STEP_LAUNCHES, **{"nearest_vertices[shared]": 2,
                                                    "refine_shortlist": 2})
MALA_STEP_LAUNCHES = dict(FEMUR_STEP_LAUNCHES, **{
    "chol_solve": 0, "tri_solve_lt": 0, "nearest_vertices[shared]": 2,
    "nearest_vertices[per_chain]": 0, "refine_shortlist": 2})
RW_STEP_LAUNCHES = dict(MALA_STEP_LAUNCHES, **{"nearest_vertices[shared]": 1,
                                               "refine_shortlist": 1})
BFM_FIT_STEPS = 5
# launches of the timed run_bfm_fitting(partial=True, verbose=True) outside
# its steps: the partial target's context (K9), the initial carry
# (collective evaluator: K5 shared and per chain; model-direction ICP: K3 +
# K4, one K6) and the boundary-aware reconstruction metric (one K5)
BFM_FIT_RUN_LAUNCHES = {"surface_distances[shared]": 2, "surface_distances[per_chain]": 1,
                        "nearest_vertices[shared]": 1, "refine_shortlist": 1,
                        "chol_solve_blocked": 1, **CONTEXT_LAUNCHES}
# the femur step with coarse="dot": K8 takes the shared coarse pass from K3
REG_STEP_LAUNCHES = dict(FEMUR_STEP_LAUNCHES, **{"nearest_vertices[shared]": 0,
                                                 "coarse_nearest_dot": 1})
# launches of one verbose registration run outside its steps: the target's
# context (K9), the initial carry's unfused queries (evaluator and
# model-direction ICP: K8 + K4 each; target-direction ICP: K3 per chain; two
# factorizations) and the four K5 queries of the reconstruction metrics
REG_RUN_LAUNCHES = {"coarse_nearest_dot": 2, "refine_shortlist": 2,
                    "nearest_vertices[per_chain]": 1, "chol_solve": 2,
                    "surface_distances[shared]": 4, **CONTEXT_LAUNCHES}
# the deterministic ICP: both directions every iteration (K3 shared + K4 for
# the model direction, K3 per chain for the target direction), one
# regression factor (K1 at r ≤ 104, K6 above)
ICP_ITERATIONS = 100
ICP_ITER_LAUNCHES = {"nearest_vertices[shared]": 1, "refine_shortlist": 1,
                     "nearest_vertices[per_chain]": 1, "chol_solve": 1, "shortlist_topk": 0}
ICP_ITER_LAUNCHES_BLOCKED = dict(ICP_ITER_LAUNCHES, chol_solve=0, chol_solve_blocked=1)
# run_deterministic_icp(verbose=True) outside its iterations: the target's
# context (K9) and the reconstruction metrics' three K5 queries (average
# distance one, Hausdorff two)
ICP_RUN_LAUNCHES = {"surface_distances[shared]": 3, **CONTEXT_LAUNCHES}
ICP_CHECK_INITS, ICP_CHECK_ITERATIONS = 4, 3
EXP_INITS, EXP_SAMPLES = 100, 1000
# the harness's MH batches at r = 201.  Euclidean: the ICP's 402 model ids
# are a prefix of the same seeded draw as the evaluator's 811, so one index
# pass serves both (mh._fusion_plan); a step adds the target direction's K3
# per chain, two K6 factors at the candidate and two K7 draws.  Hausdorff:
# the evaluator takes K5 both ways and the ICP its own index pass.  The
# initial carry queries the evaluator and the ICP anchors once, unfused,
# with no draw.
EXP_EUCLID_STEP = {"nearest_vertices[shared]": 1, "refine_shortlist": 1,
                   "nearest_vertices[per_chain]": 1, "chol_solve_blocked": 2,
                   "tri_solve_lt_blocked": 2}
EXP_EUCLID_INIT = {"nearest_vertices[shared]": 2, "refine_shortlist": 2,
                   "nearest_vertices[per_chain]": 1, "chol_solve_blocked": 2}
EXP_HAUSDORFF_STEP = {"nearest_vertices[shared]": 1, "refine_shortlist": 1,
                      "nearest_vertices[per_chain]": 1, "chol_solve_blocked": 2,
                      "tri_solve_lt_blocked": 2, "surface_distances[shared]": 1,
                      "surface_distances[per_chain]": 1}
EXP_HAUSDORFF_INIT = dict(EXP_HAUSDORFF_STEP, tri_solve_lt_blocked=0)
EXP_METRIC_LAUNCHES = {"surface_distances[shared]": 3}  # per mesh: avg 1, Hausdorff 2
EXP_LOG_KEYS = ["index", "modelPath", "targetPath", "samplingEuclideanLoggerPath",
                "samplingHausdorffLoggerPath", "coeffInit", "coeffSamplingEuclidean",
                "coeffSamplingHausdorff", "coeffIcp", "samplingEuclidean",
                "samplingHausdorff", "icp", "numOfEvaluationPoints", "numOfSamplePoints",
                "normalNoise", "datetime", "comment"]
RI_INITS, RI_ICP_SAMPLES, RI_MULTIPLIER = 5, 200, 5
# run_random_init_comparison at r = 101, full-resolution point counts: the
# ICP chains' model ids are the evaluator's, so one index pass a step serves
# the symmetric evaluator's model→target term and the ICP (mh._fusion_plan);
# a step adds K5 per chain (target→model), one K1 factor and one K2 draw;
# the initial carry queries the index twice (unfused) and draws nothing.
# The random walk a step (and its initial carry): one index pass and K5 per
# chain.  Then the metrics, K5 shared 3 per (method, init).
RI_ICP_STEP = {"nearest_vertices[shared]": 1, "refine_shortlist": 1, "chol_solve": 1,
               "tri_solve_lt": 1, "surface_distances[per_chain]": 1}
RI_ICP_INIT = dict(RI_ICP_STEP, tri_solve_lt=0, **{"nearest_vertices[shared]": 2,
                                                   "refine_shortlist": 2})
RI_RND_STEP = {"nearest_vertices[shared]": 1, "refine_shortlist": 1,
               "surface_distances[per_chain]": 1}
# the user pipelines around the sampler.  Femur: align a moved copy of the
# target, build the GPMM-100 with create_gp_model, read it back with
# load_femur_data, register PIPE_SAMPLES steps (flagship, coarse "exact"),
# then the replay CLI's two sub-commands at the JAX CLI's defaults.  A run
# of runfitting(verbose=False) launches outside its steps the initial
# carry's unfused queries (evaluator and model-direction ICP: K3 shared + K4
# each; target-direction ICP: K3 per chain), its two K1 factors and the
# target's context (K9).
PIPE_SAMPLES = 1200
PIPE_RUN_LAUNCHES = {"nearest_vertices[shared]": 2, "refine_shortlist": 2,
                     "nearest_vertices[per_chain]": 1, "chol_solve": 2, **CONTEXT_LAUNCHES}
REPLAY_STRIDE, REPLAY_SNAPSHOTS = 10, 50  # JAX CLI: replay --stride, --max-snapshots
POST_BURN_IN, POST_TAKE_EVERY = 200, 50  # JAX CLI: posterior --burn-in, --take-every
# Face: prepare_bfm_dataset on binary-PLY scans of the face stand-in
# (×1,000, moved rigidly), create_gp_model face at the reference's defaults
# on the open patch of subdivision FACE_REF_SUBDIV, load_bfm_data, then
# run_bfm_fitting(partial=True, verbose=False): outside its steps the
# partial target's context (K9) and the initial carry (collective
# evaluator: K5 shared and per chain; model-direction ICP: K3 + K4, one K6)
FACE_REF_SUBDIV = 5
FACE_DECIMATE_TO, FACE_RANK = 2000, 200  # create_gp_model face's defaults
FACE_SCANS = 2
FACE_FIT_RUN_LAUNCHES = {"surface_distances[shared]": 1, "surface_distances[per_chain]": 1,
                         "nearest_vertices[shared]": 1, "refine_shortlist": 1,
                         "chol_solve_blocked": 1, **CONTEXT_LAUNCHES}
# the configured run: build_from_config(RunConfig()) observes the
# reference's seeded ICP subsets, the evaluator's seeded subset's first
# 2·rank ids, so one index pass still serves both (mh._fusion_plan): the
# flagship step's launches
CONFIG_STEP_LAUNCHES = FEMUR_STEP_LAUNCHES
# The pod run: apps/pod_chains at its defaults (the stand-in GPMM-100,
# flagship, records kept), one process; its context and initial carry
# launch what runfitting's do (PIPE_RUN_LAUNCHES), then the flagship step's
# launches a step.  The bare step (store_params=False) and the runner are then timed
# in turns at the same chains.
POD_CHAINS, POD_STEPS = 1024, 1000
POD_RUN_LAUNCHES = PIPE_RUN_LAUNCHES
POD_BARE_WARMUP, POD_BARE_STEPS = 5, 100
# [check:pod]: 64 chains x 100 steps with no group, in an NCCL group of one
# rank, and over two gloo ranks sharing the card
POD_CHECK_CHAINS, POD_CHECK_STEPS, POD_CHECK_SEED = 64, 100, 1024
POD_RANK_TIMEOUT = 300.0
# [main:evidence]: the posterior-evidence tools (icp_proposal_tpu_torch.tools)
# through their main() on the stand-in GPMM-50 (the JAX tools' width), cut
# in chains and steps; each must launch the kernels of its path at least once
EV_KS = (16, 32, 64, 128)
EV_ARGS = {
    "validate_index": ["--ks", *map(str, EV_KS)],
    "validate_index[dot]": ["--ks", "64", "--coarse", "dot"],
    "mixing_sweep": ["--quick", "--chains", "64", "--steps", "250"],
    "posterior_parity": ["--chains", "64", "--steps", "500", "--segment", "250"],
    "quality_run": ["--chains", "16", "--samples", "250"],
    "quality_bfm": ["--chains", "16", "--samples", "200"],
    "converged_run": ["--chains", "64", "--round-steps", "500", "--max-rounds", "2",
                      "--segment-steps", "250"],
    "crossimpl_parity": ["--port-chains", "2", "--procs", "2", "--steps", "500",
                         "--burn", "100", "--chains", "64"],
}
_EV_FEMUR = ("chol_solve", "tri_solve_lt", "nearest_vertices[shared]",
             "nearest_vertices[per_chain]", "refine_shortlist", "surface_distances[shared]",
             "shortlist_topk")
EV_KERNELS = {  # every tool that builds a shortlist index launches K9
    "validate_index": ("nearest_vertices[shared]", "refine_shortlist",
                       "surface_distances[shared]", "shortlist_topk"),
    "validate_index[dot]": ("coarse_nearest_dot", "refine_shortlist",
                            "surface_distances[shared]", "shortlist_topk"),
    "mixing_sweep": _EV_FEMUR,
    "posterior_parity": _EV_FEMUR,
    "quality_run": _EV_FEMUR,
    # rank 24: K1/K2, the partial face's collective evaluator K5 both ways
    "quality_bfm": ("chol_solve", "tri_solve_lt", "nearest_vertices[shared]",
                    "refine_shortlist", "surface_distances[shared]",
                    "surface_distances[per_chain]", "shortlist_topk"),
    "converged_run": ("nearest_vertices[shared]", "refine_shortlist",  # the random walk
                      "shortlist_topk"),
    # parity mode without the index (so no K9): K5 for the evaluator and the
    # model direction, K3 per chain for the target direction
    "crossimpl_parity": ("chol_solve", "tri_solve_lt", "nearest_vertices[per_chain]",
                         "surface_distances[shared]"),
}
SOURCES = {  # record → (source in the port, TPU kernel it replaces)
    "chol_solve": ("csrc/chol.cu", "icp_proposal_tpu/ops/chol_pallas.py:74"),
    "tri_solve_lt": ("csrc/chol.cu", "icp_proposal_tpu/ops/chol_pallas.py:329"),
    "nearest_vertices[shared]": ("csrc/closest_point.cu",
                                 "icp_proposal_tpu/ops/closest_point_pallas.py:335"),
    "nearest_vertices[per_chain]": ("csrc/closest_point.cu",
                                    "icp_proposal_tpu/ops/closest_point_pallas.py:335"),
    "refine_shortlist": ("csrc/closest_point.cu",
                         "icp_proposal_tpu/ops/closest_point_pallas.py:613"),
    "surface_distances[shared]": ("csrc/closest_point.cu",
                                  "icp_proposal_tpu/ops/closest_point_pallas.py:122"),
    "surface_distances[per_chain]": ("csrc/closest_point.cu",
                                     "icp_proposal_tpu/ops/closest_point_pallas.py:122"),
    "chol_solve_blocked": ("csrc/chol.cu", "icp_proposal_tpu/ops/chol_pallas.py:145"),
    "tri_solve_lt_blocked": ("csrc/chol.cu", "icp_proposal_tpu/ops/chol_pallas.py:293"),
    "coarse_nearest_dot": ("csrc/closest_point.cu",
                           "icp_proposal_tpu/ops/closest_point_pallas.py:465"),
    # host C++ kernels of the JAX package, not Pallas kernels
    "shortlist_topk": ("csrc/point_tri.cu", "icp_proposal_tpu/native/point_tri.cpp:114"),
    "point_tri_d2": ("csrc/point_tri.cu", "icp_proposal_tpu/native/point_tri.cpp:100"),
}
VALUE_TOL = {"chol_solve", "tri_solve_lt", "chol_solve_blocked", "tri_solve_lt_blocked"}


def _sync(torch):
    torch.cuda.synchronize()


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps=KERNEL_REPS):
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync(torch)
    return start.elapsed_time(end) / reps


def _paired_times(torch, kernel, plain, reps=KERNEL_REPS, plain_reps=None):
    """plain, kernel, kernel, plain in turns → (kernel ms, plain ms)."""
    p1 = _time_ms(torch, plain, plain_reps or reps)
    k1 = _time_ms(torch, kernel, reps)
    k2 = _time_ms(torch, kernel, reps)
    p2 = _time_ms(torch, plain, plain_reps or reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _bound(n_bytes, n_flops, peak=PEAK_FP32_FLOPS):
    """The least time the card could take: bytes over HBM bandwidth or
    operations over their type's peak (FP32 unless ``peak`` says FP64),
    whichever is larger → (ms, bound_by)."""
    t_bytes, t_ops = n_bytes / PEAK_HBM_BYTES, n_flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _id_errors(ids, ids_p):
    """(max |id − id_plain| as a float, number of ids that differ)."""
    diff = (ids.long() - ids_p.long()).abs()
    return float(diff.max()), int((diff != 0).sum())


def _record(torch, err, mism, kernel, plain, n_bytes, n_flops, library=None,
            reps=KERNEL_REPS, plain_reps=None, peak=PEAK_FP32_FLOPS):
    k_ms, p_ms = _paired_times(torch, kernel, plain, reps, plain_reps)
    bound_ms, bound_by = _bound(n_bytes, n_flops, peak)
    lib_ms = _time_ms(torch, library, reps) if library is not None else None
    return dict(max_abs_err=err, id_mismatches=mism, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def _spd(torch, dev, rng, b, r, bad):
    """SPD systems like M = I + QᵀPQ, chain ``bad`` deliberately not SPD."""
    import numpy as np

    a = torch.as_tensor(rng.randn(b, r, 3 * r).astype(np.float32) * 0.1, device=dev)
    m = (a @ a.transpose(1, 2) + torch.eye(r, device=dev)).contiguous()
    m[bad, r // 2, r // 2] = -1.0
    return m, torch.as_tensor(rng.randn(b, r).astype(np.float32), device=dev)


def _chol_records(torch, dev, rng, b, r, factor, solve, prefix=""):
    """A Cholesky kernel and its triangular solve against the plain twins.
    No single PyTorch call computes the factor, the solve and log det, so
    the factor's library column is None; ``torch.linalg.cholesky_ex`` (the
    factor only) is timed in turns with the kernel (cholesky_ex, kernel,
    kernel, cholesky_ex) as ``factor_only_ms`` beside the kernel's
    ``ms_vs_factor_only``."""
    import numpy as np

    from icp_proposal_tpu_torch.ops import chol_cuda as cc

    m, rhs = _spd(torch, dev, rng, b, r, bad=b // 2)
    l, x, ld = factor(m, rhs)
    l_p, x_p, ld_p = cc.chol_solve_plain(m, rhs)
    _sync(torch)
    good = torch.arange(b, device=dev) != b // 2
    for got, want in ((l, l_p), (x, x_p), (ld, ld_p)):
        torch.testing.assert_close(got[good], want[good], rtol=TOL, atol=TOL)
    if not (torch.isnan(x[b // 2]).all() and torch.isnan(ld[b // 2])):
        raise AssertionError(f"{prefix}: a non-SPD pivot must give NaN")
    err = max(float((g[good] - w[good]).abs().max())
              for g, w in ((l, l_p), (x, x_p), (ld, ld_p)))
    # a factor needs M's lower triangle only, r(r + 1)/2 floats per chain
    chol_bytes = b * r * (r + 1) // 2 * m.element_size() + _nbytes(rhs, l, x, ld)
    chol_flops = b * (r ** 3 / 3 + 2 * r * r)  # factor + two substitutions
    rec_f = _record(torch, err, 0, lambda: factor(m, rhs),
                    lambda: cc.chol_solve_plain(m, rhs), chol_bytes, chol_flops)
    rec_f["ms_vs_factor_only"], rec_f["factor_only_ms"] = _paired_times(
        torch, lambda: factor(m, rhs), lambda: torch.linalg.cholesky_ex(m))

    lg = l[good].contiguous()
    z = torch.as_tensor(rng.randn(b - 1, r).astype(np.float32), device=dev)
    xt, xt_p = solve(lg, z), cc.tri_solve_lt_plain(lg, z)
    _sync(torch)
    torch.testing.assert_close(xt, xt_p, rtol=TOL, atol=TOL)
    # the solve needs only L's lower triangle, r(r + 1)/2 floats per chain
    tri_bytes = (b - 1) * r * (r + 1) // 2 * lg.element_size() + _nbytes(z, xt)
    rec_s = _record(torch, float((xt - xt_p).abs().max()), 0, lambda: solve(lg, z),
                    lambda: cc.tri_solve_lt_plain(lg, z), tri_bytes, (b - 1) * r * r,
                    library=lambda: torch.linalg.solve_triangular(
                        lg.transpose(-1, -2), z[..., None], upper=True))
    return rec_f, rec_s, (m, rhs)


def _print_tiled_config(torch, tag, name, r, warps):
    """Print the launch of the tiled K1/K6 kernel at rank r: tile edge,
    shared memory per chain as the launch sizes it, and CTAs (chains) per SM
    from CUDA's occupancy calculator."""
    from icp_proposal_tpu_torch.ops import chol_cuda as cc

    nt = -(-r // cc.TILE)
    smem, ctas = cc.tiled_smem_bytes(r, warps), cc.tiled_ctas_per_sm(r, warps)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[{tag}] {name} launch at r={r}: tile {cc.TILE}, padded to {nt * cc.TILE}, "
          f"{nt * (nt + 1) // 2} packed lower tiles, {warps} warps, {smem} B of "
          f"shared memory per chain, {ctas} CTAs (chains) per SM, "
          f"{ctas * sms} chains resident on {sms} SMs")


def _anchor_gaps(torch, q, points, ids, ids_exact, chunk=16):
    """How far K8's anchors ``ids`` fall from the exact nearest vertex, in
    float64: (number of anchors that differ from ``ids_exact``, max of the
    anchor's d² − the exact minimum d², max of that gap over its rounding
    bound GAP_ULPS·(‖q‖ + maxᵥ‖v‖)²)."""
    p64, vmax = points.double(), float(points.double().norm(dim=-1).max())
    gap_max = ratio_max = 0.0
    for lo in range(0, q.shape[0], chunk):
        q64 = q[lo:lo + chunk].double()
        d2 = ((q64[:, :, None, :] - p64) ** 2).sum(-1)  # [n, P, V]
        got = torch.gather(d2, -1, ids[lo:lo + chunk, :, None].long())[..., 0]
        gap = got - d2.amin(-1)
        bound = GAP_ULPS * (q64.norm(dim=-1) + vmax) ** 2
        gap_max = max(gap_max, float(gap.max()))
        ratio_max = max(ratio_max, float((gap / bound).max()))
    return int((ids != ids_exact).sum()), gap_max, ratio_max


def _print_nv_config(torch, tag, b, p, v, per_chain, dot=False):
    """Print K3's launch (with ``dot`` K8's, on K3's scan) at these shapes:
    queries a lane holds, threads per block, blocks, dynamic shared memory
    per block and CTAs per SM (from CUDA's occupancy calculator)."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cp

    cfg = cp.nearest_vertices_config(b, p, v, per_chain, dot=dot)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mode = "coarse_nearest_dot" if dot else (
        f"nearest_vertices[{'per_chain' if per_chain else 'shared'}]")
    print(f"[{tag}] {mode} launch at B={b}, P={p}, V={v}: Q={cfg['q']} "
          f"queries a lane, {cfg['threads']} threads per block, {cfg['blocks']} blocks, "
          f"{cfg['smem_bytes']} B of dynamic shared memory per block, "
          f"{cfg['ctas_per_sm']} CTAs per SM on {sms} SMs")


def _print_refine_config(torch, tag, n, index):
    """Print K4's launch for ``n`` queries: lanes a query, threads per block,
    blocks, registers a thread and CTAs per SM (CUDA's occupancy
    calculator), and the face table it reads."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cp

    cfg = cp.refine_shortlist_config(n)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[{tag}] refine_shortlist launch for {n} queries: {cfg['lanes']} lanes a query, "
          f"{cfg['threads']} threads per block, {cfg['blocks']} blocks, {cfg['registers']} "
          f"registers a thread, no shared memory, {cfg['ctas_per_sm']} CTAs per SM on "
          f"{sms} SMs; face table [{index.faces.shape[0]}, {index.faces.shape[1]}] "
          f"({index.faces.numel() * 4} B), K={index.k}")


def _closest_records(torch, dev, rng, b, data, ctx, ctx_dot):
    """K3 (both modes), K4 and K8 against their plain twins at the femur
    path's shapes on ``b`` chains → (records, queries, K3's shared ids).
    At ``N_CHAINS`` the twins run once a turn (they take tens of ms)."""
    import numpy as np

    from icp_proposal_tpu_torch.ops import closest_point_cuda as cp

    r, v = data.model.rank, data.model.num_points
    plain_reps = 2 if b > CMP_CHAINS else None
    records = {}
    # K3: shared target vertices (P = 4·rank) and per-chain meshes (P = 2·rank)
    ref = data.model.ref_points
    q = (ref[torch.as_tensor(rng.randint(0, v, (b, 4 * r)), device=dev)]
         + torch.as_tensor(rng.randn(b, 4 * r, 3).astype(np.float32) * 0.5,
                           device=dev)).contiguous()
    pts_b = (ref[None] + torch.as_tensor(rng.randn(b, 1, 3).astype(np.float32),
                                         device=dev)).contiguous()
    tq = ctx.points[:2 * r].expand(b, -1, -1).contiguous()
    for mode, (qq, pts) in (("shared", (q, ctx.index.points)),
                            ("per_chain", (tq, pts_b))):
        ids, ids_p = cp.nearest_vertices(qq, pts), cp.nearest_vertices_plain(qq, pts)
        _sync(torch)
        pairs = qq.shape[0] * qq.shape[1] * pts.shape[-2]
        records[f"nearest_vertices[{mode}]"] = _record(
            torch, *_id_errors(ids, ids_p), lambda: cp.nearest_vertices(qq, pts),
            lambda: cp.nearest_vertices_plain(qq, pts), _nbytes(qq, pts, ids),
            NV_PAIR_FLOPS * pairs, plain_reps=plain_reps)
        del ids_p
    nv = cp.nearest_vertices(q, ctx.index.points)

    # K4: the K = 64 shortlist of each query's coarse vertex, corners read
    # from the index's face table
    idx = ctx.index
    f, w = cp.refine_shortlist(q, nv, idx.cand, idx.faces)
    f_p, w_p = cp.refine_shortlist_plain(q, nv, idx.cand, idx.faces)
    _sync(torch)
    err, mism = _id_errors(f, f_p)
    if not torch.equal(w.view(torch.int32), w_p.view(torch.int32)):
        raise AssertionError("K4: the winner's corners differ from the twin's bitwise")
    records["refine_shortlist"] = _record(
        torch, max(err, float((w - w_p).abs().max())), mism,
        lambda: cp.refine_shortlist(q, nv, idx.cand, idx.faces),
        lambda: cp.refine_shortlist_plain(q, nv, idx.cand, idx.faces),
        _nbytes(q, nv, idx.cand, idx.faces, f, w),
        PAIR_FLOPS * q.shape[0] * q.shape[1] * idx.k, plain_reps=plain_reps)
    del f_p, w_p

    # K8: the dot-form coarse pass of ctx_dot's index on the same queries
    va = ctx_dot.index.points_aug
    ids8, ids8_p = cp.coarse_nearest_dot(q, va), cp.coarse_nearest_dot_plain(q, va)
    _sync(torch)
    records["coarse_nearest_dot"] = _record(
        torch, *_id_errors(ids8, ids8_p), lambda: cp.coarse_nearest_dot(q, va),
        lambda: cp.coarse_nearest_dot_plain(q, va), _nbytes(q, va, ids8),
        DOT_PAIR_FLOPS * q.shape[0] * q.shape[1] * va.shape[0], plain_reps=plain_reps)
    return records, q, nv, ids8


def phase_kernels(torch, dev, data, ctx, ctx_dot):
    """K1–K4 and K8 against the plain twins at the femur path's shapes on
    ``CMP_CHAINS`` and ``N_CHAINS`` chains (the larger as ``at_2048_chains``
    in each record); K3's launches; K8's anchors against K3's."""
    import numpy as np

    from icp_proposal_tpu_torch.ops import chol_cuda as cc

    rng = np.random.RandomState(0)
    b, r, v = CMP_CHAINS, data.model.rank, data.model.num_points
    records = {}
    records["chol_solve"], records["tri_solve_lt"], _ = _chol_records(
        torch, dev, rng, b, r, cc.chol_solve, cc.tri_solve_lt, "K1")
    _print_tiled_config(torch, "kernels", "chol_solve", r, cc.K1_WARPS)
    big = dict(zip(("chol_solve", "tri_solve_lt"), _chol_records(
        torch, dev, rng, N_CHAINS, r, cc.chol_solve, cc.tri_solve_lt, "K1")[:2]))

    closest, q, nv, ids8 = _closest_records(torch, dev, rng, b, data, ctx, ctx_dot)
    records.update(closest)
    n_diff, gap, ratio = _anchor_gaps(torch, q, ctx_dot.index.points, ids8, nv)
    print(f"[kernels] coarse_nearest_dot vs nearest_vertices[shared]: {n_diff} of "
          f"{nv.numel()} anchors differ; largest true-d² gap above the exact minimum "
          f"{gap:.3g} mm², {ratio:.3g} of its bound 2^-21·(‖q‖ + max‖v‖)²")
    if ratio > 1.0:
        raise AssertionError("K8 anchors exceed the rounding bound of the dot form")
    del q, nv, ids8
    big.update(_closest_records(torch, dev, rng, N_CHAINS, data, ctx, ctx_dot)[0])
    for chains in (CMP_CHAINS, N_CHAINS):
        _print_nv_config(torch, "kernels", chains, 4 * r, ctx.index.points.shape[0], False)
        _print_nv_config(torch, "kernels", chains, 2 * r, v, True)
        _print_nv_config(torch, "kernels", chains, 4 * r, ctx.index.points.shape[0], False,
                         dot=True)
        _print_refine_config(torch, "kernels", chains * 4 * r, ctx.index)
    for name, rec in big.items():
        records[name]["at_2048_chains"] = rec
    return records


def _k5_records(torch, dev, rng, b, model, evaluator):
    """K5 culled, the dense scan and the plain twin on the evaluator's own
    queries (a Hausdorff term's: every vertex) at ``b`` chains moved off
    the mean: all three
    bitwise equal (d² and ids), else raise; the culled kernel's share of
    (query, tile) and (query, face) pairs from one counted call."""
    import numpy as np

    from icp_proposal_tpu_torch.ops import closest_point_cuda as cp
    from icp_proposal_tpu_torch.sampling.state import init_state, transformed_points

    ctx = evaluator.ctx
    state = init_state(model, b)
    state = state._replace(coeffs=torch.as_tensor(
        rng.randn(b, model.rank).astype(np.float32) * 0.5, device=dev))
    pts = transformed_points(model, state).contiguous()
    spec = evaluator.specs[0]
    if hasattr(spec, "n_points"):  # a seeded subset each way
        ids_m = torch.as_tensor(evaluator.model_ids(spec.name), dtype=torch.int64, device=dev)
        ids_t = torch.as_tensor(evaluator.target_ids(spec.name), dtype=torch.int64,
                                device=dev)
    else:  # the Hausdorff term: every vertex each way
        ids_m = torch.arange(model.num_points, device=dev)
        ids_t = torch.arange(len(ctx.points), device=dev)
    cases = {"shared": (pts[:, ids_m].contiguous(), ctx.points, ctx.cells.int()),
             "per_chain": (ctx.points[ids_t].contiguous(), pts, model.cells.int())}
    records = {}
    for mode, args in cases.items():
        d2, fidx = cp.surface_distances(*args)
        d2_d, fidx_d = cp.surface_distances(*args, cull=False)
        d2_p, fidx_p = cp.surface_distances_plain(*args)
        visits = torch.zeros(2, dtype=torch.int64, device=dev)
        cp.surface_distances(*args, visits=visits)
        _sync(torch)
        for what, (dd, ff) in (("the dense scan", (d2_d, fidx_d)),
                               ("the plain twin", (d2_p, fidx_p))):
            if not (torch.equal(d2, dd) and torch.equal(fidx, ff)):
                raise AssertionError(f"K5 {mode} at {b} chains: the culled kernel differs "
                                     f"from {what} ({int((fidx != ff).sum())} ids, "
                                     f"{int((d2 != dd).sum())} d²)")
        err, mism = _id_errors(fidx, fidx_p)
        err = max(err, float((d2 - d2_p).abs().max()))
        q, points, cells = args
        p, f = q.shape[-2], cells.shape[0]
        n_tiles = -(-f // cp.TILE_FACES)
        tiles_seen, pairs_seen = (int(x) for x in visits.tolist())
        n_bytes = _nbytes(q, points, cells, d2, fidx)
        def dense():
            return cp.surface_distances(*args, cull=False)

        dense_ms = _time_ms(torch, dense, 5)  # dense, culled, culled, dense
        rec = _record(torch, err, mism, lambda: cp.surface_distances(*args),
                      lambda: cp.surface_distances_plain(*args), n_bytes,
                      PAIR_FLOPS * pairs_seen, reps=5,
                      plain_reps=1 if b > CMP_CHAINS else 5)
        dense_ms = (dense_ms + _time_ms(torch, dense, 5)) / 2
        rec.update(dense_ms=dense_ms,
                   dense_bound_ms=_bound(n_bytes, PAIR_FLOPS * b * p * f)[0],
                   tile_share=tiles_seen / (b * p * n_tiles), pair_share=pairs_seen / (b * p * f),
                   chains=b)
        records[f"surface_distances[{mode}]"] = rec
    return records


def phase_kernels_bfm(torch, dev, data, evaluator):
    """K5 (both modes), K6 and K7 against the plain twins at the BFM path's
    shapes on ``CMP_CHAINS`` and on ``N_CHAINS`` chains (the larger as
    ``at_2048_chains`` in each record); K1 at r = 200 timed beside K6."""
    import numpy as np

    from icp_proposal_tpu_torch.ops import chol_cuda as cc

    rng = np.random.RandomState(1)
    b, model = CMP_CHAINS, data.model
    records = {}
    records["chol_solve_blocked"], records["tri_solve_lt_blocked"], (m, rhs) = (
        _chol_records(torch, dev, rng, b, model.rank, cc.chol_solve_blocked,
                      cc.tri_solve_lt_blocked, "K6"))
    _print_tiled_config(torch, "kernels:bfm", "chol_solve_blocked", model.rank, cc.K6_WARPS)
    _print_tiled_config(torch, "kernels:bfm", "chol_solve (K1, forced)", model.rank,
                        cc.K1_WARPS)
    k1_ms, k6_ms = _paired_times(torch, lambda: cc.chol_solve(m, rhs, blocked=False),
                                 lambda: cc.chol_solve_blocked(m, rhs))
    print(f"[kernels:bfm] K1 chol_solve at r={model.rank}: {k1_ms:.4f} ms; K6 "
          f"chol_solve_blocked {k6_ms:.4f} ms; {b} chains")
    records.update(_k5_records(torch, dev, rng, b, model, evaluator))
    big = dict(zip(("chol_solve_blocked", "tri_solve_lt_blocked"), _chol_records(
        torch, dev, rng, N_CHAINS, model.rank, cc.chol_solve_blocked,
        cc.tri_solve_lt_blocked, "K6")[:2]))
    big.update(_k5_records(torch, dev, rng, N_CHAINS, model, evaluator))
    for name, rec in big.items():
        records[name]["at_2048_chains"] = rec
    return records


def phase_kernels_harness(torch, dev, data):
    """K5 (both modes) at the femur widths of the Hausdorff evaluator (every
    model vertex against the target's faces; every target vertex against
    each chain's faces), K6 and K7 at r = 201, each against its plain twin
    on ``EXP_INITS`` chains, the harness's batch → records, which go into
    the kernels' records as ``at_harness``."""
    import numpy as np

    from icp_proposal_tpu_torch.apps.femur_experiments import _harness_setup
    from icp_proposal_tpu_torch.ops import chol_cuda as cc

    rng = np.random.RandomState(2)
    model = data.model
    *_, eval_hausdorff = _harness_setup(model, data.target, data.model_boundary_mask)
    records = dict(zip(("chol_solve_blocked", "tri_solve_lt_blocked"), _chol_records(
        torch, dev, rng, EXP_INITS, model.rank, cc.chol_solve_blocked,
        cc.tri_solve_lt_blocked, "K6")[:2]))
    records.update(_k5_records(torch, dev, rng, EXP_INITS, model, eval_hausdorff))
    for rec in records.values():
        rec.update(chains=EXP_INITS, rank=model.rank)
    return records


def _index_record(torch, label, q, tri, k, n_ops):
    """K9 on (q, tri) at ``k`` against its twin on the card, ids and d²
    bitwise, else raise; timed in turns with the twin; the bound over this
    input's cascade operations (``n_ops``) at the FP64 peak → record."""
    from icp_proposal_tpu_torch import native

    idx, d2 = native.shortlist_topk(q, tri, k)
    idx_p, d2_p = native.shortlist_topk_plain(q, tri, k)
    _sync(torch)
    err, mism = _id_errors(idx, idx_p)
    if mism or not torch.equal(d2.view(torch.int64), d2_p.view(torch.int64)):
        raise AssertionError(f"[kernels:index] K9 {label} K={k}: {mism} ids or the d² "
                             "differ from the twin's bitwise")
    rec = _record(torch, max(err, float((d2 - d2_p).abs().max())), mism,
                  lambda: native.shortlist_topk(q, tri, k),
                  lambda: native.shortlist_topk_plain(q, tri, k),
                  _nbytes(q, tri, idx, d2), n_ops, plain_reps=3, peak=PEAK_FP64_FLOPS)
    rec.update(queries=q.shape[0], faces=tri.shape[0], k=idx.shape[1])
    _print_index_record(f"shortlist_topk[{label}, K={k}]", rec)
    return rec


def _print_index_record(name, rec, held="ids and d²"):
    lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
    print(f"[kernels:index] {name}: {rec['queries']} queries x {rec['faces']} faces; {held} "
          f"bitwise the twin's; kernel {rec['ms']:.4f} ms, twin on the card "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}, "
          f"FP64 at {PEAK_FP64_FLOPS / 1e12:g} TFLOP/s, HBM at {PEAK_HBM_BYTES / 1e12:g} "
          f"TB/s), library {lib}")


def phase_kernels_index(torch, dev, data, ctx, face, partial_ctx):
    """``[kernels:index]``: K9 and K10 against their twins on the card, d²
    and ids bitwise, on the inputs the index build gives them (a context's
    float32 points and Morton-ordered corners, in float64): the femur
    stand-in's target at K = 16, 32, 64, 128, the face target and the
    partial face at K = 64, K10 at the femur shape, and the open patch of
    subdivision 5 (F spanning many tiles) at K = 64 and K = MAX_K; then
    whole ``build_target_context`` calls on the card at the femur and face
    shapes, timed, each launching K9 once → records by kernel."""
    from icp_proposal_tpu_torch import native
    from icp_proposal_tpu_torch.models.synthetic import make_open_patch
    from icp_proposal_tpu_torch.sampling.context import build_target_context

    def inputs(index):
        return index.points.double(), index.tri.reshape(-1, 9).double()

    face_ctx = build_target_context(face.target, face.target_boundary_mask, device=dev)
    records = {}
    meshes = {"femur": (inputs(ctx.index), EV_KS),  # the index sweep's widths
              "face": (inputs(face_ctx.index), (64,)),
              "partial-face": (inputs(partial_ctx.index), (64,))}
    points, cells = make_open_patch(subdivisions=FACE_REF_SUBDIV, radius=0.1, z_cut=0.55)
    patch = torch.as_tensor(points, dtype=torch.float32, device=dev)
    tri = patch[torch.as_tensor(cells, dtype=torch.int64, device=dev)]
    q = patch[::8].double().contiguous()
    meshes["tiles"] = ((q, tri.reshape(-1, 9).double()), (64, native.MAX_K))
    for label, ((q, tri), ks) in meshes.items():
        n_ops = native.cascade_ops(q, tri)
        for k in ks:
            records[f"{label} K={k}"] = _index_record(torch, label, q, tri, k, n_ops)

    def tiles(f, k):
        return -(-f // (native.TOPK_SORT - k))

    print(f"[kernels:index] faces in tiles of TOPK_SORT - K: the open patch "
          f"{tiles(meshes['tiles'][0][1].shape[0], 64)} tiles at K = 64 and "
          f"{tiles(meshes['tiles'][0][1].shape[0], native.MAX_K)} at K = {native.MAX_K}; "
          f"the femur target {tiles(meshes['femur'][0][1].shape[0], 64)} at K = 64")

    # K10: the full d² matrix at the femur shape
    q, tri = meshes["femur"][0]
    full, full_p = native.point_tri_d2(q, tri), native.point_tri_d2_plain(q, tri)
    _sync(torch)
    if not torch.equal(full.view(torch.int64), full_p.view(torch.int64)):
        raise AssertionError(f"[kernels:index] K10: {int((full != full_p).sum())} d² differ "
                             "from the twin's bitwise")
    k10 = _record(torch, float((full - full_p).abs().max()), 0,
                  lambda: native.point_tri_d2(q, tri), lambda: native.point_tri_d2_plain(q, tri),
                  _nbytes(q, tri, full), native.cascade_ops(q, tri), plain_reps=3,
                  peak=PEAK_FP64_FLOPS)
    k10.update(queries=q.shape[0], faces=tri.shape[0])
    _print_index_record("point_tri_d2[femur]", k10, held="d²")
    del full, full_p

    # whole contexts on the card: the points go up once, K9 builds the index
    for label, (target, mask) in {"femur": (data.target, data.target_boundary_mask),
                                  "face": (face.target, face.target_boundary_mask)}.items():
        secs = []
        for _ in range(3):
            _reset_counts()
            t = time.perf_counter()
            built = build_target_context(target, mask, device=dev)
            _sync(torch)
            secs.append(time.perf_counter() - t)
            _check_launches(f"[kernels:index] build_target_context[{label}]", _read_counts(),
                            CONTEXT_LAUNCHES, 1)
        print(f"[kernels:index] build_target_context on the card, {label} target "
              f"({len(target.points)} vertices, {len(target.cells)} faces, K="
              f"{built.index.k}): {', '.join(f'{s:.4f}' for s in secs)} s (3 calls; K9 "
              "launched once each)")
    rec = records.pop("femur K=64")
    rec["at"] = records
    return {"shortlist_topk": rec, "point_tri_d2": k10}


def _print_records(tag, records, chains=CMP_CHAINS):
    for name, rec in records.items():
        for n, r in ((chains, rec), (N_CHAINS, rec.get("at_2048_chains"))):
            if r is not None:
                _print_record(tag, name, r, n)


def _print_record(tag, name, rec, chains):
    tol = TOL if name in VALUE_TOL else 0
    held = f"rtol {TOL:g} + atol {TOL:g}" if tol else "exact"
    lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
    print(f"[{tag}] {name}: max_abs_err {rec['max_abs_err']:.3g} (held {held}), "
          f"{rec['id_mismatches']} ids differ, kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}), library {lib}, {chains} chains")
    if "factor_only_ms" in rec:
        faster = rec["ms_vs_factor_only"] < rec["factor_only_ms"]
        print(f"[{tag}] {name}: turns with torch.linalg.cholesky_ex (the factor only, "
              f"not the same function): kernel {rec['ms_vs_factor_only']:.4f} ms, "
              f"cholesky_ex {rec['factor_only_ms']:.4f} ms; kernel faster: {faster}; "
              f"{chains} chains")
    if "dense_ms" in rec:
        print(f"[{tag}] {name}: culled {rec['ms']:.4f} ms, dense scan "
              f"{rec['dense_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms; culled visits "
              f"{rec['tile_share']:.4f} of the (query, tile) pairs and "
              f"{rec['pair_share']:.4f} of the (query, face) pairs; bound over the pairs "
              f"visited {rec['bound_ms']:.4f} ms, dense bound {rec['dense_bound_ms']:.4f} "
              f"ms; culled = dense scan = plain twin bitwise; {chains} chains")
    if rec["id_mismatches"] or (not tol and rec["max_abs_err"]):
        raise AssertionError(f"{name}: the kernel disagrees with its plain twin")


def _wrappers():
    from icp_proposal_tpu_torch import native
    from icp_proposal_tpu_torch.ops import chol_cuda, closest_point_cuda

    return (chol_cuda.chol_solve, chol_cuda.tri_solve_lt, chol_cuda.chol_solve_blocked,
            chol_cuda.tri_solve_lt_blocked, closest_point_cuda.nearest_vertices,
            closest_point_cuda.refine_shortlist, closest_point_cuda.surface_distances,
            closest_point_cuda.coarse_nearest_dot, native.shortlist_topk,
            native.point_tri_d2)


def _reset_counts():
    for fn in _wrappers():
        fn.launches = 0
        if hasattr(fn, "per_chain_launches"):
            fn.per_chain_launches = 0


def _read_counts():
    """Launch counts by record name; K3 and K5 split by mode."""
    counts = {}
    for fn in _wrappers():
        if hasattr(fn, "per_chain_launches"):
            counts[f"{fn.__name__}[per_chain]"] = fn.per_chain_launches
            counts[f"{fn.__name__}[shared]"] = fn.launches - fn.per_chain_launches
        else:
            counts[fn.__name__] = fn.launches
    return counts


def phase_main(torch, dev, tag, model, mixture, evaluator, warmup, timed, per_step):
    """``timed`` steps of ``N_CHAINS`` chains after ``warmup``; launch
    counts asserted against ``per_step`` → counts."""
    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.state import init_state

    step = mh.make_mh_step(model, mixture, evaluator)
    gen = torch.Generator(device=dev).manual_seed(0)
    carry = mh.init_carry(model, evaluator, init_state(model, N_CHAINS), mixture)
    carry, _ = mh.run_chains(step, carry, warmup, gen)
    _sync(torch)
    _reset_counts()
    t = time.perf_counter()
    carry, recs = mh.run_chains(step, carry, timed, gen)
    _sync(torch)
    dt = time.perf_counter() - t
    launches = _read_counts()
    acc = float(torch.stack([r.accepted for r in recs]).float().mean())
    print(f"[{tag}] {N_CHAINS} chains x {timed} steps in {dt:.3f} s: "
          f"{N_CHAINS * timed / dt:.1f} samples/s, {1e3 * dt / timed:.2f} ms/step, "
          f"acceptance {acc:.4f}; launches {launches}")
    _check_launches(tag, launches, per_step, timed)
    if not torch.isfinite(carry.log_post).all():
        raise AssertionError(f"{tag}: non-finite log_post after the main path")
    print(f"[{tag}] log_post finite; mean {float(carry.log_post.mean()):.3f}")
    if mixture.adapt is not None:
        scales = torch.exp(carry.adapt_log_scales)
        print(f"[{tag}] adaptive scale factors after {warmup + timed} steps, by "
              "component: " + "; ".join(
                  f"{name} {float(scales[:, i].min()):.4f}–{float(scales[:, i].max()):.4f}"
                  for i, name in enumerate(mixture.names) if mixture.adaptable[i]))
    for i, comp in mixture.icp_components.items():
        if hasattr(comp, "zeroed"):
            print(f"[{tag}] {mixture.names[i]}: {int(comp.zeroed)} non-finite gradient "
                  f"entries zeroed since the setup was built")
    return launches


def _check_launches(tag, launches, per_step, steps, outside=None):
    outside = outside or {}
    for name, n in per_step.items():
        want = n * steps + outside.get(name, 0)
        if launches[name] != want:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times, "
                                 f"expected {want} ({n} per step)")


def phase_registration(torch, dev, data):
    """The registration entry point at ``N_CHAINS`` chains with the
    flagship setup and coarse="dot": warm-up, a timed run with a JSON log
    (launch counts asserted), a resume from the log, and the step's time
    with coarse="exact" against coarse="dot" on the same chains → counts."""
    import math

    from icp_proposal_tpu_torch.apps.femur import (
        make_icp_proposal_setup,
        run_icp_proposal_registration,
    )
    from icp_proposal_tpu_torch.mesh import boundary_vertex_mask
    from icp_proposal_tpu_torch.registration.comparison import (
        evaluate_reconstruction,
        evaluate_reconstruction_boundary_aware,
    )
    from icp_proposal_tpu_torch.sampling import diagnostics, loggers, mh
    from icp_proposal_tpu_torch.sampling.state import transformed_mesh

    tag = "main:registration"
    common = dict(setup="flagship", coarse="dot", n_chains=N_CHAINS, data=data,
                  accept_info_interval=REG_SEGMENT)
    run_icp_proposal_registration(num_samples=REG_WARMUP_STEPS, verbose=False, **common)
    _sync(torch)
    BUILD.mkdir(exist_ok=True)
    log = BUILD / "registration_log.json"
    n_steps = REG_SEGMENT * REG_SEGMENTS
    _reset_counts()
    t = time.perf_counter()
    result, _ = run_icp_proposal_registration(num_samples=n_steps, json_path=str(log),
                                              seed=7, verbose=True, **common)
    _sync(torch)
    dt = time.perf_counter() - t
    launches = _read_counts()
    print(f"[{tag}] run_icp_proposal_registration(setup='flagship', coarse='dot'): "
          f"{N_CHAINS} chains x {n_steps} steps in {REG_SEGMENTS} segments; "
          f"FittingResult.samples_per_sec {result.samples_per_sec:.1f}; the whole call "
          f"{dt:.3f} s (setup and metrics included); launches {launches}")
    _check_launches(tag, launches, REG_STEP_LAUNCHES, n_steps, REG_RUN_LAUNCHES)
    print(f"[{tag}] launches per step: " + ", ".join(
        f"{name} {(launches[name] - REG_RUN_LAUNCHES.get(name, 0)) / n_steps:g}"
        for name in ("coarse_nearest_dot", "nearest_vertices[shared]",
                     "nearest_vertices[per_chain]", "refine_shortlist")))
    print(f"[{tag}] acceptance {json.dumps(result.acceptance)}")
    if len(result.json_records) != n_steps or len(loggers.load_log(log)) != n_steps:
        raise AssertionError(f"{tag}: the JSON log must hold {n_steps} records")
    best_mesh = transformed_mesh(data.model, result.best_state)
    avg, hd = evaluate_reconstruction("SAMPLE", best_mesh, data.target, verbose=False)
    mask = boundary_vertex_mask(data.target.cells, len(data.target.points))
    b_avg, b_max = evaluate_reconstruction_boundary_aware("Sampling", best_mesh,
                                                          data.target, mask, verbose=False)
    coeffs = torch.as_tensor(result.records.coeffs[..., :5], device=dev)
    rhat = diagnostics.split_rhat(coeffs).tolist()
    ess = diagnostics.ess(coeffs).tolist()
    print(f"[{tag}] best log value {result.best_log_value:.4f}; reconstruction average "
          f"{avg:.4f} mm, Hausdorff {hd:.4f} mm; boundary-aware average {b_avg:.4f} mm, "
          f"max {b_max:.4f} mm")
    print(f"[{tag}] split-R̂ of coefficients 0-4 over the run "
          f"{[round(x, 4) for x in rhat]}; ESS {[round(x, 1) for x in ess]}")
    if not all(math.isfinite(x) for x in (result.best_log_value, avg, hd, b_avg, b_max,
                                          *rhat, *ess)):
        raise AssertionError(f"{tag}: non-finite result")

    # resume from the log's last accepted record
    resumed, _ = run_icp_proposal_registration(
        num_samples=REG_SEGMENT, resume_log=str(log), resume_mode="last", verbose=False,
        **common)
    want = loggers.state_from_log(loggers.load_log(log), "last", device=dev)
    for got, w in zip(resumed.initial_state, want):
        if not torch.equal(got, w.expand_as(got)):
            raise AssertionError(f"{tag}: the resumed run did not start from the "
                                 "log's last accepted state")
    print(f"[{tag}] resume_mode='last': {N_CHAINS} chains started from the log's last "
          f"accepted record; {REG_SEGMENT} steps, acceptance "
          f"{resumed.acceptance['overall']:.4f}")

    # the femur step with the exact and the dot-form coarse pass, same chains
    ms = {"exact": [], "dot": []}
    runs = {}
    for coarse in ms:
        _, mix, ev = make_icp_proposal_setup(data, coarse=coarse)
        runs[coarse] = (mh.make_mh_step(data.model, mix, ev),
                        mh.init_carry(data.model, ev, result.final_states, mix))
    for coarse in ("exact", "dot", "dot", "exact"):
        step, carry = runs[coarse]
        gen = torch.Generator(device=dev).manual_seed(5)
        _sync(torch)
        t = time.perf_counter()
        mh.run_chains(step, carry, REG_CMP_STEPS, gen)
        _sync(torch)
        ms[coarse].append(1e3 * (time.perf_counter() - t) / REG_CMP_STEPS)
    print(f"[{tag}] femur step at {N_CHAINS} chains, turns exact/dot/dot/exact of "
          f"{REG_CMP_STEPS} steps: coarse='exact' "
          f"{', '.join(f'{x:.3f}' for x in ms['exact'])} ms/step; coarse='dot' "
          f"{', '.join(f'{x:.3f}' for x in ms['dot'])} ms/step")
    return launches


def _to_device(obj, dev):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_device(x, dev) for x in obj))
    if isinstance(obj, tuple):
        return tuple(_to_device(x, dev) for x in obj)
    return obj


def phase_check(torch, dev, tag, model, setup, cpu_setup_of, state=None):
    """8 chains, one step on the card and one on the CPU from the same carry
    with the same noise: same decisions (away from near-ties), same log
    posterior to rtol 1e-4.  ``cpu_setup_of(cpu_model)`` builds the same
    setup on the CPU; the chains start from ``state`` [8] (default the
    mean shape)."""
    from icp_proposal_tpu_torch.convert import gpmm_from_arrays
    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.state import init_state

    _, mixture, evaluator = setup
    cpu_model = gpmm_from_arrays(**{k: getattr(model, k).cpu().numpy()
                                    for k in model.__dataclass_fields__}, device="cpu")
    _, cpu_mixture, cpu_evaluator = cpu_setup_of(cpu_model)
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    cpu_step = mh.make_mh_step(cpu_model, cpu_mixture, cpu_evaluator, store_params=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    carry = mh.init_carry(model, evaluator, init_state(model, 8) if state is None else state,
                          mixture)
    carry, _ = mh.run_chains(step, carry, 4, gen)  # chains drift apart
    compared = accepted = 0
    for _ in range(3):
        noise = mh.draw_noise(mixture, 8, gen)
        nxt, rec = step(carry, noise)
        _, rec_c = cpu_step(_to_device(carry, "cpu"), _to_device(noise, "cpu"))
        _sync(torch)
        rec = _to_device(rec, "cpu")
        if not torch.equal(rec.proposal_idx, rec_c.proposal_idx):
            raise AssertionError(f"{tag}: proposal indices differ")
        clear = (rec.log_alpha - noise.log_u.cpu()).abs() > 1e-3
        if not torch.equal(rec.accepted[clear], rec_c.accepted[clear]):
            raise AssertionError(f"{tag}: accept decisions differ from the CPU run")
        torch.testing.assert_close(rec.log_product, rec_c.log_product, rtol=1e-4,
                                   atol=0)
        compared += int(clear.sum())
        accepted += int(rec.accepted.sum())
        for i, comp in mixture.icp_components.items():
            if hasattr(comp, "zeroed"):
                _check_gradient(tag, comp.factors(carry.state).cpu(),
                                cpu_mixture.icp_components[i].factors(
                                    _to_device(carry.state, "cpu")))
        carry = nxt
    print(f"[{tag}] card vs CPU plain twins, r={model.rank}, 8 chains x 3 steps: "
          f"{compared} decisions identical ({accepted} accepts), log posterior within "
          f"rtol 1e-4")


def _check_gradient(tag, got, want):
    """MALA's gradient on the card against the CPU's: rtol 1e-4 where
    |g| > 1, atol 1e-4 below, the same entries zeroed."""
    if not (got == 0).equal(want == 0):
        raise AssertionError(f"{tag}: MALA's zeroed gradient entries differ from the CPU's")
    big = want.abs() > 1
    rel = float(((got - want).abs() / want.abs())[big].max()) if big.any() else 0.0
    small = float((got - want).abs()[~big].max()) if (~big).any() else 0.0
    print(f"[{tag}] MALA gradient card vs CPU: max relative difference {rel:.3g} where "
          f"|g| > 1, max absolute {small:.3g} elsewhere; |g| up to {float(want.abs().max()):.4g}")
    if rel > 1e-4 or small > 1e-4:
        raise AssertionError(f"{tag}: MALA's gradient on the card differs from the CPU's")


def phase_bfm_fitting(torch, dev, face):
    """``run_bfm_fitting(partial=True)`` at ``N_CHAINS`` chains on the face:
    a warm-up run, then a timed run of ``BFM_FIT_STEPS`` steps (one segment)
    with a JSON log, read back; launch counts asserted → counts."""
    from icp_proposal_tpu_torch.apps.bfm import run_bfm_fitting
    from icp_proposal_tpu_torch.sampling import loggers

    tag = "main:bfm-fitting"
    common = dict(partial=True, num_samples=BFM_FIT_STEPS, n_chains=N_CHAINS)
    run_bfm_fitting(face, verbose=False, **common)
    _sync(torch)
    BUILD.mkdir(exist_ok=True)
    log = BUILD / "bfm_fitting_log.json"
    _reset_counts()
    t = time.perf_counter()
    result, _ = run_bfm_fitting(face, json_path=str(log), seed=3, verbose=True, **common)
    _sync(torch)
    dt = time.perf_counter() - t
    launches = _read_counts()
    sps = result.samples_per_sec
    print(f"[{tag}] run_bfm_fitting(partial=True): {N_CHAINS} chains x {BFM_FIT_STEPS} "
          f"steps in one segment; FittingResult.samples_per_sec {sps:.1f}, "
          f"{1e3 * N_CHAINS / sps:.2f} ms/step; the whole call {dt:.3f} s (setup, "
          f"initial carry and metrics included); acceptance "
          f"{result.acceptance['overall']:.4f}; launches {launches}")
    _check_launches(tag, launches, BFM_STEP_LAUNCHES, BFM_FIT_STEPS, BFM_FIT_RUN_LAUNCHES)
    records = loggers.load_log(log)
    if len(result.json_records) != BFM_FIT_STEPS or len(records) != BFM_FIT_STEPS:
        raise AssertionError(f"{tag}: the JSON log must hold {BFM_FIT_STEPS} records")
    if not (result.best_log_value > -float("inf")
            and torch.isfinite(result.final_states.coeffs).all()):
        raise AssertionError(f"{tag}: non-finite result")
    print(f"[{tag}] JSON log {log.name}: {len(records)} records read back; best log "
          f"value {result.best_log_value:.4f}")
    return launches


def _scaled(per_step, n, outside=None):
    """Launch counts of ``n`` steps of ``per_step`` plus ``outside``."""
    out = {name: c * n for name, c in per_step.items()}
    for name, c in (outside or {}).items():
        out[name] = out.get(name, 0) + c
    return out


def _check_counts(tag, got, want):
    """Every kernel's launches equal ``want`` (0 where it is not named)."""
    for name, n in got.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{tag}: {name} launched {n} times, expected "
                                 f"{want.get(name, 0)}")


def _delta(after, before):
    return {name: after[name] - before[name] for name in after}


def phase_icp(torch, dev, data):
    """``run_deterministic_icp`` at the reference's widths on the GPMM-50,
    verbose: its own ICP-Timing and reconstruction lines, ms per iteration,
    non-finite iterations and launch counts → counts."""
    import contextlib
    import io
    import re

    from icp_proposal_tpu_torch.apps.femur import run_deterministic_icp
    from icp_proposal_tpu_torch.registration.comparison import evaluate_reconstruction
    from icp_proposal_tpu_torch.sampling.state import init_state, transformed_mesh

    tag = "main:icp"
    model = data.model
    out = io.StringIO()
    _reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        coeffs, fitted, _, nonfinite = run_deterministic_icp(
            num_iterations=ICP_ITERATIONS, model_components=model.rank - 1, data=data,
            device=dev)
    _sync(torch)
    dt = time.perf_counter() - t
    launches = _read_counts()
    for line in out.getvalue().splitlines():
        print(f"[{tag}] {line}")
    fit_s = float(re.search(r"ICP-Timing: (\S+) sec", out.getvalue()).group(1))
    print(f"[{tag}] run_deterministic_icp(num_iterations={ICP_ITERATIONS}) on the stand-in "
          f"GPMM-{model.rank - 1} (rank {model.rank}): {model.num_points} model ids and "
          f"target points, sigma 1e-15, model_and_target; fit {fit_s:.3f} s = "
          f"{1e3 * fit_s / ICP_ITERATIONS:.3f} ms/iteration; the whole call {dt:.3f} s "
          f"(context, sampling and metrics included); non-finite iterations "
          f"{int(nonfinite)}; launches {launches}")
    _check_launches(tag, launches, ICP_ITER_LAUNCHES, ICP_ITERATIONS, ICP_RUN_LAUNCHES)
    avg, hd = evaluate_reconstruction("ICP", fitted, data.target, verbose=False)
    avg0, hd0 = evaluate_reconstruction("MEAN", transformed_mesh(model, init_state(model, 1)),
                                        data.target, verbose=False)
    print(f"[{tag}] reconstruction: average {avg:.4f} mm, Hausdorff {hd:.4f} mm; the mean "
          f"shape's: average {avg0:.4f} mm, Hausdorff {hd0:.4f} mm")
    if not (torch.isfinite(coeffs).all() and avg < avg0):
        raise AssertionError(f"{tag}: the fit is not finite or not closer than the mean")
    return launches


def _icp_inputs(torch, model, target, n_inits, seed):
    """Inits, model ids, target points and flips of the ICP check, drawn on
    the host so that the card and the CPU get the same ones."""
    from icp_proposal_tpu_torch.apps.femur_experiments import _batched_init_states
    from icp_proposal_tpu_torch.ops.surface_sampling import (
        sample_points_on_surface,
        seeded_vertex_subset,
    )

    gen = torch.Generator().manual_seed(seed)
    inits = _batched_init_states(model, n_inits, seed).coeffs.cpu()
    ids = torch.as_tensor(seeded_vertex_subset(model.num_points, model.num_points, seed),
                          dtype=torch.int64)
    tpts = sample_points_on_surface(target, model.num_points, generator=gen, device="cpu")
    flips = torch.rand((ICP_CHECK_ITERATIONS, n_inits), generator=gen) < 0.5
    flips[0, :2] = torch.tensor([True, False])  # both directions in the first iteration
    return inits, ids, tpts, flips


def phase_check_icp(torch, dev, data):
    """``ICP_CHECK_INITS`` inits × ``ICP_CHECK_ITERATIONS`` iterations of
    the deterministic ICP on the card and on the CPU plain twins, each
    iteration from the CPU's coefficients: on the same instance points the
    target faces (K3 shared + K4) and model vertices (K3 per chain) equal;
    through each side's own decode a correspondence may differ only by what
    the decodes' rounding shift explains; the coefficients within rtol 1e-4
    and atol 1e-4·max|α|; the fallbacks the same."""
    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.models.gpmm import instance_points
    from icp_proposal_tpu_torch.ops.closest_point import closest_point_on_triangle
    from icp_proposal_tpu_torch.ops.closest_point_cuda import nearest_vertices
    from icp_proposal_tpu_torch.ops.surface_index import closest_auto
    from icp_proposal_tpu_torch.registration.icp_fitting import icp_iteration
    from icp_proposal_tpu_torch.sampling.context import build_target_context

    tag = "check:icp"
    model = data.model
    cpu_model = convert.gpmm_from_arrays(**{k: getattr(model, k).cpu().numpy()
                                            for k in model.__dataclass_fields__},
                                         device="cpu")
    ctx = build_target_context(data.target, data.target_boundary_mask, device=dev)
    ix = ctx.index
    cpu_ctx = convert.context_from_arrays(ctx.points.cpu(), ctx.cells.cpu(), ctx.tri.cpu(),
                                          ctx.boundary.cpu(), ix.cand.cpu(), device="cpu")
    inits, ids, tpts, flips = _icp_inputs(torch, model, data.target, ICP_CHECK_INITS, 17)
    coeffs = inits
    worst = fallbacks = fallbacks_cpu = ties = max_shift = 0
    for it in range(ICP_CHECK_ITERATIONS):
        # the kernels on the same instance points as the twins: ids equal
        cur = instance_points(cpu_model, coeffs)
        tq = tpts.expand(ICP_CHECK_INITS, -1, -1).contiguous()
        _, _, fidx_c = closest_auto(cur[:, ids], cpu_ctx.points, cpu_ctx.cells, cpu_ctx.index)
        vid_c = nearest_vertices(tq, cur)
        cur_d = cur.to(dev)
        _, _, fidx = closest_auto(cur_d[:, ids.to(dev)], ctx.points, ctx.cells, ix)
        vid = nearest_vertices(tq.to(dev), cur_d)
        _sync(torch)
        if not (torch.equal(fidx.cpu(), fidx_c) and torch.equal(vid.cpu(), vid_c)):
            raise AssertionError(f"{tag}: r={model.rank} iteration {it}: correspondence ids "
                                 "on the same instance points differ from the twins'")
        # one whole iteration on each side
        step = icp_iteration(model, ctx, ids.to(dev), tpts.to(dev), coeffs.to(dev), 1e-30,
                             1.0, "model_and_target", flips[it].to(dev))
        step_c = icp_iteration(cpu_model, cpu_ctx, ids, tpts, coeffs, 1e-30, 1.0,
                               "model_and_target", flips[it])
        got = step.coeffs.cpu()
        fallbacks += int((~step.finite).sum())
        fallbacks_cpu += int((~step_c.finite).sum())
        if not torch.equal(step.finite.cpu(), step_c.finite):
            raise AssertionError(f"{tag}: r={model.rank} iteration {it}: the card fell back "
                                 f"on {fallbacks}, the CPU on {fallbacks_cpu} inits")
        # the card's decode rounds otherwise than the CPU's: a correspondence
        # may differ only where the two decodes' shift Δ explains it, i.e.
        # the card's pick is no farther from the CPU's query than the CPU's
        # pick plus 2Δ (distance is 1-Lipschitz), with 1e-5 relative rounding
        shift = (instance_points(model, coeffs.to(dev)).cpu() - cur).norm(dim=-1)  # [B, V]
        max_shift = max(max_shift, float(shift.max()))
        a, b = step.face_idx.cpu().long(), step_c.face_idx.long()
        bi, qi = torch.nonzero(a != b, as_tuple=True)
        q = cur[bi, ids[qi]]
        _, da = closest_point_on_triangle(q, *cpu_ctx.tri[a[bi, qi]].unbind(-2))
        _, db = closest_point_on_triangle(q, *cpu_ctx.tri[b[bi, qi]].unbind(-2))
        da, db = da.sqrt(), db.sqrt()
        if not (da - db <= 2 * shift[bi, ids[qi]] + 1e-5 * db + 1e-6).all():
            raise AssertionError(f"{tag}: a target face differs beyond the decodes' shift")
        ties += len(bi)
        a, b = step.vertex_ids.cpu().long(), step_c.vertex_ids.long()
        bi, qi = torch.nonzero(a != b, as_tuple=True)
        da = (tq[bi, qi] - cur[bi, a[bi, qi]]).norm(dim=-1)
        db = (tq[bi, qi] - cur[bi, b[bi, qi]]).norm(dim=-1)
        if not (da - db <= shift[bi, a[bi, qi]] + shift[bi, b[bi, qi]] + 1e-5 * db
                + 1e-6).all():
            raise AssertionError(f"{tag}: a model vertex differs beyond the decodes' shift")
        ties += len(bi)
        want = step_c.coeffs
        scale = float(want.abs().max())
        worst = max(worst, float(((got - want).abs() / (1e-4 * want.abs() + 1e-4 * scale))
                                 .max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
        coeffs = want
    print(f"[{tag}] r={model.rank}: {ICP_CHECK_INITS} inits x {ICP_CHECK_ITERATIONS} "
          f"iterations card vs CPU plain twins: ids on the same instance points equal; "
          f"{ties} of {2 * ICP_CHECK_INITS * ICP_CHECK_ITERATIONS * model.num_points} "
          f"correspondences of the whole iterations differ, each within the decodes' shift "
          f"(largest {max_shift:.3g} mm); coefficients' "
          f"largest difference {worst:.3g} of the tolerance (rtol 1e-4, atol "
          f"1e-4·max|α|); fallbacks card {fallbacks}, CPU {fallbacks_cpu}")


def phase_experiments(torch, dev, data):
    """``run_std_icp_vs_chain_comparison`` on the GPMM-200, one target,
    ``EXP_INITS`` inits × ``EXP_SAMPLES`` samples with Dice: each stage
    timed with its launches (asserted), the ICP batch's peak memory, the
    per-method metrics and the log read back → counts."""
    import tempfile

    import numpy as np

    from icp_proposal_tpu_torch.apps import femur_experiments as fe
    from icp_proposal_tpu_torch.io.experiment_log import ExperimentLogger

    tag = "main:experiments"
    model = data.model
    stages = []

    def timed(stage, fn):
        def run(*args, **kw):
            _sync(torch)
            before = _read_counts()
            if stage == "icp":
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
            t = time.perf_counter()
            out = fn(*args, **kw)
            _sync(torch)
            rec = dict(stage=stage, seconds=time.perf_counter() - t,
                       launches=_delta(_read_counts(), before))
            if stage == "icp":
                rec.update(peak=torch.cuda.max_memory_allocated(dev), base=base,
                           nonfinite=out[1].cpu())
            if stage == "mh":
                rec.update(stage=f"mh:{type(args[2].specs[0]).__name__}",
                           chains=args[3].coeffs.shape[0], steps=args[4],
                           acceptance=float(np.mean(out.accepted)))
            stages.append(rec)
            return out
        return run

    names = {"_icp_batch": "icp", "_run_batch": "mh", "_distance_measures": "metrics"}
    saved = {name: getattr(fe, name) for name in names}
    try:
        for name, stage in names.items():
            setattr(fe, name, timed(stage, saved[name]))
        with tempfile.TemporaryDirectory() as tmp:
            log_path = str(Path(tmp) / "experiments.json")
            _reset_counts()
            t = time.perf_counter()
            logger = fe.run_std_icp_vs_chain_comparison(
                model, [data.target], ["map.stl"], data.model_boundary_mask, log_path,
                n_inits=EXP_INITS, n_samples=EXP_SAMPLES, verbose=False, compute_dice=True)
            _sync(torch)
            dt = time.perf_counter() - t
            launches = _read_counts()
            records = ExperimentLogger(log_path).load_log()
    finally:
        for name, fn in saved.items():
            setattr(fe, name, fn)
    print(f"[{tag}] run_std_icp_vs_chain_comparison on the stand-in GPMM-200 (rank "
          f"{model.rank}), one target, {EXP_INITS} inits x {EXP_SAMPLES} samples, Dice on: "
          f"{dt:.3f} s; launches {launches}")
    _check_launches(tag, launches, CONTEXT_LAUNCHES, 1)  # the one target's context
    metrics = [r for r in stages if r["stage"] == "metrics"]
    by_stage = [r for r in stages if r["stage"] != "metrics"] + [dict(
        stage="metrics", seconds=sum(r["seconds"] for r in metrics),
        launches={k: sum(r["launches"][k] for r in metrics) for k in launches})]
    for rec in by_stage:
        extra = ""
        if rec["stage"] == "icp":
            extra = (f"; peak allocated {rec['peak'] / 2 ** 30:.3f} GiB ({rec['base'] / 2 ** 30:.3f} "
                     f"GiB before the batch); {int((rec['nonfinite'] > 0).sum())} of {EXP_INITS} "
                     f"inits kept their coefficients on {int(rec['nonfinite'].sum())} "
                     f"non-finite iterations; {1e3 * rec['seconds'] / ICP_ITERATIONS:.3f} "
                     "ms/iteration")
        if rec["stage"].startswith("mh"):
            extra = (f"; {rec['chains']} chains x {rec['steps']} steps, "
                     f"{rec['chains'] * rec['steps'] / rec['seconds']:.1f} samples/s, "
                     f"{1e3 * rec['seconds'] / rec['steps']:.3f} ms/step (initial carry and "
                     f"record drain included), acceptance {rec['acceptance']:.4f}")
        print(f"[{tag}] stage {rec['stage']}: {rec['seconds']:.3f} s; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }{extra}")
    want = {"icp": _scaled(ICP_ITER_LAUNCHES_BLOCKED, ICP_ITERATIONS),
            "mh:IndependentPointsSpec": _scaled(EXP_EUCLID_STEP, EXP_SAMPLES,
                                                EXP_EUCLID_INIT),
            "mh:HausdorffSpec": _scaled(EXP_HAUSDORFF_STEP, EXP_SAMPLES,
                                        EXP_HAUSDORFF_INIT),
            "metrics": _scaled(EXP_METRIC_LAUNCHES, 3 * EXP_INITS)}
    for rec in by_stage:
        _check_counts(f"{tag} stage {rec['stage']}", rec["launches"], want[rec["stage"]])
    if len(records) != EXP_INITS or any(list(r) != EXP_LOG_KEYS for r in records):
        raise AssertionError(f"{tag}: the log must hold {EXP_INITS} records in the "
                             "reference's schema")
    for key in ("icp", "samplingEuclidean", "samplingHausdorff"):
        vals = {m: [r[key][m] for r in records] for m in ("avg", "hausdorff", "dice")}
        if not all(np.isfinite(v).all() for v in vals.values()):
            raise AssertionError(f"{tag}: non-finite {key} metrics")
        print(f"[{tag}] {key}: mean avg {np.mean(vals['avg']):.4f} mm, Hausdorff "
              f"{np.mean(vals['hausdorff']):.4f} mm, Dice {np.mean(vals['dice']):.4f} over "
              f"{EXP_INITS} inits")
    print(f"[{tag}] experiment log: {len(records)} records read back, keys as the "
          f"reference's; {len(logger.experiments)} in the logger")
    return launches


def phase_random_init(torch, dev, data):
    """``run_random_init_comparison`` on the GPMM-100 with ``RI_INITS`` inits
    at full-resolution point counts → counts; then each method's acceptance
    and the inits' own distances, which a chain that accepted nothing keeps
    as its best state."""
    import numpy as np

    from icp_proposal_tpu_torch.apps import femur_experiments as fe
    from icp_proposal_tpu_torch.ops.metrics import avg_distance, hausdorff_distance
    from icp_proposal_tpu_torch.sampling.state import transformed_mesh

    tag = "main:random-init"
    model = data.model
    accepted = []
    run_batch = fe._run_batch

    def counted(*args, **kw):
        out = run_batch(*args, **kw)
        accepted.append(np.asarray(out.accepted))  # [C, T]
        return out

    fe._run_batch = counted
    try:
        _reset_counts()
        t = time.perf_counter()
        results = fe.run_random_init_comparison(
            model, data.target, data.model_boundary_mask, data.target_boundary_mask,
            n_inits=RI_INITS, n_icp_samples=RI_ICP_SAMPLES, rnd_multiplier=RI_MULTIPLIER,
            verbose=False)
        _sync(torch)
        dt = time.perf_counter() - t
        launches = _read_counts()
    finally:
        fe._run_batch = run_batch
    n_rnd = RI_ICP_SAMPLES * RI_MULTIPLIER
    print(f"[{tag}] run_random_init_comparison on the stand-in GPMM-100 (rank "
          f"{model.rank}): {RI_INITS} inits, {model.num_points} ICP and evaluation points, "
          f"{RI_ICP_SAMPLES} ICP and {n_rnd} random-walk samples: {dt:.3f} s; launches "
          f"{launches}")
    want = _scaled(RI_ICP_STEP, RI_ICP_SAMPLES, RI_ICP_INIT)
    for name, n in _scaled(RI_RND_STEP, n_rnd + 1,
                           {"surface_distances[shared]": 3 * 2 * RI_INITS,
                            **CONTEXT_LAUNCHES}).items():
        want[name] = want.get(name, 0) + n
    _check_counts(tag, launches, want)
    inits = fe._batched_init_states(model, RI_INITS, fe._fold_in(1024, 0))
    at_init = [(float(avg_distance(m, data.target)), float(hausdorff_distance(m, data.target)))
               for m in (transformed_mesh(model, inits, chain=i) for i in range(RI_INITS))]
    print(f"[{tag}] the inits themselves: mean avg {np.mean([a for a, _ in at_init]):.4f} mm, "
          f"Hausdorff {np.mean([h for _, h in at_init]):.4f} mm")
    for method, acc in zip(("icp", "rnd"), accepted):
        rows = [r for r in results if r["method"] == method]
        avg, hd = np.mean([r["avg"] for r in rows]), np.mean([r["hausdorff"] for r in rows])
        if not (np.isfinite(avg) and np.isfinite(hd)):
            raise AssertionError(f"{tag}: non-finite {method} metrics")
        print(f"[{tag}] {method}: mean avg {avg:.4f} mm, Hausdorff {hd:.4f} mm over "
              f"{len(rows)} inits; accepted steps per chain {acc.sum(axis=1).tolist()} of "
              f"{acc.shape[1]}")
    return launches


def _within(tag, what, got, want, rtol=1e-5, rel_atol=1e-4):
    """|got − want| ≤ rtol·|want| + rel_atol·max|want| elementwise (host
    arrays), else raise → the largest difference."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{tag}: {what} shape {got.shape}, expected {want.shape}")
    atol = rel_atol * max(float(np.abs(want).max()), 1e-12)
    diff = np.abs(got - want)
    if not np.all(diff <= atol + rtol * np.abs(want)):
        raise AssertionError(f"{tag}: {what} differs by up to {diff.max():.3g} "
                             f"(atol {atol:.3g}, rtol {rtol:g})")
    return float(diff.max())


def _landmark_ids(points, nose=False):
    """Six well-spread vertex ids: the extremes along x, y and z (the
    highest z first, the face's nose tip)."""
    import numpy as np

    ids = [int(np.argmax(points[:, 2])), int(np.argmin(points[:, 2])),
           int(np.argmax(points[:, 0])), int(np.argmin(points[:, 0])),
           int(np.argmax(points[:, 1])), int(np.argmin(points[:, 1]))]
    names = ["center.nose.tip" if nose else "z-max", "z-min", "x-max", "x-min", "y-max",
             "y-min"]
    return dict(zip(names, ids))


def _rigid(angle, axis, shift):
    """A rotation by ``angle`` about ``axis`` (Rodrigues) and a shift →
    (R [3, 3], t [3]) in float64."""
    import numpy as np

    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    r = np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx
    return r, np.asarray(shift, np.float64)


def _write_binary_ply(path, points, cells):
    """A binary little-endian PLY (float x/y/z, uchar count + int indices),
    as BFM scans come."""
    import numpy as np

    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(cells)}\nproperty list uchar int vertex_indices\n"
            "end_header\n")
    faces = np.zeros(len(cells), np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
    faces["n"], faces["v"] = 3, cells
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        f.write(np.asarray(points, "<f4").tobytes())
        f.write(faces.tobytes())


def phase_femur_pipeline(torch, dev, data, smi):
    """The femur user pipeline at full width, files under a temporary
    directory: ``align_shapes`` on a moved copy of the stand-in target and
    its landmarks; ``create_gp_model femur`` (GPMM-100) from the stand-in's
    mean mesh; ``load_femur_data(100, data_dir=…)``; the registration entry
    point (flagship, ``N_CHAINS`` chains × ``PIPE_SAMPLES`` samples, chain
    0's JSON log); ``apps.replay`` ``replay`` and ``posterior`` at the JAX
    CLI's defaults.  Launch counts asserted over the whole pipeline; the
    decode of the replayed states and the maps timed on their own →
    (counts, the model read back, chain 0's records)."""
    import tempfile

    import numpy as np

    from icp_proposal_tpu_torch.analysis.posterior_variability import (
        variability_map_normal,
        variability_map_total,
    )
    from icp_proposal_tpu_torch.analysis.replay import replay_states
    from icp_proposal_tpu_torch.apps import create_gp_model, replay
    from icp_proposal_tpu_torch.apps.align_shapes import align_shapes
    from icp_proposal_tpu_torch.apps.femur import (
        STANDIN_DIR,
        load_femur_data,
        run_icp_proposal_registration,
    )
    from icp_proposal_tpu_torch.io.landmarks import write_landmarks
    from icp_proposal_tpu_torch.io.stl import write_stl
    from icp_proposal_tpu_torch.sampling import loggers
    from icp_proposal_tpu_torch.sampling.mh import stack_states
    from icp_proposal_tpu_torch.sampling.state import transformed_points

    tag = "main:femur-pipeline"
    tpoints, tcells = data.target
    lm_ids = _landmark_ids(tpoints)
    r, t = _rigid(0.4, (1.0, -2.0, 0.5), (30.0, -12.0, 7.5))
    moved = (tpoints.astype(np.float64) @ r.T + t).astype(np.float32)
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("scans", "scan_landmarks", "femur", "replay", "posterior"):
            (tmp / sub).mkdir()
        write_stl(tmp / "scans" / "femur_target.stl", moved, tcells)
        write_landmarks(tmp / "scan_landmarks" / "femur_target.json",
                        {n: moved[i].astype(np.float64) for n, i in lm_ids.items()})
        # the stand-in's target sits in the model frame: its landmarks there
        # are the model's
        model_lms = {n: tpoints[i].astype(np.float64) for n, i in lm_ids.items()}
        write_landmarks(tmp / "femur" / "femur_reference.json", model_lms)
        _sync(torch)
        _reset_counts()
        t0 = time.perf_counter()
        n = align_shapes(str(tmp / "scans"), str(tmp / "scan_landmarks"),
                         str(tmp / "femur" / "femur_reference.json"), str(tmp / "aligned"),
                         verbose=False)
        for name in ("meshes/femur_target.stl", "landmarks/femur_target.json"):
            (tmp / "aligned" / name).replace(tmp / "femur" / Path(name).name)
        secs["align_shapes"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        create_gp_model.main(["femur", "--reference", str(STANDIN_DIR / "mean.stl"),
                              "--components", "100", "--out-dir", str(tmp / "femur"),
                              "--device", str(dev)])
        _sync(torch)
        secs["create_gp_model femur"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fdata = load_femur_data(100, data_dir=str(tmp / "femur"), device=dev)
        _sync(torch)
        secs["load_femur_data"] = time.perf_counter() - t0
        log = tmp / "chain0.json"
        t0 = time.perf_counter()
        result, _ = run_icp_proposal_registration(
            num_samples=PIPE_SAMPLES, n_chains=N_CHAINS, json_path=str(log), seed=9,
            verbose=False, setup="flagship", data=fdata, device=dev)
        _sync(torch)
        secs["registration"] = time.perf_counter() - t0
        common = ["--components", "100", "--data-dir", str(tmp / "femur"), "--device",
                  str(dev)]
        t0 = time.perf_counter()
        replay.main(["replay", str(log), "--out-dir", str(tmp / "replay"), *common])
        secs["replay CLI"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        replay.main(["posterior", str(log), "--out-dir", str(tmp / "posterior"), *common])
        _sync(torch)
        secs["posterior CLI"] = time.perf_counter() - t0
        launches = _read_counts()
        records = loggers.load_log(log)
        snapshots = sorted((tmp / "replay").iterdir())
        artifacts = sorted(p.name for p in (tmp / "posterior").iterdir())

    print(f"[{tag}] align_shapes {n} mesh, create_gp_model femur, load_femur_data, "
          f"registration, replay, posterior: " + ", ".join(
              f"{k} {v:.3f} s" for k, v in secs.items()) + f"; nvidia-smi: {smi}")
    model = fdata.model
    print(f"[{tag}] model read back: rank {model.rank}, {model.num_points} vertices, "
          f"{model.cells.shape[0]} faces; registration {N_CHAINS} chains x "
          f"{PIPE_SAMPLES} samples: FittingResult.samples_per_sec "
          f"{result.samples_per_sec:.1f}, acceptance {result.acceptance['overall']:.4f}; "
          f"launches {launches}")
    _check_launches(tag, launches, FEMUR_STEP_LAUNCHES, PIPE_SAMPLES, PIPE_RUN_LAUNCHES)
    if (model.rank, model.num_points, model.cells.shape[0]) != (101, 1622, 3240):
        raise AssertionError(f"{tag}: the GPMM-100 read back has the wrong width")
    for name in ("ref_points", "cells", "basis", "variance"):
        if not torch.equal(getattr(model, name), getattr(data.model, name)):
            raise AssertionError(f"{tag}: the model read back differs from the stand-in "
                                 f"GPMM-100 in {name}")
    shift = _within(tag, "the aligned target", fdata.target.points, tpoints, rtol=0,
                    rel_atol=1e-6)
    if not np.array_equal(fdata.target.cells, tcells):
        raise AssertionError(f"{tag}: the aligned target's cells differ")
    states = replay_states(records, REPLAY_STRIDE, device=dev)
    if (len(records) != PIPE_SAMPLES or len(snapshots) != min(REPLAY_SNAPSHOTS, len(states))
            or artifacts != ["map.stl", "mean.stl", "variability_normal.ply",
                             "variability_total.ply"]):
        raise AssertionError(f"{tag}: log {len(records)} records, {len(snapshots)} "
                             f"snapshots, posterior files {artifacts}")
    print(f"[{tag}] aligned target within {shift:.3g} mm of the stand-in's; the model read "
          f"back equals the stand-in GPMM-100 (points, cells, basis, variance); log "
          f"{len(records)} records; {len(snapshots)} replay snapshots of {len(states)} "
          f"states; posterior files {artifacts}")

    # the decode of the replayed states and the maps, on the card, timed
    thinned = [loggers.sample_to_state(rec, dev) for rec in loggers.samples_from_log(
        records, take_every_n=POST_TAKE_EVERY, burn_in=POST_BURN_IN)]
    batch, post = stack_states(states), stack_states(thinned)
    _sync(torch)
    t0 = time.perf_counter()
    pts = transformed_points(model, batch)
    _sync(torch)
    decode_ms = 1e3 * (time.perf_counter() - t0)
    sample_points = transformed_points(model, post)
    _sync(torch)
    t0 = time.perf_counter()
    total = variability_map_total(sample_points)
    normal = variability_map_normal(sample_points, model.cells)
    _sync(torch)
    maps_ms = 1e3 * (time.perf_counter() - t0)
    if not (torch.isfinite(pts).all() and torch.isfinite(total).all()
            and torch.isfinite(normal).all() and bool((normal <= total + 1e-5).all())):
        raise AssertionError(f"{tag}: non-finite replay points or maps")
    print(f"[{tag}] decode of {len(states)} replayed states [{len(states)}, "
          f"{model.num_points}, 3] in one call {decode_ms:.3f} ms; variability maps over "
          f"{len(thinned)} posterior samples {maps_ms:.3f} ms (total up to "
          f"{float(total.max()):.4f} mm², normal up to {float(normal.max()):.4f}); "
          f"nvidia-smi: {smi}")
    return launches, model, records


def phase_check_replay(torch, dev, model, records):
    """``replay_meshes`` and ``posterior_analysis`` from the same log on the
    card and on the CPU: the same number of states; points and maps within
    rtol 1e-5 and atol 1e-4 of their largest magnitude."""
    from icp_proposal_tpu_torch.analysis.replay import posterior_analysis, replay_meshes
    from icp_proposal_tpu_torch.convert import gpmm_from_arrays

    tag = "check:replay"
    cpu_model = gpmm_from_arrays(**{k: getattr(model, k).cpu().numpy()
                                    for k in model.__dataclass_fields__}, device="cpu")
    got, want = replay_meshes(model, records), replay_meshes(cpu_model, records)
    if len(got) != len(want) or not got:
        raise AssertionError(f"{tag}: {len(got)} replayed meshes, {len(want)} on the CPU")
    worst = {"replay points": _within(tag, "replay points", got, want)}
    post, post_c = posterior_analysis(model, records), posterior_analysis(cpu_model, records)
    if post["num_samples"] != post_c["num_samples"]:
        raise AssertionError(f"{tag}: posterior sample counts differ")
    for key in ("map_points", "mean_points", "variability_total", "variability_normal"):
        worst[key] = _within(tag, key, post[key], post_c[key])
    print(f"[{tag}] card vs CPU from the same log: {len(got)} replayed meshes, "
          f"{post['num_samples']} posterior samples; largest differences " + ", ".join(
              f"{k} {v:.3g}" for k, v in worst.items()) + " (held rtol 1e-5 + atol 1e-4 of "
          "the largest magnitude)")


def phase_face_pipeline(torch, dev, face, smi):
    """The face user pipeline, files under a temporary directory:
    ``prepare_bfm_dataset`` on ``FACE_SCANS`` binary-PLY scans of the face
    stand-in's target (×1,000, moved rigidly, landmarks with
    ``center.nose.tip``); ``create_gp_model face`` at the reference's
    defaults (decimate to 2,000, 800 sample points, 200 components) on the
    open patch of subdivision ``FACE_REF_SUBDIV``; ``load_bfm_data``;
    ``run_bfm_fitting(partial=True)`` at ``N_CHAINS`` chains ×
    ``BFM_FIT_STEPS`` steps.  Launch counts asserted over the pipeline →
    counts."""
    import tempfile

    import numpy as np

    from icp_proposal_tpu_torch.apps import create_gp_model
    from icp_proposal_tpu_torch.apps.bfm import (
        load_bfm_data,
        prepare_bfm_dataset,
        run_bfm_fitting,
    )
    from icp_proposal_tpu_torch.io.landmarks import write_landmarks
    from icp_proposal_tpu_torch.io.stl import write_stl
    from icp_proposal_tpu_torch.models.synthetic import make_open_patch

    tag = "main:face-pipeline"
    tpoints, tcells = face.target
    lm_ids = _landmark_ids(tpoints, nose=True)
    ref_points, ref_cells = make_open_patch(FACE_REF_SUBDIV, radius=0.1, z_cut=0.55)
    n_cut = len(tpoints) // 6  # the stand-in's own occlusion size
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("scans", "scan_landmarks", "bfm"):
            (tmp / sub).mkdir()
        for k in range(FACE_SCANS):
            r, t = _rigid(0.3 + 0.2 * k, (0.5, 1.0, -1.0 + k), (0.02 * (k + 1), -0.01, 0.03))
            moved = (tpoints.astype(np.float64) @ r.T + t) * 1000.0
            _write_binary_ply(tmp / "scans" / f"subject{k}.ply", moved, tcells)
            write_landmarks(tmp / "scan_landmarks" / f"subject{k}.json",
                            {n: moved[i] for n, i in lm_ids.items()})
        write_landmarks(tmp / "bfm" / "bfm.json",
                        {n: tpoints[i].astype(np.float64) for n, i in lm_ids.items()})
        write_stl(tmp / "face_reference.stl", ref_points, ref_cells)
        _sync(torch)
        _reset_counts()
        t0 = time.perf_counter()
        n = prepare_bfm_dataset(str(tmp / "scans"), str(tmp / "scan_landmarks"),
                                str(tmp / "bfm" / "bfm.json"), str(tmp / "bfm"),
                                n_nose_cut=n_cut, verbose=False)
        secs["prepare_bfm_dataset"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        create_gp_model.main(["face", "--reference", str(tmp / "face_reference.stl"),
                              "--out", str(tmp / "bfm" / "faceGPmodel_200c.h5"),
                              "--device", str(dev)])
        _sync(torch)
        secs["create_gp_model face"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bfm = load_bfm_data(str(tmp / "bfm"), device=dev)
        _sync(torch)
        secs["load_bfm_data"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result, _ = run_bfm_fitting(bfm, partial=True, num_samples=BFM_FIT_STEPS,
                                    n_chains=N_CHAINS, json_path=str(tmp / "bfm_log.json"),
                                    seed=5, verbose=False)
        _sync(torch)
        secs["run_bfm_fitting"] = time.perf_counter() - t0
        launches = _read_counts()
        partial = sorted(p.name for p in (tmp / "bfm" / "partial" / "meshes").iterdir())

    model = bfm.model
    print(f"[{tag}] prepare_bfm_dataset {n} scans, create_gp_model face, load_bfm_data, "
          f"run_bfm_fitting: " + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
          + f"; nvidia-smi: {smi}")
    print(f"[{tag}] reference {len(ref_points)} vertices decimated to {model.num_points}, "
          f"{model.cells.shape[0]} faces, rank {model.rank}; partial target "
          f"{len(bfm.target_partial.points)} of {len(bfm.target.points)} vertices; "
          f"run_bfm_fitting(partial=True) {N_CHAINS} chains x {BFM_FIT_STEPS} steps: "
          f"FittingResult.samples_per_sec {result.samples_per_sec:.1f}, acceptance "
          f"{result.acceptance['overall']:.4f}; launches {launches}")
    _check_launches(tag, launches, BFM_STEP_LAUNCHES, BFM_FIT_STEPS, FACE_FIT_RUN_LAUNCHES)
    if ((model.num_points, model.rank) != (min(FACE_DECIMATE_TO, len(ref_points)), FACE_RANK)
            or n != FACE_SCANS or len(partial) != n):
        raise AssertionError(f"{tag}: model {model.num_points} vertices rank {model.rank}, "
                             f"{n} scans prepared, partial meshes {partial}")
    # the STL reader numbers vertices by first appearance: compare corners
    shift = _within(tag, "the aligned scan", bfm.target.points[bfm.target.cells],
                    tpoints[tcells], rtol=0, rel_atol=1e-5)
    if not (result.best_log_value > -float("inf")
            and torch.isfinite(result.final_states.coeffs).all()):
        raise AssertionError(f"{tag}: non-finite result")
    print(f"[{tag}] aligned scan within {shift:.3g} of the stand-in's target; best log "
          f"value {result.best_log_value:.4f}")
    return launches


def phase_config(torch, dev, data, smi):
    """``build_from_config(RunConfig(), …)`` on the stand-in GPMM-100 at
    ``N_CHAINS`` chains, timed like ``[main]`` → (counts, setup)."""
    from icp_proposal_tpu_torch.utils.config import RunConfig, build_from_config

    t0 = time.perf_counter()
    setup = build_from_config(RunConfig(), data.model, data.target,
                              data.model_boundary_mask, data.target_boundary_mask)
    _sync(torch)
    print(f"[main:config] build_from_config(RunConfig()) on the stand-in GPMM-100: "
          f"{setup[1].names}; {time.perf_counter() - t0:.1f} s; nvidia-smi: {smi}")
    _, mixture, evaluator = setup
    launches = phase_main(torch, dev, "main:config", data.model, mixture, evaluator,
                          WARMUP_STEPS, TIMED_STEPS, CONFIG_STEP_LAUNCHES)
    return launches, setup


def _leaves(torch, x):
    """The tensors of a carry (nested named tuples), in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in _leaves(torch, y)]
    if x is None:
        return []
    raise TypeError(f"unexpected carry leaf {type(x).__name__}")


def phase_check_config(torch, dev, data, setup):
    """The config-built step against the flagship recipe written by hand:
    the same mixture names, weights and specs and the same evaluator specs
    as ``make_icp_proposal_setup``; the hand-written mixture observes the
    same seeded ICP subsets (the hand-built setup's own slice of the
    evaluator's points would change the proposals), each mixture's ICP
    model ids lie in its evaluator's subset, and the fusion plan serves
    every model-direction ICP component from the evaluator's query pass
    on both sides; then 32 chains × 3 steps, each side from its own carry
    with the same noise: every decision and every tensor of the carry
    (state, log posterior, named values, ICP factors) identical."""
    import dataclasses as dc

    import numpy as np

    from icp_proposal_tpu_torch.apps.femur import make_icp_proposal_setup
    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.proposals import (
        IcpComponent,
        MixtureProgram,
        mixed_proposal_icp,
        mixed_random_shape_proposal,
        nest,
    )
    from icp_proposal_tpu_torch.sampling.state import init_state

    tag = "check:config"
    model = data.model
    _, mixture, evaluator = setup
    ctx_h, flag_mix, flag_ev = make_icp_proposal_setup(data)

    def rows(specs):
        return [(type(x).__name__, dc.asdict(x)) for x in specs]

    if (mixture.names != flag_mix.names or mixture.weights != flag_mix.weights
            or rows(mixture.specs) != rows(flag_mix.specs)
            or rows(evaluator.specs) != rows(flag_ev.specs)
            or evaluator.named_keys != flag_ev.named_keys):
        raise AssertionError(f"{tag}: RunConfig() does not build the flagship recipe")
    hand = MixtureProgram(
        nest((0.9, mixed_proposal_icp(n_points=2 * model.rank,
                                      projection_direction="model_and_target",
                                      tangential_noise=10.0, noise_along_normal=5.0,
                                      step_length=0.1)),
             (0.1, mixed_random_shape_proposal())),
        model, ctx_h, data.model_boundary_mask)

    def icp_ids(mix):
        return {i: c.model_ids for i, c in mix.icp_components.items()
                if isinstance(c, IcpComponent) and c.spec.direction == "model"}

    ids_c, ids_h = icp_ids(mixture), icp_ids(hand)
    if not ids_c or sorted(ids_c) != sorted(ids_h) or any(
            not np.array_equal(ids_c[i], ids_h[i]) for i in ids_c):
        raise AssertionError(f"{tag}: the ICP components observe other model vertices")
    for side, mix, ev, ids in (("config", mixture, evaluator, ids_c),
                               ("hand", hand, flag_ev, ids_h)):
        plan = mh._fusion_plan(mix, ev)
        eval_ids = set(np.asarray(ev.model_ids(plan.spec_name)).tolist()) if plan else set()
        if plan is None or sorted(plan.icp_maps) != sorted(ids) or any(
                not set(v.tolist()) <= eval_ids for v in ids.values()):
            raise AssertionError(f"{tag}: the {side} mixture's ICP ids are not served by "
                                 "its evaluator's query pass")
    steps = {name: mh.make_mh_step(model, mix, ev, store_params=True)
             for name, (mix, ev) in (("config", (mixture, evaluator)),
                                     ("hand", (hand, flag_ev)))}
    gen = torch.Generator(device=dev).manual_seed(21)
    carry = mh.init_carry(model, evaluator, init_state(model, 32), mixture)
    hand_carry = mh.init_carry(model, flag_ev, init_state(model, 32), hand)
    accepted, n_leaves = 0, 0
    for step in range(4):
        got, want = _leaves(torch, carry), _leaves(torch, hand_carry)
        if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{tag}: the carries differ after {step} steps")
        n_leaves = len(got)
        if step == 3:
            break
        noise = mh.draw_noise(mixture, 32, gen)
        carry, rec = steps["config"](carry, noise)
        hand_carry, rec_h = steps["hand"](hand_carry, noise)
        if not torch.equal(rec.accepted, rec_h.accepted):
            raise AssertionError(f"{tag}: the config-built step decides otherwise than "
                                 "the hand-built flagship recipe")
        accepted += int(rec.accepted.sum())
    print(f"[{tag}] RunConfig() builds the flagship recipe (names, weights, specs, "
          f"evaluator); the same {sum(len(v) for v in ids_c.values())} ICP model ids "
          f"on both sides, all in the evaluator's subset and fused; 32 chains x 3 steps, "
          f"each from its own carry: 96 decisions identical ({accepted} accepts), all "
          f"{n_leaves} carry tensors equal bitwise after every step")


def phase_pod(torch, dev, data, setup):
    """``apps.pod_chains`` at its defaults in this process (``POD_CHAINS``
    chains x ``POD_STEPS`` steps, stand-in GPMM-100, flagship, records kept,
    ``--out`` read back); launches asserted over the whole call; then, from
    the same inits in the same process, the bare flagship step
    (store_params=False) and the runner with records and pooling in turns →
    counts."""
    from icp_proposal_tpu_torch.apps import pod_chains
    from icp_proposal_tpu_torch.apps.femur_experiments import _batched_init_states
    from icp_proposal_tpu_torch.parallel.runner import make_chain_mesh, run_sharded_chains
    from icp_proposal_tpu_torch.sampling import mh

    tag = "main:pod"
    BUILD.mkdir(exist_ok=True)
    out_path = BUILD / "pod_chains.json"
    _reset_counts()
    t = time.perf_counter()
    out = pod_chains.main(["--chains", str(POD_CHAINS), "--steps", str(POD_STEPS),
                           "--out", str(out_path), "--device", str(dev)])
    _sync(torch)
    wall = time.perf_counter() - t
    launches = _read_counts()
    sps = out["samples_per_sec"]
    print(f"[{tag}] pod_chains: {out['chains']} chains x {out['steps']} steps, GPMM-"
          f"{out['components']} {out['setup']}, {out['devices']} device: {sps:.1f} samples/s "
          f"({1e3 * out['chains'] / sps:.3f} ms/step with records and pooling); the whole "
          f"call {wall:.1f} s (stand-in build, setup and initial carry included); pooled "
          f"acceptance {out['pooled_acceptance']:.4f}, max split-R-hat (first 8) "
          f"{out['rhat_max_first8']:.4f}, ESS(coeff 0) {out['ess_coeff0']:.1f}, "
          f"diagnostics_via {out['diagnostics_via']}; launches {launches}")
    _check_launches(tag, launches, FEMUR_STEP_LAUNCHES, POD_STEPS, POD_RUN_LAUNCHES)
    if json.loads(out_path.read_text()) != out:
        raise AssertionError(f"{tag}: --out does not hold the printed result")
    if not (0.0 < out["pooled_acceptance"] < 1.0 and out["rhat_max_first8"] > 0
            and out["ess_coeff0"] > 0 and out["diagnostics_via"] == "single_device_fast_path"):
        raise AssertionError(f"{tag}: degenerate pooled diagnostics {out}")

    # in turns, from the pod run's inits: the bare step (mh.run_chains,
    # store_params=False), the runner with records and pooling, the runner,
    # the bare step, POD_BARE_STEPS steps each after one warm-up of each
    _, mixture, evaluator = setup
    bare_step = mh.make_mh_step(data.model, mixture, evaluator)
    rec_step = mh.make_mh_step(data.model, mixture, evaluator, store_params=True)
    carry0 = mh.init_carry(data.model, evaluator,
                           _batched_init_states(data.model, POD_CHAINS, 1024), mixture)
    mesh = make_chain_mesh([dev])
    runs = {
        "bare": lambda n: mh.run_chains(bare_step, carry0, n,
                                        torch.Generator(device=dev).manual_seed(0)),
        "runner": lambda n: run_sharded_chains(rec_step, carry0, 0, n, mesh,
                                               burn_in=n // 5)[2].acceptance.item(),
    }
    for run in runs.values():
        run(POD_BARE_WARMUP)
    _sync(torch)
    ms = {"bare": [], "runner": []}
    for name in ("bare", "runner", "runner", "bare"):
        t = time.perf_counter()
        runs[name](POD_BARE_STEPS)
        _sync(torch)
        ms[name].append(1e3 * (time.perf_counter() - t) / POD_BARE_STEPS)
    bare = POD_CHAINS / (sum(ms["bare"]) / 2e3)
    print(f"[{tag}] in turns at {POD_CHAINS} chains, {POD_BARE_STEPS} steps each: the bare "
          f"step (store_params=False) {', '.join(f'{x:.3f}' for x in ms['bare'])} ms/step "
          f"({bare:.1f} samples/s); the runner with records and pooling "
          f"{', '.join(f'{x:.3f}' for x in ms['runner'])} ms/step: records and pooling add "
          f"{100 * (sum(ms['runner']) / sum(ms['bare']) - 1):.1f} %; the pod run / bare step "
          f"{sps / bare:.4f} (its first steps in the process included)")
    return launches


def _pod_run(torch, dev, setup, world=1):
    """``POD_CHECK_CHAINS`` x ``POD_CHECK_STEPS`` flagship chains through
    ``run_sharded_chains`` over the current process group (none: this
    process alone), this rank's share → (records, final carry, stats)."""
    from icp_proposal_tpu_torch.apps.femur_experiments import _batched_init_states, _fold_in
    from icp_proposal_tpu_torch.parallel.runner import make_chain_mesh, run_sharded_chains
    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.state import FitState

    _, mixture, evaluator = setup
    model = mixture.gpmm
    mesh = make_chain_mesh([dev] * world)
    states = _batched_init_states(model, POD_CHECK_CHAINS, POD_CHECK_SEED)
    carries = mh.init_carry(model, evaluator,
                            FitState(*(x[mesh.chain_rows(POD_CHECK_CHAINS)] for x in states)),
                            mixture)
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    final, records, stats = run_sharded_chains(
        step, carries, _fold_in(POD_CHECK_SEED, 7), POD_CHECK_STEPS, mesh,
        burn_in=POD_CHECK_STEPS // 5)
    return records, final, stats


def pod_check_rank(rank, world, init, out, device):
    """One rank of [check:pod] (c): a gloo rank on ``device`` (both ranks on
    the one card), the stand-in GPMM-100 flagship built anew; saves this
    rank's decisions, log α, coefficient trace and the pooled stats."""
    import torch
    import torch.distributed as dist

    from icp_proposal_tpu_torch.apps.femur import (
        load_standin_femur_data,
        make_icp_proposal_setup,
    )
    from icp_proposal_tpu_torch.parallel.distributed import COLLECTIVE_TIMEOUT

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, world_size=int(world), rank=int(rank),
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        setup = make_icp_proposal_setup(load_standin_femur_data(device=dev))
        records, final, stats = _pod_run(torch, dev, setup, int(world))
        torch.save({"accepted": records.accepted.cpu(), "log_alpha": records.log_alpha.cpu(),
                    "coeffs": records.coeffs.cpu(), "final_coeffs": final.state.coeffs.cpu(),
                    "stats": {k: v.cpu() for k, v in stats._asdict().items()}}, out)
    finally:
        dist.destroy_process_group()


def _stats_within(torch, tag, what, got, want, tol):
    """Every field of the pooled stats ``got`` (a dict) against ``want``
    (``PooledStats``): |got − want| ≤ tol · (|want| + the field's largest
    |want|), so entries near zero are held to the field's scale →
    the largest |got − want| / max|want| over the fields."""
    worst = 0.0
    for name, x in want._asdict().items():
        x, y = x.cpu(), got[name].cpu()
        scale = float(x.abs().max())
        if not bool(((y - x).abs() <= tol * (x.abs() + scale)).all()):
            raise AssertionError(f"{tag}: {what}: pooled {name} {y} against {x} "
                                 f"(tol {tol} of |x| + max|x|)")
        worst = max(worst, float((y - x).abs().max()) / max(scale, 1e-30))
    return worst


def phase_check_pod(torch, dev, setup):
    """The short pod run ``POD_CHECK_CHAINS`` x ``POD_CHECK_STEPS`` four ways:
    (a) no process group; (b) an NCCL group of one rank (``file://``), the
    all-reduces on the card: pooled stats equal to (a)'s bitwise; (c) two
    gloo rank processes sharing the card (NCCL refuses two ranks on one
    device): every decision equal to (a)'s, chain for chain, except at
    |log α − log u| ≤ 1e-3 (a chain that flips there is left out from that
    step on), pooled stats within 1e-5 of |x| + the field's largest |x| (32
    and 64 chains may take other cuBLAS GEMMs, so coefficients near zero
    differ in their own last digits); (d) the pooled R-hat and ESS of
    (a) and (c) against ``split_rhat``/``ess`` of the gathered traces, rtol
    1e-4."""
    import tempfile

    import torch.distributed as dist

    from icp_proposal_tpu_torch.apps.femur_experiments import _fold_in
    from icp_proposal_tpu_torch.parallel.distributed import initialize_distributed, run_ranks
    from icp_proposal_tpu_torch.sampling import diagnostics, mh

    tag = "check:pod"
    burn = POD_CHECK_STEPS // 5
    t = time.perf_counter()
    rec_a, final_a, stats_a = _pod_run(torch, dev, setup)
    _sync(torch)
    print(f"[{tag}] (a) no group: {POD_CHECK_CHAINS} chains x {POD_CHECK_STEPS} steps in "
          f"{time.perf_counter() - t:.2f} s; pooled acceptance {float(stats_a.acceptance):.4f}, "
          f"max R-hat {float(stats_a.rhat.max()):.4f}, ESS {float(stats_a.ess):.1f}")

    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/rendezvous", 1, 0, device=dev)
        try:
            backend = dist.get_backend()
            rec_b, _, stats_b = _pod_run(torch, dev, setup)
            _sync(torch)
        finally:
            dist.destroy_process_group()
    if not torch.equal(rec_b.accepted, rec_a.accepted):
        raise AssertionError(f"{tag}: (b) decisions differ from (a)")
    for name, x in stats_a._asdict().items():
        if not torch.equal(getattr(stats_b, name), x):
            raise AssertionError(f"{tag}: (b) pooled {name} differs from (a)")
    print(f"[{tag}] (b) one-rank {backend} group, all-reduces on the card: every decision "
          f"and every pooled stat equal to (a) bitwise")

    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        cmds = [[sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.pod_check_rank(*sys.argv[1:])", str(r), str(world),
                 f"file://{tmp}/rendezvous", f"{tmp}/out{r}.pt", str(dev)]
                for r in range(world)]
        t = time.perf_counter()
        run_ranks(cmds, POD_RANK_TIMEOUT, tmp, cwd=Path(__file__).resolve().parent)
        outs = [torch.load(f"{tmp}/out{r}.pt") for r in range(world)]
    wall_c = time.perf_counter() - t
    for out in outs[1:]:
        for name, x in out["stats"].items():
            if not torch.equal(x, outs[0]["stats"][name]):
                raise AssertionError(f"{tag}: (c) ranks disagree on pooled {name}")
    # log u of every step: the same generator draws the whole batch's noise
    _, mixture, _ = setup
    gen = torch.Generator(device=dev).manual_seed(_fold_in(POD_CHECK_SEED, 7))
    log_u = torch.stack([mh.draw_noise(mixture, POD_CHECK_CHAINS, gen).log_u
                         for _ in range(POD_CHECK_STEPS)], dim=1).cpu()
    tie = (rec_a.log_alpha.cpu() - log_u).abs() <= 1e-3
    differ = torch.cat([o["accepted"] for o in outs]) != rec_a.accepted.cpu()
    # a chain that flips at a tie parts from (a): compare it up to that step
    parted = (differ & tie).any(dim=1)
    first = torch.where(parted, (differ & tie).int().argmax(dim=1), POD_CHECK_STEPS)
    compared = torch.arange(POD_CHECK_STEPS)[None, :] <= first[:, None]
    if (differ & ~tie & compared).any():
        raise AssertionError(f"{tag}: (c) {int((differ & ~tie & compared).sum())} decisions "
                             "differ from (a) away from a tie")
    worst = _stats_within(torch, tag, "(c) against (a)", outs[0]["stats"], stats_a, 1e-5)
    coeff_err = float((torch.cat([o["final_coeffs"] for o in outs])
                       - final_a.state.coeffs.cpu()).abs().max())
    print(f"[{tag}] (c) {world} gloo rank processes on one {dev.type} device, "
          f"{POD_CHECK_CHAINS // world} chains each, {wall_c:.1f} s with start-up: "
          f"{int((compared & ~tie).sum())} decisions away from a tie, all equal to (a)'s; "
          f"{int(tie.sum())} at |log a - log u| <= 1e-3, {int(parted.sum())} chains parted "
          f"at one; final coefficients within {coeff_err:.3g} of (a)'s; pooled stats "
          f"within {worst:.3g} of each field's largest magnitude (held 1e-5 of |x| + "
          "max|x|)")

    for what, traces, stats in (("(a)", rec_a.coeffs, stats_a._asdict()),
                                ("(c)", torch.cat([o["coeffs"] for o in outs]),
                                 outs[0]["stats"])):
        tail = traces[:, burn:, :8]
        for name, want in (("rhat", diagnostics.split_rhat(tail)),
                           ("ess", diagnostics.ess(tail[..., 0]))):
            if not torch.allclose(stats[name].cpu(), want.cpu(), rtol=1e-4, atol=0.0):
                raise AssertionError(f"{tag}: (d) {what} pooled {name} {stats[name]} against "
                                     f"the gathered traces' {want}")
    print(f"[{tag}] (d) pooled R-hat and ESS of (a) and (c) equal split_rhat/ess of the "
          "gathered traces within rtol 1e-4")


def phase_dryrun(torch):
    """``graft_entry.dryrun_multichip`` over every card (one NCCL rank per
    card, started as processes)."""
    from icp_proposal_tpu_torch.graft_entry import dryrun_multichip

    n = torch.cuda.device_count()
    t = time.perf_counter()
    dryrun_multichip(n)
    print(f"[main:dryrun] dryrun_multichip({n}) passed in {time.perf_counter() - t:.1f} s "
          "(rank processes' start-up included)")


def _evidence_summary(name, out):
    """The few numbers of a tool's output that [main:evidence] prints and
    checks; raises where an output is degenerate."""
    import math

    def finite(*xs):
        if not all(x is not None and math.isfinite(x) for x in xs):
            raise AssertionError(f"[main:evidence] {name}: non-finite output {xs}")

    if name.startswith("validate_index"):
        for row in out:
            finite(row["max_abs_err_mm"], row["max_rel_err"], row["frac_mismatched"])
            if row["frac_mismatched"] > 0.05 or row["n_queries"] != out[0]["n_queries"]:
                raise AssertionError(f"[main:evidence] {name}: {row}")
        return {f"K={r['k']} {r['regime']}": [r["max_abs_err_mm"], r["frac_mismatched"]]
                for r in out}
    if name in ("mixing_sweep", "posterior_parity"):
        runs = out if name == "mixing_sweep" else out["runs"]
        acc = {r["label"]: r["acceptance_overall"] for r in runs}
        for r in runs:
            finite(r["acceptance_overall"], r["final_avg_dist_mm_mean"])
            if not 0.0 < r["acceptance_overall"] < 1.0:
                raise AssertionError(f"[main:evidence] {name}: acceptance {acc}")
        parity, exact = (("flagship-parity-s0.1", "flagship-exact-s0.1")
                         if name == "mixing_sweep" else ("icp-parity", "icp-exact"))
        if acc[parity] <= acc[exact]:  # the parity density's known bias
            raise AssertionError(f"[main:evidence] {name}: parity acceptance "
                                 f"{acc[parity]} not above the exact {acc[exact]}")
        summary = {"acceptance": acc}
        if name == "posterior_parity":
            summary["max_z"] = {c["pair"]: c["max_z"] for c in out["comparisons"]}
            finite(*summary["max_z"].values())
        return summary
    if name == "quality_run":
        rows = out["rows"]
        for r in rows.values():
            finite(r["map_avg_distance_mm"], r["ess_per_wall_second"])
        if out["recommended_by_ess_per_wall_second"] not in rows:
            raise AssertionError(f"[main:evidence] {name}: {out}")
        return {"map_avg_distance_mm": {k: r["map_avg_distance_mm"] for k, r in rows.items()},
                "ess_per_wall_second": {k: r["ess_per_wall_second"] for k, r in rows.items()},
                "recommended_by_ess_per_wall_second":
                    out["recommended_by_ess_per_wall_second"],
                "index_check": out["index_check"]}
    if name == "quality_bfm":
        rows = out["rows"]
        for r in rows.values():
            finite(r["map_avg_distance_vs_full_target"], r["ess_first8_mean"])
        return {k: {"map_avg": r["map_avg_distance_vs_full_target"],
                    "acceptance": r["acceptance"]["overall"]} for k, r in rows.items()}
    if name == "converged_run":
        # two rounds: the host R-hat covers round 1 alone, as the pooled one does
        pooled = out["rounds"][-1]["collective_split_rhat_max_first8"]
        host = out["host_split_rhat_max_first8_postburn"]
        if len(out["rounds"]) != 2 or abs(pooled - host) > 1e-4 * abs(host):
            raise AssertionError(f"[main:evidence] {name}: pooled R-hat {pooled} against "
                                 f"the gathered traces' {host}")
        return {"rhat_by_round": [r["collective_split_rhat_max_first8"]
                                  for r in out["rounds"]], "host_rhat": host,
                "pooled_acceptance": out["rounds"][-1]["pooled_acceptance"]}
    finite(out["max_abs_z_first"])  # crossimpl_parity
    return {k: out[k] for k in ("max_abs_z_first", "pass_3sigma_first",
                                "max_delta_in_posterior_sd_first")} | {
        "acceptance": {"numpy": out["port"]["acceptance"], "port": out["jax"]["acceptance"]}}


def phase_evidence(torch, dev, data):
    """``[main:evidence]``: each tool of ``icp_proposal_tpu_torch.tools``
    through its ``main()`` with ``EV_ARGS`` on the card, outputs under
    build/evidence_smoke (each tool's own output in ``<tool>.log``), launch
    counts read around each; the shortlist indices ``validate_index`` builds
    are kept for [kernels:evidence], and its K = 64 rows are held to the
    same sweep on the CPU twins (``data``: the stand-in GPMM-50 the tools
    build) → (summed counts, indices by K, the sweep's queries by regime)."""
    import contextlib
    import importlib

    from icp_proposal_tpu_torch.ops import surface_index

    out_dir = BUILD / "evidence_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    built = {}
    build_index = surface_index.build_surface_index

    def keep(points, cells, k=surface_index.INDEX_K, coarse="exact", device="cuda"):
        index = build_index(points, cells, k, coarse, device)
        if coarse == "exact":
            built[k] = index
        return index

    total = {}
    outs = {}
    for name, args in EV_ARGS.items():
        module = name.split("[")[0]
        tool = importlib.import_module(f"icp_proposal_tpu_torch.tools.{module}")
        argv = [*args, "--device", str(dev), "--out", str(out_dir / f"{module}.json")]
        if module == "crossimpl_parity":
            argv += ["--port-cache", str(out_dir / "crossimpl_port_moments.npz")]
        surface_index.build_surface_index = keep
        _reset_counts()
        t = time.perf_counter()
        try:
            with open(out_dir / f"{name}.log", "w") as log, contextlib.redirect_stdout(log):
                outs[name] = tool.main(argv)
            _sync(torch)
        finally:
            surface_index.build_surface_index = build_index
        wall = time.perf_counter() - t
        counts = _read_counts()
        missing = [k for k in EV_KERNELS[name] if counts[k] == 0]
        if missing:
            raise AssertionError(f"[main:evidence] {name}: {missing} never launched; "
                                 f"launches {counts}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        print(f"[main:evidence] {name} {' '.join(args)}: {wall:.1f} s; launches "
              f"{ {k: n for k, n in counts.items() if n} }")
        print(f"[main:evidence] {name}: " + json.dumps(_evidence_summary(name, outs[name])))

    # the card's K = 64 sweep against the same sweep on the CPU twins, on
    # the tool's own queries (the stand-in ``data`` is the tools' GPMM-50)
    from icp_proposal_tpu_torch.tools import validate_index as vi

    gen = torch.Generator().manual_seed(1024)
    queries = {regime: vi.perturbed_queries(data, gen, **kw)
               for regime, kw in vi.REGIMES.items()}
    idx = built[64]
    cpu_index = surface_index.SurfaceIndex(idx.points.cpu(), idx.tri.cpu(), idx.cand.cpu(),
                                           idx.points_aug.cpu())
    for row in (r for r in outs["validate_index"] if r["k"] == 64):
        err, _, frac = surface_index.validate_index(cpu_index, queries[row["regime"]],
                                                    with_rel=True)
        if abs(err - row["max_abs_err_mm"]) > 1e-5 or frac != row["frac_mismatched"]:
            raise AssertionError(f"[main:evidence] validate_index K=64 {row['regime']}: "
                                 f"card {row}, CPU twins {err}, {frac}")
    print("[main:evidence] validate_index K=64: the card's errors equal the CPU twins' "
          "(max_abs_err within 1e-5 mm, frac_mismatched equal) in every regime")
    return total, built, queries


def phase_kernels_evidence(torch, dev, indices, queries):
    """``[kernels:evidence]``: K4 at each shortlist width of the index sweep
    against its twin, on the sweep's own queries ([1, P, 3] a regime, the
    coarse ids from K3): ids and winner corners bitwise in every regime,
    timed on the last regime's (far-init) queries → records by K."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cp

    records = {}
    for k, idx in sorted(indices.items()):
        for regime, q_np in queries.items():
            q = torch.as_tensor(q_np, device=dev)[None].contiguous()
            nv = cp.nearest_vertices(q, idx.points)
            f, w = cp.refine_shortlist(q, nv, idx.cand, idx.faces)
            f_p, w_p = cp.refine_shortlist_plain(q, nv, idx.cand, idx.faces)
            _sync(torch)
            err, mism = _id_errors(f, f_p)
            if mism or not torch.equal(w.view(torch.int32), w_p.view(torch.int32)):
                raise AssertionError(f"[kernels:evidence] K4 at K={k}, {regime}: {mism} "
                                     "ids or the winner's corners differ from the twin")
        rec = _record(torch, err, mism, lambda: cp.refine_shortlist(q, nv, idx.cand, idx.faces),
                      lambda: cp.refine_shortlist_plain(q, nv, idx.cand, idx.faces),
                      _nbytes(q, nv, idx.cand, idx.faces, f, w),
                      PAIR_FLOPS * q.shape[1] * idx.k)
        rec.update(k=k, queries=q.shape[1])
        _print_record("kernels:evidence", f"refine_shortlist[K={k}]", rec, 1)
        records[f"K={k}"] = rec
    print(f"[kernels:evidence] K4 equals its twin bitwise (ids and winner corners) at "
          f"K = {', '.join(map(str, sorted(indices)))} in all {len(queries)} regimes")
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _smi()

    # 1. device
    from icp_proposal_tpu_torch import _build

    nvcc = _build.find_nvcc()
    nvcc_line = "missing"
    if nvcc:
        nvcc_line = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                   timeout=60).stdout.strip().splitlines()[-1]
    print(f"[device] {kind} x{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvcc: {nvcc_line}; python {sys.version.split()[0]}")
    print(f"[device] nvidia-smi: {smi}")
    _sync(torch)

    # 2. build
    t = time.perf_counter()
    path, log = _build.build_library()
    _build.load_library()
    print(f"[build] {path.name} in {time.perf_counter() - t:.1f} s")
    for line in log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")
    _sync(torch)

    # the stand-in femur workload and the flagship setup, on the card
    from icp_proposal_tpu_torch.apps.bfm import (
        load_synthetic_face_data,
        make_bfm_fitting_setup,
    )
    from icp_proposal_tpu_torch.apps.femur import (
        FemurData,
        load_standin_femur_data,
        make_hybrid_setup,
        make_icp_proposal_setup,
        make_mala_setup,
        make_random_walk_adapt_setup,
    )

    t = time.perf_counter()
    data = load_standin_femur_data(device=dev)
    setup = make_icp_proposal_setup(data)
    ctx, mixture, evaluator = setup
    dot_setup = make_icp_proposal_setup(data, coarse="dot")
    _sync(torch)
    print(f"[setup] stand-in femur GPMM-100: rank {data.model.rank}, "
          f"{data.model.num_points} vertices; K={ctx.index.k} index; flagship setups "
          f"with coarse='exact' and 'dot'; {time.perf_counter() - t:.1f} s")

    # 3. kernels against plain twins
    records = phase_kernels(torch, dev, data, ctx, dot_setup[0])
    _print_records("kernels", records)
    _sync(torch)

    # 4. main path: femur
    launches = {"femur": phase_main(torch, dev, "main", data.model, mixture, evaluator,
                                    WARMUP_STEPS, TIMED_STEPS, FEMUR_STEP_LAUNCHES)}

    # 5. check against the plain twins on the CPU
    def cpu_femur(m, coarse="exact"):
        return make_icp_proposal_setup(FemurData(m, data.target, data.target_boundary_mask,
                                                 data.model_boundary_mask), coarse=coarse)

    phase_check(torch, dev, "check", data.model, setup, cpu_femur)
    _sync(torch)

    # 6. main path: the registration entry point, coarse pass K8
    launches["registration"] = phase_registration(torch, dev, data)

    # 7. check the coarse="dot" step against the plain twins on the CPU
    phase_check(torch, dev, "check:dot", data.model, dot_setup,
                lambda m: cpu_femur(m, coarse="dot"))
    _sync(torch)

    # 8. the BFM face stand-in at rank 200 and the partial-face setup
    t = time.perf_counter()
    face = load_synthetic_face_data(rank=BFM_RANK, subdiv=BFM_SUBDIV, device=dev)
    t_build = time.perf_counter() - t
    t = time.perf_counter()
    bfm_setup = make_bfm_fitting_setup(face, partial=True)
    _, bfm_mixture, bfm_evaluator = bfm_setup
    _sync(torch)
    print(f"[setup:bfm] face stand-in: rank {face.model.rank}, "
          f"{face.model.num_points} vertices, {face.model.cells.shape[0]} faces; "
          f"partial target {len(face.target_partial.points)} vertices, "
          f"{len(face.target_partial.cells)} faces; host model build {t_build:.1f} s, "
          f"setup {time.perf_counter() - t:.1f} s")

    # 9. K5, K6, K7 against plain twins
    bfm_records = phase_kernels_bfm(torch, dev, face, bfm_evaluator)
    _print_records("kernels:bfm", bfm_records)
    records.update(bfm_records)
    _sync(torch)

    # 9b. K9 and K10 (the index build) against their twins; whole contexts
    records.update(phase_kernels_index(torch, dev, data, ctx, face, bfm_setup[0]))
    _sync(torch)

    # 10. main path: BFM partial
    launches["bfm-partial"] = phase_main(
        torch, dev, "main:bfm-partial", face.model, bfm_mixture, bfm_evaluator,
        BFM_WARMUP_STEPS, BFM_TIMED_STEPS, BFM_STEP_LAUNCHES)

    # 11. check against the plain twins on the CPU
    phase_check(torch, dev, "check:bfm", face.model, bfm_setup,
                lambda m: make_bfm_fitting_setup(dataclasses.replace(face, model=m),
                                                 partial=True))
    _sync(torch)

    # 12. main paths: the adaptive femur setups
    adaptive = {"hybrid": (make_hybrid_setup, HYBRID_STEP_LAUNCHES),
                "mala": (make_mala_setup, MALA_STEP_LAUNCHES),
                "rw-adapt": (make_random_walk_adapt_setup, RW_STEP_LAUNCHES)}
    built = {}
    for name, (make, per_step) in adaptive.items():
        built[name] = make(data)
        _, mix, ev = built[name]
        launches[name] = phase_main(torch, dev, f"main:{name}", data.model, mix, ev,
                                    WARMUP_STEPS, TIMED_STEPS, per_step)

    # 13. check the gradient-informed setups against the plain twins on the CPU
    for name in ("hybrid", "mala"):
        make = adaptive[name][0]
        phase_check(torch, dev, f"check:{name}", data.model, built[name],
                    lambda m, make=make: make(FemurData(
                        m, data.target, data.target_boundary_mask,
                        data.model_boundary_mask)))
        _sync(torch)

    # 14. main path: the BFM entry point
    launches["bfm-fitting"] = phase_bfm_fitting(torch, dev, face)
    _sync(torch)

    # 15. main path: the face pipeline (scans of the face stand-in's target)
    launches["face-pipeline"] = phase_face_pipeline(torch, dev, face, smi)
    _sync(torch)
    del face, bfm_setup, bfm_mixture, bfm_evaluator, built

    # 16. the stand-in femur GPMM-200 and GPMM-50
    femur_models = {}
    for components in (200, 50):
        t = time.perf_counter()
        femur_models[components] = load_standin_femur_data(device=dev,
                                                           model_components=components)
        _sync(torch)
        m = femur_models[components].model
        print(f"[setup:femur200] stand-in femur GPMM-{components}: rank {m.rank}, "
              f"{m.num_points} vertices; host build {time.perf_counter() - t:.1f} s")

    # 17. main path: the deterministic ICP entry point
    launches["icp"] = phase_icp(torch, dev, femur_models[50])

    # 18. the deterministic ICP against the plain twins on the CPU
    for components in (50, 200):
        phase_check_icp(torch, dev, femur_models[components])
    _sync(torch)

    # 19. K5, K6 and K7 at the harness's widths against the plain twins
    harness_records = phase_kernels_harness(torch, dev, femur_models[200])
    _print_records("kernels:harness", harness_records, EXP_INITS)
    for name, rec in harness_records.items():
        records[name]["at_harness"] = rec
    _sync(torch)

    # 20. main path: the paper's harness
    launches["experiments"] = phase_experiments(torch, dev, femur_models[200])

    # 21. the harness's two MH setups against the plain twins on the CPU, from
    # the harness's own inits
    from icp_proposal_tpu_torch.apps import femur_experiments as fe

    d200 = femur_models[200]

    def harness_setups(m):
        ctx_h, mix, eval_euclid, eval_hausdorff = fe._harness_setup(
            m, d200.target, d200.model_boundary_mask)
        return {"euclidean": (ctx_h, mix, eval_euclid),
                "hausdorff": (ctx_h, mix, eval_hausdorff)}

    inits = fe._batched_init_states(d200.model, 8, fe._fold_in(1024, 0, 0))
    for name, setup_h in harness_setups(d200.model).items():
        phase_check(torch, dev, f"check:experiments-{name}", d200.model, setup_h,
                    lambda m, name=name: harness_setups(m)[name], state=inits)
        _sync(torch)

    # 22. main path: the random-init comparison
    launches["random-init"] = phase_random_init(torch, dev, data)

    # 23. its two MH setups against the plain twins on the CPU, from its inits
    def random_init_setups(m):
        ctx_ri, ev, mix_icp, mix_rnd = fe._random_init_setup(
            m, data.target, data.model_boundary_mask, data.target_boundary_mask)
        return {"icp": (ctx_ri, mix_icp, ev), "rnd": (ctx_ri, mix_rnd, ev)}

    inits = fe._batched_init_states(data.model, 8, fe._fold_in(1024, 0))
    for name, setup_ri in random_init_setups(data.model).items():
        phase_check(torch, dev, f"check:random-init-{name}", data.model, setup_ri,
                    lambda m, name=name: random_init_setups(m)[name], state=inits)
        _sync(torch)

    # 24. main path: the configured run, and its check against the hand-built
    # flagship recipe and the CPU twins
    launches["config"], config_setup = phase_config(torch, dev, data, smi)
    phase_check_config(torch, dev, data, config_setup)

    def cpu_config(m):
        from icp_proposal_tpu_torch.utils.config import RunConfig, build_from_config

        return build_from_config(RunConfig(), m, data.target, data.model_boundary_mask,
                                 data.target_boundary_mask)

    phase_check(torch, dev, "check:config", data.model, config_setup, cpu_config)
    _sync(torch)

    # 25. main path: the femur pipeline (align, build, load, register, replay,
    # posterior); its replay and posterior against the CPU from the same log
    launches["femur-pipeline"], pipe_model, pipe_records = phase_femur_pipeline(
        torch, dev, data, smi)
    phase_check_replay(torch, dev, pipe_model, pipe_records)
    _sync(torch)
    del pipe_model, pipe_records

    # 26. main path: the pod run (apps.pod_chains at its defaults), then the
    # bare step at its chains
    launches["pod"] = phase_pod(torch, dev, data, setup)
    _sync(torch)

    # 27. the short pod run with no group, in a one-rank NCCL group and over
    # two gloo rank processes; pooled R-hat/ESS against the gathered traces
    phase_check_pod(torch, dev, setup)
    _sync(torch)

    # 28. the driver's dry run, one NCCL rank process per card
    phase_dryrun(torch)

    # 29. main path: the posterior-evidence tools at cut sizes; 30. K4 at the
    # index sweep's shortlist widths against its twin
    launches["evidence"], ev_indices, ev_queries = phase_evidence(torch, dev, femur_models[50])
    records["refine_shortlist"]["at_evidence"] = phase_kernels_evidence(
        torch, dev, ev_indices, ev_queries)
    _sync(torch)

    kernels = []
    for name, rec in records.items():
        by_path = {path: counts[name] for path, counts in launches.items()}
        kernels.append({"name": name, "route": "cuda",
                        "source": f"icp_proposal_tpu_torch/{SOURCES[name][0]}",
                        "replaces": SOURCES[name][1], "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **rec})
    print(json.dumps({"kernels": kernels}))
    print(f"[device] nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
