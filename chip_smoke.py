#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (vpic_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. device: a CUDA card is present; prints its nvidia-smi name and power
     limit;
  2. build: the eleven kernel sources (csrc/fused_push2d.cu,
     fused_push3d.cu, move_p.cu, merge_p.cu, res_plan.cu, compact_block.cu
     with the compaction and the block copy, mailbox.cu, field_beb.cu,
     graph_cond.cu, ta_collide.cu, rho_p.cu) built for sm_90a, one nvcc
     each, started together; prints ptxas' registers / spills / shared
     memory (ta_collide's kernels must spill nothing), and the push
     kernels' CUDA blocks per SM;
  3. 2-D kernel: holds the 2-D push kernel against its plain PyTorch version
     on the 64^2 x 64 ppc harris state at the main path's shapes, after the
     bucket sort; prints its deposit rounds that took the global path and
     their share of all; times both with CUDA events, and the kernel's
     device time per push of both species with torch.profiler;
  4. 2-D reference: a small 2-D harris deck run 10 steps on the card and on
     the CPU (where the plain versions run) must agree;
  5. 2-D run: the full-width 2-D harris deck (64^2 cells x 64 ppc, 2 species
     of 131,072 particles) through Simulation's step for 200 steps; the push
     kernel (one launch a step for both species) must have been launched at
     least once a step, no streak may be left unfinished and the energy
     drift must stay below 1e-3 (bench.py's guard); the step's field
     advance must be field_beb, launched exactly once a step; prints the
     run's share
     of global-path deposit rounds; then 7 more steps, and the kernel
     against its plain version again on the last push before the next
     sort (the most global-path rounds);
  6. 3-D kernels: at the full-width 3-D harris state (32^3 cells x 128 ppc,
     2 species of 2,097,152 particles) after its first rebucket, the 3-D
     push kernel with its residency outbox against its plain version (with
     its global-path deposit rounds, and its device time as in phase 3),
     then the merge kernel (one launch for both species, in place, as the
     step runs it) against its plain version on clones of that push's
     lanes and its exchange plan (bit for bit); both timed with CUDA
     events and the kernel's device time with torch.profiler, the input
     restored before each call; its bound written to new arrays and the
     least an in-place merge of these inputs must move;
  7. 3-D reference: a 16^3 harris deck run 10 steps on the card and on the
     CPU must agree;
  8. 3-D run: the full-width 3-D harris deck through the residency step for
     100 steps (bench.py --deck harris3d's widths and steps); both 3-D
     kernels must have been launched (the push and the merge once a step
     for both species, field_beb exactly once a step),
     no streak left unfinished, drift below 1e-3, and
     the species tensors must be the same storage after the run; prints the
     run's global-path share; then the merge kernel's launches and device
     time per step over 10 more steps (torch.profiler), and the push kernel
     against its plain version again on the residency lanes and home maps
     the run left;
  9. residency prototypes: the entry points vpic_tpu_torch.scripts.
     residency_proto and residency_grid_bench (their main()), which hold the
     compaction kernel against numpy and its plain version bit for bit with
     equal counts at (9, 4096) and (16, 64 x 4096) (two entries of the
     kernels' line, one per entry point, each with its launches), the
     block copy (compact_blocks without a mask) at (16, 64 x 4096), and
     the mailbox kernel at 96 blocks of (16, 128), into a zeroed output
     and into a NaN-filled out=; and time kernel, plain version and
     library call (CUDA events), with the kernel's and the library call's
     device time;
 10. field trio: the entry point vpic_tpu_torch.scripts.field_fuse_proto
     (its main()) at the 64^2, 32^3, 128^2, 256^2 and 64^3 harris fields
     (4 ppc): field_beb against the plain trio to 1e-6 abs on each output,
     exactly one launch per trio; both timed with CUDA events and
     torch.profiler, in turns (kernel, plain, plain, kernel), with the
     bound;
 11. lpi: the lpi deck at its published width (128 x 32 cells, 16 ppc in the
     slab: 2 species of 32,768 particles; absorbing field walls, reflux
     particle walls, the laser through user_field_injection) on the card:
     the 2-D push kernel's WALLS instance against its plain version after
     the first sort (lanes, pend codes, remaining displacement, acc, rhob),
     both timed; then 200 steps, which must launch the push kernel exactly
     once a step and the reflux walk kernel (move_p) once per handler call,
     keep every particle (reflux re-emits what reaches a wall), stay
     finite and run the plain field trio (absorbing faces and the laser
     hook: no field_beb launch); prints ms/step, launches, and over 20 more steps the kernel
     launches a step and the device's busy share (torch.profiler); 2 more
     steps must make no synchronizing operation (torch's sync debug
     mode); then
     move_p against its plain version on the lanes a push parks and on a
     denser set (lanes, pend codes, displacement, acc, rhob), both timed;
     the lanes parked at the walls a step; then the push kernel against its
     plain version again;
 12. 2-D region walls: a 128^2 periodic deck (16 ppc, 262,144 electrons)
     with an absorbing interior square, 10 steps on the card (the kernel
     must have run, lanes must have died), then the kernel against its
     plain version on the lanes those steps left (lanes, pend, acc, rhob);
 13. 3-D region walls: a 32^3 periodic deck (32 ppc, 1,048,576 electrons)
     with an absorbing interior cube, on the residency path: 20 steps
     (the push kernel once a step, merges, lanes dying at the region), then
     the 3-D kernel's WALLS instance with its residency outbox against its
     plain version on the residency lanes and home maps the run left (no
     lane stopped at a wall reaches the outbox), both timed;
 14. general path: a 24 x 24 x 20 periodic deck (16 ppc; nz is no
     multiple of 8, so no bricks) with the absorbing cube and reflux
     particle walls at +-x, 10 steps on the card: the 3-D kernel without
     home maps once a step, move_p once per handler run (boundary_p's
     num_comm_round + 1 runs), lanes absorbed; then the kernel against its
     plain version on the lanes the run left; 2 eager steps with no
     synchronizing operation (so step_graph captures the general path);
 15. the deck runner: vpic_tpu_torch.__main__.main in process on the
     64^2 x 64 ppc harris deck, 200 steps with --energies and --checkpt
     ck:100, then --restore ck.100 to step 200 into a second energies
     file: the 2-D push kernel exactly once a step in both runs, no
     unfinished streak, drift below 1e-3, the restart's step-200 energies
     and its energies-file rows within RESTART_RTOL of the total of the
     uninterrupted run's, equal particle counts; the checkpoint's bytes and
     write time and the restore's time; at step 200 the field, hydro,
     particle (both species) and grid dumps, each timed and read back with
     utilities/read_dumps.py, and the card's hydro against the CPU's
     plain hydro of the same state to 1e-5 max|moment|; ms/step with and
     without the I/O cadence;
 16. 3-D restart: the 16^3 x 4 ppc harris residency deck, 10 steps, a
     checkpoint, 10 more; restored into a new Simulation, 10 steps: the
     push and the merge kernels once a step, no rebucket added, fields,
     energies and lanes (live counts, voxel multisets) equal to the
     uninterrupted run's to the ten-step tolerances;
 17. shapes: the deck at its defaults (64 x 16, eps 4 slab, sigma 2
     block), 160 steps on the card and on the CPU: fields to the ten-step
     tolerances, the energy non-increasing while over a quarter of the
     interior field energy is in the conductor and under half its start at
     the end, the plain field trio on the card (no field_beb launch), and
     make_beb refusing the mesh coefficients;
 18. collision ops: hard sphere, Takizuka-Abe (intra- and interspecies),
     large-angle Coulomb and Langevin on 2^19 lanes in a 16^3 periodic box
     (scripts/bench_collision.py's shape), each applied on the card and on
     the CPU to the same CPU-made draws: the shuffle permutation, live
     masks, voxels and weights equal, momenta to 1e-5 max|u|; each timed
     (CUDA events, its device time and launches from torch.profiler, M
     particle-collisions/s), and one application must make no
     synchronizing operation; the route each op took (the T&A ops on the
     card: csrc/ta_collide.cu's kernels);
 19. collisional reconnection: the deck at 32^3 x 128 ppc (2 species of
     2,097,152 particles, three T&A ops every 5 steps) on the residency
     path for 20 steps: the 3-D push and field_beb exactly once a step, a
     rebucket
     before the push on every firing step, the merge on every step the
     exchange did not rebucket, one host sync a step, the species storage
     and the particle counts kept, no unfinished streak, the energy drift
     below 3e-2; prints ms/step, then over one 5-step cycle the launches
     and device ms a step and the busy share (torch.profiler), and the
     collision stage's device ms and launches a firing; the rebuckets by
     cause (residency.rebuckets_by_cause: they add up to the rebuckets
     after the push), and 6 steps traced around a firing, the firing
     step's replay claimed whole (utils.profile.attribute), its device ms
     by stage.  Before that window, on the state after the cycle: each of
     the three ops, its hand kernels against the plain op from the same
     draws (equal slots, momenta to 1e-5 max|u|) and both timed in turns
     (CUDA events, device ms, launches), the plain electron-ion op's
     index_add_ timed with every i-lane and with the paired live ones
     alone, and the lanes the order passes sent down their wide path; the
     20 steps must launch csrc/ta_collide.cu's kernels 27 times a firing
     (an order pass of 6 a shuffled species and a pair kernel an op), every
     op on its "cuda" route;
 20. emission: child_langmuir's apply on the diode (after 30 CPU steps)
     on the card and the CPU from the same draws (new lanes to 3e-5, rhob
     and acc to 1e-5 of their largest, one move_p launch); then the diode
     at its defaults on the card: lanes from step 0, the anode's tally 0
     for 20 steps, then 200 steps with the 2-D WALLS push once a step and
     move_p once per emitter call, the tally growing; 2 more steps with
     no synchronizing operation; ms/step, launches, lanes emitted and
     absorbed a step;
 21. aged injection: 3,000 aged lanes, some aimed at an absorbing wall:
     initialize() on the card and the CPU agree (the same lanes killed,
     lanes to 2e-6), with one move_p launch;
 22. the nine sample decks (scripts/deck_checks.py): twostream (64 x 1 x 1),
     weibel_gold (16 x 1 x 1), beam_plas, force_free (32 x 16 x 16),
     sc08 (32 x 8 x 16), asymm4sp at vpic_tpu's defaults, dipole (16^3) and
     waveguide (48 x 8) at their oracles' sizes, cygnus (190 x 1 x 18),
     each through its oracle's steps and asserts (the JAX package's tests
     of the deck); the path each takes, field_beb exactly once a step on
     the six particle decks and never on dipole, waveguide and cygnus (the
     plain trio: absorbing faces or a field hook), the push kernel once a
     step wherever there are species, no merge (no deck here has room for
     residency), no unfinished streak; ms/step, launches, and over 10 more
     steps the launches and device ms a step and the busy share
     (torch.profiler); each deck's first 5 steps on the card and on the CPU
     from one initial state (lanes to 3e-5, fields to 5e-7 + 1e-5 max|a|,
     energies to 1e-5 of their sum); the 2-D push kernel against its plain
     version on twostream's lanes (one-cell y and z axes) sorted and as the
     step left them, field_beb against the plain trio bit for bit on
     twostream's and weibel_gold's fields, the 3-D kernel with home maps on
     force_free's and without on sc08's (pec and reflecting x faces);
 23. sc08 at the reference demo's 150 x 25 x 100 x 1 ppc (749,998
     particles), one device, the general path: 50 steps with every
     particle kept and drift below 5e-3; the deck's build (host staging) and
     initialize() seconds, ms/step, launches, busy share and peak device
     memory (also above what was allocated before the build); then the 3-D
     kernel without home maps against its plain version on the lanes the
     run left, both timed.
 24. harris 2-D at phase 5's 64^2 x 64 ppc decomposed (1, 2, 1): two
     ranks on the one card (parallel.mesh.launch; the transport is
     gloo-staged: the exchanged buffers go through pinned host memory),
     each holding 64 x 32; 6 steps whose energies match phase 5's deck on
     one domain on the card (rtol 5e-4, atol 1e-7 of their sum,
     tests/test_sharded.py:45-46), then 194 timed steps: the 2-D WALLS
     push once a step per rank, every particle kept (the ranks' live
     lanes summed, none dropped), drift < 1e-3; then on each rank the
     kernel with its remote faces against its plain version after a
     migration step, and move_p walking received lanes on against its
     plain walk (PERF.md §2 row 3's WALLS tolerances);
 25. harris3d at phase 6's 32^3 x 128 ppc decomposed (1, 2, 1), 20 steps:
     the 3-D WALLS push with home maps once a step per rank (the brick
     sort every step, no residency and no merge), particles conserved,
     drift < 1e-3, the 3-D kernel with remote faces against its plain
     version;
 26. sc08 at the reference demo's 150 x 25 x 100 x 1 ppc on its (1, 1, 4):
     four ranks, 50 steps on the general path; every particle kept and
     drift within twice phase 23's one-domain drift;
 27. small decomposed cases: the irregular join (join_domain between
     ranks, 4 ranks: 64 lanes kept), maxwellian_reflux on a decomposed face
     (2 ranks: 128 lanes kept), and a (1, 2, 1) harris restart: a
     checkpoint written at step 10 of 20, restored on (1, 2, 1) and
     remapped to (1, 1, 1), the step-20 energies against the uninterrupted
     run's.
     Phases 24-26 print per rank the transport, staged bytes, host syncs,
     ms/step (host clock around synchronize), launches and lanes migrated
     per step and the busy share over 5 profiled steps.
 28. the decomposed stochastic decks, two ranks on the one card:
     (a) collisional reconnection at phase 19's 32^3 x 128 ppc, tau 5, on
     (1, 2, 1), 20 steps (four firings): every staged lane kept, none
     dropped, drift < 3e-2 (printed beside phase 19's), the 3-D WALLS
     push once a step per rank, the 3-D kernel with remote faces against
     its plain version on the lanes of a collision firing, move_p on
     received lanes; per rank the collision stage's launches, device ms
     and CUDA-event ms of a firing, ms/step, busy share and peak device
     memory;
     (b) the emission diode at its defaults on (2, 1, 1): the first step's
     census equal to the one-domain run's on the card, the anode tally 0
     after EMIT_QUIET steps and growing over EMIT_STEPS more, the 2-D
     WALLS push once a step per rank, no lane dropped, the push kernel
     against its plain version and child_langmuir card against CPU from
     the same draws (move_p's aged walk against its plain walk);
     (c) the runtime-injection hook (scripts/sharded_checks.injection_deck,
     4096 aged lanes a step in a 32^3 box) on (1, 2, 1): the ranks'
     lanes after the first step, gathered in global coordinates, equal the
     one-domain run's on the card (a lane whose aged walk reaches a seam
     parks on it, as vpic_tpu's does), and after 10 steps every lane kept;
     (d) parallel.mesh.dryrun(8): harris (1, 8, 1) and the (2, 2, 2) 3-D
     box on 8 ranks, the irregular join on 4, the decomposed reflux, the
     surface emitter and the collisional deck on 2.
 29. the graphed step (vpic_tpu_torch/step_graph.py): step_graph.refusal of
     every one-domain deck (lpi, dipole, waveguide and cygnus eager for
     their hooks, the others captured) and of a decomposed harris; one
     step graphed and one eager from one state (equal generator states)
     on harris2d 64^2 x 64, harris3d 32^3 x 128, reconnection 32^3 x 128
     tau 5 and the diode: lanes bit for bit, then 10 steps each way with
     the fields to 5e-7 + 1e-5 max|a|; a rebucket forced under the IF node
     of a 16^3 residency deck (one slack block a brick) equal to the eager
     branch; 200 harris2d and 100 harris3d steps in one make_multi_step
     after every cadence is captured: push and field_beb launches equal to
     the steps, merges equal to the steps less the rebuckets, two IF
     conditions a 3-D step, no synchronizing operation (sync debug mode
     "error"), drift below 1e-3 from step 0, the state's tensors kept, and
     in 10 profiled steps no kernel-launch call from the host, one
     cudaGraphLaunch a step; ms/step, pushes/s, device busy share and
     peak memory eager and graphed in turns (eager, graphed, graphed,
     eager); 20 graphed reconnection steps from step 0 (every lane kept,
     drift below 3e-2, the IF rebuckets counted) and its peak memory in
     turns.
 30. the cleaners' charge deposit: the entry point vpic_tpu_torch.scripts.
     rho_bench (its main()) on harris3d 32^3 x 128 ppc (the residency
     layout with its home maps: the kernel's TILE instance), sc08 at
     150 x 25 x 100 x 1 ppc and harris2d 64^2 x 64 ppc (no home maps: the
     global path), each after 3 graphed steps: no launch in initialize()
     (the plain version) and one a cleaning step for every species; in
     each of 10 calls (one launch each) the kernel against the plain
     moment form to 2e-6 of the charge scale (the larger of max |rhof|
     and one species' largest node charge) and against the node form
     summed in float64 to 1e-6 of it (the plain version's own error
     printed beside); no lane on the global path on the residency layout,
     every live lane deposited; the kernel and the plain version timed
     (CUDA events, device ms), with the bound (1 byte a slot, 20 a live
     lane, rhof twice).
The graphed steps (every one-domain deck but those four) count their
launches by replay (step_graph): the counts are read after
step_graph.settle(), and the residency step's host syncs are those of its
eager warm-up steps (one a step), so phases 8 and 19 require that many.
``python3 chip_smoke.py --decomposed-only`` runs phases 1-2 and 24-28,
with the one-domain sc08 drift of phase 26 from its own run of phase 23's
deck (phase 19's drift is then not run); any other argument is
refused.
Each phase from 18 on prints its seconds.  The kernel launch counts of
each run are reset just before it and read just after it, and a kernel's
entry in the kernels' line sums its runs' launches (field_beb's those of
phases 5, 8, 19, 22 and 23, the main paths; the decomposed phases' push
launches go to the WALLS instances' entries, with move_p's).  Then it
prints the
kernels' JSON line, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.
"""

import gc
import json
import os
import sys
import time
import warnings
import weakref

import numpy as np

N_STEPS = 200
N_STEPS_3D = 100
LPI = {}                        # lpi at its published defaults
REGION_2D = ((128, 128, 1), 16)
REGION_3D = ((32, 32, 32), 32)
REGION_GENERAL = ((24, 24, 20), 16)   # nz not a multiple of 8: no bricks
CLI_STEPS = 200                 # the CLI harris run, checkpointed halfway
SHAPES_STEPS = 160              # the shapes pulse into the conductor
COLL_N = 1 << 19                # scripts/bench_collision.py's lanes
# the collisional tier: Lx = Ly = 16, Lz = 4, tau 5, log_lambda 10
RECON = dict(nx=32, ny=32, nz=32, nppc=128)
RECON_STEPS = 20                # four collision firings
EMIT_QUIET = 20                 # diode steps before the first can arrive
EMIT_STEPS = 200                # then across the gap
AGED_LANES = 3000
# The restart's step-200 energies against the uninterrupted run's, each
# column to this share of the total energy: the two runs differ only in the
# float atomics' summation order on the card (both push kernels' deposits),
# which is chaotic but bounded by the drift guard (1e-3 over 200 steps);
# 1e-4 is ten times inside it and 100 times the 10-step card-vs-CPU limit.
RESTART_RTOL = 1e-4
ROOT = os.path.dirname(os.path.abspath(__file__))
# the field trio's entry point: the step's 2-D and 3-D grids, 128^2, 256^2
# and 64^3
TRIO_SIZES = ([], ["--nx", "32", "--ny", "32", "--nz", "32"],
              ["--nx", "128", "--ny", "128"], ["--nx", "256", "--ny", "256"],
              ["--nx", "64", "--ny", "64", "--nz", "64"])
# the decomposed phases: harris 2-D's steps, harris3d's, sc08's
SHARDED_STEPS = (200, 20, 50)
SHARDED_CHECK_AT = 6            # harris 2-D's energies against one domain
SHARDED_RESTART = (10, 10)      # checkpoint after 10 steps, 10 more
SHARDED_RTOL, SHARDED_ATOL = 5e-4, 1e-7   # tests/test_sharded.py:45-46
# phase 28c: the injection hook's box, its aged lanes a step, its steps
INJECT_GRID, INJECT_LANES, INJECT_STEPS = 32, 4096, 10
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_FLOPS = 67e12              # H100 SXM, float32 outside the tensor cores


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(bytes_moved, flops):
    """(least time in ms, what bounds it): bytes over the HBM rate against
    float32 operations over the card's float32 peak."""
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def lane_diff(torch, a, b):
    """Per live lane: voxels that differ.  Tolerance: at most 1 lane in 1e5
    may end in the neighbour cell, and only one that lies within 1e-5 of a
    face (FMA contraction); returns the (N,) bool mask of differing lanes."""
    live = a.live.cpu().numpy()
    n_live = int(live.sum())
    diff = live & (a.i.cpu().numpy() != b.i.cpu().numpy())
    if diff.sum() > max(1, n_live // 100_000):
        fail(f"{int(diff.sum())} of {n_live} voxels differ")
    for sp in (a, b):
        pos = np.stack([getattr(sp, n).cpu().numpy()[diff]
                        for n in ("dx", "dy", "dz")])
        gap = (1.0 - np.abs(pos)).min(axis=0) if diff.any() else []
        if np.any(np.asarray(gap) > 1e-5):
            fail("a differing voxel is not at a face")
    return diff


def compare_lanes(torch, k, a, b, diff):
    """Offsets and momenta of the live lanes whose voxel agrees, to 3e-5."""
    live = a.live.cpu().numpy()
    keep = live & ~diff
    err = 0.0
    for n in ("dx", "dy", "dz", "ux", "uy", "uz"):
        x = getattr(a, n).cpu().numpy()[keep]
        y = getattr(b, n).cpu().numpy()[keep]
        e = float(np.abs(x - y).max()) if x.size else 0.0
        if e > 3e-5:
            fail(f"species {k}.{n}: max abs err {e} > 3e-5")
        err = max(err, e)
    print(f"  species {k}: {int(live.sum())} live lanes, {int(diff.sum())} "
          f"voxel(s) differ at a face")
    return err


def compare_acc(acc_k, acc_r):
    da, db = acc_k.cpu().numpy(), acc_r.cpu().numpy()
    e_acc = float(np.abs(da - db).max())
    scale = float(np.abs(db).max())
    print(f"  acc: max abs err {e_acc:.3e}, max |acc| {scale:.3e}")
    if e_acc > 1e-5 * max(scale, 1e-30):
        fail(f"acc: max abs err {e_acc} > 1e-5 * max|acc|")
    return e_acc


def global_share(mod, what):
    """Prints and returns the global-path deposit rounds counted by the
    push module ``mod`` since its count was reset, and their share."""
    glob, every = mod.deposits.tolist()
    share = glob / every if every else 0.0
    print(f"  deposits ({what}): {glob} of {every} rounds took the global "
          f"path ({100 * share:.4f} %)")
    return glob, share


def compare_push(torch, PT, FP, g, species, fcoef, qms, what):
    """2-D kernel vs plain version on the same inputs; returns the max abs
    error over the compared lane state and accumulator."""
    print(f"compare: 2-D kernel vs plain, {what}")
    zeros = lambda: torch.zeros((g.nv, 12), device=fcoef.device)
    FP.deposits = None
    sk, acc_k, unf_k = FP.fused_push_multi(PT.clone_species(species), fcoef,
                                           zeros(), g, qms)
    sr, acc_r, unf_r = FP.fused_push_multi_ref(PT.clone_species(species),
                                               fcoef, zeros(), g, qms)
    torch.cuda.synchronize()
    global_share(FP, what)
    if int(unf_k) != int(unf_r):
        fail(f"unfinished streaks: kernel {int(unf_k)} plain {int(unf_r)}")
    err = 0.0
    for k, (a, b) in enumerate(zip(sk, sr)):
        err = max(err, compare_lanes(torch, k, a, b, lane_diff(torch, a, b)))
    return max(err, compare_acc(acc_k, acc_r))


def compare_push3d(torch, PT, FP3, g, species, homes, fcoef, qms, what):
    """3-D kernel with its residency outbox vs plain version on the same
    inputs; returns (max abs error over the compared lane state, outbox
    rows and accumulator, the kernel's outputs)."""
    print(f"compare: 3-D kernel vs plain, {what} (residency outbox)")
    zeros = lambda: torch.zeros((g.nv, 12), device=fcoef.device)
    kw = dict(homes=homes, residency=True)
    FP3.deposits = None
    ker = FP3.fused_push3d_multi(PT.clone_species(species), fcoef, zeros(),
                                 g, qms, **kw)
    ref = FP3.fused_push3d_multi_ref(PT.clone_species(species), fcoef,
                                     zeros(), g, qms, **kw)
    torch.cuda.synchronize()
    global_share(FP3, what)
    (sk, acc_k, em_k, obx_k, ores_k, unf_k) = ker
    (sr, acc_r, em_r, obx_r, ores_r, unf_r) = ref
    if int(unf_k) != int(unf_r) or int(ores_k) != int(ores_r):
        fail(f"3-D: unfinished {int(unf_k)}/{int(unf_r)}, ores "
             f"{int(ores_k)}/{int(ores_r)} (kernel/plain)")
    err = 0.0
    blk0 = 0
    n_emit = 0
    for k, (a, b) in enumerate(zip(sk, sr)):
        diff = lane_diff(torch, a, b)
        err = max(err, compare_lanes(torch, k, a, b, diff))
        ea, eb = em_k[k].cpu().numpy(), em_r[k].cpu().numpy()
        if not np.array_equal(ea[~diff], eb[~diff]):
            fail(f"3-D species {k}: emit marks differ")
        n_emit += int(ea.sum())
        # outbox columns of every block whose lanes' voxels all agree
        nb = a.capacity // FP3.BLOCK
        ok_blk = ~diff.reshape(nb, FP3.BLOCK).any(1)
        cols = ((blk0 + np.nonzero(ok_blk)[0])[:, None] * FP3.OUT_CAP
                + np.arange(FP3.OUT_CAP)[None, :]).reshape(-1)
        for name in ("valid", "vox"):
            x = getattr(obx_k, name).cpu().numpy()[cols]
            y = getattr(obx_r, name).cpu().numpy()[cols]
            if not np.array_equal(x, y):
                fail(f"3-D species {k}: outbox {name} differs")
        e = float(np.abs(obx_k.f.cpu().numpy()[:, cols]
                         - obx_r.f.cpu().numpy()[:, cols]).max())
        if e > 3e-5:
            fail(f"3-D species {k}: outbox rows max abs err {e} > 3e-5")
        err = max(err, e)
        blk0 += nb
    err = max(err, compare_acc(acc_k, acc_r))
    print(f"  outbox: {n_emit} leavers emitted, {int(ores_k)} past the cap")
    return err, ker


def push_bytes(species, g, slots, extra=0):
    """Bytes a push must move: per live lane 8 words read and 7 written,
    a live flag per slot, the coefficient table, the accumulator in and
    out, plus ``extra``."""
    live = sum(int(sp.live.sum()) for sp in species)
    return (live * (32 + 28) + slots + g.nv * 72 + 2 * g.nv * 48 + extra,
            live * 150)


def small_reference(torch, harris, p, what):
    """10 steps of a small harris deck on the card and on the CPU (plain
    versions): fields to 5e-7 + 1e-5 max|a| (test_pallas.py:88-94),
    energies to 1e-6 of their sum, live counts equal."""
    runs = []
    for dev in ("cuda", "cpu"):
        sim = harris.build(p, device=dev)
        state = sim.run(num_step=10, verbose=False)
        runs.append((sim, state))
    (sim_gpu, gpu), (sim_cpu, cpu) = runs
    for n in ("jfx", "ex", "ey", "cbz"):
        a = getattr(cpu.fields, n).numpy()
        b = getattr(gpu.fields, n).cpu().numpy()
        if not np.abs(a - b).max() < 5e-7 + 1e-5 * np.abs(a).max():
            fail(f"{what}: field {n} differs from the CPU run")
    e_cpu = sim_cpu.energies(cpu).double().numpy()
    e_gpu = sim_gpu.energies(gpu).double().cpu().numpy()
    if not np.isfinite(e_gpu).all() or \
            np.abs(e_cpu - e_gpu).max() / e_cpu.sum() >= 1e-6:
        fail(f"{what}: energies {e_gpu} vs CPU {e_cpu}")
    for a, b in zip(cpu.species, gpu.species):
        if int(a.live.sum()) != int(b.live.sum()):
            fail(f"{what}: live counts differ")
    if int(gpu.diag["unfinished"]) != 0:
        fail(f"{what}: unfinished streaks on the card")
    print(f"reference: {what}, 10 steps on the card == CPU plain path "
          "(fields 5e-7 + 1e-5 max|a|, energies 1e-6 sum, live counts)")


def compare_walls(torch, PT, P, what, fn, ref, g, species, fcoef, qms,
                  vbc=None, **kw):
    """A push kernel's WALLS instance against its plain version on clones of
    the same lanes, each with its own accumulator and a rhob from zero.
    Over the lanes live when the push began: voxels, live masks and pend
    codes equal but for at most 1 lane in 1e5 at a face (lane_diff's rule),
    offsets, momenta and remaining displacement to 3e-5; a killed lane has
    w = 0; the accumulator to 1e-5 max|acc| and rhob to 1e-5 max|rhob|
    (float atomics); with residency, the emit marks of the agreeing lanes
    equal and no lane stopped at a wall emitted.  Returns (max abs error,
    lanes parked, lanes killed)."""
    print(f"compare: {what}")
    outs = []
    for f in (fn, ref):
        walls = P.Walls(torch.zeros(g.nv, device=fcoef.device), vbc)
        acc = torch.zeros((g.nv, 12), device=fcoef.device)
        outs.append((f(PT.clone_species(species), fcoef, acc, g, qms,
                       walls=walls, **kw), acc, walls))
    torch.cuda.synchronize()
    (rk, acc_k, wk), (rr, acc_r, wr) = outs
    emits = (rk[2], rr[2]) if len(rk) == 6 and rk[2] is not None else None
    err, parked, killed = 0.0, 0, 0
    host = lambda t: t.cpu().numpy()
    for k, (s0, a, b) in enumerate(zip(species, rk[0], rr[0])):
        live0 = host(s0.live)
        diff = live0 & host((a.i != b.i) | (a.live != b.live)
                            | (wk.pends[k] != wr.pends[k]))
        if diff.sum() > max(1, live0.sum() // 100_000):
            fail(f"{what}: {int(diff.sum())} lanes differ in voxel, life "
                 "or pend code")
        for sp in (a, b):
            pos = np.stack([host(getattr(sp, n))[diff]
                            for n in ("dx", "dy", "dz")])
            if diff.any() and ((1.0 - np.abs(pos)).min(axis=0) > 1e-5).any():
                fail(f"{what}: a differing lane is not at a face")
        keep = live0 & ~diff
        pairs = [(host(getattr(a, n))[keep], host(getattr(b, n))[keep], n)
                 for n in ("dx", "dy", "dz", "ux", "uy", "uz")]
        pairs.append((host(wk.disps[k])[:, keep], host(wr.disps[k])[:, keep],
                      "remaining displacement"))
        for x, y, n in pairs:
            e = float(np.abs(x - y).max()) if x.size else 0.0
            if e > 3e-5:
                fail(f"{what}: species {k}.{n}: max abs err {e} > 3e-5")
            err = max(err, e)
        dead = live0 & ~host(a.live)
        if host(a.w)[dead].any():
            fail(f"{what}: a killed lane keeps its weight")
        if int(a.np) != int(a.live.sum()):
            fail(f"{what}: np is not the live count")
        stopped = (host(wk.pends[k]) >= P.CUSTOM_BASE) & live0
        parked += int(stopped.sum())
        killed += int(dead.sum())
        if emits is not None:
            ea, eb = host(emits[0][k]), host(emits[1][k])
            if not np.array_equal(ea[~diff], eb[~diff]):
                fail(f"{what}: species {k}: emit marks differ")
            if ea[stopped | dead].any():
                fail(f"{what}: a lane stopped at a wall reached the outbox")
    err = max(err, compare_acc(acc_k, acc_r))
    ra, rb = host(wk.rhob), host(wr.rhob)
    e = float(np.abs(ra - rb).max())
    scale = float(np.abs(rb).max())
    print(f"  rhob: max abs err {e:.3e}, max |rhob| {scale:.3e}; {parked} "
          f"lanes parked at a custom face, {killed} killed at an absorbing "
          "one")
    if e > 1e-5 * max(scale, 1e-30):
        fail(f"{what}: rhob max abs err {e} > 1e-5 * max|rhob|")
    unf = (rk[-1], rr[-1]) if len(rk) == 6 else (rk[2], rr[2])
    if int(unf[0]) != int(unf[1]):
        fail(f"{what}: unfinished streaks differ")
    return max(err, e), parked, killed


def compare_move(torch, PT, P, MP, what, g, sp, pend, disp, active, qsp):
    """The move_p kernel against its plain version on clones of the same
    lanes, pend codes and displacement, each with its own accumulator and a
    rhob from zero.  Over the lanes live before: voxels, live masks and
    pend codes equal but for at most 1 lane in 1e5 at a face (lane_diff's
    rule), offsets, momenta and remaining displacement to 3e-5, w equal;
    acc to 1e-5 max|acc| and rhob to 1e-5 max|rhob| (float atomics).
    Returns (max abs error, lanes walked, lanes killed, lanes parked
    again)."""
    outs = []
    for f in (MP.move_p, MP.move_p_ref):
        acc = torch.zeros((g.nv, 12), device=sp.dx.device)
        rhob = torch.zeros(g.nv, device=sp.dx.device)
        c = PT.clone_species([sp])[0]
        out = f(c, pend.clone(), tuple(d.clone() for d in disp), acc, rhob,
                g, qsp, active)
        outs.append((c, out, acc, rhob))
    torch.cuda.synchronize()
    (a, oa, acc_k, rk), (b, ob, acc_r, rr) = outs
    host = lambda t: t.cpu().numpy()
    live0 = host(sp.live)
    diff = live0 & host((a.i != b.i) | (a.live != b.live)
                        | (oa[1] != ob[1]))
    if diff.sum() > max(1, live0.sum() // 100_000):
        fail(f"{what}: {int(diff.sum())} lanes differ in voxel, life or "
             "pend code")
    keep = live0 & ~diff
    err = 0.0
    pairs = [(host(getattr(a, n)), host(getattr(b, n)), n)
             for n in ("dx", "dy", "dz", "ux", "uy", "uz", "w")]
    pairs.append((np.stack([host(d) for d in oa[2]]),
                  np.stack([host(d) for d in ob[2]]),
                  "remaining displacement"))
    for x, y, n in pairs:
        e = float(np.abs(x[..., keep] - y[..., keep]).max()) \
            if keep.any() else 0.0
        if e > (0.0 if n == "w" else 3e-5):
            fail(f"{what}: {n}: max abs err {e}")
        err = max(err, e)
    if int(oa[0].np) != int(a.live.sum()) or \
            int(oa[0].np) != int(ob[0].np):
        fail(f"{what}: np is not the live count, or differs")
    err = max(err, compare_acc(acc_k, acc_r))
    e = float(np.abs(host(rk) - host(rr)).max())
    if e > 1e-5 * max(float(np.abs(host(rr)).max()), 1e-30):
        fail(f"{what}: rhob max abs err {e}")
    walked = int((active & sp.live).sum())
    killed = int((sp.live & ~a.live).sum())
    parked = int(((oa[1] >= P.CUSTOM_BASE) & active & sp.live).sum())
    print(f"compare: {what}: {walked} lanes walked, {killed} killed, "
          f"{parked} parked again; max abs err {max(err, e):.3e}")
    return max(err, e), walked, killed, parked


def move_inputs(torch, P, FP, g, species, fcoef, qms, seed):
    """The reflux walk's inputs at the main path's shapes: a kernel push
    (WALLS) of clones of ``species``; per species the lanes it parked, with
    pend DONE and a new remaining displacement (normal, 0.5 cells), and a
    denser set (every 8th live lane, 1.5 cells) that reaches more faces."""
    from vpic_tpu_torch.utils import push_timing as PT
    walls = P.Walls(torch.zeros(g.nv, device=fcoef.device))
    acc = torch.zeros((g.nv, 12), device=fcoef.device)
    pushed, _, _ = FP.fused_push_multi(PT.clone_species(species), fcoef, acc,
                                       g, qms, walls=walls)
    gen = torch.Generator(device=fcoef.device).manual_seed(seed)
    out = []
    for sp, pend in zip(pushed, walls.pends):
        n = sp.capacity
        parked = (pend >= P.CUSTOM_BASE) & sp.live
        dense = sp.live & (torch.arange(n, device=sp.dx.device) % 8 == 0)
        for active, scale in ((parked, 0.5), (dense | parked, 1.5)):
            disp = tuple(torch.where(active, scale * torch.randn(
                n, generator=gen, device=sp.dx.device), 0.0)
                for _ in range(3))
            out.append((sp, torch.where(active, P.DONE, pend), disp,
                        active))
    return out


def region_deck(vt, shape, ppc, capacity_factor=1.0):
    """A periodic unit box (nz == 1: one cell thick) with an absorbing
    interior box [0.375, 0.625]^d, ppc warm electrons a cell outside it
    (the decks of tests/test_region_pbc.py at a real size), on the card."""
    nx, ny, nz = shape
    lz = 1.0 if nz > 1 else 1.0 / nx
    sim = vt.Simulation(seed=5)
    sim.define_units(1.0, 1.0)
    g0 = vt.partition_periodic_box(0, 0, 0, 1.0, 1.0, lz, nx, ny, nz)
    sim.define_timestep(0.7 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, lz), shape)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    n = int(nx * ny * nz * ppc)
    ele = sim.define_species("electron", -1.0, 1.0,
                             int(n * capacity_factor))

    def inside(x, y, z):
        return (0.375 < x < 0.625) and (0.375 < y < 0.625) and \
            (nz == 1 or 0.375 < z < 0.625)

    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 1, (2 * n, 3)) * [1.0, 1.0, lz]
    out = ~((np.abs(pos[:, 0] - 0.5) < 0.125) & (np.abs(pos[:, 1] - 0.5)
                                                  < 0.125)
            & ((nz == 1) | (np.abs(pos[:, 2] - 0.5) < 0.125)))
    pos = pos[out][:n]
    u = rng.normal(0, 0.3, (n, 3))
    w = lz / n                    # density 1
    for (x, y, z), (ux, uy, uz) in zip(pos.tolist(), u.tolist()):
        sim.inject_particle(ele, x, y, z, ux, uy, uz, w)
    sim.set_region_particle_bc(inside, vt.ABSORB_PARTICLES)
    return sim


def synchronizing(torch, fn):
    """The synchronizing operations fn() makes, as torch's sync debug mode
    warns at each (its own notice that it is a prototype is not one)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [w for w in caught if "synchroniz" in str(w.message)
            and "prototype" not in str(w.message)]


def reset_counts(counters):
    from vpic_tpu_torch import step_graph as SG
    SG.settle()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters):
    """The counts, with the launches of the IF branches the graphed steps
    replayed since the last read added (step_graph.settle, one read)."""
    from vpic_tpu_torch import step_graph as SG
    SG.settle()
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


_STEPS = weakref.WeakKeyDictionary()


def step_of(sim):
    """The deck's make_step(), made once per Simulation here, so a phase's
    runs replay the graphs its earlier runs captured."""
    if sim not in _STEPS:
        _STEPS[sim] = sim.make_step()
    return _STEPS[sim]


# the steps of the last run_steps on a Simulation that ran eagerly: the
# graphed step's warm-ups, or every step of an eager one (the residency
# step's one host read is made by these only)
EAGER = weakref.WeakKeyDictionary()


def run_steps(torch, sim, state, n_steps, counters):
    """n_steps of the deck's step with every kernel count set to 0 just
    before and read just after; returns (state, seconds, launches)."""
    step = step_of(sim)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    sim.host_syncs = 0
    warm = getattr(step, "eager_steps", 0)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state = step(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    EAGER[sim] = (step.eager_steps - warm if step.graphed is True
                  else n_steps)
    return state, elapsed, read_counts(counters)


def check_run(torch, sim, state, e0, what):
    e1 = sim.energies(state).double().cpu().numpy()
    unfinished = int(state.diag["unfinished"])
    drift = abs(e1.sum() - e0.sum()) / e0.sum()
    if unfinished != 0:
        fail(f"{what}: {unfinished} streaks left unfinished")
    if not np.isfinite(e1).all():
        fail(f"{what}: non-finite energies")
    if not drift < 1e-3:
        fail(f"{what}: energy drift {drift}")
    for sp, st in zip(state.species, sim.species):
        if tuple(sp.dx.shape) != (st.params.capacity,) or \
                not torch.isfinite(sp.ux).all():
            fail(f"{what}: particle state has the wrong shape or "
                 "non-finite values")
    return drift, unfinished


def merge_per_step(torch, step, state, n=10):
    """(merge kernel launches, its device ms) per step over n more steps of
    ``step`` from ``state``, from torch.profiler, and the state after
    them."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
    from vpic_tpu_torch.scripts import device_averages
    hits = [e for e in device_averages(prof) if "merge_kernel" in e.key]
    return (sum(e.count for e in hits) / n,
            sum(e.device_time_total for e in hits) / 1e3 / n, state)


def trio_once_a_step(sim, launches, n_steps, what):
    """The step's field advance ran field_beb exactly once a step; returns
    its launches."""
    fields = sim.make_step().fields
    got = launches["field_beb"]
    print(f"{what}: field advance {fields!r}, field_beb launches {got} in "
          f"{n_steps} steps")
    if fields != "field_beb" or got != n_steps:
        fail(f"{what}: field_beb launched {got} times in {n_steps} steps "
             f"(field advance {fields!r})")
    return got


def plain_trio(sim, launches, what):
    """A deck the fused trio does not cover: the plain trio, no field_beb
    launch."""
    fields = sim.make_step().fields
    print(f"{what}: field advance {fields!r}, field_beb launches "
          f"{launches['field_beb']}")
    if not fields.startswith("plain: ") or launches["field_beb"] != 0:
        fail(f"{what}: field advance {fields!r} with "
             f"{launches['field_beb']} field_beb launches")


def field_trio_phase(torch, RF, FF, counters, card, beb_main):
    """Phase 10: the entry point scripts.field_fuse_proto at TRIO_SIZES,
    the kernel against the plain trio; returns field_beb's entry of the
    kernels' line, with the main path's launches (phases 5 and 8)."""
    reset_counts(counters)
    trio = [RF.main(a) for a in TRIO_SIZES]
    launches = read_counts(counters)
    calls = sum(r["kernel_calls"] for r in trio)
    print(f"run field trio: launches {launches}, {calls} fused trios")
    if launches[FF.KERNEL] != calls or calls == 0:
        fail(f"{launches[FF.KERNEL]} field_beb launches for {calls} trios")
    for r in trio:
        nvox = r["shape"][0] * r["shape"][1] * r["shape"][2]
        # 12 arrays read and 9 written; 81 float operations a voxel (3 x 6
        # in each half advance_b, 3 x 15 in advance_e)
        bms, _ = bound_ms((12 + 9) * 4 * nvox, 81 * nvox)
        r["bound"] = (bms, (12 + 9) * 4 * nvox, 81 * nvox)
        if not r["device_ms"] > 0:
            fail(f"field trio {r['shape']}: the profiler saw no kernel")
        if not r["max_abs_err"] <= 1e-6:
            fail(f"field trio {r['shape']}: max abs err {r['max_abs_err']}")
        if r["launches_per_trio"] != 1:
            fail(f"field trio {r['shape']}: {r['launches_per_trio']} "
                 "launches a trio")
        print(f"timing ({card}): field trio {r['shape']}: plain "
              f"{r['plain_ms'][0]:.5f} / {r['plain_ms'][1]:.5f} ms (device "
              f"{r['plain_device_ms']:.5f}, {r['plain_launches_per_trio']:.0f}"
              f" launches) per trio; bound {bms:.6f} ms "
              f"({r['bound'][1] / 1e6:.2f} MB)")
        print(f"  field_beb: {r['ms'][0]:.5f} / {r['ms'][1]:.5f} ms on CUDA "
              f"events, device {r['device_ms']:.6f} ms "
              f"({100 * bms / r['device_ms']:.1f} % of the bound), max abs "
              f"err {r['max_abs_err']:.3e} (best of 3 windows of 100; turns: "
              "kernel, plain, plain, kernel)")
    r = trio[0]
    _, nbytes, flops = r["bound"]
    bms, bby = bound_ms(nbytes, flops)
    return dict(
        name=FF.KERNEL, route="cuda", source="vpic_tpu_torch/csrc/field_beb.cu",
        replaces="scripts/field_fuse_proto.py:41",
        launches=beb_main,
        max_abs_err=max(x["max_abs_err"] for x in trio), ms=r["ms"][0],
        plain_ms=r["plain_ms"][0], bound_ms=bms, bound_by=bby,
        library_ms=None)


def residency_prototypes(counters, card):
    """Phase 9: the entry points scripts.residency_proto and
    residency_grid_bench, each run with the kernel counts set to 0 just
    before and read just after; fails on a kernel not launched or a result
    that differs by a bit.  Returns the kernels' line entries by name."""
    from vpic_tpu_torch.ops import compact as C
    from vpic_tpu_torch.scripts import residency_grid_bench as RG
    from vpic_tpu_torch.scripts import residency_proto as RP

    results = {}
    reset_counts(counters)
    proto = RP.main([])
    launches = read_counts(counters)
    reset_counts(counters)
    grid = RG.main([])
    launches_grid = read_counts(counters)
    print(f"run prototypes: launches {launches} (residency_proto), "
          f"{launches_grid} (residency_grid_bench)")
    if launches[C.KERNEL] == 0 or launches[C.MAILBOX_KERNEL] == 0 or \
            launches_grid[C.KERNEL] == 0 or launches_grid[C.COPY_KERNEL] == 0:
        fail("a compaction, block copy or mailbox kernel was not launched")
    calls = {"compaction (9, 4096)": proto["compaction"],
             "compaction (16, 64 x 4096)": grid["compact"],
             "copy (16, 64 x 4096)": grid["copy"],
             "mailbox 96 x (16, 128)": proto["mailbox"],
             "mailbox into out=": proto["mailbox_out"]}
    if not all(c["bit_exact"] and c["max_abs_err"] == 0.0
               for c in calls.values()):
        fail("a prototype kernel differs from its plain version")
    for what, c in calls.items():
        if "ms" not in c:
            continue
        print(f"timing ({card}): {what}: kernel {c['ms']:.5f} ms (device "
              f"{c['device_ms']:.6f}), plain {c['plain_ms']:.5f}, library "
              f"{c['library_ms']:.5f} ms (device "
              f"{c['library_device_ms']:.6f}) per call; == plain and numpy, "
              "bit for bit (CUDA events, best of 3 windows; device time from "
              "torch.profiler)")
    for variant in ("copy", "compact"):
        c = grid[variant]
        print(f"timing ({card}): {variant} (16, 64 x 4096) after a 64 MB "
              f"write: kernel device {c['cold_device_ms']:.6f} ms, library "
              f"device {c['library_cold_device_ms']:.6f} ms")
    # bytes: each row read and written once, a float mask read once
    compactions = (
        (C.KERNEL, proto["compaction"], launches,
         "scripts/residency_proto.py:42"),
        (C.KERNEL + "_grid", grid["compact"], launches_grid,
         "scripts/residency_grid_bench.py:14, "
         "scripts/residency_grid_bench2.py:12"))
    for name, c, runs, where in compactions:
        R, Pn = c["shape"]
        bms, bby = bound_ms(2 * R * Pn * 4 + Pn * 4, 0)
        results[name] = dict(
            name=name, route="cuda",
            source="vpic_tpu_torch/csrc/compact_block.cu", replaces=where,
            launches=runs[C.KERNEL], max_abs_err=c["max_abs_err"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=bms, bound_by=bby,
            library_ms=c["library_ms"])
    c = grid["copy"]
    R, Pn = c["shape"]
    bms, bby = bound_ms(2 * R * Pn * 4, 0)
    results[C.COPY_KERNEL] = dict(
        name=C.COPY_KERNEL, route="cuda",
        source="vpic_tpu_torch/csrc/compact_block.cu",
        replaces="scripts/residency_grid_bench.py:14 (make(False)), "
                 "scripts/residency_grid_bench2.py:12 (make('copy'))",
        launches=launches_grid[C.COPY_KERNEL], max_abs_err=c["max_abs_err"],
        ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=bms, bound_by=bby,
        library_ms=c["library_ms"])
    c = proto["mailbox"]
    R, M = c["shape"]
    bms, bby = bound_ms(2 * R * M * c["blocks"] * 4 + 4 * c["blocks"], 0)
    results[C.MAILBOX_KERNEL] = dict(
        name=C.MAILBOX_KERNEL, route="cuda",
        source="vpic_tpu_torch/csrc/mailbox.cu",
        replaces="scripts/residency_proto.py:110",
        launches=launches[C.MAILBOX_KERNEL],
        max_abs_err=max(c["max_abs_err"],
                        proto["mailbox_out"]["max_abs_err"]),
        ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=bms, bound_by=bby,
        library_ms=c["library_ms"])
    return results


def wall_phases(torch, counters, card):
    """Phases 11-14 (the decks with wall faces); returns the kernels' line
    entries of the two push kernels' WALLS instances and of the reflux walk
    kernel."""
    import vpic_tpu_torch as vt
    from vpic_tpu_torch import boundary_ops as BO
    from vpic_tpu_torch.models import lpi
    from vpic_tpu_torch.ops import fused_push as FP
    from vpic_tpu_torch.ops import fused_push3d as FP3
    from vpic_tpu_torch.ops import interp as I
    from vpic_tpu_torch.ops import move_p as MP
    from vpic_tpu_torch.ops import push as P
    from vpic_tpu_torch.ops import residency as RES
    from vpic_tpu_torch.scripts import cuda_ms, kernel_device_ms
    from vpic_tpu_torch.utils import push_timing as PT

    results = {}
    # --- phase 11: lpi on the card ---
    sim = lpi.build(lpi.LPIParams(**LPI))
    t0 = time.perf_counter()
    state = sim.initialize()
    torch.cuda.synchronize()
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    n0 = [int(sp.np) for sp in state.species]
    print(f"initialize: lpi 128 x 32 x 16 ppc ({n0} particles) in "
          f"{time.perf_counter() - t0:.1f} s; path {sim.make_step().path}")
    if sim.make_step().path != "push2d" or not P.has_walls(g):
        fail("lpi does not take the 2-D kernel path with its walls")
    sorted_sp = [FP.bucket_sort_p(sp, g, extent=st.count)
                 for sp, st in zip(state.species, sim.species)]
    fcoef = I.load_interpolator(state.fields, g)
    err_w, _, _ = compare_walls(
        torch, PT, P, "2-D kernel (WALLS) vs plain, lpi, first push after "
        "the sort", FP.fused_push_multi, FP.fused_push_multi_ref, g,
        sorted_sp, fcoef, qms)
    walls = P.Walls(torch.zeros(g.nv, device=fcoef.device))
    ms, plain_ms, ms2, plain_ms2 = (
        PT.time_push(fn, g, sorted_sp, fcoef, qms, walls=walls)
        for fn in (FP.fused_push_multi, FP.fused_push_multi_ref) * 2)
    dev_ms = PT.push_device_ms(FP.fused_push_multi, "fused_push2d_kernel",
                               g, sorted_sp, fcoef, qms, walls=walls)
    print(f"timing ({card}): 2-D kernel (WALLS) at lpi {ms:.4f} / "
          f"{ms2:.4f} ms, plain {plain_ms:.4f} / {plain_ms2:.4f} ms per push "
          f"of both species (CUDA events, mean of {PT.REPS}, order "
          "kernel-plain-kernel-plain); kernel device time "
          f"{dev_ms:.5f} ms per push of both species (torch.profiler, "
          f"{PT.REPS} pushes)")
    slots = sum(sp.capacity for sp in sorted_sp)
    live = sum(int(sp.live.sum()) for sp in sorted_sp)
    # + per live lane the pend code and remaining displacement written
    # (slots dead when the push began get none)
    nbytes, flops = push_bytes(sorted_sp, g, slots, extra=16 * live)
    bms, bby = bound_ms(nbytes, flops)
    results["fused_push2d_walls"] = dict(
        name="fused_push2d_walls", route="cuda",
        source="vpic_tpu_torch/csrc/fused_push2d.cu",
        replaces="vpic_tpu/ops/pallas_push.py:251 (wall pre-flag :439-474, "
                 "region mark :461-472, outlier replay :972-1048)",
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
        library_ms=None)
    state, elapsed, launches = run_steps(torch, sim, state, N_STEPS,
                                         counters)
    if launches[FP.KERNEL] != N_STEPS:
        fail(f"lpi: the 2-D push kernel launched {launches[FP.KERNEL]} "
             f"times in {N_STEPS} steps")
    n1 = [int(sp.np) for sp in state.species]
    if n1 != n0 or [int(sp.live.sum()) for sp in state.species] != n0:
        fail(f"lpi: {n0} particles became {n1} (reflux keeps them all)")
    en = sim.energies(state)
    if not torch.isfinite(en).all() or not all(
            torch.isfinite(sp.ux).all() for sp in state.species):
        fail("lpi: non-finite energies or momenta")
    results["fused_push2d_walls"]["launches"] = launches[FP.KERNEL]
    plain_trio(sim, launches, "lpi")
    walks = len(sim.pbc_handlers) * len(state.species) * N_STEPS
    if launches[MP.KERNEL] != walks:
        fail(f"lpi: the reflux walk kernel launched {launches[MP.KERNEL]} "
             f"times in {N_STEPS} steps, not once per handler call "
             f"({walks})")
    print(f"run lpi: {N_STEPS} steps, {sum(n0)} particles kept, "
          f"{elapsed * 1e3 / N_STEPS:.3f} ms/step ({card}, host clock around "
          f"synchronize); launches {launches}; field energy "
          f"{float(en[:6].sum()):.4e}, max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    step = step_of(sim)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n_win = 20
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_win):
            state = step(state)
        torch.cuda.synchronize()
        win_ms = (time.perf_counter() - t0) * 1e3 / n_win
    from vpic_tpu_torch.scripts import device_averages
    kern = device_averages(prof)
    busy = sum(e.device_time_total for e in kern) / 1e3 / n_win
    push_dev, move_dev = (sum(e.device_time_total for e in kern
                              if name in e.key) / 1e3 / n_win
                          for name in ("fused_push2d_kernel",
                                       "move_p_kernel"))
    print(f"run lpi: over {n_win} profiled steps {win_ms:.3f} ms/step, "
          f"{sum(e.count for e in kern) / n_win:.1f} kernel launches a step, "
          f"device busy {busy:.4f} ms/step ({100 * busy / win_ms:.1f} % of "
          f"the window), push kernel {push_dev:.5f} device ms/step, reflux "
          f"walk kernel {move_dev:.5f} (torch.profiler; {card})")

    # the walled step reads nothing back from the card: not one
    # synchronizing operation (torch's sync debug mode warns at each);
    # a read of the card must be seen, or the check below proves nothing
    if not synchronizing(torch, lambda: int(state.species[0].np)):
        fail("torch's sync debug mode did not see a device read")
    box = {"state": state}

    def two_steps():
        for _ in range(2):
            box["state"] = step(box["state"])

    syncs = synchronizing(torch, two_steps)
    state = box["state"]
    print(f"run lpi: {len(syncs)} synchronizing operations in 2 more steps "
          "(torch.cuda.set_sync_debug_mode)")
    if syncs:
        fail(f"lpi: the step synchronizes with the card: {syncs[0].message} "
             f"({syncs[0].filename}:{syncs[0].lineno})")

    # the reflux walk kernel against its plain version at lpi's shapes:
    # the lanes the push parks, and a denser set that reaches more faces
    fcoef = I.load_interpolator(state.fields, g)
    inputs = move_inputs(torch, P, FP, g, list(state.species), fcoef, qms,
                         seed=7)
    err_m = 0.0
    for j, (sp, pend, disp, active) in enumerate(inputs):
        which = "the lanes the push parked" if j % 2 == 0 else \
            "every 8th lane"
        err_m = max(err_m, compare_move(
            torch, PT, P, MP, f"move_p vs plain, lpi species {j // 2}, "
            f"{which}", g, sp, pend, disp, active, qms[j // 2][0])[0])
    sp, pend, disp, active = inputs[0]
    box = {}

    def setup():
        box.update(sp=PT.clone_species([sp])[0], pend=pend.clone(),
                   disp=tuple(d.clone() for d in disp),
                   acc=torch.zeros((g.nv, 12), device=fcoef.device),
                   rhob=torch.zeros(g.nv, device=fcoef.device))

    def walk(f):
        return lambda: f(box["sp"], box["pend"], box["disp"], box["acc"],
                         box["rhob"], g, qms[0][0], active)

    m_ms, m_plain, m_ms2, m_plain2 = (
        cuda_ms(walk(f), PT.REPS, setup)
        for f in (MP.move_p, MP.move_p_ref) * 2)
    m_dev = kernel_device_ms(walk(MP.move_p), "move_p_kernel", PT.REPS,
                             setup)
    walked = int((active & sp.live).sum())
    print(f"timing ({card}): move_p at lpi species 0 ({sp.capacity} slots, "
          f"{walked} lanes walking) {m_ms:.4f} / {m_ms2:.4f} ms, plain "
          f"{m_plain:.4f} / {m_plain2:.4f} ms (CUDA events, input restored "
          f"before each call, best of windows of {PT.REPS}); kernel device "
          f"time {m_dev:.5f} ms (torch.profiler)")
    # the live and active flags of every slot; per walking lane 8 words,
    # its pend code and displacement read and written back (7 words), and
    # at least one deposit round's 12 currents read and written
    bms, bby = bound_ms(2 * sp.capacity + walked * (48 + 44 + 96),
                        walked * 40)
    results["move_p"] = dict(
        name="move_p", route="cuda", source="vpic_tpu_torch/csrc/move_p.cu",
        replaces="vpic_tpu/boundary_ops.py:31 (_continue_walk, the reflux "
                 "walk: plain jnp, no TPU kernel)",
        launches=launches[MP.KERNEL], max_abs_err=err_m, ms=m_ms,
        plain_ms=m_plain, bound_ms=bms, bound_by=bby, library_ms=None)
    parked = torch.zeros((), dtype=torch.int64,
                         device=state.fields.ex.device)

    def counting(h):
        def spy(gen, sp, pend, *rest):
            parked.add_(((pend == P.CUSTOM_BASE + rest[5])
                         & sp.live).sum())
            return h(gen, sp, pend, *rest)
        spy.in_place = True
        return spy

    handlers = sim.pbc_handlers
    sim.pbc_handlers = {k: counting(h) for k, h in handlers.items()}
    step = step_of(sim)
    for _ in range(n_win):
        state = step(state)
    sim.pbc_handlers = handlers
    print(f"run lpi: {int(parked) / n_win:.1f} lanes parked at the reflux "
          f"walls a step ({n_win} more steps)")
    err_w = max(err_w, compare_walls(
        torch, PT, P, f"2-D kernel (WALLS) vs plain, lpi after "
        f"{N_STEPS + 2 * n_win} steps", FP.fused_push_multi,
        FP.fused_push_multi_ref, g, list(state.species),
        I.load_interpolator(state.fields, g), qms)[0])
    del sim, state, sorted_sp, fcoef, step

    # --- phase 12: a 2-D deck with an absorbing region, 128^2 ---
    sim = region_deck(vt, *REGION_2D)
    state = sim.initialize()
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    n0 = int(state.species[0].np)
    state, elapsed, launches = run_steps(torch, sim, state, 10, counters)
    n1 = int(state.species[0].np)
    print(f"run 2-D region: 10 steps of {n0} particles, {n0 - n1} absorbed "
          f"at the region, {elapsed * 1e2:.3f} ms/step; launches {launches}")
    if launches[FP.KERNEL] != 10 or not 0 < n0 - n1 or \
            n1 != int(state.species[0].live.sum()):
        fail("2-D region deck: the kernel did not run, or nothing was "
             "absorbed, or np is not the live count")
    err_w = max(err_w, compare_walls(
        torch, PT, P, "2-D kernel (WALLS) vs plain, 128^2 x 16 ppc region "
        "deck after 10 steps", FP.fused_push_multi, FP.fused_push_multi_ref,
        g, list(state.species), I.load_interpolator(state.fields, g), qms,
        vbc=sim._local_vbc())[0])
    results["fused_push2d_walls"]["max_abs_err"] = err_w
    del sim, state

    # --- phase 13: a 3-D deck with an absorbing region, residency ---
    t0 = time.perf_counter()
    sim = region_deck(vt, *REGION_3D, capacity_factor=1.5)
    state = sim.initialize()
    torch.cuda.synchronize()
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    res_on, slack = sim._residency_mode()
    if sim.make_step().path != "push3d" or not res_on:
        fail("the 3-D region deck does not take the residency path")
    n0 = int(state.species[0].np)
    print(f"initialize: 32^3 x 32 ppc region deck ({n0} particles, "
          f"residency slack {slack}) in {time.perf_counter() - t0:.1f} s")
    state, elapsed, launches = run_steps(torch, sim, state, 20, counters)
    n1 = int(state.species[0].np)
    rebuckets = int(state.diag["_res_rebuckets"])
    print(f"run 3-D region: 20 steps, {n0 - n1} absorbed at the region, "
          f"{elapsed * 50:.3f} ms/step, rebuckets {rebuckets}, host syncs "
          f"{sim.host_syncs}; launches {launches}")
    if launches[FP3.KERNEL] != 20 or launches[RES.KERNEL] != 20 - rebuckets \
            or not 0 < n0 - n1 or n1 != int(state.species[0].live.sum()):
        fail("3-D region deck: a kernel did not run as the step should, or "
             "nothing was absorbed, or np is not the live count")
    exts = RES.extents(g, [st.count for st in sim.species], slack)
    species = [RES.slice_species(sp, E)
               for sp, E in zip(state.species, exts)]
    homes = [state.diag[f"_chart_home{k}"] for k in range(len(species))]
    fcoef = I.load_interpolator(state.fields, g)
    vbc = sim._local_vbc()
    kw = dict(homes=homes, residency=True)
    err3w, _, _ = compare_walls(
        torch, PT, P, "3-D kernel (WALLS) with its residency outbox vs "
        "plain, 32^3 x 32 ppc region deck after 20 steps",
        FP3.fused_push3d_multi, FP3.fused_push3d_multi_ref, g, species,
        fcoef, qms, vbc=vbc, **kw)
    walls = P.Walls(torch.zeros(g.nv, device=fcoef.device), vbc)
    ms3, plain3, ms3b, plain3b = (
        PT.time_push(fn, g, species, fcoef, qms, walls=walls, **kw)
        for fn in (FP3.fused_push3d_multi, FP3.fused_push3d_multi_ref) * 2)
    dev3 = PT.push_device_ms(FP3.fused_push3d_multi, "fused_push3d_kernel",
                             g, species, fcoef, qms, walls=walls, **kw)
    print(f"timing ({card}): 3-D kernel (WALLS) at the region deck "
          f"{ms3:.4f} / {ms3b:.4f} ms, plain {plain3:.4f} / {plain3b:.4f} ms "
          f"per push (CUDA events, mean of {PT.REPS}, order "
          "kernel-plain-kernel-plain); kernel device time "
          f"{dev3:.5f} ms per push (torch.profiler, {PT.REPS} pushes)")
    slots = sum(sp.capacity for sp in species)
    live = sum(int(sp.live.sum()) for sp in species)
    M = sum(-(-sp.capacity // FP3.BLOCK) for sp in species) * FP3.OUT_CAP
    # + the emit marks and outbox, and per live lane the wall outputs; the
    # vbc rows are read only where a lane crosses a face, and left out
    nbytes, flops = push_bytes(species, g, slots,
                               extra=slots + M * 33 + 4 * (M // 128)
                               + 16 * live)
    bms, bby = bound_ms(nbytes, flops)
    results["fused_push3d_walls"] = dict(
        name="fused_push3d_walls", route="cuda",
        source="vpic_tpu_torch/csrc/fused_push3d.cu",
        replaces="vpic_tpu/ops/pallas_push3d.py:369 (pre-flag :550-576, "
                 "region mark :578-590)",
        launches=launches[FP3.KERNEL], max_abs_err=err3w, ms=ms3,
        plain_ms=plain3, bound_ms=bms, bound_by=bby, library_ms=None)
    del sim, state, species, fcoef

    # --- phase 14: the general path (a 3-D grid the bricks do not tile) ---
    t0 = time.perf_counter()
    sim = region_deck(vt, *REGION_GENERAL)
    reflux = BO.maxwellian_reflux({"electron": 0.3}, {"electron": 0.3})
    for face in (0, 3):
        sim.set_domain_particle_bc(face, reflux)
    state = sim.initialize()
    torch.cuda.synchronize()
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    if sim.make_step().path != "general" or FP3.supports3d(g):
        fail("the general-path deck does not take the general path")
    n0 = int(state.species[0].np)
    print(f"initialize: {g.nx}x{g.ny}x{g.nz} general-path deck ({n0} "
          f"particles, reflux x walls, absorbing region) in "
          f"{time.perf_counter() - t0:.1f} s")
    n_gen = 10
    state, elapsed, launches = run_steps(torch, sim, state, n_gen, counters)
    n1 = int(state.species[0].np)
    walks = len(sim.pbc_handlers) * (1 + sim.num_comm_round) * n_gen
    print(f"run general path: {n_gen} steps, {n0 - n1} absorbed at the "
          f"region, {elapsed * 1e3 / n_gen:.3f} ms/step; launches {launches}")
    if launches[FP3.KERNEL] != n_gen or launches[MP.KERNEL] != walks or \
            not 0 < n0 - n1 or n1 != int(state.species[0].live.sum()) or \
            not torch.isfinite(sim.energies(state)).all():
        fail("general path: the 3-D kernel did not push once a step, or the "
             "reflux walk kernel not once per handler run, or nothing was "
             "absorbed, or np is not the live count, or non-finite energies")
    err_g, _, _ = compare_walls(
        torch, PT, P, f"3-D kernel (WALLS) without home maps vs plain, the "
        f"general path after {n_gen} steps", FP3.fused_push3d_multi,
        FP3.fused_push3d_multi_ref, g, list(state.species),
        I.load_interpolator(state.fields, g), qms, vbc=sim._local_vbc())
    results["fused_push3d_walls"]["max_abs_err"] = max(err3w, err_g)
    # the general path's eager step makes no synchronizing operation, so
    # step_graph captures it (its run above was graphed)
    eager = sim.make_advance()
    box = {"state": state}

    def two_steps():
        for _ in range(2):
            box["state"] = eager(box["state"])

    syncs = synchronizing(torch, two_steps)
    graphed = step_of(sim).graphed
    print(f"general path: {len(syncs)} synchronizing operations in 2 eager "
          f"steps (torch's sync debug mode); make_step().graphed {graphed}")
    if syncs or graphed is not True:
        fail(f"general path: {syncs[0].message if syncs else graphed}")
    del sim, state, box, eager

    return results


def _load_read_dumps():
    """utilities/read_dumps.py, loaded by path (as tests/test_io_diag.py
    does)."""
    import importlib.util
    path = os.path.join(ROOT, "utilities", "read_dumps.py")
    spec = importlib.util.spec_from_file_location("read_dumps", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _energy_rows(path):
    """{step: energies row} of an energies file."""
    rows = np.loadtxt(path, comments="%", ndmin=2)
    return {int(r[0]): r[1:] for r in rows}


def _timed(torch, fn):
    """(fn's result, ms), the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _same_fields(a, b, what, names=("jfx", "ex", "ey", "cbz")):
    """Fields to the ten-step tolerances (test_pallas.py:88-94)."""
    for n in names:
        x = getattr(a.fields, n).cpu().numpy()
        y = getattr(b.fields, n).cpu().numpy()
        err = np.abs(x - y).max()
        if not err < 5e-7 + 1e-5 * np.abs(x).max():
            fail(f"{what}: field {n} max abs err {err}")


def io_phases(torch, counters, card):
    """Phases 15-17: the deck runner on the card with a restart and the
    dumps, the 3-D restart on the residency path, and the shapes deck."""
    import shutil
    from vpic_tpu_torch import __main__ as CLI
    from vpic_tpu_torch import checkpoint as CK
    from vpic_tpu_torch import dump as DU
    from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
    from vpic_tpu_torch.models import harris, shapes
    from vpic_tpu_torch.ops import field_fuse as FF
    from vpic_tpu_torch.ops import fused_push as FP
    from vpic_tpu_torch.ops import fused_push3d as FP3
    from vpic_tpu_torch.ops import hydro as H
    from vpic_tpu_torch.ops import residency as RES

    RD = _load_read_dumps()
    tmp = os.path.join(ROOT, "build", "chip_smoke_io")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    # --- phase 15: python -m vpic_tpu_torch harris, restarted ---
    n, half = CLI_STEPS, CLI_STEPS // 2
    e1, e2 = os.path.join(tmp, "E1"), os.path.join(tmp, "E2")
    ck = os.path.join(tmp, "ck")
    reset_counts(counters)
    (sim, state), ms_run = _timed(torch, lambda: CLI.main(
        ["harris", "--num-step", str(n), "--energies", e1,
         "--checkpt", f"{ck}:{half}"]))
    launches = read_counts(counters)
    reset_counts(counters)
    (sim2, state2), ms_rst = _timed(torch, lambda: CLI.main(
        ["harris", "--num-step", str(n), "--restore", f"{ck}.{half}",
         "--energies", e2]))
    launches2 = read_counts(counters)
    g = sim.grid
    if (g.nx, g.ny, g.nz) != (64, 64, 1) or \
            sum(st.count for st in sim.species) != 262144:
        fail("the CLI harris deck is not 64^2 x 64 ppc")
    print(f"run CLI: python -m vpic_tpu_torch harris --num-step {n} "
          f"--energies --checkpt ck:{half}: {ms_run / 1e3:.1f} s (deck "
          f"build and initialize included); launches {launches}; restart "
          f"from ck.{half}: {ms_rst / 1e3:.1f} s, launches {launches2} "
          f"({card})")
    if launches[FP.KERNEL] != n or launches2[FP.KERNEL] != n - half:
        fail(f"CLI harris: the 2-D push kernel launched "
             f"{launches[FP.KERNEL]} times in {n} steps and "
             f"{launches2[FP.KERNEL]} in the restart's {n - half}")
    rows1, rows2 = _energy_rows(e1), _energy_rows(e2)
    drift, _ = check_run(torch, sim, state, rows1[0], "CLI harris run")
    check_run(torch, sim2, state2, rows1[0], "CLI harris restart")
    en1 = sim.energies(state).double().cpu().numpy()
    en2 = sim2.energies(state2).double().cpu().numpy()
    err = np.abs(en1 - en2).max() / en1.sum()
    common = sorted(set(rows1) & set(rows2) - {half})
    err_rows = max(np.abs(rows1[k] - rows2[k]).max() / rows1[k].sum()
                   for k in common)
    np1 = [int(sp.np) for sp in state.species]
    np2 = [int(sp.np) for sp in state2.species]
    print(f"run CLI: step {n} energies, restart vs uninterrupted: max "
          f"column error {err:.3e} of the total (limit {RESTART_RTOL:g}); "
          f"energies file rows {common}: {err_rows:.3e}; drift {drift:.3e}; "
          f"particles {np1} vs {np2} ({card})")
    if not err <= RESTART_RTOL or not err_rows <= RESTART_RTOL or np1 != np2:
        fail("CLI harris: the restart parts from the uninterrupted run")
    # the restore alone, and the checkpoint's size and times
    _, ms_restore = _timed(torch, lambda: CK.restore(f"{ck}.{half}",
                                                     sim=sim2))
    name, ms_ck = _timed(torch, lambda: CK.checkpt(
        state, os.path.join(tmp, "timed"), sim=sim))
    ck_bytes = os.path.getsize(name + ".npz")
    print(f"timing ({card}): checkpoint {ms_ck:.1f} ms, {ck_bytes} bytes "
          f"(npz, compressed); restore {ms_restore:.1f} ms")
    # the dumps at the last step, read back
    st_, sp0, sp1 = state, sim.species[0].params, sim.species[1].params
    dumps = [("fields", lambda: DU.dump_fields(sim, st_, f"{tmp}/fields"))]
    for spp in (sp0, sp1):
        dumps += [
            (f"hydro {spp.name}", lambda spp=spp: DU.dump_hydro(
                sim, st_, spp.name, f"{tmp}/{spp.name}_hydro")),
            (f"particles {spp.name}", lambda spp=spp: DU.dump_particles(
                sim, st_, spp.name, f"{tmp}/{spp.name}_particles"))]
    dumps.append(("grid", lambda: DU.dump_grid(sim, f"{tmp}/grid")))
    files = {}
    for what, fn in dumps:
        names, ms = _timed(torch, fn)
        files[what] = names[0]
        print(f"timing ({card}): dump {what} at step {st_.step}: {ms:.1f} "
              f"ms, {os.path.getsize(names[0])} bytes")
    hdr, fields = RD.read_fields(files["fields"])
    if hdr["step"] != st_.step or not np.array_equal(
            fields["ey"], state.fields.ey.cpu().numpy()):
        fail("dump_fields does not read back")
    for k, spp in enumerate((sp0, sp1)):
        _, parts = RD.read_particles(files[f"particles {spp.name}"])
        _, hyd = RD.read_hydro(files[f"hydro {spp.name}"])
        if len(parts) != np1[k] or not np.isfinite(hyd["rho"]).all() or \
                not np.abs(hyd["rho"]).max() > 0:
            fail(f"the {spp.name} dumps do not read back")
    with open(files["grid"], "rb") as fh:
        if RD.read_header(fh)["nx"] != g.nx:
            fail("dump_grid does not read back")
    # the card's hydro against the plain hydro of the same state on the CPU
    cpu = state_from_numpy(state_to_numpy(state), device="cpu")
    for k, spp in enumerate((sp0, sp1)):
        h_gpu = H.compute_hydro(sim, state, k).cpu().numpy()
        h_cpu = H.compute_hydro(sim, cpu, k).numpy()
        e = np.abs(h_gpu - h_cpu).max()
        print(f"hydro {spp.name}: card vs CPU max abs err {e:.3e}, max "
              f"|moment| {np.abs(h_cpu).max():.3e} ({card})")
        if not e <= 1e-5 * np.abs(h_cpu).max():
            fail(f"hydro {spp.name}: the card differs from the CPU")
    # ms/step with and without the I/O cadence, over 2 x 2 status intervals
    # more steps (after the dumps: the steps update the fields in place)
    status = sim.status_interval
    state, ms_io = _timed(torch, lambda: sim.run(
        state, num_step=n + 2 * status, energies_file=e1,
        checkpt_base=os.path.join(tmp, "cad"), checkpt_interval=2 * status,
        verbose=False))
    state, ms_plain = _timed(torch, lambda: sim.run(
        state, num_step=n + 4 * status, verbose=False))
    print(f"timing ({card}): {ms_io / (2 * status):.3f} ms/step with the "
          f"I/O cadence (energies every {status} steps, a checkpoint every "
          f"{2 * status}), {ms_plain / (2 * status):.3f} ms/step without "
          f"(host clock, {2 * status} steps each)")
    del sim, state, sim2, state2, cpu

    # --- phase 16: the 3-D restart on the residency path ---
    p3 = harris.HarrisParams(nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0,
                             Lz=8.0, headroom=6.0)
    sim = harris.build(p3)
    if not sim._residency_mode()[0]:
        fail("the 16^3 harris deck does not take the residency path")
    step = step_of(sim)
    state = sim.initialize()
    for _ in range(10):
        state = step(state)
    base, ms_ck = _timed(torch, lambda: CK.checkpt(
        state, os.path.join(tmp, "ck3"), sim=sim))
    rebuckets = int(state.diag["_res_rebuckets"])
    for _ in range(10):
        state = step(state)
    sim2 = harris.build(p3)
    back, ms_restore = _timed(torch, lambda: CK.restore(base, sim=sim2))
    if back.diag["_res_valid"] is not True or \
            int(back.diag["_res_rebuckets"]) != rebuckets:
        fail("3-D restore: the residency layout was not restored")
    back, _, launches = run_steps(torch, sim2, back, 10, counters)
    print(f"run 3-D restart: 16^3 x 4 ppc harris, checkpoint at step 10 "
          f"({os.path.getsize(base + '.npz')} bytes, {ms_ck:.1f} ms), "
          f"restore {ms_restore:.1f} ms, 10 steps after it: launches "
          f"{launches}, rebuckets {rebuckets} -> "
          f"{int(back.diag['_res_rebuckets'])} ({card})")
    if launches[FP3.KERNEL] != 10 or launches[RES.KERNEL] != 10 or \
            int(back.diag["_res_rebuckets"]) != rebuckets:
        fail("3-D restart: the push and the merge kernels were not "
             "launched once a step, or it rebucketed")
    _same_fields(state, back, "3-D restart")
    for k, (a, b) in enumerate(zip(state.species, back.species)):
        va = np.bincount(a.i[a.live].cpu().numpy(), minlength=g.nv)
        vb = np.bincount(b.i[b.live].cpu().numpy(), minlength=g.nv)
        moved = int(np.abs(va - vb).sum()) // 2
        if int(a.np) != int(b.np) or moved > max(1, int(a.np) // 100_000):
            fail(f"3-D restart: species {k} lanes differ ({moved} voxels)")
    ea = sim.energies(state).double().cpu().numpy()
    eb = sim2.energies(back).double().cpu().numpy()
    if not np.abs(ea - eb).max() / ea.sum() < 1e-6:
        fail("3-D restart: energies differ")
    print("run 3-D restart: lanes (live counts, voxel multisets), fields "
          "and energies equal the uninterrupted run's to the ten-step "
          "tolerances")
    del sim, state, sim2, back

    # --- phase 17: shapes (region materials) on the card and the CPU ---
    runs = []
    for dev in ("cuda", "cpu"):
        sim = shapes.build(device=dev)
        state = sim.initialize()
        step = step_of(sim)
        beb0 = FF.launches
        inner = (slice(1, -1),) * 3
        inside = torch.from_numpy(sim._mat_ids["cmat"][inner] == 2).to(dev)
        hist = []
        t0 = time.perf_counter()
        for _ in range(SHAPES_STEPS):
            state = step(state)
            f = state.fields
            dens = sum(getattr(f, c)[inner] ** 2
                       for c in ("ex", "ey", "ez", "cbx", "cby", "cbz"))
            hist.append((float(sim.energies(state).sum()),
                         float(dens[inside].sum() / dens.sum())))
        runs.append((sim, state, hist, time.perf_counter() - t0))
        if dev == "cuda":
            plain_trio(sim, {FF.KERNEL: FF.launches - beb0}, "shapes")
    (sim, state, hist, sec), (sim_c, cpu, _, sec_c) = runs
    _same_fields(cpu, state, "shapes card vs CPU",
                 ("ex", "ey", "ez", "cbx", "cby", "cbz"))
    e0 = float(sim.energies(sim.initialize()).sum())
    window = [e for e, share in hist if share > 0.25]
    print(f"run shapes: 64 x 16 cells, eps 4 slab, sigma 2 block, "
          f"{SHAPES_STEPS} steps on the card ({sec * 1e3 / SHAPES_STEPS:.3f} "
          f"ms/step with a host read of the energies each step; CPU "
          f"{sec_c * 1e3 / SHAPES_STEPS:.3f}; {card}): fields == CPU to the "
          f"ten-step tolerances; energy {e0:.6f} -> {hist[-1][0]:.6f}; "
          f"{len(window)} steps with over a quarter of it in the conductor")
    if len(window) < 5 or any(b > a for a, b in zip(window, window[1:])) \
            or not hist[-1][0] < 0.5 * e0:
        fail("shapes: the energy rose while the pulse was in the "
             "conductor, or the conductor did not take it")
    try:
        FF.make_beb(sim.grid, sim._material_coeffs(), sim.damp)
        fail("shapes: make_beb accepted mesh coefficients")
    except NotImplementedError as e:
        print(f"run shapes: make_beb refuses the coefficients ({e})")
    shutil.rmtree(tmp, ignore_errors=True)


def _device_sum(kernels):
    """(launches, device ms) summed over device_kernels' entries."""
    return (sum(c for c, _ in kernels.values()),
            sum(ms for _, ms in kernels.values()))


def stochastic_phases(torch, counters, card, results):
    """Phases 18-21: the collision ops, card against CPU and timed; the
    collisional reconnection deck at 32^3 x 128 ppc on the residency path;
    the emission diode; aged injection.  Adds the runs' launches to the
    kernels' line entries of the kernels they ran; returns the
    reconnection run's drift."""
    import vpic_tpu_torch as vt
    from vpic_tpu_torch import boundary_ops as BO
    from vpic_tpu_torch.models import emission, reconnection
    from vpic_tpu_torch.ops import field_fuse as FF
    from vpic_tpu_torch.ops import fused_push as FP
    from vpic_tpu_torch.ops import fused_push3d as FP3
    from vpic_tpu_torch.ops import move_p as MP
    from vpic_tpu_torch.ops import residency as RES
    from vpic_tpu_torch.ops import ta_collide as TA
    from vpic_tpu_torch.scripts import cuda_ms, device_kernels
    from vpic_tpu_torch.scripts import stochastic_checks as SC

    # --- phase 18: the collision ops, card against CPU, timed ---
    t_phase = time.perf_counter()
    g = SC.collision_grid()
    n = COLL_N
    host = [SC.collision_species(n, g, seed=0),
            SC.collision_species(n, g, seed=1)]
    on_card = SC.to(host, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for name, op in SC.collision_ops(g, n).items():
        try:
            err = SC.compare_collision_op(op, host, g, "cuda")
        except AssertionError as e:
            fail(f"collision op {name}, card vs CPU: {e}")
        if getattr(op, "has_diag", False):
            call = lambda op=op: op(on_card, None, g, 0, gen, {})
        else:
            call = lambda op=op: op(on_card, None, g, 0, gen)
        syncs = synchronizing(torch, call)
        if syncs:
            fail(f"collision op {name} synchronizes with the card: "
                 f"{syncs[0].message}")
        ms = cuda_ms(call, 10)
        launches, dev = _device_sum(device_kernels(call, 5))
        route = f"route {op.route}; " if hasattr(op, "route") else ""
        print(f"collision {name}: {route}card == CPU with the same draws "
              f"(permutation, live, voxels, weights equal; momenta max abs "
              f"err {err:.3e}, tolerance {SC.MOM_RTOL} max|u|); {ms:.4f} ms "
              f"(CUDA events, draws included) = {n / ms / 1e3:.1f} M "
              f"particle-collisions/s, device {dev:.4f} ms in {launches:.0f} "
              f"launches per application, 0 synchronizing operations "
              f"({n} lanes, 16^3 cells; {card})")
    del host, on_card
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")

    # --- phase 19: collisional reconnection, 32^3 x 128 ppc, tau 5 ---
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sim = reconnection.build(reconnection.ReconnectionParams(**RECON))
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = sim.initialize()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    g = sim.grid
    res_on, slack = sim._residency_mode()
    tau = sim.collision_ops[0].interval
    if not res_on or sim.make_step().path != "push3d":
        fail("reconnection 32^3 x 128 does not take the residency path")
    n0 = [int(sp.np) for sp in state.species]
    print(f"initialize: reconnection 32^3 x 128 ppc ({n0} particles, "
          f"{len(sim.collision_ops)} T&A ops every {tau} steps), deck build "
          f"(host staging) {t_build:.1f} s, initialize() {t_init:.1f} s; "
          f"residency slack {slack} blocks per brick")
    e0 = sim.energies(state).double().cpu().numpy()
    ptrs = [[getattr(sp, k).data_ptr() for k in FP3.LANE_FIELDS]
            for sp in state.species]
    sim.relayouts = 0
    causes0 = RES.rebuckets_by_cause()
    state, elapsed, launches = run_steps(torch, sim, state, RECON_STEPS,
                                         counters)
    firings = sum(1 for k in range(RECON_STEPS) if k % tau == 0)
    post = int(state.diag["_res_rebuckets"])
    causes = {k: v - causes0[k] for k, v in RES.rebuckets_by_cause().items()}
    e1 = sim.energies(state).double().cpu().numpy()
    drift = abs(e1.sum() - e0.sum()) / e0.sum()
    n1 = [int(sp.np) for sp in state.species]
    unfinished = int(state.diag["unfinished"])
    print(f"run reconnection: {RECON_STEPS} steps, "
          f"{elapsed * 1e3 / RECON_STEPS:.3f} ms/step ({card}, host clock "
          f"around synchronize); launches {launches}; rebuckets before the "
          f"push {sim.relayouts} ({firings} firing steps), after it {post} "
          f"({(sim.relayouts + post) / RECON_STEPS:.2f} a step; by cause "
          f"{causes}); host syncs "
          f"{sim.host_syncs}; unfinished {unfinished}; energy drift "
          f"{drift:.3e} (bound 3e-2); max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if launches[FP3.KERNEL] != RECON_STEPS:
        fail(f"reconnection: the 3-D push kernel launched "
             f"{launches[FP3.KERNEL]} times in {RECON_STEPS} steps")
    if sim.relayouts != firings:
        fail(f"reconnection: {sim.relayouts} rebuckets before the push for "
             f"{firings} collision firings")
    if sum(causes.values()) != post:
        fail(f"reconnection: {post} rebuckets after the push, {causes} by "
             "cause")
    if launches[RES.KERNEL] != RECON_STEPS - post:
        fail(f"reconnection: {launches[RES.KERNEL]} merges with {post} "
             f"rebuckets after the push in {RECON_STEPS} steps")
    # an order pass a species an op shuffles and a pair kernel an op
    ta_firing = sum(TA.ORDER_LAUNCHES * len(set(op.pair)) + 1
                    for op in sim.collision_ops)
    if launches[TA.KERNEL] != ta_firing * firings or \
            any(op.route != "cuda" for op in sim.collision_ops):
        fail(f"reconnection: the T&A kernels launched {launches[TA.KERNEL]} "
             f"times in {firings} firings of {ta_firing}; routes "
             f"{[op.route for op in sim.collision_ops]}")
    if sim.host_syncs != EAGER[sim]:
        fail(f"reconnection: {sim.host_syncs} host syncs in {RECON_STEPS} "
             f"steps, {EAGER[sim]} of them eager")
    if ptrs != [[getattr(sp, k).data_ptr() for k in FP3.LANE_FIELDS]
                for sp in state.species]:
        fail("reconnection: the species tensors changed storage")
    if n1 != n0 or unfinished != 0:
        fail(f"reconnection: particles {n0} -> {n1}, {unfinished} streaks "
             "unfinished")
    if not np.isfinite(e1).all() or not drift < 3e-2:
        fail(f"reconnection: energy drift {drift} (bound 3e-2)")
    results[FF.KERNEL]["launches"] += trio_once_a_step(
        sim, launches, RECON_STEPS, "reconnection")
    results[FP3.KERNEL]["launches"] += launches[FP3.KERNEL]
    results[RES.KERNEL]["launches"] += launches[RES.KERNEL]
    print(f"run reconnection: the T&A kernels launched {launches[TA.KERNEL]} "
          f"times in {firings} firings ({ta_firing} a firing), routes "
          f"{[op.route for op in sim.collision_ops]}")
    # one collision cycle under the profiler: launches and device time a
    # step, and the device's busy share against the host clock's ms/step
    step = step_of(sim)
    while state.step % tau:
        state = step(state)
    box = {"state": state}

    def cycle():
        for _ in range(tau):
            box["state"] = step(box["state"])

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        cycle()
        torch.cuda.synchronize()
    from vpic_tpu_torch.scripts import device_averages
    evs = device_averages(prof)
    step_launches = sum(e.count for e in evs) / tau
    step_dev = sum(e.device_time_total for e in evs) / 1e3 / tau
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cycle()
    torch.cuda.synchronize()
    cycle_ms = (time.perf_counter() - t0) * 1e3 / tau
    # the collision stage alone: the three ops firing on the state
    state = box["state"]
    stage_in = list(state.species)

    def stage():
        sp, d = stage_in, {}
        for op in sim.collision_ops:
            sp, d = op(sp, state.fields, g, 0, sim._generator, d)
        return sp

    coll_launches, coll_dev = _device_sum(device_kernels(stage, 2))
    coll_ms = cuda_ms(stage, 3)
    print(f"run reconnection: one {tau}-step cycle: {cycle_ms:.3f} ms/step "
          f"(host clock), device {step_dev:.3f} ms and {step_launches:.0f} "
          f"launches a step (torch.profiler), busy share "
          f"{100 * step_dev / cycle_ms:.1f} %; the collision stage (3 T&A "
          f"ops, one firing) {coll_ms:.3f} ms (CUDA events), device "
          f"{coll_dev:.3f} ms in {coll_launches:.0f} launches = "
          f"{100 * coll_dev / tau / step_dev:.1f} % of the device time a "
          f"step amortized ({card})")
    # each op by route on the state after the cycle, from the same draws:
    # the hand kernels against the plain op, in turns; the plain
    # interspecies op's j-side index_add_ with its dead i-lanes and without;
    # a firing's bound counted as benchmark/metrics/collision_roofline_pct
    # counts it (9 words a live lane an op touches, 4 a pair)
    torch.cuda.synchronize()
    wide0 = TA.wide_lanes()
    sp_in = list(stage_in)
    ta = dict(err=0.0, ms=0.0, plain_ms=0.0, words=0)
    for op in sim.collision_ops:
        draws = op.draw(sim._generator, sp_in)
        try:
            err = SC.compare_routes(op, sp_in, g, draws)
        except AssertionError as e:
            fail(f"reconnection op {op.pair}, hand vs plain: {e}")
        t = SC.time_routes(op, sp_in, g, draws)
        i, j = op.pair
        ni, nj = int(sp_in[i].np), int(sp_in[j].np)
        ta["words"] += ni * 9 + ni // 2 * 4 if i == j else \
            (ni + nj) * 9 + ni * 4
        ta["err"] = max(ta["err"], err)
        ta["ms"] += t["cuda"][0]
        ta["plain_ms"] += t["plain"][0]
        print(f"run reconnection: op {op.pair} route {op.route}: hand "
              f"kernels {t['cuda'][0]:.3f} ms (CUDA events), device "
              f"{t['cuda'][1]:.4f} ms in {t['cuda'][2]:.0f} launches; plain "
              f"{t['plain'][0]:.3f} ms, device {t['plain'][1]:.4f} ms in "
              f"{t['plain'][2]:.0f} launches (in turns); equal slots, "
              f"momenta max abs err {err:.3e} ({card})")
        if op.pair[0] != op.pair[1]:
            ia = SC.time_index_add(op, sp_in, g, draws)
            print(f"run reconnection: op {op.pair}'s plain index_add_ (one "
                  f"component): every i-lane ({ia['lanes']}, "
                  f"{ia['at_voxel0']} at voxel 0's first j-slot) "
                  f"{ia['unmasked'][0]:.3f} ms, device "
                  f"{ia['unmasked'][1]:.4f} ms; the {ia['paired']} paired "
                  f"live i-lanes alone {ia['masked'][0]:.3f} ms, device "
                  f"{ia['masked'][1]:.4f} ms ({card})")
        sp_in = op.apply_plain(sp_in, g, draws)[0]
    torch.cuda.synchronize()
    wide = {k: v - wide0[k] for k, v in TA.wide_lanes().items()}
    print(f"run reconnection: order-pass lanes on the wide path over these "
          f"ops' hand runs {wide}; since the process began "
          f"{TA.wide_lanes()}")
    bms, bby = bound_ms(4 * ta["words"], 0)
    results[TA.KERNEL] = dict(
        name=TA.KERNEL, route="cuda",
        source="vpic_tpu_torch/csrc/ta_collide.cu",
        replaces="none: vpic_tpu/collision.py's binary op is plain jnp",
        launches=launches[TA.KERNEL], max_abs_err=ta["err"], ms=ta["ms"],
        plain_ms=ta["plain_ms"], bound_ms=bms, bound_by=bby,
        library_ms=None)
    print(f"run reconnection: a firing's three ops, hand kernels "
          f"{ta['ms']:.3f} ms, plain {ta['plain_ms']:.3f} ms (CUDA events, "
          f"draws excluded); bound {bms:.4f} ms ({4e-6 * ta['words']:.1f} MB, "
          f"{100 * bms / ta['ms']:.1f} % of the hand kernels' time)")
    # a firing step's replay under the profiler, in a window of 6 steps that
    # starts on the step before it (the profiler may drop a few records of
    # a window's first replay; such a window is profiled again, up to
    # PROFILE_TRIES): the firing replay claimed whole, its device records
    # by stage, the generator's fills that open it in collision
    from vpic_tpu_torch import step_graph as SG
    from vpic_tpu_torch.scripts import PROFILE_TRIES, profile_window
    from vpic_tpu_torch.utils import profile as PF
    fs = box["state"]
    for _ in range(PROFILE_TRIES):
        while (fs.step + 1) % tau:
            fs = step(fs)
        SG.replay_log.clear()
        with profile_window() as fprof:
            for _ in range(6):
                fs = step(fs)
        recs = sorted(((e.name, float(e.time_range.start),
                        float(e.time_range.end)) for e in fprof.events()
                       if e.device_type.name == "CUDA"
                       and not getattr(e, "is_user_annotation", False)),
                      key=lambda r: r[1])
        got = PF.attribute(recs, SG.replay_log.maps)
        fired = got.stage_replays.get("collision", 0)
        if fired == 1 and not got.misfits:
            break
    box["state"] = fs
    split = ", ".join(f"{k} {v / 1e3:.4f}" for k, v in sorted(
        got.stage_us.items(), key=lambda kv: -kv[1]))
    print(f"run reconnection: 6 steps traced from step {fs.step - 6}, "
          f"{fired} firing: device ms by stage {split}; unstaged "
          f"{len(got.unstaged)} records "
          f"({sum(e - a for _, a, e in got.unstaged) / 1e3:.4f} ms), "
          f"{got.misfits} misfit replays, branches {got.taken} ({card})")
    if fired != 1 or got.misfits > 1:
        fail(f"reconnection: the firing step's replay is not claimed whole: "
             f"{fired} firing replays claimed, {got.misfits} misfits")
    del sim, state, box, stage_in, step, prof, fprof, sp_in
    drift_recon = drift
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")

    # --- phase 20: the emission diode at its defaults ---
    t_phase = time.perf_counter()
    sim_h = emission.build(device="cpu")
    state_h = sim_h.initialize()
    step_h = sim_h.make_step()
    for _ in range(30):
        state_h = step_h(state_h)
    MP.launches = 0
    try:
        err, new = SC.compare_child_langmuir(sim_h, state_h, "cuda")
    except AssertionError as e:
        fail(f"child_langmuir card vs CPU: {e}")
    if MP.launches != 1:
        fail(f"child_langmuir on the card launched move_p {MP.launches} "
             "times")
    print(f"compare: child_langmuir card == CPU with the same draws on the "
          f"diode after 30 steps ({int(state_h.species[0].np)} live lanes, "
          f"{new} new): live and voxels equal, weights to {SC.WEIGHT_RTOL} of "
          f"themselves, offsets and momenta "
          f"max abs err {err:.3e} (tolerance {SC.LANE_ATOL}), rhob and acc "
          f"within {SC.FIELD_RTOL} of their largest; 1 move_p launch")
    sim = emission.build()
    state = sim.initialize()
    step = step_of(sim)
    key = [k for k in state.diag if k.startswith("absorb_tally/")][0]
    if step.path != "push2d":
        fail("emission does not take the 2-D kernel path")
    state = step(state)
    first = int(state.species[0].np)
    for _ in range(EMIT_QUIET - 1):
        state = step(state)
    quiet = int(state.diag[key])
    if first == 0 or quiet != 0:
        fail(f"emission: {first} lanes after step 0, anode tally {quiet} "
             f"after {EMIT_QUIET} steps")
    kept0 = int(state.species[0].np) + quiet
    state, elapsed, launches = run_steps(torch, sim, state, EMIT_STEPS,
                                         counters)
    tally = int(state.diag[key])
    live = int(state.species[0].np)
    if launches[FP.KERNEL] != EMIT_STEPS or \
            launches[MP.KERNEL] != EMIT_STEPS * len(sim.emitters):
        fail(f"emission: launches {launches} in {EMIT_STEPS} steps (the "
             "WALLS push once a step, move_p once per emitter call)")
    if not tally > 0 or int(state.diag["unfinished"]) != 0 or \
            int(state.species[0].live.sum()) != live:
        fail(f"emission: anode tally {tally} after {EMIT_QUIET + EMIT_STEPS}"
             " steps, or lanes lost")
    results["fused_push2d_walls"]["launches"] += launches[FP.KERNEL]
    results["move_p"]["launches"] += launches[MP.KERNEL]
    box = {"state": state}

    def two_steps():
        for _ in range(2):
            box["state"] = step(box["state"])

    syncs = synchronizing(torch, two_steps)
    if syncs:
        fail(f"emission: the step synchronizes with the card: "
             f"{syncs[0].message} ({syncs[0].filename}:{syncs[0].lineno})")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            box["state"] = step(box["state"])
        torch.cuda.synchronize()
    from vpic_tpu_torch.scripts import device_averages
    evs = device_averages(prof)
    print(f"run emission: 32 x 8 cells, {EMIT_STEPS} steps after "
          f"{EMIT_QUIET} (lanes after step 0: {first}; anode tally 0 until "
          f"step {EMIT_QUIET}), {elapsed * 1e3 / EMIT_STEPS:.3f} ms/step "
          f"({card}, host clock around synchronize); hand-kernel launches "
          f"{launches}; {(live + tally - kept0) / EMIT_STEPS:.2f} lanes "
          f"emitted and {tally / EMIT_STEPS:.2f} absorbed a step "
          f"({live} live, {tally} tallied); 0 synchronizing operations in 2 "
          f"more steps; over 10 more: {sum(e.count for e in evs) / 10:.0f} "
          f"launches and {sum(e.device_time_total for e in evs) / 1e4:.4f} "
          "device ms a step (torch.profiler)")
    del sim, state, box, sim_h, state_h
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")

    # --- phase 21: aged injection on the card ---
    t_phase = time.perf_counter()
    MP.launches = 0
    try:
        err, killed = SC.compare_aged_initialize(vt, "cuda", AGED_LANES)
    except AssertionError as e:
        fail(f"aged injection, card vs CPU: {e}")
    if MP.launches != 1 or killed == 0:
        fail(f"aged injection: {MP.launches} move_p launches for one aged "
             f"species, {killed} lanes killed at the wall")
    results["move_p"]["launches"] += MP.launches
    print(f"compare: aged initialize() card == CPU on {AGED_LANES} aged "
          f"lanes: the same {killed} killed at the absorbing wall, lanes "
          f"max abs err {err:.3e} (tolerance {SC.AGED_ATOL}); 1 move_p "
          "launch")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return drift_recon


class CountedRun:
    """run(sim, state, n) for scripts.deck_checks' oracles: n steps through
    run_steps (every kernel count set to 0 just before and read just
    after), summed over the calls: steps, seconds and launches, and the
    largest peak of device memory."""

    def __init__(self, torch, counters):
        self.torch, self.counters = torch, counters
        self.steps, self.seconds, self.peak = 0, 0.0, 0
        self.launches = {k: 0 for k in counters}

    def __call__(self, sim, state, n):
        state, elapsed, launches = run_steps(self.torch, sim, state, n,
                                             self.counters)
        self.steps += n
        self.seconds += elapsed
        self.peak = max(self.peak, self.torch.cuda.max_memory_allocated())
        for k, v in launches.items():
            self.launches[k] += v
        return state


def profiled_steps(torch, sim, state, n):
    """(kernel launches a step, device ms a step, ms a step, busy share)
    over n more steps under torch.profiler, and the state after them."""
    step = step_of(sim)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
        win_ms = (time.perf_counter() - t0) * 1e3 / n
    from vpic_tpu_torch.scripts import device_averages
    kern = device_averages(prof)
    busy = sum(e.device_time_total for e in kern) / 1e3 / n
    return (sum(e.count for e in kern) / n, busy, win_ms, busy / win_ms,
            state)


def compare_push3d_plain(torch, PT, FP3, g, species, fcoef, qms, what,
                         homes=None):
    """The 3-D kernel (home maps or none, no outbox) against its plain
    version on the same inputs; returns the max abs error over the compared
    lane state and accumulator."""
    print(f"compare: 3-D kernel vs plain, {what}")
    zeros = lambda: torch.zeros((g.nv, 12), device=fcoef.device)
    FP3.deposits = None
    sk, acc_k, *_, unf_k = FP3.fused_push3d_multi(
        PT.clone_species(species), fcoef, zeros(), g, qms, homes=homes)
    sr, acc_r, *_, unf_r = FP3.fused_push3d_multi_ref(
        PT.clone_species(species), fcoef, zeros(), g, qms, homes=homes)
    torch.cuda.synchronize()
    global_share(FP3, what)
    if int(unf_k) != int(unf_r):
        fail(f"{what}: unfinished {int(unf_k)}/{int(unf_r)} (kernel/plain)")
    err = 0.0
    for k, (a, b) in enumerate(zip(sk, sr)):
        if not torch.equal(a.live, b.live):
            fail(f"{what}: species {k} live masks differ")
        err = max(err, compare_lanes(torch, k, a, b, lane_diff(torch, a, b)))
    return max(err, compare_acc(acc_k, acc_r))


def compare_beb(torch, FF, sim, state, what):
    """field_beb against the plain trio on clones of the state's fields:
    bit for bit on every array, one launch."""
    from vpic_tpu_torch.scripts import same_bits
    from vpic_tpu_torch.state import FIELD_NAMES
    f = state.fields
    fk = f.replace(**{n: getattr(f, n).clone() for n in FIELD_NAMES})
    fr = f.replace(**{n: getattr(f, n).clone() for n in FIELD_NAMES})
    g, m = sim.grid, sim._material_coeffs()
    n0 = FF.launches
    FF.make_beb(g, m, sim.damp)(fk)
    FF.beb_ref(fr, g, m, sim.damp)
    torch.cuda.synchronize()
    if FF.launches != n0 + 1:
        fail(f"{what}: field_beb launched {FF.launches - n0} times")
    for n in FIELD_NAMES:
        if not same_bits(getattr(fk, n), getattr(fr, n)):
            fail(f"{what}: field_beb's {n} differs from the plain trio")
    print(f"compare: field_beb == plain trio bit for bit on every array, "
          f"{what} ({g.nx}x{g.ny}x{g.nz}), one launch")
    return 0.0


# phase 22's expected path per deck (scripts.deck_checks' sizes)
DECK_PATHS = dict(twostream="push2d", weibel_gold="push2d",
                  beam_plas="push2d", force_free="push3d", sc08="general",
                  asymm4sp="push2d", dipole="push3d", waveguide="push2d",
                  cygnus="general")
DECK_WINDOW = 10                # profiled steps after each deck's oracle
DECK_CPU_STEPS = 5              # card against CPU from one initial state
SC08_STEPS = 50                 # sc08 at the demo size


def deck_phases(torch, counters, card, results):
    """Phases 22-23: the nine sample decks at their sizes (scripts.
    deck_checks) through their oracles on the card, each card against CPU
    for 5 steps and their kernels against their plain versions on the
    decks' own states; then sc08 at the reference demo's 150 x 25 x 100.
    Adds the runs' launches to the kernels' line entries of the kernels
    they ran."""
    from vpic_tpu_torch.ops import field_fuse as FF
    from vpic_tpu_torch.ops import fused_push as FP
    from vpic_tpu_torch.ops import fused_push3d as FP3
    from vpic_tpu_torch.ops import interp as I
    from vpic_tpu_torch.ops import push as P
    from vpic_tpu_torch.ops import residency as RES
    from vpic_tpu_torch.scripts import deck_checks as DC
    from vpic_tpu_torch.utils import push_timing as PT

    # --- phase 22: the nine decks, each through its oracle ---
    t_phase = time.perf_counter()
    err2, err3, errb = 0.0, 0.0, 0.0
    for name in DC.DECKS:
        t0 = time.perf_counter()
        run = CountedRun(torch, counters)
        try:
            r = DC.oracle(name, "cuda", run)
        except AssertionError as e:
            fail(f"{name} oracle on the card: {e}")
        sim, state = r["sim"], r["state"]
        step = step_of(sim)
        n, L = run.steps, run.launches
        push = FP.KERNEL if step.path == "push2d" else FP3.KERNEL
        particles = bool(sim.species)
        if step.path != DECK_PATHS[name]:
            fail(f"{name}: path {step.path}, not {DECK_PATHS[name]}")
        if name in DC.FIELD_BEB:
            if step.fields != "field_beb" or L[FF.KERNEL] != n:
                fail(f"{name}: field advance {step.fields!r}, field_beb "
                     f"launched {L[FF.KERNEL]} times in {n} steps")
        elif not step.fields.startswith("plain: ") or L[FF.KERNEL] != 0:
            fail(f"{name}: field advance {step.fields!r} with "
                 f"{L[FF.KERNEL]} field_beb launches")
        if L[push] != (n if particles else 0) or \
                L[FP.KERNEL] + L[FP3.KERNEL] != L[push]:
            fail(f"{name}: push launches {L} in {n} steps")
        if L[RES.KERNEL]:
            fail(f"{name}: the merge ran without residency")
        if int(state.diag["unfinished"]) != 0:
            fail(f"{name}: unfinished streaks")
        walled = P.has_walls(sim.grid, sim._local_vbc())
        entry = push + ("_walls" if walled else "")
        results[entry]["launches"] += L[push]
        results[RES.KERNEL]["launches"] += L[RES.KERNEL]
        results[FF.KERNEL]["launches"] += L[FF.KERNEL]
        calls, dev_ms, win_ms, busy, state = profiled_steps(
            torch, sim, state, DECK_WINDOW)
        try:
            c = DC.card_vs_cpu(name, "cuda", DECK_CPU_STEPS)
        except AssertionError as e:
            fail(f"{name} card vs CPU: {e}")
        g = sim.grid
        facts = {k: v for k, v in r.items() if k not in ("sim", "state")}
        print(f"run {name}: {g.nx}x{g.ny}x{g.nz}, "
              f"{sum(st.count for st in sim.species)} particles, path "
              f"{step.path}, field advance {step.fields!r}; oracle passed "
              f"{facts}; {n} steps at {run.seconds * 1e3 / n:.3f} ms/step "
              f"({card}, host clock around synchronize); hand-kernel "
              f"launches {L}; over {DECK_WINDOW} profiled steps "
              f"{calls:.1f} launches and {dev_ms:.4f} device ms a step, "
              f"{win_ms:.3f} ms/step, busy share {100 * busy:.1f} %; card "
              f"vs CPU over {DECK_CPU_STEPS} steps from one state: lanes "
              f"{c['lane']:.3e}, fields {c['field']:.3e} of their largest, "
              f"energies {c['energy']:.3e} of their sum; "
              f"{time.perf_counter() - t0:.1f} s")
        qms = [(st.params.q, st.params.m) for st in sim.species]
        fcoef = I.load_interpolator(state.fields, g)
        if name in ("twostream", "weibel_gold"):
            if name == "twostream":
                sorted_sp = [FP.bucket_sort_p(sp, g, extent=st.count)
                             for sp, st in zip(state.species, sim.species)]
                err2 = max(err2, compare_push(
                    torch, PT, FP, g, sorted_sp, fcoef, qms,
                    f"twostream {g.nx}x{g.ny}x{g.nz} after "
                    f"{n + DECK_WINDOW} steps, sorted"))
                err2 = max(err2, compare_push(
                    torch, PT, FP, g, list(state.species), fcoef, qms,
                    f"twostream {g.nx}x{g.ny}x{g.nz} after "
                    f"{n + DECK_WINDOW} steps, as the step left them"))
            errb = max(errb, compare_beb(torch, FF, sim, state,
                                         f"{name} after {n} steps"))
        if name == "force_free":
            sp_h = [FP3.brick_sort_p_home(sp, g, extent=st.count)
                    for sp, st in zip(state.species, sim.species)]
            err3 = max(err3, compare_push3d_plain(
                torch, PT, FP3, g, [s for s, _ in sp_h], fcoef, qms,
                f"force_free {g.nx}x{g.ny}x{g.nz} home maps, after "
                f"{n + DECK_WINDOW} steps", homes=[h for _, h in sp_h]))
        if name == "sc08":
            err3 = max(err3, compare_push3d_plain(
                torch, PT, FP3, g, list(state.species), fcoef, qms,
                f"sc08 {g.nx}x{g.ny}x{g.nz} without home maps (pec and "
                f"reflecting x faces), after {n + DECK_WINDOW} steps"))
        del sim, state, r, fcoef
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")

    # --- phase 23: sc08 at the reference demo's grid ---
    t_phase = time.perf_counter()
    # what earlier phases left (their Simulations hold reference cycles)
    # is collected, and the peak is also given above what stays allocated
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    run = CountedRun(torch, counters)
    try:
        r = DC.sc08_demo("cuda", run, n_steps=SC08_STEPS)
    except AssertionError as e:
        fail(f"sc08 {DC.SC08_DEMO}: {e}")
    sim, state = r["sim"], r["state"]
    g = sim.grid
    step = step_of(sim)
    L = run.launches
    if step.path != "general" or FP3.supports3d(g) or \
            L[FP3.KERNEL] != SC08_STEPS or L[FF.KERNEL] != SC08_STEPS or \
            int(state.diag["unfinished"]) != 0:
        fail(f"sc08 demo: path {step.path}, launches {L}, unfinished "
             f"{int(state.diag['unfinished'])}")
    results[FP3.KERNEL]["launches"] += L[FP3.KERNEL]
    results[FF.KERNEL]["launches"] += L[FF.KERNEL]
    calls, dev_ms, win_ms, busy, state = profiled_steps(
        torch, sim, state, DECK_WINDOW)
    n_part = sum(st.count for st in sim.species)
    qms = [(st.params.q, st.params.m) for st in sim.species]
    fcoef = I.load_interpolator(state.fields, g)
    species = list(state.species)
    err3 = max(err3, compare_push3d_plain(
        torch, PT, FP3, g, species, fcoef, qms,
        f"sc08 {g.nx}x{g.ny}x{g.nz} x 1 ppc without home maps, after "
        f"{SC08_STEPS + DECK_WINDOW} steps"))
    ms3, plain3 = (PT.time_push(fn, g, species, fcoef, qms)
                   for fn in (FP3.fused_push3d_multi,
                              FP3.fused_push3d_multi_ref))
    dev3 = PT.push_device_ms(FP3.fused_push3d_multi, "fused_push3d_kernel",
                             g, species, fcoef, qms)
    print(f"run sc08 demo: {g.nx}x{g.ny}x{g.nz} x 1 ppc ({g.nx * g.ny * g.nz}"
          f" cells, {n_part} particles), general path; deck build (host "
          f"staging) {r['build_s']:.1f} s, initialize() "
          f"{r['initialize_s']:.1f} s; {SC08_STEPS} steps at "
          f"{run.seconds * 1e3 / SC08_STEPS:.3f} ms/step ({card}, host clock "
          f"around synchronize), every particle kept, drift "
          f"{r['drift']:.3e}; hand-kernel launches {L}; over {DECK_WINDOW} "
          f"profiled steps {calls:.1f} launches and {dev_ms:.4f} device ms a "
          f"step, {win_ms:.3f} ms/step, busy share {100 * busy:.1f} %; peak "
          f"device memory {run.peak / 2**20:.1f} MiB, "
          f"{(run.peak - base) / 2**20:.1f} MiB above what was allocated "
          "before the deck's build")
    print(f"timing ({card}): 3-D kernel without home maps on the sc08 demo "
          f"state {ms3:.4f} ms (CUDA events), device {dev3:.5f} ms "
          f"(torch.profiler), plain {plain3:.4f} ms per push of both species")
    for k, e in ((FP.KERNEL, err2), (FP3.KERNEL, err3), (FF.KERNEL, errb)):
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"], e)
    drift = r["drift"]
    del sim, state, r, species, fcoef
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return drift


def print_ranks(res, what, card):
    """The per-rank lines of a decomposed phase."""
    for r in res:
        prof = (f", busy share {100 * r['busy']:.1f} % ({r['calls']:.1f} "
                f"launches, {r['device_ms']:.3f} device ms a step over 5 "
                "profiled steps)" if "busy" in r else "")
        print(f"  {what} rank {r['rank']}: transport {r['transport']}, "
              f"{r['ms_step']:.3f} ms/step ({card}, host clock around "
              f"synchronize), staged {r['staged_bytes']:.0f} bytes and "
              f"{r['host_syncs']:.1f} host syncs a step, "
              f"{r['migrated']:.1f} lanes migrated a step, launches "
              f"{r['launches']}{prof}")


def sharded_phases(torch, counters, card, results, sc08_drift,
                   recon_drift=None):
    from vpic_tpu_torch.models import harris
    from vpic_tpu_torch.ops import fused_push as FP
    from vpic_tpu_torch.ops import fused_push3d as FP3
    from vpic_tpu_torch.ops import move_p as MP
    from vpic_tpu_torch.parallel import mesh as M
    from vpic_tpu_torch.scripts import sharded_checks as SC

    # a decomposed deck's push runs the kernels' WALLS instance (remote
    # faces are wall faces), entered as in phases 11-14 and 22
    walls = {FP.KERNEL: "fused_push2d_walls", FP3.KERNEL: "fused_push3d_walls"}

    def add(res, kernel_errs):
        for r in res:
            for k, v in r["launches"].items():
                if walls.get(k, k) in results:
                    results[walls.get(k, k)]["launches"] += v
        for k, e in kernel_errs.items():
            k = walls.get(k, k)
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"], e)

    def kernels(res, push_kernel, what):
        errs = {push_kernel: 0.0, MP.KERNEL: 0.0}
        for r in res:
            p, mv = r["push"], r["move_p"]
            print(f"  {what} rank {r['rank']}: {push_kernel} with remote "
                  f"faces vs plain: max abs err {p['max_abs_err']:.3e}, "
                  f"{p['remote_parked']} lanes parked at a remote face; "
                  f"move_p on {mv['walked']} received lanes vs plain: max "
                  f"abs err {mv['max_abs_err']:.3e}, {mv['left_again']} "
                  "left again")
            errs[push_kernel] = max(errs[push_kernel], p["max_abs_err"])
            errs[MP.KERNEL] = max(errs[MP.KERNEL], mv["max_abs_err"])
        return errs

    def checked(res, what, n_steps, kernel, once=True):
        try:
            SC.conserved(res, what)
        except AssertionError as e:
            fail(str(e))
        for r in res:
            if r["unfinished"]:
                fail(f"{what}: {r['unfinished']} streaks unfinished")
            n = r["launches"][kernel]
            if n != n_steps if once else n < 1:
                fail(f"{what}: rank {r['rank']} launched {kernel} {n} times "
                     f"in {n_steps} steps")
        print(f"  {what}: lanes {res[0]['lanes'][0]} -> {res[0]['lanes'][1]}"
              f", dropped {res[0]['dropped']}, drift {res[0]['drift']:.3e}, "
              f"path {res[0]['path']}, fields {res[0]['fields']}")

    # --- phase 24: harris 2-D decomposed (1, 2, 1) ---
    t_phase = time.perf_counter()
    sim = harris.build(harris.HarrisParams())
    state = sim.initialize()
    step = step_of(sim)
    for _ in range(SHARDED_CHECK_AT):
        state = step(state)
    e_one = sim.energies(state).double().cpu().numpy()
    del sim, state, step
    n2 = SHARDED_STEPS[0]
    res = M.launch(SC.run_rank, 2, "cuda", args=(
        "harris", dict(topology=(1, 2, 1)), n2, "cuda", SHARDED_CHECK_AT,
        True, 5))
    print(f"run harris 2-D (1, 2, 1): 64^2 x 64 ppc on 2 ranks of one card, "
          f"{n2} steps")
    print_ranks(res, "harris 2-D", card)
    n_timed = n2 - SHARDED_CHECK_AT
    checked(res, "harris 2-D (1, 2, 1)", n_timed, FP.KERNEL)
    e_dec = res[0]["e_check"]
    err = np.abs(e_dec - e_one)
    lim = SHARDED_RTOL * np.abs(e_one) + SHARDED_ATOL * e_one.sum()
    print(f"  harris 2-D: step-{SHARDED_CHECK_AT} energies vs one domain: "
          f"max rel err {(err / np.abs(e_one)).max():.3e} (limit rtol "
          f"{SHARDED_RTOL}, atol {SHARDED_ATOL} x sum)")
    if not (err <= lim).all():
        fail(f"harris 2-D (1, 2, 1): energies {e_dec} vs one domain {e_one}")
    if res[0]["drift"] >= 1e-3:
        fail(f"harris 2-D (1, 2, 1): drift {res[0]['drift']}")
    add(res, kernels(res, FP.KERNEL, "harris 2-D"))
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s")

    # --- phase 25: harris3d decomposed (1, 2, 1) ---
    t_phase = time.perf_counter()
    n3 = SHARDED_STEPS[1]
    res = M.launch(SC.run_rank, 2, "cuda", args=(
        "harris", dict(nx=32, ny=32, nz=32, nppc=128, Lx=16.0, Ly=16.0,
                       Lz=16.0, topology=(1, 2, 1)), n3, "cuda", 0, True, 5))
    print(f"run harris3d (1, 2, 1): 32^3 x 128 ppc on 2 ranks of one card, "
          f"{n3} steps; staging {res[0]['build_s']:.1f} s, initialize() "
          f"{res[0]['initialize_s']:.1f} s")
    print_ranks(res, "harris3d", card)
    checked(res, "harris3d (1, 2, 1)", n3, FP3.KERNEL)
    if res[0]["path"] != "push3d" or res[0]["drift"] >= 1e-3:
        fail(f"harris3d (1, 2, 1): path {res[0]['path']}, drift "
             f"{res[0]['drift']}")
    add(res, kernels(res, FP3.KERNEL, "harris3d"))
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s")

    # --- phase 26: sc08 at the demo's grid on its (1, 1, 4) ---
    t_phase = time.perf_counter()
    n8 = SHARDED_STEPS[2]
    res = M.launch(SC.run_rank, 4, "cuda", args=(
        "sc08", dict(nx=150, ny=25, nz=100, nppc=1, topology=(1, 1, 4)), n8,
        "cuda", 0, False, 5))
    print(f"run sc08 (1, 1, 4): 150 x 25 x 100 x 1 ppc on 4 ranks of one "
          f"card, {n8} steps; staging {res[0]['build_s']:.1f} s, "
          f"initialize() {res[0]['initialize_s']:.1f} s")
    print_ranks(res, "sc08", card)
    checked(res, "sc08 (1, 1, 4)", n8, FP3.KERNEL)
    print(f"  sc08: drift {res[0]['drift']:.3e} vs one domain (phase 23) "
          f"{sc08_drift:.3e}")
    if res[0]["drift"] > 2 * sc08_drift:
        fail(f"sc08 (1, 1, 4): drift {res[0]['drift']} more than twice the "
             f"one-domain {sc08_drift}")
    add(res, {})
    print(f"phase 26: {time.perf_counter() - t_phase:.1f} s")

    # --- phase 27: the irregular join, the decomposed reflux, a restart ---
    t_phase = time.perf_counter()
    kept = sum(M.launch(M.irregular_join_case, 4, "cuda"))
    print(f"run irregular join (4 ranks, two spliced 2-rank rings): {kept} "
          "of 64 lanes kept")
    if kept != 64:
        fail(f"irregular join kept {kept} of 64 lanes")
    kept = sum(M.launch(M.reflux_case, 2, "cuda", args=("cuda", 20)))
    print(f"run decomposed reflux ((1, 2, 1), 20 steps): {kept} of 128 "
          "lanes kept")
    if kept != 128:
        fail(f"decomposed reflux kept {kept} of 128 lanes")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        base = os.path.join(d, "ck")
        n1, n2 = SHARDED_RESTART
        res = M.launch(SC.restart_rank, 2, "cuda", args=(
            base, dict(topology=(1, 2, 1)), n1, n2))
        e_run, e_rst = res[0]["e_run"], res[0]["e_restored"]
        e_map = SC.remap_run(f"{base}.{n1}", dict(topology=(1, 1, 1)), n2)
    for what, e in (("restored on (1, 2, 1)", e_rst),
                    ("remapped onto (1, 1, 1)", e_map)):
        rel = float(np.abs(e - e_run).max() / e_run.sum())
        print(f"run harris 2-D (1, 2, 1) restart, checkpoint at step {n1}, "
              f"{what}: step-{n1 + n2} energies differ from the "
              f"uninterrupted run's by {rel:.3e} of the total (the one-domain"
              f" CPU restart is exact; on the card the float atomics' "
              f"summation order differs run to run; limit {RESTART_RTOL})")
        if not rel <= RESTART_RTOL:
            fail(f"decomposed restart {what}: energies differ by {rel}")
    print(f"phase 27: {time.perf_counter() - t_phase:.1f} s")

    # --- phase 28: the decomposed stochastic decks ---
    from vpic_tpu_torch.models import emission
    t_phase = time.perf_counter()
    res = M.launch(SC.run_rank, 2, "cuda", args=(
        "reconnection", dict(RECON, topology=(1, 2, 1)), RECON_STEPS, "cuda",
        0, True, 5))
    r0 = res[0]
    print(f"run reconnection (1, 2, 1): 32^3 x 128 ppc, tau 5, on 2 ranks of "
          f"one card, {RECON_STEPS} steps; staging {r0['build_s']:.1f} s, "
          f"initialize() {r0['initialize_s']:.1f} s")
    print_ranks(res, "reconnection", card)
    checked(res, "reconnection (1, 2, 1)", RECON_STEPS, FP3.KERNEL)
    one = "not run" if recon_drift is None else f"{recon_drift:.3e}"
    print(f"  reconnection (1, 2, 1): drift {r0['drift']:.3e} (bound 3e-2) "
          f"vs one domain (phase 19) {one}")
    if r0["path"] != "push3d" or not r0["drift"] < 3e-2 or \
            not np.isfinite(r0["e_end"]).all():
        fail(f"reconnection (1, 2, 1): path {r0['path']}, drift "
             f"{r0['drift']}")
    for r in res:
        c = r["collision"]
        print(f"  reconnection rank {r['rank']}: the collision stage (3 T&A "
              f"ops, one firing) {c['ms']:.3f} ms (CUDA events), device "
              f"{c['device_ms']:.3f} ms in {c['launches']:.0f} launches "
              f"(torch.profiler); peak device memory "
              f"{r['peak_mib']:.1f} MiB ({card})")
    add(res, kernels(res, FP3.KERNEL, "reconnection"))
    print(f"phase 28a: {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    sim = emission.build()
    census = int(sim.make_step()(sim.initialize()).species[0].np)
    del sim
    n_em = EMIT_QUIET + EMIT_STEPS
    res = M.launch(SC.run_rank, 2, "cuda", args=(
        "emission", dict(topology=(2, 1, 1)), n_em, "cuda", EMIT_QUIET, True,
        5, (1, EMIT_QUIET)))
    r0 = res[0]
    print(f"run emission (2, 1, 1): the diode at its defaults (32 x 8 cells) "
          f"on 2 ranks of one card, {n_em} steps")
    print_ranks(res, "emission", card)
    first, quiet = r0["marks"][1], r0["marks"][EMIT_QUIET]
    print(f"  emission (2, 1, 1): {first[0]} lanes after step 0 (one domain "
          f"on the card: {census}), anode tally {quiet[1]} after "
          f"{EMIT_QUIET} steps, {r0['tally']} after {n_em}; "
          f"{(r0['lanes'][1] + r0['tally'] - quiet[0]) / EMIT_STEPS:.2f} "
          f"lanes emitted and {(r0['tally'] - quiet[1]) / EMIT_STEPS:.2f} "
          f"absorbed a step; {r0['dropped']} dropped, path {r0['path']}")
    if first[0] != census or census == 0:
        fail(f"emission (2, 1, 1): census {first[0]} vs one domain {census}")
    if quiet[1] != 0 or not r0["tally"] > 0 or r0["dropped"] != 0:
        fail(f"emission (2, 1, 1): tally {quiet[1]} after {EMIT_QUIET} "
             f"steps, {r0['tally']} at the end, {r0['dropped']} dropped")
    for r in res:
        n = r["launches"]
        if n[FP.KERNEL] != EMIT_STEPS or n[MP.KERNEL] < EMIT_STEPS or \
                r["unfinished"]:
            fail(f"emission (2, 1, 1): rank {r['rank']} launches {n} in "
                 f"{EMIT_STEPS} steps, {r['unfinished']} unfinished")
        e = r["emitter"]
        print(f"  emission rank {r['rank']}: child_langmuir card == CPU with "
              f"the same draws ({e['new']} new lanes; the aged walk on move_p"
              f" vs its plain walk): max abs err {e['max_abs_err']:.3e}")
    errs = kernels(res, FP.KERNEL, "emission")
    errs[MP.KERNEL] = max([errs[MP.KERNEL]]
                          + [r["emitter"]["max_abs_err"] for r in res])
    add(res, errs)
    print(f"phase 28b: {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    n, m_lanes = INJECT_GRID, INJECT_LANES
    one = SC.inject_rank("cuda", INJECT_STEPS, (1, 1, 1), n, m_lanes)
    res = M.launch(SC.inject_rank, 2, "cuda", args=(
        "cuda", INJECT_STEPS, (1, 2, 1), n, m_lanes))
    try:
        cmp = SC.compare_injected(one["first"], [r["first"] for r in res],
                                  (1, 2, 1), n, 0.04 * 8 / n)
    except AssertionError as e:
        fail(f"runtime injection (1, 2, 1): {e}")
    print(f"run runtime injection (1, 2, 1): {n}^3 box, {m_lanes} aged "
          f"lanes a step through the hook, path {res[0]['path']}: after the "
          f"first step the ranks' {cmp['lanes']} lanes equal one domain's on "
          f"the card ({cmp['parked']} parked at a seam by their aged walk); "
          f"after {INJECT_STEPS} steps {res[0]['total']} lanes (one domain "
          f"{one['total']}), {res[0]['dropped']} dropped")
    if res[0]["total"] != one["total"] or \
            one["total"] != INJECT_STEPS * m_lanes or res[0]["dropped"]:
        fail(f"runtime injection (1, 2, 1): {res[0]['total']} lanes vs "
             f"{one['total']}")
    print(f"phase 28c: {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    M.dryrun(8, "cuda")
    print(f"phase 28d: {time.perf_counter() - t_phase:.1f} s")


# phase 29's runs through make_multi_step: harris 2-D's steps, harris3d's
GRAPH_STEPS = {"harris2d": 200, "harris3d": 100}
GRAPH_TURN = 50                 # steps a timing turn (eager, graphed, ...)
GRAPH_RECON = 20                # reconnection steps graphed (four firings)
EAGER_ONLY = {"lpi", "dipole", "waveguide", "cygnus"}   # their hooks


def graph_phase(torch, counters, card, results):
    """Phase 29: the graphed step (step_graph) against the eager one."""
    from vpic_tpu_torch import step_graph as SG
    from vpic_tpu_torch.models import harris
    from vpic_tpu_torch.scripts import graph_checks as GC
    t_phase = time.perf_counter()

    # which decks are captured
    refused = GC.refusals()
    for name, why in refused.items():
        print(f"graph refusal {name}: {why or 'none (captured)'}")
    split = harris.build(harris.HarrisParams(topology=(1, 2, 1)))
    why = SG.refusal(split)
    print(f"graph refusal harris2d (1, 2, 1): {why}")
    if {k for k, v in refused.items() if v} != EAGER_ONLY or \
            not why or "decomposed" not in why:
        fail(f"graph refusals {refused}, decomposed {why!r}")

    # the forced rebucket under the IF node
    sim = GC.build("residency16", "cuda")
    if sim._residency_mode() != (True, 1):
        fail(f"residency16: residency {sim._residency_mode()}")
    res = GC.graphed_vs_eager(sim, sim.initialize(), 3,
                              prepare=GC.force_rebucket)
    print(f"graph residency16: forced rebucket under the IF node at step "
          f"{res['at']}: rebuckets (graphed, eager) {res['rebuckets']}, "
          f"lanes differing {res['lanes'] or 'none'}, fields "
          f"{res['fields']:.3f} of the tolerance")
    if res["rebuckets"] != (1, 1) or res["lanes"] or not res["fields"] < 1:
        fail(f"forced rebucket: {res}")
    results[SG.KERNEL]["max_abs_err"] = float(
        abs(res["rebuckets"][0] - res["rebuckets"][1]))
    del sim

    for name in ("harris2d", "harris3d", "reconnection", "emission"):
        t0 = time.perf_counter()
        sim = GC.build(name, "cuda")
        if sim.make_step().graphed is not True:
            fail(f"{name}: the step is not graphed: "
                 f"{sim.make_step().graphed}")
        # one step graphed and one eager from one state, then 10 each way
        res = GC.graphed_vs_eager(sim, sim.initialize(), 10)
        print(f"graph {name}: one step graphed vs eager from one state at "
              f"step {res['at']}: lanes differing {res['lanes'] or 'none'}"
              f", rebuckets {res['rebuckets']}; 10 steps: fields at "
              f"{res['fields']:.3f} of the tolerance (5e-7 + 1e-5 max|a|)")
        if res["lanes"] or not res["fields"] < 1.0 or \
                res["rebuckets"][0] != res["rebuckets"][1]:
            fail(f"{name}: graphed step differs from the eager one: {res}")
        if name in GRAPH_STEPS:
            graph_run(torch, sim, name, GRAPH_STEPS[name], counters, card,
                      results)
        elif name == "reconnection":
            graph_reconnection(torch, sim, counters, card)
        del sim
        print(f"graph {name}: {time.perf_counter() - t0:.1f} s")
    print(f"phase 29: {time.perf_counter() - t_phase:.1f} s")


def rho_phase(card):
    """Phase 30: the entry point scripts.rho_bench at the benchmark decks'
    sizes; returns rho_p's entry of the kernels' line."""
    from vpic_tpu_torch.ops import rho_p as RHO
    from vpic_tpu_torch.scripts import rho_bench as RB
    t0 = time.perf_counter()
    out = RB.main()
    for name in RB.DECKS:
        r = out[name]
        run = r["run"]
        print(f"rho_p {name} ({run['path']}, tile {r['tile']}): "
              f"{run['launches']} launches in initialize() and "
              f"{RB.STEPS} steps with {run['cleaning_steps']} cleaning; "
              f"worst of {RB.ERR_CALLS} calls: max abs err "
              f"{r['max_abs_err']:.3e} of the charge scale "
              f"({r['err_of_max_rhof']:.3e} of max |rhof|), against the "
              f"float64 sum {r['kernel_err_exact']:.3e} (plain "
              f"{r['plain_err_exact']:.3e}); lanes on the global path "
              f"{r['global_lanes']} of {r['deposited_lanes']}; timing "
              f"({card}): device {r['device_ms']:.5f} ms "
              f"({r['bound_pct']:.1f} % of the bound {r['bound_ms']:.5f}), "
              f"CUDA events {r['ms']:.5f} ms; plain device "
              f"{r['plain_device_ms']:.5f}, CUDA events "
              f"{r['plain_ms']:.5f} ms")
        if run["launches"] != run["cleaning_steps"]:
            fail(f"rho_p {name}: {run['launches']} launches for "
                 f"{run['cleaning_steps']} cleaning steps")
        if (r["launches"] != 1 or not r["max_abs_err"] <= 2e-6
                or not r["kernel_err_exact"] <= 1e-6):
            fail(f"rho_p {name}: {r}")
        if r["deposited_lanes"] != r["lanes"] or not r["device_ms"] > 0:
            fail(f"rho_p {name}: {r}")
        if r["tile"] and r["global_lanes"] != 0:
            fail(f"rho_p {name}: {r['global_lanes']} lanes outside their "
                 "block's brick on the residency layout")
    print(f"phase 30: {time.perf_counter() - t0:.1f} s")
    r = out["harris3d"]
    return dict(
        name=RHO.KERNEL, route="cuda",
        source="vpic_tpu_torch/csrc/rho_p.cu",
        replaces="none (vpic_tpu/ops/push.py accumulate_rho_p, plain jnp)",
        launches=sum(out[n]["run"]["launches"] for n in RB.DECKS),
        max_abs_err=max(out[n]["max_abs_err"] for n in RB.DECKS),
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by="bytes", library_ms=None)


def graph_run(torch, sim, name, n, counters, card, results):
    """Phase 29's harris runs: n steps in one make_multi_step once every
    cadence of them is captured, then eager and graphed in turns."""
    from vpic_tpu_torch import step_graph as SG
    from vpic_tpu_torch.ops import field_fuse as FF
    from vpic_tpu_torch.ops import fused_push as FP
    from vpic_tpu_torch.ops import fused_push3d as FP3
    from vpic_tpu_torch.ops import residency as RES
    from vpic_tpu_torch.scripts import graph_checks as GC
    state = sim.initialize()
    particles = sum(int(sp.np) for sp in state.species)
    e0 = sim.energies(state).double().cpu().numpy()
    many = sim.make_multi_step(n)
    step = many.step
    state = GC.warm_for(step, state, n)
    ptrs = GC.storage(state)
    reset_counts(counters)
    sim.host_syncs = 0
    r0 = int(state.diag.get("_res_rebuckets", torch.zeros(())))
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("error")
        try:
            t1 = time.perf_counter()
            state = many(state)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t1
        except RuntimeError as e:
            fail(f"{name}: a synchronizing operation in the graphed window: "
                 f"{e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    launches = read_counts(counters)
    rebuckets = int(state.diag.get("_res_rebuckets", torch.zeros(()))) - r0
    e1 = sim.energies(state).double().cpu().numpy()
    drift = abs(e1.sum() - e0.sum()) / e0.sum()
    push = FP.KERNEL if name == "harris2d" else FP3.KERNEL
    merges = launches[RES.KERNEL]
    print(f"graph {name}: {n} steps in one make_multi_step after "
          f"{state.step - n} warm-up and capture steps ({step.captures} "
          f"graphs, {step.eager_steps} eager): {sec * 1e3 / n:.3f} ms/step; "
          f"launches {launches}; rebuckets {rebuckets}; host syncs "
          f"{sim.host_syncs}; drift {drift:.3e} from step 0; 0 "
          "synchronizing operations (sync debug mode error)")
    if launches[push] != n or launches[FF.KERNEL] != n:
        fail(f"{name}: push {launches[push]} and field_beb "
             f"{launches[FF.KERNEL]} launches in {n} graphed steps")
    if name == "harris3d" and (merges != n - rebuckets or
                               launches[SG.KERNEL] != 2 * n):
        fail(f"{name}: {merges} merges with {rebuckets} rebuckets and "
             f"{launches[SG.KERNEL]} IF conditions in {n} steps")
    if sim.host_syncs != 0 or not np.isfinite(e1).all() or \
            not drift < 1e-3 or int(state.diag["unfinished"]) != 0:
        fail(f"{name}: host syncs {sim.host_syncs}, drift {drift}, "
             f"unfinished {int(state.diag['unfinished'])}")
    if GC.storage(state) != ptrs:
        fail(f"{name}: the graphed window moved the state's tensors")
    if name == "harris3d":
        results[SG.KERNEL]["launches"] += launches[SG.KERNEL]
    # the profiled window: graph launches only
    state, prof = GC.timed(step, state, 1, particles, profile_steps=10)
    if prof["calls"]["kernel"] != 0 or prof["calls"]["graph"] != 10:
        fail(f"{name}: host launch calls in 10 graphed steps "
             f"{prof['calls']}")
    print(f"graph {name}: 10 profiled graphed steps: host calls "
          f"{prof['calls']} (no kernel launched from Python)")
    # eager and graphed in turns, from the same evolving state
    turns(torch, sim, step, state, particles, GRAPH_TURN, name, card)
    if name == "harris3d":
        results[SG.KERNEL]["ms"], state = prof_kernel_ms(
            torch, step, state, "set_condition_kernel")


def turns(torch, sim, step, state, particles, n, name, card):
    """Eager, graphed, graphed, eager: n steps each from the same evolving
    state (graph_checks.timed)."""
    from vpic_tpu_torch.scripts import graph_checks as GC
    eager = sim.make_advance()
    for mode in ("eager", "graphed", "graphed", "eager"):
        state, t = GC.timed(eager if mode == "eager" else step, state, n,
                            particles)
        print(f"graph {name} {mode}: {t['ms']:.3f} ms/step, "
              f"{t['pushes_per_s']:.4e} pushes/s, device busy "
              f"{100 * t['busy_share']:.1f} % ({t['device_ms']:.4f} device "
              f"ms a step over 10 profiled steps), peak memory allocated "
              f"{t['peak_mib']:.1f} MiB, reserved {t['reserved_mib']:.1f} "
              f"MiB, host launch calls in 10 steps {t['calls']} ({n} "
              f"steps; {card})")
    return state


def graph_reconnection(torch, sim, counters, card):
    """Phase 29's reconnection: GRAPH_RECON graphed steps from step 0, then
    eager and graphed in turns."""
    from vpic_tpu_torch.ops import residency as RES
    state = sim.initialize()
    n0 = [int(sp.np) for sp in state.species]
    e0 = sim.energies(state).double().cpu().numpy()
    many = sim.make_multi_step(GRAPH_RECON)
    reset_counts(counters)
    sim.relayouts = sim.host_syncs = 0
    t1 = time.perf_counter()
    state = many(state)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t1
    launches = read_counts(counters)
    step = many.step
    e1 = sim.energies(state).double().cpu().numpy()
    drift = abs(e1.sum() - e0.sum()) / e0.sum()
    n1 = [int(sp.np) for sp in state.species]
    post = int(state.diag["_res_rebuckets"])
    print(f"graph reconnection: {GRAPH_RECON} steps from step 0 in one "
          f"make_multi_step ({step.eager_steps} eager warm-ups, "
          f"{step.captures} graphs): {sec * 1e3 / GRAPH_RECON:.3f} ms/step "
          f"with the captures; rebuckets after the push {post}, under the IF "
          f"node {step.taken['rebucket']} (merges there "
          f"{step.taken['merge']}); before it {sim.relayouts}; host syncs "
          f"{sim.host_syncs} (the eager steps'); launches {launches}; "
          f"particles {n0} -> {n1}; drift {drift:.3e} (bound 3e-2)")
    if n1 != n0 or not drift < 3e-2 or not np.isfinite(e1).all():
        fail(f"graphed reconnection: particles {n0} -> {n1}, drift {drift}")
    if step.taken["rebucket"] + step.taken["merge"] != \
            GRAPH_RECON - step.eager_steps or \
            launches[RES.KERNEL] != GRAPH_RECON - post or \
            sim.host_syncs != step.eager_steps:
        fail(f"graphed reconnection: branches {step.taken}, "
             f"{launches[RES.KERNEL]} merges with {post} rebuckets, "
             f"{sim.host_syncs} host syncs")
    turns(torch, sim, step, state, sum(n0), 10, "reconnection", card)


def host_read_ms(torch, n=2000):
    """ms a host read of a 0-d bool on the card (the eager residency
    step's decision), host clock over n reads."""
    t = torch.zeros((), dtype=torch.bool, device="cuda")
    bool(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        bool(t)
    return (time.perf_counter() - t0) * 1e3 / n


def prof_kernel_ms(torch, step, state, kernel):
    """(device ms a launch of ``kernel`` over 10 graphed steps, from
    torch.profiler, and the state after them)."""
    from vpic_tpu_torch.scripts import device_averages, profile_window
    with profile_window() as prof:
        for _ in range(10):
            state = step(state)
    hits = [e for e in device_averages(prof) if kernel in e.key]
    n = sum(e.count for e in hits)
    if not n:
        fail(f"no {kernel} in 10 profiled graphed steps")
    return sum(e.device_time_total for e in hits) / 1e3 / n, state


def main():
    args = sys.argv[1:]
    if args not in ([], ["--decomposed-only"]):
        print(f"chip_smoke: unknown arguments {args}; usage: chip_smoke.py "
              "[--decomposed-only]", file=sys.stderr)
        return 2
    decomposed_only = bool(args)
    import torch

    # --- phase 1: device ---
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's smoke test needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vpic_tpu_torch.models import harris
    from vpic_tpu_torch.ops import _build
    from vpic_tpu_torch.ops import compact as C
    from vpic_tpu_torch.ops import field_fuse as FF
    from vpic_tpu_torch.ops import fused_push as FP
    from vpic_tpu_torch.ops import fused_push3d as FP3
    from vpic_tpu_torch.ops import interp as I
    from vpic_tpu_torch.ops import move_p as MP
    from vpic_tpu_torch.ops import residency as RES
    from vpic_tpu_torch.ops import rho_p as RHO
    from vpic_tpu_torch.ops import ta_collide as TA
    from vpic_tpu_torch import step_graph as SG
    from vpic_tpu_torch.scripts import card as card_and_power
    from vpic_tpu_torch.scripts import cuda_ms, device_ms, kernel_device_ms
    from vpic_tpu_torch.scripts import field_fuse_proto as RF
    from vpic_tpu_torch.utils import push_timing as PT

    card = card_and_power()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {FP.KERNEL: (FP, "launches"), FP3.KERNEL: (FP3, "launches"),
                MP.KERNEL: (MP, "launches"),
                RES.KERNEL: (RES, "launches"),
                RES.PLAN_KERNEL: (RES, "plan_launches"),
                C.KERNEL: (C, "launches"),
                C.COPY_KERNEL: (C, "copy_launches"),
                C.MAILBOX_KERNEL: (C, "mailbox_launches"),
                FF.KERNEL: (FF, "launches"), SG.KERNEL: (SG, "launches"),
                TA.KERNEL: (TA, "launches"), RHO.KERNEL: (RHO, "launches")}
    sources = [FP.KERNEL, FP3.KERNEL, MP.KERNEL, RES.KERNEL,
               RES.PLAN_KERNEL, C.KERNEL, C.MAILBOX_KERNEL, FF.KERNEL,
               SG.KERNEL, TA.KERNEL, RHO.KERNEL]

    # --- phase 2: build every kernel, in parallel ---
    t0 = time.perf_counter()
    libs = _build.build_many(sources)
    print(f"build: {', '.join(lib.name for lib in libs)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for name in sources:
        log = _build.build_log(name)
        if "sm_90a" not in log:
            fail(f"{name} was not built for sm_90a")
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  {name}: " + line.strip())
    ta_spills = [ln for ln in _build.build_log(TA.KERNEL).splitlines()
                 if "spill stores" in ln]
    if not ta_spills or any("0 bytes spill stores" not in ln
                            for ln in ta_spills):
        fail(f"{TA.KERNEL}'s kernels spill: {ta_spills}")
    per_sm = [(FP._kernel_lib().fused_push2d_blocks_per_sm(w),
               FP3._kernel_lib().fused_push3d_blocks_per_sm(w))
              for w in (0, 1)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"occupancy: 1024-thread CUDA blocks per SM: fused_push2d "
          f"{per_sm[0][0]} (WALLS instance {per_sm[1][0]}), fused_push3d "
          f"{per_sm[0][1]} (WALLS instance {per_sm[1][1]}) (registers and "
          f"the deposit tile in shared memory; {sms} SMs)")
    if min(min(p) for p in per_sm) < 1:
        fail("a push kernel instance does not fit on an SM")
    results = {}

    def sharded(sc08_drift, recon_drift=None):
        # --- phases 24-28: decomposed runs, one process per rank ---
        sharded_phases(torch, counters, card, results, sc08_drift,
                       recon_drift)

    if decomposed_only:
        from vpic_tpu_torch.scripts import deck_checks as DC
        for k in ("fused_push2d_walls", "fused_push3d_walls", MP.KERNEL):
            results[k] = dict(launches=0, max_abs_err=0.0)
        r = DC.sc08_demo("cuda", n_steps=SHARDED_STEPS[2])
        print(f"run sc08 demo, one domain: drift {r['drift']:.3e}")
        sharded(r["drift"])
        print(json.dumps({k: {"launches": v["launches"],
                              "max_abs_err": v["max_abs_err"]}
                          for k, v in results.items()}))
        print("partial run (phases 1-2 and 24-28): ok")
        return 0

    # --- phase 3: 2-D kernel against its plain version ---
    sim = harris.build(harris.HarrisParams())
    t0 = time.perf_counter()
    state = sim.initialize()
    torch.cuda.synchronize()
    print(f"initialize: 64^2 x 64 ppc harris in "
          f"{time.perf_counter() - t0:.1f} s")
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    extents = [st.count for st in sim.species]
    sorted_sp = [FP.bucket_sort_p(sp, g, extent=e)
                 for sp, e in zip(state.species, extents)]
    fcoef = I.load_interpolator(state.fields, g)
    max_err = compare_push(torch, PT, FP, g, sorted_sp, fcoef, qms,
                           "first push after the sort")
    ms, plain_ms, ms2, plain_ms2 = (
        PT.time_push(fn, g, sorted_sp, fcoef, qms)
        for fn in (FP.fused_push_multi, FP.fused_push_multi_ref) * 2)
    dev_ms = PT.push_device_ms(FP.fused_push_multi, "fused_push2d_kernel",
                               g, sorted_sp, fcoef, qms)
    print(f"timing ({card}): 2-D kernel {ms:.4f} / {ms2:.4f} ms, plain "
          f"{plain_ms:.4f} / {plain_ms2:.4f} ms per push of both species "
          f"(CUDA events, mean of {PT.REPS}, order "
          "kernel-plain-kernel-plain); "
          f"kernel device time {dev_ms:.5f} ms per push of both species "
          f"(torch.profiler, {PT.REPS} pushes)")
    nbytes, flops = push_bytes(sorted_sp, g,
                               sum(sp.capacity for sp in sorted_sp))
    bms, bby = bound_ms(nbytes, flops)
    results[FP.KERNEL] = dict(
        name=FP.KERNEL, route="cuda",
        source="vpic_tpu_torch/csrc/fused_push2d.cu",
        replaces="vpic_tpu/ops/pallas_push.py:251", max_abs_err=max_err,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
        library_ms=None)

    # --- phase 4: small 2-D deck against the CPU plain path ---
    small_reference(torch, harris, harris.HarrisParams(
        nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0), "16^2 x 4 ppc harris")

    # --- phase 5: the 2-D main path, 200 steps ---
    n_particles = sum(int(sp.np) for sp in state.species)
    e0 = sim.energies(state).double().cpu().numpy()
    FP.deposits = None
    state, elapsed, launches = run_steps(torch, sim, state, N_STEPS,
                                         counters)
    drift, unfinished = check_run(torch, sim, state, e0, "2-D run")
    global_share(FP, f"{N_STEPS} steps")
    rate = n_particles * N_STEPS / elapsed
    print(f"run 2-D: {N_STEPS} steps, {n_particles} particles, "
          f"{elapsed * 1e3 / N_STEPS:.3f} ms/step, {rate:.4e} pushes/s "
          f"({card}, host clock around synchronize)")
    print(f"run 2-D: launches {launches}, unfinished streaks {unfinished}, "
          f"host syncs {sim.host_syncs}, energy drift {drift:.3e}, max "
          "memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if launches[FP.KERNEL] < N_STEPS:
        fail(f"2-D push kernel launched {launches[FP.KERNEL]} times in "
             f"{N_STEPS} steps")
    beb_main = trio_once_a_step(sim, launches, N_STEPS, "2-D run")
    results[FP.KERNEL]["launches"] = launches[FP.KERNEL]
    # 7 more steps (the first of them sorts): the lanes of the last push
    # before the next sort, where the most rounds take the global path
    step = step_of(sim)
    for _ in range(7):
        state = step(state)
    max_err = max(max_err, compare_push(
        torch, PT, FP, g, state.species, I.load_interpolator(state.fields, g),
        qms, f"{N_STEPS + 7} steps (7 pushes after a sort)"))
    results[FP.KERNEL]["max_abs_err"] = max_err
    del sim, state, sorted_sp, fcoef, step

    # --- phase 6: 3-D kernels against their plain versions ---
    p3 = harris.HarrisParams(nx=32, ny=32, nz=32, nppc=128, Lx=16.0,
                             Ly=16.0, Lz=16.0)
    t0 = time.perf_counter()
    sim = harris.build(p3)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = sim.initialize()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    g = sim.grid
    res_on, slack = sim._residency_mode()
    if not res_on:
        fail("the 32^3 x 128 ppc harris deck does not run residency")
    print(f"initialize: 32^3 x 128 ppc harris, deck build (host staging) "
          f"{t_build:.1f} s, initialize() {t_init:.1f} s; residency slack "
          f"{slack} blocks per brick")
    qms = [(st.params.q, st.params.m) for st in sim.species]
    n0 = [st.count for st in sim.species]
    exts = RES.extents(g, n0, slack)
    species, homes = [], []
    for sp, n, E in zip(state.species, n0, exts):
        s, h = FP3.brick_sort_p_home(RES.slice_species(sp, E), g, extent=n,
                                     slack=slack)
        species.append(s)
        homes.append(h)
    fcoef = I.load_interpolator(state.fields, g)
    kw = dict(homes=homes, residency=True)
    err3, ker = compare_push3d(torch, PT, FP3, g, species, homes, fcoef, qms,
                               "first push after the first rebucket")
    sk, _, em_k, obx_k, ores_k, _ = ker
    ms3, plain3, ms3b, plain3b = (
        PT.time_push(fn, g, species, fcoef, qms, **kw)
        for fn in (FP3.fused_push3d_multi, FP3.fused_push3d_multi_ref) * 2)
    dev3 = PT.push_device_ms(FP3.fused_push3d_multi, "fused_push3d_kernel",
                             g, species, fcoef, qms, **kw)
    print(f"timing ({card}): 3-D kernel {ms3:.4f} / {ms3b:.4f} ms, plain "
          f"{plain3:.4f} / {plain3b:.4f} ms per push of both species "
          f"(CUDA events, mean of {PT.REPS}, order "
          "kernel-plain-kernel-plain); "
          f"kernel device time {dev3:.5f} ms per push of both species "
          f"(torch.profiler, {PT.REPS} pushes)")
    slots = sum(sp.capacity for sp in species)
    M = obx_k.vox.shape[0]
    nbytes, flops = push_bytes(species, g, slots,
                               extra=slots + M * 33 + 4 * (M // 128))
    bms, bby = bound_ms(nbytes, flops)
    results[FP3.KERNEL] = dict(
        name=FP3.KERNEL, route="cuda",
        source="vpic_tpu_torch/csrc/fused_push3d.cu",
        replaces="vpic_tpu/ops/pallas_push3d.py:369", max_abs_err=err3,
        ms=ms3, plain_ms=plain3, bound_ms=bms, bound_by=bby,
        library_ms=None)

    # the exchange plan of the kernel push's outputs: the plan kernels
    # against the plain version, bit for bit, and timed
    _, spid, usable = RES.static_layout(exts)
    pargs = (sk, em_k, obx_k, ores_k, homes, spid, usable, g)
    plan_k = RES.plan(*pargs)
    plan_r = RES.plan_ref(*pargs)
    torch.cuda.synchronize()
    routed = int(plan_r.stats[0])
    n = min(routed, plan_r.compact.vox.shape[0])
    for what, x, y in (
            ("compact.f", plan_k.compact.f[:, :n], plan_r.compact.f[:, :n]),
            ("compact.vox", plan_k.compact.vox[:n], plan_r.compact.vox[:n]),
            ("compact.valid", plan_k.compact.valid, plan_r.compact.valid),
            *((name, getattr(plan_k, name), getattr(plan_r, name))
              for name in ("starts_j", "a_j", "stats", "overflow",
                           "misplaced", "rebuild"))):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.view(torch.int32) if x.dtype == torch.float32 else x,
                y.view(torch.int32) if y.dtype == torch.float32 else y):
            fail(f"3-D plan: the kernels' {what} differs from plain")
    if bool(plan_k.overflow):
        fail("3-D: the first exchange plan overflows (the step would "
             "rebucket), so the merge would not run")
    compact, starts_j, a_j, stats = (plan_k.compact, plan_k.starts_j,
                                     plan_k.a_j, plan_k.stats)
    kplan = lambda: RES.plan(*pargs)
    rplan = lambda: RES.plan_ref(*pargs)
    plan_ms, plan_plain, plan_ms2, plan_plain2 = (
        cuda_ms(fn, PT.REPS) for fn in (kplan, rplan, kplan, rplan))
    plan_dev = kernel_device_ms(kplan, "res_plan_", PT.REPS)
    plan_plain_dev = device_ms(rplan, PT.REPS)
    # the plan's own bytes: live, emit and voxel of every slot; valid and
    # voxel of every outbox row, read twice; 8 words each way of every
    # routed row
    rows = obx_k.vox.shape[0]
    nbytes = slots * 6 + rows * 10 + routed * 64
    pbms, pbby = bound_ms(nbytes, 0)
    print(f"compare: plan kernels == plain plan, bit for bit ({routed} "
          f"rows routed, rebuild {bool(plan_k.rebuild)})")
    print(f"timing ({card}): plan kernels {plan_ms:.4f} / {plan_ms2:.4f} "
          f"ms, plain {plan_plain:.4f} / {plan_plain2:.4f} ms per plan of "
          f"both species (CUDA events, best of 3 windows of {PT.REPS}, "
          "kernel-plain-kernel-plain); device time: kernels "
          f"{plan_dev:.5f} ms in {RES.PLAN_LAUNCHES} launches, plain "
          f"{plan_plain_dev:.5f} ms (torch.profiler); bound {pbms:.5f} ms "
          f"({nbytes / 1e6:.1f} MB, {100 * pbms / plan_dev:.1f} % of it)")
    results[RES.PLAN_KERNEL] = dict(
        name=RES.PLAN_KERNEL, route="cuda",
        source="vpic_tpu_torch/csrc/res_plan.cu",
        replaces="none: vpic_tpu/ops/residency.py's plan is plain jnp",
        max_abs_err=0.0, ms=plan_ms, plain_ms=plan_plain, bound_ms=pbms,
        bound_by=pbby, library_ms=None)
    src = PT.clone_species(sk)          # the pushed lanes, kept
    ka, kb = PT.clone_species(sk), PT.clone_species(sk)
    mk = RES.merge_p(ka, em_k, compact, starts_j, a_j, ka)
    mr = RES.merge_p_ref(kb, em_k, compact, starts_j, a_j, kb)
    torch.cuda.synchronize()
    merge_err = 0.0
    changed = 0
    for k, (a, b, x0) in enumerate(zip(mk, mr, src)):
        moved = a.live != x0.live
        for n in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w"):
            x, y = getattr(a, n), getattr(b, n)
            merge_err = max(merge_err, float(
                (x.double() - y.double()).abs().max()))
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                fail(f"merge species {k}.{n}: kernel differs from plain")
            moved |= x.view(torch.int32) != getattr(x0, n).view(torch.int32)
        if not torch.equal(a.live, b.live) or int(a.np) != int(b.np) or \
                int(a.np) != int(a.live.sum()):
            fail(f"merge species {k}: live lanes differ")
        changed += int(moved.sum())
    routed, placed = int(stats[0]), int(a_j.sum())
    print(f"compare: merge kernel in place == plain version in every lane, "
          f"bit for bit ({routed} rows routed, {placed} placed, {changed} "
          f"of {slots} slots changed)")
    work = PT.clone_species(sk)

    def restore():
        for w, x0 in zip(work, src):
            for n in FP3.LANE_FIELDS:
                getattr(w, n).copy_(getattr(x0, n))

    merge = lambda: RES.merge_p(work, em_k, compact, starts_j, a_j, work)
    merge_ref = lambda: RES.merge_p_ref(work, em_k, compact, starts_j, a_j,
                                        work)
    merge_ms, merge_plain, merge_ms2, merge_plain2 = (
        cuda_ms(fn, PT.REPS, setup=restore)
        for fn in (merge, merge_ref, merge, merge_ref))
    merge_dev = kernel_device_ms(merge, "merge_kernel", PT.REPS,
                                 setup=restore)
    # bytes written to new arrays (the bound row 3 has kept since it was
    # ported): live + emit per slot, keepers' 8 words read, newcomers' 8
    # words read, starts and counts, every slot's 8 words + live written
    keepers = sum(int((s.live & ~e).sum()) for s, e in zip(sk, em_k))
    nbytes = (slots * 2 + keepers * 32 + placed * 32 + 8 * a_j.shape[0]
              + slots * 33)
    bms, bby = bound_ms(nbytes, 0)
    # in place, the least: the marks of every slot, 8 words read and 8
    # words + live written per slot that changes, the newcomers' 8 words,
    # starts and counts
    inplace = slots * 2 + changed * 65 + placed * 32 + 8 * a_j.shape[0]
    ibms, _ = bound_ms(inplace, 0)
    print(f"timing ({card}): merge kernel {merge_ms:.4f} / {merge_ms2:.4f} "
          f"ms, plain {merge_plain:.4f} / {merge_plain2:.4f} ms per merge "
          f"of both species (CUDA events around each call, input restored "
          f"before it, best of 3 windows of {PT.REPS}, "
          "kernel-plain-kernel-plain); kernel device time "
          f"{merge_dev:.5f} ms (torch.profiler, {PT.REPS} merges); bound "
          f"{bms:.5f} ms written to new arrays ({nbytes / 1e6:.1f} MB, "
          f"{100 * bms / merge_dev:.1f} % of it), {ibms:.5f} ms in place "
          f"({inplace / 1e6:.1f} MB, {100 * ibms / merge_dev:.1f} %)")
    results[RES.KERNEL] = dict(
        name=RES.KERNEL, route="cuda", source="vpic_tpu_torch/csrc/merge_p.cu",
        replaces="vpic_tpu/ops/residency.py:232", max_abs_err=merge_err,
        ms=merge_ms, plain_ms=merge_plain, bound_ms=bms, bound_by=bby,
        library_ms=None)
    del ker, sk, mk, mr, ka, kb, src, work, compact, species, fcoef
    del plan_k, plan_r, pargs, kplan, rplan
    # the IF node's condition kernel: its plain version is the eager step's
    # host read of the bool; it reads one byte
    bms, bby = bound_ms(1, 0)
    results[SG.KERNEL] = dict(
        name=SG.KERNEL, route="cuda", source="vpic_tpu_torch/csrc/graph_cond.cu",
        replaces="vpic_tpu/deck.py:1406", max_abs_err=None, ms=None,
        plain_ms=host_read_ms(torch), bound_ms=bms, bound_by=bby,
        library_ms=None, launches=0)

    # --- phase 7: small 3-D deck against the CPU plain path ---
    small_reference(torch, harris, harris.HarrisParams(
        nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0, Lz=8.0, headroom=6.0),
        "16^3 x 4 ppc harris (residency)")

    # --- phase 8: the 3-D residency path, 100 steps ---
    n_particles = sum(int(sp.np) for sp in state.species)
    e0 = sim.energies(state).double().cpu().numpy()
    ptrs = [[getattr(sp, n).data_ptr() for n in FP3.LANE_FIELDS]
            for sp in state.species]
    FP3.deposits = None
    state, elapsed, launches = run_steps(torch, sim, state, N_STEPS_3D,
                                         counters)
    if ptrs != [[getattr(sp, n).data_ptr() for n in FP3.LANE_FIELDS]
                for sp in state.species]:
        fail("3-D run: the species tensors changed storage")
    drift, unfinished = check_run(torch, sim, state, e0, "3-D run")
    global_share(FP3, f"{N_STEPS_3D} steps")
    rebuckets = int(state.diag["_res_rebuckets"])
    rate = n_particles * N_STEPS_3D / elapsed
    print(f"run 3-D: {N_STEPS_3D} steps, {n_particles} particles, "
          f"{elapsed * 1e3 / N_STEPS_3D:.3f} ms/step, {rate:.4e} pushes/s "
          f"({card}, host clock around synchronize)")
    print(f"run 3-D: launches {launches}, rebuckets {rebuckets}, host syncs "
          f"{sim.host_syncs}, unfinished streaks {unfinished}, energy drift "
          f"{drift:.3e}, max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"initialize() {t_init:.1f} s")
    nsp = len(state.species)
    if launches[FP3.KERNEL] < N_STEPS_3D:
        fail(f"3-D push kernel launched {launches[FP3.KERNEL]} times")
    if launches[RES.KERNEL] != N_STEPS_3D - rebuckets or \
            launches[RES.KERNEL] == 0:
        fail(f"merge kernel launched {launches[RES.KERNEL]} times with "
             f"{rebuckets} rebuckets in {N_STEPS_3D} steps")
    if sim.host_syncs != EAGER[sim]:
        fail(f"{sim.host_syncs} host syncs in {N_STEPS_3D} steps, "
             f"{EAGER[sim]} of them eager")
    if launches[SG.KERNEL] != 2 * (N_STEPS_3D - EAGER[sim]) or \
            launches[SG.KERNEL] == 0:
        fail(f"{launches[SG.KERNEL]} IF conditions in {N_STEPS_3D} steps, "
             f"{EAGER[sim]} of them eager")
    results[SG.KERNEL]["launches"] += launches[SG.KERNEL]
    beb_main += trio_once_a_step(sim, launches, N_STEPS_3D, "3-D run")
    if launches[RES.PLAN_KERNEL] != RES.PLAN_LAUNCHES * N_STEPS_3D:
        fail(f"plan kernels launched {launches[RES.PLAN_KERNEL]} times in "
             f"{N_STEPS_3D} steps")
    results[FP3.KERNEL]["launches"] = launches[FP3.KERNEL]
    results[RES.KERNEL]["launches"] = launches[RES.KERNEL]
    results[RES.PLAN_KERNEL]["launches"] = launches[RES.PLAN_KERNEL]
    print("run 3-D: the species tensors kept their storage over the "
          f"{N_STEPS_3D} steps")
    merge_calls, merge_dev, state = merge_per_step(torch, step_of(sim),
                                                   state)
    print(f"run 3-D: merge kernel {merge_calls:.2f} launches and "
          f"{merge_dev:.5f} device ms a step (torch.profiler, 10 more "
          f"steps; {card})")
    # the residency lanes and home maps the run left, kernel against plain
    err3, _ = compare_push3d(
        torch, PT, FP3, g, [RES.slice_species(sp, E)
                            for sp, E in zip(state.species, exts)],
        [state.diag[f"_chart_home{k}"] for k in range(nsp)],
        I.load_interpolator(state.fields, g), qms,
        f"{N_STEPS_3D + 10} steps after the first rebucket")
    results[FP3.KERNEL]["max_abs_err"] = max(
        results[FP3.KERNEL]["max_abs_err"], err3)
    del sim, state

    # --- phase 9: the residency prototypes' entry points ---
    results.update(residency_prototypes(counters, card))

    # --- phase 10: the fused field trio's entry point ---
    results[FF.KERNEL] = field_trio_phase(torch, RF, FF, counters, card,
                                          beb_main)

    # --- phases 11-14: wall faces ---
    results.update(wall_phases(torch, counters, card))

    # --- phases 15-17: the deck runner, restarts, dumps, materials ---
    io_phases(torch, counters, card)

    # --- phases 18-21: collisions, emission, aged injection ---
    recon_drift = stochastic_phases(torch, counters, card, results)

    # --- phases 22-23: the nine sample decks, sc08 at the demo size ---
    sc08_drift = deck_phases(torch, counters, card, results)
    sharded(sc08_drift, recon_drift)

    # --- phase 29: the graphed step ---
    graph_phase(torch, counters, card, results)

    # --- phase 30: the cleaners' charge deposit ---
    results[RHO.KERNEL] = rho_phase(card)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
