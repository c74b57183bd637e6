"""Drive the PyTorch port's main path once on one CUDA card.

The run that bench.py times, through timemachine_torch: solvated DHFR
(23,558 atoms, waters first), HMR masses, 400 FIRE steps, then Langevin
BAOAB at 2.5 fs and 300 K with a Monte Carlo barostat every 25 steps. The
nonbonded term runs through the hand-written rowscan kernel
(timemachine_torch/csrc/rowscan.cu); forcefield-parameter gradients and the
kernel="v1" configuration run through the hand-written block-tile kernel
(timemachine_torch/csrc/nb_tiles.cu); the kernel="gather", kernel="quad" and
kernel="dot" configurations run through the hand-written gather, quadscan
and dotscan kernels (csrc/gather.cu, csrc/quadscan.cu, csrc/dotscan.cu);
HREX's replicas run through the rowscan kernel's replica-batched form (REST's
too), local MD's steps through its masked form; two
probes measure the card (csrc/probe_fma.cu, csrc/probe_bf16.cu). All seven
are built here with nvcc for sm_90a, in parallel.

Phases, one line each or more: the device; the kernel builds; the rowscan
kernel against its plain PyTorch version at DHFR shapes, in the main path's
form (Newton-triangular lists, row-center images, no w: JAX's default DHFR
path, with rowscan_has_w computed as bench.py does) in F and U, in the
energy/force entry's form (triangular, minimum image, w) in F+U, and in
the symmetric form (the kernel's first design) in F mode, with both
forms' slots, times and bounds and the main form's F time held under
REDESIGN_RATIO of the symmetric one's; the main form's MD force against the symmetric form's, and
the whole force on the card against the same modules on the host CPU; the
main path (1,000 warm-up and 1,000 timed NPT steps, with ns/day), then 50
steps under torch.profiler for the device's busy time per step (its table
goes to standard error), and at the end state the image-bound margin and
the largest |dU/dx| against the kernel's fixed-point limit; bitwise determinism of
two fresh Contexts;
the block-tile kernel against its plain version at DHFR shapes in its
Newton-triangular form (every path's) in modes DP (A&S 7.1.26, the
training path's du/dp form, and erfc, kernel="v1"'s), UF (exact and
polynomial) and F, and in its symmetric form (the first design) in DP
(A&S) and F, with the slots listed, kept by the kernel's sub-tile and column culls
and swept, the bounds, the triangular / symmetric time ratio in DP and F held under
NB_REDESIGN_RATIO, and the largest |DP column| against the fixed-point
limit; du/dp training: 5 Adam steps on a
protein charge scale through a reweighting estimator over 8 NPT frames
(the largest |DP column| over the frames, device busy per step); the
kernel="v1" path: its force against the rowscan configuration's, then 500
NPT steps; the kernel="gather" path [9], the kernel="quad" path [10] and the
kernel="dot" path [11], each from the minimized start: list shapes and build
time, the kernel against its plain version in F and F+U, the net force
against the rowscan configuration's, 500 NPT steps and two bitwise-equal
100-step runs (gather and quad also: the largest |dU/dx| after the run
against the kernels' fixed-point limit; quad also: the configuration
taken, the constant-shift margin; dot also: the sort taken, both list
forms, the image-bound margin before and after the run, its MD provider's
force against rowscan's). Phases 9-11 also print the pair slots listed,
kept by the redesigned kernel's column cull (gather: of its
Newton-triangular suffixes) and swept after chunk padding (held under
GATHER_SWEPT_SHARE or SWEPT_SHARE of the listed; counted by cull_census,
the plain copy of the kernel's cull and chunking, not by the kernel), and
the redesign against the first design in F in the same run (gather: its
full-list kernel, held under GATHER_REDESIGN_RATIO; quad: its first
kernel, held under QUAD_REDESIGN_RATIO; dot: the symmetric form, its
first design, held under DOT_REDESIGN_RATIO); phase 10
also holds quad's no-w form against its plain version, with its time and
bound. The probes [12]: the FP32
FMA rate at INNER and twice INNER (the time must double) beside the data
sheet's peak, the bf16 and f32 gate rates, each probe bitwise against its
plain version; the gate probe's redesign and first design in both types at
ITERS x (1, 4, 8, 16, 32) iterations, with the slope (marginal time per
ITERS), the intercept (fixed cost per launch), the time from 16 to 32 ITERS
(held in PROBE_RATIO) and the redesign / first design marginal bf16 time
(held under GATE_REDESIGN_RATIO), each of the four kernels bitwise against
the plain version at ITERS and 4 ITERS; the tile census of the DHFR start,
held to the script's counts. The solvent RBFE leg [13]: the 12 ethanol -> propane
windows of timemachine_torch/testsystems/cache/ (6,404 atoms, the hybrid
ligand masked out of the host term) loaded on the card; the rowscan kernel
in the masked form (triangular, minimum image, w) against its plain version
in F, U and F+U, with two masked atoms on one point and two at r^2 = 2.5e-7,
and the block-tile DP pass under the mask; each window-0 term's force on the
card against the host CPU's; run_sims_sequential over the 12 windows in one
reused Context (depth cut to N13_EQ equilibration steps and N13_FRAMES
frames of N13_STEPS_PER_FRAME; ns/day per window on the host clock) and pair
BAR, the host term's works exactly zero; a window step's device idle share;
a window in a fresh Context against the same window after reset_for_state,
bitwise. HREX over the same 12 windows [14]: the replica-batched masked
sweep (one launch for every replica, csrc/rowscan.cu's system axis) in F
over the K = 12 replicas and in U over the banded energies' K (2
max_delta_states + 1) = 108 systems, each system bitwise against its
single launch and per column against rowscan_sweep_batched_plain, with
its time, K (or 108) single launches' time, the plain time and the bound;
the banded U_kl after a segment against single-system f64 sums of each
term's u at the target state's parameters (TOL_BANDED_REL, the +inf
pattern identical); the kernel launches of a step without a rebuild or a
barostat move at K = 2 and K = 12, counted in a CUDA graph that captures
the step, which must be equal; run_sims_hrex
(depth cut to N14_EQ equilibration steps and N14_FRAMES iterations of
N14_STEPS_PER_FRAME) with the time per iteration, replica-steps per second
against phase 13's sequential window step, the swap acceptance per pair,
pair BAR and the edge's dG; the batched step's time and device idle share.
The state builder [15]: the same 12 windows built on this machine by
timemachine_torch's builder (testsystems/rbfe_solvent.py build_rbfe_solvent:
SMILES, the cache's conformers, AM1 charges in strict mode, the force field,
the atom mapping, the single topology, the water box, setup_initial_state;
only x0 and box0 from the cache), each stage's host seconds; the core, every
window's index arrays, masses, barostat groups and seeds, interacting atoms
and v0 equal to the cache's, every parameter within TOL_BUILD_REL of its
column's largest |value| but the columns of the AM1 charges, held in charge
units within TOL_CHARGE_E (their relative difference, the host's numpy and
OpenBLAS kernels printed); the count of windows bitwise the cache's and of
equal integrator seeds (printed); at window N15_WINDOW the total force at
the cache's x0 against the cache-loaded state's (TOL_BUILD_FORCE of the
all-pairs norm), and N15_STEPS steps from the built state, finite, on the
masked rowscan kernel every step, and with the cache's integrator seed
bitwise the cache-loaded state's run. The solvent leg from two SMILES
[16]: fe/rbfe.py run_solvent as a user calls it, on ethanol and propane
embedded from SMILES (N16_WINDOWS windows, depth cut to N16_EQ
equilibration steps, N16_FRAMES frames of N16_STEPS_PER_FRAME and
N16_FRAMES_BISECTION bisection frames), with each stage's host seconds
(the embedding, the host's FIRE and NPT, the anchors' λ-chain
minimization, bisection, HREX); the conformers against the cache's
(TOL_EMBED) and the core; the ligand bitwise unmoved through the host's
NPT run, the host's largest |F| under MAX_FORCE_NORM and its box volume
against the cache's box0; per anchor window its BFGS calls, its float64
energy before and after (it must fall) and its largest displacement (at
most N16_MIN_CUTOFF); window 0 minimized again, bitwise; the bisection's λ
schedule and overlaps; HREX's acceptance, ΔG and 11 finite BAR pairs; the
rowscan and nb_tiles launches by stage and form, with no plain sweep: the
host's FIRE and every minimization on nb_tiles' exact form alone (JAX's
"tiled" and fresh dense forms at 6,404 atoms), the NPT runs, bisection and
HREX on the rowscan kernel alone. The exact-erfc and masked forms [17]: at
window 0 of the cached leg under the host mask, the host term configured
kernel="v1", "gather" and "dot"; nb_tiles' exact F and F+U, gather's F and
F+U and dot's MD F against their plain versions (TOL_KERNEL_COL, bitwise on
a repeat launch, CUDA-event times); gather's and dot's all-pairs force
against the masked rowscan form's (TOL_ALT_FORCE); v1's float64 minimizer
energy and force against the CPU's float64 dense form (TOL_F64_U_ROUNDINGS,
TOL_FORCE_REL_NORM), and a control with A&S 7.1.26 in place of erfc that
must fail one of the two; N17_STEPS NPT steps of window N17_WINDOW under each,
finite, bitwise on repeat, its own kernel every step; each form's time
against its bound over the window's host pairs. REST and local MD [18]: the
12 windows built with SingleTopologyREST (fe/rest/) at DEFAULT_REST_PARAMS'
scale against phase 15's plain windows (the region, its seeds and the target
propers printed; windows 0 and 11 bitwise, the scaled entries the plain ones
times the scale within TOL_REST_REL, every other entry bitwise);
run_sims_hrex over the 12 REST windows, one batched F launch a step; local
MD on window N18_WINDOW in both freeze_reference modes (frozen atoms' x and
v bitwise unmoved, the reference frozen, no barostat move, finite in
float32 with the reference free, bitwise on repeat, one masked F launch a
local step) and with an explicit selection; run_solvent from the two SMILES
with REST and local MD (its HREX time-multiplexed in one Context), each
stage's seconds and launches by form, ΔG and the BAR pairs. The absolute
hydration leg [19] of ethanol from SMILES (fe/absolute_hydration.py):
run_solvent at N19_WINDOWS windows (each stage's seconds, the rowscan and
nb_tiles launches by stage and form: the host's FIRE on nb_tiles' exact
form alone, the windows' MD on the masked rowscan form alone; ΔG beside
FreeSolv's experimental value, 7 finite BAR pairs; the interaction group
exactly 0 at λ = 1; window 0's card force against the host CPU's; a reused
window bitwise a fresh one); the SMC path at a cut depth: the solvent-phase
system and its NPT samples on nb_tiles' exact form (a fresh Context's form
at over 4,096 atoms), the vacuum walkers, the endstate samples and
sequential_monte_carlo over a fixed 6-λ schedule, decoupled to coupled (the
ESS at each λ, the estimate, every log weight finite, a rerun bitwise); one
OptimizedMTMMove of K aligned vacuum proposals (its acceptance probability,
the ligand's geometry kept through the alignment). Water sampling [20]: the
probe-in-water ladder of the JAX package's examples/water_sampling_hrex.py
at a 4.0 nm box (timemachine_torch/testsystems/water_sampling.py: the
adamantane cage embedded and solvated, 6,419 atoms, decoupled over 6 AHFE
windows) with the TIBD water sampler (md/exchange/) in HREX: one segment of a
ReplicaExchangeRunner's segment with its firing traced (the carried
weights against a float64 rebuild; the firing replayed through its records
of draws and accepts; the waters rigid, the probe and box
untouched), a firing after a water is planted on another in every replica
(each replica's force through the lists rebuilt after it against the host
CPU's float64 force, the lists from before it as the control that must
miss), a firing captured in a CUDA graph at K = 2 and 6 (equal launches), a
bitwise rerun, an HREX step with and without the sampler; run_sims_hrex at
a cut depth (one batched F launch a step, a list rebuild after every firing,
every firing's carried weights against a float64 rebuild, the
WaterSamplingDiagnostics' counts, acceptance and occupancy by window, ΔG);
one window by get_context + sample_with_context (its Context's lists after
a firing a fresh build's, bitwise); the time-multiplexed HREX with local MD
and the sampler (each segment's state's sampler parameters, the counts).
The standalone samplers, the training path and the last utilities [21]:
equilibrate_host_barker over phase 16's raw solvent-leg host at JAX's
defaults (the host du/dx's nb_tiles exact form once a step and once for the
final force check, nothing else; the host's largest |F|; the entry point
rerun from its seed for its first steps, bitwise; its first steps replayed
on the host CPU in float64 from the card's own states and draws, and its
du/dx there held against the CPU's), integrator.simulate of ethanol's walkers in vacuum (shape, finite,
bitwise rerun, ms a batched step), the forcefield-training demonstration
(optimize/training_demo.py) on ethanol at a cut depth (the label, each
round's loss, scale and free energies; a round's card gradient against a
float64 central difference on the CPU), lib.py's HilbertSort,
Neighborlist, NonbondedMolEnergy and SegmentedSumExp on DHFR, and the
CentroidRestraint and FanoutSummedPotential modules on DHFR against the
CPU's float64. The complex leg [22]: fe/rbfe.py run_complex as a user
calls it on the capped helix ACE-(ALA)24-NME of
timemachine_torch/testsystems/peptide.py (its PDB text written to a file;
12,518 atoms with the ligands) and phase 16's ethanol and propane posed 0.9 nm
from the helix axis, the core by the native MCS (its searches counted), at
N22_WINDOWS windows and phase 16's depth: the atom counts and the perceived
net charge (0), each stage's host seconds (the build's parse, perception,
Amber assignment and lattice; FIRE, NPT, the anchors' minimization,
bisection, HREX), BFGS calls and ms a call, the host's largest |F| after
FIRE and after NPT under MAX_FORCE_NORM, window 0's card force against the
host CPU's float64 (TOL_FORCE_REL_NORM of the all-pairs norm), ΔG per pair,
swap acceptance, and the rowscan and nb_tiles launches by stage and form:
FIRE and the minimizations on nb_tiles' exact form alone, NPT and bisection
on the masked rowscan form alone, HREX on the batched form, no plain sweep
and no launch outside the stages. HREX checkpoint and resume [23]: phase 14's
runner over the 12 windows takes 4 iterations of 25 steps straight, a second
2, its pickled state_dict() loads into a fresh runner that takes the last 2,
and the resumed iterations are bitwise the straight run's (frames, boxes,
permutations, swap counts, U_kl) with equal launches, on the batched form
alone; the same on phase 20's probe ladder with the TIBD sampler firing after
the split (frames and sampler counters bitwise); an InteractionGroupTraj of
the ligand over the run's frames, its U and dU/dp on the card against the
host CPU's float64; the frames through StoredArrays; a DevicePoolClient task
launching the masked rowscan form in a spawned worker, bitwise this
process's launch; whether matplotlib imports and the estimators' plots
(None without it). The sorted-state step [25] (every single-system Context
above takes it where JAX's conditions hold, as JAX's default does; the
canonical step runs with md/context.py SORTED_MD off): phase 4's relaxed
DHFR (the main form) and phase 13's window 6 (the masked form), 100 steps
of each step from one start, x, v and box bitwise; 500 DHFR steps of each
in alternating rounds (ns/day, not gated) and the idle share; a step of
each captured in a CUDA graph (kernels a step); the shared contribution
plan's force on the card against the CPU's float64 (TOL_PLAN_REL). The reset's seed, the DHFR-size water box, the
prefactor energies and the examples [24]: `Context.reset_for_state(window
0, seed=)` twice over 100 NPT steps, bitwise, and another seed moving the
noise's and the barostat's generators; `setup_dhfr_scale_waterbox()` (its
atoms and build seconds, FIRE, the card's force against the host CPU's,
100 + 500 NPT steps on the rowscan main form with ns/day, launches a step
and the idle share, the image-bound margins and the largest |dU/dx|); the
coulomb and LJ interaction-group energies of window 0's ligand over 10
frames by the linear-basis prefactors, the card's float32 against the host
CPU's float64 and both times; and the five `timemachine_torch/examples/`
entry points through `main(argv)` at a cut depth (water_sampling_mc at
--box_width 4.0, run_rbfe_legs --legs vacuum solvent, relative_free_energy
--legs solvent; in the worker, after phase 22, biphenyl_torsion_sampling_hrex
twice, bitwise, and water_sampling_hrex at JAX's 3.0 nm): their lines,
seconds and launches by form (the legs' also by stage), the legs' host
pre-equilibration, run_rbfe_legs's bisection frames and biphenyl's
equilibration cut where no argument reaches them, run_rbfe_legs's legs in
this process. Phases 16, 19, 21 and 22 and phase 24's two dense examples
run in a second process (the worker: `chip_smoke.py --worker DIR T_START
EXACT_MS`, started after phase 17) while this one runs phase 20, phase 18,
which takes phase 16's embedded molecules from the worker, and phase 24;
the worker's lines follow phase 24's, then its additions to the kernels
line's rows, then phase 23, then phase 25, then phase 26. The mesh code
[26] on torch.distributed: the rowscan kernel's row slab at phase 4's
relaxed DHFR in the spatial runner's form (triangular, minimum image, w),
F and U, D = 1, 2, 4 and 8 slabs, their int64 accumulators summed before
the store bitwise the whole launch, each slab within TOL_KERNEL_COL of its
plain version, each slab's time beside its own pairs' bound;
make_spatial_md_runner of DHFR (NVT) on a one-rank nccl mesh against a
Context of the same seed (x's drift within TOL_DRIFT_RATIO of a control's),
ms a step of each, the idle share, one slab launch a step, bitwise on
repeat; the same run on two gloo ranks sharing the card, spawned and joined
by the phase (x's drift from one rank within the same bound);
run_hrex_sharded over phase 14's windows, and ReplicaExchangeRunner with a
one-rank replica mesh bitwise its no-mesh run, the per-rank cost of the
terms a replica mesh evaluates over the whole batch. Each phase
prints its host seconds ("[N time]"), and the script its total up to the
kernels line ("[time]").
Every path runs with all launch and plain-call counts set to
0 just before it and read just after. Then a JSON line on the kernels
(time; launches per NPT step of the path named in `path`, per Adam step of
the training path where the kernel has one, per replica-step of HREX for
the batched form (launches_rest_hrex: of REST's HREX), per local step for the
masked form (launches_local_md; launches_ahfe: per step of the AHFE
windows), per replica-step of the water-sampling HREX for the batched form
(launches_water_hrex), per run of phase 12 for the probes; nb_tiles' exact masked row
also launches_ahfe_fire, launches_smc, launches_mtm, launches_barker
and bound_ms_barker (phase 21's, per run and per launch); the masked,
batched and exact masked rows launches_run_complex (phase 22's); the batched
row launches_resume (phase 23's, per replica-step of the resumed HREX
iterations); the main row launches_sorted (phase 25's, per DHFR step under
the sorted-state step), launches_slabs, slab_ms, slab_plain_ms and
slab_bound_ms (phase 26's: slab launches per step of the spatial runner,
each slab's kernel and plain ms by mode and D, each slab's bound from the
pairs its row chunks sweep), launches_waterbox and launches_water_sampling_mc
(per step of each), the masked, batched and exact masked rows
launches_examples (phase 24's, per run of the examples); bound;
plain time), the card's name and power limit from
nvidia-smi, and as the last line {"ok": true, "device": {...}}.

Usage, from the repository root:  python3 chip_smoke.py
Without a CUDA card, or when any phase fails, the script exits non-zero and
prints no result.
"""

import atexit
import ctypes
import itertools
import json
import os
import pickle
import shutil
import subprocess
import sys
import time
from collections import Counter
from dataclasses import replace
from functools import partial

T_START = time.perf_counter()

TEMP, DT, FRICTION, PRESSURE, BAROSTAT_INTERVAL = 300.0, 2.5e-3, 1.0, 1.013, 25
# N_STEPS and N_FRAMES cut from 1000 and 8 when phase 21 came
N_FIRE, N_STEPS, N_PROFILE, N_DET = 400, 500, 50, 100
N_FRAMES, FRAME_INTERVAL, N_ADAM, ADAM_LR, S_START = 4, 100, 5, 2e-3, 1.01
N_ALT = 200  # 500 until phase 20 came
# phase 13, the solvent RBFE leg: depth cut from the JAX package's
# DEFAULT_MD_PARAMS (fe/rbfe.py: 10,000 equilibration steps, 1,000 frames of
# 400 steps) to fit the script's time; the 12 windows and 6,404 atoms are not cut
# (cut to 250 and 10 since phase 16 drives the leg end to end, to 100 and 10 frames of 30 since
# phase 17 runs too, to 3 frames since phase 20 runs too, to 50, 100 and 30 equilibration, timed and reused
# steps since phase 21 runs too, to 20 equilibration steps since phase 23 runs too)
N13_EQ, N13_FRAMES, N13_STEPS_PER_FRAME, N13_TIMED, N13_REUSE = 20, 3, 30, 100, 30
# phase 14, HREX over the same 12 windows: DEFAULT_HREX_PARAMS (fe/rbfe.py:
# max_delta_states 4, K^3 swap attempts an iteration) with its depth cut as
# phase 13's (10,000 equilibration steps, 1,000 frames of 400 steps in the
# JAX package); the windows, atoms and replicas are not cut
# (cut to 200 and 10 iterations of 50 from 500 and 20 when phase 18 came, to 100 and 4 iterations
# when phase 20 came, to 50 and 3 when phase 21 came)
N14_EQ, N14_FRAMES, N14_STEPS_PER_FRAME, N14_MAX_DELTA, N14_TIMED = 50, 3, 50, 4, 40
# phase 15, the state builder: the window whose force and run are held, the
# run's steps; the built parameters against the cache's relative to each
# column's largest |value|, and the force on phase 13's all-pairs norm. The
# columns that carry the ligands' AM1 charges (the interaction group's q, the
# pair list's q_i q_j) are held in charge units to the AM1 tolerance
# TOL_CHARGE_E instead, and their relative difference is printed: the AM1 SCF
# stops at |dE| < 1e-7, so the host's OpenBLAS build and kernels move the
# charges' last digits (by 9.9e-12 e against the cache on an H100 host with
# numpy 2.3.5's OpenBLAS, which is 1.07e-10 of the pair list's largest
# q_i q_j; `python -m timemachine_torch.probes.am1_host` measures it)
N15_WINDOW, N15_STEPS = 6, 200
# phase 16, run_solvent from two SMILES: ethanol -> propane embedded with
# seed 7 (the cache's embedding), 12 windows against DEFAULT_NUM_WINDOWS'
# 48, and DEFAULT_HREX_PARAMS' depth (10,000 equilibration steps, 1,000
# frames of 400 steps, 100 frames a bisection state) cut to 100, 10 of 25
# and 6 (200, 20 of 50 and 10 until phase 18 came, 100, 10 of 50 and 6 until
# phase 19 came), then to 6 frames and 2 bisection frames when phase 20 came, to 6 windows, 50
# equilibration steps and 4 frames when phase 21 came; the anchors'
# displacements held at min_cutoff 0.7 nm (JAX's
# estimators' default) and the embedded conformers to TOL_EMBED of the cache's
N16_EMBED_SEED, N16_WINDOWS, N16_MIN_CUTOFF, TOL_EMBED = 7, 6, 0.7, 1e-10
N16_EQ, N16_FRAMES, N16_STEPS_PER_FRAME, N16_FRAMES_BISECTION = 50, 4, 25, 2
# phase 18, REST and local MD: REST at DEFAULT_REST_PARAMS' scale (fe/rbfe.py:
# max_temperature_scale 3, exponential), its HREX over the 12 windows cut as
# phase 14's (100 equilibration steps, 10 iterations of 50; 4 since phase 20); local MD on
# window N18_WINDOW, N18_LOCAL steps a segment at LocalMDParams' default k
# and a 1.0 nm radius, an explicit selection of the N18_SELECTION atoms
# nearest a ligand atom; run_solvent with REST and LocalMDParams(local_steps=25)
# at 4 windows, 100 equilibration steps, 5 bisection frames and 10 HREX
# iterations of 50 steps (3 and 3 since phase 20). REST's scaled entries against the plain windows
# times the scale to TOL_REST_REL (one float64 product each: measured 0 on
# the CPU)
# (cut when phase 21 came: N18_EQ 100 -> 50, N18_FRAMES 4 -> 3, N18_RS_EQ 100 -> 50, N18_RS_FRAMES_BISECTION 3 -> 2)
N18_MAX_TEMPERATURE_SCALE, N18_EQ, N18_FRAMES, N18_STEPS_PER_FRAME = 3.0, 50, 3, 50
N18_WINDOW, N18_LOCAL, N18_LOCAL_K, N18_LOCAL_RADIUS, N18_LOCAL_SEED, N18_SELECTION = 6, 50, 1_000.0, 1.0, 2023, 30
N18_RS_WINDOWS, N18_RS_EQ, N18_RS_FRAMES_BISECTION, N18_RS_FRAMES, N18_RS_STEPS_PER_FRAME, N18_RS_LOCAL_STEPS = 4, 50, 2, 3, 50, 25
TOL_REST_REL = 1e-12
# phase 19, the absolute hydration leg of ethanol from SMILES (embedded with seed 7, AM1 in strict
# mode). Windowed: run_solvent's 4.0 + 0.1 nm box at N19_WINDOWS windows (n_windows cut from 16),
# DEFAULT_AHFE_MD_PARAMS' depth (10,000 equilibration steps, 1,000 frames of 400) cut to 100 and 10
# of 30 (3 of 30 since phase 20); a reused window N19_REUSE steps. SMC: the solvent-phase system at λ = 1 (a 3.0 +
# 0.5 nm box); pregenerate_samples' depth (50,000 equilibration steps, 1,000 solvent samples of
# 1,000 steps, 30,000 ligand batches of 250 steps after 2,000 of burn-in) cut to 200 (500 until phase
# 20 came), 4 of 100 (8 until then), and
# 8 walkers x 32 batches of 25 steps after 8 of burn-in (64 until phase 20 came); N_ENDSTATE_SAMPLES (5,000) cut to
# N19_ENDSTATE; N19_SMC_WALKERS walkers over N19_SMC_WINDOWS λ, N19_SMC_STEPS NPT steps a λ (25 until
# phase 20 came, 10 since), resampled
# below N19_RESAMPLE of the walkers' ESS; the MTM move's K; FreeSolv's experimental hydration free
# energy of ethanol, -5.00 kcal/mol (a published number, printed for information)
# (cut when phase 21 came: N19_EQ 100 -> 50, N19_REUSE 60 -> 30, N19_SMC_EQ 200 -> 100, N19_SOLVENT_SAMPLES 4 -> 2,
# N19_VAC_BATCHES 32 -> 16; when phase 23 came: N19_EQ 50 -> 20)
N19_EMBED_SEED, N19_SEED, N19_SMC_SEED = 7, 2023, 2022
N19_WINDOWS, N19_EQ, N19_FRAMES, N19_STEPS_PER_FRAME, N19_REUSE = 8, 20, 3, 30, 30
N19_SMC_EQ, N19_SOLVENT_SAMPLES, N19_STEPS_PER_SAMPLE = 100, 2, 100
N19_VAC_WALKERS, N19_VAC_STEPS_PER_BATCH, N19_VAC_BATCHES, N19_VAC_BURN_IN = 8, 25, 16, 8
N19_ENDSTATE, N19_SMC_WALKERS, N19_SMC_WINDOWS, N19_SMC_STEPS, N19_RESAMPLE, N19_MTM_K = 64, 8, 6, 10, 0.5, 8
FREESOLV_ETHANOL_KJ = -5.00 * 4.184
# the ligand's internal distances after alignment against the vacuum conformer's (nm), and the
# normalized SMC weights' sum against 1
TOL_ALIGNED_GEOMETRY, TOL_WEIGHT_SUM = 1e-5, 1e-12
# phase 20, water sampling: the probe-in-water ladder of the JAX package's examples/water_sampling_hrex.py
# (the adamantane cage embedded and solvated with seed 2024, decoupled over linspace(1, 0, 6) by AHFE
# states, HREXParams(), the TIBD sampler every 100 steps with 500 proposals, batch 250, radius 2 x 0.46
# nm) at its --box_width 4.0: 6,419 atoms, over the 4,096 at which the host term takes the rowscan sweep.
# Depth cut from the example's 1,000 + 50 x 100 steps to N20_EQ + N20_FRAMES x N20_STEPS_PER_FRAME: one
# firing a frame per replica, 12 in all. A firing's carried weights against a float64 rebuild (kT; the
# firing computes in float64, ROADMAP P29), the replay's raw log acceptance against the firing's, and
# the window of |min(raw, 0) - log u| inside which a decision may flip; the waters' O-H and H-H
# distances (nm).
# [20 control] places a copy of a water N20_PLANT_NM from it (nm) in every replica before a firing.
# [20 single]: one window by get_context + sample_with_context, N20_SINGLE_FRAMES frames; [20 local]: the
# time-multiplexed HREX with local MD over the last 2 windows, N20_TM_FRAMES frames, the sampler every
# N20_TM_INTERVAL steps with N20_TM_PROPOSALS proposals (firings in each segment's global steps)
# (cut when phase 21 came: N20_EQ 200 -> 100, N20_FRAMES 10 -> 5, a firing a frame per replica still;
# when phase 23 came: N20_EQ 100 -> 50, N20_FRAMES 5 -> 4, a firing a frame)
N20_BOX, N20_WINDOWS, N20_SEED, N20_EQ, N20_FRAMES, N20_STEPS_PER_FRAME = 4.0, 6, 2024, 50, 4, 100
N20_INTERVAL, N20_PROPOSALS, N20_BATCH, N20_RADIUS = 100, 500, 250, 2 * 0.46
N20_SINGLE_FRAMES, N20_TM_FRAMES, N20_TM_INTERVAL, N20_TM_PROPOSALS, N20_TM_LOCAL = 1, 1, 25, 100, 25
N20_PLANT_NM = 0.2
TOL_WEIGHT_DRIFT_KT, TOL_RAW_LOG_P, TOL_RIGID_NM = 1e-2, 1e-2, 1e-5
# the raw log p is held to TOL_RAW_LOG_P where it could decide (at or above RAW_DECISION_FLOOR: a uniform's
# log falls below it with probability e^-50); below, where a clash sends it to -1e20, the firing's must
# stay below half the floor, where no uniform can accept it either
RAW_DECISION_FLOOR = -50.0
# phase 21, the standalone samplers, the training path and the last utilities (since PR 18).
# [21 barker]: equilibrate_host_barker over phase 16's raw host (the solvent leg's 4.0 + 0.1 nm TIP3P box
# around ethanol and propane, 6,393 host atoms, not cut) at JAX's defaults (sigma 1e-4 nm, 1,000 steps, 300 K),
# seeded N21_SEED; the entry point again for its first N21_RERUN steps from the seed, its draws and states
# bitwise the first run's (a whole second chain takes about 17.5 s on an H100 host); the first run's first
# N21_REPLAY steps replayed on the host CPU in float64, each from the card's state with the card's own draws (a
# float64 host-CPU force at 6,393 atoms takes about 2.7 s there), to TOL_BARKER_REPLAY nm, a coordinate
# excepted where its flip decision fell within BARKER_FLIP_MARGIN of its threshold (|log u - log sigmoid(g z)|),
# and the card's du/dx there against the CPU's to TOL_FORCE_REL_NORM of its norm. [21 simulate]: integrator.simulate of N21_SIM_WALKERS walkers of
# ethanol in vacuum, N21_SIM_BATCHES batches of N21_SIM_STEPS steps. [21 train]: the training demo on ethanol
# (phase 16's, embedded with seed 7) at a depth cut from the JAX script's 8 walkers x 60 batches of 25 steps
# and 3 rounds of 60 Adam steps to N21_TRAIN_* (the walkers, steps a batch and Adam steps not cut); a round's
# card gradient against a central difference (step N21_FD_H) of its estimator in float64 on the CPU to
# TOL_TRAIN_FD relative. [21 lib] and [21 restraints] on DHFR: NonbondedMolEnergy per water to
# TOL_MOL_ENERGY relative, SegmentedSumExp to TOL_LSE, the restraints' energy to TOL_RESTRAINT_U relative
# and force to TOL_RESTRAINT_F of its norm, each card against the CPU in float64
N21_SEED, N21_REPLAY, N21_RERUN, TOL_BARKER_REPLAY, BARKER_FLIP_MARGIN = 2024, 3, 20, 1e-5, 1e-3
N21_SIM_WALKERS, N21_SIM_BATCHES, N21_SIM_STEPS, N21_SIM_SEED = 8, 2, 25, 2023
N21_TRAIN_WALKERS, N21_TRAIN_BATCHES, N21_TRAIN_STEPS, N21_TRAIN_ROUNDS, N21_TRAIN_ADAM = 8, 3, 25, 2, 60
N21_FD_H, TOL_TRAIN_FD = 1e-4, 1e-4
N21_NBLIST_CUTOFF, TOL_MOL_ENERGY, TOL_LSE, TOL_RESTRAINT_U, TOL_RESTRAINT_F = 1.2, 1e-5, 1e-12, 1e-6, 1e-5
# the CPU's float64 reference of NonbondedMolEnergy (mol_energies_near) takes 3-30 ms a water on an 8-core host,
# so it holds N21_MOL_HELD evenly spaced waters of the 7,023; N21_NEAR_MARGIN (nm) is more than a water's O-H
# distance
N21_MOL_HELD, N21_NEAR_MARGIN = 512, 0.3
# phase 22, the complex leg: run_complex on ACE-(ALA)N22_ALA-NME (timemachine_torch/testsystems/peptide.py, its
# axis along a box axis: a 5.1 nm box, over 12,000 atoms, past the 4,096 at which the host term takes the
# sweeps) with phase 16's ethanol and propane posed N22_POSE_NM from the helix axis; N22_WINDOWS windows against
# DEFAULT_NUM_WINDOWS' 48 and DEFAULT_HREX_PARAMS' depth cut as phase 16's; min_cutoff None
N22_ALA, N22_POSE_NM, N22_MIN_ATOMS = 24, 0.9, 10_000
N22_WINDOWS, N22_EQ, N22_FRAMES, N22_STEPS_PER_FRAME, N22_FRAMES_BISECTION = 4, 50, 4, 25, 2
EXACT_UF = "nb_tiles F+U triangular exact"  # the host du/dx's form (form_launches' name), as the host FIRE's
# phase 17, the exact-erfc and masked forms: the window whose NPT run each form takes, and its steps;
# the DHFR atoms (the protein's last) the dot form's mask leaves out, as many as the leg's hybrid ligand
N17_WINDOW, N17_STEPS, N17_DOT_OUT = 6, 100, 11
# the minimizer's float64 energy on the card (an f32 sweep, its per-atom
# energies summed in f64, the exclusions in f64 at the f32-rounded
# coordinates) against the same state built in float64 on the CPU (the plain
# sweep, all f64), at window 0's input and minimized coordinates, in units of
# one f32 rounding of the all-pairs term (2^-24 |U_all-pairs|: the noise a
# float32 total would put on every energy BFGS compares). The change of dU
# between the two coordinates, what BFGS and the energy-decrease check read,
# must stay under one such rounding. dU itself is mostly an offset: the
# water's rigid, identical pairs round alike, so their sweep errors add
# coherently (0.59-0.87 of a rounding on the CPU's plain f32 sweep,
# tests/test_torch_rbfe_coords.py; -0.12 to -0.27 on the card's exact form,
# phases 16 and 17 on an H100), and it may reach 2: the same reading with
# A&S 7.1.26 in place of erfc sits 4.46 roundings off (phase 17's control),
# so the limit tells the two forms apart. The gradient on
# TOL_FORCE_REL_NORM's scale, the all-pairs force norm, does not (6.4e-7
# against the control's 6.9e-7)
TOL_F64_U_CHANGE_ROUNDINGS, TOL_F64_U_ROUNDINGS = 1.0, 2.0
TOL_BUILD_REL, TOL_BUILD_FORCE, TOL_CHARGE_E = 1e-10, 1e-6, 1e-10
# the banded U_kl against single-system sums of each term's u at the target
# state's parameters: both accumulate in f64 (the host term's per-atom
# energies come bitwise from the same kernel), so only the f32 terms' own
# rounding is left (about 1e-8 of U)
TOL_BANDED_REL = 1e-6
# whole force on the card vs on the host CPU, both f32, relative to the
# all-pairs force: the net force is what is left after the exclusions
# cancel the all-pairs term's huge bonded-neighbour forces, so f32 rounding
# of those (the sweep's ~1e-6) sets the scale, not the small net
TOL_FORCE_REL_NORM = 1e-5
# every kernel vs plain PyTorch, per output column, both f32: the two sum
# each atom's pairs in different orders and the kernel's rsqrt is
# approximate (2 ulp)
TOL_KERNEL_COL = 1e-4
# the main path's rowscan form (triangular, preshift, no w) against the
# symmetric form (the kernel's first design) in F mode, in the same run: it sweeps about half
# the slots with fewer operations per slot
REDESIGN_RATIO = 0.65
# the block-tile kernel's triangular form (every path's) against its
# symmetric form (the first design), DP and F, in the same run: it sweeps
# 34.0M of the symmetric 216.5M slots at DHFR with a division-free pair function
NB_REDESIGN_RATIO = 0.40
# dL/ds with the DP pass on the kernel vs on the plain version
TOL_DLDS = 1e-4
# kernel="v1" (A&S erfc, exact exclusions) vs rowscan (polynomial) net
# nonbonded force, relative to the all-pairs force norm
TOL_V1_FORCE = 1e-5
# kernel="gather" / kernel="quad" (the same polynomial function over other
# lists and summation orders) vs rowscan net force, the same scale
TOL_ALT_FORCE = 1e-5
# kernel="dot": its MD provider's force (direct differences at the row
# center's images, forces by contraction) against rowscan's, on the
# all-pairs scale. The limit sits between the kernel's reading (1.011e-6)
# and that of r^2 by the f32 dot identity, the JAX kernel's default F mode,
# which DHFR NPT does not survive (1.47e-5 to 1.51e-5; ROADMAP R6), so this
# check fails a return to it
TOL_DOT_FORCE = 4e-6
# the quad and dot redesigns (per-step culls with compaction, list segments)
# against their first designs, F mode, in the same run: at DHFR they sweep
# about 32M of the quad lists' 70.4M slots and 35M of the dot lists' 91.1M
QUAD_REDESIGN_RATIO = 0.60
DOT_REDESIGN_RATIO = 0.55
# the culls of the quad and dot redesigns must leave at most this share of
# the listed slots to sweep at DHFR (as cull_census counts them: the plain
# copy of each kernel's cull and chunking)
SWEPT_SHARE = 0.5
# the gather redesign (the Newton-triangular suffix of the full lists, a
# per-step column cull with compaction, list pieces) against its first
# design, F mode, in the same run: at DHFR it sweeps about 30.6M of the full
# lists' 64.1M slots (cull_census), with reactions the first design has not;
# and the share of the full lists' slots it may sweep
GATHER_REDESIGN_RATIO = 0.75
GATHER_SWEPT_SHARE = 0.55
# the FP32 probe's time from INNER to 2 INNER, and each gate kernel's from
# 16 ITERS to 32 ITERS: the loops were not folded, the fixed cost is small
PROBE_RATIO = (1.8, 2.2)
# the redesigned bf16 gate (packed compare, shift table, ELEMS pairs a
# thread, one wave) against the first design: marginal time per ITERS
# iterations, same run
GATE_REDESIGN_RATIO = 0.75
# the tile census of the DHFR start (tiles built, after the chop, with no
# pair within the cutoff; pairs within the cutoff), as
# scripts/probe_bf16.py --census counts them (its hits printed as 7.2M)
CENSUS_DHFR = (24523, 22889, 7531, 7201903)
# the bound: published H100 SXM peaks (NVIDIA data sheet), FP32 outside the
# tensor cores and HBM3; bf16 outside the tensor cores (NVIDIA H100 Tensor
# Core GPU Architecture whitepaper: 133.8 TFLOP/s, twice FP32)
PEAK_FP32, PEAK_BYTES, PEAK_BF16_VECTOR = 67e12, 3.35e12, 133.8e12
# FP32 operations for one pair within the cutoff, counted once with its
# reaction on the other atom (the least work of the function, whatever a
# list makes a kernel sweep), from the sources in the timed mode: an FMA is 2,
# a compare, select or special function (rsqrt, exp, cos, sqrt, division) 1.
# No minimum image: quadscan computes the function without one (one image
# per list entry). The symmetric rowscan form, gather and quadscan:
# pair_math.cuh's pair function in F mode 48, the 4 differences, the 3 pair
# parameters, the row sums 6 and the reaction 3. The main path's rowscan
# form (triangular, preshift, no w) computes the same function without w:
# the pair function without dw 46, the 3 differences, the 3 pair
# parameters, the row sums 6 and the reaction 3 (the kernel's column
# contraction, 7, is how it is built, not what the function needs).
# nb_tiles' DP pass (exact form): 94 for the
# differences, the parameters, the pair function and the row's four sums,
# and 7 for the reaction's four. dotscan's F mode: the 4 differences, the
# pair function 48, the 3 pair parameters, the row contraction's 4 sums 7
# and the column's 7. quadscan's no-w form as rowscan's main form: 61.
FLOPS_PER_PAIR = {
    "rowscan_sweep": 61, "rowscan_symmetric": 64, "nb_tiles": 101, "gather_sweep": 64, "quadscan_sweep": 64,
    "quadscan_sweep_nw": 61, "dotscan_sweep": 69,
    # the RBFE host term's masked form (triangular, minimum image, w): the
    # symmetric form's function, each pair once with its reaction
    "rowscan_sweep_masked": 64,
    # nb_tiles' exact form (erfcf) in the triangular sweep's F and F+U modes, as its DP
    # count above with the special functions counted 1 each (erfcf among them, as exp is:
    # a lower bound on its instructions): the differences 16, r2 7, the gate 4, the pair
    # parameters 3, LJ 17, the switched erfc and its derivative 33, the sums 2, the select 1,
    # the row and column force sums 12; F+U adds the energy's select and sum
    "nb_tiles_exact_F": 95, "nb_tiles_exact_UF": 97,
    # the same form batched over HREX's replicas: F mode as the masked form;
    # U mode (the barostat's and the banded U_kl's) 53: the pair function in
    # U mode 45 (F mode's 48 with the energy's expression, 3 fewer than the
    # force's), the 4 differences, the 3 pair parameters and the row energy sum
    "rowscan_sweep_batched": 64, "rowscan_sweep_batched_U": 53,
}


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def pair_ops(name: str, pairs: int) -> float:
    """FP32 operations of `pairs` pairs of kernel `name`."""
    return pairs * FLOPS_PER_PAIR[name]


def bound(ops: float, nbytes: int, peak: float = PEAK_FP32):
    """(bound_ms, bound_by): the larger of the operations over the peak
    rate of their type and the bytes over the memory rate."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pairs_within_cutoff(x, box, w, cutoff: float) -> int:
    """Atom pairs, each counted once, with 4D minimum-image r^2 in the
    kernels' gate (1e-7, cutoff^2): the pairs a sweep must compute."""
    import torch

    n = x.shape[0]
    diag = torch.diagonal(box)
    total = 0
    for i0 in range(0, n, 1024):
        d = x[i0 : i0 + 1024, None, :] - x[None, :, :]
        d = d - diag * torch.round(d / diag)
        r2 = (d * d).sum(2) + (w[i0 : i0 + 1024, None] - w[None, :]) ** 2
        later = torch.arange(i0, min(i0 + 1024, n), device=x.device)[:, None] < torch.arange(n, device=x.device)
        total += int(((r2 < cutoff * cutoff) & (r2 > 1e-7) & later).sum())
    return total


def pairs_by_row_chunk(x, box, w, cutoff: float, pad_order, n_rows: int):
    """pairs_within_cutoff's pairs by the Newton-triangular row chunk that
    sweeps each: the 32-slot chunk of the pair's earlier slot in the sweep's
    order (pad_order: slot -> atom), an (n_rows,) int64 tensor."""
    import torch

    n = x.shape[0]
    slot = torch.empty(n, dtype=torch.int64, device=x.device)
    slot[pad_order[:n]] = torch.arange(n, device=x.device)
    diag = torch.diagonal(box)
    counts = torch.zeros(n_rows, dtype=torch.int64, device=x.device)
    for i0 in range(0, n, 1024):
        d = x[i0 : i0 + 1024, None, :] - x[None, :, :]
        d = d - diag * torch.round(d / diag)
        r2 = (d * d).sum(2) + (w[i0 : i0 + 1024, None] - w[None, :]) ** 2
        later = torch.arange(i0, min(i0 + 1024, n), device=x.device)[:, None] < torch.arange(n, device=x.device)
        i, j = ((r2 < cutoff * cutoff) & (r2 > 1e-7) & later).nonzero(as_tuple=True)
        counts += torch.bincount(torch.minimum(slot[i + i0], slot[j]) // 32, minlength=n_rows)
    return counts


def count_ops():
    """A dispatch mode that counts the aten operations run inside it (its .n)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    return CountOps()


def graph_nodes(fn, generator):
    """Counter {CUgraphNodeType: nodes} of the CUDA graph that captures fn()
    (0 a kernel, 1 a memory copy, 2 a memory set), `generator` registered
    with it; the graph is never replayed."""
    import torch

    libcuda = ctypes.CDLL("libcuda.so.1")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(libcuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    kinds = Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0, "cuGraphNodeGetType failed")
        kinds[kind.value] += 1
    return kinds


def kernel_counters() -> tuple:
    """(kernel wrappers, plain versions): each wrapper counts its launches in
    .launches, each plain version its calls in .calls."""
    from timemachine_torch.ops import dotscan_kernel as dk
    from timemachine_torch.ops import gather_kernel as gk
    from timemachine_torch.ops import nonbonded_kernel as nbk
    from timemachine_torch.ops import quadscan_kernel as qk
    from timemachine_torch.ops import rowscan_kernel as rs
    from timemachine_torch.probes import bf16_rate as br
    from timemachine_torch.probes import fp32_peak as fp

    sweeps = (
        rs.rowscan_sweep, rs.rowscan_sweep_batched, nbk.nb_tiles, gk.gather_sweep, qk.quadscan_sweep,
        dk.dotscan_sweep, fp.fp32_peak, br.bf16_rate,
    )
    plains = (
        rs.rowscan_sweep_plain, rs.rowscan_sweep_batched_plain, nbk.nb_tiles_plain, gk.gather_sweep_plain,
        qk.quadscan_sweep_plain, dk.dotscan_sweep_plain, fp.fp32_peak_plain, br.bf16_rate_plain,
    )
    return sweeps, plains


def zero_counts():
    """Every kernel's launch count and every plain version's call count
    to 0, just before a path runs."""
    sweeps, plains = kernel_counters()
    for fn in sweeps:
        fn.launches = 0
    for fn in plains:
        fn.calls = 0
    sweeps[0].launches_slabs = 0  # rowscan's slab launches (phase 26)


def read_counts():
    """({kernel: launches}, plain calls) since zero_counts()."""
    sweeps, plains = kernel_counters()
    return {fn.__name__: fn.launches for fn in sweeps}, sum(fn.calls for fn in plains)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def form_launches():
    """Every rowscan and nb_tiles launch so far by form, from the wrappers'
    own counts (launches_by_form)."""
    from timemachine_torch.ops import nonbonded_kernel as nbk
    from timemachine_torch.ops import rowscan_kernel as rs

    mode_names = {rs.FORCE: "F", rs.FORCE_ENERGY: "F+U", rs.ENERGY: "U"}
    nb_modes = {nbk.UF: "F+U", nbk.FORCE: "F", nbk.DP: "DP"}
    made = Counter()
    for (mode, triangular, es), n in nbk.nb_tiles.launches_by_form.items():
        made[f"nb_tiles {nb_modes[mode]} {'triangular' if triangular else 'symmetric'} {es}"] += n
    for (mode, triangular, preshift, has_w), n in rs.rowscan_sweep.launches_by_form.items():
        made[f"{mode_names[mode]} {'triangular' if triangular else 'symmetric'} "
             f"{'preshift' if preshift else 'minimum image'} {'w' if has_w else 'no w'}"] += n
    for (mode, has_w), n in rs.rowscan_sweep_batched.launches_by_form.items():
        made[f"batched {mode_names[mode]} {'w' if has_w else 'no w'}"] += n
    return made


MASKED_F = "F triangular minimum image w"  # the RBFE host term's MD force form (form_launches' name)


class StageClock:
    """Host seconds and kernel launches by stage: wrap(module, attr, stage)
    replaces module.attr by a wrapper that adds its host seconds to `sec`
    under `stage` and the rowscan and nb_tiles launches made inside it to
    `forms` under (stage, form), less those of a stage nested in it (each
    launch is tallied under its innermost stage; "setup" holds what no stage
    made once the caller adds the run's total there); run(stage, thunk)
    does the same for one call. restore() puts every wrapped attribute
    back."""

    def __init__(self, sync):
        self.sync, self.sec, self.stack, self.forms, self.wrapped = sync, {}, ["setup"], Counter(), []

    def run(self, stage, thunk):
        self.sync()
        self.stack.append(stage)
        before = form_launches()
        t_start = time.perf_counter()
        try:
            out = thunk()
            self.sync()
        finally:
            self.stack.pop()
        self.sec[stage] = self.sec.get(stage, 0.0) + time.perf_counter() - t_start
        for form, n in (form_launches() - before).items():
            self.forms[stage, form] += n
            self.forms[self.stack[-1], form] -= n
        return out

    def wrap(self, module, attr, stage, record=None):
        fn = getattr(module, attr)

        def wrapper(*args, **kwargs):
            out = self.run(stage, lambda: fn(*args, **kwargs))
            if record is not None:
                record(args, kwargs, out)
            return out

        setattr(module, attr, wrapper)
        self.wrapped.append((module, attr, fn))
        return fn

    def restore(self):
        for module, attr, fn in reversed(self.wrapped):
            setattr(module, attr, fn)
        self.wrapped.clear()

    def by_stage(self) -> str:
        """The nonzero launches as 'stage: form n, ...; ...'."""
        stages = {}
        for (stage, form), n in sorted(self.forms.items()):
            if n:
                stages.setdefault(stage, []).append(f"{form} {n}")
        return "; ".join(f"{stage}: {', '.join(v)}" for stage, v in stages.items())

    def launches(self, stage, kernel) -> int:
        """The launches of `kernel` ("nb_tiles" or "rowscan", batched form included) under `stage`."""
        return sum(n for (st, form), n in self.forms.items()
                   if st == stage and form.startswith("nb_tiles") == (kernel == "nb_tiles"))


def phase18(dev, smi, zero_counts, read_counts, masked_row, batched_row, plain_states, states13, dG14, inputs16):
    """REST and local MD, the two sampling options of the leg's HREX:
    [18 rest build] the 12 windows built with SingleTopologyREST against the
    plain builder's (`plain_states`, phase 15's, float64 on the card);
    [18 rest hrex] run_sims_hrex over the 12 REST windows on the batched
    kernel; [18 local] local MD on window N18_WINDOW of the cached leg
    (`states13`, phase 13's); [18 run_solvent] run_solvent from the two
    SMILES (`inputs16`: phase 16's embedded molecules, core and force field)
    with REST and local MD. Adds launches_rest_hrex to the batched row and
    launches_local_md to the masked row."""
    import numpy as np
    import torch

    from timemachine_torch.fe import free_energy as fe18
    from timemachine_torch.fe import rbfe as rbfe18
    from timemachine_torch.fe.free_energy import HREXParams, LocalMDParams, MDParams, RESTParams, get_context
    from timemachine_torch.md import minimizer as minimizer18
    from timemachine_torch.testsystems.rbfe_solvent import build_rbfe_solvent, rest_differences

    t_phase18 = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    rest18 = RESTParams(N18_MAX_TEMPERATURE_SCALE, "exponential")
    sync = torch.cuda.synchronize

    # -- the REST windows ----------------------------------------------------------
    strict_before = os.environ.get("TM_STRICT_CHARGES")
    os.environ["TM_STRICT_CHARGES"] = "1"  # AM1 or fail, as phase 15's plain windows
    try:
        rec18 = {}
        t0 = time.perf_counter()
        rest64 = build_rbfe_solvent(device=dev, dtype=f64, record=rec18, rest_params=rest18)
        sync()
        t_build18 = time.perf_counter() - t0
        rest32 = build_rbfe_solvent(device=dev, dtype=f32, rest_params=rest18)
    finally:
        if strict_before is None:
            os.environ.pop("TM_STRICT_CHARGES")
        else:
            os.environ["TM_STRICT_CHARGES"] = strict_before
    st18 = rec18["single_topology"]
    d18 = rest_differences(rest64, plain_states, st18)
    scales18 = [st18.get_energy_scale_factor(s.lamb) for s in rest64]
    print(
        f"[18 rest build] build_rbfe_solvent(rest_params=RESTParams({N18_MAX_TEMPERATURE_SCALE}, 'exponential')), 12 "
        f"windows on the card in {t_build18:.2f} s host clock; seeds (atoms whose bonded parameters change, and the "
        f"dummies) {sorted(st18.base_rest_region_atom_idxs)}, region {sorted(st18.rest_region_atom_idxs)}, "
        f"{len(st18.target_proper_idxs)} target propers {st18.target_proper_idxs}; energy scale by window "
        + " ".join(f"{s:.6f}" for s in scales18)
        + f"; scaled entries a window {d18['n_scaled']}; against the plain builder's windows (phase 15's): windows "
        f"bitwise {d18['bitwise']}, the scaled entries' largest relative difference from plain x scale "
        f"{d18['scaled_rel']:.3e} (tol {TOL_REST_REL:g}), every other entry, index array and buffer bitwise "
        f"{d18['others_bitwise']} ({smi})"
    )
    check(d18["bitwise"][:1] == [0] and d18["bitwise"][-1:] == [11], "[18] REST's end-state windows differ from the plain ones")
    check(d18["scaled_rel"] <= TOL_REST_REL and d18["others_bitwise"], "[18] REST's windows are not the plain ones scaled")
    check(all(v > 0 for k, v in d18["n_scaled"].items() if k in ("proper", "nonbonded_pair_list", "nonbonded_ixn_group")),
          "[18] REST scaled no proper, pair-list or interaction-group entry")

    # -- HREX over the REST windows -------------------------------------------------
    md18 = MDParams(
        n_frames=N18_FRAMES, n_eq_steps=N18_EQ, steps_per_frame=N18_STEPS_PER_FRAME, seed=2023,
        hrex_params=HREXParams(n_frames_bisection=100, max_delta_states=N14_MAX_DELTA, rest_params=rest18),
    )
    steps18 = N18_EQ + N18_FRAMES * N18_STEPS_PER_FRAME
    zero_counts()
    before = form_launches()
    t0 = time.perf_counter()
    res18, trajs18, diag18, _ = fe18.run_sims_hrex(rest32, md18, print_diagnostics_interval=None)
    sync()
    t_hrex18 = time.perf_counter() - t0
    launches_h, plain_h = read_counts()
    forms_h = form_launches() - before
    rates18 = diag18.cumulative_swap_acceptance_rates[-1]
    finite18 = bool(np.isfinite(res18.dGs).all() and np.isfinite(res18.dG_errs).all())
    dG18 = float(np.sum(res18.dGs))
    print(
        f"[18 rest hrex] run_sims_hrex over the 12 REST windows ({N18_EQ} equilibration steps, {N18_FRAMES} iterations "
        f"of {N18_STEPS_PER_FRAME}; DEFAULT_REST_PARAMS' depth 10,000 and 1,000 of 400 cut): {t_hrex18:.1f} s host clock; "
        f"launches by form {dict(forms_h)}; totals {launches_h}, plain calls {plain_h}; swap acceptance "
        + " ".join(f"{k}-{k + 1} {r:.3f}" for k, r in enumerate(rates18))
        + f"; dG {dG18:.4f} +- {float(np.linalg.norm(res18.dG_errs)):.4f} kJ/mol ({len(res18.bar_results)} BAR pairs, "
        f"finite {finite18}; not converged) beside phase 14's plain HREX {dG14:.4f} ({smi})"
    )
    check(plain_h == 0, "[18] REST HREX ran a plain sweep")
    check(forms_h["batched F w"] == steps18, "[18] REST HREX did not take one batched F launch a step")
    check(len(res18.bar_results) == 11 and finite18, "[18] REST HREX did not give 11 finite BAR pairs")
    batched_row["launches_rest_hrex"] = forms_h["batched F w"] / (len(rest32) * steps18)

    # -- local MD on one window -------------------------------------------------------
    s18 = states13[N18_WINDOW]
    lig18 = s18.ligand_idxs
    n18 = s18.x0.shape[0]
    md_l = MDParams(n_frames=1, n_eq_steps=0, steps_per_frame=1, seed=2023)
    ctx_g = get_context(s18, md_l)
    ctx_g.multiple_steps(N18_LOCAL)
    sync()
    t0 = time.perf_counter()
    ctx_g.multiple_steps(N18_LOCAL)
    sync()
    global_ms = (time.perf_counter() - t0) * 1e3 / N18_LOCAL

    def local_run(freeze_reference, seed=N18_LOCAL_SEED):
        ctx = get_context(s18, md_l)
        ref, free = ctx.local_selection(lig18, N18_LOCAL_K, N18_LOCAL_RADIUS, seed, None, freeze_reference)
        x0, v0, box0 = ctx.get_x_t(), ctx.get_v_t(), ctx.get_box()
        moves0 = [int(st.total_attempted) for st in ctx.get_mover_states()]
        zero_counts()
        before = form_launches()
        sync()
        t_start = time.perf_counter()
        frames, boxes = ctx.multiple_steps_local(N18_LOCAL, lig18, k=N18_LOCAL_K, radius=N18_LOCAL_RADIUS, seed=seed,
                                                 freeze_reference=freeze_reference)
        sync()
        ms = (time.perf_counter() - t_start) * 1e3 / N18_LOCAL
        counts, plain = read_counts()
        forms = form_launches() - before
        out = dict(ctx=ctx, ref=ref, free=free, x0=x0, v0=v0, box0=box0, x=ctx.get_x_t(), v=ctx.get_v_t(), box=ctx.get_box(),
                   frames=frames, ms=ms, counts=counts, plain=plain, forms=forms,
                   moves=[int(st.total_attempted) for st in ctx.get_mover_states()] == moves0)
        return out

    frozen_run = local_run(True)
    frozen = ~frozen_run["free"]
    still = bool(np.array_equal(frozen_run["x"][frozen], frozen_run["x0"][frozen])
                 and np.array_equal(frozen_run["v"][frozen], frozen_run["v0"][frozen]))
    moved = int(np.any(frozen_run["x"] != frozen_run["x0"], axis=1).sum())
    ref_still = bool(frozen[frozen_run["ref"]] and np.array_equal(frozen_run["x"][frozen_run["ref"]], frozen_run["x0"][frozen_run["ref"]]))
    free_run = local_run(False)
    finite_free = bool(np.isfinite(free_run["x"]).all() and np.isfinite(free_run["v"]).all())
    ref_moved = bool(np.any(free_run["x"][free_run["ref"]] != free_run["x0"][free_run["ref"]]))
    again = local_run(True)
    same = all(np.array_equal(again[k], frozen_run[k]) for k in ("x", "v", "box"))
    with torch.no_grad():
        u_r, f_r = free_run["ctx"].local_restraint(
            torch.as_tensor(free_run["x"], device=dev), torch.as_tensor(free_run["box"], device=dev), free_run["ref"],
            torch.as_tensor(free_run["free"], device=dev), N18_LOCAL_K, N18_LOCAL_RADIUS, False,
        )
    restraint_finite = bool(np.isfinite(float(u_r)) and torch.isfinite(f_r).all())
    print(
        f"[18 local] window {N18_WINDOW}, multiple_steps_local({N18_LOCAL} steps, the ligand's {len(lig18)} atoms, k "
        f"{N18_LOCAL_K:g}, radius {N18_LOCAL_RADIUS}, seed {N18_LOCAL_SEED}): freeze_reference=True: {int(frozen_run['free'].sum())} "
        f"of {n18} atoms free around reference {frozen_run['ref']}, {moved} moved; frozen atoms' x and v bitwise unmoved "
        f"{still}, the reference frozen {ref_still}, box bitwise {np.array_equal(frozen_run['box'], frozen_run['box0'])}, no "
        f"barostat move {frozen_run['moves']}; freeze_reference=False: {int(free_run['free'].sum())} free, the reference moved "
        f"{ref_moved}, x and v finite in float32 {finite_free}, the float64 restraint (log-complement shell) finite "
        f"{restraint_finite}; the same seed again bitwise {same}; {frozen_run['ms']:.4f} ms a local step against "
        f"{global_ms:.4f} a global step (host clock, {N18_LOCAL} steps each); launches by form "
        f"{dict(frozen_run['forms'])}, plain calls {frozen_run['plain']} ({smi})"
    )
    check(still and ref_still and moved > 0, "[18] a frozen atom moved in local MD, or none moved")
    check(np.array_equal(frozen_run["box"], frozen_run["box0"]) and frozen_run["moves"], "[18] a mover fired in local MD")
    check(finite_free and ref_moved and restraint_finite, "[18] the free-reference local run is not finite or left the reference")
    check(same, "[18] local MD with the same seed is not bitwise on repeat")
    for run in (frozen_run, free_run, again):
        check(run["plain"] == 0 and run["forms"][MASKED_F] == N18_LOCAL
              and sum(run["forms"].values()) == N18_LOCAL,
              "[18] a local step did not take exactly one masked rowscan F launch")
    masked_row["launches_local_md"] = frozen_run["forms"][MASKED_F] / N18_LOCAL

    # an explicit selection: the N18_SELECTION atoms nearest the ligand's first atom
    ctx_s = get_context(s18, md_l)
    x_s = ctx_s.get_x_t().astype(np.float64)
    diff = x_s - x_s[lig18[0]]
    diag = np.diagonal(s18.box0)
    diff -= diag * np.floor(diff / diag + 0.5)
    order = np.argsort(np.linalg.norm(diff, axis=1))
    sel = np.array([i for i in order if i != lig18[0]][:N18_SELECTION])
    zero_counts()
    ctx_s.multiple_steps_local_selection(N18_LOCAL, int(lig18[0]), sel, radius=N18_LOCAL_RADIUS, k=N18_LOCAL_K)
    sync()
    counts_s, plain_s = read_counts()
    moved_s = np.any(ctx_s.get_x_t() != x_s.astype(np.float32), axis=1)
    only_sel = bool(moved_s[sel].any() and not np.delete(moved_s, sel).any())
    print(f"[18 local] multiple_steps_local_selection({N18_LOCAL} steps, reference atom {int(lig18[0])}, the {N18_SELECTION} "
          f"atoms nearest it): {int(moved_s.sum())} moved, only selected atoms moved {only_sel}; launches {counts_s}, plain "
          f"calls {plain_s} ({smi})")
    check(only_sel and plain_s == 0 and counts_s["rowscan_sweep"] == N18_LOCAL, "[18] the explicit selection moved others")

    # -- run_solvent with REST and local MD -------------------------------------------
    mols16, core16, ff16 = inputs16
    clock = StageClock(sync)
    sec, forms, staged = clock.sec, clock.forms, clock.wrap

    md_rs = MDParams(
        n_frames=N18_RS_FRAMES, n_eq_steps=N18_RS_EQ, steps_per_frame=N18_RS_STEPS_PER_FRAME, seed=2023,
        hrex_params=HREXParams(n_frames_bisection=N18_RS_FRAMES_BISECTION, rest_params=rest18),
        local_md_params=LocalMDParams(local_steps=N18_RS_LOCAL_STEPS),
    )
    multiplexed, topologies = [], []
    staged(minimizer18, "pre_equilibrate_host", "host")
    staged(rbfe18, "optimize_coordinates", "minimize anchors")
    staged(rbfe18, "run_sims_bisection", "bisection")
    staged(rbfe18, "run_sims_hrex", "hrex")
    tm_fn, st_fn = fe18._run_sims_hrex_time_multiplexed, rbfe18.make_single_topology
    fe18._run_sims_hrex_time_multiplexed = lambda *a, **k: multiplexed.append(1) or tm_fn(*a, **k)
    rbfe18.make_single_topology = lambda *a, **k: topologies.append(st_fn(*a, **k)) or topologies[-1]
    try:
        zero_counts()
        before = form_launches()
        t0 = time.perf_counter()
        res_rs, _ = rbfe18.run_solvent(mols16[0], mols16[1], core16, ff16, None, md_params=md_rs, n_windows=N18_RS_WINDOWS,
                                       device=dev)
        sync()
        t_rs = time.perf_counter() - t0
        counts_rs, plain_rs = read_counts()
        forms_rs = form_launches() - before
        for form, n in forms_rs.items():
            forms["setup", form] += n  # what no stage launched
    finally:
        fe18._run_sims_hrex_time_multiplexed, rbfe18.make_single_topology = tm_fn, st_fn
        clock.restore()
    fin = res_rs.final_result
    finite_rs = bool(np.isfinite(fin.dGs).all() and np.isfinite(fin.dG_errs).all())
    st_rs = fin.initial_states
    rest_rs = [type(t).__name__ for t in topologies] == ["SingleTopologyREST"]
    outside = forms_rs - sum((Counter({f: n for (s, f), n in forms.items() if s == name}) for name in sec), Counter())
    print(
        f"[18 run_solvent] run_solvent from the two SMILES with RESTParams({N18_MAX_TEMPERATURE_SCALE}) and "
        f"LocalMDParams(local_steps={N18_RS_LOCAL_STEPS}), {N18_RS_WINDOWS} windows, {N18_RS_EQ} equilibration steps, "
        f"{N18_RS_FRAMES_BISECTION} bisection frames and {N18_RS_FRAMES} HREX iterations of {N18_RS_STEPS_PER_FRAME} steps: "
        f"{t_rs:.1f} s host clock: " + ", ".join(f"{k} {v:.1f} s" for k, v in sec.items())
        + f", the rest {t_rs - sum(sec.values()):.1f} s; λ schedule " + " ".join(f"{s.lamb:.4f}" for s in st_rs)
        + f"; the edge's topology {[type(t).__name__ for t in topologies]}; HREX time-multiplexed {bool(multiplexed)}, "
        + "swap acceptance "
        + " ".join(f"{r:.3f}" for r in res_rs.hrex_diagnostics.cumulative_swap_acceptance_rates[-1])
        + f"; dG {float(np.sum(fin.dGs)):.4f} +- {float(np.linalg.norm(fin.dG_errs)):.4f} kJ/mol ({len(fin.bar_results)} "
        f"BAR pairs, finite {finite_rs}; not converged) ({smi})"
    )
    print(f"[18 run_solvent] rowscan and nb_tiles launches by stage and form: {clock.by_stage()}; outside the "
          f"stages {dict(+outside)}; totals {counts_rs}; plain calls {plain_rs} ({smi})")
    check(rest_rs and finite_rs and len(fin.bar_results) == N18_RS_WINDOWS - 1, "[18] run_solvent with REST and local MD failed")
    check(bool(multiplexed) and plain_rs == 0, "[18] run_solvent's HREX was not time-multiplexed, or a plain sweep ran")
    rs_only = lambda name: sum(n for (s, f), n in forms.items() if s == name and not f.startswith("nb_tiles"))  # noqa: E731
    check(rs_only("bisection") > 0 and rs_only("hrex") > 0
          and all(n == 0 for (s, f), n in forms.items() if s == "hrex" and f.startswith(("batched", "nb_tiles"))),
          "[18] run_solvent's bisection and HREX did not run on the single masked rowscan form")
    check(sum(n for f, n in forms_rs.items() if not f.startswith(("nb_tiles", "batched"))) == counts_rs["rowscan_sweep"]
          and sum(n for f, n in forms_rs.items() if f.startswith("batched")) == counts_rs["rowscan_sweep_batched"]
          and sum(n for f, n in forms_rs.items() if f.startswith("nb_tiles")) == counts_rs["nb_tiles"],
          "[18] the launches by form do not add up to the wrappers' counts")
    masked_row["launches_run_solvent_rest_local"] = counts_rs["rowscan_sweep"]
    print(f"[18 time] phase 18 took {time.perf_counter() - t_phase18:.1f} s, host clock ({smi})")


def phase16(dev, smi, zero_counts, read_counts, masked_row, batched_row):
    """run_solvent as a user calls it: the ligands embedded from SMILES, AM1,
    the mapping, the water box, the host's pre-equilibration, the anchors'
    λ-chain minimization, bisection and HREX, on `dev`, with every count
    zeroed just before run_solvent and read just after; the cache is read
    only for the comparisons printed. Adds run_solvent's launches to the
    masked and batched rowscan rows; returns its launches by kernel and the
    nb_tiles launches of its FIRE and minimization stages, and its inputs
    (the embedded molecules, the core, the force field)."""
    import numpy as np
    import torch

    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.chem.embed import embed_mol
    from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS, MAX_FORCE_NORM
    from timemachine_torch.fe import rbfe as rbfe16
    from timemachine_torch.fe.atom_mapping import get_cores
    from timemachine_torch.constants import DEFAULT_TEMP
    from timemachine_torch.fe.free_energy import HREXParams, MDParams
    from timemachine_torch.fe.single_topology import SingleTopology
    from timemachine_torch.ff import Forcefield
    from timemachine_torch.md import minimizer as minimizer16
    from timemachine_torch.md.context import Context
    from timemachine_torch.potentials import NonbondedAllPairs
    from timemachine_torch.testsystems.rbfe_solvent import load_arrays as rbfe_cache_arrays
    from timemachine_torch.testsystems.rbfe_solvent import metadata as rbfe_cache_metadata
    from timemachine_torch.testsystems.rbfe_solvent import window_arrays as window_arrays16

    t_phase16 = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    clock16 = StageClock(sync)
    sec16, forms16, staged = clock16.sec, clock16.forms, clock16.wrap
    calls16, chains16, host16, call_s16 = [], [], {}, []

    def record_host(args, kwargs, out):
        host16.update(mols=args[0], config=args[1], x_host=out[0], box=out[1])

    def record_chain(args, kwargs, out):
        """The anchors, their minimized coordinates and each one's largest
        displacement, taken before setup_initial_states writes x0."""
        disp = [float(rbfe16.displacements(state, x)[1].max()) for state, x in zip(args[0], out)]
        for state, x in zip(args[0], out):
            rbfe16._check_displacements(state, x, N16_MIN_CUTOFF)
        chains16.append((list(args[0]), out, disp))

    def record_call(args, kwargs, out):
        calls16.append((args, kwargs, out))
        call_s16.append(sec16["minimize"] - sum(call_s16))

    def count_vg(fn):
        """Keep every val_and_grad function made (each counts its calls)."""

        def wrapper(*args, **kwargs):
            vgs16.append(fn(*args, **kwargs))
            return vgs16[-1]

        return wrapper

    vgs16 = []
    originals16 = [
        (minimizer16, "fire_minimize_host", staged(minimizer16, "fire_minimize_host", "fire")),
        (minimizer16, "pre_equilibrate_host", staged(minimizer16, "pre_equilibrate_host", "npt", record_host)),
        (minimizer16, "Context", getattr(minimizer16, "Context")),
        (minimizer16, "get_val_and_grad_fn", getattr(minimizer16, "get_val_and_grad_fn")),
        (rbfe16, "optimize_coordinates", staged(rbfe16, "optimize_coordinates", "minimize anchors", record_chain)),
        (rbfe16, "optimize_coords_state", staged(rbfe16, "optimize_coords_state", "minimize", record_call)),
        (rbfe16, "run_sims_bisection", staged(rbfe16, "run_sims_bisection", "bisection")),
        (rbfe16, "run_sims_hrex", staged(rbfe16, "run_sims_hrex", "hrex")),
    ]
    contexts16 = []

    def catching_context(*args, **kwargs):
        contexts16.append(Context(*args, **kwargs))
        return contexts16[-1]

    minimizer16.Context = catching_context
    minimizer16.get_val_and_grad_fn = count_vg(originals16[3][2])
    try:
        a16 = rbfe_cache_arrays()
        meta16 = rbfe_cache_metadata(a16)
        t0 = time.perf_counter()
        mols16 = [mol_from_smiles(str(smi), add_hs=True, name=str(nm)) for smi, nm in zip(meta16["smiles"], meta16["names"])]
        for mol in mols16:
            embed_mol(mol, seed=N16_EMBED_SEED)
        sec16["embed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ff16 = Forcefield.load_default()
        core16 = get_cores(*mols16, **DEFAULT_ATOM_MAPPING_KWARGS)[0]
        sec16["mapping"] = time.perf_counter() - t0
        md16 = MDParams(
            n_frames=N16_FRAMES, n_eq_steps=N16_EQ, steps_per_frame=N16_STEPS_PER_FRAME, seed=2023,
            hrex_params=HREXParams(n_frames_bisection=N16_FRAMES_BISECTION),
        )
        zero_counts()
        forms_before16 = form_launches()
        t0 = time.perf_counter()
        res16, cfg16 = rbfe16.run_solvent(mols16[0], mols16[1], core16, ff16, None, md_params=md16, n_windows=N16_WINDOWS)
        PLOTS_SEEN["run_solvent RBFE (phase 16)"] = (res16.plots, res16.hrex_plots)
        sync()
        t_run16 = time.perf_counter() - t0
        launches16, plain16_calls = read_counts()
        forms_run16 = form_launches() - forms_before16
        for form, n in forms_run16.items():
            forms16["setup", form] += n
    finally:
        for module, attr, fn in originals16:
            setattr(module, attr, fn)
    other16 = t_run16 - sum(v for k, v in sec16.items() if k in ("npt", "minimize anchors", "bisection", "hrex"))
    print(
        f"[16 time] run_solvent {t_run16:.1f} s: host pre-equilibration {sec16['npt']:.1f} s (FIRE {sec16['fire']:.1f}), "
        f"anchor minimization {sec16['minimize anchors']:.1f} s, bisection {sec16['bisection']:.1f} s (its new λ "
        f"minimizations {sum(call_s16[len(chains16[0][0]):]):.1f} s), HREX {sec16['hrex']:.1f} s, the rest "
        f"(SingleTopology, water box, window states) {other16:.1f} s; before it embedding {sec16['embed']:.1f} s, force "
        f"field and mapping {sec16['mapping']:.2f} s; host clock ({smi})"
    )

    emb16 = [float(np.abs(m.get_conf() - meta16[k]).max()) for m, k in zip(mols16, ("conf_a", "conf_b"))]
    print(f"[16 embed] embed_mol(seed {N16_EMBED_SEED}) of {', '.join(str(n) for n in meta16['names'])} from SMILES against "
          f"the cache's recorded conformers (the JAX package's embedding): largest |diff| {emb16[0]:.3e}, {emb16[1]:.3e} nm "
          f"(tol {TOL_EMBED:g}); core {len(core16)} atoms, the cache's: {np.array_equal(core16, meta16['core'])}")
    check(max(emb16) <= TOL_EMBED, "[16] an embedded conformer differs from the cache's")
    check(np.array_equal(core16, meta16["core"]), "[16] the core differs from the cache's")

    n_host16 = host16["config"].conf.shape[0]
    ctx16 = contexts16[0]
    lig16 = np.concatenate([m.get_conf() for m in host16["mols"]])
    x_end16 = ctx16.get_x_t()
    frozen16 = bool(np.array_equal(x_end16[n_host16:], lig16.astype(x_end16.dtype)))
    with torch.no_grad():
        f_end16 = minimizer16.total_force(ctx16.potentials, torch.as_tensor(x_end16, device=dev), ctx16._box)
    fmax16 = float(torch.linalg.vector_norm(f_end16[:n_host16], dim=-1).max())
    vol16 = float(np.prod(np.diagonal(host16["box"])))
    vol_cache = float(np.prod(np.diagonal(window_arrays16(a16, 0)["box0"])))
    vol_start = float(np.prod(np.diagonal(cfg16.box)))
    print(
        f"[16 host] {n_host16} host atoms, {len(lig16)} ligand atoms at infinite mass: FIRE {sec16['fire']:.2f} s (2 λ "
        f"windows of 500 steps), NPT {sec16['npt'] - sec16['fire']:.2f} s (1,000 steps, barostat every 5); ligand "
        f"bitwise unmoved: {frozen16}; the host's largest |F| {fmax16:.1f} kJ/mol/nm (limit MAX_FORCE_NORM "
        f"{MAX_FORCE_NORM:g}); box volume {vol16:.4f} nm^3 from {vol_start:.4f}, the cache's box0 {vol_cache:.4f} "
        f"(ratio {vol16 / vol_cache:.4f}) ({smi})"
    )
    check(frozen16, "[16] the ligand moved during the host's pre-equilibration")
    check(fmax16 < MAX_FORCE_NORM, "[16] the pre-equilibrated host's forces exceed MAX_FORCE_NORM")
    check(0.7 * vol_start < vol16 < 1.3 * vol_start, "[16] the pre-equilibrated box volume left (0.7, 1.3) of the start")

    (anchors16, xs16, disp16), = chains16
    n_anchor = len(anchors16)
    # the anchors' terms as their minimization read them: get_context has since configured window 0's in place
    # (rowscan, as JAX's configure_pallas does), so each window is built again, fresh, on the card
    st16 = SingleTopology(mols16[0], mols16[1], core16, ff16)
    cfg_h = host16["config"]
    host_card = rbfe16.Host(cfg_h.host_system, cfg_h.masses, host16["x_host"], host16["box"], cfg_h.num_water_atoms,
                            cfg_h.host_topology)
    fresh16 = [rbfe16.setup_initial_state(st16, state.lamb, host_card, DEFAULT_TEMP, md16.seed, dev) for state in anchors16]
    for state, fresh, x_opt, disp in zip(anchors16, fresh16, xs16, disp16):
        k = next(i for i, c in enumerate(calls16[:n_anchor]) if c[0][0] is state.potentials)
        _, x_in, box_in = calls16[k][0][:3]
        check_vg = minimizer16.get_val_and_grad_fn(fresh.potentials, box_in)
        u_in, u_out = check_vg(x_in)[0], check_vg(x_opt)[0]
        print(f"[16 minimize] anchor λ {state.lamb:.4f}: {vgs16[k].calls} BFGS energy/force calls in {call_s16[k]:.2f} s, "
              f"U {u_in:.4f} -> {u_out:.4f} kJ/mol (float64 sums), largest displacement of the interacting atoms "
              f"{disp:.4f} nm (min_cutoff {N16_MIN_CUTOFF}, checked)")
        check(np.isfinite(u_out) and u_out < u_in, f"[16] anchor λ {state.lamb} did not lower its energy")

    # window 0's card energy against the same state in float64 on the CPU
    state0 = anchors16[0]
    k0 = next(i for i, c in enumerate(calls16[:n_anchor]) if c[0][0] is state0.potentials)
    state_cpu = rbfe16.setup_initial_state(st16, state0.lamb, host_card, DEFAULT_TEMP, md16.seed, torch.device("cpu"),
                                           torch.float64)
    check(np.array_equal(state_cpu.x0, calls16[k0][0][1]), "[16] the CPU rebuild of window 0 starts elsewhere")
    vg_card = minimizer16.get_val_and_grad_fn(fresh16[0].potentials, state0.box0)
    vg_cpu = minimizer16.get_val_and_grad_fn(state_cpu.potentials, state0.box0)
    d_us, u_hs = [], []
    for label, x_at in (("input", calls16[k0][0][1]), ("minimized", xs16[0])):
        (u_c, g_c), (u_h, g_h) = vg_card(x_at), vg_cpu(x_at)
        ap_card = next(p for p in vg_card.modules if isinstance(p, NonbondedAllPairs))
        with torch.no_grad():  # the scale: the card's all-pairs term alone (its f32 sweep, summed in float64)
            x_c = torch.as_tensor(x_at, device=dev, dtype=torch.float64)
            u_ap, f_ap = NonbondedAllPairs.energy_force_f64(ap_card, x_c, torch.as_tensor(state0.box0, device=dev))
        d_us.append(u_c - u_h)
        u_hs.append(u_h)
        rounding, d_g = 2.0**-24 * abs(float(u_ap)), float(np.linalg.norm(g_c - g_h))
        norm_ap = float(torch.linalg.vector_norm(f_ap))
        print(f"[16 minimize] window 0 at its {label} coordinates, the card's float64 energy (host term "
              f"{ap_card.kernel}) against the CPU's (float64 throughout, host term "
              f"{next(p for p in vg_cpu.modules if isinstance(p, NonbondedAllPairs)).kernel}): U {u_c:.6f} vs "
              f"{u_h:.6f} kJ/mol, dU {d_us[-1]:.3e} = "
              f"{d_us[-1] / rounding:.3f} f32 roundings of U_all-pairs {float(u_ap):.1f} (limit {TOL_F64_U_ROUNDINGS:g}); "
              f"|d grad| {d_g:.3e} = {d_g / np.linalg.norm(g_h):.3e} of |grad|, {d_g / norm_ap:.3e} of the all-pairs "
              f"force norm (limit {TOL_FORCE_REL_NORM:g}) ({smi})")
        check(abs(d_us[-1]) <= TOL_F64_U_ROUNDINGS * rounding,
              f"[16] window 0's card energy at its {label} coordinates is off the CPU's float64")
        check(d_g <= TOL_FORCE_REL_NORM * norm_ap, f"[16] window 0's card gradient at its {label} coordinates is off the CPU's")
    print(f"[16 minimize] window 0's dU changed by {d_us[1] - d_us[0]:.3e} kJ/mol from its input to its minimized "
          f"coordinates = {(d_us[1] - d_us[0]) / rounding:.3f} f32 roundings (limit {TOL_F64_U_CHANGE_ROUNDINGS:g}); "
          f"the minimization lowered the CPU's U by {u_hs[0] - u_hs[1]:.4f} kJ/mol ({smi})")
    check(abs(d_us[1] - d_us[0]) <= TOL_F64_U_CHANGE_ROUNDINGS * rounding,
          "[16] window 0's card energy change off the CPU's float64 change")
    args0, kwargs0, out0 = calls16[0]
    check(args0[0] is state0.potentials, "[16] the first minimization was not window 0's")
    t0 = time.perf_counter()
    again16 = rbfe16.optimize_coords_state(fresh16[0].potentials, *args0[1:], **kwargs0)
    t_again16 = time.perf_counter() - t0
    same16 = bool(np.array_equal(again16, out0))
    print(f"[16 minimize] {n_anchor} anchors, {sum(v.calls for v in vgs16[:n_anchor])} calls; "
          f"{len(calls16) - n_anchor} more minimizations for bisection's new λ "
          f"({', '.join(str(vg_.calls) for vg_ in vgs16[n_anchor:])} calls); window 0 minimized again "
          f"({t_again16:.2f} s): bitwise the first {same16} ({smi})")
    check(same16, "[16] a repeated minimization of window 0 differs from the first")

    bis16 = res16.intermediate_results[-1]
    print(f"[16 bisection] {len(res16.intermediate_results) - 1} bisections: λ schedule "
          + " ".join(f"{s.lamb:.4f}" for s in bis16.initial_states) + "; BAR overlaps "
          + " ".join(f"{o:.3f}" for o in bis16.overlaps) + f" ({N16_FRAMES_BISECTION} frames a state)")
    rates16 = res16.hrex_diagnostics.cumulative_swap_acceptance_rates[-1]
    fin16 = res16.final_result
    finite16 = bool(np.isfinite(fin16.dGs).all() and np.isfinite(fin16.dG_errs).all())
    dG16 = float(np.sum(fin16.dGs))
    print(f"[16 hrex] {len(fin16.initial_states)} replicas, {N16_FRAMES} iterations of {N16_STEPS_PER_FRAME} steps: swap "
          f"acceptance " + " ".join(f"{r:.3f}" for r in rates16) + f"; dG {dG16:.4f} +- "
          f"{float(np.linalg.norm(fin16.dG_errs)):.4f} kJ/mol ({len(fin16.bar_results)} BAR pairs, finite {finite16}; "
          f"not converged); plots {res16.plots}, {res16.hrex_plots} ({smi})")
    check(len(fin16.bar_results) == N16_WINDOWS - 1 and finite16, "[16] HREX did not give 11 finite BAR pairs")

    print(f"[16 kernels] rowscan and nb_tiles launches in run_solvent by stage and form: {clock16.by_stage()}; "
          f"totals {launches16}; plain sweeps {plain16_calls} ({smi})")
    check(plain16_calls == 0, "[16] run_solvent ran a plain sweep")
    check(launches16["rowscan_sweep"] > 0 and launches16["rowscan_sweep_batched"] > 0,
          "[16] run_solvent did not launch the rowscan kernel and its batched form")
    check(all(n == 0 for (stage, _), n in forms16.items() if stage == "setup"),
          "[16] a kernel launch outside the stages")

    stage_launches = clock16.launches

    # JAX's forms by stage (potentials.all_pairs_kernel): the host's FIRE reads "tiled" (v1), the anchors' and the
    # new λ's minimizations a fresh state's dense term (v1 on the card at 6,404 atoms); MD, bisection's u_kln
    # and HREX the Context's rowscan sweep
    for stage in ("fire", "minimize"):
        exact = sum(n for (st, form), n in forms16.items() if st == stage and form.startswith("nb_tiles") and form.endswith("exact"))
        check(exact > 0 and stage_launches(stage, "rowscan") == 0 and stage_launches(stage, "nb_tiles") == exact,
              f"[16] the {stage} stage did not run on nb_tiles' exact form alone")
    for stage in ("npt", "bisection", "hrex"):
        check(stage_launches(stage, "rowscan") > 0 and stage_launches(stage, "nb_tiles") == 0,
              f"[16] the {stage} stage did not run on the rowscan kernel alone")
    rs_forms = {form: n for form, n in forms_run16.items() if not form.startswith("nb_tiles")}
    check(sum(n for form, n in rs_forms.items() if not form.startswith("batched")) == launches16["rowscan_sweep"]
          and sum(n for form, n in rs_forms.items() if form.startswith("batched")) == launches16["rowscan_sweep_batched"]
          and sum(n for form, n in forms_run16.items() if form.startswith("nb_tiles")) == launches16["nb_tiles"],
          "[16] the launches by form do not add up to the wrappers' counts")
    masked_row["launches_run_solvent"] = launches16["rowscan_sweep"]
    batched_row["launches_run_solvent"] = launches16["rowscan_sweep_batched"]
    print(f"[16 time] phase 16 took {time.perf_counter() - t_phase16:.1f} s, host clock ({smi})")
    exact16 = {stage: stage_launches(stage, "nb_tiles") for stage in ("fire", "minimize")}
    return launches16, exact16, (mols16, core16, ff16), host16["config"]


def phase19(dev, smi, zero_counts, read_counts, masked_row, exact_row):
    """The absolute hydration (AHFE) leg of ethanol from SMILES, windowed and
    by SMC: [19 windowed] fe/absolute_hydration.py run_solvent (each
    stage's host seconds and rowscan and nb_tiles launches by form; ΔG; the
    interaction group exactly 0 at λ = 1; window 0's card force against the
    host CPU's; a reused window bitwise a fresh one); [19 smc] the
    solvent-phase system, its NPT samples and the weighted vacuum
    conformers, the endstate samples and sequential_monte_carlo over a
    fixed schedule (ESS per λ, the estimate, a rerun bitwise); [19 mtm] one
    OptimizedMTMMove of aligned vacuum proposals. Adds the windowed leg's
    launches to the masked rowscan row and the FIRE's, the SMC's and the
    MTM's to nb_tiles' exact masked row."""
    import numpy as np
    import torch
    from scipy.special import logsumexp

    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.chem.embed import embed_mol
    from timemachine_torch.constants import BOLTZ, DEFAULT_TEMP
    from timemachine_torch.fe import absolute_hydration as ah19
    from timemachine_torch.fe import free_energy as fe19
    from timemachine_torch.fe.topology import BaseTopology
    from timemachine_torch.ff import Forcefield
    from timemachine_torch.ff.handlers import compute_or_load_base_charges
    from timemachine_torch.md import builders as builders19
    from timemachine_torch.md import enhanced as en19
    from timemachine_torch.md import minimizer as minimizer19
    from timemachine_torch.md import smc as smc19
    from timemachine_torch.md.context import Context
    from timemachine_torch.md.moves import OptimizedMTMMove
    from timemachine_torch.md.states import CoordsVelBox
    from timemachine_torch.potentials import NonbondedAllPairs, NonbondedInteractionGroup, all_pairs_kernel

    t_phase19 = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    kT = BOLTZ * DEFAULT_TEMP

    # -- [19 windowed] ---------------------------------------------------------------------------
    clock = StageClock(sync)
    strict_before = os.environ.get("TM_STRICT_CHARGES")
    os.environ["TM_STRICT_CHARGES"] = "1"  # AM1 or fail, as phase 15
    try:
        mol = clock.run("embed", lambda: mol_from_smiles("CCO", add_hs=True, name="ethanol"))
        clock.run("embed", lambda: embed_mol(mol, seed=N19_EMBED_SEED))
        ff = Forcefield.load_default()
        clock.run("am1", lambda: compute_or_load_base_charges(mol, mode=ff.q_handle.base_mode))
        clock.wrap(builders19, "build_water_system", "water box")
        clock.wrap(minimizer19, "fire_minimize_host", "fire")
        clock.wrap(ah19, "_initial_state_at", "initial states")
        clock.wrap(fe19, "sample_with_context", "sampling")
        clock.wrap(fe19, "generate_pair_bar_ulkns", "u_kln")
        clock.wrap(fe19, "estimate_free_energy_bar", "bar")
        md19 = fe19.MDParams(n_frames=N19_FRAMES, n_eq_steps=N19_EQ, steps_per_frame=N19_STEPS_PER_FRAME, seed=N19_SEED)
        zero_counts()
        before = form_launches()
        t0 = time.perf_counter()
        res19, cfg19 = ah19.run_solvent(mol, ff, None, md19, n_windows=N19_WINDOWS, device=dev)
        PLOTS_SEEN["run_solvent AHFE (phase 19)"] = (res19.plots,)
        sync()
        t_run19 = time.perf_counter() - t0
        counts19, plain19 = read_counts()
        for form, n in (form_launches() - before).items():
            clock.forms["setup", form] += n
    finally:
        clock.restore()
        if strict_before is None:
            os.environ.pop("TM_STRICT_CHARGES")
        else:
            os.environ["TM_STRICT_CHARGES"] = strict_before
    fin19 = res19.final_result
    states19 = fin19.initial_states
    n_atoms19, n_host19 = len(states19[0].x0), cfg19.conf.shape[0]
    sec = clock.sec
    print(f"[19 time] run_solvent (AHFE, {N19_WINDOWS} windows, {n_atoms19} atoms: {n_host19} water atoms and ethanol's "
          f"{n_atoms19 - n_host19}) {t_run19:.1f} s: " + ", ".join(f"{k} {sec[k]:.2f} s" for k in (
              "water box", "fire", "initial states", "sampling", "u_kln", "bar"))
          + f" ({N19_WINDOWS} _initial_state_at calls); before it embedding {sec['embed']:.2f} s, AM1 {sec['am1']:.2f} s "
          f"(strict); host clock ({smi})")
    pair_finite = [bool(np.isfinite(r.dG) and np.isfinite(r.dG_err)) for r in fin19.bar_results]
    dG19, dG19_err = float(np.sum(fin19.dGs)), float(np.linalg.norm(fin19.dG_errs))
    print(f"[19 windowed] λ schedule " + " ".join(f"{st.lamb:.4f}" for st in states19) + "; pair dG "
          + " ".join(f"{r.dG:.3f}" for r in fin19.bar_results) + "; overlaps " + " ".join(f"{r.overlap:.3f}" for r in fin19.bar_results)
          + f"; ΔG (decoupled -> coupled) {dG19:.4f} +- {dG19_err:.4f} kJ/mol over {len(fin19.bar_results)} pairs "
          f"(finite {sum(pair_finite)}), {N19_EQ} equilibration steps and {N19_FRAMES} frames of {N19_STEPS_PER_FRAME} a "
          f"window: not converged; FreeSolv's experimental hydration free energy of ethanol {FREESOLV_ETHANOL_KJ:.2f} kJ/mol "
          f"(-5.00 kcal/mol; for information); plots {res19.plots} ({smi})")
    check(len(fin19.bar_results) == N19_WINDOWS - 1 and all(pair_finite), "[19] the windowed leg did not give 7 finite BAR pairs")
    stages19 = ("water box", "fire", "initial states", "sampling", "u_kln", "bar")
    print(f"[19 kernels] rowscan and nb_tiles launches by stage and form: {clock.by_stage()}; totals {counts19}; plain "
          f"sweeps {plain19} ({smi})")
    check(plain19 == 0, "[19] the windowed leg ran a plain sweep")
    check(all(n == 0 for (stage, _), n in clock.forms.items() if stage not in stages19), "[19] a kernel launch outside the stages")
    fire_exact = sum(n for (st, form), n in clock.forms.items() if st == "fire" and form.startswith("nb_tiles") and form.endswith("exact"))
    check(fire_exact > 0 and clock.launches("fire", "rowscan") == 0 and clock.launches("fire", "nb_tiles") == fire_exact,
          "[19] the host's FIRE did not run on nb_tiles' exact form alone")
    sampling = {form: n for (st, form), n in clock.forms.items() if st == "sampling" and n}
    check(sampling.get(MASKED_F, 0) >= N19_WINDOWS * (N19_EQ + N19_FRAMES * N19_STEPS_PER_FRAME)
          and all(form.endswith("triangular minimum image w") for form in sampling),
          "[19] the windows' MD did not run on the masked rowscan form alone")
    check(clock.launches("u_kln", "rowscan") > 0 and clock.launches("u_kln", "nb_tiles") == 0,
          "[19] the u_kln did not run on the rowscan kernel alone")
    masked_row["launches_ahfe"] = sampling.get(MASKED_F, 0) / (N19_WINDOWS * (N19_EQ + N19_FRAMES * N19_STEPS_PER_FRAME))
    exact_row["launches_ahfe_fire"] = fire_exact

    # the interaction group at λ = 1: exactly 0 in the u_kln and on the card
    ixn_i = next(i for i, p in enumerate(states19[0].potentials) if isinstance(p, NonbondedInteractionGroup))
    u_ixn = fin19.bar_results[0].u_kln_by_component[ixn_i]
    dt19 = states19[0].potentials[0].params.dtype  # float32 on the card
    x0c = torch.as_tensor(states19[0].x0, device=dev, dtype=dt19)
    box0c = torch.as_tensor(states19[0].box0, device=dev, dtype=dt19)
    with torch.no_grad():
        u_ixn0, f_ixn0 = states19[0].potentials[ixn_i].energy_force(x0c, box0c)
        u_ixn1 = states19[-1].potentials[ixn_i].energy(x0c, box0c)
    zero19 = bool(np.all(u_ixn[:, 0] == 0.0) and float(u_ixn0) == 0.0 and not bool(f_ixn0.any()))
    print(f"[19 ixn] window 0 (λ {states19[0].lamb:.1f}): the interaction group's energy exactly 0 over the pair's "
          f"{u_ixn[:, 0].size} u_kln entries and on the card at x0 (force 0): {zero19}; at λ {states19[-1].lamb:.1f} "
          f"{float(u_ixn1):.2f} kJ/mol ({smi})")
    check(zero19, "[19] the interaction group is not exactly 0 at λ = 1")

    # window 0's force on the card (its host term as get_context configured it, rowscan) against the
    # same window built on the host CPU in float64, host term rowscan too
    cpu = torch.device("cpu")
    afe_cpu = fe19.AbsoluteFreeEnergy(mol, BaseTopology(mol, ff))
    st_cpu = ah19._initial_state_at(afe_cpu, ff, cfg19, states19[0].x0[:n_host19], DEFAULT_TEMP, states19[0].lamb, md19.seed, cpu)
    ap_i = next(i for i, p in enumerate(st_cpu.potentials) if isinstance(p, NonbondedAllPairs))
    x64 = torch.as_tensor(states19[0].x0, dtype=torch.float64)
    box64 = torch.as_tensor(states19[0].box0, dtype=torch.float64)
    st_cpu.potentials[ap_i].configure(box64, x64, kernel="rowscan")
    card_pots = states19[0].potentials
    check(card_pots[ap_i].kernel == "rowscan", "[19] window 0's host term is not on the rowscan sweep")
    with torch.no_grad():
        f_card = [p.energy_force(x0c, box0c)[1].double().cpu() for p in card_pots]
        f_cpu = [p.energy_force(x64, box64)[1] for p in st_cpu.potentials]
        ap_norm = float(torch.linalg.vector_norm(NonbondedAllPairs.energy_force(card_pots[ap_i], x0c, box0c)[1]))
    per_term = " ".join(
        f"{type(p).__name__} {float(torch.linalg.vector_norm(a - b)) / max(float(torch.linalg.vector_norm(b)), 1e-30):.2e}"
        for p, a, b in zip(card_pots, f_card, f_cpu))
    rel19 = float(torch.linalg.vector_norm(sum(f_card) - sum(f_cpu))) / ap_norm
    print(f"[19 force] window 0, card ({dt19}) vs host CPU (float64, the same build), per term |diff| / |term force|: "
          f"{per_term}; total |diff| / |all-pairs force| {rel19:.3e} (tol {TOL_FORCE_REL_NORM:g}) ({smi})")
    check(rel19 <= TOL_FORCE_REL_NORM, "[19] window 0's force on the card disagrees with the host CPU")

    mid19 = len(states19) // 2
    fresh19 = fe19.get_context(states19[mid19], md19)
    reused19 = fe19.get_context(states19[0], md19)
    reused19.multiple_steps(N19_REUSE)
    reused19.reset_for_state(states19[mid19])
    for c in (fresh19, reused19):
        c.multiple_steps(N19_REUSE)
    same19 = all(np.array_equal(f(fresh19), f(reused19)) for f in (Context.get_x_t, Context.get_v_t, Context.get_box))
    print(f"[19 reuse] window {mid19}: a fresh Context and one reset from window 0 after {N19_REUSE} steps there, "
          f"{N19_REUSE} steps each: x, v, box bitwise equal: {same19} ({smi})")
    check(same19, "[19] a reused Context differs from a fresh one")

    # -- [19 smc] --------------------------------------------------------------------------------
    smc_clock = StageClock(sync)
    zero_counts()
    before = form_launches()
    system = smc_clock.run("solvent system", lambda: en19.get_solvent_phase_system(mol, ff, 1.0, device=dev))
    pots, params, masses, coords, box = system
    solvent_xvbs = smc_clock.run("solvent samples", lambda: en19.generate_solvent_samples(
        coords, box, masses, pots, params, DEFAULT_TEMP, 1.0, N19_SMC_SEED, N19_SOLVENT_SAMPLES, num_equil_steps=N19_SMC_EQ,
        md_steps_per_move=N19_STEPS_PER_SAMPLE, device=dev))
    vacuum = smc_clock.run("ligand samples", lambda: en19.VacuumState(mol, ff, device=dev))
    ligand_xvs, ligand_lw = smc_clock.run("ligand samples", lambda: en19.generate_log_weighted_samples(
        mol, DEFAULT_TEMP, vacuum.U_easy, vacuum.U_full, N19_SMC_SEED, steps_per_batch=N19_VAC_STEPS_PER_BATCH,
        num_batches=N19_VAC_WALKERS * N19_VAC_BATCHES, num_workers=N19_VAC_WALKERS, burn_in_batches=N19_VAC_BURN_IN,
        device=dev))

    def anneal(tag):
        """The endpoint machinery from the samples above, then SMC with a RandomState(seed) from decoupled
        (λ = 1, where the walkers are drawn) to coupled: the driver's s = 1 - λ runs 0 -> 1 (ROADMAP R10)."""
        rp, mover, endstate = smc_clock.run(f"endstate {tag}", lambda: ah19._endpoint_machinery(
            mol, ff, system, solvent_xvbs, ligand_xvs, ligand_lw, N19_ENDSTATE, DEFAULT_TEMP, 1.0, N19_SMC_STEPS,
            N19_SMC_SEED, np.random.RandomState(N19_SMC_SEED), dev))
        walkers, lambdas, propagate, log_prob, resample = ah19._smc_ingredients(
            rp, mover, endstate, N19_SMC_WALKERS, N19_SMC_WINDOWS, N19_RESAMPLE, N19_SMC_SEED)
        find_next = partial(smc19.fixed_find_next_lambda, log_prob=lambda xs, s, *_: log_prob(xs, 1.0 - s),
                            lambdas=1.0 - np.asarray(lambdas)[::-1])
        result = smc_clock.run(f"smc {tag}", lambda: smc19.sequential_monte_carlo(
            walkers, lambda xs, s: propagate(xs, 1.0 - s), lambda xs, s: log_prob(xs, 1.0 - s), resample, find_next))
        return result, rp, mover

    smc_a, rp19, mover19 = anneal("a")
    smc_b, _, _ = anneal("b")
    counts_smc, plain_smc = read_counts()
    for form, n in (form_launches() - before).items():
        smc_clock.forms["setup", form] += n
    lw_traj, inc_traj = smc_a["log_weights_traj"], smc_a["incremental_log_weights_traj"]
    # the ESS each λ's reweighting leaves, before the resampler flattens the weights it stores
    ess = [smc19.effective_sample_size(lw + inc) for lw, inc in zip(lw_traj, inc_traj)]
    final = lw_traj[-1]
    weights = np.exp(final - logsumexp(final))
    f_smc = -(logsumexp(final) - np.log(len(final)))
    finite_smc = bool(np.isfinite(lw_traj).all() and np.isfinite(smc_a["incremental_log_weights_traj"]).all())
    rerun = all(np.array_equal(smc_a[k], smc_b[k]) for k in
                ("log_weights_traj", "ancestry_traj", "incremental_log_weights_traj", "lambdas_traj")) and all(
        np.array_equal(a.coords, b.coords) and np.array_equal(a.box, b.box) for a, b in zip(smc_a["traj"][-1], smc_b["traj"][-1]))
    n_smc_atoms = len(coords)
    sec = smc_clock.sec
    print(f"[19 smc] the solvent-phase system at λ 1: {n_smc_atoms} atoms ({n_smc_atoms - mol.num_atoms} water atoms), box "
          f"{box[0, 0]:.2f} nm; stages " + ", ".join(f"{k} {v:.2f} s" for k, v in sec.items()) + f"; {len(solvent_xvbs)} "
          f"solvent states ({N19_SMC_EQ} equilibration steps at 1e-4 ps, {N19_SOLVENT_SAMPLES} samples of "
          f"{N19_STEPS_PER_SAMPLE}), {len(ligand_xvs)} weighted vacuum conformers (ESS "
          f"{smc19.effective_sample_size(ligand_lw):.1f}), {N19_ENDSTATE} endstate samples; host clock ({smi})")
    print(f"[19 smc] {N19_SMC_WALKERS} walkers, λ " + " ".join(f"{1.0 - x:.4f}" for x in smc_a["lambdas_traj"])
          + f" ({N19_SMC_STEPS} NPT steps a λ): ESS after each reweighting, before resampling (below "
          f"{N19_RESAMPLE * N19_SMC_WALKERS:g}: resampled) " + " ".join(f"{e:.2f}" for e in ess)
          + f"; ΔG (decoupled -> coupled) {f_smc * kT:.4f} kJ/mol ({f_smc:.4f} kT) from the final log weights; "
          f"every log weight finite {finite_smc}; normalized weights sum to 1 - {1.0 - weights.sum():.3e}; a rerun from "
          f"seed {N19_SMC_SEED} bitwise equal {rerun} ({smi})")
    check(finite_smc and abs(weights.sum() - 1.0) <= TOL_WEIGHT_SUM, "[19] an SMC log weight is not finite")
    check(rerun, "[19] an SMC rerun from the same seed differs")
    print(f"[19 smc kernels] rowscan and nb_tiles launches by stage and form: {smc_clock.by_stage()}; totals {counts_smc}; "
          f"plain sweeps {plain_smc}; the mover's host term {mover19.bps[ap_i].kernel!r}, all_pairs_kernel('fresh', "
          f"{n_smc_atoms}) {all_pairs_kernel('fresh', n_smc_atoms, dev)!r} ({smi})")
    check(plain_smc == 0 and counts_smc["rowscan_sweep"] == 0 and counts_smc["rowscan_sweep_batched"] == 0,
          "[19] the SMC path launched a plain sweep or the rowscan kernel")
    # the all-pairs form at each site (potentials.all_pairs_kernel): the FIRE's "host_du_dx", the moves', the
    # equilibration's and the energies' "fresh": nb_tiles' exact form at 4,096 atoms and up on the card, else dense
    fresh19 = all_pairs_kernel("fresh", n_smc_atoms, dev)
    check(mover19.bps[ap_i].kernel == fresh19, "[19] the move's host term is not a fresh Context's form")
    for stage in ("solvent system", "solvent samples", "smc a", "smc b"):
        n_nb = smc_clock.launches(stage, "nb_tiles")
        check(n_nb > 0 if fresh19 == "v1" else n_nb == 0, f"[19] the {stage} stage did not take the {fresh19} form")
    check(all(n == 0 for (st, _), n in smc_clock.forms.items() if st.startswith(("ligand", "endstate"))),
          "[19] the vacuum sampler or the endpoint machinery launched a sweep")
    exact_row["launches_smc"] = smc_clock.launches("smc a", "nb_tiles")

    # -- [19 mtm] --------------------------------------------------------------------------------
    vac_x = ligand_xvs[:, 0]
    xvb = solvent_xvbs[-1]
    n_lig = mol.num_atoms
    proposals = en19.aligned_batch_propose(xvb, N19_MTM_K, np.random.default_rng(N19_SMC_SEED), vac_x, ligand_lw)
    chosen = en19.jax_sample_from_log_weights(vac_x, ligand_lw, N19_MTM_K, np.random.default_rng(N19_SMC_SEED))

    def internal(x):
        x = np.asarray(x, dtype=np.float64)
        return np.linalg.norm(x[:, None] - x[None, :], axis=-1)

    geometry = max(float(np.abs(internal(p.coords[-n_lig:]) - internal(c)).max()) for p, c in zip(proposals, chosen))
    solvent_kept = all(np.array_equal(p.coords[:-n_lig], xvb.coords[:-n_lig]) for p in proposals)
    move = OptimizedMTMMove(
        N19_MTM_K, lambda x, k, rng: en19.jax_aligned_batch_propose_coords(x, k, rng, vac_x, ligand_lw),
        lambda states, b: -np.array([rp19(CoordsVelBox(s, None, b), 1.0) for s in states]), seed=N19_SMC_SEED)
    zero_counts()
    t0 = time.perf_counter()
    _, p_accept = move.acceptance_probability(xvb.coords, xvb.box, move.rng)
    sync()
    t_mtm = time.perf_counter() - t0
    counts_mtm, plain_mtm = read_counts()
    print(f"[19 mtm] OptimizedMTMMove, K {N19_MTM_K} aligned vacuum proposals on the last solvent sample, log weights "
          f"-u(x, λ 1) / kT: acceptance probability {p_accept:.6g} ({t_mtm:.2f} s host clock); launches {counts_mtm}, plain "
          f"calls {plain_mtm}; the ligand's internal distances after alignment vs the vacuum conformer's: largest |diff| "
          f"{geometry:.3e} nm (tol {TOL_ALIGNED_GEOMETRY:g}), the solvent bitwise kept {solvent_kept} ({smi})")
    check(np.isfinite(p_accept) and 0.0 <= p_accept <= 1.0, "[19] the MTM acceptance probability is not a probability")
    check(geometry <= TOL_ALIGNED_GEOMETRY and solvent_kept, "[19] an aligned proposal changed the ligand's geometry")
    check(plain_mtm == 0 and counts_mtm["nb_tiles"] == (2 * N19_MTM_K if fresh19 == "v1" else 0),
          "[19] the MTM's log weights did not take one nb_tiles launch each")
    exact_row["launches_mtm"] = counts_mtm["nb_tiles"]
    print(f"[19 time] phase 19 took {time.perf_counter() - t_phase19:.1f} s, host clock ({smi})")
    return dG19, f_smc * kT


def phase20(dev, smi, zero_counts, read_counts, batched_row):
    """Water sampling over the probe-in-water ladder of the JAX package's
    examples/water_sampling_hrex.py at a 4.0 nm box (6,419 atoms): [20
    build] the probe embedded and solvated, the AHFE states; [20 firing]
    a segment of a ReplicaExchangeRunner, its firing traced: the carried
    weights against a float64 rebuild, the firing replayed through its
    records, the waters rigid and the probe and box untouched; [20 control]
    a firing after a water is planted on another in every replica: each
    replica's force through the lists rebuilt after it against the host
    CPU's float64 force (the same rowscan function), the lists from before
    it as the control; [20 launches] a firing captured in a CUDA graph at K
    = 2 and 6 (equal); [20 rerun] a fresh runner's segment bitwise the
    first's; [20 time] an HREX step with and without the sampler; [20
    hrex] run_sims_hrex at the cut depth (one batched F launch a
    step, a list rebuild after every firing, every firing's carried weights
    against a float64 rebuild, the diagnostics' counts, occupancy and
    acceptance per window, ΔG); [20 single] one window by
    get_context + sample_with_context; [20 local] the time-multiplexed HREX
    with local MD. Adds launches_water_hrex to the batched row. Returns
    {"dG", "states", "make_runner"}: the ladder's states and
    make_runner(water) -> an initialized ReplicaExchangeRunner over them
    (phase 23 resumes one)."""
    import numpy as np
    import torch

    from timemachine_torch.constants import DEFAULT_TEMP
    from timemachine_torch.fe import absolute_hydration as ah20
    from timemachine_torch.fe import free_energy as fe20
    from timemachine_torch.fe.topology import BaseTopology
    from timemachine_torch.ff import Forcefield
    from timemachine_torch.md import context as context20
    from timemachine_torch.md.exchange.targeted_insertion import TIBDExchangeMove
    from timemachine_torch.md.hrex import get_swap_attempts_per_iter_heuristic
    from timemachine_torch.parallel.replica_exchange import ReplicaExchangeRunner
    from timemachine_torch.potentials import NonbondedAllPairs, all_pairs_kernel
    from timemachine_torch.testsystems.water_sampling import build_probe_in_water, compute_occupancy

    t_phase20 = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    f64 = torch.float64
    cpu = torch.device("cpu")
    wsp = fe20.WaterSamplingParams(interval=N20_INTERVAL, n_proposals=N20_PROPOSALS, batch_size=N20_BATCH, radius=N20_RADIUS)
    md20 = fe20.MDParams(n_frames=N20_FRAMES, n_eq_steps=N20_EQ, steps_per_frame=N20_STEPS_PER_FRAME, seed=N20_SEED,
                         hrex_params=fe20.HREXParams(), water_sampling_params=wsp)

    # -- [20 build] ------------------------------------------------------------------------------
    clock = StageClock(sync)
    strict_before = os.environ.get("TM_STRICT_CHARGES")
    os.environ["TM_STRICT_CHARGES"] = "1"  # AM1 or fail, as phases 15 and 19
    try:
        mol, host = clock.run("probe in water", lambda: build_probe_in_water(box_width=N20_BOX, seed=N20_SEED))
        ff = Forcefield.load_default()
        afe = fe20.AbsoluteFreeEnergy(mol, BaseTopology(mol, ff))
        schedule = np.linspace(1.0, 0.0, N20_WINDOWS)
        states = clock.run("initial states", lambda: ah20.setup_initial_states(
            afe, ff, host, DEFAULT_TEMP, schedule, N20_SEED, device=dev))
    finally:
        if strict_before is None:
            os.environ.pop("TM_STRICT_CHARGES")
        else:
            os.environ["TM_STRICT_CHARGES"] = strict_before
    K = len(states)
    n_atoms, n_host = states[0].x0.shape[0], host.conf.shape[0]
    lig = torch.as_tensor(states[0].ligand_idxs, device=dev)
    temperature = states[0].integrator.temperature
    water_params = [fe20.get_water_sampler_params(s) for s in states]
    print(f"[20 build] the probe (adamantane, {mol.num_atoms} atoms) in a {N20_BOX} nm box: {n_atoms} atoms, "
          f"{n_host // 3} waters; λ {' '.join(f'{s.lamb:.2f}' for s in states)}; host term form at {n_atoms} atoms "
          f"{all_pairs_kernel('context', n_atoms, dev)!r}; stages " + ", ".join(f"{k} {v:.2f} s" for k, v in clock.sec.items())
          + f" (the embedding and FIRE inside them), host clock ({smi})")
    check(n_atoms >= 4096 and all_pairs_kernel("context", n_atoms, dev) == ("rowscan" if dev.type == "cuda" else "dense"),
          "[20] the system is not over the 4,096-atom rule")

    def make_runner(water: bool):
        md = md20 if water else replace(md20, water_sampling_params=None)
        runner = ReplicaExchangeRunner(
            fe20.get_context(states[0], md), [[p.params for p in s.potentials] for s in states], temperature=temperature,
            neighbor_pairs=list(zip(range(K), range(1, K))), n_swap_attempts_per_iter=get_swap_attempts_per_iter_heuristic(K),
            max_delta_states=md20.hrex_params.max_delta_states, seed=N20_SEED,
            water_params_by_state=water_params if water else None,
        )
        runner.initialize([s.x0 for s in states], [s.v0 for s in states], [s.box0 for s in states])
        return runner

    # -- [20 firing] a segment's firing, traced -----------------------------------------------------
    runner = make_runner(True)
    batch = runner.batch
    k_w = next(i for i, m in enumerate(batch.movers) if isinstance(m, TIBDExchangeMove))
    mover = batch.movers[k_w]
    host_i = next(i for i, p in enumerate(batch.potentials) if isinstance(p, NonbondedAllPairs))
    move = batch._move_fns[k_w]
    firing = move.firing
    seen = {}

    def traced(state, x, v, box):
        sync()
        t_start = time.perf_counter()
        seen.update(stale=batch._prov_states, x=x, box=box, state=state)
        new_state, x_new, v_new, box_new, trace = move(state, x, v, box, with_trace=True)
        sync()
        seen.update(sec=time.perf_counter() - t_start, trace=trace, after=new_state)
        return new_state, x_new, v_new, box_new

    batch._move_fns[k_w] = traced
    runner.equilibrate(N20_INTERVAL, barostat_interval=None)  # one segment, the sampler firing after its last step
    sync()
    batch._move_fns[k_w] = move
    trace = seen["trace"]
    acc = trace["accept"]  # (P, K)
    first = [t.clone() for t in (batch._x, batch._v, batch._box)] + [seen["after"].n_accepted.clone()]
    x1, box1 = batch._x, batch._box
    params64 = seen["state"].params.to(f64)
    w64 = firing.weights.full(params64, x1.to(f64), box1.to(f64))
    drift = float((trace["weights"].to(f64) - w64).abs().max())
    records = {k: trace[k] for k in ("chosen", "i2o", "site", "rot", "log_u", "accept")}
    records["site"], records["rot"], records["log_u"] = (records[k].to(f64) for k in ("site", "rot", "log_u"))
    x_rep, raw64, acc64, n1_64, _ = firing.replay(params64, seen["x"].to(f64), seen["box"].to(f64), records, follow_accepts=True)
    raw32 = trace["raw_log_p"].to(f64)
    both = torch.isfinite(raw64) & torch.isfinite(raw32)
    same_pattern = bool(torch.equal(torch.isfinite(raw64), torch.isfinite(raw32)))
    near = both & (raw64 >= RAW_DECISION_FLOOR)
    far = both & (raw64 < RAW_DECISION_FLOOR)
    gap = (raw64 - raw32).abs()
    raw_gap = float(gap[near].max()) if bool(near.any()) else 0.0
    raw_rel = float((gap[far] / raw64[far].abs()).max()) if bool(far.any()) else 0.0
    far_kept = bool((raw32[far] < RAW_DECISION_FLOOR / 2).all())
    margin = (torch.clamp(raw64, max=0.0) - records["log_u"]).abs()
    flips = acc64 != acc
    flips_outside = int((flips & (margin >= TOL_RAW_LOG_P)).sum())
    print(f"[20 firing] a segment of {N20_INTERVAL} steps of the {K} replicas, the sampler firing after its last step: "
          f"{N20_PROPOSALS} proposals each, {seen['sec']:.3f} s traced, accepted by replica {acc.sum(0).tolist()}, the "
          f"largest raw log p by replica " + " ".join(f"{v:.2f}" for v in raw32.amax(0).tolist()) + "; the carried weights "
          f"({trace['weights'].dtype}) against a float64 rebuild at the final coordinates: largest |diff| {drift:.3e} kT (tol "
          f"{TOL_WEIGHT_DRIFT_KT:g}); the firing replayed through its records (draws and accepts): largest |raw log p| gap "
          f"{raw_gap:.3e} over the {int(near.sum())} at or above {RAW_DECISION_FLOOR:g} (tol {TOL_RAW_LOG_P:g}), relative "
          f"{raw_rel:.3e} over the {int(far.sum())} below, the firing's below {RAW_DECISION_FLOOR / 2:g} there {far_kept}, "
          f"non-finite pattern equal {same_pattern}; "
          f"decisions that differ "
          f"{int(flips.sum())} of {flips.numel()}, {flips_outside} of them with |min(raw, 0) - log u| >= {TOL_RAW_LOG_P:g}, "
          f"the smallest margin {float(margin.min()):.3e}; region counts that differ {int((n1_64 != trace['n1']).sum())}; "
          f"replayed coordinates vs the card's {float((x_rep - x1.to(f64)).abs().max()):.3e} nm ({smi})")
    check(drift <= TOL_WEIGHT_DRIFT_KT, "[20] the carried weights drifted from a float64 rebuild")
    check(same_pattern and raw_gap <= TOL_RAW_LOG_P and far_kept and flips_outside == 0,
          "[20] the float64 replay disagrees with the card")

    def water_geometry(x):
        w = x[:, firing.water_idxs]  # (K, W, 3, 3)
        return torch.stack([torch.linalg.vector_norm(w[:, :, a] - w[:, :, b], dim=-1) for a, b in ((0, 1), (0, 2), (1, 2))], -1)

    def mover_invariants():
        """(largest change of a water's O-H and H-H distances, probe unmoved, box unmoved) through the last firing."""
        rigid = float((water_geometry(batch._x) - water_geometry(seen["x"])).abs().max())
        return rigid, bool(torch.equal(batch._x[:, lig], seen["x"][:, lig])), bool(torch.equal(batch._box, seen["box"]))

    rigid, probe_kept, box_kept = mover_invariants()
    counted = (seen["after"].n_proposed - seen["state"].n_proposed).tolist()
    print(f"[20 mover] the waters' O-H and H-H distances through the firing: largest change {rigid:.3e} nm (tol "
          f"{TOL_RIGID_NM:g}); the probe bitwise unmoved {probe_kept}, the box bitwise unmoved {box_kept}; proposals "
          f"counted by replica {counted} ({smi})")
    check(rigid <= TOL_RIGID_NM and probe_kept and box_kept, "[20] the mover broke a water, moved the probe or the box")
    check(counted == [N20_PROPOSALS] * K, "[20] the mover did not count its proposals")

    # -- [20 control] a firing with teleports: the lists rebuilt after it, and the stale ones ------------------
    # in equilibrated water a proposal is accepted rarely ([20 water]'s acceptance), so every replica's last
    # water is placed N20_PLANT_NM from its neighbour in the list (a copy of that water, shifted): the two
    # carry the largest weights, and the sampler's next firing, through the step's own mover call, teleports
    # one of them
    plant = firing.water_idxs[-2:]
    x_plant = batch._x.clone()
    x_plant[:, plant[1]] = x_plant[:, plant[0]] + torch.tensor([N20_PLANT_NM, 0.0, 0.0], device=dev, dtype=x_plant.dtype)
    batch._x = x_plant
    batch._prov_states = None
    batch._ensure_lists()  # the lists the firing finds: the planted coordinates
    batch._move_fns[k_w] = traced
    batch._fire_movers(N20_INTERVAL - 1)  # the end of a step whose count fires the sampler
    sync()
    batch._move_fns[k_w] = move
    n_acc = seen["trace"]["accept"].sum(0).cpu().numpy()
    x1, box1 = batch._x, batch._box
    rigid_p, probe_p, box_p = mover_invariants()
    w_full = firing.weights.full(seen["state"].params.to(f64), x1.to(f64), box1.to(f64))
    drift_p = float((seen["trace"]["weights"].to(f64) - w_full).abs().max())  # after accepted moves' updates

    def card_forces(prov_states):
        """(K, N, 3) each replica's total force, the providers through prov_states' lists."""
        with torch.no_grad():
            total = torch.zeros_like(batch._x)
            for i in range(len(batch.potentials)):
                if i in batch._providers:
                    f = batch._providers[i][1](prov_states[i], batch._x, batch._params[i], batch._box, 1)[0]
                else:
                    f = batch._u_force[i](batch._x, batch._params[i], batch._box)[1]
                total = total + f
        return total.double().cpu()

    f_now, f_stale = card_forces(batch._prov_states), card_forces(seen["stale"])
    # the reference: each replica's state built on the host CPU in float64, its host term the same
    # rowscan function (the plain sweep over lists built there at the same x), as phases 13 and 19;
    # the dense form's exact erfc sits farther than the limit from the rowscan polynomial, so it is
    # printed for replica 0 only
    afe_cpu = fe20.AbsoluteFreeEnergy(mol, BaseTopology(mol, ff))
    state_of = runner._state_of_replica()
    rel_now, rel_stale = [], []
    t0 = time.perf_counter()
    for r in range(K):
        st_cpu = ah20._initial_state_at(afe_cpu, ff, host, states[0].x0[:n_host], DEFAULT_TEMP, float(schedule[state_of[r]]),
                                        N20_SEED, cpu)
        x64, b64 = x1[r].double().cpu(), box1[r].double().cpu()
        st_cpu.potentials[host_i].configure(b64, x64, kernel="rowscan")
        with torch.no_grad():
            f_ref = sum(p.energy_force(x64, b64)[1] for p in st_cpu.potentials)
            ap = float(torch.linalg.vector_norm(NonbondedAllPairs.energy_force(batch.potentials[host_i], x1[r], box1[r])[1]))
            if r == 0:
                st_cpu.potentials[host_i].configure(b64, x64, kernel="dense")
                f_dense = sum(p.energy_force(x64, b64)[1] for p in st_cpu.potentials)
                rel_dense = float(torch.linalg.vector_norm(f_now[r] - f_dense)) / ap
        rel_now.append(float(torch.linalg.vector_norm(f_now[r] - f_ref)) / ap)
        rel_stale.append(float(torch.linalg.vector_norm(f_stale[r] - f_ref)) / ap)
    t_ref = time.perf_counter() - t0
    moved = [r for r in range(K) if n_acc[r] > 0]
    print(f"[20 control] the planted firing: accepted by replica {n_acc.tolist()}, the waters rigid to {rigid_p:.3e} nm, the "
          f"probe and box bitwise unmoved {probe_p and box_p}, the carried weights {drift_p:.3e} kT from a float64 rebuild "
          f"(tol {TOL_WEIGHT_DRIFT_KT:g}); each replica's force through the lists rebuilt after it "
          f"against the host CPU's float64 force (the rowscan function, {t_ref:.1f} s), |diff| / |all-pairs force|: "
          + " ".join(f"{v:.2e}" for v in rel_now) + f" (tol {TOL_FORCE_REL_NORM:g}); the control, through the lists from "
          "before it: " + " ".join(f"{v:.2e}" for v in rel_stale) + f" (replicas with a teleport {moved}: the largest must "
          f"miss); replica 0 against the CPU's float64 dense form (exact erfc) {rel_dense:.2e}, for information ({smi})")
    check(rigid_p <= TOL_RIGID_NM and probe_p and box_p, "[20] the planted firing broke a water, moved the probe or the box")
    check(drift_p <= TOL_WEIGHT_DRIFT_KT, "[20] the planted firing's carried weights drifted from a float64 rebuild")
    check(max(rel_now) <= TOL_FORCE_REL_NORM, "[20] a force through the rebuilt lists disagrees with the host CPU")
    check(bool(moved) and max(rel_stale[r] for r in moved) > TOL_FORCE_REL_NORM,
          "[20] the stale lists' control did not miss the limit: the force check cannot fail")

    # -- [20 launches] a firing at K = 2 and K = 6 in a CUDA graph -------------------------------------
    def firing_launches(k):
        st = mover.init_state(dev, batch._x.dtype, shape=(k,))
        st.params = seen["state"].params[:k].clone()
        xk, vk, bk = (t[:k].clone() for t in (batch._x, batch._v, batch._box))
        move_k = mover.make_move_fn(None, dev)
        with torch.no_grad():
            return graph_nodes(lambda: move_k(st, xk, vk, bk), st.generator)

    nodes2, nodesK = firing_launches(2), firing_launches(K)
    print(f"[20 launches] a firing of {N20_PROPOSALS} proposals captured in a CUDA graph: {nodes2[0]} kernels at K = 2, "
          f"{nodesK[0]} at K = {K} ({nodesK[0] / N20_PROPOSALS:.1f} a proposal; memory sets {nodes2[2]}, {nodesK[2]}; "
          f"copies {nodes2[1]}, {nodesK[1]}) ({smi})")
    check(nodes2[0] > 0 and nodes2 == nodesK, "[20] a firing's launches grow with K")

    # -- [20 rerun] and [20 time] --------------------------------------------------------------------------
    def segment_ms(r):
        sync()
        t_start = time.perf_counter()
        r.equilibrate(N20_INTERVAL, barostat_interval=None)
        sync()
        return (time.perf_counter() - t_start) * 1e3 / N20_INTERVAL

    ms = {}
    for water in (True, False):
        timed = make_runner(water)
        segment_ms(timed)  # its first segment
        if water:
            k_t = k_w
            again = [timed.batch._x, timed.batch._v, timed.batch._box, timed.batch.get_mover_states()[k_t].n_accepted]
            bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
            print(f"[20 rerun] a fresh runner's first segment against the first runner's: x, v, box and the accepted "
                  f"counts bitwise equal {bitwise} ({smi})")
            check(bitwise, "[20] a rerun from the same seeds differs")
        ms[water] = segment_ms(timed)
    print(f"[20 time] an HREX step of {K} replicas over {N20_INTERVAL} steps, the second segment of a fresh runner: "
          f"{ms[True]:.3f} ms with the sampler (one firing in them), {ms[False]:.3f} ms without: a firing about "
          f"{(ms[True] - ms[False]) * N20_INTERVAL / 1e3:.3f} s ({(ms[True] - ms[False]) * N20_INTERVAL / N20_PROPOSALS:.3f} "
          f"ms a proposal for all {K} replicas), host clock ({smi})")

    # -- [20 hrex] run_sims_hrex at the cut depth -------------------------------------------------------
    tally = Counter()
    drifts = []
    ensure_lists, make_move_fn = context20.BatchedContext._ensure_lists, TIBDExchangeMove.make_move_fn

    def counting_ensure(self):
        tally["rebuilds"] += self._prov_states is None
        ensure_lists(self)

    def counting_make(self, energy_fn=None, device=None):
        inner = make_move_fn(self, energy_fn, device)

        def counted(state, x, v, box):
            """The firing, traced: its accepted moves and its carried weights against a float64 rebuild."""
            tally["firings"] += 1
            out = inner(state, x, v, box, with_trace=True)
            w_full = inner.firing.weights.full(state.params.to(f64), out[1].to(f64), box.to(f64))
            drifts.append((int(out[4]["accept"].sum()), float((out[4]["weights"].to(f64) - w_full).abs().max())))
            return out[:4]

        return counted

    context20.BatchedContext._ensure_lists, TIBDExchangeMove.make_move_fn = counting_ensure, counting_make
    try:
        zero_counts()
        before = form_launches()
        t0 = time.perf_counter()
        res20, trajs20, diag20, water20 = fe20.run_sims_hrex(states, md20, print_diagnostics_interval=None)
        sync()
        t_hrex = time.perf_counter() - t0
        counts_h, plain_h = read_counts()
        forms_h = form_launches() - before
    finally:
        context20.BatchedContext._ensure_lists, TIBDExchangeMove.make_move_fn = ensure_lists, make_move_fn
    steps = N20_EQ + N20_FRAMES * N20_STEPS_PER_FRAME
    firings = steps // N20_INTERVAL
    check(isinstance(water20, fe20.WaterSamplingDiagnostics), "[20] run_sims_hrex returned no water diagnostics")
    counts = np.asarray(water20.proposals_by_state_by_iter)
    cum = water20.cumulative_proposals_by_state()
    acc_rate = cum[:, 0] / cum[:, 1]
    ligand_idxs = states[0].ligand_idxs
    inside = [np.mean([_waters_inside(f, b, ligand_idxs, firing.water_idxs.cpu().numpy(), N20_RADIUS)
                       for f, b in zip(t.frames, t.boxes)]) for t in trajs20]
    occupancy = [np.mean([compute_occupancy(f, b, ligand_idxs, N20_RADIUS) // 3 for f, b in zip(t.frames, t.boxes)])
                 for t in trajs20]
    finite20 = bool(np.isfinite(res20.dGs).all() and np.isfinite(res20.dG_errs).all())
    print(f"[20 hrex] run_sims_hrex over the {K} windows ({N20_EQ} equilibration steps, {N20_FRAMES} iterations of "
          f"{N20_STEPS_PER_FRAME}; the example's 1,000 and 50 of 100 cut): {t_hrex:.1f} s host clock; launches by form "
          f"{dict(forms_h)}; totals {counts_h}, plain calls {plain_h}; firings {tally['firings']} (expected {firings}), list "
          f"rebuilds {tally['rebuilds']} (a segment's start {1 + N20_FRAMES}, plus one after every firing) ({smi})")
    check(plain_h == 0, "[20] the water-sampling HREX ran a plain sweep")
    check(forms_h["batched F w"] == steps, "[20] the water-sampling HREX did not take one batched F launch a step")
    check(tally["firings"] == firings and tally["rebuilds"] == 1 + N20_FRAMES + firings,
          "[20] the lists were not rebuilt after every firing")
    print(f"[20 drift] each firing's accepted moves and its carried weights against a float64 rebuild at its "
          f"final coordinates (kT): " + ", ".join(f"{a} {d:.2e}" for a, d in drifts) + f" (tol {TOL_WEIGHT_DRIFT_KT:g}) ({smi})")
    check(len(drifts) == firings and max(d for _, d in drifts) <= TOL_WEIGHT_DRIFT_KT,
          "[20] a firing's carried weights drifted from a float64 rebuild")
    print(f"[20 water] WaterSamplingDiagnostics {counts.shape}: proposals by state each iteration "
          f"{sorted(set(counts[..., 1].ravel().tolist()))}, accepted by window " + " ".join(str(int(c)) for c in cum[:, 0])
          + " of " + " ".join(str(int(c)) for c in cum[:, 1]) + "; acceptance by window "
          + " ".join(f"{a:.4f}" for a in acc_rate) + f"; waters whose centroid lies within {N20_RADIUS:.2f} nm of the "
          "probe's, mean over frames by window " + " ".join(f"{v:.2f}" for v in inside)
          + "; the example's occupancy (atoms within the radius // 3) " + " ".join(f"{v:.2f}" for v in occupancy) + f" ({smi})")
    check(counts.shape == (N20_FRAMES, K, 2), "[20] the water diagnostics' shape is not (frames, states, 2)")
    check(bool((counts[..., 1] == N20_PROPOSALS).all()) and bool((counts[..., 0] <= counts[..., 1]).all()),
          "[20] the water diagnostics' counts are not one firing an iteration")
    dG20 = float(np.sum(res20.dGs))
    print(f"[20 bar] pair dG " + " ".join(f"{r.dG:.3f}" for r in res20.bar_results) + "; overlaps "
          + " ".join(f"{r.overlap:.3f}" for r in res20.bar_results) + f"; ΔG (decoupled -> coupled) {dG20:.4f} +- "
          f"{float(np.linalg.norm(res20.dG_errs)):.4f} kJ/mol over {len(res20.bar_results)} pairs (finite {finite20}; for "
          f"information: this depth does not converge it); swap acceptance "
          + " ".join(f"{a:.3f}" for a in diag20.cumulative_swap_acceptance_rates[-1]) + f" ({smi})")
    check(len(res20.bar_results) == K - 1 and finite20, "[20] the water-sampling HREX did not give 5 finite BAR pairs")
    batched_row["launches_water_hrex"] = forms_h["batched F w"] / (K * steps)

    # -- [20 single] one window by get_context + sample_with_context --------------------------------------
    md_s = fe20.MDParams(n_frames=N20_SINGLE_FRAMES, n_eq_steps=0, steps_per_frame=N20_INTERVAL, seed=N20_SEED,
                         water_sampling_params=wsp)
    ctx = fe20.get_context(states[-1], md_s)
    k_s = next(i for i, m in enumerate(ctx.movers) if isinstance(m, TIBDExchangeMove))
    move_s = ctx._move_fns[k_s]
    last = {}

    def spy(state, x, v, box):
        out = move_s(state, x, v, box)
        last.update(stale=ctx._prov_states, accepted=int(out[0].n_accepted) - int(state.n_accepted))
        return out

    ctx._move_fns[k_s] = spy
    zero_counts()
    t0 = time.perf_counter()
    traj = fe20.sample_with_context(ctx, md_s, temperature, states[-1].ligand_idxs, max_buffer_frames=100)
    sync()
    t_single = time.perf_counter() - t0
    counts_s, plain_s = read_counts()
    prov = ctx._providers[host_i]
    with torch.no_grad():
        f_ctx = prov[1](ctx._prov_states[host_i], ctx._x, ctx._box, 1)[0]
        f_fresh = prov[1](prov[0](ctx._x, ctx._box), ctx._x, ctx._box, 1)[0]
        f_old = prov[1](last["stale"][host_i], ctx._x, ctx._box, 1)[0]
        ap_s = float(torch.linalg.vector_norm(NonbondedAllPairs.energy_force(ctx.potentials[host_i], ctx._x, ctx._box)[1]))
    fresh_equal = bool(torch.equal(f_ctx, f_fresh))
    stale_s = float(torch.linalg.vector_norm(f_old - f_fresh)) / ap_s
    st_s = ctx.get_mover_states()[k_s]
    print(f"[20 single] window {K - 1} (λ {states[-1].lamb:.1f}) through get_context + sample_with_context, "
          f"{N20_SINGLE_FRAMES} frames of {N20_INTERVAL} steps: {t_single:.2f} s host clock, frames finite "
          f"{bool(np.isfinite(traj.frames).all())}; launches {counts_s}, plain calls {plain_s}; the sampler {int(st_s.n_accepted)} "
          f"of {int(st_s.n_proposed)} accepted, {last['accepted']} in its last firing; the host term's force through the "
          f"Context's lists after it bitwise a fresh build's {fresh_equal}; through the lists from before it "
          f"{stale_s:.2e} of the all-pairs norm ({smi})")
    check(fresh_equal and bool(np.isfinite(traj.frames).all()), "[20] the single Context did not rebuild its lists")
    check(int(st_s.n_proposed) == N20_SINGLE_FRAMES * N20_PROPOSALS and plain_s == 0 and counts_s["rowscan_sweep"] > 0,
          "[20] the single Context's sampler or host term did not run as asked")

    # -- [20 local] the time-multiplexed HREX with local MD and the sampler ---------------------------------
    wsp_tm = fe20.WaterSamplingParams(interval=N20_TM_INTERVAL, n_proposals=N20_TM_PROPOSALS, batch_size=N20_TM_PROPOSALS,
                                      radius=N20_RADIUS)
    md_tm = fe20.MDParams(n_frames=N20_TM_FRAMES, n_eq_steps=0, steps_per_frame=N20_STEPS_PER_FRAME, seed=N20_SEED,
                          hrex_params=fe20.HREXParams(), local_md_params=fe20.LocalMDParams(local_steps=N20_TM_LOCAL),
                          water_sampling_params=wsp_tm)
    set_calls = []
    set_params = context20.Context.set_water_sampler_params

    def recording_set(self, params):
        set_calls.append(np.asarray(params))
        set_params(self, params)

    context20.Context.set_water_sampler_params = recording_set
    try:
        zero_counts()
        t0 = time.perf_counter()
        res_tm, trajs_tm, _, water_tm = fe20.run_sims_hrex(states[-2:], md_tm, print_diagnostics_interval=None)
        sync()
        t_tm = time.perf_counter() - t0
        counts_tm, plain_tm = read_counts()
    finally:
        context20.Context.set_water_sampler_params = set_params
    per_segment = N20_TM_PROPOSALS * sum((u + 1) % N20_TM_INTERVAL == 0 for u in range(N20_STEPS_PER_FRAME - N20_TM_LOCAL))
    tm_counts = np.asarray(water_tm.proposals_by_state_by_iter)
    expected_sets = [water_params[s] for _ in range(N20_TM_FRAMES) for s in (K - 2, K - 1)]
    sets_ok = len(set_calls) == len(expected_sets) and all(np.array_equal(a, b) for a, b in zip(set_calls, expected_sets))
    print(f"[20 local] run_sims_hrex over windows {K - 2}-{K - 1} with LocalMDParams({N20_TM_LOCAL}) (time-multiplexed), "
          f"{N20_TM_FRAMES} frames of {N20_STEPS_PER_FRAME}, the sampler every {N20_TM_INTERVAL} steps with "
          f"{N20_TM_PROPOSALS} proposals: {t_tm:.2f} s host clock; proposals by iteration and state {tm_counts[..., 1].tolist()} "
          f"(expected {per_segment} a segment), accepted {tm_counts[..., 0].tolist()}; set_water_sampler_params called with "
          f"each segment's state's parameters {sets_ok} ({len(set_calls)} calls); launches {counts_tm}, plain calls "
          f"{plain_tm}; ΔG {float(np.sum(res_tm.dGs)):.4f} kJ/mol ({smi})")
    check(tm_counts.shape == (N20_TM_FRAMES, 2, 2) and bool((tm_counts[..., 1] == per_segment).all()) and sets_ok,
          "[20] the time-multiplexed HREX did not give each state its sampler parameters and counts")
    check(plain_tm == 0 and bool(np.isfinite(res_tm.dGs).all()), "[20] the time-multiplexed HREX ran a plain sweep or failed")
    print(f"[20 time] phase 20 took {time.perf_counter() - t_phase20:.1f} s, host clock ({smi})")
    return {"dG": dG20, "states": states, "make_runner": make_runner}


def mol_energies_near(x, params, box, mols, beta: float, cutoff: float):
    """Float64 reference of NonbondedMolEnergy on the host CPU: each
    molecule's pair energies (nonbonded_block_unsummed, NaN counted +inf)
    with the atoms of other molecules within cutoff + N21_NEAR_MARGIN of its
    first atom, the only ones within the cutoff of any of its atoms when no
    atom of it lies N21_NEAR_MARGIN from its first. numpy (molecules,)."""
    import numpy as np
    import torch

    from timemachine_torch.ops.nonbonded import nonbonded_block_unsummed

    f64 = torch.float64
    x, params, box = (torch.as_tensor(np.asarray(a), dtype=f64) for a in (x, params, box))
    diag = torch.diagonal(box)
    reach2 = (cutoff + N21_NEAR_MARGIN) ** 2
    out = []
    for m in mols:
        m = torch.as_tensor(m)
        d = x - x[m[0]]
        d = d - diag * torch.round(d / diag)
        near = (d * d).sum(1) < reach2
        near[m] = False
        cols = torch.nonzero(near)[:, 0]
        u = nonbonded_block_unsummed(x[m], x[cols], box, params[m], params[cols], beta, cutoff)
        out.append(float(torch.where(torch.isnan(u), torch.inf, u).sum()))
    return np.array(out)


def phase21(dev, smi, zero_counts, read_counts, exact_row, inputs16, host16, dhfr):
    """The standalone samplers, the training path and the last utilities:
    [21 barker] equilibrate_host_barker over phase 16's raw solvent-leg
    host (`host16`, with `inputs16`'s ethanol, propane and force field) at
    JAX's defaults, its launches (the host du/dx's nb_tiles exact form once
    a step and once for the final check, nothing else), the host's largest
    |F|, its first steps rerun through it bitwise and replayed on the CPU
    in float64 from the card's own states and draws; [21 simulate] integrator.simulate of
    ethanol's walkers in vacuum; [21 train] the training demo on ethanol, a
    round's card gradient against a float64 central difference on the CPU;
    [21 lib] HilbertSort, Neighborlist, NonbondedMolEnergy over the waters
    and SegmentedSumExp on DHFR (`dhfr`, its HostConfig); [21 restraints]
    CentroidRestraint and FanoutSummedPotential on DHFR, card against the
    CPU's float64. Adds the Barker's launches and the bound of its launch
    to nb_tiles' exact row (`exact_row`)."""
    import numpy as np
    import torch

    from timemachine_torch import lib as lib21
    from timemachine_torch import potentials as pot21
    from timemachine_torch.constants import BOLTZ, DEFAULT_NB_CUTOFF, DEFAULT_TEMP, MAX_FORCE_NORM
    from timemachine_torch.integrator import simulate
    from timemachine_torch.md import barker as barker21
    from timemachine_torch.md import minimizer as minimizer21
    from timemachine_torch.optimize import training_demo as demo21

    t_phase21 = time.perf_counter()
    stages, stage_start = {}, [t_phase21]

    def stage_done(name):
        """Host seconds since the previous stage ended, under `name`."""
        now = time.perf_counter()
        stages[name] = now - stage_start[0]
        stage_start[0] = now
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    mols, _, ff = inputs16
    kT = BOLTZ * DEFAULT_TEMP
    sigma = 1e-4  # JAX's default proposal stddev (nm)

    # -- [21 barker] -------------------------------------------------------------------------------
    x0 = np.asarray(host16.conf)
    n_host = x0.shape[0]
    draw, step = barker21.barker_draws, barker21.barker_step

    def recorded(run, n_steps):
        """run()'s result, and the draws (z, u), gradients g and states after
        each of the first n_steps steps of the Barker chain it runs, as the
        entry point's own calls of barker_draws and barker_step made them."""
        kept = {"z": [], "u": [], "g": [], "x": []}

        def draws_kept(generator, x, sigma):
            z, u = draw(generator, x, sigma)
            if len(kept["z"]) < n_steps:
                kept["z"].append(z)
                kept["u"].append(u)
            return z, u

        def step_kept(x, g, z, u):
            out = step(x, g, z, u)
            if len(kept["x"]) < n_steps:
                kept["g"].append(g)
                kept["x"].append(out)
            return out

        barker21.barker_draws, barker21.barker_step = draws_kept, step_kept
        try:
            return run(), kept
        finally:
            barker21.barker_draws, barker21.barker_step = draw, step

    steps = 1000  # JAX's default
    zero_counts()
    before = form_launches()
    sync()
    t0 = time.perf_counter()
    x_b, kept = recorded(lambda: minimizer21.equilibrate_host_barker(mols, host16, ff, seed=N21_SEED, device=dev),
                         max(N21_RERUN, N21_REPLAY))
    sync()
    t_b = time.perf_counter() - t0
    counts, plain = read_counts()
    forms = {f: n for f, n in (form_launches() - before).items() if n}
    du_dx = minimizer21.make_host_du_dx_fxn(mols, host16, ff, device=dev)
    f_max = float(torch.linalg.vector_norm(du_dx(torch.as_tensor(x_b, device=dev)), dim=1).max())
    rms = float(np.sqrt(np.mean((x_b.astype(np.float64) - x0) ** 2)))
    print(f"[21 barker] equilibrate_host_barker over phase 16's raw host ({n_host} atoms, box "
          f"{np.diag(host16.box)[0]:.2f} nm) with ethanol and propane frozen, sigma {sigma} nm, {steps} steps, 300 K, seed "
          f"{N21_SEED}: {t_b:.2f} s ({1e3 * t_b / steps:.2f} ms a step), host clock; launches by form {forms}, totals "
          f"{counts}, plain calls {plain}; the host's largest |F| {f_max:.1f} kJ/mol/nm against MAX_FORCE_NORM "
          f"{MAX_FORCE_NORM:g}; RMS displacement per coordinate {rms:.3e} nm ({smi})")
    check(forms == {EXACT_UF: steps + 1} and plain == 0 and counts["nb_tiles"] == steps + 1
          and sum(counts.values()) == steps + 1,
          "[21] the Barker chain did not launch nb_tiles' exact form once a step and once for its check alone")
    check(bool(np.isfinite(x_b).all()) and f_max <= MAX_FORCE_NORM, "[21] the Barker chain's host is not finite or over MAX_FORCE_NORM")
    check(len(kept["x"]) == max(N21_RERUN, N21_REPLAY), "[21] the Barker chain's steps were not recorded")
    stage_done("chain")

    # the entry point again from the same seed for its first N21_RERUN steps: its draws and states, held bitwise
    # against the first run's; the raw box after so few steps may fail the final force check, which is reported
    def rerun():
        try:
            minimizer21.equilibrate_host_barker(mols, host16, ff, n_steps=N21_RERUN, seed=N21_SEED, device=dev)
            return "passed"
        except minimizer21.MinimizationError:
            return "raised MinimizationError"

    sync()
    t0 = time.perf_counter()
    rerun_check, kept_again = recorded(rerun, N21_RERUN)
    sync()
    t_rerun = time.perf_counter() - t0
    same = len(kept_again["x"]) == N21_RERUN and all(
        torch.equal(a, b) for key in kept_again for a, b in zip(kept[key][:N21_RERUN], kept_again[key]))
    stage_done("rerun")

    # the first N21_REPLAY steps replayed on the host CPU in float64, each from the card's state before it with
    # the card's own draws; the card's gradient held against the CPU's at the same state
    t0 = time.perf_counter()
    du_cpu = minimizer21.make_host_du_dx_fxn(mols, host16, ff, device=cpu)
    starts = [torch.as_tensor(x0, dtype=kept["x"][0].dtype), *kept["x"][: N21_REPLAY - 1]]
    err, force_rel, force_max, n_near = 0.0, 0.0, 0.0, 0
    for i in range(N21_REPLAY):
        xi = starts[i].to(cpu, f64)
        du_ref = du_cpu(xi)
        du_card = -kT * kept["g"][i].to(cpu, f64)
        force_rel = max(force_rel, float(torch.linalg.vector_norm(du_card - du_ref) / torch.linalg.vector_norm(du_ref)))
        force_max = max(force_max, float(torch.abs(du_card - du_ref).max()))
        g = -du_ref / kT
        z, u = kept["z"][i].to(cpu, f64), kept["u"][i].to(cpu, f64)
        near = torch.abs(torch.log(u) - torch.nn.functional.logsigmoid(g * z)) < BARKER_FLIP_MARGIN
        n_near += int(near.sum())
        xr = barker21.barker_step(xi, g, z, u)
        err = max(err, float(torch.where(near, 0.0, torch.abs(kept["x"][i].to(cpu, f64) - xr)).max()))
    t_replay = time.perf_counter() - t0
    stage_done("replay")
    print(f"[21 barker] the entry point again from seed {N21_SEED} for {N21_RERUN} steps ({t_rerun:.2f} s; its final "
          f"force check {rerun_check}): draws, gradients and states bitwise the first run's {same}; the first run's "
          f"first {N21_REPLAY} steps replayed on the host CPU in float64, each from the card's state with the card's "
          f"draws ({t_replay:.1f} s): largest |diff| {err:.3e} nm (tol {TOL_BARKER_REPLAY:g}) over the coordinates "
          f"whose flip decision cleared its threshold by {BARKER_FLIP_MARGIN:g}, {n_near} of "
          f"{N21_REPLAY * x0.size} excepted; the card's du/dx against the CPU's at the same states: |diff| / |du/dx| "
          f"{force_rel:.3e} (tol {TOL_FORCE_REL_NORM:g}), largest |diff| {force_max:.3e} kJ/mol/nm ({smi})")
    check(same, "[21] the Barker chain is not bitwise on rerun")
    check(err <= TOL_BARKER_REPLAY, "[21] the Barker chain's first steps differ from their float64 replay")
    check(force_rel <= TOL_FORCE_REL_NORM, "[21] the Barker chain's du/dx on the card is off the CPU's float64")
    # the launch's bound: the host pairs within the cutoff at the chain's start (the ligands are masked out
    # of the host term), at the exact F+U form's operations a pair; its bytes: each atom's row and
    # parameters read once, its force written once. Its time a launch is phase 17's of the same form over the
    # solvent leg's host under the host mask (exact_row["ms"])
    pairs = pairs_within_cutoff(torch.as_tensor(x0, device=dev), torch.as_tensor(host16.box, device=dev),
                                torch.zeros(n_host, device=dev, dtype=f64), DEFAULT_NB_CUTOFF)
    bound_ms, bound_by = bound(pair_ops("nb_tiles_exact_UF", pairs), (32 + 12) * n_host)
    print(f"[21 bound] nb_tiles' exact F+U under the Barker chain: its bound {bound_ms:.4f} ms a launch by {bound_by} "
          f"over the {pairs} host pairs within the cutoff at the chain's start, against phase 17's {exact_row['ms']:.4f} "
          f"ms a launch of the same form; {counts['nb_tiles']} launches a run ({smi})")
    exact_row["launches_barker"] = counts["nb_tiles"]
    exact_row["bound_ms_barker"] = bound_ms
    stage_done("bound")

    # -- [21 simulate] -----------------------------------------------------------------------------
    ethanol = mols[0]
    energies = demo21.DemoEnergies(ethanol, ff, device=dev)

    def sim():
        sync()
        t0 = time.perf_counter()
        out = simulate(energies.x0, lambda y: energies.u_total(y, 1.0), DEFAULT_TEMP, energies.masses, N21_SIM_STEPS,
                       N21_SIM_BATCHES, N21_SIM_WALKERS, seed=N21_SIM_SEED, device=dev)
        sync()
        return out, time.perf_counter() - t0

    zero_counts()
    (xs, vs), t_sim = sim()
    counts, plain = read_counts()
    (xs2, vs2), _ = sim()
    shape = (N21_SIM_WALKERS, N21_SIM_BATCHES, ethanol.num_atoms, 3)
    ok_sim = xs.shape == vs.shape == shape and bool(np.isfinite(xs).all() and np.isfinite(vs).all())
    same = np.array_equal(xs, xs2) and np.array_equal(vs, vs2)
    n_steps = N21_SIM_BATCHES * N21_SIM_STEPS
    print(f"[21 simulate] integrator.simulate of {N21_SIM_WALKERS} ethanol walkers in vacuum, {N21_SIM_BATCHES} batches of "
          f"{N21_SIM_STEPS} steps: shape {xs.shape}, every frame finite {ok_sim}, rerun bitwise {same}; {t_sim:.2f} s, "
          f"{1e3 * t_sim / n_steps:.3f} ms a batched step, host clock; sweeps launched {sum(counts.values())} ({smi})")
    check(ok_sim and same, "[21] simulate's walkers are misshapen, not finite or not bitwise on rerun")
    stage_done("simulate")

    # -- [21 train] --------------------------------------------------------------------------------
    cfg = demo21.DemoConfig(n_walkers=N21_TRAIN_WALKERS, n_batches=N21_TRAIN_BATCHES, steps_per_batch=N21_TRAIN_STEPS,
                            n_rounds=N21_TRAIN_ROUNDS, steps_per_round=N21_TRAIN_ADAM)
    sync()
    t0 = time.perf_counter()
    rec = demo21.run_demo(ethanol, ff, cfg, device=dev, log=lambda line: print(f"[21 train] {line}"))
    sync()
    t_train = time.perf_counter() - t0
    rounds = rec["rounds"]
    numbers = [rec["label_df_kbt"], rec["label_err_kbt"], rec["scale_final"]]
    numbers += [r[k] for r in rounds for k in ("loss_start", "loss_end", "scale", "pred_df_kbt", "ref_df_kbt", "dest_ds_start")]
    last = rec["samples"][-1]
    cpu_energies = demo21.DemoEnergies(ethanol, ff, device=cpu)
    est_cpu = demo21.endpoint_estimator(cpu_energies, last["xs_a"], last["xs_b"], last["scale"], last["ref_df"])
    with torch.no_grad():
        fd = float((est_cpu(last["scale"] + N21_FD_H) - est_cpu(last["scale"] - N21_FD_H)) / (2 * N21_FD_H))
    grad_card = rounds[-1]["dest_ds_start"]
    rel_fd = abs(grad_card - fd) / abs(fd)
    print(f"[21 train] the training demo on ethanol ({t_train:.1f} s host clock; {len(last['xs_a'])} frames a state a round; "
          f"depth cut from 8 walkers x 60 batches of 25 steps, 3 rounds of 60 Adam steps to {cfg.n_walkers} x "
          f"{cfg.n_batches} of {cfg.steps_per_batch}, {cfg.n_rounds} rounds of {cfg.steps_per_round}): label df* "
          f"{rec['label_df_kbt']:.4f} +- {rec['label_err_kbt']:.4f} kT; "
          + "; ".join(f"round {r['round']}: loss {r['loss_start']:.5f} -> {r['loss_end']:.5f}, scale {r['scale_start']:.4f} "
                      f"-> {r['scale']:.4f}, predicted df {r['pred_df_kbt']:.4f}, reference df {r['ref_df_kbt']:.4f}"
                      for r in rounds)
          + f"; d df_est/ds at round {rounds[-1]['round']}'s start: card autograd {grad_card:.6f}, CPU float64 central "
            f"difference {fd:.6f}, relative {rel_fd:.2e} (tol {TOL_TRAIN_FD:g}) ({smi})")
    check(bool(np.isfinite(numbers).all()), "[21] a number of the training demo is not finite")
    check(all(r["loss_end"] <= r["loss_start"] for r in rounds), "[21] a training round's loss rose")
    check(abs(rec["scale_final"] - 1.0) < abs(cfg.scale_init - 1.0), "[21] the trained scale is no closer to 1 than its start")
    check(rel_fd <= TOL_TRAIN_FD, "[21] the card's estimator gradient differs from the float64 central difference")
    stage_done("train")

    # -- [21 lib] ----------------------------------------------------------------------------------
    xd = np.asarray(dhfr.conf)
    boxd = np.asarray(dhfr.box)
    n = xd.shape[0]
    nb = dhfr.host_system.nonbonded_all_pairs
    params64 = nb.params.to(cpu, f64).numpy()
    sec = {}

    def timed(name, thunk):
        sync()
        t0 = time.perf_counter()
        out = thunk()
        sync()
        sec[name] = time.perf_counter() - t0
        return out

    perm = timed("HilbertSort", lambda: lib21.HilbertSort(n, device=dev).sort(xd, boxd))
    is_perm = perm.shape == (n,) and np.array_equal(np.sort(perm.astype(np.int64)), np.arange(n))
    nbl = lib21.Neighborlist(n, device=dev)
    lists = timed("Neighborlist", lambda: nbl.get_nblist(xd, boxd, N21_NBLIST_CUTOFF))
    # every pair within the cutoff listed: each pair (i < j) within it, keyed (i's row block, j), found among the
    # listed keys
    xt = torch.as_tensor(xd, device=dev, dtype=f64)
    diag = torch.diagonal(torch.as_tensor(boxd, device=dev, dtype=f64))
    lens = np.array([len(ids) for ids in lists])
    flat = np.fromiter(itertools.chain.from_iterable(lists), dtype=np.int64, count=int(lens.sum()))
    listed = torch.as_tensor(np.repeat(np.arange(len(lists)), lens) * n + flat, device=dev).sort().values
    within, missed = 0, 0
    cols = torch.arange(n, device=dev)
    for i0 in range(0, n, 512):
        rows = cols[i0 : i0 + 512]
        d = xt[rows, None, :] - xt[None, :, :]
        d = d - diag * torch.round(d / diag)
        i, j = torch.nonzero(((d * d).sum(-1) < N21_NBLIST_CUTOFF**2) & (rows[:, None] < cols[None, :]), as_tuple=True)
        keys = (rows[i] // nbl.BLOCK) * n + j
        found = listed[torch.clamp(torch.searchsorted(listed, keys), max=len(listed) - 1)] == keys
        within += len(keys)
        missed += int((~found).sum())
    ref_pairs = pairs_within_cutoff(xt, torch.as_tensor(boxd, device=dev, dtype=f64),
                                    torch.zeros(n, device=dev, dtype=f64), N21_NBLIST_CUTOFF)
    waters = [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(dhfr.num_water_atoms // 3)]
    mol_e = timed("NonbondedMolEnergy card", lambda: lib21.NonbondedMolEnergy(n, waters, nb.beta, nb.cutoff, device=dev)
                  .execute(xd, params64, boxd))
    held = np.linspace(0, len(waters) - 1, N21_MOL_HELD).astype(int)
    mol_e_cpu = timed("the CPU reference", lambda: mol_energies_near(xd, params64, boxd, [waters[i] for i in held],
                                                                       nb.beta, nb.cutoff))
    rel_mol = float(np.max(np.abs(mol_e[held] - mol_e_cpu) / np.abs(mol_e_cpu)))
    segs = [np.random.default_rng(21).normal(0, 30, k) for k in (1, 7, 1000, 100_000)]
    lse = timed("SegmentedSumExp", lambda: lib21.SegmentedSumExp(100_000, 4, device=dev).logsumexp(segs))
    rel_lse = max(abs(a - float(torch.logsumexp(torch.as_tensor(s, device=dev), 0))) / abs(a) for a, s in zip(lse, segs))
    print(f"[21 lib] DHFR ({n} atoms): HilbertSort a permutation {is_perm}; Neighborlist at {N21_NBLIST_CUTOFF} nm: "
          f"{len(lists)} row blocks, {nbl.get_tile_ixn_count()} candidates, pairs within the cutoff {within} "
          f"(pairs_within_cutoff {ref_pairs}), missed {missed}; NonbondedMolEnergy over {len(waters)} waters on the "
          f"card, {N21_MOL_HELD} of them evenly spaced against the CPU in float64 (each against the atoms within "
          f"{N21_NEAR_MARGIN} nm more than the cutoff of its oxygen, mol_energies_near): largest relative difference {rel_mol:.2e} (tol {TOL_MOL_ENERGY:g}), energies "
          f"{mol_e.min():.2f} to {mol_e.max():.2f} kJ/mol; SegmentedSumExp against torch.logsumexp: {rel_lse:.2e} (tol "
          f"{TOL_LSE:g}); seconds " + ", ".join(f"{k} {v:.2f}" for k, v in sec.items()) + f", host clock ({smi})")
    check(is_perm, "[21] HilbertSort is not a permutation")
    check(missed == 0 and within == ref_pairs, "[21] the neighbour list misses a pair within the cutoff")
    check(bool(np.isfinite(mol_e).all()) and rel_mol <= TOL_MOL_ENERGY, "[21] NonbondedMolEnergy differs from the CPU's")
    check(rel_lse <= TOL_LSE, "[21] SegmentedSumExp differs from torch.logsumexp")
    stage_done("lib")

    # -- [21 restraints] ---------------------------------------------------------------------------
    n_w = dhfr.num_water_atoms
    group_a, group_b = np.arange(n_w, n_w + 20), np.arange(n_w + 1000, n_w + 1020)
    bonds = dhfr.host_system.bond.idxs.cpu().numpy()
    protein = (bonds >= n_w).all(1)
    bonds, bond_params = bonds[protein], dhfr.host_system.bond.params.to(cpu, f64).numpy()[protein]
    half = len(bonds) // 2

    def restraints(device, dtype):
        centroid = pot21.CentroidRestraint(group_a, group_b, 500.0, 0.2, np.zeros(0), n, device=device, dtype=dtype)
        members = [
            pot21.HarmonicBond(bonds[:half], bond_params[:half], n, device=device, dtype=dtype),
            pot21.HarmonicBond(bonds[half : 2 * half], bond_params[:half], n, device=device, dtype=dtype),
            pot21.CentroidRestraint(group_a, group_b, 500.0, 0.0, np.zeros(0), n, device=device, dtype=dtype),
        ]
        fanout = pot21.FanoutSummedPotential(members, bond_params[:half], device=device, dtype=dtype)
        x = torch.as_tensor(xd, device=device, dtype=dtype)
        box = torch.as_tensor(boxd, device=device, dtype=dtype)
        return [tuple(t.to(cpu, f64) for t in m.energy_force(x, box)) for m in (centroid, fanout)]

    lines = []
    ok_r = True
    for name, (u_c, f_c), (u_r, f_r) in zip(("CentroidRestraint", "FanoutSummedPotential"), restraints(dev, f32),
                                            restraints(cpu, f64)):
        rel_u = abs(float(u_c - u_r)) / abs(float(u_r))
        rel_f = float(torch.linalg.vector_norm(f_c - f_r) / torch.linalg.vector_norm(f_r))
        ok_r &= rel_u <= TOL_RESTRAINT_U and rel_f <= TOL_RESTRAINT_F
        lines.append(f"{name} U {float(u_r):.6g} kJ/mol, energy {rel_u:.2e} relative, force {rel_f:.2e} of its norm")
    print(f"[21 restraints] on DHFR, card float32 against the CPU in float64 (tol {TOL_RESTRAINT_U:g} and "
          f"{TOL_RESTRAINT_F:g}; the groups: the protein's first 20 atoms and its atoms 1000-1019, residue-sized, the "
          f"file holding no residue table; the fan-out: two halves of the protein's bonds on one parameter array and a "
          f"b0 = 0 centroid restraint): " + "; ".join(lines) + f" ({smi})")
    check(ok_r, "[21] a restraint differs from the CPU's float64")
    stage_done("restraints")
    print(f"[21 time] phase 21 took {time.perf_counter() - t_phase21:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in stages.items()) + f"; host clock ({smi})")


def phase22(dev, smi, zero_counts, read_counts, masked_row, batched_row, exact_row, inputs16):
    """run_complex as a user calls it: the capped helix's PDB written to a
    file, ethanol and propane (phase 16's embedding, seed 7) posed beside the
    helix, the core by the native MCS, then the protein host built natively
    (parse, perception, Amber assignment, the water lattice), its FIRE and
    NPT, the anchors' minimization, bisection and HREX on `dev`, with every
    count zeroed just before run_complex and read just after. Adds its
    launches to the masked, batched and exact rows."""
    import tempfile

    import numpy as np
    import torch

    from timemachine_torch.chem import pdb as pdb22
    from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS, DEFAULT_TEMP, MAX_FORCE_NORM
    from timemachine_torch.fe import mcgregor_native
    from timemachine_torch.fe import rbfe as rbfe22
    from timemachine_torch.fe.atom_mapping import get_cores
    from timemachine_torch.fe.free_energy import HREXParams, MDParams
    from timemachine_torch.fe.single_topology import SingleTopology
    from timemachine_torch.ff import amber_xml as amber22
    from timemachine_torch.md import builders as builders22
    from timemachine_torch.md import minimizer as minimizer22
    from timemachine_torch.md.context import Context
    from timemachine_torch.potentials import NonbondedAllPairs
    from timemachine_torch.testsystems.peptide import capped_helix_pdb, helix_axis, pocket_offset

    t_phase22 = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    clock22 = StageClock(sync)
    sec22, forms22 = clock22.sec, clock22.forms
    host22, fire22, protein22, vgs22, contexts22 = {}, [], [], [], []

    def record_host(args, kwargs, out):
        host22.update(mols=args[0], config=args[1], x_host=out[0], box=out[1])

    def count_vg(fn):
        def wrapper(*args, **kwargs):
            vgs22.append(fn(*args, **kwargs))
            return vgs22[-1]

        return wrapper

    def catching_context(*args, **kwargs):
        contexts22.append(Context(*args, **kwargs))
        return contexts22[-1]

    stages = (
        (pdb22, "parse_pdb", "parse", None),
        (pdb22, "protein_mol_from_pdb", "perception", lambda a, k, out: protein22.append(out)),
        (amber22.AmberForceField, "parse", "assignment", None),
        (amber22, "assign_protein_parameters", "assignment", None),
        (builders22, "build_protein_system", "build", None),
        (minimizer22, "fire_minimize_host", "fire", lambda a, k, out: fire22.append((a, out))),
        (minimizer22, "pre_equilibrate_host", "npt", record_host),
        (rbfe22, "optimize_coordinates", "minimize anchors", None),
        (rbfe22, "optimize_coords_state", "minimize", None),
        (rbfe22, "run_sims_bisection", "bisection", None),
        (rbfe22, "run_sims_hrex", "hrex", None),
    )
    originals22 = [(minimizer22, "Context", minimizer22.Context), (minimizer22, "get_val_and_grad_fn", minimizer22.get_val_and_grad_fn),
                   (amber22.AmberForceField, "parse", amber22.AmberForceField.__dict__["parse"])]  # the classmethod itself
    pdb_path = None
    try:
        for module, attr, stage, record in stages:
            clock22.wrap(module, attr, stage, record)
        minimizer22.Context = catching_context
        minimizer22.get_val_and_grad_fn = count_vg(originals22[1][2])
        pdb_text = capped_helix_pdb(N22_ALA)
        fd, pdb_path = tempfile.mkstemp(suffix=".pdb")
        with os.fdopen(fd, "w") as fh:
            fh.write(pdb_text)
        mols16, _, ff22 = inputs16
        mols22 = [m.copy() for m in mols16]
        offset = pocket_offset(pdb_text, [m.get_conf() for m in mols22], N22_POSE_NM)
        for m in mols22:
            m.set_conf(m.get_conf() + offset)
        searches = mcgregor_native.searches
        t0 = time.perf_counter()
        core22 = get_cores(*mols22, **DEFAULT_ATOM_MAPPING_KWARGS)[0]
        t_core22 = time.perf_counter() - t0
        native22 = mcgregor_native.searches - searches
        md22 = MDParams(
            n_frames=N22_FRAMES, n_eq_steps=N22_EQ, steps_per_frame=N22_STEPS_PER_FRAME, seed=2023,
            hrex_params=HREXParams(n_frames_bisection=N22_FRAMES_BISECTION),
        )
        zero_counts()
        forms_before22 = form_launches()
        t0 = time.perf_counter()
        res22, cfg22 = rbfe22.run_complex(mols22[0], mols22[1], core22, ff22, pdb_path, md_params=md22,
                                          n_windows=N22_WINDOWS, min_cutoff=None, device=dev)
        sync()
        t_run22 = time.perf_counter() - t0
        launches22, plain22_calls = read_counts()
        for form, n in (form_launches() - forms_before22).items():
            forms22["setup", form] += n
    finally:
        clock22.restore()
        for module, attr, fn in originals22:
            setattr(module, attr, fn)
        if pdb_path is not None:
            os.unlink(pdb_path)

    n_protein = cfg22.conf.shape[0] - cfg22.num_water_atoms
    n_lig = sum(m.num_atoms for m in mols22)
    n_total = cfg22.conf.shape[0] + n_lig
    charge22 = protein22[0].total_charge()
    print(f"[22 system] capped helix ACE-(ALA){N22_ALA}-NME: {n_protein} protein atoms (perceived net charge "
          f"{charge22:+d} e), {cfg22.num_water_atoms} water atoms, {n_lig} ligand atoms, {n_total} atoms in all; cubic box "
          f"{cfg22.box[0, 0]:.4f} nm with the headroom; ligand pair centroid {N22_POSE_NM} nm from the helix axis "
          f"({smi})")
    check(charge22 == 0, "[22] the helix's perceived net charge is not 0")
    check(n_total >= N22_MIN_ATOMS, f"[22] the complex holds fewer than {N22_MIN_ATOMS} atoms")
    ca = np.array([r.coords[r.atom_names.index("CA")] for r in pdb22.parse_pdb(pdb_text).residues if r.name == "ALA"]) / 10
    check(abs(helix_axis(ca)[2]) > 0.999, "[22] the helix axis is not along z")
    print(f"[22 core] get_cores {t_core22:.3f} s, {len(core22)} core atoms, native searches {native22} ({smi})")
    check(native22 > 0, "[22] the native MCS did not run")

    n_host22 = host22["config"].conf.shape[0]
    lig22 = np.concatenate([m.get_conf() for m in host22["mols"]])
    ctx22 = contexts22[0]
    (_, x_fire22), = fire22
    with torch.no_grad():
        f_fire = minimizer22.total_force(ctx22.potentials, torch.as_tensor(np.concatenate([x_fire22, lig22]), device=dev,
                                         dtype=ctx22._x.dtype), torch.as_tensor(cfg22.box, device=dev, dtype=ctx22._x.dtype))
        f_end = minimizer22.total_force(ctx22.potentials, ctx22._x, ctx22._box)
    fmax_fire = float(torch.linalg.vector_norm(f_fire[:n_host22], dim=-1).max())
    fmax_end = float(torch.linalg.vector_norm(f_end[:n_host22], dim=-1).max())
    frozen22 = bool(np.array_equal(ctx22.get_x_t()[n_host22:], lig22.astype(ctx22.get_x_t().dtype)))
    print(f"[22 host] {n_host22} host atoms: the host's largest |F| {fmax_fire:.1f} kJ/mol/nm after FIRE, {fmax_end:.1f} "
          f"after NPT (limit MAX_FORCE_NORM {MAX_FORCE_NORM:g}); ligand bitwise unmoved {frozen22}; box volume "
          f"{float(np.prod(np.diagonal(host22['box']))):.4f} nm^3 from {float(np.prod(np.diagonal(cfg22.box))):.4f} ({smi})")
    check(fmax_fire < MAX_FORCE_NORM and fmax_end < MAX_FORCE_NORM, "[22] the host's forces exceed MAX_FORCE_NORM")
    check(frozen22, "[22] the ligands moved during the host's pre-equilibration")

    # window 0 as run_complex simulated it (minimized anchors, the host after NPT), its force on the card against
    # the same window's potentials built on the host CPU in float64 at the same coordinates, both host terms on the
    # rowscan function
    state0 = res22.final_result.initial_states[0]
    st22 = SingleTopology(mols22[0], mols22[1], core22, ff22)
    cfg_h = host22["config"]
    host_cpu = rbfe22.Host(cfg_h.host_system, cfg_h.masses, host22["x_host"], host22["box"], cfg_h.num_water_atoms,
                           cfg_h.host_topology)
    cpu = torch.device("cpu")
    state_cpu = rbfe22.setup_initial_state(st22, state0.lamb, host_cpu, DEFAULT_TEMP, md22.seed, cpu, torch.float64)
    card_pots = state0.potentials
    check(len(card_pots) == len(state_cpu.potentials), "[22] window 0's terms differ between the card and the CPU")
    ap_i = next(i for i, p in enumerate(state_cpu.potentials) if isinstance(p, NonbondedAllPairs))
    dt22 = card_pots[0].params.dtype
    xc, bc = (torch.as_tensor(a, device=dev, dtype=dt22) for a in (state0.x0, state0.box0))
    x64, b64 = (torch.as_tensor(a, dtype=torch.float64) for a in (state0.x0, state0.box0))
    card_pots[ap_i].configure(bc, xc, kernel="rowscan")
    state_cpu.potentials[ap_i].configure(b64, x64, kernel="rowscan")
    t0 = time.perf_counter()
    with torch.no_grad():
        f_card = [p.energy_force(xc, bc)[1].double().cpu() for p in card_pots]
        f_cpu = [p.energy_force(x64, b64)[1] for p in state_cpu.potentials]
        ap_norm = float(torch.linalg.vector_norm(NonbondedAllPairs.energy_force(card_pots[ap_i], xc, bc)[1]))
    per_term = " ".join(
        f"{type(p).__name__} {float(torch.linalg.vector_norm(a - b)) / max(float(torch.linalg.vector_norm(b)), 1e-30):.2e}"
        for p, a, b in zip(card_pots, f_card, f_cpu))
    rel22 = float(torch.linalg.vector_norm(sum(f_card) - sum(f_cpu))) / ap_norm
    print(f"[22 force] window 0 (λ {state0.lamb:.1f}) as run_complex simulated it, card ({dt22}) vs host CPU (float64), "
          f"both host terms rowscan, per term |diff| / |term force|: {per_term}; total |diff| {rel22:.3e} of the all-pairs "
          f"force norm {ap_norm:.1f} (limit {TOL_FORCE_REL_NORM:g}; the CPU's {time.perf_counter() - t0:.1f} s) ({smi})")
    check(rel22 <= TOL_FORCE_REL_NORM, "[22] window 0's card force is off the host CPU's")
    # the host term's own error against the CPU's float32 plain version of it: the sweep takes every pair and
    # subtracts the excluded ones, and an Amber 1-2 pair's LJ force (about 1e8 kJ/mol/nm at 0.1 nm) leaves
    # float32 rounding of that size on the protein's atoms
    state_cpu32 = rbfe22.setup_initial_state(st22, state0.lamb, host_cpu, DEFAULT_TEMP, md22.seed, cpu, torch.float32)
    x32, b32 = (torch.as_tensor(a, dtype=torch.float32) for a in (state0.x0, state0.box0))
    state_cpu32.potentials[ap_i].configure(b32, x32, kernel="rowscan")
    with torch.no_grad():
        f_ap32 = state_cpu32.potentials[ap_i].energy_force(x32, b32)[1].double()
    f_ap64 = f_cpu[ap_i]
    d_card, d_32 = (torch.linalg.vector_norm(f - f_ap64, dim=-1) for f in (f_card[ap_i], f_ap32))
    rel_card, rel_32 = (float(torch.linalg.vector_norm(f - f_ap64)) / float(torch.linalg.vector_norm(f_ap64))
                        for f in (f_card[ap_i], f_ap32))
    print(f"[22 force] the host term against the CPU's float64: card {rel_card:.3e} of its own norm (the largest |diff| "
          f"{float(d_card[:n_protein].max()):.3f} kJ/mol/nm on a protein atom, {float(d_card[n_protein:n_host22].max()):.4f} on "
          f"a water atom), the CPU's float32 plain version {rel_32:.3e} ({float(d_32[:n_protein].max()):.3f} and "
          f"{float(d_32[n_protein:n_host22].max()):.4f}); limit for the card 10x the CPU's float32 ({smi})")
    check(rel_card <= 10 * rel_32, "[22] the card's host term is off by more than float32 rounding explains")

    bfgs_calls = sum(vg.calls for vg in vgs22)
    minimize_s = sec22.get("minimize", 0.0)
    build_rest = sec22["build"] - sec22["parse"] - sec22["perception"] - sec22["assignment"]
    print(f"[22 time] run_complex {t_run22:.1f} s: the build {sec22['build']:.2f} s (parse {sec22['parse']:.3f}, perception "
          f"{sec22['perception']:.3f}, Amber assignment {sec22['assignment']:.3f}, lattice and assembly {build_rest:.3f}), "
          f"FIRE {sec22['fire']:.1f} s, NPT {sec22['npt'] - sec22['fire']:.1f} s, anchor minimization "
          f"{sec22['minimize anchors']:.1f} s, bisection {sec22['bisection']:.1f} s, HREX {sec22['hrex']:.1f} s; "
          f"{bfgs_calls} BFGS energy/force calls in {minimize_s:.1f} s ({1e3 * minimize_s / max(bfgs_calls, 1):.1f} ms a "
          f"call); host clock ({smi})")

    fin22 = res22.final_result
    finite22 = bool(np.isfinite(fin22.dGs).all() and np.isfinite(fin22.dG_errs).all())
    rates22 = res22.hrex_diagnostics.cumulative_swap_acceptance_rates[-1]
    print(f"[22 hrex] {len(fin22.initial_states)} replicas at λ " + " ".join(f"{s.lamb:.4f}" for s in fin22.initial_states)
          + f", {N22_FRAMES} iterations of {N22_STEPS_PER_FRAME} steps: ΔG per pair "
          + " ".join(f"{g:.4f} +- {e:.4f}" for g, e in zip(fin22.dGs, fin22.dG_errs))
          + f" kJ/mol, sum {float(np.sum(fin22.dGs)):.4f} +- {float(np.linalg.norm(fin22.dG_errs)):.4f} (not converged); "
          "swap acceptance " + " ".join(f"{r:.3f}" for r in rates22) + f"; finite {finite22} ({smi})")
    check(len(fin22.bar_results) == N22_WINDOWS - 1 and finite22, "[22] HREX did not give finite BAR pairs for every pair")

    print(f"[22 kernels] rowscan and nb_tiles launches in run_complex by stage and form: {clock22.by_stage()}; totals "
          f"{launches22}; plain sweeps {plain22_calls} ({smi})")
    check(plain22_calls == 0, "[22] run_complex ran a plain sweep")
    check(all(n == 0 for (stage, _), n in forms22.items() if stage in ("setup", "build", "parse", "perception", "assignment")),
          "[22] a kernel launch outside the sampling and minimization stages")
    launches_at = clock22.launches
    for stage in ("fire", "minimize"):
        exact = sum(n for (st, form), n in forms22.items() if st == stage and form.startswith("nb_tiles") and form.endswith("exact"))
        check(exact > 0 and launches_at(stage, "rowscan") == 0 and launches_at(stage, "nb_tiles") == exact,
              f"[22] the {stage} stage did not run on nb_tiles' exact form alone")
    for stage in ("npt", "bisection"):
        masked = sum(n for (st, form), n in forms22.items() if st == stage and form.endswith("triangular minimum image w"))
        check(masked > 0 and launches_at(stage, "rowscan") == masked and launches_at(stage, "nb_tiles") == 0,
              f"[22] the {stage} stage did not run on the masked rowscan form alone")
    batched = sum(n for (st, form), n in forms22.items() if st == "hrex" and form.startswith("batched"))
    check(batched > 0 and launches_at("hrex", "nb_tiles") == 0, "[22] HREX did not run on the batched rowscan form")
    # u_kln inside the hrex stage: every rowscan launch that is not batched is the masked form
    unbatched = [(form, n) for (st, form), n in forms22.items() if st == "hrex" and n
                 and not form.startswith(("batched", "nb_tiles"))]
    check(unbatched and all(form.endswith("triangular minimum image w") for form, _ in unbatched),
          f"[22] u_kln in the hrex stage launched a rowscan form other than the masked one: {unbatched}")
    masked_row["launches_run_complex"] = launches22["rowscan_sweep"]
    batched_row["launches_run_complex"] = launches22["rowscan_sweep_batched"]
    exact_row["launches_run_complex"] = launches22["nb_tiles"]
    print(f"[22 time] phase 22 took {time.perf_counter() - t_phase22:.1f} s, the script so far "
          f"{time.perf_counter() - T_START:.1f} s, host clock ({smi})")


N23_STEPS, N23_WATER_STEPS, N23_SPLIT, N23_ITERS = 25, 50, 2, 4  # iterations of each run; the split after N23_SPLIT
N23_IG_CUTOFF, TOL_IG_REL = 1.2, 1e-5  # nm; the interaction group's U and dU/dp against the CPU's float64
PLOTS_SEEN = {}  # an estimator's name -> its plots fields, recorded by phases 16 and 19 for phase 23


def _phase23_task(inputs):
    """A DevicePoolClient task: one masked rowscan F launch (triangular,
    minimum image, w) in a spawned worker, on the card its
    CUDA_VISIBLE_DEVICES names; (forces, its launches, the card's name,
    CUDA_VISIBLE_DEVICES)."""
    import torch

    from timemachine_torch.ops import rowscan_kernel as rs

    dev = torch.device("cuda", 0)
    *arrays, series = inputs
    rs.rowscan_sweep.launches = 0
    out = rs.rowscan_sweep(*(torch.as_tensor(a, device=dev) for a in arrays), series, rs.FORCE, triangular=True, has_w=True)
    torch.cuda.synchronize()
    return out.cpu().numpy(), rs.rowscan_sweep.launches, torch.cuda.get_device_name(0), os.environ.get("CUDA_VISIBLE_DEVICES")


def phase23(dev, smi, zero_counts, read_counts, batched_row, make_runner14, ladder20, states13, args13):
    """HREX checkpoint and resume, frames on disk, and the last modules:
    [23 resume] the 12 windows of the solvent RBFE leg as phase 14 builds
    its runner (make_runner14(K), the barostat on): one runner takes
    N23_ITERS iterations of N23_STEPS steps straight; a second takes
    N23_SPLIT, its state_dict() is pickled, and a fresh runner
    load_state_dict()s the pickle and takes the rest. The resumed
    iterations' frames, boxes, permutations, accepted and proposed counts
    and U_kl must be bitwise the straight run's, and their launches (every
    count zeroed just before them) equal, on the batched rowscan form alone;
    [23 water] the same split on phase 20's probe ladder with the TIBD
    sampler (ladder20["make_runner"](True), N23_WATER_STEPS a segment: a
    firing before the split and one after it), bitwise frames and sampler
    counters; [23 ixn] an InteractionGroupTraj of the ligand against the
    host atoms at N23_IG_CUTOFF nm over the straight run's frames by state,
    make_U_fxn(nb_pair_fxn) under state 0's interaction-group parameters on
    the card against the same on the host CPU in float64 (U within
    TOL_IG_REL of the largest |U|, dU/dp within TOL_IG_REL of the CPU's
    norm; the card's float32 printed beside); [23 frames] those frames
    through Trajectory's StoredArrays, read back and unpickled bitwise;
    [23 client] a DevicePoolClient(max_workers=1) task runs one masked
    rowscan F launch (phase 13's inputs, args13) in a spawned worker after
    this process has used the card: bitwise this process's launch; [23
    plots] whether matplotlib imports, and the plots phases 16 and 19's
    estimators returned (None without it). Adds launches_resume to the
    batched row."""
    import pickle

    import numpy as np
    import torch

    from timemachine_torch.fe.free_energy import Trajectory
    from timemachine_torch.fe.interaction_group_traj import InteractionGroupTraj, nb_pair_fxn
    from timemachine_torch.fe.stored_arrays import StoredArrays
    from timemachine_torch.ops import rowscan_kernel as rs
    from timemachine_torch.parallel.client import DevicePoolClient
    from timemachine_torch.potentials import NonbondedInteractionGroup

    t_phase23 = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fields = ("frames_by_state", "boxes_by_state", "replica_idx_by_state", "accepted_by_pair", "proposed_by_pair", "U_kl")

    def iterate(runner, n_iters, n_steps):
        """n_iters HREX iterations, every count zeroed just before them and
        read just after: (results, launches, plain calls, launches by form, host s)."""
        sync()
        zero_counts()
        before = form_launches()
        t_start = time.perf_counter()
        out = [runner.advance_frame(n_steps) for _ in range(n_iters)]
        sync()
        sec = time.perf_counter() - t_start
        counts, plain = read_counts()
        return out, counts, plain, form_launches() - before, sec

    def split_and_resume(make, n_steps):
        straight = make()
        head, *_, sec_head = iterate(straight, N23_SPLIT, n_steps)
        tail_a, counts_a, plain_a, forms_a, sec_a = iterate(straight, N23_ITERS - N23_SPLIT, n_steps)
        split = make()
        iterate(split, N23_SPLIT, n_steps)
        t_start = time.perf_counter()
        blob = pickle.dumps(split.state_dict())
        t_save = time.perf_counter() - t_start
        resumed = make()
        t_start = time.perf_counter()
        resumed.load_state_dict(pickle.loads(blob))
        t_load = time.perf_counter() - t_start
        tail_b, counts_b, plain_b, forms_b, sec_b = iterate(resumed, N23_ITERS - N23_SPLIT, n_steps)
        same = {f: all(np.array_equal(getattr(a, f), getattr(b, f)) for a, b in zip(tail_a, tail_b)) for f in fields}
        return dict(straight=straight, resumed=resumed, head=head, tail_a=tail_a, tail_b=tail_b, same=same, blob=blob,
                    counts=(counts_a, counts_b), plain=(plain_a, plain_b), forms=(forms_a, forms_b),
                    sec=(sec_head, sec_a, sec_b, t_save, t_load))

    def only_batched(counts, plain):
        return plain == 0 and counts["rowscan_sweep_batched"] > 0 and all(
            n == 0 for k, n in counts.items() if k != "rowscan_sweep_batched")

    # -- [23 resume] the 12 windows ------------------------------------------------------------------
    K = len(states13)
    r = split_and_resume(lambda: make_runner14(K), N23_STEPS)
    state = pickle.loads(r["blob"])
    forms_a, forms_b = r["forms"]
    counts_a, counts_b = r["counts"]
    sec_head, sec_a, sec_b, t_save, t_load = r["sec"]
    n_resumed = (N23_ITERS - N23_SPLIT) * N23_STEPS
    print(f"[23 resume] {K} windows of {states13[0].x0.shape[0]} atoms, {N23_ITERS} iterations of {N23_STEPS} steps "
          f"straight against {N23_SPLIT} + pickle({len(r['blob'])} bytes: keys {sorted(state)}, torch named in it "
          f"{b'torch' in r['blob']}, written on {state['device_type']!r} at t {state['t']}, step {state['step']}) + "
          f"load_state_dict + {N23_ITERS - N23_SPLIT}: iterations {N23_SPLIT + 1}-{N23_ITERS} bitwise "
          + ", ".join(f"{f} {v}" for f, v in r["same"].items())
          + f"; their launches straight {dict(forms_a)}, resumed {dict(forms_b)} (plain calls {r['plain']}); host s "
          f"{sec_a:.2f} straight, {sec_b:.2f} resumed, {sec_head:.2f} for the first {N23_SPLIT}; state_dict + pickle "
          f"{t_save * 1e3:.1f} ms, unpickle + load_state_dict {t_load * 1e3:.1f} ms; accepted by pair in the last "
          f"iteration {r['tail_b'][-1].accepted_by_pair.tolist()} ({smi})")
    check(all(r["same"].values()), "[23] the resumed HREX run is not bitwise the straight one")
    check(counts_a == counts_b and forms_a == forms_b and only_batched(counts_b, r["plain"][1]) and r["plain"][0] == 0,
          "[23] the resumed iterations' launches differ from the straight run's, or left the batched rowscan form")
    check(b"torch" not in r["blob"] and state["device_type"] == dev.type, "[23] the checkpoint holds a torch object")
    batched_row["launches_resume"] = counts_b["rowscan_sweep_batched"] / (K * n_resumed)

    # -- [23 water] the probe ladder with the TIBD sampler ---------------------------------------------
    w = split_and_resume(lambda: ladder20["make_runner"](True), N23_WATER_STEPS)
    k_w = len(w["resumed"].water_counters_by_replica()[0])
    at_split = [int(v) for v in pickle.loads(w["blob"])["mover_leaves"][-3]]  # the sampler's n_proposed (then params, generator)
    acc_a, prop_a = w["straight"].water_counters_by_replica()
    acc_b, prop_b = w["resumed"].water_counters_by_replica()
    counters_same = bool(np.array_equal(acc_a, acc_b) and np.array_equal(prop_a, prop_b))
    fired_after = all(b > a for a, b in zip(at_split, prop_b))
    print(f"[23 water] the probe ladder, {k_w} replicas, {N23_ITERS} iterations of {N23_WATER_STEPS} steps, the sampler "
          f"every {N20_INTERVAL} steps: resumed iterations bitwise " + ", ".join(f"{f} {v}" for f, v in w["same"].items())
          + f"; sampler proposed by replica at the split {at_split}, at the end {prop_b.tolist()} (straight "
          f"{prop_a.tolist()}), accepted {acc_b.tolist()} (straight {acc_a.tolist()}), equal {counters_same}; launches "
          f"straight {dict(w['forms'][0])}, resumed {dict(w['forms'][1])}; host s {w['sec'][1]:.2f} straight, "
          f"{w['sec'][2]:.2f} resumed ({smi})")
    check(all(w["same"].values()) and counters_same and fired_after,
          "[23] the resumed water-sampling run is not bitwise the straight one, or the sampler did not fire after the split")
    check(w["counts"][0] == w["counts"][1] and only_batched(w["counts"][1], w["plain"][1]),
          "[23] the resumed water-sampling iterations' launches differ or left the batched rowscan form")

    # -- [23 ixn] the interaction group over the straight run's frames ----------------------------------
    runs = r["head"] + r["tail_a"]
    frames = np.concatenate([res.frames_by_state for res in runs])  # (iterations x K, N, 3), by state within each
    box_diags = np.concatenate([np.diagonal(res.boxes_by_state, axis1=1, axis2=2) for res in runs])
    lig = np.asarray(states13[0].ligand_idxs)
    env = np.setdiff1d(np.arange(frames.shape[1]), lig)
    t_start = time.perf_counter()
    traj = InteractionGroupTraj(frames.astype(np.float64), box_diags.astype(np.float64), lig, env, cutoff=N23_IG_CUTOFF,
                                verbose=False)
    t_build = time.perf_counter() - t_start
    ig = next(p for p in states13[0].potentials if isinstance(p, NonbondedInteractionGroup))
    params = ig.params.detach().cpu().to(torch.float64)
    u_fn = traj.make_U_fxn(nb_pair_fxn)

    def u_and_grad(device, dtype):
        q = params.to(device=device, dtype=dtype).requires_grad_(True)
        sync()
        t_start = time.perf_counter()
        u = u_fn(q)
        (g,) = torch.autograd.grad(u.sum(), q)
        sync()
        return u.detach().cpu().to(torch.float64), g.cpu().to(torch.float64), time.perf_counter() - t_start

    u_cpu, g_cpu, s_cpu = u_and_grad(torch.device("cpu"), torch.float64)
    u_64, g_64, s_64 = u_and_grad(dev, torch.float64)
    u_32, g_32, s_32 = u_and_grad(dev, torch.float32)

    def gaps(u, g):
        return (float((u - u_cpu).abs().max() / u_cpu.abs().max()),
                float(torch.linalg.vector_norm(g - g_cpu) / torch.linalg.vector_norm(g_cpu)))

    gap64, gap32 = gaps(u_64, g_64), gaps(u_32, g_32)
    print(f"[23 ixn] InteractionGroupTraj of the {len(lig)} ligand atoms against {len(env)} host atoms at "
          f"{N23_IG_CUTOFF} nm over {traj.n_frames} frames ({N23_ITERS} iterations x {K} states): shell padded to "
          f"{traj.selected_env_idxs.shape[1]} atoms, built in {t_build:.2f} s; U under state 0's interaction-group "
          f"parameters {u_cpu.min():.3f} to {u_cpu.max():.3f} kJ/mol; card float64 vs CPU float64: U {gap64[0]:.2e} of "
          f"the largest |U|, dU/dp {gap64[1]:.2e} of the CPU's norm (tol {TOL_IG_REL:g}); card float32: {gap32[0]:.2e}, "
          f"{gap32[1]:.2e} (not held); U and dU/dp in {s_64 * 1e3:.1f} ms float64, {s_32 * 1e3:.1f} ms float32 on the "
          f"card, {s_cpu * 1e3:.1f} ms on the host ({smi})")
    check(gap64[0] <= TOL_IG_REL and gap64[1] <= TOL_IG_REL and bool(torch.isfinite(u_32).all()),
          "[23] the interaction group's energies or gradient on the card disagree with the CPU's")

    # -- [23 frames] the straight run's frames through StoredArrays ------------------------------------
    trajs = [Trajectory.empty() for _ in range(K)]
    for res in runs:
        for k, t in enumerate(trajs):
            t.frames.extend(res.frames_by_state[k][None])
            t.boxes.append(res.boxes_by_state[k])
    by_state = frames.reshape(len(runs), K, *frames.shape[1:]).transpose(1, 0, 2, 3)
    read_back = all(np.array_equal(np.asarray(t.frames), by_state[k]) for k, t in enumerate(trajs))
    unpickled = [pickle.loads(pickle.dumps(t)) for t in trajs]
    pickled_back = all(isinstance(u.frames, StoredArrays) and u.frames == t.frames for u, t in zip(unpickled, trajs))
    spilled = sum(len(os.listdir(t.frames._dir.name)) for t in trajs)
    print(f"[23 frames] {K} trajectories of {len(runs)} frames on StoredArrays ({spilled} .npy files under the "
          f"temporary directory): read back bitwise {read_back}, unpickled bitwise {pickled_back} ({smi})")
    check(read_back and pickled_back and spilled == K * len(runs), "[23] frames did not round-trip through StoredArrays")

    # -- [23 client] a card task in a spawned worker ------------------------------------------------------
    inputs = [a.cpu().numpy() for a in args13[:5]] + [args13[5]]
    parent = rs.rowscan_sweep(*args13, rs.FORCE, triangular=True, has_w=True).cpu().numpy()
    t_start = time.perf_counter()
    client = DevicePoolClient(max_workers=1)
    try:
        forces, worker_launches, worker_card, visible = client.submit(_phase23_task, inputs).result()
    finally:
        client.executor.shutdown()
    t_client = time.perf_counter() - t_start
    same_forces = bool(np.array_equal(forces, parent))
    print(f"[23 client] DevicePoolClient(max_workers=1), platform {client.platform!r}, a {client.executor._mp_context.get_start_method()} "
          f"worker: one masked rowscan F launch there on {worker_card} (CUDA_VISIBLE_DEVICES {visible}), launches "
          f"{worker_launches}, forces bitwise this process's launch {same_forces}; {t_client:.1f} s host clock with the "
          f"worker's start ({smi})")
    check(same_forces and worker_launches == 1 and visible == "0", "[23] the pool's card task did not run as asked")

    # -- [23 plots] -----------------------------------------------------------------------------------------
    try:
        import matplotlib  # noqa: F401

        have_mpl = True
    except ImportError:
        have_mpl = False
    seen = {name: [None if p is None else {k: len(v) for k, v in vars(p).items()} for p in plots]
            for name, plots in PLOTS_SEEN.items()}
    print(f"[23 plots] matplotlib imports here: {have_mpl}; the estimators' plots (None, or PNG bytes by figure): "
          + "; ".join(f"{name} {v}" for name, v in seen.items()) + f" ({smi})")
    check(len(seen) == 2 and all((p is not None) == have_mpl for v in seen.values() for p in v),
          "[23] an estimator's plots disagree with whether matplotlib imports")
    print(f"[23 time] phase 23 took {time.perf_counter() - t_phase23:.1f} s, host clock ({smi})")


# phase 24: the reset's seed, the DHFR-size water box, the prefactor energies and the repository's examples as
# the port's entry points. The examples run at a cut depth through their main(argv); where their depth is not an
# argument (the legs' host pre-equilibration, 500 FIRE steps a window and 1,000 NPT steps; run_rbfe_legs's 100
# bisection frames; biphenyl's 1,000 equilibration steps) it is cut here, and run_rbfe_legs's legs run in this process (its DevicePoolClient, one card
# here, replaced by the serial client) so that their launches count here. relative_free_energy takes run_rbfe_legs's
# solvent leg (the same run_solvent on the same pair at the same depth) instead of running it again: it runs its
# own CIF and plot path on that leg's result
N24_SEED, N24_STEPS, N24_FRAMES = 2031, 100, 10  # the reset runs' NPT steps; the prefactors' frames among them
N24_WARM, N24_TIMED = 100, 500  # the water box's NPT steps
TOL_PREFACTOR = 1e-5  # of the energy's scale, the sum of its pair terms' |values| (float32 pair terms cancel)
N24_FIRE, N24_NPT, N24_BISECTION = 100, 100, 2
N24_MC = ["--box_width", "4.0", "--n_iterations", "3", "--md_steps_per_batch", "100", "--mc_proposals_per_batch", "200"]
N24_LEGS = ["--legs", "vacuum", "solvent", "--n_eq_steps", "50", "--n_frames", "3", "--steps_per_frame", "25",
            "--n_windows", "3", "--seed", "2025"]
N24_RFE = ["--n_frames", "3", "--n_eq_steps", "50", "--steps_per_frame", "25", "--seed", "2025", "--legs", "solvent",
           "--n_windows", "3"]
N24_BIPHENYL = ["--n_states", "8", "--n_frames", "5", "--steps_per_frame", "100"]
N24_BIPHENYL_EQ = 100  # the script's fixed 1,000 equilibration steps, cut
N24_WATER_HREX = ["--box_width", "3.0", "--n_windows", "4", "--n_frames", "2", "--steps_per_frame", "100",
                  "--n_eq_steps", "100", "--water_sampling_interval", "100", "--n_proposals", "100"]


def phase24(dev, smi, zero_counts, read_counts, kernel_row, masked_row, batched_row, exact_row, states13):
    """[24 faults] Context.reset_for_state(state, seed=) on phase 13's window
    0: two resets with one seed give the same N24_STEPS NPT steps bitwise
    (frames, box, the noise's and the barostat's generators), another seed
    moves both generators and the coordinates. [24 waterbox]
    setup_dhfr_scale_waterbox() built natively: its atoms and build seconds,
    the card's total force at the FIRE-minimized start against the host
    CPU's (TOL_FORCE_REL_NORM of the all-pairs norm, as phase 3), N24_WARM +
    N24_TIMED NPT steps on the rowscan main form (ns/day, launches a step,
    the idle share of 50 profiled steps), the image-bound margins and the
    largest |dU/dx| at the end (as phase 4). [24 prefactors] the coulomb and
    LJ interaction-group energies of window 0's ligand over the reset run's
    N24_FRAMES frames, by the linear-basis prefactors on the card in float32
    against the host CPU in float64 (TOL_PREFACTOR of each energy's scale)
    and their times. [24 examples] water_sampling_mc, run_rbfe_legs and
    relative_free_energy through their main(argv) (run_example: every count
    zeroed just before each; seconds, launches by form, summary lines,
    finite results); relative_free_energy on run_rbfe_legs's solvent leg,
    its CIF and plot path alone; the other two run in the worker
    (phase24_dense). Adds the phase's launches to the rows they use:
    water_sampling_mc's to the masked form's, the form it runs."""
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.chem.sdf import write_sdf
    from timemachine_torch.constants import DEFAULT_TEMP
    from timemachine_torch.convert import host_system_arrays
    from timemachine_torch.examples import relative_free_energy as ex_rfe
    from timemachine_torch.examples import run_rbfe_legs as ex_legs
    from timemachine_torch.examples import water_sampling_mc as ex_mc
    from timemachine_torch.fe import rbfe as rbfe24
    from timemachine_torch.fe.free_energy import HREXParams, get_context
    from timemachine_torch.fe.model_utils import apply_hmr
    from timemachine_torch.fe.system import HostSystem
    from timemachine_torch.integrators import LangevinIntegrator
    from timemachine_torch.md import minimizer as minimizer24
    from timemachine_torch.md.barostat import MonteCarloBarostat
    from timemachine_torch.md.context import Context
    from timemachine_torch.md.fire import FireMinimizationConfig, fire_minimize
    from timemachine_torch.md.utils import sample_velocities
    from timemachine_torch.ops import nonbonded as nbm
    from timemachine_torch.ops import nonbonded_kernel as nbk
    from timemachine_torch.ops import rowscan_kernel as rs
    from timemachine_torch.parallel.client import SerialClient
    from timemachine_torch.potentials import NonbondedAllPairs, NonbondedInteractionGroup, all_pairs_kernel
    from timemachine_torch.testsystems.dhfr import setup_dhfr_scale_waterbox
    from timemachine_torch.testsystems.rbfe_solvent import load_arrays, metadata

    t_phase24 = time.perf_counter()
    f32 = torch.float32
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)  # the CPU rehearses the phase

    # -- [24 faults] ------------------------------------------------------------------------------------------
    s0 = states13[0]
    ctx = get_context(s0)

    def reset_run(seed):
        ctx.reset_for_state(s0, seed=seed)
        xs, boxes = [], []
        for _ in range(N24_FRAMES):
            ctx.multiple_steps(N24_STEPS // N24_FRAMES)
            xs.append(ctx.get_x_t())
            boxes.append(ctx.get_box())
        sync()
        return dict(x=np.stack(xs), box=np.stack(boxes), noise=ctx._noise.get_state(),
                    barostat=ctx.get_mover_states()[0].generator.get_state())

    zero_counts()
    t0 = time.perf_counter()
    first = reset_run(N24_SEED)
    t_reset = time.perf_counter() - t0
    launches_reset, plain_reset = read_counts()
    again, other = reset_run(N24_SEED), reset_run(N24_SEED + 1)
    same = all(np.array_equal(first[k], again[k]) for k in ("x", "box")) and all(
        torch.equal(first[k], again[k]) for k in ("noise", "barostat"))
    moved = {k: not torch.equal(first[k], other[k]) for k in ("noise", "barostat")}
    moved["x"] = not np.array_equal(first["x"], other["x"])
    print(f"[24 faults] reset_for_state(window 0, seed={N24_SEED}) twice, {N24_STEPS} NPT steps each ({t_reset:.2f} s "
          f"host clock, launches {launches_reset}, plain calls {plain_reset}): frames, box and the noise's and the "
          f"barostat's generators bitwise {same}; seed {N24_SEED + 1} moves noise {moved['noise']}, barostat "
          f"{moved['barostat']}, x {moved['x']} ({smi})")
    check(same and all(moved.values()), "[24] reset_for_state(seed=) is not a reseed of the noise and the barostat")
    check(bool(np.isfinite(first["x"]).all()), "[24] the reset run is not finite")
    check(plain_reset == 0 and launches_reset["rowscan_sweep"] >= N24_STEPS, "[24] the reset run did not launch rowscan")

    # -- [24 prefactors] ------------------------------------------------------------------------------------
    ixn = next(p for p in s0.potentials if isinstance(p, NonbondedInteractionGroup))
    lig = torch.as_tensor(np.asarray(s0.ligand_idxs), device=dev)
    env = torch.as_tensor(np.setdiff1d(np.arange(s0.x0.shape[0]), np.asarray(s0.ligand_idxs)), device=dev)

    def prefactor_energies(x, box, params):
        xl, xe = x[:, lig.to(x.device)], x[:, env.to(x.device)]
        pl, pe = params[lig.to(x.device)], params[env.to(x.device)]
        cq = nbm.coulomb_prefactors_on_snapshot(xl, xe, pe[:, 0], box, ixn.beta, ixn.cutoff)
        cl = nbm.lj_prefactors_on_snapshot(xl, xe, pe[:, 1], pe[:, 2], box, ixn.cutoff)
        return nbm.coulomb_interaction_group_energy(pl[:, 0], cq), nbm.lj_interaction_group_energy(pl[:, 1], pl[:, 2], cl)

    x_card = torch.as_tensor(first["x"], device=dev, dtype=f32)
    box_card = torch.as_tensor(first["box"], device=dev, dtype=f32)
    p_card = ixn.params.to(f32)
    prefactor_energies(x_card, box_card, p_card)  # the first call's allocations
    sync()
    t0 = time.perf_counter()
    u_card = prefactor_energies(x_card, box_card, p_card)
    sync()
    ms_card = (time.perf_counter() - t0) * 1e3
    x64, box64, p64 = x_card.double().cpu(), box_card.double().cpu(), p_card.double().cpu()
    t0 = time.perf_counter()
    u_cpu = prefactor_energies(x64, box64, p64)
    ms_cpu = (time.perf_counter() - t0) * 1e3
    # each energy's scale: the sum over frames' pairs of |its pair term|, float64 on the CPU
    d = nbm._ligand_env_distances(x64[:, lig.cpu()], x64[:, env.cpu()], box64, ixn.cutoff)
    pl, pe = p64[lig.cpu()], p64[env.cpu()]
    q_abs = (pl[:, 0, None] * pe[None, :, 0] / d * torch.special.erfc(ixn.beta * d) * nbm.switch_fn(d)).abs().sum((-1, -2))
    s6 = ((pl[:, 1, None] + pe[None, :, 1]) / d) ** 6
    lj_abs = (4.0 * pl[:, 2, None] * pe[None, :, 2] * (s6 * s6 + s6)).sum((-1, -2))
    errs = []
    for label, uc, uh, scale in (("coulomb", u_card[0], u_cpu[0], q_abs), ("LJ", u_card[1], u_cpu[1], lj_abs)):
        diff = (uc.double().cpu() - uh).abs()
        errs.append(float((diff / scale).max()))
        print(f"[24 prefactors] {label} over {N24_FRAMES} frames of window 0's ligand ({lig.numel()} atoms against "
              f"{env.numel()}): card float32 vs host CPU float64, largest |dU| / scale {errs[-1]:.3e} (tol "
              f"{TOL_PREFACTOR:g}), largest |dU| / |U| {float((diff / uh.abs()).max()):.3e}; U frame 0 "
              f"{float(uh[0]):.4f} kJ/mol ({smi})")
    print(f"[24 prefactors] both energies over the {N24_FRAMES} frames: card {ms_card:.2f} ms, host CPU float64 "
          f"{ms_cpu:.1f} ms, host clock ({smi})")
    check(max(errs) <= TOL_PREFACTOR, "[24] the card's prefactor energies disagree with the CPU's float64")

    # -- [24 waterbox] -----------------------------------------------------------------------------------------
    t0 = time.perf_counter()
    wb = setup_dhfr_scale_waterbox()
    t_build = time.perf_counter() - t0
    n = wb.conf.shape[0]
    arrays = host_system_arrays(wb.host_system)
    hs = HostSystem.from_arrays(arrays, device=dev, dtype=f32)
    bps, nb = hs.get_U_fns(), hs.nonbonded_all_pairs
    x0 = torch.as_tensor(wb.conf, device=dev, dtype=f32)
    box = torch.as_tensor(wb.box, device=dev, dtype=f32)
    has_w = bool((nb.params[:, 3] != 0).any())  # False for water, as phase 3's DHFR
    nb.configure(box, x0, kernel=all_pairs_kernel("context", n, dev), rowscan_has_w=has_w)
    check(nb.kernel == "rowscan" and nb.md_preshift, "[24] the water box did not take the rowscan main form")
    t0 = time.perf_counter()
    x_min = fire_minimize(x0, lambda x: sum(p.energy_force(x, box)[1] for p in bps), FireMinimizationConfig(N_FIRE))
    sync()
    t_fire = time.perf_counter() - t0
    # FIRE rearranges the built lattice: the lists are sized again from its result
    invalid_fire = int(nb.md_force_provider()[0](x_min, box).invalid)
    nb.configure(box, x_min, kernel=nb.kernel, rowscan_has_w=has_w)
    check(nb.kernel == "rowscan" and nb.md_preshift, "[24] the relaxed water box did not take the rowscan main form")
    hs_cpu = HostSystem.from_arrays(arrays, device="cpu", dtype=f32)
    hs_cpu.nonbonded_all_pairs.configure(box.cpu(), x_min.cpu(), kernel=nb.kernel, rowscan_has_w=has_w)
    f_card = sum(p.energy_force(x_min, box)[1] for p in bps)
    f_host = sum(p.energy_force(x_min.cpu(), box.cpu())[1] for p in hs_cpu.get_U_fns())
    f_ap = NonbondedAllPairs.energy_force(nb, x_min, box)[1]
    f_rel = float(torch.linalg.vector_norm(f_card.cpu() - f_host)) / float(torch.linalg.vector_norm(f_ap))
    print(f"[24 waterbox] setup_dhfr_scale_waterbox(): {n} atoms, a {float(box[0, 0]):.4f} nm box, built in {t_build:.2f} s; "
          f"FIRE {N_FIRE} steps {t_fire:.2f} s (the lists sized at the lattice invalid after it: {invalid_fire}; sized "
          f"again); total force card vs host CPU |diff| / |all-pairs force| {f_rel:.3e} (tol {TOL_FORCE_REL_NORM:g}); "
          f"largest |F| {float(f_host.norm(dim=-1).max()):.1f} kJ/mol/nm ({smi})")
    check(f_rel <= TOL_FORCE_REL_NORM, "[24] the water box's force on the card disagrees with the host CPU")
    masses = apply_hmr(wb.masses, arrays["bond_idxs"])
    intg = LangevinIntegrator(TEMP, DT, FRICTION, masses, seed=N24_SEED)
    v0 = sample_velocities(masses, TEMP, seed=N24_SEED + 1)
    baro = MonteCarloBarostat(n, PRESSURE, TEMP, wb.host_topology.group_idxs, BAROSTAT_INTERVAL, seed=N24_SEED + 2)
    wctx = Context(x_min, v0, box, intg, bps, movers=[baro], device=dev)
    zero_counts()
    forms_before = form_launches()
    wctx.multiple_steps(N24_WARM)
    sync()
    t0 = time.perf_counter()
    wctx.multiple_steps(N24_TIMED)
    sync()
    elapsed = time.perf_counter() - t0
    launches_wb, plain_wb = read_counts()
    forms_wb = form_launches() - forms_before
    main_wb = sum(k for f, k in forms_wb.items() if "preshift" in f and not f.startswith(("batched", "nb_tiles")))
    ns_day = N24_TIMED * DT / 1000.0 / elapsed * 86_400.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wctx.multiple_steps(N_PROFILE)
        sync()
    print(f"{smi}; {N_PROFILE} NPT steps of the water box\n{prof.key_averages().table(sort_by='cuda_time_total', row_limit=20)}",
          file=sys.stderr)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3 / N_PROFILE
    step_ms = elapsed * 1e3 / N24_TIMED
    idle = f"{1 - busy_ms / step_ms:.3f}" if busy_ms > 0 else "not measured (the profiler saw no device time)"
    x_end = torch.as_tensor(wctx.get_x_t(), device=dev, dtype=f32)
    box_end = torch.as_tensor(wctx.get_box(), device=dev, dtype=f32)
    state0, state_end = nb.md_force_provider()[0](x_min, box), nb.md_force_provider()[0](x_end, box_end)
    check(int(state_end.invalid) == 0, "[24] the water box's lists invalid at the end state")
    t_end = state_end.lists
    atoms_end = rs.assemble_atoms(x_end, box_end, t_end.pad_order, state_end.prows)
    count_end = rs.chop_row_counts(atoms_end[:, :3], t_end.rank_mat, t_end.row_count, box_end, nb.cutoff)
    end_args = (atoms_end, t_end.row_start, count_end, t_end.col_ids, rs.sweep_scalars(box_end, nb.cutoff),
                rs.es_energy_force_series(nb.beta, nb.cutoff))
    images = dict(rcen_q=t_end.rcen_q) if nb.md_preshift else {}  # the CPU rehearsal's small box: minimum image
    grad_end = max(
        float(rs.rowscan_sweep(*end_args, rs.FORCE, triangular=True, has_w=has_w, **images)[:, 1:4].abs().max()),
        float(NonbondedAllPairs.energy_force(nb, x_end, box_end)[1].abs().max()),
    )
    finite_wb = bool(torch.isfinite(x_end).all() and torch.isfinite(box_end).all())
    print(f"[24 waterbox] NPT {N24_WARM} warm-up + {N24_TIMED} timed steps: {ns_day:.2f} ns/day ({step_ms:.4f} ms/step, "
          f"host clock); device busy {busy_ms:.4f} ms/step, idle share {idle} ({N_PROFILE} profiled steps); rowscan "
          f"launches {launches_wb['rowscan_sweep']} ({launches_wb['rowscan_sweep'] / (N24_WARM + N24_TIMED):.3f} a step), "
          f"main form {main_wb}, plain calls {plain_wb}; box {float(box_end[0, 0]):.4f} nm; finite {finite_wb} ({smi})")
    margins = [float(getattr(st.lists, "margin", float("nan"))) for st in (state0, state_end)]
    print(f"[24 waterbox] image-bound margin at cutoff + skin: {margins[0]:.4f} nm at the start, "
          f"{margins[1]:.4f} nm at the end; largest |dU/dx| {grad_end:.4e} of the kernel's fixed-point limit "
          f"{nbk.FIX_LIMIT:.4e} kJ/mol/nm ({smi})")
    check(finite_wb and plain_wb == 0, "[24] the water box's run is not finite or ran a plain sweep")
    check(main_wb == launches_wb["rowscan_sweep"] >= N24_WARM + N24_TIMED, "[24] the water box left the rowscan main form")
    check(grad_end < nbk.FIX_LIMIT, "[24] the water box's |dU/dx| beyond the kernel's fixed-point limit")
    kernel_row["launches_waterbox"] = launches_wb["rowscan_sweep"] / (N24_WARM + N24_TIMED)

    # -- [24 examples] ---------------------------------------------------------------------------------------
    a13 = load_arrays()
    meta = metadata(a13)
    mols = [mol_from_smiles(str(s), add_hs=True, name=str(nm)) for s, nm in zip(meta["smiles"], meta["names"])]
    for mol, key in zip(mols, ("conf_a", "conf_b")):
        mol.set_conf(np.asarray(meta[key]))
    names = [str(nm) for nm in meta["names"]]
    workdir = tempfile.mkdtemp(prefix="chip_smoke24_")
    sdf = os.path.join(workdir, "ligands.sdf")
    write_sdf(mols, sdf)
    added = Counter()

    # water_sampling_mc at 4.0 nm: over the 4,096-atom line, the rowscan kernel every step. By JAX's rule it takes
    # the masked row's form, not the main form: the host term keeps w (get_context's rule), and the preshift image
    # bound fails in a 4.0 nm box (as dot's does at the RBFE leg's 4.03 nm)
    (mc_ctx, occ), forms_mc, _, _ = run_example(dev, smi, "water_sampling_mc", ex_mc.main, N24_MC)
    n_mc = mc_ctx.get_x_t().shape[0]
    steps_mc = int(N24_MC[N24_MC.index("--n_iterations") + 1]) * int(N24_MC[N24_MC.index("--md_steps_per_batch") + 1])
    check(n_mc > 4096 and dict(forms_mc) == {MASKED_F: steps_mc} and bool(np.isfinite(mc_ctx.get_x_t()).all())
          and len(occ) == 3, "[24] water_sampling_mc did not launch the masked rowscan form once a step or is not finite")
    masked_row["launches_water_sampling_mc"] = forms_mc[MASKED_F] / steps_mc

    # run_rbfe_legs and relative_free_energy: the host pre-equilibration and bisection cut, the legs in this process
    restore = [(minimizer24, "pre_equilibrate_host", minimizer24.pre_equilibrate_host),
               (ex_legs, "HREXParams", ex_legs.HREXParams), (ex_legs, "DevicePoolClient", ex_legs.DevicePoolClient),
               (ex_legs, "run_solvent", ex_legs.run_solvent), (ex_rfe, "run_solvent", ex_rfe.run_solvent)]
    minimizer24.pre_equilibrate_host = partial(minimizer24.pre_equilibrate_host, minimizer_steps_per_window=N24_FIRE,
                                               equilibration_steps=N24_NPT)
    # at the script's --target_overlap the schedule is rebalanced, which raises (ROADMAP R8)
    ex_legs.HREXParams = lambda **kw: HREXParams(**{**kw, "n_frames_bisection": N24_BISECTION,
                                                     "optimize_target_overlap": None})
    ex_legs.DevicePoolClient = lambda n_devices: SerialClient()
    solvent_leg = {}

    def record_solvent(mol_a, mol_b, core, ff, host, md_params, **kw):
        solvent_leg["call"] = (mol_a.name, mol_b.name, np.asarray(core), md_params, kw.get("n_windows"))
        solvent_leg["out"] = restore[3][2](mol_a, mol_b, core, ff, host, md_params, **kw)
        return solvent_leg["out"]

    def replay_solvent(mol_a, mol_b, core, ff, host, md_params=None, n_windows=None, device=None):
        names_a, names_b, core_legs, md_legs, n_legs = solvent_leg["call"]
        same = (mol_a.name, mol_b.name, n_windows) == (names_a, names_b, n_legs) and np.array_equal(core, core_legs)
        same = same and all(getattr(md_params, k) == getattr(md_legs, k)
                            for k in ("n_frames", "n_eq_steps", "steps_per_frame", "seed"))
        check(same, "[24] relative_free_energy asked for another solvent leg than run_rbfe_legs ran")
        return solvent_leg["out"]

    ex_legs.run_solvent = record_solvent
    ex_rfe.run_solvent = replay_solvent
    clock = StageClock(sync)
    for module, attr, stage in ((minimizer24, "fire_minimize_host", "fire"), (minimizer24, "pre_equilibrate_host", "npt"),
                                (rbfe24, "optimize_coords_state", "minimize"), (rbfe24, "run_sims_bisection", "bisection"),
                                (rbfe24, "run_sims_hrex", "hrex")):
        clock.wrap(module, attr, stage)
    try:
        out_legs = os.path.join(workdir, "legs")
        legs, _, counts_legs, _ = run_example(
            dev, smi, "run_rbfe_legs", ex_legs.main,
            ["--sdf_path", sdf, "--mol_a", names[0], "--mol_b", names[1], *N24_LEGS, "--output_dir", out_legs], added, clock)
        stages_legs = clock.by_stage() + "; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in clock.sec.items())
        stage_forms_legs = dict(clock.forms)
        out_rfe = os.path.join(workdir, "rfe")
        rfe, forms_rfe, _, _ = run_example(
            dev, smi, "relative_free_energy", ex_rfe.main,
            ["--ligands", sdf, "--mol_a_name", names[0], "--mol_b_name", names[1], "--protein", "unused.pdb",
             *N24_RFE, "--output_dir", out_rfe])
    finally:
        clock.restore()
        for module, attr, fn in restore:
            setattr(module, attr, fn)
    print(f"[24 examples] run_rbfe_legs launches by stage and form: {stages_legs} ({smi})")
    files_legs = sorted(os.path.relpath(os.path.join(d, f), out_legs) for d, _, fs in os.walk(out_legs) for f in fs)
    print(f"[24 examples] run_rbfe_legs wrote {files_legs} ({smi})")
    check(len(legs) == 2 and all(np.isfinite(v) for leg in legs for v in leg), "[24] run_rbfe_legs's ΔG not finite")
    check({"vacuum/results.npz", "solvent/results.npz", "solvent/lambda1_traj.npz"} <= set(files_legs),
          "[24] run_rbfe_legs did not write JAX's files")
    res_rfe = rfe["solvent"]
    n_cif = len([f for f in os.listdir(out_rfe) if f.startswith("solvent_traj_") and f.endswith(".cif")])
    check(res_rfe is solvent_leg["out"][0] and not forms_rfe and n_cif == len(res_rfe.frames)
          and bool(np.isfinite(res_rfe.final_result.dGs).all()),
          "[24] relative_free_energy did not write a CIF a window of run_rbfe_legs's solvent leg, or launched a kernel")
    check(counts_legs["nb_tiles"] > 0 and counts_legs["rowscan_sweep"] > 0, "[24] run_rbfe_legs did not launch nb_tiles and rowscan")
    for stage in ("fire", "minimize"):
        in_stage = {f: k for (st, f), k in stage_forms_legs.items() if st == stage and k}
        check(in_stage.get(EXACT_UF, 0) > 0 and set(in_stage) == {EXACT_UF},
              f"[24] run_rbfe_legs's {stage} stage is not on nb_tiles' exact F+U form alone")
    check(stage_forms_legs.get(("npt", MASKED_F), 0) > 0, "[24] run_rbfe_legs's host NPT did not launch the masked form")
    check(any(st == "hrex" and f.startswith("batched") and k for (st, f), k in stage_forms_legs.items()),
          "[24] run_rbfe_legs's HREX did not launch the batched form")
    masked = added[MASKED_F]
    batched = sum(k for f, k in added.items() if f.startswith("batched"))
    exact = added[EXACT_UF]
    check(masked > 0 and batched > 0 and exact > 0,
          "[24] the solvent legs did not launch the masked, batched and exact F+U forms")
    masked_row["launches_examples"], batched_row["launches_examples"], exact_row["launches_examples"] = masked, batched, exact

    print(f"[24 time] phase 24 took {time.perf_counter() - t_phase24:.1f} s, host clock ({smi})")


def run_example(dev, smi, label, main_fn, argv, added=None, clock=None):
    """An example's main(argv) on `dev` with every count zeroed just before
    it: its printed lines (prefixed), seconds and launches by form. With
    `added`, its launches by form are added there; with a StageClock, the
    launches outside its stages go under "setup"."""
    import contextlib
    import io

    import torch

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    zero_counts()
    before = form_launches()
    buf = io.StringIO()
    t_start = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main_fn([*argv, "--device", dev.type])
    sync()
    sec = time.perf_counter() - t_start
    counts, plain = read_counts()
    forms = form_launches() - before
    if added is not None:
        added.update(forms)
    if clock is not None:
        for form, k in forms.items():
            clock.forms["setup", form] += k
    for line in buf.getvalue().splitlines():
        if line.strip():
            print(f"[24 examples] {label} | {line}")
    print(f"[24 examples] {label}: {sec:.1f} s host clock; launches {counts}, plain calls {plain}; by form "
          f"{dict(sorted(forms.items()))} ({smi})")
    check(plain == 0, f"[24] {label} ran a plain sweep")
    return out, forms, counts, sec


def phase24_dense(dev, smi):
    """Phase 24's two examples at JAX's sizes below 4,096 atoms, in the
    worker (they read nothing of this process's phases):
    biphenyl_torsion_sampling_hrex twice, its rerun bitwise, and
    water_sampling_hrex at 3.0 nm; no kernel launches there (JAX's dense
    form)."""
    import numpy as np

    from timemachine_torch.examples import biphenyl_torsion_sampling_hrex as ex_biphenyl
    from timemachine_torch.examples import water_sampling_hrex as ex_water_hrex

    t_start = time.perf_counter()
    # the two examples at JAX's sizes, below 4,096 atoms: the dense form on the card, no kernel. Biphenyl's
    # equilibration is cut, and its rerun takes the first run's embedded molecule
    restore = [(ex_biphenyl, "MDParams", ex_biphenyl.MDParams), (ex_biphenyl, "get_biphenyl", ex_biphenyl.get_biphenyl)]
    biphenyl = ex_biphenyl.get_biphenyl()
    ex_biphenyl.MDParams = lambda **kw: restore[0][2](**{**kw, "n_eq_steps": N24_BIPHENYL_EQ})
    ex_biphenyl.get_biphenyl = lambda: biphenyl
    try:
        first_b, _, counts_b, _ = run_example(dev, smi, "biphenyl_torsion_sampling_hrex", ex_biphenyl.main, N24_BIPHENYL)
        again_b, _, _, _ = run_example(dev, smi, "biphenyl_torsion_sampling_hrex (rerun)", ex_biphenyl.main, N24_BIPHENYL)
    finally:
        for module, attr, fn in restore:
            setattr(module, attr, fn)
    same_b = bool(np.array_equal(first_b[0].dGs, again_b[0].dGs)) and all(
        np.array_equal(np.asarray(a.frames), np.asarray(b.frames)) for a, b in zip(first_b[1], again_b[1]))
    print(f"[24 examples] biphenyl_torsion_sampling_hrex rerun: ΔG and every state's frames bitwise {same_b} ({smi})")
    check(same_b and bool(np.isfinite(first_b[0].dGs).all()), "[24] biphenyl's rerun differs or its ΔG is not finite")
    water_hrex, _, counts_w, _ = run_example(dev, smi, "water_sampling_hrex", ex_water_hrex.main, N24_WATER_HREX)
    n_w = water_hrex[1][0].frames[0].shape[0]
    check(bool(np.isfinite(water_hrex[0].dGs).all()) and n_w < 4096, "[24] water_sampling_hrex's ΔG not finite")
    check(sum(counts_b.values()) == 0 and sum(counts_w.values()) == 0,
          "[24] an example below 4,096 atoms launched a kernel (JAX's dense form there)")
    print(f"[24 time] phase 24's dense examples took {time.perf_counter() - t_start:.1f} s in the worker, host clock ({smi})")


# phase 25, the sorted-state step: the DHFR run and the RBFE window held
# bitwise against the canonical step, the steps timed alternately, the
# plan's force against the CPU's float64
N25_BITWISE, N25_TIMED, N25_ROUNDS, N25_PROFILE, N25_WINDOW = 100, 500, 5, 20, 6
TOL_PLAN_REL = 1e-5


def phase25(dev, smi, zero_counts, read_counts, kernel_row, dhfr, states13):
    """[25 dhfr] Two Contexts of phase 4's relaxed DHFR (the main form:
    preshift, no w), one taking the sorted-state step (md/context.py
    SORTED_MD, the default) and one the canonical step, N25_BITWISE NPT
    steps each from the same start: x, v and box bitwise equal, the rowscan
    launches of each (the sorted run's per step on the kernels line's main
    row as launches_sorted). [25 time] N25_TIMED more steps of each in
    N25_ROUNDS alternating rounds (host clock, ns/day; not gated: the step
    is host-bound), and N25_PROFILE profiled steps of each for the device's
    busy time and idle share. [25 launches] a step of each that neither
    rebuilds nor moves the box, captured in a CUDA graph (its kernels,
    memory sets and copies), and the aten operations a step dispatches.
    [25 window] phase 13's window N25_WINDOW (the masked form: minimum
    image, w) through get_context, sorted and canonical, N25_BITWISE steps
    each, bitwise. [25 plan] the one contribution plan's assembled force at
    the relaxed DHFR start (the bonded tails past the leading waters and the
    exclusion tail) on the card in float32 against the same plan on the
    host CPU in float64, within TOL_PLAN_REL of the latter's norm."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from timemachine_torch.fe.free_energy import MDParams, get_context
    from timemachine_torch.md import context as context_module
    from timemachine_torch.ops import nonbonded as nbops
    from timemachine_torch.ops.assembly import assemble_forces, build_contrib_plan
    from timemachine_torch.testsystems.dhfr import setup_dhfr_native

    t_phase = time.perf_counter()
    names = ("sorted", "canonical")

    def built(make, sorted_md):
        context_module.SORTED_MD = sorted_md
        try:
            ctx = make()
        finally:
            context_module.SORTED_MD = True
        check((ctx._sorted_info is not None) == sorted_md, f"[25] a Context did not take the {names[not sorted_md]} step")
        return ctx

    def run_pair(make, label):
        """Both steps from one start, N25_BITWISE steps each: (contexts, launches a step, bitwise)."""
        ctxs, launches = {}, {}
        for name in names:
            zero_counts()
            ctx = ctxs[name] = built(make, name == "sorted")
            ctx.multiple_steps(N25_BITWISE)
            torch.cuda.synchronize()
            counts, plain = read_counts()
            check(plain == 0 and counts["rowscan_sweep"] >= N25_BITWISE, f"[25] the {label} {name} run did not launch the rowscan kernel every step")
            launches[name] = counts["rowscan_sweep"] / N25_BITWISE
        a, b = ctxs["sorted"], ctxs["canonical"]
        same = {k: bool(np.array_equal(getattr(a, f)(), getattr(b, f)())) for k, f in (("x", "get_x_t"), ("v", "get_v_t"), ("box", "get_box"))}
        finite = bool(np.isfinite(a.get_x_t()).all())
        moved = int(a.get_mover_states()[0].total_accepted)
        print(f"[25 {label}] sorted vs canonical step, {N25_BITWISE} NPT steps from one start (rebuilds every 20, the "
              f"barostat every {BAROSTAT_INTERVAL}, {moved} moves accepted): bitwise " + ", ".join(f"{k} {v}" for k, v in same.items())
              + f"; finite {finite}; rowscan launches a step: sorted {launches['sorted']:.3f}, canonical "
              f"{launches['canonical']:.3f} ({smi})")
        check(all(same.values()) and finite, f"[25] the {label} sorted step is not bitwise the canonical step")
        return ctxs, launches

    # -- DHFR, the main form
    ctxs, launches = run_pair(dhfr["make_context"], "dhfr")
    nb_i = ctxs["sorted"]._sorted_info[0]
    check(bool(ctxs["sorted"].potentials[nb_i].md_preshift), "[25] DHFR is not on the main form (preshift)")
    kernel_row["launches_sorted"] = launches["sorted"]

    seconds = dict.fromkeys(names, 0.0)
    per_round = N25_TIMED // N25_ROUNDS
    for r in range(N25_ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctxs[name].multiple_steps(per_round)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t0
    step_ms = {k: v * 1e3 / N25_TIMED for k, v in seconds.items()}
    busy = {}
    for name in names:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ctxs[name].multiple_steps(N25_PROFILE)
            torch.cuda.synchronize()
        busy[name] = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3 / N25_PROFILE
    print("[25 time] DHFR " + "; ".join(
        f"{name} step {step_ms[name]:.4f} ms ({N25_TIMED * DT / 1000.0 / seconds[name] * 86_400.0:.2f} ns/day), device busy "
        f"{busy[name]:.4f} ms/step, idle " + (f"{1 - busy[name] / step_ms[name]:.3f}" if busy[name] > 0 else "not measured")
        for name in names) + f"; {N25_TIMED} steps each in {N25_ROUNDS} alternating rounds, host clock, {N25_PROFILE} "
        f"profiled steps each; sorted / canonical step time {step_ms['sorted'] / step_ms['canonical']:.3f} ({smi})")

    # two steps in a row that neither rebuild nor move the box (t % 20 != 0, (t + 1) % 25 != 0): the first
    # counts the aten operations, the second is captured
    for ctx in ctxs.values():
        while ctx._step % 20 in (0, 19) or (ctx._step + 1) % BAROSTAT_INTERVAL in (0, 24):
            ctx.multiple_steps(1)
    steps = {}
    sorted_ctx = ctxs["sorted"]
    for name, ctx in ctxs.items():
        if name == "sorted":
            carry = sorted_ctx._to_sorted(sorted_ctx._x, sorted_ctx._v, sorted_ctx._prov_states[nb_i])

            def one(carry=carry):
                return sorted_ctx._sorted_step(carry)
        else:
            one = ctx._one_step
        with torch.no_grad(), count_ops() as ops:
            out = one()
        torch.cuda.synchronize()
        if name == "sorted":
            carry = out

            def one(carry=carry):
                return sorted_ctx._sorted_step(carry)
        with torch.no_grad():
            nodes = graph_nodes(one, ctx._noise)  # the Context is left unusable
        steps[name] = (nodes, ops.n)
    print("[25 launches] DHFR, a step without a rebuild or a barostat move captured in a CUDA graph: " + "; ".join(
        f"{name} {nodes[0]} kernels, {nodes[2]} memory sets, {nodes[1]} copies, {ops_n} aten operations dispatched"
        for name, (nodes, ops_n) in steps.items()) + f" ({smi})")
    check(all(n[0] > 0 for n, _ in steps.values()), "[25] a captured step launched no kernel")

    # -- the RBFE window, the masked form
    md = MDParams(n_frames=1, n_eq_steps=0, steps_per_frame=1, seed=2023)
    wctxs, wlaunches = run_pair(lambda: get_context(states13[N25_WINDOW], md), f"window {N25_WINDOW}")
    wnb = wctxs["sorted"].potentials[wctxs["sorted"]._sorted_info[0]]
    check(wnb.atom_mask is not None and not wnb.md_preshift, "[25] the window is not on the masked form")

    # -- the plan's force: the card's float32 against the CPU's float64
    x, box = dhfr["x_min"], dhfr["box"]
    ctx = built(dhfr["make_context"], True)
    contribs = []
    with torch.no_grad():
        for i, fn in ctx._contrib_entries:
            contribs.extend(fn(x, ctx.potentials[i].params, box)[0])
        f_card = assemble_forces(ctx._plan, contribs)
    f64 = torch.float64
    pots64 = setup_dhfr_native(waters_first=True, device="cpu", dtype=f64).host_system.get_U_fns()
    x64, box64 = x.cpu().to(f64), box.cpu().to(f64)
    groups, contribs64 = [], []
    for term in pots64[:4]:
        g, fn = term.force_contribs()
        groups += g
        contribs64 += fn(x64, term.params, box64)[0]
    nb64 = pots64[4]
    _, (f_l, f_r) = nbops.specific_pairs_force_contribs(
        x64, nb64.params, box64, nb64.tail_idxs, nb64.beta, nb64.cutoff, nb64.tail_scales, nb64.h_coeffs
    )
    groups.append(nb64.tail_idxs.numpy())
    contribs64.append([-f_l, -f_r])
    plan64 = build_contrib_plan(groups, x64.shape[0], device="cpu")
    check(np.array_equal(plan64.perm, ctx._plan.perm), "[25] the card's plan is not the CPU's")
    f_ref = assemble_forces(plan64, contribs64)
    plan_rel = float(torch.linalg.vector_norm(f_card.cpu().to(f64) - f_ref) / torch.linalg.vector_norm(f_ref))
    print(f"[25 plan] the plan's assembled force at the relaxed DHFR start ({len(groups)} groups, {plan64.perm.shape[0]} "
          f"contributions): card float32 vs CPU float64 |diff| / |force| {plan_rel:.3e} (tol {TOL_PLAN_REL:g}) ({smi})")
    check(plan_rel <= TOL_PLAN_REL, "[25] the card's plan force disagrees with the CPU's float64")
    print(f"[25 time] phase 25 took {time.perf_counter() - t_phase:.1f} s, host clock ({smi})")


# phase 26, the mesh code on torch.distributed: the rowscan kernel's row slab at DHFR, spatially decomposed MD of
# DHFR on a one-rank nccl mesh and on two gloo ranks sharing the card, HREX over phase 14's windows on a one-rank mesh
N26_SLABS, N26_STEPS, N26_WARM, N26_PROFILE, N26_SEED = (1, 2, 4, 8), 100, 20, 20, 2031
N26_HREX_ITERS, N26_HREX_STEPS, N26_RANKS = 2, 10, 2
# the spatial runner's force against the Context's at the relaxed DHFR start, and two ranks' against one's: the norm
# of the difference over the all-pairs force's (phase 3's TOL_FORCE_REL_NORM); the trajectories' drift apart after
# N26_CMP and N26_STEPS steps is printed beside a control's (the Context with its bonded terms summed in another
# order), not held to JAX's 5e-4 nm (TOL_SPATIAL_X, its bound for a water box at 1 fs over 10 steps): float32 sums of
# the protein's swept-and-subtracted excluded pairs differ by up to tens of kJ/mol/nm an atom between any two orders
# (PERF.md Open question 20), which moves DHFR's trajectories further apart than that within 10 steps of 2.5 fs
TOL_SPATIAL_X, N26_CMP = 5e-4, 10
# the spatial runner's x drift from the Context (and two ranks' from one) after N26_CMP steps, at most this many
# times the drift of the Context with its bonded terms summed in another order: both come from float32 sums taken
# in another order, so a fault of the runner's integrator (its noise, its coefficients, a rebuild at the wrong
# step) shows as a drift many times the control's
TOL_DRIFT_RATIO = 3.0
N26_SHARE = 4  # ranks of the replica mesh whose per-rank share [26 hrex] times the whole batch against


def _slabs26(n_rows: int, d: int) -> list:
    """The spatial runner's split of n_rows row chunks over d ranks: (row_base, n_rows_local) each."""
    local = -(-n_rows // d)
    return [(r * local, min(local, n_rows - r * local)) for r in range(d) if r * local < n_rows]


def _sync26(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _phase26_rank(rank: int, inputs_path: str, out_dir: str):
    """One of phase 26's two gloo ranks sharing the card: DHFR's spatial runner over the 2-rank mesh,
    n_warm steps, n_cmp steps, then n_steps twice from the same start, its rowscan launches counted."""
    import numpy as np
    import torch

    from timemachine_torch.ops import _build
    from timemachine_torch.ops import rowscan_kernel as rs
    from timemachine_torch.parallel.mesh import make_mesh
    from timemachine_torch.parallel.spatial_md import make_spatial_md_runner
    from timemachine_torch.testsystems.dhfr import setup_dhfr_native

    inputs = dict(np.load(inputs_path))
    dev = torch.device(str(inputs["device"]))
    if dev.type == "cuda":
        _build.load_libraries("rowscan")
    hc = setup_dhfr_native(waters_first=True, device=dev, dtype=torch.float32)
    mesh = make_mesh(dev, "spatial")
    x0, v0, box = inputs["x0"], inputs["v0"], inputs["box"]
    make_run = make_spatial_md_runner(hc.host_system.get_U_fns(), inputs["masses"], mesh, conf0=x0, box0=box)
    n_steps = int(inputs["n_steps"])
    make_run(TEMP, DT, FRICTION, int(inputs["n_warm"]))(x0, v0, box, N26_SEED)
    x_cmp = make_run(TEMP, DT, FRICTION, int(inputs["n_cmp"]))(x0, v0, box, N26_SEED)[0]
    f0 = make_run.force(x0, box)
    run = make_run(TEMP, DT, FRICTION, n_steps)
    _sync26(dev)
    before, slabs_before = rs.rowscan_sweep.launches, rs.rowscan_sweep.launches_slabs
    t0 = time.perf_counter()
    x = run(x0, v0, box, N26_SEED)[0]
    _sync26(dev)
    seconds = time.perf_counter() - t0
    launches = (rs.rowscan_sweep.launches - before, rs.rowscan_sweep.launches_slabs - slabs_before)
    x2 = run(x0, v0, box, N26_SEED)[0]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), x=x.cpu().numpy(), x2=x2.cpu().numpy(),
             x_cmp=x_cmp.cpu().numpy(), force=f0.cpu().numpy(), launches=np.array(launches), seconds=seconds)


def _overlap_batch26(dev, same_w: bool):
    """tests/test_torch_cuda.py's _batched_case at overlap_in=4: 3 replicas of a masked 4,089-atom fluid (the first
    9 atoms out of the subset), 3 parameter sets each; system 4's atoms 9 and 10 0.01 nm apart in xyz, their w
    offsets lifting them apart unless same_w. Returns (the batched sweep's arguments, system 4's single sweep's)."""
    import numpy as np
    import torch

    from timemachine_torch.ops import rowscan_kernel as rs

    lists, systems = [], []
    for k in range(3):
        rng = np.random.default_rng(20 + k)
        pts = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1).reshape(-1, 3) * 0.31
        n = len(pts) - 7
        conf = torch.as_tensor(pts[:n] + rng.normal(0, 0.03, (n, 3)), device=dev, dtype=torch.float32)
        params = torch.as_tensor(np.stack([
            rng.uniform(-0.6, 0.6, n) * np.sqrt(138.935456), rng.uniform(0.05, 0.16, n), rng.uniform(0.05, 0.9, n) ** 0.5,
            rng.uniform(0.0, 0.2, n)], 1), device=dev, dtype=torch.float32)
        box = torch.eye(3, device=dev) * 16 * 0.31
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        mask[:9] = False
        tiles = rs.build_rowscan_tiles(conf, box, 1.3, 10**7, triangular=True, atom_mask=mask)
        lists.append(tiles)
        for s in range(3):
            c, prm = conf, params * (1.0 + 0.03 * s)
            if len(systems) == 4:
                c, prm = conf.clone(), prm.clone()
                c[10] = c[9] + torch.tensor([0.01, 0.0, 0.0], device=dev)
                prm[9:11, 1], prm[9:11, 2] = 0.15, 1.0
                if same_w:
                    prm[9:11, 3] = 0.0
            atoms = rs.assemble_atoms(c, box, tiles.pad_order, rs.param_rows(prm, tiles.pad_order, n, mask))
            row_count = rs.chop_row_counts(atoms[:, :3], tiles.rank_mat, tiles.row_count, box, 1.2)
            systems.append((atoms, tiles.row_start, row_count, tiles.col_ids, rs.sweep_scalars(box, 1.2)))
    series = rs.es_energy_force_series(2.0, 1.2)
    batched = (
        torch.stack([a for a, *_ in systems]), torch.stack([t.row_start for t in lists]),
        torch.stack([systems[3 * k][2] for k in range(3)]), torch.stack([t.col_ids for t in lists]),
        torch.arange(3, device=dev, dtype=torch.int32).repeat_interleave(3), torch.stack([sc for *_, sc in systems]), series,
    )
    return batched, (*systems[4], series)


def phase26(dev, smi, zero_counts, read_counts, kernel_row, dhfr, make_runner14, states13):
    """[26 fault 0] tests/test_torch_cuda.py's batched overflow case
    (ROADMAP §3 item 0): system 4's largest |dU/dx| and per-atom energy by
    the plain version, the kernel's NaN rows, bitwise its single launch;
    NaN everywhere where the sum leaves the fixed-point range, else within
    TOL_KERNEL_COL of plain. [26 slabs] The rowscan kernel's row slab at phase 4's relaxed DHFR in
    the spatial runner's form (Newton-triangular lists at cutoff + skin
    chopped to the cutoff, minimum image, w), F and U: D = 1, 2, 4 and 8
    slabs (the runner's split), their int64 accumulators summed before the
    store bitwise the whole-range launch, each slab's own output within
    TOL_KERNEL_COL per column of rowscan_sweep_plain's slab, each slab's
    device time by probes.queued_ms beside its bound (the pairs its row
    chunks own under the triangular lists: a pair goes to the chunk of its
    earlier slot) and its plain version's (CUDA events over 2 calls). [26 spatial] make_spatial_md_runner of DHFR (NVT) on a one-rank
    nccl mesh against a Context (the sorted step) of the same potentials
    and seed from the same start: the force at the start within
    TOL_FORCE_REL_NORM of the all-pairs force's norm; x's drift after
    N26_CMP steps within TOL_DRIFT_RATIO times a control's (the Context
    with its bonded terms summed in another order: the float32 drift of a
    reordered sum), after N26_STEPS printed; ms a step of each after
    N26_WARM steps, the runner's idle share over N26_PROFILE profiled steps,
    rowscan launches a step (one F slab; a list rebuild launches no sweep);
    a second run bitwise. [26 two ranks] the same runs over N26_RANKS gloo
    ranks sharing the card (spawned and joined here): the force at the start
    within TOL_FORCE_REL_NORM of one rank's, x's drift from the one-rank
    run after N26_CMP steps within TOL_DRIFT_RATIO times the control's,
    bitwise on repeat, each rank one slab launch a step. [26 hrex] run_hrex_sharded over phase 14's
    windows (a bare u_fn: the windows' summed potential, forces by autograd)
    and ReplicaExchangeRunner over them with a one-rank replica mesh against
    the same runner without one, N26_HREX_ITERS iterations of N26_HREX_STEPS
    steps: bitwise (frames, boxes, permutations, U_kl), the batched form's
    launches equal; then the device ms of what a rank of a replica mesh
    evaluates over the whole batch to keep that bitwise (the terms without
    a batched provider, forces by vmap, and the step's noise), over all K
    rows against the K / N26_SHARE rows a rank owns on an N26_SHARE-rank
    mesh."""
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from timemachine_torch.fe.terms import make_summed_potential
    from timemachine_torch.integrators import LangevinIntegrator
    from timemachine_torch.md.context import Context
    from timemachine_torch.ops import rowscan_kernel as rs
    from timemachine_torch.parallel.hrex_sharded import run_hrex_sharded
    from timemachine_torch.parallel.mesh import default_backend, make_mesh, spawn_ranks
    from timemachine_torch.parallel.replica_exchange import make_replica_mesh
    from timemachine_torch.parallel.spatial_md import make_spatial_md_runner
    from timemachine_torch.potentials import SKIN, NonbondedAllPairs
    from timemachine_torch.probes import queued_ms

    t_phase = time.perf_counter()
    bps, x_min, box, masses, v0 = dhfr["bps"], dhfr["x_min"], dhfr["box"], dhfr["masses"], dhfr["v0"]

    # -- [26 fault 0] ------------------------------------------------------------------------------------
    for same_w in (False, True):
        batched, single = _overlap_batch26(dev, same_w)
        parts = []
        for label, mode in (("F", rs.FORCE), ("U", rs.ENERGY)):
            out = rs.rowscan_sweep_batched(*batched, mode)[4]
            plain = rs.rowscan_sweep_batched_plain(*batched, mode)[4]
            col = 0 if mode == rs.ENERGY else slice(1, 4)
            nan_rows = int(torch.isnan(out).any(1).sum())
            same = torch.equal(out, rs.rowscan_sweep(*single, mode, triangular=True)) or bool(
                torch.isnan(out).all() and torch.isnan(rs.rowscan_sweep(*single, mode, triangular=True)).all())
            largest = float(plain[:, col].abs().max())
            expect_nan = same_w or mode == rs.FORCE
            rel = None
            if not expect_nan:
                rel = float(torch.linalg.vector_norm(out[:, 0] - plain[:, 0]) / torch.linalg.vector_norm(plain[:, 0]))
            parts.append(f"{label}: plain's largest |{'u_i' if mode == rs.ENERGY else 'dU/dx'}| {largest:.4e}, kernel NaN "
                         f"rows {nan_rows} of {out.shape[0]}, bitwise its single launch {same}"
                         + ("" if rel is None else f", energy column vs plain {rel:.3e}"))
            check(same and (nan_rows == out.shape[0] if expect_nan else nan_rows == 0 and rel <= TOL_KERNEL_COL),
                  f"[26] the batched sweep's overflow case disagrees (same_w {same_w}, {label})")
        print(f"[26 fault 0] the batched masked sweep's system 4, a pair 0.01 nm apart in xyz "
              + ("with equal w" if same_w else "lifted apart by w") + " (limit 2^30 = 1.0737e+09): " + "; ".join(parts)
              + f" ({smi})")
    nb = next(p for p in bps if hasattr(p, "exclusion_energy_force"))
    n = x_min.shape[0]

    # -- [26 slabs] ------------------------------------------------------------------------------------
    max_pairs = rs.suggest_max_pairs(x_min, box, nb.cutoff + SKIN, margin=1.4, triangular=True)
    tiles = rs.build_rowscan_tiles(x_min, box, nb.cutoff + SKIN, max_pairs, triangular=True)
    atoms = rs.assemble_atoms(x_min, box, tiles.pad_order, rs.param_rows(nb.params, tiles.pad_order, n))
    row_count = rs.chop_row_counts(atoms[:, :3], tiles.rank_mat, tiles.row_count, box, nb.cutoff)
    args = (atoms, tiles.row_start, row_count, tiles.col_ids, rs.sweep_scalars(box, nb.cutoff),
            rs.es_energy_force_series(nb.beta, nb.cutoff))
    n_rows = atoms.shape[0] // 32
    pairs = pairs_within_cutoff(x_min, box, nb.params[:, 3], nb.cutoff)
    pairs_by_row = pairs_by_row_chunk(x_min, box, nb.params[:, 3], nb.cutoff, tiles.pad_order, n_rows)
    check(int(pairs_by_row.sum()) == pairs, "[26] the row chunks' pairs do not sum to the sweep's")
    def plain_ms(fn, reps=2):
        """Device ms a call of a plain version by CUDA events over reps calls (after one)."""
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    slab_ms, slab_plain_ms, slab_bound_ms = {}, {}, {}
    for label, mode in (("F", rs.FORCE), ("U", rs.ENERGY)):
        whole = rs.rowscan_sweep(*args, mode, True)
        name = "rowscan_sweep_masked" if mode == rs.FORCE else "rowscan_sweep_batched_U"  # its function: minimum image, w
        whole_bound = bound(pair_ops(name, pairs), 0)[0]
        slab_ms[label], slab_plain_ms[label], slab_bound_ms[label] = {}, {}, {}
        for d in N26_SLABS:
            slabs = _slabs26(n_rows, d)
            accs, worst = [], 0.0
            for base, local in slabs:
                out = rs.rowscan_sweep(*args, mode, True, None, True, base, local, lambda a: accs.append(a.clone()))
                plain = rs.rowscan_sweep_plain(*args, mode, True, None, True, base, local)
                for col in range(4):
                    norm = float(torch.linalg.vector_norm(plain[:, col]))
                    if norm == 0:
                        check(not bool(out[:, col].any()), f"[26] slab column {col} not zero ({label}, D {d})")
                    else:
                        worst = max(worst, float(torch.linalg.vector_norm(out[:, col] - plain[:, col])) / norm)
            reduced = rs.rowscan_store_checked(torch.stack(accs).sum(0))
            same = torch.equal(reduced, whole)
            ms = [queued_ms(lambda b=base, l=local: rs.rowscan_sweep(*args, mode, True, None, True, b, l), 20)
                  for base, local in slabs]
            ms_plain = [plain_ms(lambda b=base, l=local: rs.rowscan_sweep_plain(*args, mode, True, None, True, b, l))
                        for base, local in slabs] if dev.type == "cuda" else [0.0] * len(slabs)
            # each slab's bound from its own pairs: a triangular row lists only later columns, so the slabs'
            # work falls from the first to the last; the bounds sum to the whole launch's
            slab_pairs = [int(pairs_by_row[base : base + local].sum()) for base, local in slabs]
            bounds = [bound(pair_ops(name, p), 0)[0] for p in slab_pairs]
            slab_ms[label][str(d)], slab_plain_ms[label][str(d)] = ms, ms_plain
            slab_bound_ms[label][str(d)] = bounds
            print(f"[26 slabs] DHFR {label}, D {d} ({len(slabs)} slabs of {slabs[0][1]}-{slabs[-1][1]} of {n_rows} row "
                  f"chunks): int64 sums reduced then stored bitwise the whole launch: {same}; worst slab column vs plain "
                  f"{worst:.3e} (tol {TOL_KERNEL_COL:g}); slab ms " + " ".join(f"{m:.4f}" for m in ms)
                  + f" (sum {sum(ms):.4f}); slab pairs " + " ".join(str(p) for p in slab_pairs)
                  + "; slab bound ms " + " ".join(f"{b:.5f}" for b in bounds)
                  + f" (sum {sum(bounds):.5f}, the whole launch's {whole_bound:.5f}); slab ms / bound "
                  + " ".join(f"{m / b:.1f}" for m, b in zip(ms, bounds)) + "; plain ms "
                  + " ".join(f"{m:.2f}" for m in ms_plain) + f" ({smi})")
            check(same, f"[26] {d} slabs reduced are not the whole launch ({label})")
            check(worst <= TOL_KERNEL_COL, f"[26] a slab disagrees with plain ({label}, D {d})")
    kernel_row.update(slab_ms=slab_ms, slab_plain_ms=slab_plain_ms, slab_bound_ms=slab_bound_ms)

    # -- [26 spatial] ----------------------------------------------------------------------------------
    mesh = make_mesh(dev, "spatial")
    backend = torch.distributed.get_backend(torch.distributed.group.WORLD)
    make_run = make_spatial_md_runner(bps, masses, mesh, conf0=x_min, box0=box)
    make_run(TEMP, DT, FRICTION, N26_WARM)(x_min, v0, box, N26_SEED)
    run = make_run(TEMP, DT, FRICTION, N26_STEPS)
    _sync26(dev)
    zero_counts()
    t0 = time.perf_counter()
    x_sp = run(x_min, v0, box, N26_SEED)[0]
    _sync26(dev)
    ms_sp = (time.perf_counter() - t0) * 1e3 / N26_STEPS
    counts, plain = read_counts()
    slabs_launched = rs.rowscan_sweep.launches_slabs
    kernel_row["launches_slabs"] = slabs_launched / N26_STEPS
    check(plain == 0 and counts["rowscan_sweep"] == slabs_launched == N26_STEPS,
          "[26] the spatial runner did not launch one rowscan slab a step")
    x_sp2 = run(x_min, v0, box, N26_SEED)[0]
    repeat = torch.equal(x_sp, x_sp2)

    def context_x(potentials, n_steps):
        ctx = Context(x_min, v0, box, LangevinIntegrator(TEMP, DT, FRICTION, masses, seed=N26_SEED), potentials,
                      device=dev)
        ctx.multiple_steps(n_steps)
        return ctx.get_x_t()

    # the force at the start: the runner's against the Context's, on the all-pairs force's scale
    f_sp = make_run.force(x_min, box)
    ctx0 = Context(x_min, v0, box, LangevinIntegrator(TEMP, DT, FRICTION, masses, seed=N26_SEED), bps, device=dev)
    with torch.no_grad():
        ctx0._ensure_lists()
        f_ctx = ctx0._force(x_min, box, 0)
    nb_ap = torch.linalg.vector_norm(NonbondedAllPairs.energy_force(nb, x_min, box)[1])
    f_rel = float(torch.linalg.vector_norm(f_sp - f_ctx) / nb_ap)
    # the drift: the runner and a control (the same Context's function with its bonded terms summed in another
    # order) against the Context, after N26_CMP and N26_STEPS steps from one start
    x_sp_cmp = make_run(TEMP, DT, FRICTION, N26_CMP)(x_min, v0, box, N26_SEED)[0].cpu().numpy()
    control = [bps[1], bps[0], *bps[2:]]
    x_ctx_cmp = context_x(bps, N26_CMP)
    dx_cmp = float(np.abs(x_sp_cmp - x_ctx_cmp).max())
    dx_ctrl_cmp = float(np.abs(context_x(control, N26_CMP) - x_ctx_cmp).max())
    x_ctx = context_x(bps, N26_STEPS)
    dx = float(np.abs(x_sp.cpu().numpy() - x_ctx).max())
    dx_ctrl = float(np.abs(context_x(control, N26_STEPS) - x_ctx).max())
    ctx = Context(x_min, v0, box, LangevinIntegrator(TEMP, DT, FRICTION, masses, seed=N26_SEED), bps, device=dev)
    ctx.multiple_steps(N26_WARM)
    _sync26(dev)
    t0 = time.perf_counter()
    ctx.multiple_steps(N26_STEPS)
    _sync26(dev)
    ms_ctx = (time.perf_counter() - t0) * 1e3 / N26_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        make_run(TEMP, DT, FRICTION, N26_PROFILE)(x_min, v0, box, N26_SEED)
        _sync26(dev)
    busy = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3 / N26_PROFILE
    print(f"[26 spatial] DHFR NVT, make_spatial_md_runner on a one-rank {backend} mesh: the force at the start vs the "
          f"Context's |diff| / |all-pairs force| {f_rel:.3e} (tol {TOL_FORCE_REL_NORM:g}); |x - Context x|max after "
          f"{N26_CMP} steps {dx_cmp:.3e} nm, the control's {dx_ctrl_cmp:.3e} (limit {TOL_DRIFT_RATIO:g} x the "
          f"control's; JAX's bound for a water box {TOL_SPATIAL_X:g}); after {N26_STEPS} {dx:.3e} nm, the control's {dx_ctrl:.3e}; {ms_sp:.4f} ms a step ({N26_STEPS} after "
          f"{N26_WARM}) against the Context's {ms_ctx:.4f} (host clock); device busy {busy:.4f} ms a step over "
          f"{N26_PROFILE} profiled steps, idle " + (f"{1 - busy / ms_sp:.3f}" if busy > 0 else "not measured")
          + f"; rowscan launches a step {counts['rowscan_sweep'] / N26_STEPS:.3f} (slabs {slabs_launched}); a second run "
          f"bitwise: {repeat} ({smi})")
    check(bool(torch.isfinite(x_sp).all()) and f_rel <= TOL_FORCE_REL_NORM, "[26] the spatial runner's force is not the Context's")
    check(dx_cmp <= TOL_DRIFT_RATIO * dx_ctrl_cmp,
          f"[26] the spatial runner drifts from the Context {dx_cmp:.3e} nm in {N26_CMP} steps, past "
          f"{TOL_DRIFT_RATIO:g} x the control's {dx_ctrl_cmp:.3e}")
    check(repeat, "[26] two spatial runs differ")

    # -- [26 two ranks] --------------------------------------------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, x0=x_min.cpu().numpy(), v0=np.asarray(v0), box=box.cpu().numpy(), masses=np.asarray(masses),
                 device=str(dev), n_steps=N26_STEPS, n_warm=N26_WARM, n_cmp=N26_CMP)
        spawn_ranks(_phase26_rank, N26_RANKS, (inputs, tmp), backend=default_backend(dev, N26_RANKS), store_dir=tmp)
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(N26_RANKS)]
    f2_rel = max(float(np.linalg.norm(r["force"] - f_sp.cpu().numpy())) for r in ranks) / float(nb_ap)
    dx2_cmp = max(float(np.abs(r["x_cmp"] - x_sp_cmp).max()) for r in ranks)
    dx2 = max(float(np.abs(r["x"] - x_sp.cpu().numpy()).max()) for r in ranks)
    same_ranks = all(np.array_equal(r["x"], ranks[0]["x"]) for r in ranks)
    repeat2 = all(np.array_equal(r["x"], r["x2"]) for r in ranks)
    launches2 = [r["launches"].tolist() for r in ranks]
    print(f"[26 two ranks] DHFR NVT over {N26_RANKS} {default_backend(dev, N26_RANKS)} ranks sharing the card: the force "
          f"at the start vs one rank's |diff| / |all-pairs force| {f2_rel:.3e} (tol {TOL_FORCE_REL_NORM:g}); |x - one-rank "
          f"x|max after {N26_CMP} steps {dx2_cmp:.3e} nm (limit {TOL_DRIFT_RATIO:g} x the control's {dx_ctrl_cmp:.3e}), after {N26_STEPS} {dx2:.3e} nm; every rank the same x: "
          f"{same_ranks}; bitwise on repeat: {repeat2}; rowscan launches (all, slabs) over {N26_STEPS} steps by rank "
          f"{launches2}; "
          + ", ".join(f"rank {k} {1e3 * float(r['seconds']) / N26_STEPS:.4f} ms a step" for k, r in enumerate(ranks))
          + f"; the leg took {time.perf_counter() - t0:.1f} s with the ranks' start ({smi})")
    check(f2_rel <= TOL_FORCE_REL_NORM and same_ranks and repeat2, "[26] the two-rank run disagrees")
    check(dx2_cmp <= TOL_DRIFT_RATIO * dx_ctrl_cmp,
          f"[26] two ranks drift from one {dx2_cmp:.3e} nm in {N26_CMP} steps, past {TOL_DRIFT_RATIO:g} x the control's")
    check(all(a == s == N26_STEPS for a, s in launches2), "[26] a rank did not launch one slab a step")

    # -- [26 hrex] ---------------------------------------------------------------------------------------
    rmesh = make_replica_mesh(dev)
    summed = make_summed_potential(states13[0].potentials)
    flat = np.stack([make_summed_potential(s.potentials).params.cpu().numpy() for s in states13])
    k = len(states13)
    zero_counts()
    t0 = time.perf_counter()
    res = run_hrex_sharded(
        lambda x, bx, p: summed.potential(x, p, bx), flat, np.stack([s.x0 for s in states13]),
        np.stack([s.v0 for s in states13]), np.stack([s.box0 for s in states13]), states13[0].integrator.masses,
        temperature=TEMP, dt=states13[0].integrator.dt, friction=FRICTION, n_iters=N26_HREX_ITERS,
        steps_per_iter=N26_HREX_STEPS, neighbor_pairs=[(i, i + 1) for i in range(k - 1)], n_swap_attempts_per_iter=k**3,
        seed=N26_SEED, mesh=rmesh, device=dev, dtype=torch.float32,
    )
    _sync26(dev)
    seconds = time.perf_counter() - t0
    counts, plain = read_counts()
    finite = bool(np.isfinite(res.frames).all() and np.isfinite(res.log_q_kl_by_iter).any(axis=-1).all())
    print(f"[26 hrex] run_hrex_sharded over phase 14's {k} windows on a one-rank mesh (u_fn the windows' summed "
          f"potential, forces by autograd), {N26_HREX_ITERS} iterations of {N26_HREX_STEPS} steps: frames finite "
          f"{finite}, swaps accepted {int(res.accepted_by_pair_by_iter.sum())} of {int(res.proposed_by_pair_by_iter.sum())}, "
          f"{seconds:.1f} s; launches {dict((c, v) for c, v in counts.items() if v)}, plain calls {plain} ({smi})")
    check(finite and plain == 0, "[26] run_hrex_sharded over the windows failed")

    results, launches = {}, {}
    for label, m in (("no mesh", None), ("one-rank mesh", rmesh)):
        runner = make_runner14(k, mesh=m)
        zero_counts()
        results[label] = [runner.advance_frame(N26_HREX_STEPS) for _ in range(N26_HREX_ITERS)]
        _sync26(dev)
        launches[label] = read_counts()[0]["rowscan_sweep_batched"]
    same = all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for a, b in zip(*results.values())
        for f in ("frames_by_state", "boxes_by_state", "replica_idx_by_state", "accepted_by_pair", "U_kl")
    )
    print(f"[26 hrex] ReplicaExchangeRunner over the {k} windows, {N26_HREX_ITERS} iterations of {N26_HREX_STEPS} "
          f"steps, with a one-rank replica mesh against without: bitwise {same}; batched launches "
          + ", ".join(f"{lbl} {v}" for lbl, v in launches.items()) + f" ({smi})")
    check(same and len(set(launches.values())) == 1, "[26] the replica mesh's run is not the no-mesh run")

    # what a rank of a replica mesh evaluates over the whole batch (BatchedContext draw_rows): the terms without a
    # batched provider and the step's noise, over all K rows against the K / N26_SHARE rows it owns
    batch = runner.batch
    closed = [i for i in range(len(batch.potentials)) if i not in batch._providers]
    x_b, box_b = batch._x, batch._box

    def replicated(rows):
        for i in closed:
            batch._u_force[i](x_b[rows], batch._params[i][rows], box_b[rows])
        torch.randn(x_b[rows].shape, generator=batch._noise, device=dev, dtype=x_b.dtype)

    share = slice(0, k // N26_SHARE)
    with torch.no_grad():
        ms_whole, ms_share = ((plain_ms(lambda: replicated(slice(None)), 20), plain_ms(lambda: replicated(share), 20))
                              if dev.type == "cuda" else (float("nan"), float("nan")))
    print(f"[26 hrex] what a replica-mesh rank evaluates over the whole batch to step bitwise as the no-mesh run "
          f"({len(closed)} terms without a batched provider, forces by vmap, and the step's noise): {ms_whole:.4f} ms "
          f"a step over the {k} rows against {ms_share:.4f} ms over the {k // N26_SHARE} a rank of {N26_SHARE} owns "
          f"(CUDA events over 20 calls) ({smi})")
    torch.distributed.destroy_process_group()  # the one-rank group the meshes above made
    print(f"[26 time] phase 26 took {time.perf_counter() - t_phase:.1f} s, host clock ({smi})")


def _waters_inside(x, box, ligand_idxs, water_idxs, radius) -> int:
    """Waters whose centroid lies within radius of the ligand's centroid (the sampler's inner region)."""
    import numpy as np

    center = np.mean(x[ligand_idxs], axis=0)
    d = np.mean(x[water_idxs], axis=1) - center
    d -= np.diag(box) * np.floor(d / np.diag(box) + 0.5)
    return int(np.sum(np.linalg.norm(d, axis=-1) < radius))


# phases 16, 19, 21 and 22 run in a second process (the worker) beside phases 20 and 18 of main(): all are
# host-bound legs that leave the card idle most of the time, and one after another they took the script
# past its time on a slow host. The longest either process waits for the other, in seconds
WORKER_WAIT_S = 1_100


def put_handoff(handoff: str, name: str, obj) -> None:
    """Pickle obj under name in the handoff directory, whole or not at all."""
    tmp = os.path.join(handoff, f"{name}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, os.path.join(handoff, f"{name}.pkl"))


def take_handoff(handoff: str, name: str, alive):
    """What the other process put under name, waited for while alive() holds."""
    path = os.path.join(handoff, f"{name}.pkl")
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if not alive() and not os.path.exists(path):
            if os.path.exists(os.path.join(handoff, "err.log")):
                dump_worker_logs(handoff)
            check(False, f"[worker] the other process ended without handing over {name}")
        check(time.perf_counter() - t0 < WORKER_WAIT_S, f"[worker] no {name} after {WORKER_WAIT_S} s")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def dump_worker_logs(handoff: str) -> None:
    """The worker's standard output to ours, its standard error to ours."""
    for log, stream in (("out.log", sys.stdout), ("err.log", sys.stderr)):
        with open(os.path.join(handoff, log), encoding="utf-8", errors="replace") as f:
            stream.write(f.read())
        stream.flush()


def start_worker(exact_ms: float):
    """(process, handoff directory) of `chip_smoke.py --worker DIR T_START EXACT_MS`: worker() with this
    script's start time and phase 17's exact-form time; its output goes to files in the directory. The
    process is stopped and the directory removed when this one exits."""
    import tempfile

    handoff = tempfile.mkdtemp(prefix="chip_smoke_worker_")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.stdout.flush()
    with open(os.path.join(handoff, "out.log"), "wb") as out, open(os.path.join(handoff, "err.log"), "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), "--worker", handoff, repr(T_START), repr(exact_ms)],
            stdout=out, stderr=err, cwd=here,
        )

    def stop():
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        shutil.rmtree(handoff, ignore_errors=True)

    atexit.register(stop)
    print(f"[worker] phases 16, 19, 21 and 22 in process {proc.pid}, beside phases 20 and 18 here; their lines follow "
          "phase 18's")
    return proc, handoff


def finish_worker(proc, handoff: str) -> dict:
    """Wait for the worker, print its output and return what its phases added: {"rows": {"masked", "batched",
    "exact": {key: value}}, "plots": {estimator: plots}}."""
    t0 = time.perf_counter()
    try:
        rc = proc.wait(WORKER_WAIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    dump_worker_logs(handoff)
    print(f"[worker] ended with code {rc}, {time.perf_counter() - t0:.1f} s after phase 24, the last before it in this process (host clock)")
    check(rc == 0, f"[worker] phases 16, 19, 21 and 22 failed or outlasted {WORKER_WAIT_S} s (code {rc})")
    return take_handoff(handoff, "added", lambda: False)


def worker(handoff: str, exact_ms: float) -> int:
    """Phases 16, 19, 21 and 22 and phase 24's dense examples, as main() runs them in a second process: hands phase 16's inputs to main()
    for phase 18, and what the phases add to the kernels line's rows and the estimators' plots back at its
    end. Every count it reads is its own process's, zeroed by each phase just before its path runs."""
    import torch

    from timemachine_torch.ops import _build
    from timemachine_torch.testsystems.dhfr import setup_dhfr_native

    parent = os.getppid()
    ctypes.CDLL(None, use_errno=True).prctl(1, 15)  # PR_SET_PDEATHSIG, SIGTERM: end with main()
    _build.load_libraries(*_build.LIBRARIES)  # built by main(): loaded, not compiled again
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line()
    rows = {"masked": {}, "batched": {}, "exact": {}}
    launches16, exact16, inputs16, host16 = phase16(dev, smi, zero_counts, read_counts, rows["masked"], rows["batched"])
    check(os.getppid() == parent, "[worker] main() ended")
    put_handoff(handoff, "inputs16", inputs16)
    rows["exact"].update(launches=launches16["nb_tiles"], launches_by_stage_run_solvent=exact16)
    phase19(dev, smi, zero_counts, read_counts, rows["masked"], rows["exact"])
    hc = setup_dhfr_native(waters_first=True, device=dev, dtype=torch.float32)
    rows["exact"]["ms"] = exact_ms  # phase 21 prints its chain's sweep against phase 17's
    phase21(dev, smi, zero_counts, read_counts, rows["exact"], inputs16, host16, hc)
    del rows["exact"]["ms"]
    phase22(dev, smi, zero_counts, read_counts, rows["masked"], rows["batched"], rows["exact"], inputs16)
    phase24_dense(dev, smi)
    put_handoff(handoff, "added", {"rows": rows, "plots": PLOTS_SEEN})
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from timemachine_torch.constants import BOLTZ
    from timemachine_torch.fe import free_energy as fe13
    from timemachine_torch.fe.free_energy import HREXParams, MDParams, configure_all_pairs, get_context
    from timemachine_torch.fe.loss import pseudo_huber_loss
    from timemachine_torch.fe.model_utils import apply_hmr
    from timemachine_torch.fe.reweighting import construct_mixture_reweighting_estimator
    from timemachine_torch.integrators import LangevinIntegrator
    from timemachine_torch.md.barostat import MonteCarloBarostat
    from timemachine_torch.md.context import Context
    from timemachine_torch.md.fire import FireMinimizationConfig, fire_minimize
    from timemachine_torch.md.utils import sample_velocities
    from timemachine_torch.ops import _build
    from timemachine_torch.ops import dotscan_kernel as dk
    from timemachine_torch.ops import gather_kernel as gk
    from timemachine_torch.ops import nonbonded_kernel as nbk
    from timemachine_torch.ops import quadscan_kernel as qk
    from timemachine_torch.ops import rowscan_kernel as rs
    from timemachine_torch.parallel.replica_exchange import ReplicaExchangeRunner
    from timemachine_torch.potentials import DP_CB, SKIN, Nonbonded, NonbondedAllPairs
    from timemachine_torch.probes import bf16_rate as br
    from timemachine_torch.probes import fp32_peak as fp
    from timemachine_torch.probes import queued_ms
    from timemachine_torch.probes import tile_census as tc
    from timemachine_torch.testsystems.dhfr import setup_dhfr_native
    from timemachine_torch.ff.handlers import AM1ELF10_CHARGE_CACHE, GASTEIGER_CHARGE_CACHE
    from timemachine_torch.probes.am1_host import blas_kernels
    from timemachine_torch.testsystems.rbfe_solvent import build_differences, build_rbfe_solvent, load_rbfe_solvent, term_differences
    from timemachine_torch.testsystems.rbfe_solvent import load_arrays as rbfe_cache_arrays
    from timemachine_torch.testsystems.rbfe_solvent import metadata as rbfe_cache_metadata

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # -- 1. device ------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = card_line()
    print(f"[1 device] {name}, count {count}, nvidia-smi: {smi}, torch {torch.__version__}, cuda {torch.version.cuda}")

    clock = [time.perf_counter()]

    def phase_time(label):
        """Print the host seconds since the last call (the script's start for the first)."""
        now = time.perf_counter()
        print(f"[{label} time] phase {label} took {now - clock[0]:.1f} s, host clock ({smi})")
        clock[0] = now

    clock[0] = T_START

    # -- 2. kernel build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_libraries(*_build.LIBRARIES)
    t_build = time.perf_counter() - t0
    for lib in _build.LIBRARIES:
        log = _build.build_log(lib).splitlines()
        ptxas = [ln.strip() for ln in log[1:] if "registers" in ln or "spill" in ln]
        print(f"[2 build] {lib}: {log[0]} | " + " | ".join(ptxas))
    print(f"[2 build] {len(_build.LIBRARIES)} libraries in {t_build:.1f} s, one nvcc each, in parallel ({smi})")

    phase_time("1-2")

    # -- 3. kernel vs plain at DHFR shapes -------------------------------------------
    hc = setup_dhfr_native(waters_first=True, device=dev, dtype=f32)
    bps = hc.host_system.get_U_fns()
    nb = hc.host_system.nonbonded_all_pairs
    x0 = torch.as_tensor(hc.conf, device=dev, dtype=f32)
    box = torch.as_tensor(hc.box, device=dev, dtype=f32)
    has_w = bool((nb.params[:, 3] != 0).any())  # bench.py's rowscan_has_w: False for DHFR
    nb.configure(box, x0, rowscan_has_w=has_w)
    n = x0.shape[0]
    state = nb.md_force_provider()[0](x0, box)
    tiles = state.lists
    check(nb.md_preshift, "DHFR configured without preshift (the image bound at cutoff + skin)")
    check(int(state.invalid) == 0, "main-path lists invalid at DHFR (overflow, the image bound or a nonzero w)")
    atoms = rs.assemble_atoms(x0, box, tiles.pad_order, state.prows)
    row_count = rs.chop_row_counts(atoms[:, :3], tiles.rank_mat, tiles.row_count, box, nb.cutoff)
    series = rs.es_energy_force_series(nb.beta, nb.cutoff)
    scalars = rs.sweep_scalars(box, nb.cutoff)
    main_form = dict(triangular=True, rcen_q=tiles.rcen_q, has_w=has_w)
    sweep_args = (atoms, tiles.row_start, row_count, tiles.col_ids, scalars, series)
    n_rows = tiles.row_start.shape[0]
    slots = (int(row_count.sum()) + n_rows) * rs.ROW * rs.COL  # the covering tiles are swept too
    # the yardstick: the symmetric form (per-pair minimum image, w) on the same sort
    list_cut = nb.cutoff + SKIN
    sym = rs.build_rowscan_tiles(
        x0, box, list_cut, rs.suggest_max_pairs(x0, box, list_cut, cell_size=nb.md_cell_size), nb.md_cell_size
    )
    check(int(sym.overflow) == 0 and torch.equal(sym.pad_order, tiles.pad_order), "symmetric lists at DHFR")
    sym_count = rs.chop_row_counts(atoms[:, :3], sym.rank_mat, sym.row_count, box, nb.cutoff)
    sym_args = (atoms, sym.row_start, sym_count, sym.col_ids, scalars, series)
    sym_slots = int(sym_count.sum()) * rs.ROW * rs.COL
    print(
        f"[3 shapes] N {n}, Npad {atoms.shape[0]}, row chunks {n_rows}, cell {nb.md_cell_size} nm; main form "
        f"(triangular, preshift {nb.md_preshift}, has_w {has_w}): max_pairs {nb.md_max_pairs}, listed tiles "
        f"{int(tiles.row_count.sum())}, swept slots/step {slots} with the covering tiles, image-bound margin "
        f"{float(tiles.margin):.4f} nm; symmetric: listed tiles {int(sym.row_count.sum())}, swept slots/step "
        f"{sym_slots} ({smi})"
    )

    def cuda_ms(fn, reps):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    w0 = nb.params[:, 3].to(f32)
    pairs_x0 = pairs_within_cutoff(x0, box, w0, nb.cutoff)
    print(
        f"[3 bound] pairs within the cutoff at the DHFR start, each once: {pairs_x0}; main form: slots / pairs "
        f"{slots / pairs_x0:.2f}, F-mode bound over pairs {bound(pair_ops('rowscan_sweep', pairs_x0), 0)[0]:.4f} ms, "
        f"over its swept slots {bound(pair_ops('rowscan_sweep', slots), 0)[0]:.4f} ms "
        f"({FLOPS_PER_PAIR['rowscan_sweep']} per pair); symmetric: slots / pairs {sym_slots / pairs_x0:.2f}, "
        f"over pair visits {bound(pair_ops('rowscan_symmetric', sym_slots // 2), 0)[0]:.4f} ms "
        f"({FLOPS_PER_PAIR['rowscan_symmetric']} per pair; each pair swept twice); FP32 peak {PEAK_FP32:.3g}/s ({smi})"
    )

    def kernel_entry(name, source, replaces, max_abs_err, ms, plain_ms, pairs, nbytes, ops=None, peak=PEAK_FP32):
        """One row of the kernels JSON line, bound by the pairs' operations
        (or `ops` at `peak`); launches are filled in by the kernel's path."""
        bound_ms, bound_by = bound(pair_ops(name, pairs) if ops is None else ops, nbytes, peak)
        return {
            "name": name, "route": "cuda", "source": f"timemachine_torch/csrc/{source}",
            "replaces": replaces if "/" in replaces else f"timemachine_tpu/ops/pallas/{replaces}", "launches": 0,
            "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a cutoff pair sweep
            "library_ms": None,
        }

    def compare_kernel(tag, calls):
        """Kernel against plain for each (label, kernel(), plain()) at one
        set of inputs: per-column relative norm, two launches bitwise equal,
        the kernel's device ms over 20 launches queued behind a spin kernel
        (probes.queued_ms: a busy host cannot stretch them) and ms over 2
        plain calls. Returns the first's (max_abs,
        ms, plain_ms)."""
        first = None
        for label, kernel, plain in calls:
            out_k, out_k2, out_p = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out_k).all()), f"[{tag}] kernel output not finite in mode {label}")
            rels = []
            for col in range(out_p.shape[1]):
                norm = float(torch.linalg.vector_norm(out_p[:, col]))
                if norm == 0:  # F mode's energy column, dU/dw at w = 0
                    check(not bool(out_k[:, col].any()), f"[{tag}] kernel column {col} not zero in mode {label}")
                    rels.append(0.0)
                else:
                    rels.append(float(torch.linalg.vector_norm(out_k[:, col] - out_p[:, col])) / norm)
            max_abs = float((out_k - out_p).abs().max())
            same = torch.equal(out_k, out_k2)
            ms = queued_ms(kernel, 20)
            plain_ms = cuda_ms(plain, 2)
            print(
                f"[{tag} kernel {label}] rel_norm per column " + " ".join(f"{r:.3e}" for r in rels)
                + f" (tol {TOL_KERNEL_COL:g}); max_abs {max_abs:.3e} of max |out| {float(out_p.abs().max()):.3e}; "
                f"two launches bitwise equal: {same}; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms ({smi})"
            )
            check(max(rels) <= TOL_KERNEL_COL, f"[{tag}] kernel disagrees with plain in mode {label}")
            check(same, f"[{tag}] two launches differ in mode {label}")
            first = first or (max_abs, ms, plain_ms)
        return first

    err3, ms3, plain3 = compare_kernel("3", [
        (f"main form {label}", lambda m=mode: rs.rowscan_sweep(*sweep_args, m, **main_form),
         lambda m=mode: rs.rowscan_sweep_plain(*sweep_args, m, **main_form))
        for label, mode in (("F", rs.FORCE), ("U", rs.ENERGY))
    ])
    # the energy/force entry's form (FIRE, the training forward): triangular, minimum image, w
    compare_kernel("3", [
        ("energy/force form F+U", lambda: rs.rowscan_sweep(*sweep_args, rs.FORCE_ENERGY, triangular=True),
         lambda: rs.rowscan_sweep_plain(*sweep_args, rs.FORCE_ENERGY, triangular=True))
    ])
    _, ms_sym, _ = compare_kernel("3", [
        ("symmetric F", lambda: rs.rowscan_sweep(*sym_args, rs.FORCE), lambda: rs.rowscan_sweep_plain(*sym_args, rs.FORCE))
    ])
    print(
        f"[3 redesign] main form F {ms3:.4f} ms over {slots} slots ({slots / ms3 / 1e6:.1f}G slots/s), symmetric F "
        f"{ms_sym:.4f} ms over {sym_slots} slots ({sym_slots / ms_sym / 1e6:.1f}G slots/s); ratio {ms3 / ms_sym:.3f} "
        f"(want <= {REDESIGN_RATIO}) ({smi})"
    )
    check(ms3 <= REDESIGN_RATIO * ms_sym, "the main form's F sweep is not enough faster than the symmetric form's")
    kernel_row = kernel_entry(
        "rowscan_sweep", "rowscan.cu", "rowscan_kernel.py:111", err3, ms3, plain3, pairs_x0,
        tensor_bytes(atoms, tiles.row_start, row_count, tiles.rcen_q) + 4 * int(row_count.sum()) + 16 * atoms.shape[0],
    )

    # the main form's MD force (all pairs through the kernel, minus the
    # exclusions) against the symmetric form's on the all-pairs scale
    inv = torch.argsort(tiles.pad_order[:n])
    f_sym_ap = -rs.rowscan_sweep(*sym_args, rs.FORCE)[inv, 1:4]
    f_sym = f_sym_ap + nb.exclusion_energy_force(x0, box)[1]
    f_main = nb.md_force_provider()[1](state, x0, box, 1)[0]
    main_rel = float(torch.linalg.vector_norm(f_main - f_sym) / torch.linalg.vector_norm(f_sym_ap))
    print(f"[3 force] MD provider, main form vs symmetric form: net nonbonded force |diff| / |all-pairs force| "
          f"{main_rel:.3e} (tol {TOL_ALT_FORCE:g}; {smi})")
    check(main_rel <= TOL_ALT_FORCE, "the main form's MD force disagrees with the symmetric form's")

    hc_cpu = setup_dhfr_native(waters_first=True, device="cpu", dtype=f32)
    hc_cpu.host_system.nonbonded_all_pairs.configure(box.cpu(), x0.cpu(), rowscan_has_w=has_w)
    f_card = sum(p.energy_force(x0, box)[1] for p in bps)
    f_host = sum(p.energy_force(x0.cpu(), box.cpu())[1] for p in hc_cpu.host_system.get_U_fns())
    f_all_pairs = NonbondedAllPairs.energy_force(nb, x0, box)[1]
    f_err = float(torch.linalg.vector_norm(f_card.cpu() - f_host))
    f_rel = f_err / float(torch.linalg.vector_norm(f_all_pairs))
    print(
        f"[3 slice] total force, card vs host CPU: |diff| / |all-pairs force| {f_rel:.3e} "
        f"(tol {TOL_FORCE_REL_NORM:g}); |diff| / |total force| {f_err / float(torch.linalg.vector_norm(f_host)):.3e} ({smi})"
    )
    check(f_rel <= TOL_FORCE_REL_NORM, "total force on the card disagrees with the host CPU")

    phase_time("3")

    # -- 4. main path -----------------------------------------------------------------
    masses = apply_hmr(hc.masses, hc.host_system.bond.idxs.cpu().numpy())
    t0 = time.perf_counter()
    x_min = fire_minimize(x0, lambda x: sum(p.energy_force(x, box)[1] for p in bps), FireMinimizationConfig(N_FIRE))
    torch.cuda.synchronize()
    t_fire = time.perf_counter() - t0
    check(bool(torch.isfinite(x_min).all()), "FIRE produced non-finite coordinates")
    intg = LangevinIntegrator(TEMP, DT, FRICTION, masses, seed=2026)
    v0 = sample_velocities(masses, TEMP, seed=2028)

    def make_context(potentials=bps):
        baro = MonteCarloBarostat(n, PRESSURE, TEMP, hc.group_idxs, BAROSTAT_INTERVAL, seed=2027)
        return Context(x_min, v0, box, intg, potentials, movers=[baro], device=dev)

    def bitwise_repeat(tag, potentials):
        a, b = make_context(potentials), make_context(potentials)
        a.multiple_steps(N_DET)
        b.multiple_steps(N_DET)
        same = all(np.array_equal(p, q) for p, q in ((a.get_x_t(), b.get_x_t()), (a.get_v_t(), b.get_v_t()), (a.get_box(), b.get_box())))
        print(f"[{tag} determinism] two fresh Contexts, {N_DET} steps: x, v, box bitwise equal: {same} ({smi})")
        check(same, f"[{tag}] two identical runs differ")

    zero_counts()
    ctxt = make_context()
    ctxt.multiple_steps(N_STEPS)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctxt.multiple_steps(N_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches4, plain_calls = read_counts()
    launches = launches4["rowscan_sweep"]
    ns_per_day = N_STEPS * DT / 1000.0 / elapsed * 86_400.0
    baro_state = ctxt.get_mover_states()[0]
    attempted, accepted = int(baro_state.total_attempted), int(baro_state.total_accepted)
    x_end = torch.as_tensor(ctxt.get_x_t(), device=dev)
    box_end = torch.as_tensor(ctxt.get_box(), device=dev)
    u_end = float(sum(p.energy(x_end, box_end) for p in bps))
    print(
        f"[4 main path] DHFR NPT {n} atoms: {ns_per_day:.2f} ns/day ({elapsed * 1e3 / N_STEPS:.4f} ms/step over "
        f"{N_STEPS} steps; {smi}); FIRE {N_FIRE} steps {t_fire:.2f} s; barostat {accepted}/{attempted} "
        f"accepted; box {box_end[0, 0].item():.4f} nm; U {u_end:.2f} kJ/mol; kernel launches in the "
        f"{2 * N_STEPS} NPT steps {launches} ({launches / (2 * N_STEPS):.3f} per step), plain sweeps {plain_calls}"
    )
    check(bool(torch.isfinite(x_end).all() and torch.isfinite(box_end).all()), "coordinates or box not finite")
    check(np.isfinite(u_end), "final energy not finite")
    check(attempted == 2 * N_STEPS // BAROSTAT_INTERVAL, f"barostat attempted {attempted} moves")
    check(accepted >= 1, "barostat accepted no move")
    min_launches = 2 * N_STEPS + 2 * attempted
    check(launches >= min_launches, f"kernel launched {launches} times, want >= {min_launches}")
    check(plain_calls == 0, "the main path ran the plain sweep")
    kernel_row["launches"] = launches / (2 * N_STEPS)
    kernel_row["path"] = "DHFR NPT, the main path (per step)"

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ctxt.multiple_steps(N_PROFILE)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3 / N_PROFILE
    table = events.table(sort_by="cuda_time_total", row_limit=30)
    print(f"{smi}; {N_PROFILE} NPT steps of DHFR\n{table}", file=sys.stderr)
    step_ms = elapsed * 1e3 / N_STEPS
    busy = (
        f"device busy {busy_ms:.4f} ms/step, {1 - busy_ms / step_ms:.3f} of the unprofiled step idle"
        if busy_ms > 0 else "device busy not measured (the profiler saw no device time)"
    )
    print(f"[4 profile] {N_PROFILE} steps: {busy} ({smi}); table on stderr")

    # the end state: lists and row centers rebuilt there, and the main form's
    # |dU/dx| (row sums and reactions in int64 fixed point) against its range
    state_end = nb.md_force_provider()[0](x_end, box_end)
    t_end = state_end.lists
    check(int(state_end.invalid) == 0, "[4] main-path lists invalid at the end state (overflow, the image bound or w)")
    atoms_end = rs.assemble_atoms(x_end, box_end, t_end.pad_order, state_end.prows)
    count_end = rs.chop_row_counts(atoms_end[:, :3], t_end.rank_mat, t_end.row_count, box_end, nb.cutoff)
    end_args = (atoms_end, t_end.row_start, count_end, t_end.col_ids, rs.sweep_scalars(box_end, nb.cutoff), series)
    end_form = dict(triangular=True, rcen_q=t_end.rcen_q, has_w=has_w)
    grad_end = max(
        float(rs.rowscan_sweep(*end_args, rs.FORCE, **end_form)[:, 1:4].abs().max()),
        float(NonbondedAllPairs.energy_force(nb, x_end, box_end)[1].abs().max()),
    )
    ms_end = queued_ms(lambda: rs.rowscan_sweep(*end_args, rs.FORCE, **end_form), 20)
    print(
        f"[4 invariant] image-bound margin at cutoff + skin: {float(tiles.margin):.4f} nm at the start, "
        f"{float(t_end.margin):.4f} nm at the end; largest |dU/dx| {grad_end:.4e} of the kernel's fixed-point "
        f"limit {nbk.FIX_LIMIT:.4e} kJ/mol/nm (NaN beyond); main form F at the end state {ms_end:.4f} ms over "
        f"{(int(count_end.sum()) + n_rows) * rs.ROW * rs.COL} slots ({smi})"
    )
    check(grad_end < nbk.FIX_LIMIT, "[4] |dU/dx| beyond the kernel's fixed-point limit")

    # -- 5. determinism -----------------------------------------------------------------
    bitwise_repeat("5", bps)

    phase_time("4-5")

    # -- 6. block-tile kernel vs plain at DHFR shapes ----------------------------------
    # the triangular form (every path's) and the symmetric form (the first design) on the same sort
    tri6 = nbk.build_block_tiles(x0, nb.params, box, nb.cutoff, nb.dp_max_tiles, DP_CB, triangular=True)
    sym6 = nbk.build_block_tiles(x0, nb.params, box, nb.cutoff, nbk.suggest_max_tiles(x0, box, nb.cutoff, cb=DP_CB), DP_CB)
    check(int(tri6.overflow) == 0 and int(sym6.overflow) == 0, "block-tile list overflow at DHFR")
    check(torch.equal(tri6.pad_order, sym6.pad_order), "the two block-tile forms sort differently")
    scal6 = nbk.tile_scalars(box, nb.beta, nb.cutoff)
    forms6 = {"triangular": tri6, "symmetric": sym6}

    def nb_args(form):
        t = forms6[form]
        return t.atoms, t.row_start, t.row_count, t.col_ids, scal6

    n_tiles = int(tri6.row_count.sum())
    census6 = nbk.cull_census(*nb_args("triangular")[:4], box, nb.cutoff, DP_CB)
    sym_slots6 = int(sym6.row_count.sum()) * nbk.BLOCK * nbk.BLOCK * DP_CB
    print(
        f"[6 shapes] Npad {tri6.atoms.shape[0]}, row blocks {tri6.row_start.shape[0]}, cb {DP_CB}; triangular: listed "
        f"tiles {n_tiles} of capacity {nb.dp_max_tiles}, pair slots listed {census6.listed}, in 32 x 32 sub-tiles "
        f"not below the diagonal {census6.upper}, kept by the sub-tile cull {census6.subtiles}, by the column cull "
        f"{census6.columns}, swept in chunks of 32 columns {census6.swept}; symmetric: listed tiles "
        f"{int(sym6.row_count.sum())}, pair slots {sym_slots6}; pairs within the cutoff {pairs_x0} ({smi})"
    )
    poly = nbk.es_switch_poly_coeffs(nb.beta, nb.cutoff)
    # DP runs A&S 7.1.26, the form the training path's du/dp pass launches (run_dp's
    # default, phase 7); DP-erfc is kernel="v1"'s du/dp pass, the exact modes its UF and F
    modes6 = (("DP", nbk.DP, nbk.AS7126), ("DP-erfc", nbk.DP, None), ("UF-exact", nbk.UF, None),
              ("UF-poly", nbk.UF, poly), ("F", nbk.FORCE, None))
    res6 = {}
    for form in ("triangular", "symmetric"):
        for label, mode, es in modes6:
            if form == "symmetric" and label not in ("DP", "F"):
                continue  # the first design is kept in DP and F only
            tri = form == "triangular"
            res6[form, label] = compare_kernel("6", [(
                f"{form} {label}",
                lambda m=mode, e=es, f=form, t=tri: nbk.nb_tiles(*nb_args(f), m, DP_CB, e, triangular=t),
                lambda m=mode, e=es, f=form, t=tri: nbk.nb_tiles_plain(*nb_args(f), m, DP_CB, e, triangular=t),
            )])
    err6, ms6, plain6 = res6["triangular", "DP"]
    nb_row = kernel_entry(
        "nb_tiles", "nb_tiles.cu", "nonbonded_kernel.py:213", err6, ms6, plain6, pairs_x0,
        tensor_bytes(tri6.atoms, tri6.row_start, tri6.row_count) + 4 * n_tiles + 16 * tri6.atoms.shape[0],
    )
    nb_row["ms_by_form_and_mode"] = {f"{form} {label}": r[1] for (form, label), r in res6.items()}
    print(
        f"[6 bound] DP mode: bound over pairs {nb_row['bound_ms']:.4f} ms, over the slots the culls keep "
        f"{bound(pair_ops('nb_tiles', census6.columns), 0)[0]:.4f} ms, over the slots the triangular kernel "
        f"sweeps {bound(pair_ops('nb_tiles', census6.swept), 0)[0]:.4f} ms, over the symmetric pair visits "
        f"{bound(pair_ops('nb_tiles', sym_slots6 // 2), 0)[0]:.4f} ms (each pair swept twice); triangular DP "
        f"{census6.swept / ms6 / 1e6:.1f}G swept slots/s ({smi})"
    )
    ratios6 = {label: res6["triangular", label][1] / res6["symmetric", label][1] for label in ("DP", "F")}
    print(
        "[6 redesign] triangular / symmetric, same run: "
        + ", ".join(f"{label} {res6['triangular', label][1]:.4f} / {res6['symmetric', label][1]:.4f} ms = {r:.3f}"
                    for label, r in ratios6.items())
        + f" (want <= {NB_REDESIGN_RATIO}) ({smi})"
    )
    check(max(ratios6.values()) <= NB_REDESIGN_RATIO, "the triangular block-tile sweep is not enough faster")
    dp6 = nbk.nb_tiles(*nb_args("triangular"), nbk.DP, DP_CB, triangular=True).abs().amax(0).tolist()
    print(
        f"[6 range] largest |DP column| at DHFR: dU/dq {dp6[0]:.4e}, dU/d(sig/2) {dp6[1]:.4e}, dU/d sqrt(eps) "
        f"{dp6[2]:.4e}, dU/dw {dp6[3]:.4e}; the kernel's limit {nbk.FIX_LIMIT:.4e} (NaN beyond), the "
        f"fixed-point range {2.0**63 / rs.FIXED_SCALE:.4e} ({smi})"
    )
    check(max(dp6) < nbk.FIX_LIMIT, "[6] a DP column beyond the fixed-point limit")

    phase_time("6")

    # -- 7. du/dp training ----------------------------------------------------------------
    frames, frame_boxes = ctxt.multiple_steps(N_FRAMES * FRAME_INTERVAL, store_x_interval=FRAME_INTERVAL)
    samples = [(torch.as_tensor(f, device=dev), torch.as_tensor(b, device=dev)) for f, b in zip(frames, frame_boxes)]
    protein = torch.arange(n, device=dev) >= hc.num_water_atoms
    q0 = nb.params[:, 0]
    kT = BOLTZ * TEMP

    def params_of(s):
        """nb params with the protein's charges scaled by s."""
        return torch.cat([torch.where(protein, q0 * s, q0)[:, None], nb.params[:, 1:]], dim=1)

    def batched_u(smp, s):
        p = params_of(s)
        return torch.stack([nb.u(x, p, b) for x, b in smp]) / kT

    with torch.no_grad():
        u_ref = batched_u(samples, torch.ones((), device=dev))
    estimator = construct_mixture_reweighting_estimator(samples, u_ref, lambda smp, s: u_ref, batched_u)

    def loss_of(delta_f):
        return pseudo_huber_loss(kT * delta_f - 0.0)

    s0 = torch.tensor(S_START, device=dev, requires_grad=True)
    (g_kernel,) = torch.autograd.grad(loss_of(estimator(s0)), s0)
    # the same dL/ds with the DP pass on the plain version, by the chain rule
    u_n = batched_u(samples, s0.detach()).detach().requires_grad_(True)
    (dl_du,) = torch.autograd.grad(
        loss_of(construct_mixture_reweighting_estimator(samples, u_ref, lambda smp, s: u_ref, lambda smp, s: u_n)(None)), u_n
    )
    du_ds, dp_max = [], torch.zeros(4, device=dev)
    for x, b in samples:
        p = params_of(s0.detach())
        t7 = nbk.build_block_tiles(x, p, b, nb.cutoff, nb.dp_max_tiles, DP_CB, triangular=True)
        check(int(t7.overflow) == 0, "[7] block-tile list overflow at a training frame")
        args7 = (t7.atoms, t7.row_start, t7.row_count, t7.col_ids, nbk.tile_scalars(b, nb.beta, nb.cutoff), nbk.DP, DP_CB)
        # the training path's DP pass: rowscan's u takes JAX's _run_dp electrostatics, A&S 7.1.26
        dp = nbk.nb_tiles_plain(*args7, nbk.AS7126, triangular=True)
        dp_max = torch.maximum(dp_max, nbk.nb_tiles(*args7, nbk.AS7126, triangular=True).abs().amax(0))
        dq = dp[torch.argsort(t7.pad_order[:n]), 0]
        s_e = s0.detach().requires_grad_(True)
        (d_exc,) = torch.autograd.grad(nb.exclusion_energy(x, params_of(s_e), b), s_e)
        du_ds.append((torch.sum(torch.where(protein, dq * q0, 0.0)) - d_exc) / kT)
    g_plain = torch.sum(dl_du * torch.stack(du_ds))
    g_rel = abs(float(g_kernel) - float(g_plain)) / abs(float(g_plain))
    print(f"[7 du/dp] dL/ds at s = {S_START}: through the kernel {float(g_kernel):.6e}, through the plain DP "
          f"{float(g_plain):.6e}, rel {g_rel:.3e} (tol {TOL_DLDS:g}; {smi})")
    check(g_rel <= TOL_DLDS, "dL/ds through the kernel disagrees with the plain DP pass")
    dp_max = dp_max.tolist()
    print(
        f"[7 range] largest |DP column| through the kernel over the {N_FRAMES} frames: dU/dq {dp_max[0]:.4e}, "
        f"dU/d(sig/2) {dp_max[1]:.4e}, dU/d sqrt(eps) {dp_max[2]:.4e}, dU/dw {dp_max[3]:.4e}; the kernel's limit "
        f"{nbk.FIX_LIMIT:.4e} ({smi})"
    )
    check(max(dp_max) < nbk.FIX_LIMIT, "[7] a DP column beyond the fixed-point limit")

    zero_counts()
    s = s0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([s], lr=ADAM_LR)
    history = [(None, float(s.detach()))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(N_ADAM):
        opt.zero_grad()
        loss = loss_of(estimator(s))
        loss.backward()
        opt.step()
        history.append((float(loss.detach()), float(s.detach())))
        print(
            f"[7 du/dp] Adam step {step}: loss {history[-1][0]:.6f}, s {history[-2][1]:.6f} -> "
            f"{history[-1][1]:.6f}, dL/ds {float(s.grad):.6e} ({smi})"
        )
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3 / N_ADAM
    launches7, plain7 = read_counts()
    losses = [h[0] for h in history[1:]]
    print(
        f"[7 du/dp] DHFR, {N_FRAMES} frames {FRAME_INTERVAL} steps apart, protein charge scale: "
        f"{train_ms:.2f} ms per training step ({smi}); loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"launches {launches7}, plain calls {plain7}"
    )
    check(all(np.isfinite(v) for v in losses), "a training loss is not finite")
    check(all(abs(b - 1.0) < abs(a - 1.0) for (_, a), (_, b) in zip(history, history[1:])), "s did not move toward 1 at every step")
    check(losses[-1] < losses[0], "the training loss did not fall")
    check(launches7["nb_tiles"] >= N_ADAM * N_FRAMES, f"nb_tiles launched {launches7['nb_tiles']} times on the training path")
    check(launches7["rowscan_sweep"] >= N_ADAM * N_FRAMES, "rowscan_sweep not launched on the training path")
    check(plain7 == 0, "the training path ran a plain version")
    # the training path's own counts, beside each row's NPT path in `launches`
    kernel_row["launches_per_training_step"] = launches7["rowscan_sweep"] / N_ADAM
    nb_row["launches_per_training_step"] = launches7["nb_tiles"] / N_ADAM
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss_of(estimator(s)).backward()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy7 = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3
    table = events.table(sort_by="cuda_time_total", row_limit=20)
    print(f"{smi}; one DHFR training step (loss and dL/ds)\n{table}", file=sys.stderr)
    busy = (
        f"device busy {busy7:.4f} ms, {1 - busy7 / train_ms:.3f} of the unprofiled step idle"
        if busy7 > 0 else "device busy not measured (the profiler saw no device time)"
    )
    print(f"[7 profile] one training step: {busy} ({smi}); table on stderr")

    phase_time("7")

    # -- 8. the kernel="v1" path --------------------------------------------------------
    hc8 = setup_dhfr_native(waters_first=True, device=dev, dtype=f32)
    bps8 = hc8.host_system.get_U_fns()
    nb8 = hc8.host_system.nonbonded_all_pairs.configure(box, x_min, kernel="v1")
    f_v1 = nb8.energy_force(x_min, box)[1]
    f_rs = nb.energy_force(x_min, box)[1]
    f_ap = NonbondedAllPairs.energy_force(nb, x_min, box)[1]
    v1_rel = float(torch.linalg.vector_norm(f_v1 - f_rs) / torch.linalg.vector_norm(f_ap))
    print(
        f"[8 v1] capacities: {nb8.dp_max_tiles} tiles at the cutoff, {nb8.md_max_tiles} at cutoff + skin (cb {DP_CB}); "
        f"net nonbonded force, v1 vs rowscan: |diff| / |all-pairs force| {v1_rel:.3e} (tol {TOL_V1_FORCE:g}), "
        f"|diff| / |net force| {float(torch.linalg.vector_norm(f_v1 - f_rs) / torch.linalg.vector_norm(f_rs)):.3e} ({smi})"
    )
    check(v1_rel <= TOL_V1_FORCE, "the v1 force disagrees with the rowscan configuration's")

    def npt_run(tag, label, potentials, sweep):
        """N_ALT NPT steps from the minimized start with every count set to 0
        first: the path's own kernel must carry every step and every
        barostat energy, and no plain version may run. Returns its launches
        per step and the final coordinates and box."""
        zero_counts()
        ctx = make_context(potentials)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.multiple_steps(N_ALT)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches, plain = read_counts()
        x_end = torch.as_tensor(ctx.get_x_t(), device=dev)
        box_end = torch.as_tensor(ctx.get_box(), device=dev)
        u_end = float(sum(p.energy(x_end, box_end) for p in potentials))
        attempted = int(ctx.get_mover_states()[0].total_attempted)
        print(
            f"[{tag} NPT] DHFR NPT {N_ALT} steps on {label}: {N_ALT * DT / 1000.0 / elapsed * 86_400.0:.2f} ns/day "
            f"({elapsed * 1e3 / N_ALT:.4f} ms/step, list builds included; {smi}); box {box_end[0, 0].item():.4f} nm; "
            f"U {u_end:.2f} kJ/mol; launches {launches} ({launches[sweep.__name__] / N_ALT:.3f} per step), plain calls {plain}"
        )
        check(bool(torch.isfinite(x_end).all() and torch.isfinite(box_end).all()) and np.isfinite(u_end), f"[{tag}] run not finite")
        check(launches[sweep.__name__] >= N_ALT + 2 * attempted, f"[{tag}] {sweep.__name__} launched {launches[sweep.__name__]} times")
        check(plain == 0, f"[{tag}] the path ran a plain version")
        return launches[sweep.__name__] / N_ALT, x_end, box_end

    nb_row["launches"], _, _ = npt_run("8", 'kernel="v1"', bps8, nbk.nb_tiles)
    nb_row["path"] = 'DHFR NPT, kernel="v1" (per step)'

    def alt_config(tag, kernel):
        """DHFR configured as `kernel` at the minimized start, and its net
        nonbonded force against the rowscan configuration's."""
        hc_k = setup_dhfr_native(waters_first=True, device=dev, dtype=f32)
        nb_k = hc_k.host_system.nonbonded_all_pairs.configure(box, x_min, kernel=kernel)
        check(nb_k.kernel == kernel, f"[{tag}] DHFR configured as {nb_k.kernel!r}, not {kernel!r}")
        f_k = nb_k.energy_force(x_min, box)[1]
        f_rel = float(torch.linalg.vector_norm(f_k - f_rs) / torch.linalg.vector_norm(f_ap))
        print(
            f"[{tag} force] configuration {nb_k.kernel!r}: net nonbonded force vs rowscan: |diff| / |all-pairs force| "
            f"{f_rel:.3e} (tol {TOL_ALT_FORCE:g}), |diff| / |net force| "
            f"{float(torch.linalg.vector_norm(f_k - f_rs) / torch.linalg.vector_norm(f_rs)):.3e} ({smi})"
        )
        check(f_rel <= TOL_ALT_FORCE, f"[{tag}] the {kernel} force disagrees with the rowscan configuration's")
        return hc_k.host_system.get_U_fns(), nb_k

    def build_ms(init):
        init(x_min, box)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            state = init(x_min, box)
        torch.cuda.synchronize()
        return state, (time.perf_counter() - t0) * 1e3 / 5

    w_min = nb.params[:, 3].to(f32)
    pairs_min = pairs_within_cutoff(x_min, box, w_min, nb.cutoff)

    phase_time("8")

    # -- 9. the kernel="gather" path -----------------------------------------------------
    bps9, nb9 = alt_config("9", "gather")
    state9, build9 = build_ms(nb9.md_force_provider()[0])
    lists = state9.lists
    check(int(lists.overflow) == 0, "[9] neighbour list overflow at DHFR")
    atoms9 = rs.assemble_atoms(x_min, box, lists.pad_order, state9.prows)
    scal9 = rs.sweep_scalars(box, nb9.cutoff)
    args9 = (atoms9, lists.counts, lists.nbr, lists.tri_start, scal9, series)
    plain_args9 = (atoms9, lists.counts, lists.nbr, scal9, series)
    census9 = gk.cull_census(*args9[:5])
    counts9 = lists.counts.double()
    print(
        f"[9 shapes] Npad {atoms9.shape[0]}, row chunks {lists.counts.shape[0]}, max_nbrs {nb9.md_max_nbrs} at "
        f"cutoff + skin, counts mean {float(counts9.mean()):.1f} max {int(lists.counts.max())}; pair slots listed "
        f"(the full lists) {census9.listed} ({census9.listed / pairs_min:.2f} per pair within the cutoff, {pairs_min} "
        f"pairs), in the Newton-triangular suffixes {census9.suffix}, kept by the column cull {census9.columns}, "
        f"swept in chunks of 32 columns {census9.swept} ({census9.swept / pairs_min:.2f} per pair; "
        f"{census9.swept / census9.listed:.3f} of listed, want <= {GATHER_SWEPT_SHARE}; counted by the plain "
        f"cull_census); list build {build9:.3f} ms ({smi})"
    )
    check(census9.swept <= GATHER_SWEPT_SHARE * census9.listed, "[9] the suffix and cull leave too many slots to sweep")
    res9 = {}
    for label, mode, first in (("F", gk.FORCE, False), ("F+U", gk.FORCE_ENERGY, False), ("first design F", gk.FORCE, True)):
        res9[label] = compare_kernel("9", [(
            label, lambda m=mode, f=first: gk.gather_sweep(*args9, m, first_design=f),
            lambda m=mode: gk.gather_sweep_plain(*plain_args9, m),
        )])
    err9, ms9, plain9 = res9["F"]
    ms_first9 = res9["first design F"][1]
    print(
        f"[9 redesign] F {ms9:.4f} ms over {census9.swept} slots swept by the census "
        f"({census9.swept / ms9 / 1e6:.1f}G slots/s), first design F {ms_first9:.4f} ms over {census9.listed} "
        f"({census9.listed / ms_first9 / 1e6:.1f}G slots/s); ratio {ms9 / ms_first9:.3f} (want <= "
        f"{GATHER_REDESIGN_RATIO}) ({smi})"
    )
    check(ms9 <= GATHER_REDESIGN_RATIO * ms_first9, "[9] the gather redesign is not enough faster than the first design")
    gather_row = kernel_entry(
        "gather_sweep", "gather.cu", "gather_kernel.py:64", err9, ms9, plain9, pairs_min,
        tensor_bytes(atoms9, lists.counts, lists.tri_start) + 4 * int(lists.counts.sum()) + 16 * atoms9.shape[0],
    )
    gather_row["ms_by_form_and_mode"] = {label: r[1] for label, r in res9.items()}
    print(
        f"[9 bound] F-mode bound over pairs {gather_row['bound_ms']:.4f} ms, over the slots the cull keeps "
        f"{bound(pair_ops('gather_sweep', census9.columns), 0)[0]:.4f} ms, over the swept slots "
        f"{bound(pair_ops('gather_sweep', census9.swept), 0)[0]:.4f} ms; the first design over its pair visits "
        f"{bound(pair_ops('gather_sweep', census9.listed // 2), 0)[0]:.4f} ms (a full list sweeps each pair twice; "
        f"{FLOPS_PER_PAIR['gather_sweep']} per pair; {smi})"
    )
    gather_row["launches"], x9, box9 = npt_run("9", 'kernel="gather"', bps9, gk.gather_sweep)
    gather_row["path"] = 'DHFR NPT, kernel="gather" (per step)'
    # the end state: lists rebuilt there, and the kernel's |dU/dx| (row sums
    # and reactions in int64 fixed point) against its range
    state_end9 = nb9.md_force_provider()[0](x9, box9)
    l_end = state_end9.lists
    check(int(l_end.overflow) == 0, "[9] neighbour list overflow at the end state")
    atoms_end9 = rs.assemble_atoms(x9, box9, l_end.pad_order, state_end9.prows)
    grad9 = max(
        float(gk.gather_sweep(
            atoms_end9, l_end.counts, l_end.nbr, l_end.tri_start, rs.sweep_scalars(box9, nb9.cutoff), series, gk.FORCE
        )[:, 1:4].abs().max()),
        float(NonbondedAllPairs.energy_force(nb9, x9, box9)[1].abs().max()),
    )
    print(
        f"[9 invariant] after {N_ALT} steps: largest |dU/dx| {grad9:.4e} of the kernel's fixed-point limit "
        f"{nbk.FIX_LIMIT:.4e} kJ/mol/nm (NaN beyond; {smi})"
    )
    check(grad9 < nbk.FIX_LIMIT, "[9] |dU/dx| beyond the kernel's fixed-point limit")
    bitwise_repeat("9", bps9)

    phase_time("9")

    # -- 10. the kernel="quad" path -------------------------------------------------------
    bps10, nb10 = alt_config("10", "quad")
    state10, build10 = build_ms(nb10.md_force_provider()[0])
    tiles10 = state10.lists
    check(int(tiles10.overflow) == 0, "[10] tile list overflow at DHFR")
    atoms10 = rs.assemble_atoms(x_min, box, tiles10.pad_order, state10.prows)
    args10 = (atoms10, tiles10.row_start, tiles10.row_count, tiles10.entries, rs.sweep_scalars(box, nb10.cutoff), series)
    listed10 = int(tiles10.row_count.sum())
    census10 = qk.cull_census(*args10[:5])
    print(
        f"[10 shapes] Npad {atoms10.shape[0]}, chunks {tiles10.row_start.shape[0]}, listed tiles {listed10} of "
        f"capacity {nb10.md_max_tiles} at cutoff + skin; pair slots listed {census10.listed} "
        f"({census10.listed / pairs_min:.2f} per pair within the cutoff), kept by the column cull {census10.columns}, "
        f"swept in chunks of 32 columns {census10.swept} ({census10.swept / pairs_min:.2f} per pair; "
        f"{census10.swept / census10.listed:.3f} of listed, want <= {SWEPT_SHARE}; counted by the plain cull_census); "
        f"constant-shift margin {float(tiles10.margin):.4f} nm; list build {build10:.3f} ms ({smi})"
    )
    check(float(tiles10.margin) > 0, "[10] the constant-shift invariant fails at the start")
    check(census10.swept <= SWEPT_SHARE * census10.listed, "[10] the culls leave too many slots to sweep")
    res10 = {}
    for label, mode, w, first in (
        ("F", qk.FORCE, True, False), ("F+U", qk.FORCE_ENERGY, True, False), ("no-w F", qk.FORCE, False, False),
        ("no-w F+U", qk.FORCE_ENERGY, False, False), ("first design F", qk.FORCE, True, True),
    ):
        res10[label] = compare_kernel("10", [(
            label, lambda m=mode, w=w, f=first: qk.quadscan_sweep(*args10, m, has_w=w, first_design=f),
            lambda m=mode, w=w: qk.quadscan_sweep_plain(*args10, m, has_w=w),
        )])
    err10, ms10, plain10 = res10["F"]
    ms_first10 = res10["first design F"][1]
    print(
        f"[10 redesign] F with w {ms10:.4f} ms over {census10.swept} slots swept by the census "
        f"({census10.swept / ms10 / 1e6:.1f}G slots/s), first design F {ms_first10:.4f} ms over {census10.listed} "
        f"({census10.listed / ms_first10 / 1e6:.1f}G slots/s); ratio {ms10 / ms_first10:.3f} (want <= "
        f"{QUAD_REDESIGN_RATIO}) ({smi})"
    )
    check(ms10 <= QUAD_REDESIGN_RATIO * ms_first10, "[10] the quad redesign is not enough faster than the first design")
    bytes10 = tensor_bytes(atoms10, tiles10.row_start, tiles10.row_count) + 4 * qk.PACK * listed10 + 16 * atoms10.shape[0]
    quad_row = kernel_entry("quadscan_sweep", "quadscan.cu", "quadscan_kernel.py:69", err10, ms10, plain10, pairs_min, bytes10)
    quad_row["ms_by_form_and_mode"] = {label: r[1] for label, r in res10.items()}
    nw = kernel_entry("quadscan_sweep_nw", "quadscan.cu", "quadscan_kernel.py:69", *res10["no-w F"], pairs_min, bytes10)
    quad_row["no_w"] = {key: nw[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    print(
        f"[10 bound] F-mode bound over pairs {quad_row['bound_ms']:.4f} ms, over the slots the culls keep "
        f"{bound(pair_ops('quadscan_sweep', census10.columns), 0)[0]:.4f} ms, over the swept slots "
        f"{bound(pair_ops('quadscan_sweep', census10.swept), 0)[0]:.4f} ms, over the listed slots "
        f"{bound(pair_ops('quadscan_sweep', census10.listed), 0)[0]:.4f} ms ({FLOPS_PER_PAIR['quadscan_sweep']} per "
        f"pair); no-w F {res10['no-w F'][1]:.4f} ms against its bound over pairs {nw['bound_ms']:.4f} ms "
        f"({FLOPS_PER_PAIR['quadscan_sweep_nw']} per pair), plain {res10['no-w F'][2]:.2f} ms ({smi})"
    )
    # the quad configuration's energy and force are rowscan's: hold its MD
    # provider's net nonbonded force (the quadscan sweep minus the
    # exclusions) against the rowscan configuration's, on the same scale
    f_md10 = nb10.md_force_provider()[1](state10, x_min, box, 1)[0]
    md_rel = float(torch.linalg.vector_norm(f_md10 - f_rs) / torch.linalg.vector_norm(f_ap))
    print(f"[10 force] MD provider (quadscan): net nonbonded force vs rowscan: |diff| / |all-pairs force| {md_rel:.3e} "
          f"(tol {TOL_ALT_FORCE:g}; {smi})")
    check(md_rel <= TOL_ALT_FORCE, "[10] the quad MD force disagrees with the rowscan configuration's")
    quad_row["launches"], x10, box10 = npt_run("10", 'kernel="quad"', bps10, qk.quadscan_sweep)
    quad_row["path"] = 'DHFR NPT, kernel="quad" (per step)'
    margin_end = qk.constant_shift_margin(x10, box10, nb10.cutoff + SKIN)
    grad_max = max(
        float(qk.quadscan_sweep(*args10, qk.FORCE)[:, 1:4].abs().max()),
        float(NonbondedAllPairs.energy_force(nb10, x10, box10)[1].abs().max()),
    )
    print(
        f"[10 invariant] constant-shift margin at cutoff + skin: {float(tiles10.margin):.4f} nm at the start, "
        f"{margin_end:.4f} nm after {N_ALT} steps; largest |dU/dx| {grad_max:.4e} of the kernel's fixed-point "
        f"limit {nbk.FIX_LIMIT:.4e} kJ/mol/nm (NaN beyond; {smi})"
    )
    check(margin_end > 0, "[10] the constant-shift invariant fails at the end")
    check(grad_max < nbk.FIX_LIMIT, "[10] |dU/dx| beyond the kernel's fixed-point limit")
    bitwise_repeat("10", bps10)

    phase_time("10")

    # -- 11. the kernel="dot" path --------------------------------------------------------
    bps11, nb11 = alt_config("11", "dot")
    state11, build11 = build_ms(nb11.md_force_provider()[0])
    tiles11 = state11.lists
    list_cut = nb11.cutoff + SKIN
    check(int(tiles11.invalid) == 0, "[11] dotscan lists invalid at DHFR (overflow or the image bound)")
    atoms11 = rs.assemble_atoms(x_min, box, tiles11.pad_order, state11.prows)
    n_rows11 = tiles11.row_start.shape[0]
    listed11 = int(tiles11.row_count.sum())
    scal11 = rs.sweep_scalars(box, nb11.cutoff)
    census11 = dk.cull_census(atoms11, tiles11.row_start, tiles11.row_count, tiles11.col_ids, tiles11.rcen_q, scal11)
    print(
        f"[11 shapes] configuration {nb11.kernel!r}, sort {nb11.dot_sort!r}; Npad {atoms11.shape[0]}, row chunks "
        f"{n_rows11}, listed tiles {listed11} of capacity {nb11.md_max_pairs} at cutoff + skin (triangular); pair "
        f"slots listed with the covering tiles {census11.listed} ({census11.listed / pairs_min:.2f} per pair within "
        f"the cutoff, {pairs_min} pairs), kept by the column cull {census11.columns}, swept in chunks of 32 columns "
        f"{census11.swept} ({census11.swept / pairs_min:.2f} per pair; {census11.swept / census11.listed:.3f} of "
        f"listed, want <= {SWEPT_SHARE}; counted by the plain cull_census); image-bound margin {float(tiles11.margin):.4f} nm; list build "
        f"{build11:.3f} ms ({smi})"
    )
    check(census11.swept <= SWEPT_SHARE * census11.listed, "[11] the cull leaves too many slots to sweep")
    sym11 = dk.build_dotscan_tiles(
        x_min, box, list_cut, dk.suggest_max_pairs(x_min, box, list_cut, sort=nb11.dot_sort), sort=nb11.dot_sort
    )
    check(int(sym11.invalid) == 0 and torch.equal(sym11.pad_order, tiles11.pad_order), "[11] symmetric lists")
    forms11 = {"tri": (tiles11, True), "sym": (sym11, False)}

    def dot_args(form):
        t, tri = forms11[form]
        return (atoms11, t.row_start, t.row_count, t.col_ids, t.rcen_q, scal11, series), tri

    res11 = {}
    for form in ("tri", "sym"):
        for label, mode in (("F", dk.FORCE), ("F+U", dk.FORCE_ENERGY)):
            res11[f"{form} {label}"] = compare_kernel("11", [(
                f"{form} {label}", lambda f=form, m=mode: dk.dotscan_sweep(*dot_args(f)[0], m, dot_args(f)[1]),
                lambda f=form, m=mode: dk.dotscan_sweep_plain(*dot_args(f)[0], m, dot_args(f)[1]),
            )])
    err11, ms11, plain11 = res11["tri F"]
    ms_sym11 = res11["sym F"][1]
    sym_slots11 = int(sym11.row_count.sum()) * dk.ROW * dk.COL
    print(
        f"[11 redesign] triangular F {ms11:.4f} ms over {census11.swept} slots swept by the census "
        f"({census11.swept / ms11 / 1e6:.1f}G slots/s), symmetric F (the first design) {ms_sym11:.4f} ms over "
        f"{sym_slots11} ({sym_slots11 / ms_sym11 / 1e6:.1f}G slots/s); ratio {ms11 / ms_sym11:.3f} (want <= "
        f"{DOT_REDESIGN_RATIO}) ({smi})"
    )
    check(ms11 <= DOT_REDESIGN_RATIO * ms_sym11, "[11] the triangular dot redesign is not enough faster than the symmetric form")
    dot_row = kernel_entry(
        "dotscan_sweep", "dotscan.cu", "dotscan_kernel.py:82", err11, ms11, plain11, pairs_min,
        tensor_bytes(atoms11, tiles11.row_start, tiles11.row_count, tiles11.rcen_q) + 4 * listed11 + 16 * atoms11.shape[0],
    )
    dot_row["ms_by_form_and_mode"] = {label: r[1] for label, r in res11.items()}
    print(
        f"[11 bound] triangular F-mode bound over pairs {dot_row['bound_ms']:.4f} ms, over the slots the cull keeps "
        f"{bound(pair_ops('dotscan_sweep', census11.columns), 0)[0]:.4f} ms, over the swept slots "
        f"{bound(pair_ops('dotscan_sweep', census11.swept), 0)[0]:.4f} ms, over the listed slots "
        f"{bound(pair_ops('dotscan_sweep', census11.listed), 0)[0]:.4f} ms (FP32 peak {PEAK_FP32:.3g}/s; {smi})"
    )
    f_md11 = nb11.md_force_provider()[1](state11, x_min, box, 1)[0]
    md_rel11 = float(torch.linalg.vector_norm(f_md11 - f_rs) / torch.linalg.vector_norm(f_ap))
    print(f"[11 force] MD provider (dotscan): net nonbonded force vs rowscan: |diff| / |all-pairs force| "
          f"{md_rel11:.3e} (tol {TOL_DOT_FORCE:g}; {smi})")
    check(md_rel11 <= TOL_DOT_FORCE, "[11] the dot MD force disagrees with the rowscan configuration's")
    dot_row["launches"], x11, box11 = npt_run("11", 'kernel="dot"', bps11, dk.dotscan_sweep)
    dot_row["path"] = 'DHFR NPT, kernel="dot" (per step)'
    # the end state: lists, centers and the dotscan sweep's |dU/dx| at x11, box11
    state_end = nb11.md_force_provider()[0](x11, box11)
    t_end = state_end.lists
    check(int(t_end.invalid) == 0, "[11] dotscan lists invalid after the run (overflow or the image bound)")
    margin11 = float(t_end.margin)
    atoms_end = rs.assemble_atoms(x11, box11, t_end.pad_order, state_end.prows)
    end_args = (atoms_end, t_end.row_start, t_end.row_count, t_end.col_ids, t_end.rcen_q, rs.sweep_scalars(box11, nb11.cutoff))
    grad11 = max(
        float(dk.dotscan_sweep(*end_args, series, dk.FORCE, True)[:, 1:4].abs().max()),
        float(NonbondedAllPairs.energy_force(nb11, x11, box11)[1].abs().max()),
    )
    print(
        f"[11 invariant] image-bound margin at cutoff + skin: {float(tiles11.margin):.4f} nm at the start, "
        f"{margin11:.4f} nm after {N_ALT} steps; largest |dU/dx| {grad11:.4e} of the kernel's fixed-point "
        f"limit {nbk.FIX_LIMIT:.4e} kJ/mol/nm (NaN beyond; {smi})"
    )
    check(margin11 > 0, "[11] the image bound fails at the end")
    check(grad11 < nbk.FIX_LIMIT, "[11] |dU/dx| beyond the kernel's fixed-point limit")
    bitwise_repeat("11", bps11)

    phase_time("11")

    # -- 12. the probes ----------------------------------------------------------------
    x12 = fp.inputs(dev)
    a12, b12 = br.inputs(dev)
    bf16 = torch.bfloat16
    zero_counts()
    tflops, ms_fma, ms_fma2 = fp.measure(x12)
    fits = br.measure(a12, b12)
    ms_gate = {dt: fits[dt, False].device_ms for dt in (torch.float32, torch.bfloat16)}
    launches12, plain12 = read_counts()
    check(plain12 == 0, "[12] the probes ran a plain version")
    ratio = ms_fma2 / ms_fma
    print(
        f"[12 fp32] {fp.GRID} x ({fp.ROWS}, {fp.LANES}) elements, 4 FMA chains: {ms_fma:.4f} ms at INNER {fp.INNER}, "
        f"{ms_fma2:.4f} ms at {2 * fp.INNER} (CUDA events over 20 launches each, queued behind a spin kernel; ratio {ratio:.3f}, want "
        f"{PROBE_RATIO[0]}-{PROBE_RATIO[1]}); "
        f"measured FP32 peak {tflops:.2f} TFLOP/s, {fp.flops(x12.numel()) / ((ms_fma2 - ms_fma) * 1e-3) / 1e12:.2f} from "
        f"the difference, against the data sheet's {PEAK_FP32 / 1e12:.0f} ({tflops * 1e12 / PEAK_FP32:.3f}; {smi})"
    )
    check(PROBE_RATIO[0] <= ratio <= PROBE_RATIO[1], "[12] the FP32 probe's time does not double with INNER")
    n12 = a12.numel()
    slot_iters = n12 * br.ITERS
    print(
        f"[12 bf16] ({br.SUB}, {br.LANE}) x {br.ITERS} slot-iterations, device time ({fits[torch.float32, False].timed_by}, {fits[bf16, False].timed_by}): f32 {ms_gate[torch.float32] * 1e3:.2f} us "
        f"({ms_gate[torch.float32] * 1e9 / slot_iters:.4f} ps/slot-iteration), bf16 {ms_gate[torch.bfloat16] * 1e3:.2f} us "
        f"({ms_gate[torch.bfloat16] * 1e9 / slot_iters:.4f}); bf16 speedup over f32 "
        f"{ms_gate[torch.float32] / ms_gate[torch.bfloat16]:.3f}x ({smi})"
    )
    for (dt, first), f in fits.items():
        print(
            f"[12 bf16 slope] {br.KERNELS[dt, first]} ({'first design' if first else 'redesign'}): us per launch at "
            + ", ".join(f"{k} {ms * 1e3:.3f}" for k, ms in f.ms_by_iters.items())
            + f" iterations (CUDA events over {br.REPS} launches queued behind a spin kernel); marginal "
            f"{f.marginal_ms * 1e3:.4f} us per {br.ITERS} iterations, fixed {f.fixed_ms * 1e3:.4f} us per launch, "
            f"time at {br.ITERS * br.MULTIPLES[-1]} / at {br.ITERS * br.MULTIPLES[-2]} {f.ratio:.3f} (want "
            f"{PROBE_RATIO[0]}-{PROBE_RATIO[1]}); {f.timed_by} at {br.ITERS} {f.device_ms * 1e3:.3f} us ({smi})"
        )
        check(PROBE_RATIO[0] <= f.ratio <= PROBE_RATIO[1], f"[12] {br.KERNELS[dt, first]}'s time is not linear in iterations")
    for first in (False, True):
        f32_fit, bf_fit = fits[torch.float32, first], fits[bf16, first]
        print(
            f"[12 bf16 slope] {'first design' if first else 'redesign'}: bf16 speedup over f32 "
            f"{f32_fit.marginal_ms / bf_fit.marginal_ms:.3f}x marginal, "
            f"{f32_fit.ms_by_iters[br.ITERS] / bf_fit.ms_by_iters[br.ITERS]:.3f}x per launch at {br.ITERS} ({smi})"
        )
    gate_ratio = fits[bf16, False].marginal_ms / fits[bf16, True].marginal_ms
    print(
        f"[12 redesign] marginal bf16 time per {br.ITERS} iterations, redesign / first design: {gate_ratio:.3f} "
        f"(limit {GATE_REDESIGN_RATIO}); f32 {fits[torch.float32, False].marginal_ms / fits[torch.float32, True].marginal_ms:.3f} "
        f"({smi})"
    )
    check(gate_ratio <= GATE_REDESIGN_RATIO, "[12] the redesigned bf16 gate is not fast enough against the first design")
    probe_rows = []
    for probe, kernel, plain, ms, ops, peak, nbytes, source, replaces in (
        ("fp32_peak", lambda: fp.fp32_peak(x12), lambda: fp.fp32_peak_plain(x12), ms_fma, fp.flops(x12.numel()),
         PEAK_FP32, 8 * x12.numel(), "probe_fma.cu", "scripts/probe_mfu.py:53"),
        ("bf16_rate", lambda: br.bf16_rate(a12, b12), lambda: br.bf16_rate_plain(a12, b12), ms_gate[torch.bfloat16],
         slot_iters * br.OPS_PER_SLOT, PEAK_BF16_VECTOR, 12 * n12, "probe_bf16.cu", "scripts/probe_bf16.py:41"),
    ):
        out_k, out_p = kernel(), plain()
        same = torch.equal(out_k, out_p) and torch.equal(out_k, kernel()) and bool(torch.isfinite(out_k).all())
        plain_ms = cuda_ms(plain, 1)
        row = kernel_entry(probe, source, replaces, float((out_k - out_p).abs().max()), ms, plain_ms, 0, nbytes, ops, peak)
        row["launches"], row["path"] = launches12[probe], "chip_smoke.py phase 12 (per run)"
        probe_rows.append(row)
        print(f"[12 {probe}] kernel vs plain bitwise equal (and two launches), finite: {same}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']} ({smi})")
        check(same, f"[12] {probe} disagrees with its plain version")
    fit = fits[bf16, False]
    probe_rows[-1].update(
        ms_by_iters=fit.ms_by_iters, marginal_ms=fit.marginal_ms, fixed_ms=fit.fixed_ms,
        first_design_ms=fits[bf16, True].device_ms, ms_timed_by=fits[bf16, False].timed_by,
    )
    out_f32 = br.bf16_rate(a12, b12, torch.float32)
    check(torch.equal(out_f32, br.bf16_rate_plain(a12, b12, torch.float32)), "[12] the f32 gate disagrees with plain")
    for dt in (torch.float32, bf16):
        for first in (False, True):
            for iters in (br.ITERS, 4 * br.ITERS):
                out_k = br.bf16_rate(a12, b12, dt, iters, first_design=first)
                same = torch.equal(out_k, br.bf16_rate_plain(a12, b12, dt, iters)) and torch.equal(
                    out_k, br.bf16_rate(a12, b12, dt, iters, first_design=first)
                )
                check(same, f"[12] {br.KERNELS[dt, first]} at {iters} iterations disagrees with plain or itself")
    print(
        f"[12 bf16 designs] {', '.join(br.KERNELS.values())} at {br.ITERS} and {4 * br.ITERS} iterations: each bitwise "
        f"equal to bf16_rate_plain, two launches equal ({smi})"
    )
    t0 = time.perf_counter()
    census = tc.tile_census(hc.conf, hc.box, dev)
    torch.cuda.synchronize()
    census_ms = (time.perf_counter() - t0) * 1e3
    print(f"[12 census] DHFR start: {tc.describe(census)}; {census_ms:.1f} ms on the card, host clock ({smi})")
    check(
        (census.built, census.chopped, census.empty, census.hits) == CENSUS_DHFR,
        f"[12] the tile census {census} differs from the script's {CENSUS_DHFR}",
    )

    phase_time("12")

    # -- 13. the solvent RBFE leg ------------------------------------------------------
    # the 12 ethanol -> propane windows of the committed cache on the card:
    # the masked rowscan form against its plain version, the window's force
    # against the host CPU's, run_sims_sequential in one reused Context and
    # pair BAR, and a reused window against a fresh one
    t0 = time.perf_counter()
    states13 = load_rbfe_solvent(device=dev, dtype=f32)
    configure_all_pairs(states13[0])
    torch.cuda.synchronize()
    t_load13 = time.perf_counter() - t0
    s13 = states13[0]
    pots13 = s13.potentials
    host_i = next(i for i, p in enumerate(pots13) if isinstance(p, Nonbonded))
    nb13 = pots13[host_i]
    x13 = torch.as_tensor(s13.x0, device=dev, dtype=f32)
    box13 = torch.as_tensor(s13.box0, device=dev, dtype=f32)
    n13, mask13 = x13.shape[0], nb13.atom_mask
    n_masked = int((~mask13).sum())
    check(nb13.kernel == "rowscan" and not nb13.md_preshift, "[13] the host term is not the masked rowscan form")
    state13 = nb13.md_force_provider()[0](x13, box13)
    t13 = state13.lists
    check(int(state13.invalid) == 0, "[13] masked lists invalid at window 0")
    atoms13 = rs.assemble_atoms(x13, box13, t13.pad_order, state13.prows)
    count13 = rs.chop_row_counts(atoms13[:, :3], t13.rank_mat, t13.row_count, box13, nb13.cutoff)
    n_rows13 = t13.row_start.shape[0]
    slots13 = (int(count13.sum()) + n_rows13) * rs.ROW * rs.COL
    host_idx13 = torch.nonzero(mask13).squeeze(1)
    pairs13 = pairs_within_cutoff(x13[host_idx13], box13, nb13.params[host_idx13, 3].to(f32), nb13.cutoff)
    print(
        f"[13 shapes] ethanol -> propane solvent leg: {n13} atoms, {n_masked} masked in the host term (the hybrid "
        f"ligand), {len(states13)} windows (λ {', '.join(f'{s.lamb:.3f}' for s in states13)}); host term: "
        f"max_pairs {nb13.max_pairs}, MD max_pairs {nb13.md_max_pairs} (cell {nb13.md_cell_size} nm), DP tiles "
        f"{nb13.dp_max_tiles}; listed tiles {int(t13.row_count.sum())}, swept slots/step {slots13} with the covering "
        f"tiles, pairs within the cutoff {pairs13}; interaction group {len(pots13[-1].row_atom_idxs)} x "
        f"{len(pots13[-1].col_atom_idxs)}; loaded and configured in {t_load13:.2f} s ({smi})"
    )
    series13 = rs.es_energy_force_series(nb13.beta, nb13.cutoff)
    args13 = (atoms13, t13.row_start, count13, t13.col_ids, rs.sweep_scalars(box13, nb13.cutoff), series13)
    masked_form = dict(triangular=True, has_w=True)
    err13, ms13, plain13 = compare_kernel("13", [
        (f"masked form {label}", lambda m=mode: rs.rowscan_sweep(*args13, m, **masked_form),
         lambda m=mode: rs.rowscan_sweep_plain(*args13, m, **masked_form))
        for label, mode in (("F", rs.FORCE), ("U", rs.ENERGY), ("F+U", rs.FORCE_ENERGY))
    ])
    out13 = rs.rowscan_sweep(*args13, rs.FORCE_ENERGY, **masked_form)
    lig_rows = ~mask13[t13.pad_order] | (torch.arange(atoms13.shape[0], device=dev) >= n13)
    check(not bool(out13[lig_rows].any()), "[13] masked atoms or padding got a force or an energy from the sweep")
    # two masked atoms on one point and two 5e-4 nm apart (r^2 = 2.5e-7, inside the gate)
    lig = torch.as_tensor(s13.ligand_idxs, device=dev, dtype=torch.int64)
    x_c = x13.clone()
    x_c[lig[1]] = x_c[lig[0]]
    x_c[lig[3]] = x_c[lig[2]] + torch.tensor([5e-4, 0.0, 0.0], device=dev)
    atoms_c = rs.assemble_atoms(x_c, box13, t13.pad_order, state13.prows)
    args_c = (atoms_c,) + args13[1:]
    compare_kernel("13", [(
        "coincident masked pair F+U", lambda: rs.rowscan_sweep(*args_c, rs.FORCE_ENERGY, **masked_form),
        lambda: rs.rowscan_sweep_plain(*args_c, rs.FORCE_ENERGY, **masked_form),
    )])
    tiles_dp13 = nbk.build_block_tiles(x13, nb13.params, box13, nb13.cutoff, nb13.dp_max_tiles, DP_CB, True, mask13)
    check(int(tiles_dp13.overflow) == 0, "[13] masked block-tile list overflow")
    dp_args13 = (tiles_dp13.atoms, tiles_dp13.row_start, tiles_dp13.row_count, tiles_dp13.col_ids,
                 nbk.tile_scalars(box13, nb13.beta, nb13.cutoff))
    compare_kernel("13", [(
        "block tiles DP under the mask", lambda: nbk.nb_tiles(*dp_args13, nbk.DP, DP_CB, triangular=True),
        lambda: nbk.nb_tiles_plain(*dp_args13, nbk.DP, DP_CB, triangular=True),
    )])
    dp_out13 = nbk.nb_tiles(*dp_args13, nbk.DP, DP_CB, triangular=True)
    check(not bool(dp_out13[tiles_dp13.atoms[:, 7] == 0].any()), "[13] masked atoms got a nonzero dU/dp")
    masked_row = kernel_entry(
        "rowscan_sweep_masked", "rowscan.cu", "rowscan_kernel.py:111", err13, ms13, plain13, pairs13,
        tensor_bytes(atoms13, t13.row_start, count13) + 4 * int(count13.sum()) + 16 * atoms13.shape[0],
    )
    print(
        f"[13 kernel] masked form (triangular, minimum image, w) F {ms13:.4f} ms over {slots13} slots "
        f"({slots13 / ms13 / 1e6:.1f}G slots/s); bound {masked_row['bound_ms']:.4f} ms by {masked_row['bound_by']} "
        f"({FLOPS_PER_PAIR['rowscan_sweep_masked']} FP32 operations per pair within the cutoff, {pairs13} pairs) ({smi})"
    )

    cpu13 = load_rbfe_solvent(device="cpu", dtype=f32, windows=[0])[0]
    # the card's form, named: on the CPU the Context's rule would take the dense form
    cpu13.potentials[host_i].configure(box13.cpu(), x13.cpu(), kernel="rowscan")
    f_terms = [p.energy_force(x13, box13)[1] for p in pots13]
    f_terms_cpu = [p.energy_force(x13.cpu(), box13.cpu())[1] for p in cpu13.potentials]
    f_ap13 = NonbondedAllPairs.energy_force(nb13, x13, box13)[1]
    ap13 = float(torch.linalg.vector_norm(f_ap13))
    per_term = " ".join(
        f"{type(p).__name__} {float(torch.linalg.vector_norm(a.cpu() - b)) / max(float(torch.linalg.vector_norm(b)), 1e-30):.2e}"
        for p, a, b in zip(pots13, f_terms, f_terms_cpu)
    )
    f_rel13 = float(torch.linalg.vector_norm(sum(f_terms).cpu() - sum(f_terms_cpu))) / ap13
    grad13 = max(float(f.abs().max()) for f in f_terms + [f_ap13])
    print(
        f"[13 force] window 0, card vs host CPU per term (|diff| / |term force|): {per_term}; total |diff| / "
        f"|all-pairs force| {f_rel13:.3e} (tol {TOL_FORCE_REL_NORM:g}); largest |dU/dx| {grad13:.4e} of the "
        f"fixed-point limit {nbk.FIX_LIMIT:.4e} ({smi})"
    )
    check(f_rel13 <= TOL_FORCE_REL_NORM, "[13] the window's force on the card disagrees with the host CPU")
    check(grad13 < nbk.FIX_LIMIT, "[13] |dU/dx| beyond the kernel's fixed-point limit")

    md13 = MDParams(n_frames=N13_FRAMES, n_eq_steps=N13_EQ, steps_per_frame=N13_STEPS_PER_FRAME, seed=2023)
    steps13 = N13_EQ + N13_FRAMES * N13_STEPS_PER_FRAME
    window_s, window_launches = [], []
    sample_fn = fe13.sample_with_context

    def timed_sample(*args, **kwargs):
        """sample_with_context on the host clock, with the kernels it launched."""
        torch.cuda.synchronize()
        before = rs.rowscan_sweep.launches
        t_start = time.perf_counter()
        traj = sample_fn(*args, **kwargs)
        torch.cuda.synchronize()
        window_s.append(time.perf_counter() - t_start)
        window_launches.append(rs.rowscan_sweep.launches - before)
        return traj

    fe13.sample_with_context = timed_sample
    zero_counts()
    t0 = time.perf_counter()
    try:
        result13, trajs13 = fe13.run_sims_sequential(states13, md13, TEMP)
    finally:
        fe13.sample_with_context = sample_fn
    torch.cuda.synchronize()
    t_run13 = time.perf_counter() - t0
    launches13, plain13_calls = read_counts()
    for k, (s, traj) in enumerate(zip(states13, trajs13)):
        finite = all(np.isfinite(f).all() for f in traj.frames) and np.isfinite(traj.final_velocities).all()
        print(
            f"[13 run] window {k} λ {s.lamb:.4f}: {steps13 * s.integrator.dt / 1000.0 / window_s[k] * 86_400.0:.2f} ns/day "
            f"({window_s[k] * 1e3 / steps13:.4f} ms/step over {steps13} steps, host clock; {smi}); final box "
            f"{traj.boxes[-1][0, 0]:.4f} nm, barostat volume scale {traj.final_barostat_volume_scale_factor:.6g} nm^3; "
            f"rowscan launches {window_launches[k]}; finite {finite}"
        )
        check(finite, f"[13] window {k} not finite")
    print(
        f"[13 run] run_sims_sequential, {len(states13)} windows in one reused Context: {t_run13:.1f} s with the u_kln "
        f"and pair BAR; depth cut from DEFAULT_MD_PARAMS (10,000 equilibration steps, 1,000 frames of 400 steps) to "
        f"{N13_EQ} equilibration steps and {N13_FRAMES} frames of {N13_STEPS_PER_FRAME}; atoms and windows not cut; "
        f"launches in the run {launches13}, plain calls {plain13_calls} ({smi})"
    )
    check(plain13_calls == 0, "[13] the leg ran a plain sweep")
    check(launches13["rowscan_sweep"] >= len(states13) * steps13, "[13] the leg did not launch the rowscan kernel every step")
    masked_row["launches"] = sum(window_launches) / (len(states13) * steps13)
    masked_row["path"] = "the solvent RBFE leg, run_sims_sequential over 12 windows (per window step)"

    mid13 = len(states13) // 2
    ctx13 = get_context(states13[mid13], md13)
    ctx13.multiple_steps(N_PROFILE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx13.multiple_steps(N13_TIMED)
    torch.cuda.synchronize()
    step13_ms = (time.perf_counter() - t0) * 1e3 / N13_TIMED
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof13:
        ctx13.multiple_steps(N_PROFILE)
        torch.cuda.synchronize()
    events13 = prof13.key_averages()
    busy13 = sum(e.self_device_time_total for e in events13 if e.device_type == DeviceType.CUDA) / 1e3 / N_PROFILE
    print(f"{smi}; {N_PROFILE} steps of RBFE window {mid13}\n{events13.table(sort_by='cuda_time_total', row_limit=30)}", file=sys.stderr)
    busy13_text = (
        f"device busy {busy13:.4f} ms/step, {1 - busy13 / step13_ms:.3f} of the unprofiled step idle"
        if busy13 > 0 else "device busy not measured (the profiler saw no device time)"
    )
    print(f"[13 profile] window {mid13}: {step13_ms:.4f} ms/step unprofiled over {N13_TIMED} steps; {N_PROFILE} profiled "
          f"steps: {busy13_text} ({smi}); table on stderr")

    fresh13 = get_context(states13[mid13 - 1], md13)
    reused13 = get_context(states13[0], md13)
    reused13.multiple_steps(N13_REUSE)
    reused13.reset_for_state(states13[mid13 - 1])
    for c in (fresh13, reused13):
        c.multiple_steps(N13_REUSE)
    same13 = all(np.array_equal(f(fresh13), f(reused13)) for f in (Context.get_x_t, Context.get_v_t, Context.get_box))
    print(f"[13 reuse] window {mid13 - 1}: a fresh Context and one reset from window 0 after {N13_REUSE} steps there, "
          f"{N13_REUSE} steps each (barostat every {BAROSTAT_INTERVAL}): x, v, box bitwise equal: {same13} ({smi})")
    check(same13, "[13] a reused Context differs from a fresh one")

    u13 = result13.u_kln_by_component_by_lambda
    host_works = np.concatenate([(u13[:, host_i, 0, 1] - u13[:, host_i, 0, 0]).ravel(),
                                 (u13[:, host_i, 1, 0] - u13[:, host_i, 1, 1]).ravel()])
    for k, r in enumerate(result13.bar_results):
        print(f"[13 bar] pair {k}-{k + 1}: dG {r.dG:.4f} +- {r.dG_err:.4f} kJ/mol, overlap {r.overlap:.4f}")
    dG13 = float(np.sum(result13.dGs))
    dG13_err = float(np.linalg.norm(result13.dG_errs))
    finite13 = bool(np.isfinite(result13.dGs).all() and np.isfinite(result13.dG_errs).all() and np.isfinite(result13.overlaps).all())
    print(f"[13 bar] edge ethanol -> propane, solvent: dG {dG13:.4f} +- {dG13_err:.4f} kJ/mol ({N13_FRAMES} frames a "
          f"window: not converged); all finite: {finite13}; host term works exactly zero: {not host_works.any()} "
          f"({host_works.size} works) ({smi})")
    check(finite13, "[13] a pair BAR result is not finite")
    check(not host_works.any(), "[13] the host term's works are not exactly zero")

    phase_time("13")

    # -- 14. HREX over the 12 windows ----------------------------------------------------
    # run_sims_hrex over the same windows, all K replicas in one batched step;
    # first the replica-batched masked sweep at the slice's shapes against K
    # (or K (2 max_delta + 1)) single launches and its plain version
    K14, D14 = len(states13), N14_MAX_DELTA
    S14 = 2 * D14 + 1
    md14 = MDParams(
        n_frames=N14_FRAMES, n_eq_steps=N14_EQ, steps_per_frame=N14_STEPS_PER_FRAME, seed=2023,
        hrex_params=HREXParams(n_frames_bisection=100, max_delta_states=D14),
    )
    ctx14 = get_context(states13[0], md14)

    def make_runner(k, mesh=None):
        """A runner over the first k windows at their x0, lists built, over `mesh` (None: no mesh)."""
        r = ReplicaExchangeRunner(
            ctx14, [[p.params for p in s.potentials] for s in states13[:k]], temperature=TEMP,
            neighbor_pairs=[(i, i + 1) for i in range(k - 1)], n_swap_attempts_per_iter=k**3, max_delta_states=D14,
            seed=2023, mesh=mesh,
        )
        r.initialize([s.x0 for s in states13[:k]], [s.v0 for s in states13[:k]], [s.box0 for s in states13[:k]])
        r.batch.multiple_steps(0)
        return r

    run14 = make_runner(K14)
    ps14 = run14.batch._prov_states[host_i]
    xs14, boxes14 = run14.batch._x, run14.batch._box
    cols14 = torch.clamp(torch.arange(K14, device=dev)[:, None] + torch.arange(-D14, D14 + 1, device=dev), 0, K14 - 1)
    host_sets = run14._params_by_state[host_i][cols14].to(f32)  # (K, S, N, 4)
    pad_sets = ps14.lists.pad_order[:, None, :].expand(K14, S14, -1)
    prows_u = rs.param_rows(host_sets, pad_sets, n13, mask13).reshape(K14 * S14, -1, 4)
    lists_f = torch.arange(K14, device=dev, dtype=torch.int32)
    args_f = rs.batched_sweep_inputs(ps14.lists, xs14, ps14.prows, boxes14, lists_f, nb13.cutoff)
    args_u = rs.batched_sweep_inputs(ps14.lists, xs14, prows_u, boxes14, lists_f.repeat_interleave(S14), nb13.cutoff)
    host_pairs14 = [
        pairs_within_cutoff(xs14[k][host_idx13], boxes14[k], nb13.params[host_idx13, 3].to(f32), nb13.cutoff)
        for k in range(K14)
    ]
    print(
        f"[14 shapes] HREX over {K14} windows of {n13} atoms: K {K14} replicas in one batched step, max_delta_states "
        f"{D14}, {S14} parameter sets a replica, B = K (2 max_delta + 1) = {K14 * S14} systems on the banded U call, "
        f"K^3 = {K14**3} swap attempts an iteration; Npad {args_f[0].shape[1]}, row chunks {args_f[1].shape[1]}, lists "
        f"(K, max_pairs) {tuple(args_f[3].shape)}; host-term pairs within the cutoff per replica "
        f"{min(host_pairs14)}-{max(host_pairs14)} ({smi})"
    )

    def batched_check(label, args, mode, flops_name, plain_reps):
        """The batched launch against a single launch per system (bitwise)
        and the plain version (per column); ms of the batched launch, of B
        single launches and of the plain version; the bound over the
        systems' pairs."""
        atoms_b, row_start_b, count_b, col_ids_b, lists_b, scal_b = args
        lists_host = lists_b.tolist()

        def singles():
            return [
                rs.rowscan_sweep(atoms_b[b], row_start_b[k], count_b[k], col_ids_b[k], scal_b[b], series13, mode,
                                 triangular=True)
                for b, k in enumerate(lists_host)
            ]

        out, out2, plain = (rs.rowscan_sweep_batched(*args, series13, mode), rs.rowscan_sweep_batched(*args, series13, mode),
                            rs.rowscan_sweep_batched_plain(*args, series13, mode))
        torch.cuda.synchronize()
        same_single = all(torch.equal(out[b], o) for b, o in enumerate(singles()))
        rels = []
        for b in range(out.shape[0]):
            for col in range(4):
                norm = float(torch.linalg.vector_norm(plain[b, :, col]))
                if norm == 0:
                    check(not bool(out[b, :, col].any()), f"[14] batched {label} column {col} of system {b} not zero")
                else:
                    rels.append(float(torch.linalg.vector_norm(out[b, :, col] - plain[b, :, col])) / norm)
        max_abs = float((out - plain).abs().max())
        ms = cuda_ms(lambda: rs.rowscan_sweep_batched(*args, series13, mode), 20)
        ms_singles = cuda_ms(singles, 20)
        plain_ms = cuda_ms(lambda: rs.rowscan_sweep_batched_plain(*args, series13, mode), plain_reps)
        pairs = sum(host_pairs14[k] for k in lists_host)
        nbytes = tensor_bytes(atoms_b, row_start_b, count_b, scal_b, lists_b) + 4 * int(
            sum(int(count_b[k].sum()) for k in lists_host)) + 16 * atoms_b.shape[0] * atoms_b.shape[1]
        bound_ms, bound_by = bound(pair_ops(flops_name, pairs), nbytes)
        print(
            f"[14 kernel {label}] {out.shape[0]} systems in one launch: each bitwise its single launch {same_single}, two "
            f"launches bitwise equal {torch.equal(out, out2)}; vs plain rel_norm per column max {max(rels):.3e} (tol "
            f"{TOL_KERNEL_COL:g}), max_abs {max_abs:.3e}; batched {ms:.4f} ms, {out.shape[0]} single launches "
            f"{ms_singles:.4f} ms (CUDA events over 20), plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms by {bound_by} "
            f"({FLOPS_PER_PAIR[flops_name]} FP32 operations per pair, {pairs} pairs within the cutoff over the "
            f"systems) ({smi})"
        )
        check(same_single, f"[14] a system of the batched {label} launch differs from its single launch")
        check(torch.equal(out, out2), f"[14] two batched {label} launches differ")
        check(max(rels) <= TOL_KERNEL_COL, f"[14] the batched {label} launch disagrees with its plain version")
        return max_abs, ms, plain_ms, ms_singles, bound_ms, bound_by

    err14, ms14f, plain14f, singles14f, _, _ = batched_check("F", args_f, rs.FORCE, "rowscan_sweep_batched", 2)
    _, ms14u, _, singles14u, bound14u, _ = batched_check("U", args_u, rs.ENERGY, "rowscan_sweep_batched_U", 1)
    batched_row = kernel_entry(
        "rowscan_sweep_batched", "rowscan.cu", "rowscan_kernel.py:111", err14, ms14f, plain14f, sum(host_pairs14),
        tensor_bytes(*args_f[:3], args_f[5]) + 4 * int(args_f[2].sum()) + 16 * args_f[0].shape[0] * args_f[0].shape[1],
    )

    # the banded U_kl after a short segment against single-system sums of
    # each term's u at the target state's parameters, in f64 (the host
    # term: a single launch on the replica's lists, its exclusions)
    run14.equilibrate(N14_STEPS_PER_FRAME)
    res14 = run14.advance_frame(N14_STEPS_PER_FRAME)
    own14 = np.argsort(res14.replica_idx_by_state)
    ps14 = run14.batch._prov_states[host_i]
    f64 = torch.float64
    ref14 = np.full((K14, K14), np.inf)
    with torch.no_grad():
        for r in range(K14):
            x_r, box_r = run14.batch._x[r], run14.batch._box[r]
            t_r = type(ps14.lists)(*(f[r] for f in ps14.lists))
            for lam in range(max(0, own14[r] - D14), min(K14, own14[r] + D14 + 1)):
                params_l = [p.params for p in states13[lam].potentials]
                atoms_r = rs.assemble_atoms(x_r, box_r, t_r.pad_order, rs.param_rows(params_l[host_i].to(f32), t_r.pad_order, n13, mask13))
                count_r = rs.chop_row_counts(atoms_r[:, :3], t_r.rank_mat, t_r.row_count, box_r, nb13.cutoff)
                u_all = rs.rowscan_sweep(atoms_r, t_r.row_start, count_r, t_r.col_ids, rs.sweep_scalars(box_r, nb13.cutoff),
                                         series13, rs.ENERGY, triangular=True)[:, 0].to(f64).sum()
                u_exc = nb13.exclusion_energy(x_r.to(f64), params_l[host_i].to(f64), box_r.to(f64))
                u_host = u_all - u_exc
                if r == 0 and lam == own14[0]:
                    host_parts = float(u_all), float(u_exc)
                u_rest = sum(pot.u(x_r.to(f64), p.to(f64), box_r.to(f64)) for i, (pot, p) in enumerate(zip(ctx14.potentials, params_l)) if i != host_i)
                ref14[r, lam] = float(u_host + u_rest)
    finite14 = np.isfinite(ref14)
    same_inf = bool((np.isfinite(res14.U_kl) == finite14).all())
    banded_rel = float(np.max(np.abs(res14.U_kl[finite14] - ref14[finite14]) / np.abs(ref14[finite14])))
    print(
        f"[14 banded] U_kl after {N14_STEPS_PER_FRAME + N14_STEPS_PER_FRAME} steps: {int(finite14.sum())} finite entries of "
        f"{K14 * K14} (the band |l - state(r)| <= {D14}), +inf pattern identical to the single sums: {same_inf}; max "
        f"|U - single| / |single| {banded_rel:.3e} (tol {TOL_BANDED_REL:g}; f64 sums, the host term's per-atom energies "
        f"from single launches on the replica's lists); U range {np.min(ref14[finite14]):.2f} to "
        f"{np.max(ref14[finite14]):.2f} kJ/mol; replica 0's host term: all-pairs sum {host_parts[0]:.2f}, its "
        f"exclusions {host_parts[1]:.2f}, net {host_parts[0] - host_parts[1]:.2f} kJ/mol (an f32 unit in the last place "
        f"at the all-pairs sum: {float(np.spacing(np.float32(abs(host_parts[0])))):.4f}) ({smi})"
    )
    check(same_inf, "[14] the banded U_kl's +inf pattern differs from the band")
    check(banded_rel <= TOL_BANDED_REL, "[14] the banded U_kl disagrees with single-system sums")

    # launches of a step that neither rebuilds nor moves the box, at K = 2
    # and K = 12, counted exactly: step 4 is captured into a CUDA graph
    # (never replayed; its noise draw too) and the graph's nodes are read
    # through the driver API. Profiler traces lose records, and lose them
    # together within a process (on an H100 80GB HBM3 one run read 913
    # kernels in all eight traces of such steps, another 947: the step's 936
    # and the state check's 11), so a trace's count at K = 2 and at 12 can
    # differ where the step's do not. Beside it, the aten operations step 3
    # dispatches.
    def step_launches(k):
        r = make_runner(k)
        r.batch.multiple_steps(2)  # the rebuild at step 1, then step 2
        with torch.no_grad(), count_ops() as ops:
            r.batch._one_step()  # step 3
        torch.cuda.synchronize()
        with torch.no_grad():
            nodes = graph_nodes(r.batch._one_step, r.batch._noise)  # step 4; the runner is left unusable
        return nodes, ops.n

    nodes2, ops2 = step_launches(2)
    nodes12, ops12 = step_launches(K14)
    l2, l12 = nodes2[0], nodes12[0]
    print(
        f"[14 launches] a step without a rebuild or a barostat move, captured in a CUDA graph: {l2} kernels at K = 2, "
        f"{l12} at K = {K14} (memory sets {nodes2[2]}, {nodes12[2]}; copies {nodes2[1]}, {nodes12[1]}; other nodes "
        f"{sum(nodes2.values()) - l2 - nodes2[1] - nodes2[2]}, {sum(nodes12.values()) - l12 - nodes12[1] - nodes12[2]}); "
        f"aten operations dispatched by the step before it: {ops2} at K = 2, {ops12} at K = {K14} ({smi})"
    )
    check(l2 > 0 and nodes2 == nodes12 and ops2 == ops12, "[14] a batched step's kernel launches grow with K")

    # the run: run_sims_hrex over the 12 windows, each iteration timed
    iter_s, eq_s = [], []
    advance_fn, equilibrate_fn = ReplicaExchangeRunner.advance_frame, ReplicaExchangeRunner.equilibrate

    def timed_advance(self, n_steps):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = advance_fn(self, n_steps)
        iter_s.append(time.perf_counter() - t_start)
        return out

    def timed_equilibrate(self, n_steps, *args, **kwargs):
        t_start = time.perf_counter()
        equilibrate_fn(self, n_steps, *args, **kwargs)
        torch.cuda.synchronize()
        eq_s.append(time.perf_counter() - t_start)

    ReplicaExchangeRunner.advance_frame, ReplicaExchangeRunner.equilibrate = timed_advance, timed_equilibrate
    zero_counts()
    t0 = time.perf_counter()
    try:
        result14, trajs14, diag14, _ = fe13.run_sims_hrex(states13, md14, print_diagnostics_interval=None)
    finally:
        ReplicaExchangeRunner.advance_frame, ReplicaExchangeRunner.equilibrate = advance_fn, equilibrate_fn
    torch.cuda.synchronize()
    t_run14 = time.perf_counter() - t0
    launches14, plain14_calls = read_counts()
    steps14 = N14_EQ + N14_FRAMES * N14_STEPS_PER_FRAME
    seg_s = sum(iter_s) + sum(eq_s)
    rate14 = K14 * steps14 / seg_s
    rate13 = 1e3 / step13_ms
    print(
        f"[14 run] run_sims_hrex, {K14} replicas: {t_run14:.1f} s with the u_kln and pair BAR; equilibration "
        f"{N14_EQ} steps {sum(eq_s):.2f} s ({sum(eq_s) * 1e3 / N14_EQ:.2f} ms/step); {N14_FRAMES} iterations of "
        f"{N14_STEPS_PER_FRAME} steps, each with its banded U_kl and {K14**3} swap attempts: "
        f"{np.mean(iter_s):.4f} s per iteration (min {min(iter_s):.4f}, max {max(iter_s):.4f}); {rate14:.1f} "
        f"replica-steps/s over the run's segments, against phase 13's sequential window step {step13_ms:.4f} ms "
        f"({rate13:.1f} replica-steps/s), ratio {rate14 / rate13:.2f} (host clock); launches in the run {launches14}, "
        f"plain calls {plain14_calls}; depth cut from DEFAULT_HREX_PARAMS (10,000 equilibration steps, 1,000 frames "
        f"of 400 steps) to {N14_EQ} and {N14_FRAMES} of {N14_STEPS_PER_FRAME}; windows, atoms and replicas not cut "
        f"({smi})"
    )
    check(plain14_calls == 0, "[14] HREX ran a plain sweep")
    check(launches14["rowscan_sweep_batched"] >= steps14 + N14_FRAMES, "[14] HREX did not launch the batched sweep every step")
    batched_row["launches"] = launches14["rowscan_sweep_batched"] / (K14 * steps14)
    batched_row["path"] = "HREX over the 12 windows, run_sims_hrex (per replica-step; one F launch a step for all replicas)"
    rates14 = diag14.cumulative_swap_acceptance_rates[-1]
    print(f"[14 swaps] acceptance per neighbour pair over {N14_FRAMES} iterations: "
          + " ".join(f"{k}-{k + 1} {r:.3f}" for k, r in enumerate(rates14))
          + f"; final permutation {diag14.replica_idx_by_state_by_iter[-1]}; normalized KL divergence "
          f"{diag14.normalized_kl_divergence:.4f} ({smi})")

    # the batched step's device idle share, 20 steps profiled (one rebuild, one barostat move)
    run12 = make_runner(K14)
    run12.batch.multiple_steps(N14_TIMED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run12.batch.multiple_steps(N14_TIMED)
    torch.cuda.synchronize()
    step14_ms = (time.perf_counter() - t0) * 1e3 / N14_TIMED
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof14:
        run12.batch.multiple_steps(20)
        torch.cuda.synchronize()
    events14 = prof14.key_averages()
    busy14 = sum(e.self_device_time_total for e in events14 if e.device_type == DeviceType.CUDA) / 1e3 / 20
    print(f"{smi}; 20 batched steps of {K14} replicas\n{events14.table(sort_by='cuda_time_total', row_limit=30)}", file=sys.stderr)
    busy14_text = (
        f"device busy {busy14:.4f} ms/step, {1 - busy14 / step14_ms:.3f} of the unprofiled step idle"
        if busy14 > 0 else "device busy not measured (the profiler saw no device time)"
    )
    print(f"[14 profile] the batched step of {K14} replicas: {step14_ms:.4f} ms/step unprofiled over {N14_TIMED} steps "
          f"({K14 * 1e3 / step14_ms:.1f} replica-steps/s); 20 profiled steps: {busy14_text} ({smi}); table on stderr")

    finite_res = bool(np.isfinite(result14.dGs).all() and np.isfinite(result14.dG_errs).all())
    for k, r in enumerate(result14.bar_results):
        print(f"[14 bar] pair {k}-{k + 1}: dG {r.dG:.4f} +- {r.dG_err:.4f} kJ/mol, overlap {r.overlap:.4f}")
    frames_ok = len(trajs14) == K14 and all(len(t.frames) == N14_FRAMES and np.isfinite(t.frames).all() for t in trajs14)
    print(
        f"[14 bar] edge ethanol -> propane, solvent, HREX: dG {float(np.sum(result14.dGs)):.4f} +- "
        f"{float(np.linalg.norm(result14.dG_errs)):.4f} kJ/mol ({N14_FRAMES} frames a state: not converged); "
        f"{len(result14.bar_results)} pairs, all finite {finite_res}; {len(trajs14)} trajectories of {N14_FRAMES} "
        f"frames, finite {frames_ok}; diagnostics: transition matrix {diag14.transition_matrix.shape}, relaxation time "
        f"{diag14.relaxation_time:.3f} ({smi})"
    )
    check(len(result14.bar_results) == K14 - 1 and finite_res, "[14] the HREX pair BAR results are not 11 finite pairs")
    check(frames_ok, "[14] the HREX trajectories are not 12 finite ones of the frames asked for")

    phase_time("14")

    # -- 15. the state builder ------------------------------------------------------------
    # the 12 windows built on this machine from the cache's recorded inputs
    # (SMILES, conformers, box, seed, λ grid) by the port's builder, held
    # against the cache's arrays; only x0 and box0 still come from the cache
    t_phase15 = time.perf_counter()
    f64 = torch.float64
    strict_before = os.environ.get("TM_STRICT_CHARGES")
    os.environ["TM_STRICT_CHARGES"] = "1"  # AM1 or fail: no Gasteiger charges stand in
    try:
        rec15 = {}
        t0 = time.perf_counter()
        states15 = build_rbfe_solvent(device=dev, dtype=f64, record=rec15)
        torch.cuda.synchronize()
        t_build15 = time.perf_counter() - t0
        st15 = rec15["single_topology"]
        for mol in (st15.mol_a, st15.mol_b):
            check(AM1ELF10_CHARGE_CACHE in mol.props and GASTEIGER_CHARGE_CACHE not in mol.props,
                  f"[15] {mol.name}'s base charges are not AM1ELF10")
        refs15 = load_rbfe_solvent(device=dev, dtype=f64)
        # window 6 again in the MD path's dtype, for its force and its run
        rec15b = {}
        built15 = build_rbfe_solvent(device=dev, dtype=f32, windows=[N15_WINDOW], record=rec15b)[0]
        ref15 = load_rbfe_solvent(device=dev, dtype=f32, windows=[N15_WINDOW])[0]
    finally:
        if strict_before is None:
            os.environ.pop("TM_STRICT_CHARGES")
        else:
            os.environ["TM_STRICT_CHARGES"] = strict_before
    sec15 = rec15["seconds"]
    stages15 = ", ".join(f"{k} {v:.3f} s" for k, v in sec15.items() if k != "windows")
    print(
        f"[15 build] build_rbfe_solvent, 12 windows on the card in {t_build15:.2f} s, host clock: {stages15}; "
        f"setup_initial_state per window {' '.join(f'{v:.3f}' for v in sec15['windows'])} s; built again for window "
        f"{N15_WINDOW} in f32: {', '.join(f'{k} {v:.3f} s' for k, v in rec15b['seconds'].items() if k != 'windows')}, "
        f"the window {rec15b['seconds']['windows'][0]:.3f} s ({smi})"
    )
    a15 = rbfe_cache_arrays()
    core_ok = np.array_equal(rec15["core"], rbfe_cache_metadata(a15)["core"])
    print(f"[15 core] {len(rec15['core'])} mapped atoms, the cache's core: {core_ok}")
    check(core_ok, "[15] the core differs from the cache's")
    d15 = build_differences(states15, refs15)
    same15 = all(
        np.array_equal(s.integrator.masses, r.integrator.masses) and np.array_equal(s.v0, r.v0)
        and np.array_equal(s.interacting_atoms, r.interacting_atoms) and s.barostat.seed == r.barostat.seed
        and len(s.barostat.group_idxs) == len(r.barostat.group_idxs)
        and all(np.array_equal(g, h) for g, h in zip(s.barostat.group_idxs, r.barostat.group_idxs))
        for s, r in zip(states15, refs15)
    )
    print(
        f"[15 arrays] 12 windows x {len(states15[0].potentials)} terms: index arrays equal {d15['indices_equal']}; "
        f"largest difference of a column without the AM1 charges {d15['other_rel']:.3e} of its largest |value| (tol "
        f"{TOL_BUILD_REL:g}); masses, barostat groups and seeds, interacting atoms and v0 equal {same15}"
    )
    print(
        f"[15 charges] the ligand charges (interaction group's q) within {d15['q_e']:.3e} e, the pair list's q_i q_j "
        f"within {d15['qq_e']:.3e} e a charge (tol {TOL_CHARGE_E:g} e); the same columns relative to their largest "
        f"|value| (the other columns' measure, printed): {d15['q_rel']:.3e} and {d15['qq_rel']:.3e}; numpy {np.__version__}, "
        f"OpenBLAS {blas_kernels()} (the AM1 SCF's stop follows their rounding: probes/am1_host.py)"
    )
    print(
        f"[15 seeds] windows bitwise the cache's in every parameter: {len(d15['bitwise'])} of 12 {d15['bitwise']}; "
        f"integrator seeds equal: {len(d15['seeds'])} of 12 {d15['seeds']} (the seed hashes the parameters' bytes: "
        f"ROADMAP P18)"
    )
    check(d15["indices_equal"], "[15] an index array differs from the cache's")
    check(d15["other_rel"] <= TOL_BUILD_REL, "[15] a parameter differs from the cache's")
    check(max(d15["q_e"], d15["qq_e"]) <= TOL_CHARGE_E, "[15] a ligand charge differs from the cache's")
    check(same15, "[15] masses, groups, seeds, interacting atoms or v0 differ from the cache's")

    # window 6 in the MD path's dtype: the force at the cache's x0 and 200 steps
    for s in (built15, ref15):
        configure_all_pairs(s)
    x15 = torch.as_tensor(built15.x0, device=dev, dtype=f32)
    box15 = torch.as_tensor(built15.box0, device=dev, dtype=f32)
    f_built = sum(p.energy_force(x15, box15)[1] for p in built15.potentials)
    f_ref = sum(p.energy_force(x15, box15)[1] for p in ref15.potentials)
    nb15 = next(p for p in ref15.potentials if isinstance(p, Nonbonded))
    ap15 = float(torch.linalg.vector_norm(NonbondedAllPairs.energy_force(nb15, x15, box15)[1]))
    f_rel15 = float(torch.linalg.vector_norm(f_built - f_ref)) / ap15
    print(f"[15 force] window {N15_WINDOW} at the cache's x0, built vs cache-loaded total force: |diff| / |all-pairs "
          f"force| {f_rel15:.3e} (tol {TOL_BUILD_FORCE:g}) ({smi})")
    check(f_rel15 <= TOL_BUILD_FORCE, "[15] the built window's force disagrees with the cache-loaded one's")

    def run15(state):
        ctx = get_context(state, MDParams(n_frames=1, n_eq_steps=0, steps_per_frame=1, seed=2023))
        ctx.multiple_steps(N15_STEPS)
        torch.cuda.synchronize()
        return [f(ctx) for f in (Context.get_x_t, Context.get_v_t, Context.get_box)]

    zero_counts()
    t0 = time.perf_counter()
    out_built = run15(built15)
    t_run15 = time.perf_counter() - t0
    launches15, plain15_calls = read_counts()
    finite15 = all(np.isfinite(v).all() for v in out_built)
    # where the f32 parameters are the cache's bits, the run under the cache's
    # integrator seed must be bitwise the cache-loaded state's run
    same_f32 = all(d["bitwise"] and d["indices_equal"] for d in term_differences(built15, ref15).values())
    same_seed = built15.integrator.seed == ref15.integrator.seed
    bitwise_run = None
    if same_f32:
        reseeded = replace(built15, integrator=replace(built15.integrator, seed=ref15.integrator.seed))
        out_ref = run15(ref15)
        bitwise_run = all(np.array_equal(u, v) for u, v in zip(run15(reseeded), out_ref))
        if same_seed:
            bitwise_run &= all(np.array_equal(u, v) for u, v in zip(out_built, out_ref))
    print(
        f"[15 run] window {N15_WINDOW} from the built state: {N15_STEPS} steps in {t_run15:.2f} s host clock, finite "
        f"{finite15}; launches {launches15}, plain calls {plain15_calls}; integrator seed {built15.integrator.seed} "
        f"(cache {ref15.integrator.seed}); f32 parameters bitwise the cache's {same_f32}; under the cache's seed, "
        f"x, v, box bitwise the cache-loaded run's: {bitwise_run} ({smi})"
    )
    check(finite15, "[15] the built window's run is not finite")
    check(plain15_calls == 0, "[15] the built window ran a plain sweep")
    check(launches15["rowscan_sweep"] >= N15_STEPS, "[15] the built window did not launch the rowscan kernel every step")
    check(bitwise_run is not False, "[15] the built window's run differs from the cache-loaded one's")
    masked_row["launches_from_built_states"] = launches15["rowscan_sweep"] / N15_STEPS
    print(f"[15 time] phase 15 took {time.perf_counter() - t_phase15:.1f} s, host clock ({smi})")

    # -- 17. the exact-erfc and masked forms at the leg's window 0 ----------------------------
    # the host term of window 0 (6,404 atoms, the 11 hybrid-ligand atoms masked out) configured
    # as kernel="v1" (nb_tiles' exact form: JAX's "tiled" and, on the card, its minimizers'
    # dense form) and "gather": each kernel against its plain version under the mask, gather
    # against the masked rowscan force (the same polynomial function), v1 against the CPU's
    # float64 dense form, and N17_STEPS NPT steps of window N17_WINDOW under each, twice,
    # bitwise. kernel="dot" falls back to rowscan at the leg's 4.03 nm box, as JAX's does (its
    # image bound needs row half-extents + cutoff + skin under box / 2): its masked form runs
    # the same checks on DHFR with the protein's last N17_DOT_OUT atoms out of the term
    import copy

    t_phase17 = time.perf_counter()
    forms17 = {}
    for kernel in ("v1", "gather", "dot"):
        term = copy.deepcopy(nb13)
        term.configure(box13, x13, kernel=kernel)
        check(term.kernel == (kernel if kernel != "dot" else "rowscan"),
              f"[17] the host term took kernel={term.kernel!r} for {kernel!r} under the mask")
        forms17[kernel] = term
    margins17 = {
        sort: float(dk.build_dotscan_tiles(x13, box13, nb13.cutoff + SKIN, 32, triangular=True, sort=sort,
                                           atom_mask=mask13).margin)
        for sort in ("snake", "hilbert")
    }
    print(f"[17 dot] window 0: the image bound's margin on the host atoms at cutoff + skin, snake {margins17['snake']:.4f} "
          f"nm, hilbert {margins17['hilbert']:.4f} nm (must exceed 0.1): kernel=\"dot\" takes "
          f"{forms17['dot'].kernel!r}, as JAX's configure_pallas does ({smi})")
    check(max(margins17.values()) <= 0.1, "[17] dot's image bound holds at window 0: the dot form should run there")
    hc17 = setup_dhfr_native(waters_first=True, device=dev, dtype=f32)
    bps17 = hc17.host_system.get_U_fns()
    nb_i17 = next(i for i, p in enumerate(bps17) if isinstance(p, Nonbonded))
    nb_d = bps17[nb_i17]
    keep17 = np.arange(n - N17_DOT_OUT)  # waters first: the out atoms are the protein's last
    dot17 = Nonbonded(n, *nb_d._exclusions, nb_d.beta, nb_d.cutoff, nb_d.params.cpu().numpy(), atom_idxs=keep17,
                      device=dev, dtype=f32)
    rs_d17 = copy.deepcopy(dot17).configure(box, x_min, kernel="rowscan")
    dot17.configure(box, x_min, kernel="dot")
    check(dot17.kernel == "dot", "[17] masked DHFR did not take kernel=\"dot\"")
    forms17["dot"] = dot17
    mask_d17 = dot17.atom_mask
    params17 = nb13.params
    tiles17 = nbk.build_block_tiles(x13, params17, box13, nb13.cutoff, forms17["v1"].dp_max_tiles, DP_CB, True, mask13)
    check(int(tiles17.overflow) == 0, "[17] masked block-tile list overflow")
    nb_args17 = (tiles17.atoms, tiles17.row_start, tiles17.row_count, tiles17.col_ids,
                 nbk.tile_scalars(box13, nb13.beta, nb13.cutoff))
    lists17 = gk.build_gather_neighbors(x13, box13, nb13.cutoff, forms17["gather"].max_nbrs, atom_mask=mask13)
    check(int(lists17.overflow) == 0, "[17] masked gather list overflow")
    atoms_g17 = rs.assemble_atoms(x13, box13, lists17.pad_order, rs.param_rows(params17, lists17.pad_order, n13, mask13))
    scal17 = rs.sweep_scalars(box13, nb13.cutoff)
    g_args17 = (atoms_g17, lists17.counts, lists17.nbr, lists17.tri_start, scal17, series13)
    dt17 = dk.build_dotscan_tiles(x_min, box, dot17.cutoff + SKIN, dot17.md_max_pairs, triangular=True, sort=dot17.dot_sort,
                                  atom_mask=mask_d17)
    check(int(dt17.invalid) == 0, "[17] masked dot lists invalid (overflow or the image bound)")
    atoms_d17 = rs.assemble_atoms(x_min, box, dt17.pad_order, rs.param_rows(dot17.params, dt17.pad_order, n, mask_d17))
    d_args17 = (atoms_d17, dt17.row_start, dt17.row_count, dt17.col_ids, dt17.rcen_q, rs.sweep_scalars(box, dot17.cutoff),
                rs.es_energy_force_series(dot17.beta, dot17.cutoff))
    keep_t17 = torch.as_tensor(keep17, device=dev)
    pairs_d17 = pairs_within_cutoff(x_min[keep_t17], box, dot17.params[keep_t17, 3], dot17.cutoff)
    print(
        f"[17 shapes] window 0 under the host mask ({n_masked} atoms out): v1 DP tiles {forms17['v1'].dp_max_tiles}, "
        f"listed {int(tiles17.row_count.sum())}, MD tiles {forms17['v1'].md_max_tiles}; gather max_nbrs "
        f"{forms17['gather'].max_nbrs} (longest list {int(lists17.counts.max())}), MD {forms17['gather'].md_max_nbrs}; "
        f"pairs within the cutoff {pairs13}; DHFR with {N17_DOT_OUT} atoms out: dot sort {dot17.dot_sort}, MD max_pairs "
        f"{dot17.md_max_pairs}, listed {int(dt17.row_count.sum())}, image-bound margin on the kept atoms "
        f"{float(dt17.margin):.4f} nm, pairs within the cutoff {pairs_d17} ({smi})"
    )
    res17 = {}
    for label, kernel, plain in (
        ("nb_tiles exact F", lambda: nbk.nb_tiles(*nb_args17, nbk.FORCE, DP_CB, triangular=True),
         lambda: nbk.nb_tiles_plain(*nb_args17, nbk.FORCE, DP_CB, triangular=True)),
        ("nb_tiles exact F+U", lambda: nbk.nb_tiles(*nb_args17, nbk.UF, DP_CB, triangular=True),
         lambda: nbk.nb_tiles_plain(*nb_args17, nbk.UF, DP_CB, triangular=True)),
        ("gather F", lambda: gk.gather_sweep(*g_args17, gk.FORCE),
         lambda: gk.gather_sweep_plain(atoms_g17, lists17.counts, lists17.nbr, scal17, series13, gk.FORCE)),
        ("gather F+U", lambda: gk.gather_sweep(*g_args17, gk.FORCE_ENERGY),
         lambda: gk.gather_sweep_plain(atoms_g17, lists17.counts, lists17.nbr, scal17, series13, gk.FORCE_ENERGY)),
        ("dot MD F", lambda: dk.dotscan_sweep(*d_args17, dk.FORCE, True), lambda: dk.dotscan_sweep_plain(*d_args17, dk.FORCE, True)),
    ):
        res17[label] = compare_kernel("17", [(f"{label} under the mask", kernel, plain)])

    f_rs17 = NonbondedAllPairs.energy_force(nb13, x13, box13)[1]
    f_g17 = NonbondedAllPairs.energy_force(forms17["gather"], x13, box13)[1]
    rel_g17 = float(torch.linalg.vector_norm(f_g17 - f_rs17) / torch.linalg.vector_norm(f_rs17))
    f_rsd17 = NonbondedAllPairs.energy_force(rs_d17, x_min, box)[1]
    d_init, d_apply = NonbondedAllPairs.md_force_provider(dot17)[:2]
    f_d17 = d_apply(d_init(x_min, box), x_min, box, 0)[0]
    rel_d17 = float(torch.linalg.vector_norm(f_d17 - f_rsd17) / torch.linalg.vector_norm(f_rsd17))
    print(f"[17 force] all-pairs force under the mask against the masked rowscan form's, |diff| / |all-pairs force|: "
          f"gather (window 0) {rel_g17:.3e}, dot's MD provider (DHFR) {rel_d17:.3e} (tol {TOL_ALT_FORCE:g}) ({smi})")
    check(rel_g17 <= TOL_ALT_FORCE and rel_d17 <= TOL_ALT_FORCE, "[17] gather or dot disagrees with the masked rowscan form")

    t0 = time.perf_counter()
    cpu17 = load_rbfe_solvent(device="cpu", dtype=torch.float64, windows=[0])[0]
    host_cpu17 = cpu17.potentials[host_i]
    x64 = x13.double().cpu()
    host_cpu17.configure(box13.double().cpu(), x64, kernel="dense")
    with torch.no_grad():
        u_ref17, f_ref17 = host_cpu17.energy_force(x64, box13.double().cpu())
    t_dense17 = time.perf_counter() - t0
    v1 = forms17["v1"]
    u_v1, f_v1 = v1.energy_force_f64(x13.double(), box13.double())
    u_ap17 = float(NonbondedAllPairs.energy_force_f64(v1, x13.double(), box13.double())[0])
    f_ap17 = float(torch.linalg.vector_norm(NonbondedAllPairs.energy_force(v1, x13, box13)[1]))
    rounding17 = 2.0**-24 * abs(u_ap17)
    du17 = float(u_v1) - float(u_ref17)
    rel_v1 = float(torch.linalg.vector_norm(f_v1.cpu() - f_ref17)) / f_ap17
    print(f"[17 exact] v1 on the card (f32 sweep, energies summed in f64, exclusions exact in f64) against the CPU's "
          f"float64 dense form ({t_dense17:.1f} s): U {float(u_v1):.4f} vs {float(u_ref17):.4f} kJ/mol, dU {du17:.3e} = "
          f"{du17 / rounding17:.3f} f32 roundings of U_all-pairs {u_ap17:.1f} (limit {TOL_F64_U_ROUNDINGS:g}); force "
          f"|diff| / |all-pairs force| {rel_v1:.3e} (tol {TOL_FORCE_REL_NORM:g}) ({smi})")
    check(abs(du17) <= TOL_F64_U_ROUNDINGS * rounding17, "[17] v1's energy off the CPU's float64 exact energy")
    check(rel_v1 <= TOL_FORCE_REL_NORM, "[17] v1's force off the CPU's float64 exact force")
    # the control: the same reading with the sweep's erfc swapped for A&S 7.1.26 (the JAX
    # kernel's exact form, 1.5e-7 from erfc, which the kernel builds in DP only), by the
    # difference of the plain version's two UF sweeps on the card; the two limits must tell it
    inv17 = torch.argsort(tiles17.pad_order[:n13])
    uf17 = {es: nbk.nb_tiles_plain(*nb_args17, nbk.UF, DP_CB, es, triangular=True).double() for es in (None, nbk.AS7126)}
    d17 = uf17[nbk.AS7126] - uf17[None]
    du_as17 = du17 + float(d17[:, 0].sum())
    f_as17 = f_v1 - d17[inv17, 1:4]
    rel_as17 = float(torch.linalg.vector_norm(f_as17.cpu() - f_ref17)) / f_ap17
    print(f"[17 control] the same with A&S 7.1.26 in place of erfc: dU {du_as17:.3e} = {du_as17 / rounding17:.3f} f32 "
          f"roundings (limit {TOL_F64_U_ROUNDINGS:g}); force |diff| / |all-pairs force| {rel_as17:.3e} (tol "
          f"{TOL_FORCE_REL_NORM:g}); it must fail one ({smi})")
    check(abs(du_as17) > TOL_F64_U_ROUNDINGS * rounding17 or rel_as17 > TOL_FORCE_REL_NORM,
          "[17] the exact-form limits do not tell erfc from A&S 7.1.26")

    s17 = states13[N17_WINDOW]
    sweep_of = {"v1": nbk.nb_tiles, "gather": gk.gather_sweep, "dot": dk.dotscan_sweep}
    launches17 = {}

    def run17(kernel):
        if kernel == "dot":  # masked DHFR from the main path's minimized start
            ctx = make_context([dot17 if i == nb_i17 else p for i, p in enumerate(bps17)])
        else:
            pots = [copy.deepcopy(p) for p in s17.potentials]
            pots[host_i].configure(torch.as_tensor(s17.box0, device=dev, dtype=f32),
                                   torch.as_tensor(s17.x0, device=dev, dtype=f32), kernel=kernel)
            ctx = Context(torch.as_tensor(s17.x0, dtype=f32), s17.v0, s17.box0, s17.integrator, pots,
                          movers=[s17.barostat], device=dev)
        ctx.multiple_steps(N17_STEPS)
        torch.cuda.synchronize()
        return [f(ctx) for f in (Context.get_x_t, Context.get_v_t, Context.get_box)]

    for kernel in forms17:
        zero_counts()
        t0 = time.perf_counter()
        out_a = run17(kernel)
        t_run = time.perf_counter() - t0
        counts17, plain17 = read_counts()
        out_b = run17(kernel)
        finite = all(bool(np.isfinite(a).all()) for a in out_a)
        same = all(np.array_equal(a, b) for a, b in zip(out_a, out_b))
        launches17[kernel] = counts17[sweep_of[kernel].__name__]
        where = f"window {N17_WINDOW}" if kernel != "dot" else f"DHFR with {N17_DOT_OUT} atoms out"
        print(f"[17 run] {where}, {N17_STEPS} NPT steps under kernel={kernel!r}: {t_run:.2f} s host clock, "
              f"finite {finite}, bitwise on repeat {same}; launches {counts17}, plain calls {plain17} ({smi})")
        check(finite and same, f"[17] the {kernel} run is not finite or not bitwise on repeat")
        check(launches17[kernel] >= N17_STEPS and plain17 == 0 and counts17["rowscan_sweep"] == 0,
              f"[17] the {kernel} run did not launch its own kernel every step")

    host_pairs_bytes = 4 * int(tiles17.row_count.sum()) + 16 * tiles17.atoms.shape[0]
    rows17 = []
    for name17, source, replaces, label, pairs_label, pairs, nbytes, launches, path in (
        ("nb_tiles_exact_masked", "nb_tiles.cu", "nonbonded_kernel.py:213", "nb_tiles exact F+U", "nb_tiles_exact_UF", pairs13,
         tensor_bytes(tiles17.atoms, tiles17.row_start, tiles17.row_count) + host_pairs_bytes,
         None, "run_solvent's host FIRE and minimizations (per run; phase 16)"),
        ("gather_sweep_masked", "gather.cu", "gather_kernel.py:64", "gather F", "gather_sweep", pairs13,
         tensor_bytes(atoms_g17, lists17.counts, lists17.tri_start) + 4 * int(lists17.counts.sum()) + 16 * atoms_g17.shape[0],
         launches17["gather"] / N17_STEPS, f"window {N17_WINDOW} NPT, kernel=\"gather\" under the mask (per step)"),
        ("dotscan_sweep_masked", "dotscan.cu", "dotscan_kernel.py:82", "dot MD F", "dotscan_sweep", pairs_d17,
         tensor_bytes(atoms_d17, dt17.row_start, dt17.row_count, dt17.rcen_q) + 4 * int(dt17.row_count.sum()) + 16 * atoms_d17.shape[0],
         launches17["dot"] / N17_STEPS, f"DHFR NPT with {N17_DOT_OUT} atoms out, kernel=\"dot\" (per step)"),
    ):
        err, ms, plain_ms = res17[label]
        row = kernel_entry(name17, source, replaces, err, ms, plain_ms, pairs, nbytes, ops=pair_ops(pairs_label, pairs))
        row["name"], row["launches"], row["path"] = name17, launches, path
        row["ms_by_mode"] = {k: v[1] for k, v in res17.items() if k.split()[0] == label.split()[0]}
        rows17.append(row)
    rows17[0]["launches_npt_per_step"] = launches17["v1"] / N17_STEPS
    for row in rows17:
        launches = "phase 16's, from the worker" if row["launches"] is None else row["launches"]
        print(f"[17 bound] {row['name']}: {row['ms']:.4f} ms against its bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']} over the pairs of its system; plain {row['plain_ms']:.2f} ms; launches {launches} "
              f"({row['path']}) ({smi})")
    print(f"[17 time] phase 17 took {time.perf_counter() - t_phase17:.1f} s, host clock ({smi})")

    # -- 16, 19, 21, 22 in the worker, beside 20 and 18 here ----------------------------------------
    # 16. the solvent leg from two SMILES; 19. the absolute hydration leg, windowed and by SMC; 21. the
    # standalone samplers, the training path and the last utilities; 22. the complex leg: run_complex on a
    # solvated capped helix
    worker_proc, handoff = start_worker(rows17[0]["ms"])

    # -- 20. water sampling: the probe-in-water ladder's HREX with the TIBD sampler ---------------------
    ladder20 = phase20(dev, smi, zero_counts, read_counts, batched_row)

    # -- 18. REST and local MD ----------------------------------------------------------------
    inputs16 = take_handoff(handoff, "inputs16", lambda: worker_proc.poll() is None)
    phase18(dev, smi, zero_counts, read_counts, masked_row, batched_row, states15, states13, float(np.sum(result14.dGs)),
            inputs16)

    # -- 24. the reset's seed, the DHFR-size water box, the prefactors and the examples (while the worker ends) --
    phase24(dev, smi, zero_counts, read_counts, kernel_row, masked_row, batched_row, rows17[0], states13)

    # the worker's output, and what its phases add to the rows and the plots seen
    added = finish_worker(worker_proc, handoff)
    for row, key in ((masked_row, "masked"), (batched_row, "batched"), (rows17[0], "exact")):
        row.update(added["rows"][key])
    PLOTS_SEEN.update(added["plots"])
    check(bool(rows17[0]["launches"]), "[16] run_solvent's FIRE and minimizations launched no nb_tiles kernel")

    # -- 23. HREX checkpoint and resume, frames on disk, the client, the interaction group, the plots ------
    phase23(dev, smi, zero_counts, read_counts, batched_row, make_runner, ladder20, states13, args13)

    # -- 25. the sorted-state step against the canonical step, on DHFR and an RBFE window --------------
    phase25(dev, smi, zero_counts, read_counts, kernel_row, dict(make_context=make_context, x_min=x_min, box=box),
            states13)

    # -- 26. the mesh code: the row slab, spatially decomposed MD, sharded HREX, the replica mesh -------------
    phase26(dev, smi, zero_counts, read_counts, kernel_row,
            dict(bps=bps, x_min=x_min, box=box, masses=masses, v0=v0), make_runner, states13)

    print(f"[time] the script took {time.perf_counter() - T_START:.1f} s up to its kernels line, host clock ({smi})")
    print(json.dumps({"kernels": [kernel_row, masked_row, batched_row, nb_row, gather_row, quad_row, dot_row, *probe_rows,
                                  *rows17]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        T_START = float(sys.argv[3])
        sys.exit(worker(sys.argv[2], float(sys.argv[4])))
    sys.exit(main())
