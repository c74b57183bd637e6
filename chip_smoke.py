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
HREX's replicas run through the rowscan kernel's replica-batched form; two
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
Newton-triangular form (every path's) in modes DP, UF (exact and
polynomial) and F, and in its symmetric form (the first design) in DP and
F, with the slots listed, kept by the kernel's sub-tile and column culls
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
bitwise the cache-loaded state's run.
Every path runs with all launch and plain-call counts set to
0 just before it and read just after. Then a JSON line on the kernels
(time; launches per NPT step of the path named in `path`, per Adam step of
the training path where the kernel has one, per replica-step of HREX for
the batched form, per run of phase 12 for the probes; bound; plain time), the card's name and power limit from
nvidia-smi, and as the last line {"ok": true, "device": {...}}.

Usage, from the repository root:  python3 chip_smoke.py
Without a CUDA card, or when any phase fails, the script exits non-zero and
prints no result.
"""

import ctypes
import json
import os
import subprocess
import sys
import time
from collections import Counter
from dataclasses import replace

TEMP, DT, FRICTION, PRESSURE, BAROSTAT_INTERVAL = 300.0, 2.5e-3, 1.0, 1.013, 25
N_FIRE, N_STEPS, N_PROFILE, N_DET = 400, 1000, 50, 100
N_FRAMES, FRAME_INTERVAL, N_ADAM, ADAM_LR, S_START = 8, 100, 5, 2e-3, 1.01
N_ALT = 500
# phase 13, the solvent RBFE leg: depth cut from the JAX package's
# DEFAULT_MD_PARAMS (fe/rbfe.py: 10,000 equilibration steps, 1,000 frames of
# 400 steps) to fit the script's time; the 12 windows and 6,404 atoms are not cut
N13_EQ, N13_FRAMES, N13_STEPS_PER_FRAME, N13_TIMED, N13_REUSE = 500, 20, 50, 200, 60
# phase 14, HREX over the same 12 windows: DEFAULT_HREX_PARAMS (fe/rbfe.py:
# max_delta_states 4, K^3 swap attempts an iteration) with its depth cut as
# phase 13's (10,000 equilibration steps, 1,000 frames of 400 steps in the
# JAX package); the windows, atoms and replicas are not cut
N14_EQ, N14_FRAMES, N14_STEPS_PER_FRAME, N14_MAX_DELTA, N14_TIMED = 500, 20, 50, 4, 40
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

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
    from timemachine_torch.probes import tile_census as tc
    from timemachine_torch.testsystems.dhfr import setup_dhfr
    from timemachine_torch.ff.handlers import AM1ELF10_CHARGE_CACHE, GASTEIGER_CHARGE_CACHE
    from timemachine_torch.probes.am1_host import blas_kernels
    from timemachine_torch.testsystems.rbfe_solvent import build_differences, build_rbfe_solvent, load_rbfe_solvent, term_differences
    from timemachine_torch.testsystems.rbfe_solvent import load_arrays as rbfe_cache_arrays
    from timemachine_torch.testsystems.rbfe_solvent import metadata as rbfe_cache_metadata

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sweeps = (
        rs.rowscan_sweep, rs.rowscan_sweep_batched, nbk.nb_tiles, gk.gather_sweep, qk.quadscan_sweep,
        dk.dotscan_sweep, fp.fp32_peak, br.bf16_rate,
    )
    plains = (
        rs.rowscan_sweep_plain, rs.rowscan_sweep_batched_plain, nbk.nb_tiles_plain, gk.gather_sweep_plain,
        qk.quadscan_sweep_plain, dk.dotscan_sweep_plain, fp.fp32_peak_plain, br.bf16_rate_plain,
    )

    def zero_counts():
        """Every kernel's launch count and every plain version's call count
        to 0, just before a path runs."""
        for fn in sweeps:
            fn.launches = 0
        for fn in plains:
            fn.calls = 0

    def read_counts():
        """({kernel: launches}, plain calls) since zero_counts()."""
        return {fn.__name__: fn.launches for fn in sweeps}, sum(fn.calls for fn in plains)

    # -- 1. device ------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {name}, count {count}, nvidia-smi: {smi}, torch {torch.__version__}, cuda {torch.version.cuda}")

    # -- 2. kernel build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_libraries(*_build.LIBRARIES)
    t_build = time.perf_counter() - t0
    for lib in _build.LIBRARIES:
        log = _build.build_log(lib).splitlines()
        ptxas = [ln.strip() for ln in log[1:] if "registers" in ln or "spill" in ln]
        print(f"[2 build] {lib}: {log[0]} | " + " | ".join(ptxas))
    print(f"[2 build] {len(_build.LIBRARIES)} libraries in {t_build:.1f} s, one nvcc each, in parallel ({smi})")

    # -- 3. kernel vs plain at DHFR shapes -------------------------------------------
    hc = setup_dhfr(waters_first=True, device=dev, dtype=f32)
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
        ms over 20 launches and 2 plain calls. Returns the first's (max_abs,
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
            ms = cuda_ms(kernel, 20)
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

    hc_cpu = setup_dhfr(waters_first=True, device="cpu", dtype=f32)
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
    ms_end = cuda_ms(lambda: rs.rowscan_sweep(*end_args, rs.FORCE, **end_form), 20)
    print(
        f"[4 invariant] image-bound margin at cutoff + skin: {float(tiles.margin):.4f} nm at the start, "
        f"{float(t_end.margin):.4f} nm at the end; largest |dU/dx| {grad_end:.4e} of the kernel's fixed-point "
        f"limit {nbk.FIX_LIMIT:.4e} kJ/mol/nm (NaN beyond); main form F at the end state {ms_end:.4f} ms over "
        f"{(int(count_end.sum()) + n_rows) * rs.ROW * rs.COL} slots ({smi})"
    )
    check(grad_end < nbk.FIX_LIMIT, "[4] |dU/dx| beyond the kernel's fixed-point limit")

    # -- 5. determinism -----------------------------------------------------------------
    bitwise_repeat("5", bps)

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
    modes6 = (("DP", nbk.DP, None), ("UF-exact", nbk.UF, None), ("UF-poly", nbk.UF, poly), ("F", nbk.FORCE, None))
    res6 = {}
    for form in ("triangular", "symmetric"):
        for label, mode, es in modes6:
            if form == "symmetric" and mode == nbk.UF:
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
        dp = nbk.nb_tiles_plain(*args7, triangular=True)
        dp_max = torch.maximum(dp_max, nbk.nb_tiles(*args7, triangular=True).abs().amax(0))
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

    # -- 8. the kernel="v1" path --------------------------------------------------------
    hc8 = setup_dhfr(waters_first=True, device=dev, dtype=f32)
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
        hc_k = setup_dhfr(waters_first=True, device=dev, dtype=f32)
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
        f"{ms_fma2:.4f} ms at {2 * fp.INNER} (CUDA events over 20 launches each; ratio {ratio:.3f}, want "
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
    configure_all_pairs(cpu13)
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

    def make_runner(k):
        """A runner over the first k windows at their x0, lists built."""
        r = ReplicaExchangeRunner(
            ctx14, [[p.params for p in s.potentials] for s in states13[:k]], temperature=TEMP,
            neighbor_pairs=[(i, i + 1) for i in range(k - 1)], n_swap_attempts_per_iter=k**3, max_delta_states=D14,
            seed=2023,
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
    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    libcuda = ctypes.CDLL("libcuda.so.1")

    def graph_nodes(fn, generator):
        """Counter {CUgraphNodeType: nodes} of the CUDA graph that captures fn()
        (0 a kernel, 1 a memory copy, 2 a memory set)."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph):
            fn()
        torch.cuda.synchronize()
        handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
        check(libcuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "[14] cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * n.value)()
        check(libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "[14] cuGraphGetNodes failed")
        kinds = Counter()
        for node in nodes:
            kind = ctypes.c_int(-1)
            check(libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0, "[14] cuGraphNodeGetType failed")
            kinds[kind.value] += 1
        return kinds

    def step_launches(k):
        r = make_runner(k)
        r.batch.multiple_steps(2)  # the rebuild at step 1, then step 2
        with torch.no_grad(), CountOps() as ops:
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

    print(json.dumps({"kernels": [kernel_row, masked_row, batched_row, nb_row, gather_row, quad_row, dot_row, *probe_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
