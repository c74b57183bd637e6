"""Drive the PyTorch port's main path once on one CUDA card.

The run that bench.py times, through timemachine_torch: solvated DHFR
(23,558 atoms, waters first), HMR masses, 400 FIRE steps, then Langevin
BAOAB at 2.5 fs and 300 K with a Monte Carlo barostat every 25 steps. The
nonbonded term runs through the hand-written rowscan kernel
(timemachine_torch/csrc/rowscan.cu); forcefield-parameter gradients and the
kernel="v1" configuration run through the hand-written block-tile kernel
(timemachine_torch/csrc/nb_tiles.cu); the kernel="gather", kernel="quad" and
kernel="dot" configurations run through the hand-written gather, quadscan
and dotscan kernels (csrc/gather.cu, csrc/quadscan.cu, csrc/dotscan.cu); two
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
plain version. Every path runs with all launch and plain-call counts set to
0 just before it and read just after. Then a JSON line on the kernels
(time; launches per NPT step of the path named in `path`, per Adam step of
the training path where the kernel has one, per run of phase 12 for the
probes; bound; plain time), the card's name and power limit from
nvidia-smi, and as the last line {"ok": true, "device": {...}}.

Usage, from the repository root:  python3 chip_smoke.py
Without a CUDA card, or when any phase fails, the script exits non-zero and
prints no result.
"""

import json
import subprocess
import sys
import time

TEMP, DT, FRICTION, PRESSURE, BAROSTAT_INTERVAL = 300.0, 2.5e-3, 1.0, 1.013, 25
N_FIRE, N_STEPS, N_PROFILE, N_DET = 400, 1000, 50, 100
N_FRAMES, FRAME_INTERVAL, N_ADAM, ADAM_LR, S_START = 8, 100, 5, 2e-3, 1.01
N_ALT = 500
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
# the FP32 probe's time from INNER to 2 INNER: the chains were not folded
PROBE_RATIO = (1.8, 2.2)
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

    from timemachine_torch.constants import BOLTZ
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
    from timemachine_torch.potentials import DP_CB, SKIN, NonbondedAllPairs
    from timemachine_torch.probes import bf16_rate as br
    from timemachine_torch.probes import fp32_peak as fp
    from timemachine_torch.testsystems.dhfr import setup_dhfr

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sweeps = (rs.rowscan_sweep, nbk.nb_tiles, gk.gather_sweep, qk.quadscan_sweep, dk.dotscan_sweep, fp.fp32_peak, br.bf16_rate)
    plains = (
        rs.rowscan_sweep_plain, nbk.nb_tiles_plain, gk.gather_sweep_plain, qk.quadscan_sweep_plain,
        dk.dotscan_sweep_plain, fp.fp32_peak_plain, br.bf16_rate_plain,
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
    zero_counts()
    tflops, ms_fma, ms_fma2 = fp.measure(x12)
    ms_gate = {dt: br.time_ms(a12, b12, dt) for dt in (torch.float32, torch.bfloat16)}
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
        f"[12 bf16] ({br.SUB}, {br.LANE}) x {br.ITERS} slot-iterations, device time: f32 {ms_gate[torch.float32] * 1e3:.2f} us "
        f"({ms_gate[torch.float32] * 1e9 / slot_iters:.4f} ps/slot-iteration), bf16 {ms_gate[torch.bfloat16] * 1e3:.2f} us "
        f"({ms_gate[torch.bfloat16] * 1e9 / slot_iters:.4f}); bf16 speedup over f32 "
        f"{ms_gate[torch.float32] / ms_gate[torch.bfloat16]:.3f}x ({smi})"
    )
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
    out_f32 = br.bf16_rate(a12, b12, torch.float32)
    check(torch.equal(out_f32, br.bf16_rate_plain(a12, b12, torch.float32)), "[12] the f32 gate disagrees with plain")

    print(json.dumps({"kernels": [kernel_row, nb_row, gather_row, quad_row, dot_row, *probe_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
