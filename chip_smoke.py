"""Drive the PyTorch port's main path once on one CUDA card.

The run that bench.py times, through timemachine_torch: solvated DHFR
(23,558 atoms, waters first), HMR masses, 400 FIRE steps, then Langevin
BAOAB at 2.5 fs and 300 K with a Monte Carlo barostat every 25 steps. The
nonbonded term runs through the hand-written rowscan kernel
(timemachine_torch/csrc/rowscan.cu), built here with nvcc for sm_90a.

Phases, one line each: the device; the kernel build; the kernel against its
plain PyTorch version at DHFR shapes in its three modes, and the whole
force on the card against the same modules on the host CPU; the main path
(1,000 warm-up and 1,000 timed NPT steps, with ns/day), then 50 steps under
torch.profiler for the device's busy time per step (its table goes to
standard error); bitwise determinism of two fresh Contexts. Then a JSON line on the kernels, the card's name and power limit
from nvidia-smi, and as the last line {"ok": true, "device": {...}}.

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
# kernel vs plain PyTorch, both f32: the two sum each atom's ~700 pairs in
# different orders and the kernel's rsqrt is approximate (2 ulp)
TOL_GRAD_REL_NORM = 1e-4
TOL_U_REL_NORM = 1e-4
# whole force on the card vs on the host CPU, both f32, relative to the
# all-pairs force: the net force is what is left after the exclusions
# cancel the all-pairs term's huge bonded-neighbour forces, so f32 rounding
# of those (the sweep's ~1e-6) sets the scale, not the small net
TOL_FORCE_REL_NORM = 1e-5


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from timemachine_torch.fe.model_utils import apply_hmr
    from timemachine_torch.integrators import LangevinIntegrator
    from timemachine_torch.md.barostat import MonteCarloBarostat
    from timemachine_torch.md.context import Context
    from timemachine_torch.md.fire import FireMinimizationConfig, fire_minimize
    from timemachine_torch.md.utils import sample_velocities
    from timemachine_torch.ops import _build
    from timemachine_torch.ops import rowscan_kernel as rs
    from timemachine_torch.potentials import NonbondedAllPairs
    from timemachine_torch.testsystems.dhfr import setup_dhfr

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    _build.load_library("rowscan")
    log = _build.build_log("rowscan").splitlines()
    ptxas = [ln.strip() for ln in log[1:] if "registers" in ln or "spill" in ln]
    print(f"[2 build] {time.perf_counter() - t0:.1f} s: {log[0]} | " + " | ".join(ptxas))

    # -- 3. kernel vs plain at DHFR shapes -------------------------------------------
    hc = setup_dhfr(waters_first=True, device=dev, dtype=f32)
    bps = hc.host_system.get_U_fns()
    nb = hc.host_system.nonbonded_all_pairs
    x0 = torch.as_tensor(hc.conf, device=dev, dtype=f32)
    box = torch.as_tensor(hc.box, device=dev, dtype=f32)
    nb.configure(box, x0)
    n = x0.shape[0]
    state = nb.md_force_provider()[0](x0, box)
    tiles = state.tiles
    atoms = rs.assemble_atoms(x0, box, tiles.pad_order, state.prows)
    row_count = rs.chop_row_counts(atoms[:, :3], tiles.rank_mat, tiles.row_count, box, nb.cutoff)
    series = rs.es_energy_force_series(nb.beta, nb.cutoff)
    sweep_args = (atoms, tiles.row_start, row_count, tiles.col_ids, rs.sweep_scalars(box, nb.cutoff), series)
    slots = int(row_count.sum()) * rs.ROW * rs.COL
    print(
        f"[3 shapes] N {n}, Npad {atoms.shape[0]}, row chunks {tiles.row_start.shape[0]}, "
        f"max_pairs {nb.md_max_pairs}, cell {nb.md_cell_size} nm, listed tiles {int(tiles.row_count.sum())}, "
        f"swept slots/step {slots}"
    )
    check(int(tiles.overflow) == 0, "tile list overflow at DHFR")

    def rel_norm(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    def cuda_ms(fn, reps):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    kernel_row = None
    for mode, label in ((rs.FORCE, "F"), (rs.FORCE_ENERGY, "F+U"), (rs.ENERGY, "U")):
        out_k = rs.rowscan_sweep(*sweep_args, mode)
        out_p = rs.rowscan_sweep_plain(*sweep_args, mode)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all()), f"kernel output not finite in mode {label}")
        msg = []
        if mode != rs.ENERGY:
            g_err = float((out_k[:, 1:4] - out_p[:, 1:4]).abs().max())
            g_rel = rel_norm(out_k[:, 1:4], out_p[:, 1:4])
            g_max = float(out_p[:, 1:4].abs().max())
            msg.append(f"grad max_abs {g_err:.3e} of max |grad| {g_max:.3e}, rel_norm {g_rel:.3e} (tol {TOL_GRAD_REL_NORM:g})")
            check(g_rel <= TOL_GRAD_REL_NORM, f"kernel gradient disagrees with plain in mode {label}")
        else:
            check(bool((out_k[:, 1:4] == 0).all()), "energy mode wrote gradients")
        if mode != rs.FORCE:
            u_rel = rel_norm(out_k[:, 0], out_p[:, 0])
            u_k, u_p = float(out_k[:, 0].double().sum()), float(out_p[:, 0].double().sum())
            msg.append(f"u rel_norm {u_rel:.3e} (tol {TOL_U_REL_NORM:g}), total {u_k:.4f} vs {u_p:.4f} kJ/mol")
            check(u_rel <= TOL_U_REL_NORM, f"kernel energy disagrees with plain in mode {label}")
        ms = cuda_ms(lambda: rs.rowscan_sweep(*sweep_args, mode), 20)
        plain_ms = cuda_ms(lambda: rs.rowscan_sweep_plain(*sweep_args, mode), 2)
        print(f"[3 kernel {label}] {'; '.join(msg)}; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms ({smi})")
        if mode == rs.FORCE:
            kernel_row = {
                "name": "rowscan_sweep", "route": "cuda", "source": "timemachine_torch/csrc/rowscan.cu",
                "replaces": "timemachine_tpu/ops/pallas/rowscan_kernel.py:111", "launches": None,
                "max_abs_err": g_err, "ms": ms, "plain_ms": plain_ms,
            }

    hc_cpu = setup_dhfr(waters_first=True, device="cpu", dtype=f32)
    hc_cpu.host_system.nonbonded_all_pairs.configure(box.cpu(), x0.cpu())
    f_card = sum(p.energy_force(x0, box)[1] for p in bps)
    f_host = sum(p.energy_force(x0.cpu(), box.cpu())[1] for p in hc_cpu.host_system.get_U_fns())
    f_all_pairs = NonbondedAllPairs.energy_force(nb, x0, box)[1]
    f_err = float(torch.linalg.vector_norm(f_card.cpu() - f_host))
    f_rel = f_err / float(torch.linalg.vector_norm(f_all_pairs))
    print(
        f"[3 slice] total force, card vs host CPU: |diff| / |all-pairs force| {f_rel:.3e} "
        f"(tol {TOL_FORCE_REL_NORM:g}); |diff| / |total force| {f_err / float(torch.linalg.vector_norm(f_host)):.3e}"
    )
    check(f_rel <= TOL_FORCE_REL_NORM, "total force on the card disagrees with the host CPU")

    # -- 4. main path -----------------------------------------------------------------
    rs.rowscan_sweep.launches = 0
    rs.rowscan_sweep_plain.calls = 0
    masses = apply_hmr(hc.masses, hc.host_system.bond.idxs.cpu().numpy())
    t0 = time.perf_counter()
    x_min = fire_minimize(x0, lambda x: sum(p.energy_force(x, box)[1] for p in bps), FireMinimizationConfig(N_FIRE))
    torch.cuda.synchronize()
    t_fire = time.perf_counter() - t0
    check(bool(torch.isfinite(x_min).all()), "FIRE produced non-finite coordinates")
    intg = LangevinIntegrator(TEMP, DT, FRICTION, masses, seed=2026)
    v0 = sample_velocities(masses, TEMP, seed=2028)

    def make_context():
        baro = MonteCarloBarostat(n, PRESSURE, TEMP, hc.group_idxs, BAROSTAT_INTERVAL, seed=2027)
        return Context(x_min, v0, box, intg, bps, movers=[baro], device=dev)

    ctxt = make_context()
    ctxt.multiple_steps(N_STEPS)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctxt.multiple_steps(N_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches, plain_calls = rs.rowscan_sweep.launches, rs.rowscan_sweep_plain.calls
    ns_per_day = N_STEPS * DT / 1000.0 / elapsed * 86_400.0
    baro_state = ctxt.get_mover_states()[0]
    attempted, accepted = int(baro_state.total_attempted), int(baro_state.total_accepted)
    x_end = torch.as_tensor(ctxt.get_x_t(), device=dev)
    box_end = torch.as_tensor(ctxt.get_box(), device=dev)
    u_end = float(sum(p.energy(x_end, box_end) for p in bps))
    print(
        f"[4 main path] DHFR NPT {n} atoms: {ns_per_day:.2f} ns/day ({elapsed * 1e3 / N_STEPS:.4f} ms/step over "
        f"{N_STEPS} steps; {smi}); FIRE {N_FIRE} steps {t_fire:.2f} s; barostat {accepted}/{attempted} "
        f"accepted; box {box_end[0, 0].item():.4f} nm; U {u_end:.2f} kJ/mol; kernel launches {launches}, "
        f"plain sweeps {plain_calls}"
    )
    check(bool(torch.isfinite(x_end).all() and torch.isfinite(box_end).all()), "coordinates or box not finite")
    check(np.isfinite(u_end), "final energy not finite")
    check(attempted == 2 * N_STEPS // BAROSTAT_INTERVAL, f"barostat attempted {attempted} moves")
    check(accepted >= 1, "barostat accepted no move")
    min_launches = (N_FIRE + 1) + 2 * N_STEPS + 2 * attempted
    check(launches >= min_launches, f"kernel launched {launches} times, want >= {min_launches}")
    check(plain_calls == 0, "the main path ran the plain sweep")
    kernel_row["launches"] = launches

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

    # -- 5. determinism -----------------------------------------------------------------
    a, b = make_context(), make_context()
    a.multiple_steps(N_DET)
    b.multiple_steps(N_DET)
    same = all(np.array_equal(p, q) for p, q in ((a.get_x_t(), b.get_x_t()), (a.get_v_t(), b.get_v_t()), (a.get_box(), b.get_box())))
    print(f"[5 determinism] two fresh Contexts, {N_DET} steps: x, v, box bitwise equal: {same}")
    check(same, "two identical runs differ")

    print(json.dumps({"kernels": [kernel_row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
