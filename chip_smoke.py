"""Drive the PyTorch port's main path once on one CUDA card.

The run that bench.py times, through timemachine_torch: solvated DHFR
(23,558 atoms, waters first), HMR masses, 400 FIRE steps, then Langevin
BAOAB at 2.5 fs and 300 K with a Monte Carlo barostat every 25 steps. The
nonbonded term runs through the hand-written rowscan kernel
(timemachine_torch/csrc/rowscan.cu); forcefield-parameter gradients and the
kernel="v1" configuration run through the hand-written block-tile kernel
(timemachine_torch/csrc/nb_tiles.cu). Both are built here with nvcc for
sm_90a, in parallel.

Phases, one line each or more: the device; the kernel builds; the rowscan
kernel against its plain PyTorch version at DHFR shapes in its three modes,
and the whole force on the card against the same modules on the host CPU;
the main path (1,000 warm-up and 1,000 timed NPT steps, with ns/day), then
50 steps under torch.profiler for the device's busy time per step (its
table goes to standard error); bitwise determinism of two fresh Contexts;
the block-tile kernel against its plain version at DHFR shapes in its modes
DP, UF (exact and polynomial) and F; du/dp training: 5 Adam steps on a
protein charge scale through a reweighting estimator over 8 NPT frames; the
kernel="v1" path: its force against the rowscan configuration's, then 500
NPT steps. Then a JSON line on the kernels, the card's name and power limit
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
N_FRAMES, FRAME_INTERVAL, N_ADAM, ADAM_LR, S_START = 8, 100, 5, 2e-3, 1.01
N_V1 = 500
# kernel vs plain PyTorch, both f32: the two sum each atom's ~700 pairs in
# different orders and the kernel's rsqrt is approximate (2 ulp)
TOL_GRAD_REL_NORM = 1e-4
TOL_U_REL_NORM = 1e-4
# whole force on the card vs on the host CPU, both f32, relative to the
# all-pairs force: the net force is what is left after the exclusions
# cancel the all-pairs term's huge bonded-neighbour forces, so f32 rounding
# of those (the sweep's ~1e-6) sets the scale, not the small net
TOL_FORCE_REL_NORM = 1e-5
# block-tile kernel vs plain PyTorch, per output column, both f32
TOL_NB_COL = 1e-4
# dL/ds with the DP pass on the kernel vs on the plain version
TOL_DLDS = 1e-4
# kernel="v1" (A&S erfc, exact exclusions) vs rowscan (polynomial) net
# nonbonded force, relative to the all-pairs force norm
TOL_V1_FORCE = 1e-5


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
    from timemachine_torch.ops import nonbonded_kernel as nbk
    from timemachine_torch.ops import rowscan_kernel as rs
    from timemachine_torch.potentials import DP_CB, NonbondedAllPairs
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
    _build.load_libraries(*_build.LIBRARIES)
    t_build = time.perf_counter() - t0
    for lib in _build.LIBRARIES:
        log = _build.build_log(lib).splitlines()
        ptxas = [ln.strip() for ln in log[1:] if "registers" in ln or "spill" in ln]
        print(f"[2 build] {lib}: {log[0]} | " + " | ".join(ptxas))
    print(f"[2 build] {len(_build.LIBRARIES)} libraries in {t_build:.1f} s, one nvcc each, in parallel")

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

    # -- 6. block-tile kernel vs plain at DHFR shapes ----------------------------------
    tiles6 = nbk.build_block_tiles(x0, nb.params, box, nb.cutoff, nb.dp_max_tiles, DP_CB)
    check(int(tiles6.overflow) == 0, "block-tile list overflow at DHFR")
    nb_args = (tiles6.atoms, tiles6.row_start, tiles6.row_count, tiles6.col_ids, nbk.tile_scalars(box, nb.beta, nb.cutoff))
    n_tiles = int(tiles6.row_count.sum())
    print(
        f"[6 shapes] Npad {tiles6.atoms.shape[0]}, row blocks {tiles6.row_start.shape[0]}, cb {DP_CB}, "
        f"listed tiles {n_tiles} of capacity {nb.dp_max_tiles}, pair slots {n_tiles * nbk.BLOCK * nbk.BLOCK * DP_CB}"
    )
    poly = nbk.es_switch_poly_coeffs(nb.beta, nb.cutoff)
    nb_row = None
    for label, mode, es in (("DP", nbk.DP, None), ("UF-exact", nbk.UF, None), ("UF-poly", nbk.UF, poly), ("F", nbk.FORCE, None)):
        out_k = nbk.nb_tiles(*nb_args, mode, DP_CB, es)
        out_k2 = nbk.nb_tiles(*nb_args, mode, DP_CB, es)
        out_p = nbk.nb_tiles_plain(*nb_args, mode, DP_CB, es)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all()), f"block-tile kernel output not finite in mode {label}")
        rels = []
        for col in range(4):
            norm = float(torch.linalg.vector_norm(out_p[:, col]))
            if norm == 0:  # F mode's energy column, dU/dw at w = 0
                check(not bool(out_k[:, col].any()), f"kernel column {col} not zero in mode {label}")
                rels.append(0.0)
            else:
                rels.append(float(torch.linalg.vector_norm(out_k[:, col] - out_p[:, col])) / norm)
        max_abs = float((out_k - out_p).abs().max())
        same = torch.equal(out_k, out_k2)
        ms = cuda_ms(lambda: nbk.nb_tiles(*nb_args, mode, DP_CB, es), 20)
        plain_ms = cuda_ms(lambda: nbk.nb_tiles_plain(*nb_args, mode, DP_CB, es), 2)
        print(
            f"[6 kernel {label}] rel_norm per column " + " ".join(f"{r:.3e}" for r in rels)
            + f" (tol {TOL_NB_COL:g}); max_abs {max_abs:.3e}; two launches bitwise equal: {same}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms ({smi})"
        )
        check(max(rels) <= TOL_NB_COL, f"block-tile kernel disagrees with plain in mode {label}")
        check(same, f"two block-tile launches differ in mode {label}")
        if mode == nbk.DP:
            nb_row = {
                "name": "nb_tiles", "route": "cuda", "source": "timemachine_torch/csrc/nb_tiles.cu",
                "replaces": "timemachine_tpu/ops/pallas/nonbonded_kernel.py:213", "launches": None,
                "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            }

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
    du_ds = []
    for x, b in samples:
        p = params_of(s0.detach())
        t7 = nbk.build_block_tiles(x, p, b, nb.cutoff, nb.dp_max_tiles, DP_CB)
        dp = nbk.nb_tiles_plain(
            t7.atoms, t7.row_start, t7.row_count, t7.col_ids, nbk.tile_scalars(b, nb.beta, nb.cutoff), nbk.DP, DP_CB
        )
        dq = dp[torch.argsort(t7.pad_order[:n]), 0]
        s_e = s0.detach().requires_grad_(True)
        (d_exc,) = torch.autograd.grad(nb.exclusion_energy(x, params_of(s_e), b), s_e)
        du_ds.append((torch.sum(torch.where(protein, dq * q0, 0.0)) - d_exc) / kT)
    g_plain = torch.sum(dl_du * torch.stack(du_ds))
    g_rel = abs(float(g_kernel) - float(g_plain)) / abs(float(g_plain))
    print(f"[7 du/dp] dL/ds at s = {S_START}: through the kernel {float(g_kernel):.6e}, through the plain DP "
          f"{float(g_plain):.6e}, rel {g_rel:.3e} (tol {TOL_DLDS:g})")
    check(g_rel <= TOL_DLDS, "dL/ds through the kernel disagrees with the plain DP pass")

    rs.rowscan_sweep.launches, nbk.nb_tiles.launches = 0, 0
    rs.rowscan_sweep_plain.calls, nbk.nb_tiles_plain.calls = 0, 0
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
            f"{history[-1][1]:.6f}, dL/ds {float(s.grad):.6e}"
        )
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3 / N_ADAM
    launches7 = {"rowscan_sweep": rs.rowscan_sweep.launches, "nb_tiles": nbk.nb_tiles.launches}
    plain7 = rs.rowscan_sweep_plain.calls + nbk.nb_tiles_plain.calls
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
        f"|diff| / |net force| {float(torch.linalg.vector_norm(f_v1 - f_rs) / torch.linalg.vector_norm(f_rs)):.3e}"
    )
    check(v1_rel <= TOL_V1_FORCE, "the v1 force disagrees with the rowscan configuration's")
    rs.rowscan_sweep.launches, nbk.nb_tiles.launches = 0, 0
    rs.rowscan_sweep_plain.calls, nbk.nb_tiles_plain.calls = 0, 0
    baro8 = MonteCarloBarostat(n, PRESSURE, TEMP, hc8.group_idxs, BAROSTAT_INTERVAL, seed=2027)
    ctx8 = Context(x_min, v0, box, LangevinIntegrator(TEMP, DT, FRICTION, masses, seed=2026), bps8, movers=[baro8], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx8.multiple_steps(N_V1)
    torch.cuda.synchronize()
    elapsed8 = time.perf_counter() - t0
    launches8, plain8 = nbk.nb_tiles.launches, nbk.nb_tiles_plain.calls + rs.rowscan_sweep_plain.calls
    x8 = torch.as_tensor(ctx8.get_x_t(), device=dev)
    box8 = torch.as_tensor(ctx8.get_box(), device=dev)
    u8 = float(sum(p.energy(x8, box8) for p in bps8))
    attempted8 = int(ctx8.get_mover_states()[0].total_attempted)
    print(
        f"[8 v1] DHFR NPT {N_V1} steps on kernel=\"v1\": {N_V1 * DT / 1000.0 / elapsed8 * 86_400.0:.2f} ns/day "
        f"({elapsed8 * 1e3 / N_V1:.4f} ms/step, lists built included; {smi}); box {box8[0, 0].item():.4f} nm; "
        f"U {u8:.2f} kJ/mol; nb_tiles launches {launches8}, rowscan launches {rs.rowscan_sweep.launches}, plain calls {plain8}"
    )
    check(bool(torch.isfinite(x8).all() and torch.isfinite(box8).all()) and np.isfinite(u8), "v1 run not finite")
    check(launches8 >= N_V1 + 2 * attempted8, f"nb_tiles launched {launches8} times on the v1 path")
    check(plain8 == 0, "the v1 path ran a plain version")

    kernel_row["launches"] += launches7["rowscan_sweep"]
    nb_row["launches"] = launches7["nb_tiles"] + launches8
    print(json.dumps({"kernels": [kernel_row, nb_row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
