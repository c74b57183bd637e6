"""Time sweep variants on one CUDA card, at the solvated DHFR start.

    python3 sweep_variants.py gather-splits [--splits 1 2 4]
        Builds a copy of timemachine_torch/csrc/gather.cu for each value of
        its SPLITS constant (blocks per row chunk), under
        timemachine_torch/_build/variants/, one nvcc each, in parallel, and
        times the redesigned F sweep of each (CUDA events over 20 launches,
        the values in turn and then in reverse), each checked against the
        plain version (relative norm per column <= 1e-4).

    python3 sweep_variants.py bf16-elems [--elems 2 4 8]
        Builds a copy of timemachine_torch/csrc/probe_bf16.cu for each value
        of its ELEMS constant (f32 elements or bf16 pairs per thread of the
        redesigned gate), checks each bitwise against the plain version, and
        times the redesign in f32 and bf16 by bf16_rate.measure (marginal
        time per ITERS iterations and fixed cost), the values in turn and
        then in reverse.

    python3 sweep_variants.py rowscan-main [--package-root DIR]
        Times the rowscan sweep's main-path form (Newton-triangular,
        row-center images, no w) in F mode, CUDA events over 20 launches,
        with the timemachine_torch package found under DIR (default: this
        script's directory). Point DIR at an unpacked checkout of another
        commit to compare two trees in one call.

    python3 sweep_variants.py host-load [--burners 0 16 48] [--idle 10]
        Times the rowscan sweep's main-path form and its symmetric form (the
        first design) in F mode at the DHFR start while each count of
        processes spins on the host's cores, two ways: CUDA events around 20
        launches as the host queues them (cuda_ms), and probes.queued_ms (a
        spin kernel holds the stream while the host queues them; the least
        of 3 rounds). Each way starts after the card has idled --idle
        seconds, the main form first, as chip_smoke.py's phase 3 times them
        after the build. Prints both times and the main / symmetric ratio of
        each way; the spinning processes are stopped after each count.

Every line names the card and its power limit as nvidia-smi reports them.
Exits non-zero without a CUDA card.
"""

import argparse
import ctypes
import multiprocessing
import re
import subprocess
import sys
from pathlib import Path

TOL = 1e-4
REPS = 20


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dhfr_start(dev):
    """(conf, params, box) of the DHFR start, f32 on dev."""
    import torch

    from timemachine_torch.testsystems.dhfr import setup_dhfr_native

    hc = setup_dhfr_native(waters_first=True, device=dev, dtype=torch.float32)
    nb = hc.host_system.nonbonded_all_pairs
    conf = torch.as_tensor(hc.conf, device=dev, dtype=torch.float32)
    return conf, nb, torch.as_tensor(hc.box, device=dev, dtype=torch.float32)


def build_variants(name: str, constant: str, values) -> dict:
    """{k: CDLL} of csrc/<name>.cu with `constexpr int <constant> = k;`, one
    nvcc each, in parallel, under timemachine_torch/_build/variants/."""
    from timemachine_torch.ops import _build

    source = (_build.CSRC / f"{name}.cu").read_text()
    pattern = rf"constexpr int {constant} = \d+;"
    if len(re.findall(pattern, source)) != 1:
        raise SystemExit(f"sweep_variants: csrc/{name}.cu does not define {constant} once")
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for k in values:
        src = _build.CSRC / f"{name}_{constant.lower()}{k}.cu.tmp"  # beside the headers it includes
        src.write_text(re.sub(pattern, f"constexpr int {constant} = {k};", source))
        so = out_dir / f"lib{name}_{constant.lower()}{k}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-x", "cu", "-o", str(so), str(src)]
        jobs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), src, so)
    libs = {}
    for k, (proc, src, so) in jobs.items():
        out, err = proc.communicate()
        src.unlink()
        if proc.returncode != 0:
            raise SystemExit(f"sweep_variants: nvcc failed for {constant} = {k}:\n{err}")
        regs = [ln.strip() for ln in (out + err).splitlines() if "registers" in ln]
        print(f"[build] {constant} {k}: " + " | ".join(regs))
        libs[k] = ctypes.CDLL(str(so))
    return libs


def gather_splits(splits, smi: str) -> None:
    import torch

    from timemachine_torch.ops import _build
    from timemachine_torch.ops import gather_kernel as gk
    from timemachine_torch.ops import rowscan_kernel as rs
    from timemachine_torch.potentials import SKIN

    libs = build_variants("gather", "SPLITS", splits)
    dev = torch.device("cuda", 0)
    conf, nb, box = dhfr_start(dev)
    cutoff = nb.cutoff
    lists = gk.build_gather_neighbors(conf, box, cutoff + SKIN, gk.suggest_max_nbrs(conf, box, cutoff + SKIN))
    atoms = rs.assemble_atoms(conf, box, lists.pad_order, rs.param_rows(nb.params.to(torch.float32), lists.pad_order, conf.shape[0]))
    series = rs.es_energy_force_series(nb.beta, cutoff)
    args = (atoms, lists.counts, lists.nbr, lists.tri_start, rs.sweep_scalars(box, cutoff), series)
    plain = gk.gather_sweep_plain(*args[:3], *args[4:], gk.FORCE)

    def use(k):
        _build._libs["gather"] = libs[k]  # gather_sweep's launcher reads the loaded library from here

    times = {k: [] for k in splits}
    for k in [*splits, *reversed(splits)]:
        use(k)
        out = gk.gather_sweep(*args, gk.FORCE)
        rel = max(
            float(torch.linalg.vector_norm(out[:, c] - plain[:, c]) / torch.linalg.vector_norm(plain[:, c]))
            for c in range(1, 4)
        )
        if not rel <= TOL:
            raise SystemExit(f"sweep_variants: SPLITS = {k} disagrees with the plain version ({rel:.3e})")
        times[k].append(cuda_ms(lambda: gk.gather_sweep(*args, gk.FORCE)))
    for k in splits:
        print(
            f"[gather splits] SPLITS {k}: F " + " ".join(f"{t:.4f}" for t in times[k])
            + f" ms (CUDA events over {REPS} launches, DHFR start, lists at cutoff + skin; {smi})"
        )


def rowscan_forms(symmetric: bool = False):
    """{form: thunk} of the rowscan F sweep at the DHFR start: the main-path
    form ("main": Newton-triangular, row-center images, no w) and, if
    symmetric, the symmetric form ("symmetric": minimum image, w) on the
    same sort, as chip_smoke.py's phase 3 builds them."""
    import torch

    from timemachine_torch.ops import rowscan_kernel as rs
    from timemachine_torch.potentials import SKIN

    dev = torch.device("cuda", 0)
    conf, nb, box = dhfr_start(dev)
    has_w = bool((nb.params[:, 3] != 0).any())  # False for DHFR, as bench.py computes it
    nb.configure(box, conf, rowscan_has_w=has_w)
    state = nb.md_force_provider()[0](conf, box)
    tiles = state.lists
    atoms = rs.assemble_atoms(conf, box, tiles.pad_order, state.prows)
    row_count = rs.chop_row_counts(atoms[:, :3], tiles.rank_mat, tiles.row_count, box, nb.cutoff)
    scalars, series = rs.sweep_scalars(box, nb.cutoff), rs.es_energy_force_series(nb.beta, nb.cutoff)
    args = (atoms, tiles.row_start, row_count, tiles.col_ids, scalars, series)
    form = dict(triangular=True, rcen_q=tiles.rcen_q, has_w=has_w)
    forms = {"main": lambda: rs.rowscan_sweep(*args, rs.FORCE, **form)}
    if symmetric:
        cut = nb.cutoff + SKIN
        sym = rs.build_rowscan_tiles(conf, box, cut, rs.suggest_max_pairs(conf, box, cut, cell_size=nb.md_cell_size),
                                     nb.md_cell_size)
        if int(sym.overflow) or not torch.equal(sym.pad_order, tiles.pad_order):
            raise SystemExit("sweep_variants: the symmetric lists at DHFR overflow or sort differently")
        sym_count = rs.chop_row_counts(atoms[:, :3], sym.rank_mat, sym.row_count, box, nb.cutoff)
        sym_args = (atoms, sym.row_start, sym_count, sym.col_ids, scalars, series)
        forms["symmetric"] = lambda: rs.rowscan_sweep(*sym_args, rs.FORCE)
    return forms


def rowscan_main(smi: str) -> None:
    from timemachine_torch.ops import rowscan_kernel as rs

    ms = cuda_ms(rowscan_forms()["main"])
    print(f"[rowscan main] {rs.__file__}: main form F {ms:.4f} ms (CUDA events over {REPS} launches, DHFR start; {smi})")


def _spin(stop) -> None:
    while not stop.is_set():
        pass


def host_load(burners, idle_s: float, smi: str) -> None:
    import os
    import time

    from timemachine_torch.probes import queued_ms

    forms = rowscan_forms(symmetric=True)
    ctx = multiprocessing.get_context("spawn")
    for n in burners:
        stop = ctx.Event()
        procs = [ctx.Process(target=_spin, args=(stop,), daemon=True) for _ in range(n)]
        for p in procs:
            p.start()
        try:
            for how, timer in (("events as queued", cuda_ms), ("queued_ms", lambda fn: queued_ms(fn, REPS))):
                time.sleep(idle_s)
                ms = {form: timer(fn) for form, fn in forms.items()}
                print(
                    f"[host load] {n} spinning processes on {os.cpu_count()} cores, {how} after {idle_s:g} s idle: main form F "
                    f"{ms['main']:.4f} ms, symmetric F {ms['symmetric']:.4f} ms, ratio "
                    f"{ms['main'] / ms['symmetric']:.3f} ({REPS} launches, DHFR start; {smi})"
                )
        finally:
            stop.set()
            for p in procs:
                p.join(5)
                if p.is_alive():
                    p.terminate()
                    p.join()


def bf16_elems(elems, smi: str) -> None:
    import torch

    from timemachine_torch.ops import _build
    from timemachine_torch.probes import bf16_rate as br

    libs = build_variants("probe_bf16", "ELEMS", elems)
    a, b = br.inputs(torch.device("cuda", 0))
    plain = {dt: br.bf16_rate_plain(a, b, dt) for dt in (torch.float32, torch.bfloat16)}
    fits = {k: [] for k in elems}
    for k in [*elems, *reversed(elems)]:
        _build._libs["probe_bf16"] = libs[k]  # bf16_rate's launcher reads the loaded library from here
        for dt in plain:
            if not torch.equal(br.bf16_rate(a, b, dt), plain[dt]):
                raise SystemExit(f"sweep_variants: ELEMS = {k} disagrees with the plain version in {dt}")
        fits[k].append(br.measure(a, b, designs=(False,)))
    for k in elems:
        for dt in plain:
            runs = [m[dt, False] for m in fits[k]]
            print(
                f"[bf16 elems] ELEMS {k}, {br.KERNELS[dt, False]}: marginal "
                + " ".join(f"{f.marginal_ms * 1e3:.4f}" for f in runs) + " us per "
                f"{br.ITERS} iterations, fixed " + " ".join(f"{f.fixed_ms * 1e3:.4f}" for f in runs)
                + f" us, at {br.ITERS} " + " ".join(f"{f.ms_by_iters[br.ITERS] * 1e3:.4f}" for f in runs)
                + f" us (bf16_rate.measure, ({br.SUB}, {br.LANE}) elements; {smi})"
            )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("gather-splits", "rowscan-main", "bf16-elems", "host-load"))
    parser.add_argument("--splits", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--elems", type=int, nargs="+", default=[2, 4, 8])
    parser.add_argument("--burners", type=int, nargs="+", default=[0, 16, 48])
    parser.add_argument("--idle", type=float, default=10.0)
    parser.add_argument("--package-root", default=str(Path(__file__).resolve().parent))
    a = parser.parse_args()
    sys.path.insert(0, a.package_root)
    import torch

    if not torch.cuda.is_available():
        print("sweep_variants: torch.cuda.is_available() is False: this script needs a CUDA card", file=sys.stderr)
        return 1
    smi = card_line()
    if a.what == "gather-splits":
        gather_splits(a.splits, smi)
    elif a.what == "bf16-elems":
        bf16_elems(a.elems, smi)
    elif a.what == "host-load":
        host_load(a.burners, a.idle, smi)
    else:
        rowscan_main(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
