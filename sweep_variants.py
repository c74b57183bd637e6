"""Time sweep variants on one CUDA card, at the solvated DHFR start.

    python3 sweep_variants.py gather-splits [--splits 1 2 4]
        Builds a copy of timemachine_torch/csrc/gather.cu for each value of
        its SPLITS constant (blocks per row chunk), under
        timemachine_torch/_build/variants/, one nvcc each, in parallel, and
        times the redesigned F sweep of each (CUDA events over 20 launches,
        the values in turn and then in reverse), each checked against the
        plain version (relative norm per column <= 1e-4).

    python3 sweep_variants.py rowscan-main [--package-root DIR]
        Times the rowscan sweep's main-path form (Newton-triangular,
        row-center images, no w) in F mode, CUDA events over 20 launches,
        with the timemachine_torch package found under DIR (default: this
        script's directory). Point DIR at an unpacked checkout of another
        commit to compare two trees in one call.

Every line names the card and its power limit as nvidia-smi reports them.
Exits non-zero without a CUDA card.
"""

import argparse
import ctypes
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

    from timemachine_torch.testsystems.dhfr import setup_dhfr

    hc = setup_dhfr(waters_first=True, device=dev, dtype=torch.float32)
    nb = hc.host_system.nonbonded_all_pairs
    conf = torch.as_tensor(hc.conf, device=dev, dtype=torch.float32)
    return conf, nb, torch.as_tensor(hc.box, device=dev, dtype=torch.float32)


def gather_splits(splits, smi: str) -> None:
    import torch

    from timemachine_torch.ops import _build
    from timemachine_torch.ops import gather_kernel as gk
    from timemachine_torch.ops import rowscan_kernel as rs
    from timemachine_torch.potentials import SKIN

    source = (_build.CSRC / "gather.cu").read_text()
    pattern = r"constexpr int SPLITS = \d+;"
    if len(re.findall(pattern, source)) != 1:
        raise SystemExit("sweep_variants: csrc/gather.cu does not define SPLITS once")
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for k in splits:
        src = _build.CSRC / f"gather_splits{k}.cu.tmp"  # beside the headers it includes
        src.write_text(re.sub(pattern, f"constexpr int SPLITS = {k};", source))
        so = out_dir / f"libgather_splits{k}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-x", "cu", "-o", str(so), str(src)]
        jobs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), src, so)
    libs = {}
    for k, (proc, src, so) in jobs.items():
        out, err = proc.communicate()
        src.unlink()
        if proc.returncode != 0:
            raise SystemExit(f"sweep_variants: nvcc failed for SPLITS = {k}:\n{err}")
        regs = [ln.strip() for ln in (out + err).splitlines() if "registers" in ln]
        print(f"[build] SPLITS {k}: " + " | ".join(regs))
        libs[k] = ctypes.CDLL(str(so))

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


def rowscan_main(smi: str) -> None:
    import torch

    from timemachine_torch.ops import rowscan_kernel as rs

    dev = torch.device("cuda", 0)
    conf, nb, box = dhfr_start(dev)
    has_w = bool((nb.params[:, 3] != 0).any())  # False for DHFR, as bench.py computes it
    nb.configure(box, conf, rowscan_has_w=has_w)
    state = nb.md_force_provider()[0](conf, box)
    tiles = state.lists
    atoms = rs.assemble_atoms(conf, box, tiles.pad_order, state.prows)
    row_count = rs.chop_row_counts(atoms[:, :3], tiles.rank_mat, tiles.row_count, box, nb.cutoff)
    args = (atoms, tiles.row_start, row_count, tiles.col_ids, rs.sweep_scalars(box, nb.cutoff),
            rs.es_energy_force_series(nb.beta, nb.cutoff))
    form = dict(triangular=True, rcen_q=tiles.rcen_q, has_w=has_w)
    ms = cuda_ms(lambda: rs.rowscan_sweep(*args, rs.FORCE, **form))
    print(f"[rowscan main] {rs.__file__}: main form F {ms:.4f} ms (CUDA events over {REPS} launches, DHFR start; {smi})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("gather-splits", "rowscan-main"))
    parser.add_argument("--splits", type=int, nargs="+", default=[1, 2, 4])
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
    else:
        rowscan_main(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
