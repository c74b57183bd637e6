"""Forcefield training through a sampled free energy, end to end (the port
of the JAX package's scripts/training_demo.py).

Fits a forcefield parameter by gradients through free energies estimated
from samples:

  1. The label: a molecule in vacuum; its "experimental" value is the
     intramolecular discharging free energy (full charges -> q = 0), by BAR
     on ensembles sampled at the true charges.
  2. The working forcefield starts with the ligand's charges scaled by
     `scale_init` (1.25: a deliberately wrong parameter).
  3. Each round samples both endpoints at the current scale, builds the
     endpoint reweighting estimator (fe/reweighting.py), and takes Adam
     steps on (df_est(s) - df*)^2; the next round samples again.
  4. The loss falls in every round and the scale returns towards 1.

The molecule is an argument (SMILES, embedded by the port's chem); the
JAX script reads FreeSolv's mobley_1017962 from its SDF, which the port
does not carry (ROADMAP P35). Sampling is integrator.simulate on `device`
(None: the card). Writes a JSON file only where given a path.

Run: python -m timemachine_torch.optimize.training_demo --smiles CCO [--out result.json]
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from timemachine_torch.constants import BOLTZ
from timemachine_torch.device import resolve_device, working_dtype

EMBED_SEED = 7  # the molecule's conformer from its SMILES
LABEL_SEEDS = (100, 200)  # the label's sampling at full and zero charges
ROUND_SEEDS = (1000, 2000)  # plus the round's index


@dataclass(frozen=True)
class DemoConfig:
    """The JAX script's constants: its depth is n_walkers x n_batches x
    steps_per_batch a sampling, n_rounds rounds of steps_per_round Adam
    steps."""

    temperature: float = 300.0
    scale_init: float = 1.25
    n_walkers: int = 8
    n_batches: int = 60
    steps_per_batch: int = 25
    n_rounds: int = 3
    steps_per_round: int = 60
    learning_rate: float = 0.01


class DemoEnergies:
    """The molecule's vacuum energies as functions of one conformer (N, 3)
    on `device` in `dtype`: u_total(x, s) with every charge scaled by s (the
    pair list's q_ij by s^2), and u_discharged(x) with the charges off."""

    def __init__(self, mol, ff, temperature: float = 300.0, device=None, dtype=None):
        from timemachine_torch.convert import modules_from_bound_potentials
        from timemachine_torch.fe.topology import BaseTopology
        from timemachine_torch.fe.utils import get_mol_masses, get_romol_conf

        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device, dtype)
        guest = BaseTopology(mol, ff).setup_end_state()
        terms = [guest.bond, guest.angle, guest.proper, guest.improper, guest.nonbonded_pair_list]
        *self.valence, self.pair_list = modules_from_bound_potentials(terms, mol.num_atoms, self.device, self.dtype)
        self.params0 = self.pair_list.params  # (P, 4): [q_ij, sig_ij, eps_ij, w]
        self.box = torch.eye(3, device=self.device, dtype=self.dtype) * 100.0  # vacuum
        self.x0 = get_romol_conf(mol)
        self.masses = get_mol_masses(mol)
        self.kT = BOLTZ * temperature

    def nb_params(self, scale):
        """The pair list's parameters at charge scale s: q_ij times s^2."""
        s2 = torch.as_tensor(scale, device=self.device, dtype=self.dtype) ** 2
        return self.params0 * torch.cat([s2.reshape(1), s2.new_ones(3)])

    def u_valence(self, x):
        return sum(m.energy(x, self.box) for m in self.valence)

    def u_total(self, x, scale):
        return self.u_valence(x) + self.pair_list.u(x, self.nb_params(scale), self.box)

    def u_discharged(self, x):
        return self.u_total(x, 0.0)

    def batched(self, u_fn, xs):
        """u_fn over a stack of conformers (M, N, 3), a tensor there."""
        xs = torch.as_tensor(xs, device=self.device, dtype=self.dtype)
        return torch.func.vmap(u_fn)(xs)


def sample(energies: DemoEnergies, u_fn, cfg: DemoConfig, seed: int) -> np.ndarray:
    """Frames of cfg.n_walkers walkers under u_fn from the molecule's
    conformer, the first fifth of each walker's frames dropped as burn-in
    and the frames of a walker that diverged left out: (M, N, 3) numpy."""
    from timemachine_torch.integrator import simulate

    xs, _ = simulate(energies.x0, u_fn, cfg.temperature, energies.masses, cfg.steps_per_batch, cfg.n_batches,
                     cfg.n_walkers, seed=seed, device=energies.device)
    xs = xs[:, xs.shape[1] // 5 :].reshape(-1, *energies.x0.shape)
    return xs[np.isfinite(xs).all(axis=(1, 2))]


def bar_df(energies: DemoEnergies, scale, xs_a, xs_b) -> tuple:
    """(df, its error) in kT from charged (scale) to discharged, by BAR on
    frames xs_a sampled charged and xs_b discharged."""
    from timemachine_torch.fe.bar import bar, works_from_ukln

    def reduced(u_fn, xs):
        with torch.no_grad():
            return energies.batched(u_fn, xs).double().cpu().numpy() / energies.kT

    def charged(x):
        return energies.u_total(x, scale)

    n = min(len(xs_a), len(xs_b))
    u_kln = np.array([
        [reduced(charged, xs_a)[:n], reduced(energies.u_discharged, xs_a)[:n]],
        [reduced(charged, xs_b)[:n], reduced(energies.u_discharged, xs_b)[:n]],
    ])
    w_F, w_R = works_from_ukln(u_kln)
    df, err = bar(np.asarray(w_F), np.asarray(w_R))
    return float(df), float(err)


def endpoint_estimator(energies: DemoEnergies, xs_a, xs_b, ref_scale: float, ref_df: float):
    """df_est(s): the endpoint reweighting estimator of the discharging free
    energy at charge scale s from a round's frames, differentiable in s."""
    from timemachine_torch.fe.reweighting import construct_endpoint_reweighting_estimator

    kT = energies.kT

    def batched_u_0(xs, s):
        return energies.batched(lambda x: energies.u_total(x, s), xs) / kT

    def batched_u_1(xs, s):
        return energies.batched(energies.u_discharged, xs) / kT

    xs_a = torch.as_tensor(xs_a, device=energies.device, dtype=energies.dtype)
    xs_b = torch.as_tensor(xs_b, device=energies.device, dtype=energies.dtype)
    return construct_endpoint_reweighting_estimator(xs_a, xs_b, batched_u_0, batched_u_1, ref_scale, ref_df)


def train_round(est, label_df: float, scale: float, cfg: DemoConfig) -> dict:
    """cfg.steps_per_round Adam steps (torch.optim.Adam at the JAX script's
    learning rate) on (est(s) - label)^2 from s = scale."""
    theta = torch.tensor(scale, dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=cfg.learning_rate)

    def loss_fn(s):
        return (est(s) - label_df) ** 2

    with torch.no_grad():
        loss_start = float(loss_fn(theta))
    (dest_ds,) = torch.autograd.grad(est(theta), theta)
    for _ in range(cfg.steps_per_round):
        opt.zero_grad()
        loss_fn(theta).backward()
        opt.step()
    with torch.no_grad():
        loss_end = float(loss_fn(theta))
        pred = float(est(theta))
    return dict(loss_start=loss_start, loss_end=loss_end, scale=float(theta.detach()), pred_df_kbt=pred,
                dest_ds_start=float(dest_ds))


def run_demo(mol, ff, cfg: DemoConfig = DemoConfig(), device=None, log=print) -> dict:
    """The demo on `mol` (embedded) at cfg's depth, sampling on `device`
    (None: the card). Returns the JAX script's record, each round's frames
    under "samples" (not part of the record)."""
    t_start = time.perf_counter()
    from timemachine_torch.fe.utils import get_mol_name

    energies = DemoEnergies(mol, ff, cfg.temperature, device)

    xs_0 = sample(energies, lambda x: energies.u_total(x, 1.0), cfg, LABEL_SEEDS[0])
    xs_1 = sample(energies, energies.u_discharged, cfg, LABEL_SEEDS[1])
    label_df, label_err = bar_df(energies, 1.0, xs_0, xs_1)
    log(f"label discharging df* = {label_df:.3f} +- {label_err:.3f} kT")

    scale = cfg.scale_init
    history, samples = [], []
    for rnd in range(cfg.n_rounds):
        xs_a = sample(energies, lambda x, s=scale: energies.u_total(x, s), cfg, ROUND_SEEDS[0] + rnd)
        xs_b = sample(energies, energies.u_discharged, cfg, ROUND_SEEDS[1] + rnd)
        ref_df, _ = bar_df(energies, scale, xs_a, xs_b)
        est = endpoint_estimator(energies, xs_a, xs_b, scale, ref_df)
        out = train_round(est, label_df, scale, cfg)
        history.append(dict(round=rnd, scale_start=scale, ref_df_kbt=ref_df, **out))
        samples.append(dict(xs_a=xs_a, xs_b=xs_b, scale=scale, ref_df=ref_df))
        scale = out["scale"]
        log(f"round {rnd}: loss {out['loss_start']:.4f} -> {out['loss_end']:.4f}, scale {scale:.4f}, "
            f"pred df {out['pred_df_kbt']:.3f} (ref {ref_df:.3f}, label {label_df:.3f})")

    return dict(
        kind="training_demo",
        description="gradient recovery of a perturbed charge scale through a sampled free energy",
        mol=get_mol_name(mol),
        temperature_K=cfg.temperature,
        label_df_kbt=label_df,
        label_err_kbt=label_err,
        scale_init=cfg.scale_init,
        scale_final=scale,
        rounds=history,
        sampling=asdict(cfg),
        device=str(energies.device),
        wall_s=time.perf_counter() - t_start,
        samples=samples,
    )


def main(argv=None) -> int:
    from timemachine_torch.chem import mol_from_smiles
    from timemachine_torch.chem.embed import embed_mol
    from timemachine_torch.ff import Forcefield

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--smiles", default="CCO", help="the molecule (hydrogens added)")
    parser.add_argument("--walkers", type=int, default=DemoConfig.n_walkers)
    parser.add_argument("--batches", type=int, default=DemoConfig.n_batches)
    parser.add_argument("--steps-per-batch", type=int, default=DemoConfig.steps_per_batch)
    parser.add_argument("--rounds", type=int, default=DemoConfig.n_rounds)
    parser.add_argument("--adam-steps", type=int, default=DemoConfig.steps_per_round)
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--out", default=None, help="write the record as JSON here")
    args = parser.parse_args(argv)

    mol = mol_from_smiles(args.smiles, add_hs=True, name=args.smiles)
    embed_mol(mol, seed=EMBED_SEED)
    cfg = DemoConfig(n_walkers=args.walkers, n_batches=args.batches, steps_per_batch=args.steps_per_batch,
                     n_rounds=args.rounds, steps_per_round=args.adam_steps)
    record = run_demo(mol, Forcefield.load_default(), cfg, device=args.device)
    record.pop("samples")
    text = json.dumps(record)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
