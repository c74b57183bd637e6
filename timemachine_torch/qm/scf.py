"""Restricted closed-shell NDDO/AM1 SCF.

The port's copy of timemachine_tpu/qm/scf.py (numpy and scipy).

Given element numbers and a conformer, builds the AM1 Fock problem
(core Hamiltonian with Slater-Koster resonance terms, NDDO two-electron
matrix, AM1 core-core repulsion with Gaussian corrections) and iterates
to self-consistency with damping + DIIS on the [F, P] commutator (the
NDDO secular equation is in an orthogonal basis, so no S^-1/2 is needed).

The deliverable is `AM1Result.charges` — Coulson/Mulliken atomic partial
charges used as AM1-family base charges by the forcefield layer.

Reference analog: `timemachine/ff/handlers/nonbonded.py:343-520` delegates
this entire computation to the proprietary OpenEye backend
(`oe_assign_charges`); there is no reference code path for the model
itself. This is an independent implementation of the published AM1 method
(Dewar, Zoebisch, Healy, Stewart, JACS 107:3902, 1985).

Everything here is host-side numpy by design: charge generation runs once
per molecule at system-build time (seconds), never inside the MD hot path.
"""

from dataclasses import dataclass

import numpy as np

from timemachine_torch.qm.integrals import (
    BOHR_PER_ANGSTROM,
    E2,
    element_multipoles,
    sto_overlap,
    two_center_global,
)
from timemachine_torch.qm.params import AM1_ELEMENTS, KCAL_PER_EV, SUPPORTED_ELEMENTS

EV_ANGSTROM_TO_DEBYE = 4.803205  # e*Angstrom -> Debye


class SCFConvergenceError(RuntimeError):
    pass


@dataclass(frozen=True)
class AM1Result:
    charges: np.ndarray  # Coulson partial charges, e units, (n_atoms,)
    energy_electronic: float  # eV
    energy_core: float  # eV
    energy_total: float  # eV (electronic + core-core)
    dipole: np.ndarray  # Debye, (3,) — point-charge + sp hybridization terms
    density: np.ndarray  # (nbasis, nbasis) padded 4-per-atom AO density
    orbital_energies: np.ndarray  # eV, compact (ghosts removed), ascending
    homo: float  # eV
    lumo: float  # eV
    n_iterations: int


def _overlap_block(za: int, zb: int, rvec_ang: np.ndarray) -> np.ndarray:
    """4x4 overlap block (s, px, py, pz on each center) via Slater-Koster
    combination of sigma/pi radial overlaps. Zero-padded for H."""
    ea, eb = AM1_ELEMENTS[za], AM1_ELEMENTS[zb]
    r_b = float(np.linalg.norm(rvec_ang)) * BOHR_PER_ANGSTROM
    u = rvec_ang / np.linalg.norm(rvec_ang)
    out = np.zeros((4, 4))
    ss = sto_overlap(ea.n, 0, ea.zeta_s, eb.n, 0, eb.zeta_s, r_b, 0)
    out[0, 0] = ss
    if eb.norb > 1:
        sp = sto_overlap(ea.n, 0, ea.zeta_s, eb.n, 1, eb.zeta_p, r_b, 0)
        out[0, 1:] = sp * u
    if ea.norb > 1:
        ps = sto_overlap(ea.n, 1, ea.zeta_p, eb.n, 0, eb.zeta_s, r_b, 0)
        out[1:, 0] = ps * u
    if ea.norb > 1 and eb.norb > 1:
        pps = sto_overlap(ea.n, 1, ea.zeta_p, eb.n, 1, eb.zeta_p, r_b, 0)
        ppp = sto_overlap(ea.n, 1, ea.zeta_p, eb.n, 1, eb.zeta_p, r_b, 1)
        uu = np.outer(u, u)
        out[1:, 1:] = uu * pps + (np.eye(3) - uu) * ppp
    return out


def _core_repulsion(za: int, zb: int, r_ang: float) -> float:
    """AM1 core-core energy for one pair, eV. MNDO monopole-screened term
    with the AM1 exponential scaling (R-weighted for N-H / O-H) plus the
    AM1 Gaussian core corrections."""
    ea, eb = AM1_ELEMENTS[za], AM1_ELEMENTS[zb]
    rho0a = element_multipoles(za)[1][0]
    rho0b = element_multipoles(zb)[1][0]
    gamma = E2 / np.sqrt(r_ang**2 + (rho0a + rho0b) ** 2)
    fa, fb = np.exp(-ea.alpha * r_ang), np.exp(-eb.alpha * r_ang)
    # MNDO/AM1 rule: for X-H with X in {N, O}, the heavy-atom exponential
    # is weighted by R
    if za in (7, 8) and zb == 1:
        fa = fa * r_ang
    if zb in (7, 8) and za == 1:
        fb = fb * r_ang
    e = ea.zval * eb.zval * gamma * (1.0 + fa + fb)
    gauss = 0.0
    for el in (ea, eb):
        for k, l, m in zip(el.gauss_k, el.gauss_l, el.gauss_m):
            gauss += k * np.exp(-l * (r_ang - m) ** 2)
    # NB: the published K parameters absorb e^2 (MOPAC convention): the
    # Gaussian term is Z_A Z_B / R * sum K e^{-L(R-M)^2} with K in eV*Angstrom
    e += ea.zval * eb.zval / r_ang * gauss
    return float(e)


def _one_center_terms(z: int):
    """(g, h) one-center two-electron integral matrices in the 4-orbital
    basis: g[mu,nu] = (mu mu|nu nu), h[mu,nu] = (mu nu|mu nu)."""
    el = AM1_ELEMENTS[z]
    g = np.zeros((4, 4))
    h = np.zeros((4, 4))
    g[0, 0] = el.gss
    h[0, 0] = el.gss
    if el.norb > 1:
        for p in range(1, 4):
            g[0, p] = g[p, 0] = el.gsp
            h[0, p] = h[p, 0] = el.hsp
            g[p, p] = el.gpp
            h[p, p] = el.gpp
            for q in range(1, 4):
                if q != p:
                    g[p, q] = el.gp2
                    h[p, q] = 0.5 * (el.gpp - el.gp2)
    return g, h


class AM1System:
    """Assembled AM1 matrices for one molecule + conformer.

    Basis layout is padded: 4 AO slots per atom (s, px, py, pz); hydrogen
    p slots are ghosts, decoupled everywhere and pinned out of the
    occupied space with a large diagonal shift. Padding keeps every pair
    contraction a fixed-shape einsum over a (n_pairs, 4, 4, 4, 4) stack.
    """

    GHOST_SHIFT = 1e6  # eV added to ghost-orbital diagonal

    def __init__(self, elements, coords_ang, charge: int = 0):
        elements = [int(z) for z in elements]
        unsupported = sorted({z for z in elements if z not in SUPPORTED_ELEMENTS})
        if unsupported:
            raise ValueError(f"AM1 parameters unavailable for elements {unsupported}")
        self.elements = elements
        self.coords = np.asarray(coords_ang, dtype=np.float64)
        assert self.coords.shape == (len(elements), 3)
        self.charge = charge
        self.n_atoms = len(elements)
        self.nbasis = 4 * self.n_atoms
        els = [AM1_ELEMENTS[z] for z in elements]
        self.zval = np.array([e.zval for e in els], dtype=np.float64)
        self.n_electrons = int(self.zval.sum()) - charge
        if self.n_electrons % 2 != 0:
            raise ValueError(
                f"AM1 SCF here is restricted closed-shell; got {self.n_electrons} electrons "
                f"(net charge {charge}). Radicals are unsupported."
            )
        self.norb = np.array([e.norb for e in els])
        mask = np.zeros((self.n_atoms, 4), dtype=bool)
        for i, e in enumerate(els):
            mask[i, : e.norb] = True
        self.ao_mask = mask.reshape(-1)  # real (non-ghost) AOs

        self._build_pairs()
        self._build_core()

    def _build_pairs(self):
        n = self.n_atoms
        ia, ib = np.triu_indices(n, k=1)
        self.pair_a = ia
        self.pair_b = ib
        npair = len(ia)
        self.g_pairs = np.zeros((npair, 4, 4, 4, 4))
        s_res = np.zeros((self.nbasis, self.nbasis))
        e_core = 0.0
        beta = np.zeros((self.n_atoms, 4))
        for i, z in enumerate(self.elements):
            el = AM1_ELEMENTS[z]
            beta[i, 0] = el.beta_s
            beta[i, 1:] = el.beta_p
        for p in range(npair):
            a, b = int(ia[p]), int(ib[p])
            za, zb = self.elements[a], self.elements[b]
            rvec = self.coords[b] - self.coords[a]
            g = two_center_global(za, zb, rvec)
            na, nb = g.shape[0], g.shape[2]
            self.g_pairs[p, :na, :na, :nb, :nb] = g
            sblk = _overlap_block(za, zb, rvec)
            hblk = 0.5 * (beta[a][:, None] + beta[b][None, :]) * sblk
            s_res[4 * a : 4 * a + 4, 4 * b : 4 * b + 4] = hblk
            s_res[4 * b : 4 * b + 4, 4 * a : 4 * a + 4] = hblk.T
            e_core += _core_repulsion(za, zb, float(np.linalg.norm(rvec)))
        self.h_resonance = s_res
        self.energy_core = e_core

    def _build_core(self):
        h = self.h_resonance.copy()
        # one-center U terms
        for i, z in enumerate(self.elements):
            el = AM1_ELEMENTS[z]
            h[4 * i, 4 * i] += el.uss
            for p in range(1, el.norb):
                h[4 * i + p, 4 * i + p] += el.upp
        # core attraction: V_(mu nu on A) = -Z_B (mu nu | s_B s_B)
        for p in range(len(self.pair_a)):
            a, b = int(self.pair_a[p]), int(self.pair_b[p])
            g = self.g_pairs[p]
            h[4 * a : 4 * a + 4, 4 * a : 4 * a + 4] -= self.zval[b] * g[:, :, 0, 0]
            h[4 * b : 4 * b + 4, 4 * b : 4 * b + 4] -= self.zval[a] * g[0, 0, :, :]
        ghost = ~self.ao_mask
        h[np.diag_indices_from(h)] += ghost * self.GHOST_SHIFT
        self.h_core = h
        self.one_center_g = np.stack([_one_center_terms(z)[0] for z in self.elements])
        self.one_center_h = np.stack([_one_center_terms(z)[1] for z in self.elements])

    # -- Fock assembly ------------------------------------------------------

    def _fock(self, p_mat: np.ndarray) -> np.ndarray:
        n = self.n_atoms
        f = self.h_core.copy()
        pb = p_mat.reshape(n, 4, n, 4)

        # one-center: F_mumu += P_mumu g/2 + sum_nu!=mu P_nunu (g - h/2)
        #             F_munu += P_munu (1.5 h - 0.5 g)   (mu != nu on A)
        pd = np.einsum("aiai->ai", pb)  # (n, 4) diagonal densities
        g1, h1 = self.one_center_g, self.one_center_h
        diag_add = 0.5 * pd * np.einsum("aii->ai", g1)
        off_sum = np.einsum("aj,aij->ai", pd, g1 - 0.5 * h1) - pd * (
            np.einsum("aii->ai", g1) - 0.5 * np.einsum("aii->ai", h1)
        )
        p_same = np.einsum("aiaj->aij", pb)
        f_same = p_same * (1.5 * h1 - 0.5 * g1)
        ii = np.arange(n)[:, None, None]
        jj = np.arange(4)[None, :, None]
        kk = np.arange(4)[None, None, :]
        fb = f.reshape(n, 4, n, 4)
        np.add.at(fb, (ii, jj, ii, kk), f_same)
        # diagonal: replace the (wrong) f_same diagonal with the proper
        # 0.5 P g + sum_{nu != mu} P_nunu (g - h/2) closed-shell terms
        ia = np.arange(n)[:, None]
        io = np.arange(4)[None, :]
        fb[ia, io, ia, io] += diag_add + off_sum - np.einsum("aii->ai", f_same)

        if len(self.pair_a):
            g = self.g_pairs
            pa_blk = pb[self.pair_a, :, self.pair_a, :]  # (npair, 4, 4)
            pb_blk = pb[self.pair_b, :, self.pair_b, :]
            pab_blk = pb[self.pair_a, :, self.pair_b, :]
            # Coulomb: density on B raises the A diagonal block and vice versa
            fa = np.einsum("pijkl,pkl->pij", g, pb_blk)
            fbv = np.einsum("pijkl,pij->pkl", g, pa_blk)
            # Exchange on the A-B off-diagonal block (mu on A, lam on B)
            fab = -0.5 * np.einsum("pmnls,pns->pml", g, pab_blk)
            fb4 = f.reshape(n, 4, n, 4)
            r4 = np.arange(4)
            idx_i, idx_j = r4[None, :, None], r4[None, None, :]
            np.add.at(fb4, (self.pair_a[:, None, None], idx_i, self.pair_a[:, None, None], idx_j), fa)
            np.add.at(fb4, (self.pair_b[:, None, None], idx_i, self.pair_b[:, None, None], idx_j), fbv)
            np.add.at(fb4, (self.pair_a[:, None, None], idx_i, self.pair_b[:, None, None], idx_j), fab)
            np.add.at(fb4, (self.pair_b[:, None, None], idx_i, self.pair_a[:, None, None], idx_j), np.swapaxes(fab, 1, 2))
            f = fb4.reshape(self.nbasis, self.nbasis)
        return 0.5 * (f + f.T)

    # -- SCF ----------------------------------------------------------------

    def initial_density(self) -> np.ndarray:
        pd = np.zeros((self.n_atoms, 4))
        frac = self.n_electrons / self.zval.sum()
        for i in range(self.n_atoms):
            pd[i, : self.norb[i]] = frac * self.zval[i] / self.norb[i]
        return np.diag(pd.reshape(-1))

    def solve(self, max_iter: int = 500, tol: float = 1e-7, diis_depth: int = 8) -> AM1Result:
        p = self.initial_density()
        nocc = self.n_electrons // 2
        f_hist, e_hist = [], []
        e_old, err_max = np.inf, np.inf
        damping = 0.35
        for it in range(1, max_iter + 1):
            f = self._fock(p)
            e_elec = 0.5 * np.sum(p * (self.h_core + f))
            err = f @ p - p @ f
            err_max = float(np.max(np.abs(err)))
            if err_max < tol * 100 and abs(e_elec - e_old) < tol:
                _ghost_energy_correction(self, p)
                return self._finalize(p, e_elec, it)
            e_old = e_elec
            f_hist.append(f)
            e_hist.append(err)
            if len(f_hist) > diis_depth:
                f_hist.pop(0)
                e_hist.pop(0)
            f_use = _diis_extrapolate(f_hist, e_hist) if len(f_hist) >= 2 and err_max < 10.0 else f
            _, c = np.linalg.eigh(f_use)
            p_new = 2.0 * c[:, :nocc] @ c[:, :nocc].T
            # plain damping until DIIS has history, then take full steps
            mix = 1.0 if len(f_hist) >= 3 and err_max < 1.0 else damping
            p = (1.0 - mix) * p + mix * p_new
        raise SCFConvergenceError(
            f"AM1 SCF failed to converge in {max_iter} iterations (|[F,P]|={err_max:.2e})"
        )

    def _finalize(self, p: np.ndarray, e_elec: float, n_iter: int) -> AM1Result:
        pd = np.einsum("ii->i", p).reshape(self.n_atoms, 4)
        charges = self.zval - pd.sum(axis=1)
        f = self._fock(p)
        evals = np.linalg.eigvalsh(f)
        evals = evals[evals < 0.5 * self.GHOST_SHIFT]
        nocc = self.n_electrons // 2
        homo = float(evals[nocc - 1])
        lumo = float(evals[nocc]) if len(evals) > nocc else np.nan
        # dipole: point-charge + sp hybridization term (local s-p dipole D1)
        mu = (charges[:, None] * self.coords).sum(axis=0)
        pb = p.reshape(self.n_atoms, 4, self.n_atoms, 4)
        for i, z in enumerate(self.elements):
            if AM1_ELEMENTS[z].norb == 1:
                continue
            cfg, _ = element_multipoles(z)
            d1 = cfg[(0, 1)][0][1][0]  # dipole length, Angstrom
            sp = np.array([pb[i, 0, i, k] for k in (1, 2, 3)])
            mu -= 2.0 * d1 * sp
        dipole = mu * EV_ANGSTROM_TO_DEBYE
        return AM1Result(
            charges=charges,
            energy_electronic=float(e_elec),
            energy_core=float(self.energy_core),
            energy_total=float(e_elec + self.energy_core),
            dipole=dipole,
            density=p,
            orbital_energies=evals,
            homo=homo,
            lumo=lumo,
            n_iterations=n_iter,
        )


def _ghost_energy_correction(system: AM1System, p: np.ndarray) -> float:
    """Ghost AOs never carry density, so their shifted diagonal contributes
    exactly zero; kept as an explicit guard (and assertion surface)."""
    ghost = ~system.ao_mask
    leak = float(np.einsum("ii->i", p)[ghost].sum())
    if leak > 1e-9:
        raise SCFConvergenceError(f"density leaked onto ghost orbitals ({leak:.2e})")
    return 0.0


def _diis_extrapolate(f_hist, e_hist) -> np.ndarray:
    m = len(f_hist)
    b = -np.ones((m + 1, m + 1))
    b[m, m] = 0.0
    for i in range(m):
        for j in range(m):
            b[i, j] = np.sum(e_hist[i] * e_hist[j])
    rhs = np.zeros(m + 1)
    rhs[m] = -1.0
    try:
        coef = np.linalg.solve(b, rhs)[:m]
    except np.linalg.LinAlgError:
        return f_hist[-1]
    if not np.all(np.isfinite(coef)):
        return f_hist[-1]
    return sum(c * f for c, f in zip(coef, f_hist))


def am1(elements, coords_ang, charge: int = 0, **kw) -> AM1Result:
    """Run an AM1 single point; returns charges/energies/dipole."""
    return AM1System(elements, coords_ang, charge).solve(**kw)


def heat_of_formation_kcal(result: AM1Result, elements) -> float:
    """Standard MOPAC-style HOF: E_total - sum(EISOL) + sum(experimental
    atomic heats). EISOL computed from the same one-center parameters via
    `atomic_eisol`."""
    eisol = sum(atomic_eisol(int(z)) for z in elements)
    eheat = sum(AM1_ELEMENTS[int(z)].eheat for z in elements)
    return (result.energy_total - eisol) * KCAL_PER_EV + eheat


def atomic_eisol(z: int) -> float:
    """Ground-state valence energy of the isolated neutral atom, eV, as a
    single high-spin (Hund) determinant over the one-center AM1
    parameters: E = sum_i U_i + sum_{i<j} [J_ij - K_ij delta(spin)].
    Reproduces the MOPAC-tabulated EISOL values (e.g. C -120.8158,
    O -316.0995) exactly."""
    el = AM1_ELEMENTS[z]
    ne = el.zval
    ns = min(ne, 2)
    npp = ne - ns
    # electron list: (shell, orbital, spin); aufbau s then Hund-filled p
    electrons = [("s", 0, 0)] if ns >= 1 else []
    if ns == 2:
        electrons.append(("s", 0, 1))
    for k in range(npp):
        electrons.append(("p", k % 3, 0 if k < 3 else 1))
    e = ns * el.uss + npp * el.upp
    k_pp = 0.5 * (el.gpp - el.gp2)  # (pp'|pp')
    for i in range(len(electrons)):
        for j in range(i + 1, len(electrons)):
            (sh_i, orb_i, sp_i), (sh_j, orb_j, sp_j) = electrons[i], electrons[j]
            if sh_i == "s" and sh_j == "s":
                jj, kk = el.gss, el.gss
            elif sh_i != sh_j:
                jj, kk = el.gsp, el.hsp
            elif orb_i == orb_j:
                jj, kk = el.gpp, el.gpp
            else:
                jj, kk = el.gp2, k_pp
            e += jj
            if sp_i == sp_j:
                e -= kk
    return e
