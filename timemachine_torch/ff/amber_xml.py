"""Amber-parity protein parameterization from an OpenMM-style forcefield XML
(the port's copy of timemachine_tpu/ff/amber_xml.py; numpy and ElementTree
only).

Parity target: the reference's host path — `openmm.app.ForceField(...).
createSystem(topology)` followed by the System deserializer
(reference ff/handlers/openmm_deserializer.py:131, md/builders.py:197).
The reference delegates residue-template matching and parameter assignment
to OpenMM; this module implements that assignment natively so the complex
leg reaches Amber-parity physics WITHOUT OpenMM, given any Amber-style XML
(the repository ships the reconstructed amber99sb set,
timemachine_tpu/ff/params/amber99sb.xml, read as a file; see
ARCHITECTURE.md "Amber host policy").

Scope (the subset Amber protein forcefields use):
  <AtomTypes><Type name class element mass/>
  <Residues><Residue name><Atom name type charge/><Bond .../>
           <ExternalBond .../></Residue>
  <HarmonicBondForce><Bond class1 class2 length k/>      E = k/2 (r-r0)^2
  <HarmonicAngleForce><Angle class1..3 angle k/>         E = k/2 (t-t0)^2
  <PeriodicTorsionForce><Proper|Improper class1..4 periodicityN phaseN kN/>
  <NonbondedForce coulomb14scale lj14scale><Atom type charge sigma epsilon/>
    [<UseAttributeFromResidue name="charge"/>]

Assignment semantics mirror OpenMM's ForceField:
  * residue templates are selected per perceived PDB residue among the
    candidate variants (base, N-/C-terminal, protonation states) by EXACT
    heavy-atom-name + per-parent hydrogen-count match;
  * hydrogens are matched by parent heavy atom (Amber templates give equal
    type/charge to hydrogens sharing a parent; validated, not assumed);
  * bonds/angles/propers come from the molecular graph with class-tuple
    lookup; wildcard ("") torsion entries apply only when no exact entry
    matches (OpenMM's rule);
  * impropers: entries list the CENTRAL atom first; each center with >= 3
    neighbors takes at most one improper per matching entry, emitted in the
    OpenMM atom order (n1, n2, central, n3) so the downstream proper/improper
    angle-count splitter classifies it as improper;
  * 1-4 exclusions scaled by (1 - coulomb14scale, 1 - lj14scale) in this
    framework's rescale convention; 1-2/1-3 fully excluded.

Charges: residue-template charges when present (or when the XML carries
<UseAttributeFromResidue name="charge"/>); otherwise the NonbondedForce
per-type charge.
"""

from __future__ import annotations

from dataclasses import dataclass
from xml.etree import ElementTree

import numpy as np

from timemachine_torch.ff.serialize import builtin_params_dir

# the reconstructed Amber ff99SB set (timemachine_tpu/ff/params/__init__.py's AMBER99SB_XML), read as a file
AMBER99SB_XML = builtin_params_dir() / "amber99sb.xml"

WILD = ""


@dataclass
class ResidueTemplate:
    name: str
    atom_names: list
    atom_types: list
    atom_charges: list
    bonds: list  # (local_i, local_j)
    external: list  # local indices with external bonds


@dataclass
class AmberForceField:
    type_element: dict
    type_class: dict
    type_mass: dict
    residues: dict  # name -> ResidueTemplate
    bond_params: dict  # frozenset/tuple of classes -> (k, r0)
    angle_params: dict  # (c1, c2, c3) canonical -> (k, t0)
    propers: list  # (classes (c1..c4), [(k, phase, periodicity), ...])
    impropers: list  # (classes (central, c2, c3, c4), [(k, phase, n), ...])
    coulomb14scale: float
    lj14scale: float
    type_charge: dict  # type -> charge (NonbondedForce fallback)
    type_lj: dict  # type -> (sigma, epsilon)
    charge_from_residue: bool

    @classmethod
    def parse(cls, paths) -> "AmberForceField":
        if isinstance(paths, str):
            paths = [paths]
        type_element: dict = {}
        type_class: dict = {}
        type_mass: dict = {}
        residues: dict = {}
        bond_params: dict = {}
        angle_params: dict = {}
        propers: list = []
        impropers: list = []
        type_charge: dict = {}
        type_lj: dict = {}
        coulomb14scale = 1.0 / 1.2
        lj14scale = 0.5
        charge_from_residue = False

        def classes_of(node, n):
            out = []
            for k in range(1, n + 1):
                c = node.get(f"class{k}")
                if c is None:
                    t = node.get(f"type{k}")
                    c = type_class.get(t, t) if t not in (None, "") else ""
                out.append(c)
            return tuple(out)

        def torsion_terms(node):
            terms = []
            k = 1
            while node.get(f"periodicity{k}") is not None:
                terms.append(
                    (
                        float(node.get(f"k{k}")),
                        float(node.get(f"phase{k}")),
                        int(node.get(f"periodicity{k}")),
                    )
                )
                k += 1
            return terms

        for path in paths:
            root = ElementTree.parse(path).getroot()
            for t in root.iter("Type"):
                name = t.get("name")
                type_element[name] = t.get("element", "")
                type_class[name] = t.get("class", name)
                type_mass[name] = float(t.get("mass", "0"))
            for res in root.iter("Residue"):
                names, types, charges, bonds, external = [], [], [], [], []
                for child in res:
                    if child.tag == "Atom":
                        names.append(child.get("name"))
                        types.append(child.get("type"))
                        charges.append(float(child.get("charge", "0")))
                    elif child.tag == "Bond":
                        if child.get("atomName1") is not None:
                            i = names.index(child.get("atomName1"))
                            j = names.index(child.get("atomName2"))
                        else:
                            i = int(child.get("from"))
                            j = int(child.get("to"))
                        bonds.append((i, j))
                    elif child.tag == "ExternalBond":
                        if child.get("atomName") is not None:
                            external.append(names.index(child.get("atomName")))
                        else:
                            external.append(int(child.get("from")))
                residues[res.get("name")] = ResidueTemplate(
                    res.get("name"), names, types, charges, bonds, external
                )
            for f in root.iter("HarmonicBondForce"):
                for b in f:
                    c = classes_of(b, 2)
                    bond_params[tuple(sorted(c))] = (float(b.get("k")), float(b.get("length")))
            for f in root.iter("HarmonicAngleForce"):
                for a in f:
                    c1, c2, c3 = classes_of(a, 3)
                    key = (c1, c2, c3) if (c1 <= c3) else (c3, c2, c1)
                    angle_params[key] = (float(a.get("k")), float(a.get("angle")))
            for f in root.iter("PeriodicTorsionForce"):
                for t in f:
                    if t.tag == "Proper":
                        propers.append((classes_of(t, 4), torsion_terms(t)))
                    elif t.tag == "Improper":
                        impropers.append((classes_of(t, 4), torsion_terms(t)))
            for f in root.iter("NonbondedForce"):
                coulomb14scale = float(f.get("coulomb14scale", coulomb14scale))
                lj14scale = float(f.get("lj14scale", lj14scale))
                for a in f:
                    if a.tag == "UseAttributeFromResidue" and a.get("name") == "charge":
                        charge_from_residue = True
                    elif a.tag == "Atom":
                        tname = a.get("type")
                        if tname is None:
                            # per-class entry: expand to every type of the class
                            cls_name = a.get("class")
                            tnames = [t for t, c in type_class.items() if c == cls_name]
                        else:
                            tnames = [tname]
                        for tn in tnames:
                            type_charge[tn] = float(a.get("charge", "0"))
                            type_lj[tn] = (float(a.get("sigma")), float(a.get("epsilon")))

        return cls(
            type_element=type_element,
            type_class=type_class,
            type_mass=type_mass,
            residues=residues,
            bond_params=bond_params,
            angle_params=angle_params,
            propers=propers,
            impropers=impropers,
            coulomb14scale=coulomb14scale,
            lj14scale=lj14scale,
            type_charge=type_charge,
            type_lj=type_lj,
            charge_from_residue=charge_from_residue,
        )


@dataclass
class AmberHostParams:
    """Protein parameters in this framework's layouts (indices into the
    perceived protein atom order)."""

    charges: np.ndarray  # (N,) elementary units (NOT sqrt(ONE_4PI_EPS0)-scaled)
    lj: np.ndarray  # (N, 2) [sigma, epsilon]
    masses: np.ndarray  # (N,)
    bond_idxs: np.ndarray
    bond_params: np.ndarray  # (k, r0)
    angle_idxs: np.ndarray
    angle_params: np.ndarray  # (k, t0, 0.0)
    proper_idxs: np.ndarray
    proper_params: np.ndarray  # (k, phase, n)
    improper_idxs: np.ndarray
    improper_params: np.ndarray
    exclusion_idxs: np.ndarray
    exclusion_scales: np.ndarray  # (n, 2) [q_scale, lj_scale] rescale-mask convention
    atom_types: list


class AmberAssignmentError(ValueError):
    pass


def _candidate_names(resname: str, is_first: bool, is_last: bool):
    """Template-name candidates in preference order (terminal variants first
    when applicable, then protonation variants). The final choice is made by
    exact structural match, so order only breaks ties."""
    base_variants = {
        "HIS": ["HIE", "HID", "HIP", "HIS"],
        "CYS": ["CYS", "CYX", "CYM"],
        "ASP": ["ASP", "ASH"],
        "GLU": ["GLU", "GLH"],
        "LYS": ["LYS", "LYN"],
    }.get(resname, [resname])
    # PDB protonation spellings are themselves template names
    if resname not in base_variants:
        base_variants = [resname] + base_variants
    out = []
    if is_first:
        out += ["N" + v for v in base_variants]
    if is_last:
        out += ["C" + v for v in base_variants]
    out += base_variants
    return out


def _template_structure(tpl: ResidueTemplate, ff: AmberForceField):
    """(heavy name set, per-heavy-name hydrogen count, heavy->[H local idxs])"""
    is_h = [ff.type_element.get(t, "?") == "H" for t in tpl.atom_types]
    nbrs: dict[int, list] = {i: [] for i in range(len(tpl.atom_names))}
    for i, j in tpl.bonds:
        nbrs[i].append(j)
        nbrs[j].append(i)
    heavy_names = {nm for nm, h in zip(tpl.atom_names, is_h) if not h}
    h_of: dict[str, list] = {}
    for i, h in enumerate(is_h):
        if not h:
            continue
        parents = [j for j in nbrs[i] if not is_h[j]]
        if len(parents) != 1:
            raise AmberAssignmentError(f"template {tpl.name}: hydrogen {tpl.atom_names[i]} has {len(parents)} heavy neighbors")
        h_of.setdefault(tpl.atom_names[parents[0]], []).append(i)
    return heavy_names, h_of


def assign_protein_parameters(structure, protein_mol, ff: AmberForceField) -> AmberHostParams:
    """Match each perceived residue to its template and assign all terms.

    `structure`: chem.pdb.PDBStructure; `protein_mol`: the perceived
    chem.Mol from protein_mol_from_pdb (its atom order IS the structure's
    residue/atom-record order — asserted here)."""
    from timemachine_torch.chem.pdb import _ATOM_ALIASES, _GLOBAL_ATOM_ALIASES, _RES_ALIASES

    residues = structure.residues
    n_atoms = protein_mol.num_atoms

    # rebuild the global traversal (identical to protein_mol_from_pdb)
    atom_names: list = []
    atom_elems: list = []
    atom_res: list = []
    res_first: dict = {}
    for ri, res in enumerate(residues):
        aliases = _ATOM_ALIASES.get(_RES_ALIASES.get(res.name, res.name), {})
        for nm, el in zip(res.atom_names, res.elements):
            nm = aliases.get(nm, _GLOBAL_ATOM_ALIASES.get(nm, nm))
            atom_names.append(nm)
            atom_elems.append(el)
            atom_res.append(ri)
            res_first.setdefault(ri, len(atom_names) - 1)
    if len(atom_names) != n_atoms:
        raise AmberAssignmentError(f"structure has {len(atom_names)} atoms, mol has {n_atoms}")

    # adjacency from the perceived graph
    nbrs: dict[int, list] = {i: [] for i in range(n_atoms)}
    bond_set = set()
    for b in protein_mol.bonds:
        nbrs[b.src].append(b.dst)
        nbrs[b.dst].append(b.src)
        bond_set.add((min(b.src, b.dst), max(b.src, b.dst)))

    is_h = np.array([el == "H" for el in atom_elems])

    first_by_chain: dict = {}
    last_by_chain: dict = {}
    for ri, res in enumerate(residues):
        if res.chain not in first_by_chain:
            first_by_chain[res.chain] = ri
        last_by_chain[res.chain] = ri

    types = [None] * n_atoms
    charges = np.zeros(n_atoms)
    chosen_templates = []

    for ri, res in enumerate(residues):
        base = res_first[ri]
        na = len(res.atom_names)
        g_idx = list(range(base, base + na))
        heavy_by_name = {atom_names[g]: g for g in g_idx if not is_h[g]}
        # hydrogens by parent heavy atom (graph, like the perceiver)
        h_by_parent: dict = {}
        for g in g_idx:
            if not is_h[g]:
                continue
            parents = [p for p in nbrs[g] if not is_h[p]]
            if len(parents) != 1:
                raise AmberAssignmentError(f"atom {g} ({atom_names[g]}) has {len(parents)} heavy neighbors")
            h_by_parent.setdefault(parents[0], []).append(g)

        is_first = first_by_chain[res.chain] == ri
        is_last = last_by_chain[res.chain] == ri
        # disulfide cysteine: SG has a heavy neighbor outside the residue
        sg = heavy_by_name.get("SG")
        is_cyx = sg is not None and any(atom_res[p] != ri for p in nbrs[sg] if not is_h[p])

        match = None
        tried = []
        cands = _candidate_names(res.name, is_first, is_last)
        if not any(c in ff.residues for c in cands):
            # PDB spelling has no direct template (e.g. NMA -> NME,
            # HSD -> HIS); retry with the canonical residue name
            canon = _RES_ALIASES.get(res.name, res.name)
            cands = _candidate_names(canon, is_first, is_last)
        for cand in cands:
            # require the crosslinked template when a disulfide is present:
            # every candidate for a cysteine residue ends in CYS/CYX/CYM
            # (optionally N-/C-prefixed), so skipping all non-CYX names is
            # exact. (A former lstrip("NC") == "CYS" check stripped ALL
            # leading N/C characters — 'CCYS' -> 'YS' — and never fired.)
            if is_cyx and not cand.endswith("CYX"):
                continue
            tpl = ff.residues.get(cand)
            if tpl is None:
                continue
            tried.append(cand)
            try:
                heavy_names, h_of = _template_structure(tpl, ff)
            except AmberAssignmentError:
                continue
            if heavy_names != set(heavy_by_name):
                continue
            ok = True
            for hname, g in heavy_by_name.items():
                if len(h_of.get(hname, [])) != len(h_by_parent.get(g, [])):
                    ok = False
                    break
            if ok:
                match = tpl
                h_templ = h_of
                break
        if match is None:
            raise AmberAssignmentError(
                f"no template matches {res.name} {res.chain}{res.resseq} "
                f"(tried {tried}; heavies {sorted(heavy_by_name)})"
            )
        chosen_templates.append(match.name)

        name_to_local = {nm: k for k, nm in enumerate(match.atom_names)}
        for hname, g in heavy_by_name.items():
            lk = name_to_local[hname]
            types[g] = match.atom_types[lk]
            charges[g] = match.atom_charges[lk]
            tH = h_templ.get(hname, [])
            gH = h_by_parent.get(g, [])
            # hydrogens sharing a parent must be template-equivalent
            t_types = {match.atom_types[k] for k in tH}
            t_charges = {match.atom_charges[k] for k in tH}
            if len(t_types) > 1 or len(t_charges) > 1:
                raise AmberAssignmentError(
                    f"template {match.name}: hydrogens on {hname} are inequivalent; "
                    "name-independent H matching is unsound here"
                )
            for g_h in gH:
                types[g_h] = match.atom_types[tH[0]]
                charges[g_h] = match.atom_charges[tH[0]]

    missing = [i for i, t in enumerate(types) if t is None]
    if missing:
        raise AmberAssignmentError(f"atoms without types: {missing[:8]}")

    classes = [ff.type_class.get(t, t) for t in types]
    masses = np.array([ff.type_mass.get(t, 0.0) for t in types])
    if not ff.charge_from_residue and any(t in ff.type_charge for t in types):
        # OpenMM semantics: without <UseAttributeFromResidue name="charge"/>,
        # the NonbondedForce per-type charges are authoritative and template
        # charges are ignored. One pragmatic exception: XMLs whose
        # NonbondedForce charges are ALL zero while templates carry real
        # charges (a common hand-written style) keep the template charges —
        # zeroing the whole protein silently would be strictly worse.
        type_q = np.array([ff.type_charge.get(t, 0.0) for t in types])
        if np.any(type_q != 0.0) or np.all(charges == 0.0):
            if np.any(type_q != 0.0) and np.any(charges != 0.0) and not np.allclose(type_q, charges):
                import warnings

                warnings.warn(
                    "Amber XML carries both NonbondedForce per-type charges and "
                    "residue-template charges that disagree; using the per-type "
                    "charges (OpenMM precedence). Add <UseAttributeFromResidue "
                    "name=\"charge\"/> to select template charges.",
                    stacklevel=2,
                )
            charges = type_q
    lj = np.array([ff.type_lj[t] for t in types])

    # ---- bonded terms from the graph + class lookup ------------------------
    bond_idxs, bond_p = [], []
    for i, j in sorted(bond_set):
        key = tuple(sorted((classes[i], classes[j])))
        if key not in ff.bond_params:
            raise AmberAssignmentError(f"no bond params for classes {key} (atoms {i},{j})")
        k, r0 = ff.bond_params[key]
        bond_idxs.append((i, j))
        bond_p.append((k, r0))

    angle_idxs, angle_p = [], []
    for j in range(n_atoms):
        ns = sorted(nbrs[j])
        for a in range(len(ns)):
            for b in range(a + 1, len(ns)):
                i, k = ns[a], ns[b]
                c1, c2, c3 = classes[i], classes[j], classes[k]
                key = (c1, c2, c3) if c1 <= c3 else (c3, c2, c1)
                if key not in ff.angle_params:
                    raise AmberAssignmentError(f"no angle params for {key} (atoms {i},{j},{k})")
                ka, t0 = ff.angle_params[key]
                angle_idxs.append((i, j, k))
                angle_p.append((ka, t0, 0.0))

    def match_proper(ci, cj, ck, cl):
        wild_hit = None
        for cls4, terms in ff.propers:
            exact = cls4 in ((ci, cj, ck, cl), (cl, ck, cj, ci))
            if exact:
                return terms
            if wild_hit is None:
                for order in ((ci, cj, ck, cl), (cl, ck, cj, ci)):
                    if all(c == WILD or c == o for c, o in zip(cls4, order)):
                        wild_hit = terms
                        break
        return wild_hit

    proper_idxs, proper_p = [], []
    seen_torsion = set()
    for j, k in sorted(bond_set):
        for i in nbrs[j]:
            if i == k:
                continue
            for l in nbrs[k]:
                if l == j or l == i:
                    continue
                key = (i, j, k, l) if (i, j, k, l) <= (l, k, j, i) else (l, k, j, i)
                if key in seen_torsion:
                    continue
                seen_torsion.add(key)
                terms = match_proper(classes[i], classes[j], classes[k], classes[l])
                if terms is None:
                    continue  # OpenMM: unmatched torsions get no term
                for kk, phase, per in terms:
                    if kk == 0.0:
                        continue
                    proper_idxs.append(key)
                    proper_p.append((kk, phase, per))

    improper_idxs, improper_p = [], []
    for c in range(n_atoms):
        ns = [x for x in nbrs[c]]
        if len(ns) < 3:
            continue
        # specificity-ranked entry selection (OpenMM: a fully-specified
        # entry beats any wildcard entry regardless of XML order; among
        # equal wildcard counts the first XML entry wins)
        best = None  # (n_wild, xml_order, picked, terms)
        for order, (cls4, terms) in enumerate(ff.impropers):
            c_cen, c2, c3, c4 = cls4
            if c_cen != WILD and c_cen != classes[c]:
                continue
            # assign 3 distinct neighbors to (c2, c3, c4); exact classes
            # first, wildcards take the remaining atoms in index order
            # (OpenMM 'default'/amber ordering approximation)
            pool = sorted(ns)
            picked = []
            ok = True
            for want in (c2, c3, c4):
                if want == WILD:
                    picked.append(None)
                    continue
                cand = [x for x in pool if classes[x] == want and x not in picked]
                if not cand:
                    ok = False
                    break
                picked.append(cand[0])
            if not ok:
                continue
            rest = [x for x in pool if x not in picked]
            for m in range(3):
                if picked[m] is None:
                    picked[m] = rest.pop(0)
            n_wild = sum(1 for w in cls4 if w == WILD)
            if best is None or n_wild < best[0]:
                best = (n_wild, order, tuple(picked), terms)
        if best is not None:
            n1, n2, n3 = best[2]
            for kk, phase, per in best[3]:
                if kk == 0.0:
                    continue
                # OpenMM emits (n1, n2, central, n3): exactly one internal
                # angle — the downstream splitter classifies it improper
                improper_idxs.append((n1, n2, c, n3))
                improper_p.append((kk, phase, per))

    # ---- exclusions (1-2, 1-3 full; 1-4 scaled) ----------------------------
    excl: dict = {}
    for i, j in bond_set:
        excl[(i, j)] = (1.0, 1.0)
    for i, j, k in angle_idxs:
        key = (min(i, k), max(i, k))
        excl[key] = (1.0, 1.0)
    one_four = set()
    for i, j, k, l in seen_torsion:
        key = (min(i, l), max(i, l))
        one_four.add(key)
    for key in one_four:
        if key not in excl:  # 1-4 that is also 1-2/1-3 (rings) stays full
            excl[key] = (1.0 - ff.coulomb14scale, 1.0 - ff.lj14scale)

    keys = sorted(excl)
    exclusion_idxs = np.array(keys, dtype=np.int32).reshape(-1, 2)
    exclusion_scales = np.array([excl[k] for k in keys]).reshape(-1, 2)

    return AmberHostParams(
        charges=charges,
        lj=lj,
        masses=masses,
        bond_idxs=np.array(bond_idxs, dtype=np.int32).reshape(-1, 2),
        bond_params=np.array(bond_p).reshape(-1, 2),
        angle_idxs=np.array(angle_idxs, dtype=np.int32).reshape(-1, 3),
        angle_params=np.array(angle_p).reshape(-1, 3),
        proper_idxs=np.array(proper_idxs, dtype=np.int32).reshape(-1, 4),
        proper_params=np.array(proper_p).reshape(-1, 3),
        improper_idxs=np.array(improper_idxs, dtype=np.int32).reshape(-1, 4),
        improper_params=np.array(improper_p).reshape(-1, 3),
        exclusion_idxs=exclusion_idxs,
        exclusion_scales=exclusion_scales,
        atom_types=types,
    )
