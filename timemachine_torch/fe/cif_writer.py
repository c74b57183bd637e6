"""mmCIF trajectory writer (counterpart of timemachine_tpu/fe/cif_writer.py):
one mmCIF model per frame, coordinates in angstroms, over a mix of the
port's HostTopology (md/builders.py: waters and protein residues) and
chem.Mol ligands, each ligand a LIG residue in its own chain. No OpenMM.
"""

from __future__ import annotations

import numpy as np

from timemachine_torch.chem.periodic import symbol_of

_ELEMENT_CACHE: dict = {}


def convert_single_topology_mols(coords: np.ndarray, atom_map) -> np.ndarray:
    """Split a single-topology alchemical frame into both complete ligands
   ."""
    xa = np.zeros((atom_map.mol_a.num_atoms, 3))
    xb = np.zeros((atom_map.mol_b.num_atoms, 3))
    for a_idx, c_idx in enumerate(atom_map.a_to_c):
        xa[a_idx] = coords[c_idx]
    for b_idx, c_idx in enumerate(atom_map.b_to_c):
        xb[b_idx] = coords[c_idx]
    return np.concatenate((xa, xb), axis=0)


class BondTypeError(Exception):
    pass


class _AtomRecord:
    __slots__ = ("group", "symbol", "name", "comp", "asym", "seq")

    def __init__(self, group, symbol, name, comp, asym, seq):
        self.group = group
        self.symbol = symbol
        self.name = name
        self.comp = comp
        self.asym = asym
        self.seq = seq


_CHAIN_IDS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"


class CIFWriter:
    """Write frames in mmCIF; molecules ordered by their order in objs
   .

    objs may be native `HostTopology` instances (waters/protein residues) or
    `chem.Mol` ligands (each becomes a LIG residue in its own chain)."""

    def __init__(self, objs, out_filepath):
        assert len(objs) > 0
        self._atoms: list[_AtomRecord] = []
        chain_counter = 0
        seq_counter = 0

        for obj in objs:
            if hasattr(obj, "residues"):  # HostTopology
                asym = _CHAIN_IDS[chain_counter % len(_CHAIN_IDS)]
                chain_counter += 1
                for res in obj.residues:
                    seq_counter += 1
                    group = "HETATM" if res.name in ("HOH", "LIG", "UNK") else "ATOM"
                    counts: dict = {}
                    for z in res.atomic_nums:
                        sym = symbol_of(z)
                        counts[sym] = counts.get(sym, 0) + 1
                        self._atoms.append(
                            _AtomRecord(group, sym, f"{sym}{counts[sym]}", res.name, asym, seq_counter)
                        )
            elif hasattr(obj, "atoms"):  # chem.Mol
                asym = _CHAIN_IDS[chain_counter % len(_CHAIN_IDS)]
                chain_counter += 1
                seq_counter += 1
                for i, atom in enumerate(obj.atoms):
                    sym = symbol_of(atom.atomic_num)
                    self._atoms.append(_AtomRecord("HETATM", sym, f"{sym}{i}", "LIG", asym, seq_counter))
            else:
                raise ValueError(f"Unknown obj type: {type(obj)}")

        self.n_atoms = len(self._atoms)
        self.out_handle = open(out_filepath, "w")
        self.frame_idx = 0
        self._write_header()

    def _write_header(self):
        self.out_handle.write("data_timemachine_tpu\n")  # JAX's block name: the files are identical
        self.out_handle.write("#\n")
        self.out_handle.write(
            "loop_\n"
            "_atom_site.group_PDB\n"
            "_atom_site.id\n"
            "_atom_site.type_symbol\n"
            "_atom_site.label_atom_id\n"
            "_atom_site.label_alt_id\n"
            "_atom_site.label_comp_id\n"
            "_atom_site.label_asym_id\n"
            "_atom_site.label_entity_id\n"
            "_atom_site.label_seq_id\n"
            "_atom_site.pdbx_PDB_ins_code\n"
            "_atom_site.Cartn_x\n"
            "_atom_site.Cartn_y\n"
            "_atom_site.Cartn_z\n"
            "_atom_site.occupancy\n"
            "_atom_site.B_iso_or_equiv\n"
            "_atom_site.pdbx_PDB_model_num\n"
        )

    def write_frame(self, x):
        """x: (N, 3) coordinates in angstroms."""
        x = np.asarray(x)
        assert x.shape == (self.n_atoms, 3), f"expected ({self.n_atoms}, 3), got {x.shape}"
        self.frame_idx += 1
        lines = []
        for i, (rec, xyz) in enumerate(zip(self._atoms, x)):
            lines.append(
                f"{rec.group} {i + 1} {rec.symbol} {rec.name} . {rec.comp} {rec.asym} 1 {rec.seq} ? "
                f"{xyz[0]:.3f} {xyz[1]:.3f} {xyz[2]:.3f} 1.00 0.00 {self.frame_idx}\n"
            )
        self.out_handle.writelines(lines)

    def close(self):
        self.out_handle.write("#")
        self.out_handle.flush()
        self.out_handle.close()

    def __enter__(self):
        return self

    def __exit__(self, type, value, tb):
        self.close()
