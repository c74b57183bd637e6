"""Element data: symbols, atomic numbers, standard atomic masses, default

The port's copy of timemachine_tpu/chem/periodic.py.
valences (for implicit-H filling when building from SMILES)."""

SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba",
]

ATOMIC_NUM = {s: i for i, s in enumerate(SYMBOLS)}

# standard atomic weights (amu); indexed by atomic number
MASSES = {
    1: 1.00794, 2: 4.002602, 3: 6.941, 4: 9.012182, 5: 10.811,
    6: 12.0107, 7: 14.0067, 8: 15.9994, 9: 18.9984032, 10: 20.1797,
    11: 22.98977, 12: 24.305, 13: 26.981538, 14: 28.0855, 15: 30.973761,
    16: 32.065, 17: 35.453, 18: 39.948, 19: 39.0983, 20: 40.078,
    25: 54.938045, 26: 55.845, 27: 58.933195, 28: 58.6934, 29: 63.546,
    30: 65.38, 34: 78.96, 35: 79.904, 53: 126.90447, 55: 132.9054519,
    37: 85.4678,
}

# default valences used for implicit hydrogen counting (organic subset)
DEFAULT_VALENCES = {
    1: (1,),
    5: (3,),
    6: (4,),
    7: (3,),
    8: (2,),
    9: (1,),
    14: (4,),
    15: (3, 5),
    16: (2, 4, 6),
    17: (1,),
    35: (1,),
    53: (1,),
}


def mass_of(z: int) -> float:
    return MASSES[z]


def symbol_of(z: int) -> str:
    return SYMBOLS[z]
