"""Physical constants and framework defaults (same values as
timemachine_tpu/constants.py, plus the seed range and MD defaults that
timemachine_tpu/fe/rbfe.py defines)."""

from enum import IntEnum
from typing import Any

BOLTZMANN = 1.380658e-23  # J/K
AVOGADRO = 6.0221367e23  # 1/mol
RGAS = BOLTZMANN * AVOGADRO  # J/(mol K)
BOLTZ = RGAS / 1000.0  # kJ/(mol K)
ONE_4PI_EPS0 = 138.935456  # Coulomb constant, kJ nm / (mol e^2)
KCAL_TO_KJ = 4.184

# default thermodynamic ensemble
DEFAULT_TEMP = 300.0  # K
DEFAULT_PRESSURE = 1.013  # bar

# default force fields
DEFAULT_FF = "smirnoff_2_0_0_ccc"
DEFAULT_PROTEIN_FF = "amber99sbildn"
DEFAULT_WATER_FF = "tip3p"

# nonbonded model defaults (reaction-field erfc electrostatics)
DEFAULT_NB_BETA = 2.0  # 1/nm
DEFAULT_NB_CUTOFF = 1.2  # nm

DEFAULT_CHIRAL_ATOM_RESTRAINT_K = 1000.0
DEFAULT_CHIRAL_BOND_RESTRAINT_K = 999.9
DEFAULT_BOND_IS_PRESENT_K = 50.0
DEFAULT_POSITIONAL_RESTRAINT_K = 4000.0

# RBFE window defaults (timemachine_tpu/fe/rbfe.py): seeds are folded into
# [0, MAX_SEED_VALUE), Langevin at MD_DT ps and MD_FRICTION 1/ps, a barostat
# move every BAROSTAT_INTERVAL steps
MAX_SEED_VALUE = 10000
MD_DT = 2.5e-3
MD_FRICTION = 1.0
BAROSTAT_INTERVAL = 25

# atom mapping defaults
DEFAULT_ATOM_MAPPING_KWARGS: dict[str, Any] = {
    "ring_cutoff": 0.12,
    "chain_cutoff": 0.2,
    "max_visits": 1_000_000,
    "max_connected_components": 1,
    "min_connected_component_size": 1,
    "max_cores": 100_000,
    "enforce_core_core": True,
    "ring_matches_ring_only": False,
    "enforce_chiral": True,
    "disallow_planar_torsion_flips": True,
    "min_threshold": 0,
    "initial_mapping": None,
}


class NBParamIdx(IntEnum):
    """Column layout of per-atom nonbonded parameters."""

    Q_IDX = 0  # charge, pre-scaled by sqrt(ONE_4PI_EPS0)
    LJ_SIG_IDX = 1  # LJ sigma / 2
    LJ_EPS_IDX = 2  # sqrt(LJ epsilon)
    W_IDX = 3  # 4th-dimension (alchemical lifting) coordinate
