"""Physical constants (same values as timemachine_tpu/constants.py)."""

BOLTZMANN = 1.380658e-23  # J/K
AVOGADRO = 6.0221367e23  # 1/mol
RGAS = BOLTZMANN * AVOGADRO  # J/(mol K)
BOLTZ = RGAS / 1000.0  # kJ/(mol K)
KCAL_TO_KJ = 4.184
