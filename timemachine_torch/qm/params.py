"""AM1 semi-empirical parameters (Dewar, Zoebisch, Healy, Stewart, JACS 1985

The port's copy of timemachine_tpu/qm/params.py (numpy and scipy).
and subsequent element papers; values as distributed in the public-domain
MOPAC7 block data). These are published physical constants, not code.

Reference analog: the reference computes AM1-family charges by calling the
proprietary OpenEye QM backend (`timemachine/ff/handlers/nonbonded.py:343-520`,
`oe_assign_charges`); this package implements the AM1 model itself so base
charges can be produced natively (no licensed QM backend, no network).

Units: U, beta, g, h in eV; zeta in bohr^-1; alpha in 1/Angstrom; Gaussian
K in eV-scale (enters as Z_A Z_B e^2/R * K), L in 1/A^2, M in Angstrom.
"""

from dataclasses import dataclass, field
from typing import Tuple

EV_PER_HARTREE = 27.211386
BOHR_PER_ANGSTROM = 1.0 / 0.52917721
E2 = 14.399645  # e^2/(4 pi eps0) in eV * Angstrom
KCAL_PER_EV = 23.060548


@dataclass(frozen=True)
class AM1Element:
    z: int
    n: int  # principal quantum number of the valence shell
    zval: int  # core charge (number of valence electrons of neutral atom)
    uss: float
    upp: float  # 0.0 for H (no p shell)
    beta_s: float
    beta_p: float
    zeta_s: float
    zeta_p: float
    alpha: float
    gss: float
    gsp: float
    gpp: float
    gp2: float
    hsp: float
    eheat: float  # experimental atomic heat of formation, kcal/mol
    gauss_k: Tuple[float, ...] = field(default=())
    gauss_l: Tuple[float, ...] = field(default=())
    gauss_m: Tuple[float, ...] = field(default=())

    @property
    def norb(self) -> int:
        return 1 if self.z == 1 else 4


AM1_ELEMENTS = {
    1: AM1Element(
        z=1, n=1, zval=1,
        uss=-11.396427, upp=0.0,
        beta_s=-6.173787, beta_p=0.0,
        zeta_s=1.188078, zeta_p=0.0,
        alpha=2.882324,
        gss=12.848, gsp=0.0, gpp=0.0, gp2=0.0, hsp=0.0,
        eheat=52.102,
        gauss_k=(0.122796, 0.005090, -0.018336),
        gauss_l=(5.0, 5.0, 2.0),
        gauss_m=(1.2, 1.8, 2.1),
    ),
    6: AM1Element(
        z=6, n=2, zval=4,
        uss=-52.028658, upp=-39.614239,
        beta_s=-15.715783, beta_p=-7.719283,
        zeta_s=1.808665, zeta_p=1.685116,
        alpha=2.648274,
        gss=12.23, gsp=11.47, gpp=11.08, gp2=9.84, hsp=2.43,
        eheat=170.89,
        gauss_k=(0.011355, 0.045924, -0.020061, -0.001260),
        gauss_l=(5.0, 5.0, 5.0, 5.0),
        gauss_m=(1.6, 1.85, 2.05, 2.65),
    ),
    7: AM1Element(
        z=7, n=2, zval=5,
        uss=-71.86, upp=-57.167581,
        beta_s=-20.299110, beta_p=-18.238666,
        zeta_s=2.315410, zeta_p=2.157940,
        alpha=2.947286,
        gss=13.59, gsp=12.66, gpp=12.98, gp2=11.59, hsp=3.14,
        eheat=113.0,
        gauss_k=(0.025251, 0.028953, -0.005806),
        gauss_l=(5.0, 5.0, 2.0),
        gauss_m=(1.5, 2.1, 2.4),
    ),
    8: AM1Element(
        z=8, n=2, zval=6,
        uss=-97.83, upp=-78.26238,
        beta_s=-29.272773, beta_p=-29.272773,
        zeta_s=3.108032, zeta_p=2.524039,
        alpha=4.455371,
        gss=15.42, gsp=14.48, gpp=14.52, gp2=12.98, hsp=3.94,
        eheat=59.559,
        gauss_k=(0.280962, 0.081430),
        gauss_l=(5.0, 7.0),
        gauss_m=(0.847918, 1.445071),
    ),
    9: AM1Element(
        z=9, n=2, zval=7,
        uss=-136.105579, upp=-104.889885,
        beta_s=-69.590277, beta_p=-27.922360,
        zeta_s=3.770082, zeta_p=2.494670,
        alpha=5.5178,
        gss=16.92, gsp=17.25, gpp=16.71, gp2=14.91, hsp=4.83,
        eheat=18.89,
        gauss_k=(0.242079, 0.003607),
        gauss_l=(4.8, 4.6),
        gauss_m=(0.93, 1.66),
    ),
    15: AM1Element(
        z=15, n=3, zval=5,
        uss=-42.029863, upp=-34.030709,
        beta_s=-6.3537764, beta_p=-6.5907593,
        zeta_s=1.98128, zeta_p=1.87515,
        alpha=2.4553322,
        gss=11.560005, gsp=5.237449, gpp=7.877589, gp2=7.307648, hsp=0.779238,
        eheat=75.57,
        gauss_k=(-0.031827, 0.018470, 0.033290),
        gauss_l=(6.0, 7.0, 9.0),
        gauss_m=(1.474323, 1.779354, 3.006576),
    ),
    16: AM1Element(
        z=16, n=3, zval=6,
        uss=-56.694056, upp=-48.717049,
        beta_s=-3.920566, beta_p=-7.905278,
        zeta_s=2.366515, zeta_p=1.667263,
        alpha=2.461648,
        gss=11.786329, gsp=8.663127, gpp=10.039308, gp2=7.781688, hsp=2.532137,
        eheat=66.40,
        gauss_k=(-0.509195, -0.011863, 0.012334),
        gauss_l=(4.593691, 5.865731, 13.557336),
        gauss_m=(0.770665, 1.503313, 2.009173),
    ),
    17: AM1Element(
        z=17, n=3, zval=7,
        uss=-111.613949, upp=-76.640107,
        beta_s=-24.594670, beta_p=-14.637216,
        zeta_s=3.631376, zeta_p=2.076799,
        alpha=2.919368,
        gss=15.03, gsp=13.16, gpp=11.30, gp2=9.97, hsp=2.42,
        eheat=28.99,
        gauss_k=(0.094243, 0.027168),
        gauss_l=(4.0, 4.0),
        gauss_m=(1.3, 2.1),
    ),
    35: AM1Element(
        z=35, n=4, zval=7,
        uss=-104.656063, upp=-74.930052,
        beta_s=-19.399880, beta_p=-8.957195,
        zeta_s=3.064133, zeta_p=2.038333,
        alpha=2.576546,
        gss=15.03643948, gsp=13.03468242, gpp=11.27632539, gp2=9.85442552, hsp=2.45586832,
        eheat=26.74,
        gauss_k=(0.066685, 0.025568),
        gauss_l=(4.0, 4.0),
        gauss_m=(1.5, 2.3),
    ),
    53: AM1Element(
        z=53, n=5, zval=7,
        uss=-103.589663, upp=-74.429997,
        beta_s=-8.443327, beta_p=-6.323405,
        zeta_s=2.102858, zeta_p=2.161153,
        alpha=2.299424,
        gss=15.04044855, gsp=13.05017103, gpp=11.14778369, gp2=9.91409071, hsp=2.45638202,
        eheat=25.517,
        gauss_k=(0.004361, 0.015706),
        gauss_l=(2.3, 3.0),
        gauss_m=(1.8, 2.24),
    ),
}

SUPPORTED_ELEMENTS = frozenset(AM1_ELEMENTS)
