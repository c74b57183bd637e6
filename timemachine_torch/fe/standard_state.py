"""Standard-state corrections for releasing binding restraints (counterpart
of timemachine_tpu/fe/standard_state.py): the radial partition function of
a translational restraint, by quadrature and, for the harmonic one, in
closed form; the SO(3) partition function of an orientational restraint,
reduced to one quadrature over the rotation angle (scipy's quad, as JAX's).
"""

import numpy as np
from scipy.integrate import quad

STANDARD_VOLUME = 1.660  # nm^3 per molecule at 1 M


def integrate_radial_Z(u_fn, beta, r_max):
    """Configurational integral Z = ∫_0^{r_max} 4π r² e^{−β u(r)} dr of a
    radially symmetric restraint."""
    Z, quad_err = quad(lambda r: 4.0 * np.pi * r * r * np.exp(-beta * u_fn(r)), 0.0, r_max)
    assert quad_err < 1e-5
    return Z


def integrate_radial_Z_exact(k, beta):
    """Closed-form Z of the harmonic radial restraint u = k r²: a 3-D
    Gaussian integral, Z = (π / (β k))^{3/2}."""
    return (np.pi / (beta * k)) ** 1.5


def standard_state_correction(Z_infty, beta):
    """ΔG (kJ/mol) of releasing a restrained ligand into the standard molar
    volume."""
    return np.log(Z_infty / STANDARD_VOLUME) / beta


def integrate_rotation_Z(u_fn, beta):
    """Partition function of an orientational restraint over SO(3).

    Parameterizing rotations by unit quaternions (half-angle θ ∈ [0, π/2],
    axis uniform on S²), the Haar measure factorizes as sin²θ sinα dθ dα dφ;
    the axis integrates to 4π analytically, leaving one quadrature over the
    angle."""

    def dz(theta):
        u = u_fn(2.0 * theta)
        assert u > 0
        return np.exp(-beta * u) * np.sin(theta) ** 2

    Z_angle, quad_err = quad(dz, 0.0, np.pi / 2)
    assert quad_err < 1e-5
    return 4.0 * np.pi * Z_angle


def angle_u(theta, k):
    """RMSD-restraint rotation energy k (1 − cos θ)."""
    return k * (1.0 - np.cos(theta))


def release_orientational_restraints(k_t, k_r, beta):
    """(ΔG_translation, ΔG_rotation) in kJ/mol for releasing a harmonic
    translational restraint (k_t r²) plus an RMSD orientational restraint
    (k_r (1 − cos θ)) into the standard state.
    Only valid for exactly this restraint pair."""
    Z_t = integrate_radial_Z_exact(k_t, beta)
    # the closed form checked against quadrature
    np.testing.assert_almost_equal(Z_t, integrate_radial_Z(lambda r: k_t * r * r, beta, r_max=np.inf))
    dG_translation = standard_state_correction(Z_t, beta)

    Z_r = integrate_rotation_Z(lambda th: angle_u(th, k_r), beta)
    dG_rotation = np.log(Z_r) / beta
    return dG_translation, dG_rotation
