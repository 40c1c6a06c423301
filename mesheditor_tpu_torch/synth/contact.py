"""Hertz contact constants and the virtual-mallet strike model (Johnson 1985).

Closed forms mirror the reference (src/audio/ContactModel.{h,cpp}): effective compliance,
combined curvature, contact stiffness k = (4/3) E* sqrt(R*), patch radius, static
penetration delta0 = (N/k)^(2/3), reduced contact mass with rotational leverage, and the
Hertz contact time tau = 2.87 ((m* / E*)^2 kappa / v)^(1/5) clamped to [2e-5, 5e-2] s.
Pure numpy; these are host-side per-strike derivations feeding the device event stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..materials import STEEL
from ..types import AcousticMaterial, AcousticMaterialProperties, MassProperties

# Bounds on the derived contact time (seconds), guarding degenerate curvature/speed/scale.
MIN_CONTACT_TIME = 2e-5
MAX_CONTACT_TIME = 5e-2
# Approach speed a physics material's restitution is taken to be quoted at (m/s): restitution
# varies with approach speed while the Hunt-Crossley dissipation constant stays fixed.
RESTITUTION_REFERENCE_SPEED = 1.0


@dataclass
class ContactDynamics:
    """Per-object contact dynamics at the baked size, SI (reference: ContactModel.h:27-31).
    `contact_arm` is per excitable vertex: contact point minus center of mass, meters."""

    mass: float = 0.0
    inverse_inertia: np.ndarray = field(default_factory=lambda: np.eye(3))  # kg^-1 m^-2
    contact_arm: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))


@dataclass(frozen=True)
class Striker:
    """The virtual mallet: a capsule of some material striking on its cap. A harder material
    or a lighter capsule brightens the strike; the tip radius sets the contact curvature."""

    material: AcousticMaterial = STEEL
    tip_radius: float = 0.01  # cap radius, also the cylinder cross-section, m
    length: float = 0.19  # cylinder length, m (~0.5 kg of steel at the default radius)


@dataclass(frozen=True)
class Impactor:
    """One side of a Hertz contact reduced to compliance, tip curvature, and inverse mass.
    inv_mass = 0 models an immovable impactor."""

    material: AcousticMaterialProperties
    curvature: float = 0.0  # contribution to the combined curvature 1/R*, 1/m
    inv_mass: float = 0.0  # kg^-1


def striker_mass(s: Striker) -> float:
    """Capsule volume (cylinder + spherical caps) times material density, kg."""
    r, l = s.tip_radius, s.length
    return s.material.properties.density * np.pi * (r * r * l + 4.0 / 3.0 * r**3)


def striker_impactor(s: Striker) -> Impactor:
    return Impactor(
        material=s.material.properties,
        curvature=1.0 / s.tip_radius,
        inv_mass=1.0 / striker_mass(s),
    )


def inverse_inertia_tensor(mp: MassProperties) -> np.ndarray:
    """Inverse inertia (kg^-1 m^-2) from principal moments + orientation quaternion (wxyz)."""
    w, x, y, z = mp.inertia_orientation
    r = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    inv = np.where(mp.inertia_diagonal > 0, 1.0 / np.where(mp.inertia_diagonal == 0, 1.0, mp.inertia_diagonal), 0.0)
    return r @ np.diag(inv) @ r.T


def reduced_contact_mass(
    d: ContactDynamics, excitable_index: int, impact_direction: np.ndarray, impactor: Impactor
) -> float:
    """Reduced mass (kg) at the contact: the object's translational and rotational response
    to an off-center impulse, combined with the impactor. A light impactor dominates, so the
    reduced mass stays small even against a heavy object."""
    if excitable_index >= d.contact_arm.shape[0] or d.mass <= 0:
        return 0.0
    n = np.asarray(impact_direction, dtype=np.float64)
    n = n / np.linalg.norm(n)
    arm_cross_n = np.cross(d.contact_arm[excitable_index], n)
    inv_eff = 1.0 / d.mass + arm_cross_n @ d.inverse_inertia @ arm_cross_n + impactor.inv_mass
    return 1.0 / inv_eff


def inv_effective_modulus(a: AcousticMaterialProperties, b: AcousticMaterialProperties) -> float:
    """1/E* = (1 - nu1^2)/E1 + (1 - nu2^2)/E2, Pa^-1."""
    return (1 - a.poisson_ratio**2) / a.young_modulus + (1 - b.poisson_ratio**2) / b.young_modulus


def combined_curvature(curvature_a: float, curvature_b: float) -> float:
    """1/R* = k1 + k2, held positive so a flat or concave surface reads as flat at R* = 1e6 m."""
    return max(curvature_a + curvature_b, 1e-6)


def contact_stiffness(inv_eff_modulus: float, comb_curvature: float) -> float:
    """k = (4/3) E* sqrt(R*), N/m^(3/2). Load-penetration: N = k delta^(3/2)."""
    return 4.0 / 3.0 / inv_eff_modulus / np.sqrt(comb_curvature)


def contact_patch_radius(normal_force: float, inv_eff_modulus: float, comb_curvature: float) -> float:
    """a = (3 N R* / (4 E*))^(1/3), m — sets the contact filter's scale."""
    return np.cbrt(0.75 * max(normal_force, 0.0) * inv_eff_modulus / comb_curvature)


def static_penetration(normal_force: float, stiffness: float) -> float:
    """Equilibrium penetration under load N: delta0 = (N/k)^(2/3), m."""
    return (max(normal_force, 0.0) / stiffness) ** (2.0 / 3.0) if stiffness > 0 else 0.0


def estimate_contact_time(
    d: ContactDynamics,
    excitable_index: int,
    impact_direction: np.ndarray,
    contact_speed: float,
    object_material: AcousticMaterialProperties,
    object_curvature: float,
    impactor: Impactor,
    scale_ratio: float = 1.0,
) -> float:
    """Hertz contact time (s): tau = 2.87 ((m* / E*)^2 kappa / v)^(1/5), clamped."""
    if excitable_index >= d.contact_arm.shape[0] or d.mass <= 0:
        return MIN_CONTACT_TIME
    m_eff = reduced_contact_mass(d, excitable_index, impact_direction, impactor)
    inv_e = inv_effective_modulus(object_material, impactor.material)
    kappa = combined_curvature(object_curvature, impactor.curvature)
    speed = max(abs(contact_speed), 1e-6)
    tau = 2.87 * ((m_eff * inv_e) ** 2 * (kappa / speed)) ** 0.2
    return float(np.clip(tau * scale_ratio, MIN_CONTACT_TIME, MAX_CONTACT_TIME))
