"""Acoustic material presets.

The seven Kleinpat/RealImpact materials (Table 4 of the Kleinpat paper, mirrored by the
reference at src/audio/AcousticMaterial.h:30-41). Columns: density rho (kg/m^3), Young's
modulus E (Pa), Poisson ratio nu, Rayleigh damping alpha (1/s) and beta (s).
"""

from .types import AcousticMaterial, AcousticMaterialProperties

CERAMIC = AcousticMaterial("Ceramic", AcousticMaterialProperties(2700, 7.2e10, 0.19, 6, 1e-7))
GLASS = AcousticMaterial("Glass", AcousticMaterialProperties(2600, 6.2e10, 0.20, 1, 1e-7))
WOOD = AcousticMaterial("Wood", AcousticMaterialProperties(750, 1.1e10, 0.25, 60, 2e-6))
PLASTIC = AcousticMaterial("Plastic", AcousticMaterialProperties(1070, 1.4e9, 0.35, 30, 1e-6))
IRON = AcousticMaterial("Iron", AcousticMaterialProperties(8000, 2.1e11, 0.28, 5, 1e-7))
POLYCARBONATE = AcousticMaterial(
    "Polycarbonate", AcousticMaterialProperties(1190, 2.4e9, 0.37, 0.5, 4e-7)
)
STEEL = AcousticMaterial("Steel", AcousticMaterialProperties(7850, 2.0e11, 0.29, 5, 3e-8))

ACOUSTIC_MATERIALS = (CERAMIC, GLASS, WOOD, PLASTIC, IRON, POLYCARBONATE, STEEL)


def find_material(name: str) -> AcousticMaterial | None:
    """The preset with this name, or None (reference: AcousticMaterial.h:44-49)."""
    for m in ACOUSTIC_MATERIALS:
        if m.name == name:
            return m
    return None
