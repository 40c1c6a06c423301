"""RealImpact dataset loader (https://github.com/samuel-clarke/RealImpact).

One object's directory holds (reference: src/audio/RealImpact.cpp:12-23):
  angle.npy, distance.npy, micID.npy, listenerXYZ.npy, vertexXYZ.npy, vertexID.npy,
  deconvolved_0db.npy (2.3 GB — loaded lazily via memory map), transformed.obj, material_*.

Layout: 15 mics x 4 distances x 10 angles = 600 unique listener points; 5 impact vertices
per object; recordings are ~4.37 s at 48 kHz. Recording order varies first by mic, then
distance, then angle (reference: src/audio/RealImpact.h:9-23).

Meshes are Z-up; `Z_UP_TO_Y_UP` rotates into the framework's Y-up frame (flipped 180 deg so
the object faces forward).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

NUM_LISTENER_POINTS = 600
NUM_IMPACT_VERTICES = 5
NUM_MICS = 15
SAMPLE_RATE = 48_000

# Material for each object name; names marked * in the reference are guesses from the
# object name + material image (src/audio/RealImpact.cpp:27-90).
MATERIAL_FOR_OBJECT = {
    "CeramicKoiBowl": "Ceramic", "CeramicBowlFish": "Ceramic", "Bowl": "Ceramic",
    "BowlCeramic": "Ceramic", "bowl": "Ceramic", "IronSkillet": "Iron", "Pan": "Iron",
    "Cup": "Glass", "PurpleScoop": "Plastic", "WoodPlate": "Wood",
    "WoodPlateSquare": "Wood", "WoodSlab": "Wood", "WoodChalice": "Wood",
    "WoodWineGlass": "Wood", "WoodMug": "Wood", "MeasuringCup": "Polycarbonate",
    "SmallMeasuringCup": "Polycarbonate", "PiePan": "Steel", "IronMortar": "Iron",
    "PlasticBowl": "Plastic", "ShellPlate": "Glass", "stand": "Steel",
    "SkullCup": "Glass", "PlanterCeramic": "Ceramic", "Pot_Hexagonal": "Ceramic",
    "SmallPlanterCeramic": "Ceramic", "CeramicMug": "Ceramic",
    "PitcherCeramic": "Ceramic", "IronPlate": "Iron", "WoodBoard": "Wood",
    "PlasticBin": "Plastic", "FlowerPotLargeCeramic": "Ceramic",
    "FlowerpotSmallCeramic": "Ceramic", "CeramicCup": "Ceramic",
    "LargeSwanCeramic": "Ceramic", "SmallSwanCeramic": "Ceramic", "WoodPad": "Wood",
    "WoodVase": "Wood", "MetalHoledSpoon": "Steel", "MetalSpatula": "Steel",
    "MetalLadle": "Steel", "MetalSpoon": "Steel", "GreenGoblet": "Glass",
    "GlassGoblet": "Glass", "PlasticScoop": "Plastic", "Frisbee": "Plastic",
}

_REQUIRED = ("angle.npy", "distance.npy", "micID.npy", "listenerXYZ.npy", "vertexXYZ.npy")


def _preprocessed(directory: Path) -> Path:
    d = Path(directory)
    return d / "preprocessed" if (d / "preprocessed").is_dir() else d


@dataclass
class ListenerPoint:
    index: int
    mic_id: int
    distance_mm: int
    angle_deg: int
    position: np.ndarray  # Y-up meters


def z_up_to_y_up(points_z_up: np.ndarray) -> np.ndarray:
    """RealImpact is Z-up; rotate to Y-up and flip 180 deg to face forward:
    (x, y, z) -> (x, z, y) followed by 180 deg about y -> (-x, z, y)."""
    p = np.asarray(points_z_up, dtype=np.float64).reshape(-1, 3)
    return np.stack([-p[:, 0], p[:, 2], p[:, 1]], axis=1)


def validate_directory(directory) -> str | None:
    """Returns the object name if `directory` is a RealImpact object dir, else None."""
    d = _preprocessed(directory)
    if not all((d / f).exists() for f in _REQUIRED):
        return None
    name = Path(directory).name
    # Directories are named like "9_BowlCeramic".
    parts = name.split("_", 1)
    return parts[1] if len(parts) == 2 and parts[0].isdigit() else name


def material_for(object_name: str) -> str | None:
    return MATERIAL_FOR_OBJECT.get(object_name)


def load_listener_points(directory) -> list[ListenerPoint]:
    """The 600 unique listener positions, in recording order (mic, distance, angle)."""
    d = _preprocessed(directory)
    angle = np.load(d / "angle.npy")[:NUM_LISTENER_POINTS]
    distance = np.load(d / "distance.npy")[:NUM_LISTENER_POINTS]
    mic = np.load(d / "micID.npy")[:NUM_LISTENER_POINTS]
    xyz = np.load(d / "listenerXYZ.npy")[:NUM_LISTENER_POINTS]
    pos = z_up_to_y_up(xyz) / 1000.0  # mm -> m
    return [
        ListenerPoint(int(i), int(mic[i]), int(distance[i]), int(angle[i]), pos[i])
        for i in range(min(NUM_LISTENER_POINTS, len(angle)))
    ]


def load_impact_positions(directory) -> np.ndarray:
    """Positions of the 5 impact vertices, rotated Y-up but in the OBJ's native units —
    the reference matches them against the unscaled transformed.obj by nearest vertex
    (LoadPositions, RealImpact.cpp:134-144 + Io.cpp's FindNearestVertex; only listener
    points get the mm->m conversion)."""
    d = _preprocessed(directory)
    xyz = np.load(d / "vertexXYZ.npy")
    # One entry per (listener, impact); unique impact positions repeat every 600 rows.
    stride = NUM_LISTENER_POINTS if xyz.shape[0] >= NUM_LISTENER_POINTS * NUM_IMPACT_VERTICES else 1
    picks = xyz[::stride][:NUM_IMPACT_VERTICES]
    return z_up_to_y_up(picks)


def load_samples(directory, listener_point_index: int) -> np.ndarray:
    """Deconvolved recordings at one listener point: (5 impacts, frames) float32 at 48 kHz.
    Memory-mapped, so only the requested rows are read off disk."""
    d = _preprocessed(directory)
    mm = np.load(d / "deconvolved_0db.npy", mmap_mode="r")
    rows = [listener_point_index + NUM_LISTENER_POINTS * i for i in range(NUM_IMPACT_VERTICES)]
    return np.asarray(mm[rows], dtype=np.float32)


@dataclass
class RealImpactScan:
    object_name: str
    material_name: str | None
    positions: np.ndarray  # (n, 3) mesh vertices, Y-up, OBJ-native units
    triangles: np.ndarray  # (m, 3)
    impact_positions: np.ndarray  # (5, 3) same frame/units as `positions`
    listener_points: list[ListenerPoint]
    directory: Path


def load_realimpact_scan(directory) -> RealImpactScan:
    """Load an object's mesh + geometry metadata (not the 2.3 GB audio)."""
    from ..mesh.obj_io import load_obj

    name = validate_directory(directory)
    if name is None:
        raise FileNotFoundError(f"{directory} is not a RealImpact object directory")
    d = _preprocessed(directory)
    positions, tris = load_obj(d / "transformed.obj")
    return RealImpactScan(
        object_name=name,
        material_name=material_for(name),
        positions=z_up_to_y_up(positions),
        triangles=tris,
        impact_positions=load_impact_positions(directory),
        listener_points=load_listener_points(directory),
        directory=Path(directory),
    )
