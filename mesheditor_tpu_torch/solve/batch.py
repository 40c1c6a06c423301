"""Corpus-scale batch solving: many objects -> modal dataset (counterpart of
mesheditor_tpu/solve/batch.py).

The reference pads meshes up to BUCKET boundaries because its jitted stages recompile per
(n_elements, n_dofs, panel) shape. Eager PyTorch has no such cache: a new shape costs
nothing, so here the buckets buy no compile reuse. They are kept for the reference's
semantics (same grouping, same order of results, the same padded pencils, so the two
packages' corpora can be compared item by item) and because equal shapes within a bucket
let the CUDA caching allocator hand the previous item's blocks to the next. Padding
elements are zero-volume tets on a far-away dummy point, dropped by the degenerate filter
before assembly; padding dofs get unit diagonal mass/stiffness far above the audible band,
so they never enter the wanted window, but they do widen every device vector of the solve.

Results stream into the content-addressed model store (write-once — the reference's
.modal-file discipline). The store's file names hash what a solve PRODUCED, which a rerun
only knows after solving again, so `batch_solve` also keeps `corpus_index.json` beside the
models: one row per item under a hash of what the solve was ASKED (the store's input hash
of mesh, excitation and scale, then each material and solver field by name and value). A
rerun answers an item from its row when the model file is still there and solves only the
rest. That is for the corpus builder: a dataset of thousands of objects takes hours of
solves, and a run that was cut continues where it stopped instead of starting over.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .._device import resolve_device
from ..io.model_store import save_modal_model
from ..types import AcousticMaterialProperties, SolverConfig, TetMesh
from .mesh2modes import ModalResult, mesh2modes
from .orchestration import hash_solve_inputs

INDEX_NAME = "corpus_index.json"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_tetmesh(mesh: TetMesh, n_points: int, n_tets: int) -> TetMesh:
    """Pad a tet mesh to bucket sizes with degenerate (zero-volume) tets on a far-away
    dummy point — FilterDegenerate drops them before assembly, so padded solves produce
    the modes of unpadded ones at one shape per bucket."""
    pts = np.asarray(mesh.points, np.float64)
    tets = np.asarray(mesh.tets, np.uint32)
    if pts.shape[0] > n_points or tets.shape[0] > n_tets:
        raise ValueError("mesh exceeds bucket")
    extent = float(np.abs(pts).max()) + 1.0
    pad_pts = np.full((n_points - pts.shape[0], 3), extent * 10.0)
    dummy = pts.shape[0]  # first padding point
    pad_tets = np.full((n_tets - tets.shape[0], 4), dummy, np.uint32)
    return TetMesh(points=np.concatenate([pts, pad_pts]), tets=np.concatenate([tets, pad_tets]))


@dataclass
class CorpusItem:
    name: str
    mesh: TetMesh
    material: AcousticMaterialProperties
    excite_positions: np.ndarray
    baked_scale: tuple = (1.0, 1.0, 1.0)


@dataclass
class CorpusResult:
    name: str
    path: Optional[Path]
    num_modes: int
    f1_hz: float
    solve_seconds: float
    iterations: int


def _request_key(item: CorpusItem, config: SolverConfig) -> str:
    """Hash of what a solve is asked: the store's input hash of the mesh, the excitation
    points and the scale, then every material and solver field by name and value."""
    h = hashlib.sha256()
    h.update(hash_solve_inputs(item.mesh.points, item.mesh.tets, item.excite_positions,
                               item.baked_scale).encode())
    asked = {"material": asdict(item.material), "config": asdict(config)}
    h.update(json.dumps(asked, sort_keys=True).encode())
    return h.hexdigest()[:32]


def _write_index(path: Path, index: dict) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(index, indent=1, sort_keys=True))
    os.replace(tmp, path)


def batch_solve(
    items: Sequence[CorpusItem],
    out_dir,
    config: SolverConfig = SolverConfig(),
    point_bucket: int = 2048,
    tet_bucket: int = 4096,
    progress=None,
    device="cuda",
) -> list[CorpusResult]:
    """Solve a corpus on `device` into the content-addressed store. Buckets pad (points,
    tets) to shared shapes; results come bucket by bucket, smallest bucket first, in the
    order given within a bucket. An item whose request is in the store's index with its
    model file present is answered from the index (solve_seconds 0.0) and not solved."""
    device = resolve_device(device)
    out_dir = Path(out_dir)
    buckets: dict[tuple[int, int], list[CorpusItem]] = {}
    for item in items:
        key = (
            _round_up(item.mesh.points.shape[0], point_bucket),
            _round_up(item.mesh.tets.shape[0], tet_bucket),
        )
        buckets.setdefault(key, []).append(item)

    index_path = out_dir / INDEX_NAME
    index = json.loads(index_path.read_text()) if index_path.exists() else {}
    results: list[CorpusResult] = []
    for (np_bucket, nt_bucket), group in sorted(buckets.items()):
        for item in group:
            key = _request_key(item, config)
            row = index.get(key)
            if row is not None and (out_dir / row["file"]).exists():
                results.append(CorpusResult(item.name, out_dir / row["file"], row["num_modes"],
                                            row["f1_hz"], 0.0, row["iterations"]))
                if progress:
                    progress(results[-1])
                continue
            padded = pad_tetmesh(item.mesh, np_bucket, nt_bucket)
            t0 = time.perf_counter()
            res: ModalResult = mesh2modes(
                padded, item.material, item.excite_positions, item.baked_scale, config,
                device=device,
            )
            dt = time.perf_counter() - t0
            path = None
            if res.modes.num_modes:
                path = save_modal_model(out_dir, res.modes, res.mass_props)
            results.append(
                CorpusResult(
                    name=item.name,
                    path=path,
                    num_modes=res.modes.num_modes,
                    f1_hz=float(res.modes.freqs[0]) if res.modes.num_modes else 0.0,
                    solve_seconds=dt,
                    iterations=res.profile.restarts,
                )
            )
            if path is not None:
                row = asdict(results[-1])
                del row["name"], row["path"], row["solve_seconds"]
                index[key] = {"file": path.name, **row}
                _write_index(index_path, index)
            if progress:
                progress(results[-1])
    return results
