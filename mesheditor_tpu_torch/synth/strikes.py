"""The block's strike precompute: the impacts' half-sine force curves, the acceleration-noise
click, the per-impact gain rows and their regroup into the (slot, object) form that the
resonator kernels read (synth/impact.py, synth/coupled.py).

On a CUDA table `strike_precompute` launches csrc/strike_precompute.cu once (and raises if
that fails); on a CPU table it runs the plain chain the kernel is held to: render.py's
`_impact_force_curves`, `impact_click` and `impact_gain_rows`, then `_regroup` here. There is
no other route: nothing here falls back from the card to the plain chain.
"""

from __future__ import annotations

import torch

from ..profile import count
from .bank import BankParams, ImpactTable
from .render import _impact_force_curves, impact_click, impact_gain_rows

LAUNCHES = 0  # kernel launches (CUDA tables only; the plain chain is not counted)


def _regroup(impacts: ImpactTable, gain_imp, force_imp, n_obj: int, n_slots: int):
    """Factor the flat impact table into (slot, object) form: impacts sorted by object,
    ranked within their object; rank r of object o lands in slot (r, o). Impacts ranked
    >= n_slots are dropped (the engine sizes n_slots to the live maximum).
    Returns (gain_rok (R, O, K), force_sro (S, R, O))."""
    n_imp = impacts.active.shape[0]
    n_modes = gain_imp.shape[1]
    n_samples = force_imp.shape[1]
    dev = gain_imp.device
    idx = torch.arange(n_imp, device=dev)
    obj = torch.where(impacts.active, impacts.obj.long(), n_obj)
    order = torch.argsort(obj * (n_imp + 1) + idx)
    sorted_obj = obj[order]
    is_start = torch.ones(n_imp, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_obj[1:] != sorted_obj[:-1]
    rank = idx - torch.cummax(torch.where(is_start, idx, 0), 0).values
    keep = (sorted_obj < n_obj) & (rank < n_slots)
    # Dropped impacts add exact zeros into slot 0; kept ones own distinct slots.
    slot = torch.where(keep, rank * n_obj + sorted_obj, 0)
    gain_rok = torch.zeros(n_slots * n_obj, n_modes, dtype=torch.float32, device=dev)
    force_sro = torch.zeros(n_samples, n_slots * n_obj, dtype=torch.float32, device=dev)
    if n_slots:
        gain_rok.index_add_(0, slot, torch.where(keep[:, None], gain_imp[order], 0.0))
        force_sro.index_add_(1, slot, torch.where(keep[None, :], force_imp[order].T, 0.0))
    return (gain_rok.reshape(n_slots, n_obj, n_modes),
            force_sro.reshape(n_samples, n_slots, n_obj))


def _plain(params: BankParams, impacts: ImpactTable, num_samples: int, click_gain: float,
           n_slots: int, shard=None):
    """The plain chain: the CPU route and the kernel's twin. Returns (gain_rok, force_sro,
    click)."""
    force, prev_force = _impact_force_curves(impacts, num_samples)  # (I, S), (I,)
    click = impact_click(impacts, force, prev_force, click_gain)
    here = impacts if shard is None else shard.local_impacts(impacts)
    gain_rok, force_sro = _regroup(here, impact_gain_rows(params, here), force,
                                   params.coeff_re.shape[0], n_slots)
    return gain_rok, force_sro, click


def _bind(params: BankParams, impacts: ImpactTable, num_samples: int, click_gain: float,
          n_slots: int, obj_lo: int = 0):
    """Check the arguments of a kernel call, allocate its outputs and bind the C entry to
    them. Returns (launch, (gain_rok, force_sro, click)): launch() runs the kernel on the
    current stream and raises if the launch fails; it counts nothing."""
    shapes = params.shapes
    device = shapes.device
    n_obj, n_points, n_modes = shapes.shape[:3]
    n_imp = impacts.active.shape[0]
    if num_samples < 0 or n_slots < 0:
        raise ValueError(f"strike_precompute: num_samples={num_samples} n_slots={n_slots}")
    f32 = torch.float32
    table = [getattr(impacts, f) for f in ImpactTable.FIELDS]
    for name, t in zip(ImpactTable.FIELDS + ("shapes",), table + [shapes]):
        dtype = ImpactTable.DTYPES.get(name, f32)
        shape = {"j": (n_imp, 3), "shapes": (n_obj, n_points, n_modes, 3)}.get(name, (n_imp,))
        if t.dtype != dtype or t.device != device or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from .._build import load_kernels

    lib = load_kernels()
    gain_rok = torch.empty(n_slots, n_obj, n_modes, dtype=f32, device=device)
    force_sro = torch.empty(num_samples, n_slots, n_obj, dtype=f32, device=device)
    click = torch.empty(num_samples, dtype=f32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    tensors = (*table, shapes, force_sro, gain_rok, click)  # the C entry's order
    ptrs = [t.data_ptr() for t in tensors]
    ints = (n_imp, n_obj, n_points, n_modes, n_slots, num_samples, obj_lo)

    def launch():
        err = lib.strike_precompute(*ptrs, *ints, click_gain, stream)
        if err != 0:
            raise RuntimeError(f"strike_precompute kernel failed: cudaError {err}")

    launch.tensors = tensors  # the kernel's memory lives as long as the launch
    return launch, (gain_rok, force_sro, click)


def strike_precompute(params: BankParams, impacts: ImpactTable, num_samples: int,
                      click_gain: float = 1.0, n_slots: int = 4, shard=None):
    """The strike precompute of one block: gain rows (R, O, K) and forces (S, R, O) of the
    impacts on the bank's O objects, rank r of object o in slot (r, o) (later ones dropped;
    R = n_slots), and the click (S,) over the whole table, all float32.

    With `shard` (parallel/sharding.py:ObjectBlock) the bank is this rank's block of objects
    [shard.lo, shard.hi) and the table the whole replicated one: the slots hold the impacts on
    this rank's objects, the click all of them. Returns (gain_rok, force_sro, click)."""
    global LAUNCHES
    device = params.shapes.device
    if device.type == "cpu":
        return _plain(params, impacts, num_samples, click_gain, n_slots, shard)
    if device.type != "cuda":
        raise ValueError(f"strike_precompute: unsupported device {device}")
    launch, out = _bind(params, impacts, num_samples, click_gain, n_slots,
                        0 if shard is None else shard.lo)
    launch()
    LAUNCHES += 1
    count("play/strike_precompute")
    return out
