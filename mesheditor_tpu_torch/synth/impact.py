"""Impact-only block render through the hand-written CUDA resonator kernel (counterpart of
mesheditor_tpu/synth/pallas_impact.py).

`resonate` advances the (O, K) resonator grid over a whole call: per sample,

    excite[o, k] = sum_r force[s, r, o] * gain[r, o, k]      (exact f32 multiply-adds)
    z <- z * c + excite;  mix[s] = sum_o sum_k out_gain[o] * Im z[o, k]

On a CUDA tensor it launches csrc/impact_resonator.cu (and raises if that fails); on a CPU
tensor it runs `_resonate_plain`, the same recurrence in plain PyTorch. There is no other
route: nothing here falls back from the card to the plain version.

Impacts regroup from the flat table into (slot, object) factored form (synth/strikes.py):
R = the largest number of live impacts on one object, which the kernel takes at run time, so
any number of impacts per object and any sample count go through the kernel.
"""

from __future__ import annotations

import torch

from ..profile import scope
from .bank import BankParams, BankState, ImpactTable
from .render import finish_block
from .strikes import strike_precompute

LAUNCHES = 0  # kernel launches (CUDA tensors only; the plain version is not counted)

_EXCITE_CHUNK = 256  # samples whose excitation the plain version forms in one pass


def _resonate_plain(coeff_re, coeff_im, out_gain, gain_rok, force_sro, z_re, z_im):
    """The plain PyTorch recurrence (the impact-only branch of the reference's
    render_block_impl). Returns (mix (S,), z_re, z_im)."""
    n_samples = force_sro.shape[0]
    n_slots = gain_rok.shape[0]
    g = out_gain[:, None]
    mix = torch.empty(n_samples, dtype=torch.float32, device=coeff_re.device)
    zr, zi = z_re, z_im
    for c0 in range(0, n_samples, _EXCITE_CHUNK):
        f = force_sro[c0 : c0 + _EXCITE_CHUNK]  # (C, R, O)
        excite = torch.zeros(f.shape[0], *coeff_re.shape, dtype=torch.float32,
                             device=coeff_re.device)
        for r in range(n_slots):  # slot order, one rounded add per slot
            excite = excite + f[:, r, :, None] * gain_rok[r]
        for t in range(f.shape[0]):
            new_re = zr * coeff_re - zi * coeff_im + excite[t]
            new_im = zr * coeff_im + zi * coeff_re
            zr, zi = new_re, new_im
            mix[c0 + t] = (g * new_im).sum()
    return mix, zr, zi


def _check(name, t, shape, device):
    if t.dtype != torch.float32 or t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected float32 {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bind(coeff_re, coeff_im, out_gain, gain_rok, force_sro, z_re, z_im):
    """Check the arguments of a kernel call, allocate its outputs and bind the C entry to
    them. Returns (launch, (mix, new z_re, new z_im)): launch()
    runs the kernel on the current stream and raises if the launch fails; it counts
    nothing."""
    device = coeff_re.device
    n_obj, n_modes = coeff_re.shape
    n_slots = gain_rok.shape[0]
    n_samples = force_sro.shape[0]
    for name, t, shape in (
        ("coeff_re", coeff_re, (n_obj, n_modes)), ("coeff_im", coeff_im, (n_obj, n_modes)),
        ("out_gain", out_gain, (n_obj,)), ("gain_rok", gain_rok, (n_slots, n_obj, n_modes)),
        ("force_sro", force_sro, (n_samples, n_slots, n_obj)),
        ("z_re", z_re, (n_obj, n_modes)), ("z_im", z_im, (n_obj, n_modes)),
    ):
        _check(name, t, shape, device)
    from .._build import load_kernels

    lib = load_kernels()
    f32 = dict(dtype=torch.float32, device=device)
    rows = lib.impact_resonator_partials(n_obj, n_modes)
    if rows < 0:
        raise ValueError(f"impact_resonator: shapes O={n_obj} K={n_modes} do not fit")
    partials = torch.empty(rows, n_samples, **f32)
    mix = torch.empty(n_samples, **f32)
    new_re = torch.empty(n_obj, n_modes, **f32)
    new_im = torch.empty(n_obj, n_modes, **f32)
    stream = torch.cuda.current_stream(device).cuda_stream
    tensors = (coeff_re, coeff_im, out_gain, gain_rok, force_sro, z_re, z_im, new_re, new_im,
               partials, mix)
    ptrs = [t.data_ptr() for t in tensors]

    def launch():
        err = lib.impact_resonator(*ptrs, n_obj, n_modes, n_slots, n_samples, stream)
        if err != 0:
            raise RuntimeError(f"impact_resonator kernel failed: cudaError {err}")

    launch.tensors = tensors  # the kernel's memory lives as long as the launch
    return launch, (mix, new_re, new_im)


def resonate(coeff_re, coeff_im, out_gain, gain_rok, force_sro, z_re, z_im):
    """Advance the resonator grid over force_sro.shape[0] samples.

    coeff_re, coeff_im, z_re, z_im: (O, K); out_gain: (O,); gain_rok: (R, O, K);
    force_sro: (S, R, O); all float32. Returns (mix (S,), new z_re, new z_im)."""
    global LAUNCHES
    device = coeff_re.device
    if device.type == "cpu":
        return _resonate_plain(coeff_re, coeff_im, out_gain, gain_rok, force_sro, z_re, z_im)
    if device.type != "cuda":
        raise ValueError(f"resonate: unsupported device {device}")
    launch, out = _bind(coeff_re, coeff_im, out_gain, gain_rok, force_sro, z_re, z_im)
    launch()
    LAUNCHES += 1
    return out


def render_block_impacts(params: BankParams, state: BankState, impacts: ImpactTable,
                         num_samples: int, click_gain: float = 1.0, n_slots: int = 4,
                         shard=None):
    """Impact-only block render. `n_slots` bounds the live impacts per object (more are
    dropped). With `shard` (parallel/sharding.py:ObjectBlock) the bank is this rank's block
    of objects and the impact table the whole replicated one: the kernel sees only this
    rank's impacts, the mix is summed over the group and the click, a sum over the whole
    table, is added once after it. Returns (state, impacts, out (num_samples,) float32)."""
    with scope("play/precompute"):
        gain_rok, force_sro, click = strike_precompute(params, impacts, num_samples,
                                                       click_gain, n_slots, shard)
    with scope("play/resonate"):
        mix, z_re, z_im = resonate(params.coeff_re, params.coeff_im, params.out_gain,
                                   gain_rok, force_sro, state.z_re, state.z_im)
        if shard is not None:
            mix = shard.sum(mix)
    with scope("play/finish"):
        state, impacts, _ = finish_block(params, impacts, z_re, z_im, num_samples,
                                         shard=shard)
    return state, impacts, mix + click
