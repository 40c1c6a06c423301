"""Host orchestration of the modal synth, impact path (counterpart of
mesheditor_tpu/synth/engine.py).

One-shot events (strike / silence) queue on the host and drain into the device-resident
impact table between blocks, with one upload per table field; each block then advances the
whole bank on the device (synth/impact.py). On a CUDA bank every block goes through the
hand-written resonator kernel, whatever its sample count and however many impacts an
object carries; there is no routing to another path and no fallback.

Sustained contacts (voices, surface tracks, the coupled kernel) are not ported yet:
`publish_voices` raises.

Determinism: given the same events and block sizes the output is bit-identical; cutting a
stretch into other block sizes leaves the carried state and the samples bit-identical on
the kernel path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..types import ModalModes
from .bank import BankParams, BankState, ImpactTable, build_bank
from .impact import render_block_impacts


@dataclass
class ModalEvent:
    """One queued synthesis event (reference: ModalEvent, ModalAudio.h:61-70)."""

    kind: str  # "impact" | "silence"
    obj: int
    expos: int = 0
    j: tuple = (0.0, 0.0, 0.0)  # node-local impulse vector
    pulse_step: float = 0.0  # per-sample phase increment of the contact pulse
    pulse_gamma: float = 0.0  # contact pulse amplitude
    accel_amp: float = 0.0  # acceleration-noise click amplitude


class ModalSynth:
    """All modal synthesis state, device-resident, advanced one block at a time."""

    def __init__(
        self,
        modes_list: Sequence[ModalModes],
        gains: Optional[Sequence[float]] = None,
        sample_rate: float = 48_000.0,
        max_impacts: int = 128,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.params, self.state = build_bank(modes_list, gains, sample_rate,
                                             device=self.device)
        self.sample_rate = float(sample_rate)
        self.max_impacts = max_impacts
        self.impacts = ImpactTable.empty(max_impacts, self.device)
        self._pending_events: list[ModalEvent] = []
        self.events_dropped = 0
        self.click_gain = 1.0
        # Most live impacts on one object (an upper bound between drains, since impacts
        # only retire): the kernel's slot count R.
        self._max_impacts_per_object = 0

    # ---- events ----

    def enqueue(self, event: ModalEvent) -> None:
        self._pending_events.append(event)

    def strike(self, obj, expos, impulse, contact_time_s, accel_amp=0.0) -> None:
        """Queue a half-sine impact pulse of duration `contact_time_s` carrying `impulse`
        (node-local 3-vector). gamma = pi/2 * step normalizes the pulse to unit integral so
        the impulse magnitude rides in the gain rows (reference: TriggerModalStrike,
        AudioSystem.cpp:753-767)."""
        step = 1.0 / (contact_time_s * self.sample_rate)
        self.enqueue(
            ModalEvent(
                kind="impact",
                obj=obj,
                expos=expos,
                j=tuple(np.asarray(impulse, dtype=np.float64)),
                pulse_step=step,
                pulse_gamma=np.pi / 2 * step,
                accel_amp=accel_amp,
            )
        )

    def silence(self, obj: int) -> None:
        self.enqueue(ModalEvent(kind="silence", obj=obj))

    def publish_voices(self, voices) -> None:
        raise NotImplementedError(
            "sustained voices are not ported to mesheditor_tpu_torch yet; "
            "only impacts render on this path"
        )

    def _drain_events(self) -> None:
        """Apply queued events to the impact table: mirror it to numpy, mutate there,
        upload each field once."""
        if not self._pending_events:
            return
        n_obj = self.params.coeff_re.shape[0]
        n_points = self.params.shapes.shape[1]
        host = self.impacts.to_numpy()
        silenced: list[int] = []
        for e in self._pending_events:
            if e.obj >= n_obj:
                continue
            if e.kind == "impact" and e.pulse_step > 0:
                free = np.flatnonzero(~host["active"])
                if free.size == 0:
                    self.events_dropped += 1
                    continue
                i = int(free[0])
                host["active"][i] = True
                host["obj"][i] = e.obj
                # Out-of-range sample points clamp, as the reference's gather does.
                host["expos"][i] = min(max(e.expos, 0), n_points - 1)
                host["j"][i] = e.j
                host["pulse_step"][i] = e.pulse_step
                host["gamma"][i] = e.pulse_gamma
                host["accel_amp"][i] = e.accel_amp
                host["age"][i] = 0
                host["total"][i] = int(np.ceil(1.0 / e.pulse_step))
            elif e.kind == "silence":
                silenced.append(e.obj)
                host["active"] &= host["obj"] != e.obj
        self._pending_events.clear()
        live = host["active"]
        self._max_impacts_per_object = int(
            np.bincount(host["obj"][live]).max() if live.any() else 0
        )
        self.impacts = ImpactTable.from_numpy(host, self.device)
        if silenced:
            mask = np.ones(n_obj, np.float32)
            mask[silenced] = 0.0
            m = torch.as_tensor(mask, device=self.device)[:, None]
            self.state = BankState(z_re=self.state.z_re * m, z_im=self.state.z_im * m)

    # ---- block render ----

    def render(self, num_samples: int) -> torch.Tensor:
        """One block of mono modal synthesis, returned as a device tensor (no host sync per
        block, so back-to-back blocks queue on the device)."""
        self._drain_events()
        self.state, self.impacts, out = render_block_impacts(
            self.params, self.state, self.impacts, num_samples, self.click_gain,
            self._max_impacts_per_object,
        )
        return out

    def render_seconds(self, seconds: float, block_size: int = 512,
                       fuse: bool = True) -> np.ndarray:
        """Render a stretch of audio. With no host interaction between blocks, the stretch
        fuses into calls of 16,384 samples; carried state and samples are identical either
        way (block-boundary invariance)."""
        total = int(np.ceil(seconds * self.sample_rate / block_size)) * block_size
        step = 16384 if fuse else block_size
        chunks = []
        done = 0
        while done < total:
            n = min(step, total - done)
            chunks.append(self.render(n))
            done += n
        return torch.cat(chunks).cpu().numpy()

    @property
    def active_impacts(self) -> int:
        return int(self.impacts.active.sum())

    def set_gain(self, obj: int, gain: float) -> None:
        out_gain = self.params.out_gain.clone()
        out_gain[obj] = gain
        p = self.params
        self.params = BankParams(p.coeff_re, p.coeff_im, p.disp_scale, p.shapes, out_gain,
                                 p.sample_rate)
