"""Host orchestration of the modal synth (counterpart of mesheditor_tpu/synth/engine.py).

What stays on the host is the reference's protocol:

- one-shot events (strike / silence) drain into the device-resident impact table between
  blocks, with one upload per table field;
- sustained voices are republished whole each frame: a voice missing from the newest set
  has ended, and a publish gap past MAX_VOICE_IDLE_SECONDS silences the set
  (level-triggered semantics, reference: AdoptVoices, ModalAudio.cpp:105-144). The voice
  STATE lives in a host mirror and goes to the device in one packed upload of copies per
  dirty block; the carries live only on the device;
- surface tracks live in a content-keyed pool of device rows; a slot is repointed only when
  no live voice reads it (reference: AdoptSurfaceTrack, ModalAudio.h:261-301).

Routing: a block with at least one live voice advances the whole bank through the coupled
render (synth/coupled.py), a voice-free block through the impact render (synth/impact.py).
On a CUDA bank each goes through its hand-written kernel, whatever the sample count and
however many impacts or voices an object carries; on a CPU bank through its plain version.
There is no other route and no fallback.

Determinism: given the same events, publishes and block sizes the output is bit-identical;
cutting a stretch into other block sizes leaves the carried state and the samples
bit-identical.

Object sharding (parallel/sharding.py:shard_synth): `shard` is then this rank's block of
the objects. The bank holds that block only; the tables and this host side stay whole and
replicated, every rank making the same calls, and objects are named by their global index
throughout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..profile import scope
from ..types import ModalModes
from .bank import (VOICE_F32_COLS, VOICE_I32_COLS, BankParams, BankState, ImpactTable,
                   TrackPool, VoiceTable, apply_voice_state, build_bank, tune_object)
from .render import render_block
from .tracks import TRACK_SAMPLES, RoughnessTrack

# A voice this long without a fresh contact report ends itself
# (reference: MaxVoiceIdleSeconds, ModalAudio.cpp:26).
MAX_VOICE_IDLE_SECONDS = 0.1


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


@dataclass
class ContactTrackSpec:
    """One surface track a contact rides over (reference: ContactTrack, ModalAudio.h:33-40)."""

    index: int = -1  # pool slot, -1 unused
    rate: float = 0.0  # track samples advanced per output sample
    sigma: float = 0.0  # height scale, m
    window: float = 0.0  # contact-filter width, track samples
    step: float = 0.0  # surface distance per output sample, m


@dataclass
class SustainedVoice:
    """Published contact state (reference: SustainedState + VoiceSet::Voice,
    ModalAudio.h:42-59,120-129). `voice_id` carries carry-state across frames."""

    voice_id: int
    obj: int
    blend_points: tuple = (0, 0, 0)
    blend_weights: tuple = (1.0, 0.0, 0.0)
    normal: tuple = (0.0, 0.0, 0.0)
    slip_dir: tuple = (0.0, 0.0, 0.0)
    sweep_dir: tuple = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    normal_force: float = 0.0
    friction: float = 0.0
    stiffness: float = 0.0
    static_penetration: float = 0.0
    damping_coeff: float = 0.0
    tracks: tuple = ()  # up to 4 ContactTrackSpec


class ModalSynth:
    """All modal synthesis state, device-resident, advanced one block at a time."""

    def __init__(
        self,
        modes_list: Sequence[ModalModes],
        gains: Optional[Sequence[float]] = None,
        sample_rate: float = 48_000.0,
        max_impacts: int = 128,
        max_voices: int = 16,
        track_slots: int = 64,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.params, self.state = build_bank(modes_list, gains, sample_rate,
                                             device=self.device)
        self.n_objects = len(modes_list)  # every object, on every rank of a sharded synth
        self.shard = None  # parallel/sharding.py:ObjectBlock once shard_synth has run
        self.sample_rate = float(sample_rate)
        self.max_impacts = max_impacts
        self.max_voices = max_voices
        self.impacts = ImpactTable.empty(max_impacts, self.device)
        self.voices = VoiceTable.empty(max_voices, self.device)
        self.pool = TrackPool.empty(track_slots, TRACK_SAMPLES, self.device)
        self._pool_keys: dict[int, int] = {}  # content key -> slot
        self._voice_ids: dict[int, int] = {}  # live voice id -> table row
        self._pending_events: list[ModalEvent] = []
        self._published: Optional[list[SustainedVoice]] = None
        self._publish_fresh = False
        self._idle_samples = 0
        # Live counters (reference: ActiveVoices/ActiveImpacts + drop counters,
        # ModalAudio.h:204-206).
        self.events_dropped = 0
        self.voices_refused = 0
        self.tracks_refused = 0
        self.click_gain = 1.0
        self.sustain_level = 1.0
        self.coupling = 1.0
        # Most live impacts on one object (an upper bound between drains, since impacts
        # only retire): the kernels' slot count R.
        self._max_impacts_per_object = 0
        # Host mirror of the voice STATE (packed upload layout, see bank.apply_voice_state);
        # the carries live only on the device.
        self._voice_f32 = np.zeros((max_voices, VOICE_F32_COLS), np.float32)
        self._voice_i32 = np.zeros((max_voices, VOICE_I32_COLS), np.int32)
        self._voice_i32[:, 4:8] = -1

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

    # ---- surface track pool ----

    def adopt_track(self, key: int, make) -> int:
        """The pool slot holding `key`'s track, or -1 when every slot is live. `make()`
        returns a RoughnessTrack; only unread slots are repointed."""
        if key in self._pool_keys:
            return self._pool_keys[key]
        n_slots = self.pool.heights.shape[0]
        free = [s for s in range(n_slots) if s not in self._pool_keys.values()]
        if free:
            slot = free[0]
        else:
            live = set()
            for v in self._voice_ids.values():
                live.update(int(i) for i in self._voice_i32[v, 4:8] if i >= 0)
            if self._published:
                for voice in self._published:
                    for t in voice.tracks:
                        if t.index >= 0:
                            live.add(t.index)
            reusable = [s for s in range(n_slots) if s not in live]
            if not reusable:
                self.tracks_refused += 1
                return -1
            slot = reusable[0]
            self._pool_keys = {k: s for k, s in self._pool_keys.items() if s != slot}
        track: RoughnessTrack = make()
        n = self.pool.heights.shape[1]
        h = np.zeros(n, np.float32)
        s = np.zeros(n + 1, np.float32)
        m = min(n, track.heights.shape[0])
        h[:m] = track.heights[:m]
        s[: m + 1] = track.sums[: m + 1]
        # In-place row writes, ordered on the device after every block already queued.
        self.pool.heights[slot] = torch.from_numpy(h).to(self.device)
        self.pool.sums[slot] = torch.from_numpy(s).to(self.device)
        self._pool_keys[key] = slot
        return slot

    # ---- voices (the triple-buffered voice-set analog) ----

    def publish_voices(self, voices: Sequence[SustainedVoice]) -> None:
        """Publish this frame's whole sustained-contact set. A contact already open keeps
        its carried state; one the set omits ends; a new one opens."""
        self._published = list(voices)
        self._publish_fresh = True

    def _write_voice_row(self, row: int, s: SustainedVoice, reset: bool) -> None:
        """Write one voice's STATE into the host mirror (carries live only on the device)."""
        f = self._voice_f32[row]
        i = self._voice_i32[row]
        f[0:3] = s.blend_weights
        f[3:6] = s.normal
        f[6:9] = s.slip_dir
        f[9:15] = np.asarray(s.sweep_dir, np.float32).reshape(6)
        f[15] = s.normal_force
        f[16] = s.friction
        f[17] = s.stiffness
        f[18] = s.static_penetration
        f[19] = s.damping_coeff
        tracks = list(s.tracks)[:4] + [ContactTrackSpec()] * max(0, 4 - len(s.tracks))
        f[20:24] = [t.rate for t in tracks]
        f[24:28] = [t.sigma for t in tracks]
        f[28:32] = [t.window for t in tracks]
        f[32:36] = [t.step for t in tracks]
        i[0] = s.obj
        i[1:4] = s.blend_points
        i[4:8] = [t.index for t in tracks]
        i[8] = 1
        if reset:
            i[9] = 1

    def _clear_voice_row(self, row: int) -> None:
        self._voice_f32[row] = 0.0
        self._voice_i32[row] = 0
        self._voice_i32[row, 4:8] = -1

    def _upload_voices(self) -> None:
        """One packed upload of COPIES of the host mirror (torch.tensor copies; the mirror
        is mutated right after, so it is never handed to an asynchronous transfer)."""
        self.voices = apply_voice_state(
            self.voices,
            torch.tensor(self._voice_f32, device=self.device),
            torch.tensor(self._voice_i32, device=self.device),
        )

    def _adopt_voices(self) -> None:
        """Reconcile the published set into the host voice-state mirror, then apply it to
        the device table with ONE packed upload."""
        published = self._published
        if self._publish_fresh:
            self._idle_samples = 0
            self._publish_fresh = False
        reporting = published is not None and self._idle_samples <= int(
            self.sample_rate * MAX_VOICE_IDLE_SECONDS
        )
        named = {v.voice_id for v in published} if (reporting and published) else set()
        dirty = False
        # End voices the newest set omits.
        for vid in list(self._voice_ids):
            if vid not in named:
                self._clear_voice_row(self._voice_ids.pop(vid))
                dirty = True
        if reporting and published:
            for voice in published:
                if voice.obj >= self.n_objects:
                    continue
                if voice.voice_id in self._voice_ids:
                    row = self._voice_ids[voice.voice_id]
                    self._write_voice_row(row, voice, reset=False)
                else:
                    free = np.flatnonzero(self._voice_i32[:, 8] == 0)
                    if free.size == 0:
                        self.voices_refused += 1
                        continue
                    row = int(free[0])
                    self._voice_ids[voice.voice_id] = row
                    self._write_voice_row(row, voice, reset=True)
                dirty = True
        if dirty:
            self._upload_voices()
            self._voice_i32[:, 9] = 0  # resets consumed

    def _drain_events(self) -> None:
        """Apply queued events to the impact table: mirror it to numpy, mutate there,
        upload each field once."""
        if not self._pending_events:
            return
        with scope("play/events"):
            n_obj = self.n_objects
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
                    # Silence ends the object's voices too.
                    for vid, row in list(self._voice_ids.items()):
                        if int(self._voice_i32[row, 0]) == e.obj and self._voice_i32[row, 8]:
                            self._clear_voice_row(row)
                            del self._voice_ids[vid]
                            self._upload_voices()
            self._pending_events.clear()
            live = host["active"]
            self._max_impacts_per_object = int(
                np.bincount(host["obj"][live]).max() if live.any() else 0
            )
            self.impacts = ImpactTable.from_numpy(host, self.device)
            rows = [r for r in map(self._row, silenced) if r is not None]
            if rows:
                mask = np.ones(self.params.coeff_re.shape[0], np.float32)
                mask[rows] = 0.0
                m = torch.as_tensor(mask, device=self.device)[:, None]
                self.state = BankState(z_re=self.state.z_re * m, z_im=self.state.z_im * m)

    def _row(self, obj: int):
        """The bank row of object `obj`, or None when another rank's bank holds it."""
        return obj if self.shard is None else self.shard.local(obj)

    # ---- block render ----

    def render(self, num_samples: int) -> torch.Tensor:
        """One block of mono modal synthesis, returned as a device tensor (no host sync per
        block, so back-to-back blocks queue on the device). A block with a live voice goes
        through the coupled render, a voice-free one through the impact render.

        The call is the `play/block` span (profile.py); its phases are `play/events` (the
        strike drain, when strikes wait), `play/voices` (the voice publish, once a set was
        published), `play/precompute`, `play/resonate` and `play/finish`, and `play/reads`
        counts its reads of the device."""
        with scope("play/block"):
            self._drain_events()
            if self._published is not None or self._voice_ids:
                with scope("play/voices"):
                    self._adopt_voices()
            per_obj = 0
            if self._voice_ids:
                rows = list(self._voice_ids.values())
                per_obj = int(np.bincount(self._voice_i32[rows, 0]).max())
            self.state, self.impacts, self.voices, out = render_block(
                self.params, self.state, self.impacts, self.voices, self.pool, num_samples,
                self.click_gain, self.sustain_level, self.coupling,
                n_slots=self._max_impacts_per_object, n_per_obj=per_obj, shard=self.shard,
            )
            self._idle_samples += num_samples
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

    @property
    def active_voices(self) -> int:
        return len(self._voice_ids)

    def set_gain(self, obj: int, gain: float) -> None:
        row = self._row(obj)
        if row is None:
            return
        out_gain = self.params.out_gain.clone()
        out_gain[row] = gain
        p = self.params
        self.params = BankParams(p.coeff_re, p.coeff_im, p.disp_scale, p.shapes, out_gain,
                                 p.sample_rate)

    def retune(self, obj: int, freqs, t60s) -> None:
        row = self._row(obj)
        if row is not None:
            self.params = tune_object(self.params, row, freqs, t60s)
