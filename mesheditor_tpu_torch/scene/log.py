"""Write-behind action log + replay.

The reference serializes every recordable action through a writer thread into a session
restore dir, and replays by re-applying actions with a derivation tick between each
(src/action/Log.h:22-88). Here the records are deterministic JSON lines (type tag +
fields); `replay` rebuilds a registry from the stream, ticking registry.process() between
actions exactly as the reference's ReplayLog does, so a snapshot byte-compare of live vs
replayed scene is the determinism oracle (tests mirror main.cpp:409-423)."""

from __future__ import annotations

import json
import queue
import threading
from dataclasses import asdict, fields
from pathlib import Path

import numpy as np

from . import actions as A
from .actions import Action, apply_action
from .registry import Registry

_ACTION_TYPES = {
    t.__name__: t
    for t in (
        A.AddObject, A.AddPrimitive, A.RemoveObject, A.SetParent, A.SetTransform, A.SetField,
        A.SetAcousticMaterial, A.SetModalModel, A.StrikeVertex, A.SilenceObject,
        A.SetFundamental, A.SetT60Scale, A.SetGain,
    )
}


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, tuple):
        return list(v)
    return v


def encode_action(action: Action) -> str:
    rec = {"t": type(action).__name__}
    for f in fields(action):
        rec[f.name] = _jsonable(getattr(action, f.name))
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def decode_action(line: str) -> Action:
    rec = json.loads(line)
    t = _ACTION_TYPES[rec.pop("t")]
    kwargs = {}
    for f in fields(t):
        if f.name in rec:
            v = rec[f.name]
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
    return t(**kwargs)


class ActionLog:
    """Append-only log with a write-behind thread: enqueueing an action never blocks on
    IO (the reference's SPSC blocking queue -> writer thread, src/action/Log.h:22-67)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._file = open(self.path, "a")
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    def _writer(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                break
            self._file.write(item + "\n")
            self._file.flush()
            self._q.task_done()

    def record(self, action: Action) -> None:
        self._q.put(encode_action(action))

    def drain(self) -> None:
        """Block until every queued record is flushed to disk — the durability
        barrier callers place at frame or checkpoint boundaries."""
        self._q.join()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        self._file.close()


def read_log(path) -> list[Action]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(decode_action(line))
    return out


def replay(log_actions, registry: Registry | None = None, synth_hooks=None) -> Registry:
    """Re-apply a recorded stream onto a fresh scene, ticking the derivation pipeline
    between actions (the contract the frame loop upholds, src/action/Log.h:80-88)."""
    r = registry or Registry()
    for action in log_actions:
        apply_action(r, action, synth_hooks)
        r.process()
    return r
