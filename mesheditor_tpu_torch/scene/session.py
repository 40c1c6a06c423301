"""Crash-recoverable sessions + replay-divergence fixtures.

The reference writes every session's action log (plus referenced assets) into a scratch
*restore directory*, retains the N most recent, and offers File > Restore to reopen any
of them after a crash (MeshEditor's src/action/Log.h:70-78, main.cpp:928-938,
CMake RESTORE_SESSION_RETAIN). On replay divergence it writes a reproducing fixture dir
(MeshEditor's src/main.cpp:409-423, snapshot/ReplayTestFixture.*).

This module is the framework's equivalent (counterpart of
mesheditor_tpu/scene/session.py):

- ``Session``: wraps a Registry with a write-behind ActionLog inside a managed restore
  dir. Record actions through ``apply``; the dir always contains enough to rebuild the
  scene (base snapshot + actions.log), so a ``kill -9`` at any point loses at most the
  queue tail of the write-behind thread (flushed per record, like the reference's
  writer thread).
- ``SessionStore``: enumerates restore dirs, restores one (snapshot + replay), prunes
  to a retention count.
- ``verify_replay``: the in-app determinism self-test — byte-compares the live scene
  snapshot against a fresh replay; on divergence writes a fixture dir containing the
  log, both snapshots, and a report, and returns its path.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional

from .actions import Action, apply_action
from .log import ActionLog, encode_action, read_log, replay
from .registry import Registry
from .snapshot import restore_scene, snapshot_scene

DEFAULT_RETAIN = 5


def default_session_root() -> Path:
    root = os.environ.get("MESHEDITOR_TPU_SESSION_DIR")
    if root:
        return Path(root)
    return Path.home() / ".mesheditor_tpu" / "sessions"


class Session:
    """A live, crash-recoverable editing session.

    All scene mutations must flow through ``apply`` (the single-mutation-point
    invariant, reference Architecture.md:3-5): the action is recorded to the restore
    dir BEFORE it mutates the registry, so the on-disk stream replays to a superset of
    any crash state (at worst one action ahead — replay is idempotent from the base
    snapshot, so restoring re-applies it cleanly)."""

    def __init__(self, registry: Optional[Registry] = None, root: Optional[Path] = None,
                 retain: int = DEFAULT_RETAIN, synth_hooks=None):
        self.registry = registry or Registry()
        self.synth_hooks = synth_hooks
        store = SessionStore(root)
        self.dir = store.create_dir()
        store.prune(retain, keep=self.dir)
        (self.dir / "base_snapshot.bin").write_bytes(snapshot_scene(self.registry))
        (self.dir / "meta.json").write_text(json.dumps({
            "created": time.time(), "pid": os.getpid(), "version": 1,
        }))
        self.log = ActionLog(self.dir / "actions.log")

    def apply(self, action: Action) -> None:
        self.log.record(action)
        apply_action(self.registry, action, self.synth_hooks)

    def process(self) -> None:
        self.registry.process()

    def close(self) -> None:
        self.log.close()


class SessionStore:
    """Restore-dir management: list / restore / prune."""

    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root else default_session_root()

    def create_dir(self) -> Path:
        self.root.mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        base = self.root / f"session-{stamp}-{os.getpid()}"
        d = base
        i = 1
        while d.exists():
            d = Path(f"{base}-{i}")
            i += 1
        d.mkdir()
        return d

    def list(self) -> list[Path]:
        if not self.root.is_dir():
            return []
        return sorted(
            (d for d in self.root.iterdir() if d.is_dir() and (d / "meta.json").exists()),
            key=lambda d: d.stat().st_mtime,
        )

    def restore(self, session_dir, synth_hooks=None) -> Registry:
        """Rebuild the scene: base snapshot, then replay the action log with the
        derivation tick between actions (reference ReplayLog, Log.h:80-88)."""
        d = Path(session_dir)
        base = d / "base_snapshot.bin"
        r = restore_scene(base.read_bytes()) if base.exists() else Registry()
        log_path = d / "actions.log"
        if log_path.exists():
            r = replay(read_log(log_path), registry=r, synth_hooks=synth_hooks)
        return r

    def prune(self, retain: int, keep: Optional[Path] = None) -> None:
        sessions = self.list()
        excess = len(sessions) - retain
        for d in sessions:
            if excess <= 0:
                break
            if keep is not None and d == keep:
                continue
            for p in sorted(d.rglob("*"), reverse=True):
                p.unlink() if p.is_file() else p.rmdir()
            d.rmdir()
            excess -= 1


def verify_replay(registry: Registry, session_dir, fixture_root=None,
                  synth_hooks=None) -> Optional[Path]:
    """Determinism self-test (reference main.cpp:409-423): replay the session's log
    onto a fresh scene and byte-compare snapshots. Returns None when byte-exact;
    on divergence writes a reproducing fixture dir and returns its path."""
    d = Path(session_dir)
    live = snapshot_scene(registry)
    store = SessionStore(d.parent)
    replayed_reg = store.restore(d, synth_hooks=synth_hooks)
    replayed = snapshot_scene(replayed_reg)
    if replayed == live:
        return None
    root = Path(fixture_root) if fixture_root else d.parent / "replay_fixtures"
    root.mkdir(parents=True, exist_ok=True)
    fixture = root / f"divergence-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
    fixture.mkdir()
    (fixture / "live_snapshot.bin").write_bytes(live)
    (fixture / "replayed_snapshot.bin").write_bytes(replayed)
    for name in ("actions.log", "base_snapshot.bin", "meta.json"):
        src = d / name
        if src.exists():
            (fixture / name).write_bytes(src.read_bytes())
    first_diff = next(
        (i for i, (a, b) in enumerate(zip(live, replayed)) if a != b),
        min(len(live), len(replayed)),
    )
    (fixture / "report.txt").write_text(
        f"replay divergence: live {len(live)} bytes, replayed {len(replayed)} bytes, "
        f"first differing byte at offset {first_diff}\n"
        f"session: {d}\n"
    )
    return fixture
