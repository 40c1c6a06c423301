"""Deterministic scene snapshots: a byte-exact image of the Persistent components.

`snapshot_scene` produces identical bytes for identical scenes (sorted entities, fixed
field order, canonical array encoding) — the replay-divergence oracle of the reference
(SnapshotSceneState + byte compare, src/snapshot/SceneSnapshot.h:9-19, main.cpp:409-423).
`verify_coverage` throws when a live component type is neither Persistent nor Derived
(src/snapshot/SnapshotRoles.h:29) — the rule that keeps determinism holes out.
"""

from __future__ import annotations

import io
import json
from dataclasses import fields

import numpy as np

from .components import DERIVED_COMPONENTS, PERSISTENT_COMPONENTS
from .registry import Registry

_PERSISTENT_BY_NAME = {c.__name__: c for c in PERSISTENT_COMPONENTS}


def verify_coverage(r: Registry) -> None:
    known = set(PERSISTENT_COMPONENTS) | set(DERIVED_COMPONENTS)
    for ctype in r.component_types():
        if ctype not in known:
            raise RuntimeError(
                f"component {ctype.__name__} is neither Persistent nor Derived — "
                "register it in scene/components.py so snapshots/replay stay complete"
            )


def _encode_value(v, buf: io.BytesIO):
    if isinstance(v, np.ndarray):
        arr = np.ascontiguousarray(v)
        meta = json.dumps({"dt": arr.dtype.str, "sh": list(arr.shape)}).encode()
        buf.write(len(meta).to_bytes(4, "little"))
        buf.write(meta)
        buf.write(arr.tobytes())
    else:
        enc = json.dumps(v, sort_keys=True, default=float).encode()
        buf.write(len(enc).to_bytes(4, "little"))
        buf.write(enc)


def snapshot_scene(r: Registry) -> bytes:
    verify_coverage(r)
    buf = io.BytesIO()
    for ctype in PERSISTENT_COMPONENTS:
        items = sorted(r.view(ctype), key=lambda kv: kv[0])
        buf.write(ctype.__name__.encode())
        buf.write(len(items).to_bytes(4, "little"))
        for eid, comp in items:
            buf.write(int(eid).to_bytes(8, "little"))
            for f in fields(ctype):
                _encode_value(getattr(comp, f.name), buf)
    return buf.getvalue()


def _decode_value(buf: io.BytesIO, expect_array: bool):
    n = int.from_bytes(buf.read(4), "little")
    raw = buf.read(n)
    if expect_array:
        meta = json.loads(raw)
        arr_bytes = int(np.dtype(meta["dt"]).itemsize * int(np.prod(meta["sh"] or [1])))
        if meta["sh"] == []:
            arr_bytes = np.dtype(meta["dt"]).itemsize
        data = buf.read(int(np.prod(meta["sh"])) * np.dtype(meta["dt"]).itemsize)
        return np.frombuffer(data, dtype=meta["dt"]).reshape(meta["sh"]).copy()
    return json.loads(raw)


def restore_scene(data: bytes) -> Registry:
    r = Registry()
    buf = io.BytesIO(data)
    max_eid = 0
    for ctype in PERSISTENT_COMPONENTS:
        tag = buf.read(len(ctype.__name__)).decode()
        assert tag == ctype.__name__, f"snapshot corrupt: expected {ctype.__name__}, got {tag}"
        count = int.from_bytes(buf.read(4), "little")
        proto = ctype()
        for _ in range(count):
            eid = int.from_bytes(buf.read(8), "little")
            max_eid = max(max_eid, eid)
            if not r.valid(eid):
                while r._next <= eid:
                    r._alive[r._next] = False
                    r._next += 1
                r._alive[eid] = True
            kwargs = {}
            for f in fields(ctype):
                is_arr = isinstance(getattr(proto, f.name), np.ndarray)
                kwargs[f.name] = _decode_value(buf, is_arr)
            r.emplace(eid, ctype(**kwargs))
    r.drain_events()
    return r
