"""Entity-component registry with an intrusive scene graph.

The reference builds on entt with parent/first-child/next-sibling links and a reactive
change-tracking layer (src/scene/SceneGraph.h:6-10, src/Reactive.h:24-66). Here: integer
entities, per-type component stores with deterministic (insertion-ordered) iteration, the
same parent/child topology, and a change-event queue the frame pipeline drains — the
host-side scene model the device-resident audio state is derived from.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Iterator, Type, TypeVar

Entity = int
T = TypeVar("T")


class Registry:
    def __init__(self):
        self._next: Entity = 1
        self._alive: dict[Entity, bool] = {}
        self._stores: dict[type, dict[Entity, object]] = defaultdict(dict)
        # Change events per component type, drained by the frame pipeline (the analog of
        # the reference's reactive trackers).
        self._events: list[tuple[str, type, Entity]] = []
        self._handlers: list[Callable[[Registry], None]] = []

    # -- entities --

    def create(self) -> Entity:
        e = self._next
        self._next += 1
        self._alive[e] = True
        return e

    def destroy(self, e: Entity) -> None:
        for ctype, store in self._stores.items():
            if e in store:
                del store[e]
                self._events.append(("remove", ctype, e))
        self._alive.pop(e, None)

    def valid(self, e: Entity) -> bool:
        return self._alive.get(e, False)

    def entities(self) -> list[Entity]:
        return list(self._alive)

    # -- components --

    def emplace(self, e: Entity, component: T) -> T:
        ctype = type(component)
        store = self._stores[ctype]
        kind = "update" if e in store else "add"
        store[e] = component
        self._events.append((kind, ctype, e))
        return component

    def get(self, e: Entity, ctype: Type[T]) -> T | None:
        return self._stores[ctype].get(e)

    def has(self, e: Entity, ctype: type) -> bool:
        return e in self._stores[ctype]

    def remove(self, e: Entity, ctype: type) -> None:
        if e in self._stores[ctype]:
            del self._stores[ctype][e]
            self._events.append(("remove", ctype, e))

    def view(self, ctype: Type[T]) -> Iterator[tuple[Entity, T]]:
        yield from self._stores[ctype].items()

    def component_types(self) -> list[type]:
        return [t for t, s in self._stores.items() if s]

    # -- events (reactive layer) --

    def drain_events(self) -> list[tuple[str, type, Entity]]:
        events, self._events = self._events, []
        return events

    def on_process(self, handler: Callable[["Registry"], None]) -> None:
        """Register a per-frame derivation handler (the ComponentEventHandlers analog,
        src/ProcessEvents.cpp:1287-1289). Handlers run in registration order."""
        self._handlers.append(handler)

    def process(self) -> None:
        """One derivation tick: ordered handlers over the current state + queued events.
        Replay ticks this between actions, exactly as the reference's ReplayLog does
        (src/action/Log.h:83-88)."""
        for h in self._handlers:
            h(self)
