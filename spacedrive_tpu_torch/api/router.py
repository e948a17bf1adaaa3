"""Typed RPC router: the node's rspc surface.

Port of ``spacedrive_tpu/api/router.py`` (upstream core/src/api/mod.rs:
103-200): procedures in dotted namespaces, each a query, mutation or
subscription; a library-scoped procedure takes the library id in its input
and its handler receives the ``Library`` (api/utils/library.rs). A
subscription path lives in a map of its own, so one path may be both.
Mutations name the query keys they invalidate; after a success the router
emits an ``InvalidateOperation`` on the node's event bus
(api/utils/invalidate.rs), and ``mount_router`` refuses a key that names no
query. The transports (``api/server.py``, direct calls in tests) stand
apart from the router.
"""

from __future__ import annotations

import inspect
import uuid as uuidlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class RpcError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


@dataclass
class Procedure:
    name: str
    kind: str                      # query | mutation | subscription
    handler: Callable
    library_scoped: bool
    invalidates: List[str] = field(default_factory=list)


class Router:
    def __init__(self, node):
        self.node = node
        self.procedures: Dict[str, Procedure] = {}
        # Subscriptions live in their own namespace: a path may be both a
        # query (pull the current value) and a subscription (push every
        # change), as in rspc, where the kinds are separate maps.
        # dispatch() only ever sees `procedures`, subscribe() only this.
        self.subscriptions: Dict[str, Procedure] = {}

    # -- registration ------------------------------------------------------

    def _register(self, name: str, kind: str, library: bool,
                  invalidates: Optional[List[str]] = None):
        def deco(fn):
            registry = self.subscriptions \
                if kind == "subscription" else self.procedures
            assert name not in registry, name
            registry[name] = Procedure(
                name, kind, fn, library, list(invalidates or []))
            return fn
        return deco

    def query(self, name, library=False):
        return self._register(name, "query", library)

    def mutation(self, name, library=False, invalidates=None):
        return self._register(name, "mutation", library, invalidates)

    def subscription(self, name, library=False):
        return self._register(name, "subscription", library)

    # -- dispatch ----------------------------------------------------------

    def _resolve_library(self, input: Any):
        if not isinstance(input, dict) or "library_id" not in input:
            raise RpcError("BAD_REQUEST",
                           "library-scoped procedure needs library_id")
        try:
            lib_id = uuidlib.UUID(str(input["library_id"]))
        except ValueError:
            raise RpcError("BAD_REQUEST", "invalid library_id")
        lib = self.node.libraries.get(lib_id)
        if lib is None:
            raise RpcError("NOT_FOUND", f"library {lib_id} not loaded")
        return lib

    async def dispatch(self, path: str, input: Any = None) -> Any:
        """Run a query or mutation; returns its JSON-safe result."""
        proc = self.procedures.get(path)
        if proc is None:
            if path in self.subscriptions:
                raise RpcError("BAD_REQUEST",
                               f"{path} is a subscription; use "
                               "subscribe()")
            raise RpcError("NOT_FOUND", f"no such procedure: {path}")
        args = [self.node]
        if proc.library_scoped:
            args.append(self._resolve_library(input))
        try:
            result = proc.handler(*args, input)
            if inspect.isawaitable(result):
                result = await result
        except RpcError:
            raise
        except (KeyError, ValueError) as e:
            raise RpcError("BAD_REQUEST", str(e))
        if proc.kind == "mutation" and proc.invalidates:
            lib_id = (input or {}).get("library_id") \
                if isinstance(input, dict) else None
            for key in proc.invalidates:
                self.node.events.invalidate_query(lib_id, key)
        return result

    async def subscribe(self, path: str, input: Any,
                        emit: Callable[[Any], None]) -> Callable[[], None]:
        """Start a subscription; returns an unsubscribe callable."""
        proc = self.subscriptions.get(path)
        if proc is None:
            raise RpcError("NOT_FOUND", f"no such subscription: {path}")
        args = [self.node]
        if proc.library_scoped:
            args.append(self._resolve_library(input))
        result = proc.handler(*args, input, emit)
        if inspect.isawaitable(result):
            result = await result
        return result if callable(result) else (lambda: None)


def mount_router(node) -> Router:
    """Build the full router over a node (api/mod.rs:103-200's mount)."""
    from . import procedures
    router = Router(node)
    procedures.register_all(router)
    # Every `invalidates=` key must name a real query — a typo'd key
    # would silently never refetch (the reference validates invalidation
    # keys against the router at startup, api/utils/invalidate.rs:82).
    for proc in list(router.procedures.values()) \
            + list(router.subscriptions.values()):
        for key in proc.invalidates:
            target = router.procedures.get(key)
            if target is None or target.kind != "query":
                # Hard error (not assert: -O must not disable the guard).
                raise RuntimeError(
                    f"{proc.name} invalidates unknown query {key!r}")
    return router
