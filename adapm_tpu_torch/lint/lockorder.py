"""Runtime lock-order sentinel: the lint plane's dynamic half (the
port's copy of the JAX package's `lint/lockorder.py`).

The static rules (rules.py) claim the lock discipline from the source:
the dispatch gate is a LEAF (never held while acquiring anything
else), the server lock may be held across a gated ENQUEUE but never
across a wait, and no two lock domains order each other both ways.
This module validates the same claims at runtime: an opt-in
(``--sys.lint.lockorder``, default off) wrapper around the server
lock, the dispatch gate, and the admission/registry locks records the
per-thread acquisition graph and raises ``LockOrderError`` the moment

  - an acquisition would create a CYCLE in the process-wide
    lock-order graph (the classic deadlock precondition — caught on
    the first inverted pair, deterministically, instead of waiting for
    the storm test's scheduler to actually interleave the deadlock), or
  - any NEW lock is acquired while the dispatch gate is held anywhere
    in the thread's stack (the gate's leaf contract, docs/EXECUTOR.md:
    it brackets the enqueue only — a lock taken under it is a
    held-across-dispatch edge by definition).

The graph is keyed by lock IDENTITY, not name: two servers on one
process each own a lock named "server", and a thread nesting server A
under server B is an orderable (and invertible!) pair, never a
reentrant no-op — exactly the multi-server configuration the storm
tests run. Names are display labels in the error chain.

Zero-cost skip-wrapper like every other optional plane: with the
knob off, ``Server`` builds plain ``threading.RLock`` objects (no
wrapper exists at all) and the process-global gate — which dispatch
sites capture at import (``_GATE = dispatch_gate()``) and therefore
cannot be swapped per server — is a ``SentinelLock`` paying ONE
``is None`` check per acquire. With it on, every tracked
acquire/release notes the edge under the sentinel's own internal mutex
(deliberately NOT tracked — the sentinel cannot deadlock with itself).

The port's storm tests (the executor's producer storm and shutdown,
the episodic, tier and serving storms) run with the sentinel enabled,
so the dynamic checker rides the existing suites: a lock-order
regression fails those tests with a named edge trace, not a hung run.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Tuple

#: the gate's display name — leaf by contract (docs/EXECUTOR.md)
GATE_NAME = "dispatch_gate"

# unique identity per SentinelLock (id() can recycle after GC; a
# monotonic counter cannot); uid 1 is reserved for the process gate
_UIDS = itertools.count(1)
GATE_UID = next(_UIDS)


class LockOrderError(RuntimeError):
    """A lock acquisition violated the ordering contract (cycle or
    gate-leaf). The message names the full edge chain so the report
    points at both call sites."""


class LockOrderSentinel:
    """The process-wide acquisition-graph recorder. Thread-safe;
    per-thread held-lock stacks live in a ``threading.local``.

    Edges are directed over lock UIDs: holding A while acquiring B
    records (A -> B). Reentrant re-acquisition of the SAME lock object
    records nothing — same-lock nesting is the RLock contract, not an
    ordering fact. Edge checks happen BEFORE the underlying acquire,
    so a would-be deadlock raises instead of deadlocking."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: Dict[Tuple[int, int], bool] = {}
        self._names: Dict[int, str] = {GATE_UID: GATE_NAME}
        self._violations = 0
        self._local = threading.local()

    # -- per-thread held stack ----------------------------------------------

    def _held(self) -> List[int]:
        h = getattr(self._local, "held", None)
        if h is None:
            h = self._local.held = []
        return h

    # -- recording -----------------------------------------------------------

    def note_acquire(self, uid: int, name: str) -> None:
        held = self._held()
        if uid in held:
            held.append(uid)  # reentrant: count, no new ordering fact
            return
        if GATE_UID in held:
            # anywhere in the stack, not just the top: a reentrant
            # re-acquire above the gate must not mask the leaf contract
            with self._mu:
                self._violations += 1
            raise LockOrderError(
                f"lock {name!r} acquired while holding the dispatch "
                f"gate — the gate is a LEAF: it brackets the sharded "
                f"ENQUEUE only, and any lock taken under it is a "
                f"held-across-dispatch edge (docs/EXECUTOR.md; "
                f"APM001/APM002)")
        top = held[-1] if held else None
        if top is not None:
            with self._mu:
                self._names.setdefault(uid, name)
                edge = (top, uid)
                if edge not in self._edges:
                    cycle = self._path(uid, top)
                    if cycle is not None:
                        self._violations += 1
                        chain = " -> ".join(
                            [self._names.get(top, "?"), name]
                            + [self._names.get(u, "?")
                               for u in cycle[1:]])
                        raise LockOrderError(
                            f"lock-order cycle: acquiring {name!r} "
                            f"while holding "
                            f"{self._names.get(top, '?')!r} inverts "
                            f"the recorded order {chain} — two "
                            f"threads taking these in opposite orders "
                            f"can deadlock (docs/INVARIANTS.md)")
                    self._edges[edge] = True
        else:
            with self._mu:
                self._names.setdefault(uid, name)
        held.append(uid)

    def note_release(self, uid: int) -> None:
        held = self._held()
        # release the innermost matching hold (RLock semantics)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == uid:
                del held[i]
                return

    def _path(self, src: int, dst: int) -> Optional[List[int]]:
        """DFS over recorded edges: a path src ->* dst means adding
        (dst -> src) closes a cycle. Caller holds ``_mu``."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            cur, path = stack.pop()
            if cur == dst:
                return path
            for (a, b) in self._edges:
                if a == cur and b not in seen:
                    seen.add(b)
                    stack.append((b, path + [b]))
        return None

    # -- introspection (tests / tooling) -------------------------------------

    def edges(self) -> List[Tuple[str, str]]:
        """Recorded edges as (holder name, acquired name) pairs —
        deduplicated by NAME for readability (identity dedup lives in
        the graph itself)."""
        with self._mu:
            return sorted({(self._names.get(a, "?"),
                            self._names.get(b, "?"))
                           for a, b in self._edges})

    @property
    def violations(self) -> int:
        return self._violations

    def assert_clean(self) -> None:
        """Fail loudly if any violation was ever raised through this
        sentinel (storm tests call this at teardown — a violation that
        a storm thread swallowed must still fail the test)."""
        if self._violations:
            raise AssertionError(
                f"lock-order sentinel recorded {self._violations} "
                f"violation(s); edges seen: {self.edges()}")


class SentinelLock:
    """A named lock wrapper that reports acquire/release to the active
    sentinel — one ``is None`` check per acquire when no sentinel is
    installed (the skip-wrapper price; this is why the
    process-global dispatch gate can be a SentinelLock permanently).
    Wraps any lock-like object (Lock/RLock); delegates the Condition
    integration surface (``_is_owned``/``_acquire_restore``/
    ``_release_save``) so ``threading.Condition(SentinelLock(...))``
    works — and a condvar WAIT correctly releases the hold in the
    sentinel's view (the wait parks without the lock; re-acquiring on
    wake re-records).

    Per-server locks are built ONLY when ``--sys.lint.lockorder`` is
    on (core/kv.py, serve/admission.py): with the knob off the plain ``threading.RLock``
    is used directly and no wrapper cost exists on the hot path."""

    __slots__ = ("name", "inner", "uid")

    def __init__(self, name: str, inner=None, uid: Optional[int] = None):
        self.name = name
        self.inner = inner if inner is not None else threading.RLock()
        self.uid = uid if uid is not None else next(_UIDS)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        s = _SENTINEL
        if s is not None:
            s.note_acquire(self.uid, self.name)
        ok = self.inner.acquire(blocking, timeout)
        if not ok and s is not None:
            s.note_release(self.uid)
        return ok

    def release(self) -> None:
        self.inner.release()
        s = _SENTINEL
        if s is not None:
            s.note_release(self.uid)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- Condition integration ----------------------------------------------

    def _is_owned(self):
        return self.inner._is_owned()

    def _release_save(self):
        state = self.inner._release_save()
        s = _SENTINEL
        if s is not None:
            s.note_release(self.uid)
        return state

    def _acquire_restore(self, state):
        s = _SENTINEL
        if s is not None:
            s.note_acquire(self.uid, self.name)
        self.inner._acquire_restore(state)

    def __repr__(self):
        return f"SentinelLock({self.name!r}, uid={self.uid})"


# ---------------------------------------------------------------------------
# the process-global sentinel (None = off, the default)
# ---------------------------------------------------------------------------

_SENTINEL: Optional[LockOrderSentinel] = None
_ENABLE_MU = threading.Lock()


def enable_sentinel() -> LockOrderSentinel:
    """Install (or return the already-installed) process sentinel.
    Called by ``Server.__init__`` when ``--sys.lint.lockorder`` is on,
    and directly by tests. Idempotent — concurrent servers share one
    graph, which is the point (the gate orders across servers)."""
    global _SENTINEL
    with _ENABLE_MU:
        if _SENTINEL is None:
            _SENTINEL = LockOrderSentinel()
        return _SENTINEL


def disable_sentinel() -> None:
    """Drop the process sentinel (tests; idempotent). Locks already
    wrapped keep working — their per-acquire check just sees None."""
    global _SENTINEL
    with _ENABLE_MU:
        _SENTINEL = None


def get_sentinel() -> Optional[LockOrderSentinel]:
    return _SENTINEL
