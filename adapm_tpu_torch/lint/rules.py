"""The port's lint rule set: one rule per concurrency/plane discipline
(the twin of the JAX package's `lint/rules.py`, over `adapm_tpu_torch/`).
docs/INVARIANTS.md is the catalog — rule ID, rationale, what fires, how
to suppress; three rules are retargeted to the port, as below.

| id     | discipline                                                   |
|--------|--------------------------------------------------------------|
| APM001 | gate-coverage: the kernel wrappers that read or write a pool |
|        | launch under the process-wide dispatch_gate()                |
| APM002 | no-blocking-under-lock: never .result()/wait/join/sleep/     |
|        | block inside a `with *._lock:` section (lock-narrowing rule) |
| APM003 | skip-wrapper: optional planes are used behind an `is None`   |
|        | guard and register zero metric names at import time         |
| APM004 | raw-thread ban: threading.Thread only in the executor/       |
|        | launcher/DCN/reporter/transport allowlist                    |
| APM005 | in-place reread: a local bound to a pool (or a view or slice |
|        | of it) before an in-place kernel call is not read after it   |
| APM006 | revalidate-before-enqueue: topology read outside the lock +  |
|        | enqueue under it requires an under-lock re-read              |
| APM007 | metric-catalog drift: registered metric names <-> the        |
|        | docs/OBSERVABILITY.md catalog + snapshot schema sections     |
| APM008 | device-API confinement: torch.cuda streams, events, graphs   |
|        | and device setters, and loading a built library, only under  |
|        | device/, ops/kernels.py, parallel/exchange.py and tools/     |

Where the JAX package dispatches jitted programs by name, donates their
buffers and builds them with jax.jit, the port launches hand-written
kernels through the wrappers of ops/kernels.py, updates pools in place
and reaches the card through torch.cuda and ctypes: APM001 names the
wrappers, APM005 the in-place arguments, APM008 the CUDA APIs.

Rules are LEXICAL: they reason about the AST as written (a `with
dispatch_gate():` block, an `is None` test), not about runtime values.
That is the point — the disciplines were designed to be auditable from
the source ("enqueue under the server lock, dispatch never"), and a
lexical checker runs in milliseconds with zero device stack. The cost
is the occasional intentional exception; those carry a justified
`# apm-lint: disable=` suppression (analyzer.py), never a weakened
rule.
"""

import ast
import re
from typing import Dict, List, Optional, Tuple

from .analyzer import (Finding, ModuleInfo, ProjectContext, Rule,
                       terminal_name)

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _iter_functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _with_item_is(item: ast.withitem, names) -> bool:
    """True when a with-item's context expression terminates in one of
    `names` — either the object itself (`with _GATE:`) or a zero-ish
    call (`with dispatch_gate():`)."""
    ctx = item.context_expr
    if isinstance(ctx, ast.Call):
        return terminal_name(ctx.func) in names
    return terminal_name(ctx) in names


def _enclosing_with(mod: ModuleInfo, node: ast.AST, names) -> bool:
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.With) and \
                any(_with_item_is(i, names) for i in anc.items):
            return True
    return False


def _callee_program_name(mod: ModuleInfo,
                         call: ast.Call) -> Optional[str]:
    """Name of the called module-level function, for calls that can
    target a kernel wrapper: a bare name (`drop_set(...)`,
    `fill_gather(...)`) or an imported-module attribute
    (`kernels.sync_round(...)`). Method calls (`self.port.gather(...)`)
    return None — port and Server methods legitimately share names with
    the wrappers they orchestrate."""
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id in mod.imported_names:
        return fn.attr
    return None


def _mentions_handle(node: ast.AST, handle: str) -> bool:
    """True when `node`'s subtree mentions optional-subsystem `handle`:
    an attribute access `x.<handle>`, a bare name `<handle>`, or a
    `getattr(x, "<handle>", ...)` probe."""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr == handle:
            return True
        if isinstance(n, ast.Name) and n.id == handle:
            return True
        if isinstance(n, ast.Call) and terminal_name(n.func) == "getattr":
            if len(n.args) >= 2 and isinstance(n.args[1], ast.Constant) \
                    and n.args[1].value == handle:
                return True
    return False


def _has_none_compare(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Compare) and \
                any(isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops) \
                and any(isinstance(c, ast.Constant) and c.value is None
                        for c in n.comparators):
            return True
    return False


def _terminates(stmts: List[ast.stmt]) -> bool:
    """A statement list that unconditionally leaves the enclosing block
    (the early-return guard shape: `if x is None: return`)."""
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


# ---------------------------------------------------------------------------
# APM001 — gate coverage
# ---------------------------------------------------------------------------

# The kernel wrappers that read or write a pool (ops/kernels.py), and the
# port's main-only gather (device/torchport.py fill_gather). Each is
# called by NAME (a bare name or an imported module's attribute); the
# fused step's kernels (K1/K3 segment forms, K2, K5-K7) launch inside
# ops/fused.py's step functions, which the runner holds in variables and
# calls under its own `with srv.exec.track("main"), _GATE:` blocks, which
# this rule cannot (and need not) see through. A call inside a function
# that is itself one of these sites is the site's body: it runs under
# its caller's gate (a wrapper composing another). Grow this list when a
# kernel that touches a pool appears.
KERNEL_DISPATCH_SITES = frozenset({
    # K1, K3, K8-K13 (ops/kernels.py)
    "routed_gather", "ordered_scatter_add", "write_main_rows",
    "gather_pool", "gather_pool_cold", "gather_cold", "sync_compress",
    "alltoall_put",
    # K14 (its three forms) and K15
    "drop_set", "drop_set_install", "drop_set_zero", "sync_round",
    # device/torchport.py
    "fill_gather",
})

# context managers that ARE the gate at a dispatch site
_GATE_NAMES = frozenset({"dispatch_gate", "_GATE", "_DISPATCH_GATE"})


def _enclosing_function(mod: ModuleInfo, node: ast.AST):
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


class GateCoverageRule(Rule):
    """APM001: every call to a kernel wrapper that reads or writes a pool
    must sit lexically under `with dispatch_gate():` / `with _GATE:`
    (possibly combined: `with srv.exec.track("main"), _GATE:`). Two lock
    domains launching on the same CUDA stream in different orders would
    interleave a K11/K14 call's claim and write launches with another's
    on one claim scratch, and order a set against a gather differently
    from the server's order (docs/EXECUTOR.md)."""

    id = "APM001"
    name = "gate-coverage"
    doc = "kernel wrapper launched outside the dispatch gate"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _callee_program_name(mod, node)
            if name not in KERNEL_DISPATCH_SITES:
                continue
            if _enclosing_with(mod, node, _GATE_NAMES):
                continue
            fn = _enclosing_function(mod, node)
            if fn is not None and fn.name in KERNEL_DISPATCH_SITES:
                continue   # a site's own body: under its caller's gate
            out.append(self.finding(
                mod, node.lineno,
                f"[gate-coverage] kernel wrapper {name}() launched "
                f"outside `with dispatch_gate():` — two ungated launch "
                f"domains interleave their launches on one stream "
                f"(docs/EXECUTOR.md)"))
        return out


# ---------------------------------------------------------------------------
# APM002 — no blocking under the server lock
# ---------------------------------------------------------------------------

# attribute names that identify the guarded mutex in a with-item
_LOCK_ATTRS = frozenset({"_lock"})

# terminal call names that park the calling thread. `wait` on a
# condition variable is exempt below (a condvar RELEASES its lock while
# waiting — that is its contract, not a violation).
_BLOCKING_CALLS = frozenset({
    "result", "wait", "block_until_ready", "join", "sleep", "drain",
    "drain_streams", "block",
})


class NoBlockingUnderLockRule(Rule):
    """APM002: inside a `with <x>._lock:` section, never call
    `.result()`, `.wait()`, `.join()`, `block_until_ready`, `sleep`,
    executor `drain`s, or `.block()`. The lock-narrowing rule
    (docs/EXECUTOR.md): the server lock brackets snapshot +
    revalidation + program ENQUEUE only — a lock held across a device
    wait serializes every producer behind the device, and at
    NestPipe-style scale that is a fleet-wide stall. Condvar waits on
    the lock itself are exempt (they release it)."""

    id = "APM002"
    name = "no-blocking-under-lock"
    doc = "blocking call inside a `with *._lock:` section"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = terminal_name(node.func)
            if name not in _BLOCKING_CALLS:
                continue
            if not _enclosing_with(mod, node, _LOCK_ATTRS):
                continue
            # condvar exemption: `self._cond.wait()` under the condvar's
            # own lock is the parking idiom, not a held-lock wait
            recv = node.func.value \
                if isinstance(node.func, ast.Attribute) else None
            rname = terminal_name(recv) if recv is not None else ""
            if name == "wait" and rname and "cond" in rname.lower():
                continue
            out.append(self.finding(
                mod, node.lineno,
                f"[no-blocking-under-lock] {name}() inside a "
                f"`with *._lock:` section — the lock brackets enqueue "
                f"only, never a wait (lock-narrowing rule, "
                f"docs/EXECUTOR.md)"))
        return out


# ---------------------------------------------------------------------------
# APM003 — skip-wrapper discipline for optional planes
# ---------------------------------------------------------------------------

# Optional-subsystem handles (None when the plane is off). The
# skip-wrapper discipline: feature off = ONE `is None` check on the hot path and
# ZERO registry names — so every call THROUGH one of these attributes
# must sit behind an `is (not) None` guard of that handle (enclosing
# `if`, or a preceding early-return), or bind it to a local first
# (`f = self.fault; if f is not None: f.fire(...)` — the canonical
# form, which this rule never flags).
OPTIONAL_HANDLES = frozenset({
    "fault", "flight", "tracer", "slo", "tier", "prefetch", "recorder",
    "wtrace", "decisions", "policy", "stream",
})

# metric-registry factory methods (import-time registration ban)
_REGISTRY_FACTORIES = frozenset({"counter", "gauge", "histogram"})


class SkipWrapperRule(Rule):
    """APM003: (a) no metric registration at import time — a module
    that registers `flight.*`/`fault.*` names on import makes the
    "off = zero registry names" contract unfalsifiable (the
    metrics_overhead_check pins it at runtime; this pins it in the
    source); (b) a call through an optional-plane handle
    (`srv.fault.fire(...)`) must be guarded by an `is None` check of
    that handle — unguarded uses crash the hot path the moment the
    plane is off."""

    id = "APM003"
    name = "skip-wrapper"
    doc = "optional-plane use without an `is None` guard, or " \
          "import-time metric registration"

    # -- (a) import-time registration ---------------------------------------

    def _import_time_registrations(self, mod: ModuleInfo) -> List[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            is_factory = (isinstance(node.func, ast.Attribute)
                          and node.func.attr in _REGISTRY_FACTORIES)
            is_group = terminal_name(node.func) == "CounterGroup"
            if not (is_factory or is_group):
                continue
            if any(isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))
                   for a in mod.ancestors(node)):
                continue  # inside a function: runtime registration
            out.append(self.finding(
                mod, node.lineno,
                "[skip-wrapper] metric registered at import time — "
                "registration must happen at construction, behind the "
                "plane's knob, so a disabled plane leaves zero "
                "registry names (docs/OBSERVABILITY.md overhead "
                "contract)"))
        return out

    # -- (b) unguarded handle use -------------------------------------------

    @staticmethod
    def _handle_in_chain(call: ast.Call) -> Optional[str]:
        """The optional-handle attribute a call reaches through, e.g.
        `srv.flight.freshness.note_push(...)` -> "flight". Only the
        RECEIVER chain counts (the callee attr itself is the method)."""
        node = call.func
        if not isinstance(node, ast.Attribute):
            return None
        node = node.value  # skip the method name
        while isinstance(node, ast.Attribute):
            if node.attr in OPTIONAL_HANDLES:
                return node.attr
            node = node.value
        return None

    @staticmethod
    def _guarded(mod: ModuleInfo, call: ast.Call, handle: str) -> bool:
        # enclosing if/while/ternary whose test None-checks the handle
        for anc in mod.ancestors(call):
            test = getattr(anc, "test", None)
            if isinstance(anc, (ast.If, ast.While, ast.IfExp)) and \
                    test is not None and _has_none_compare(test) and \
                    _mentions_handle(test, handle):
                return True
            # preceding early-return guard in any enclosing block:
            # `if x.handle is None: return` before this statement
            for field in ("body", "orelse", "finalbody"):
                block = getattr(anc, field, None)
                if not isinstance(block, list):
                    continue
                for stmt in block:
                    if stmt.lineno >= call.lineno:
                        break
                    if isinstance(stmt, ast.If) and \
                            _has_none_compare(stmt.test) and \
                            _mentions_handle(stmt.test, handle) and \
                            _terminates(stmt.body):
                        return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break  # guards don't cross function boundaries
        return False

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        out = self._import_time_registrations(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            handle = self._handle_in_chain(node)
            if handle is None:
                continue
            if self._guarded(mod, node, handle):
                continue
            out.append(self.finding(
                mod, node.lineno,
                f"[skip-wrapper] call through optional handle "
                f"`.{handle}` without an `is None` guard — the plane "
                f"is None when off; bind it to a local and test once "
                f"(`h = x.{handle}` / `if h is not None:`), the "
                f"skip-wrapper discipline"))
        return out


# ---------------------------------------------------------------------------
# APM004 — raw-thread ban
# ---------------------------------------------------------------------------

# Paths (repo-relative prefixes/suffixes) still allowed to own threads:
# the executor's worker pool IS the thread plane; the launcher and the
# DCN van manage process-boundary I/O the executor cannot subsume; the
# metrics reporter is import-gated; the transport plane's threads are
# process-boundary I/O by nature (socket readers, membership beats that
# must outlive the executor into the teardown window, the loopback
# drainer). The JAX package's list, read over the port's tree.
RAW_THREAD_ALLOWLIST = (
    "adapm_tpu_torch/exec/",
    "adapm_tpu_torch/launcher.py",
    "adapm_tpu_torch/parallel/dcn.py",
    "adapm_tpu_torch/obs/reporter.py",
    "adapm_tpu_torch/net/",
)


class RawThreadBanRule(Rule):
    """APM004: `threading.Thread(...)` outside the allowlist. The executor
    subsumes every subsystem thread (sync loop, prefetch pipeline, tier
    maintenance, serve dispatchers, SLO ticks) into executor streams —
    ordered, drained at shutdown, visible in queue/overlap accounting.
    A raw thread has none of that; route the work through
    `Server.exec.submit` instead, or carry a justified suppression."""

    id = "APM004"
    name = "raw-thread-ban"
    doc = "threading.Thread outside the executor/launcher/dcn/reporter " \
          "allowlist"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        if any(mod.relpath.startswith(p) or mod.relpath == p
               for p in RAW_THREAD_ALLOWLIST):
            return []
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            is_thread = (isinstance(fn, ast.Attribute)
                         and fn.attr == "Thread"
                         and terminal_name(fn.value) == "threading") or \
                        (isinstance(fn, ast.Name) and fn.id == "Thread")
            if not is_thread:
                continue
            out.append(self.finding(
                mod, node.lineno,
                "[raw-thread-ban] threading.Thread outside the "
                "allowlist — background work runs as executor-stream "
                "programs (Server.exec.submit) so it is ordered, "
                "drained at shutdown, and visible in the exec.* "
                "accounting (docs/EXECUTOR.md)"))
        return out


# ---------------------------------------------------------------------------
# APM005 — in-place reread
# ---------------------------------------------------------------------------

# The kernel wrappers that update pools (or an output buffer) in place,
# with the positional arguments each updates. Where the JAX package
# donates a buffer and returns its replacement, the port writes into the
# caller's tensor: a local bound BEFORE the call to that tensor, or to a
# view or slice of it, shares its storage and holds the NEW rows after
# the call. Reading it afterwards as the old rows is the port's
# use-after-donate.
INPLACE_ARGS: Dict[str, Tuple[int, ...]] = {
    "ordered_scatter_add": (0,),
    "ordered_scatter_add_segments": (0,),
    "ordered_scatter_fold": (0,),
    "write_main_rows": (0,),
    "gather_pool": (9,),
    "gather_pool_cold": (13,),
    "drop_set": (0,),
    "drop_set_install": (0, 1),
    "drop_set_zero": (0,),
    "sync_round": (0, 1, 2),
}

# methods and attributes whose result may share the receiver's storage
_VIEW_METHODS = frozenset({
    "view", "view_as", "reshape", "reshape_as", "flatten", "unflatten",
    "narrow", "select", "squeeze", "unsqueeze", "expand", "expand_as",
    "t", "transpose", "permute", "movedim", "unfold", "split", "chunk",
    "unbind", "as_strided", "detach", "diagonal", "contiguous",
})
_VIEW_ATTRS = frozenset({"T", "mT", "H", "data", "real", "imag"})


def _basic_index(node: ast.AST) -> bool:
    """A subscript index that slices (a view), not a gather: constants,
    slices, `...`, None and tuples of them."""
    if isinstance(node, ast.Tuple):
        return all(_basic_index(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp):
        return isinstance(node.operand, ast.Constant)
    return isinstance(node, (ast.Constant, ast.Slice))


def _view_of(node: ast.AST, key: str) -> bool:
    """Whether `node` is the expression `key` itself, or a view or slice
    of it (a chain of basic subscripts and view methods)."""
    while True:
        if ast.unparse(node) == key:
            return True
        if isinstance(node, ast.Subscript) and _basic_index(node.slice):
            node = node.value
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _VIEW_METHODS:
            node = node.func.value
        elif isinstance(node, ast.Attribute) and node.attr in _VIEW_ATTRS:
            node = node.value
        else:
            return False


class InPlaceRereadRule(Rule):
    """APM005: for a call of an in-place kernel wrapper (INPLACE_ARGS), a
    local bound before the call (in the same function) to an updated
    argument, or to a view or slice of it, must not be read after the
    call before it is bound again. The tensor itself may be read: it
    holds the new rows, as the caller meant. Clone first to keep the old
    rows."""

    id = "APM005"
    name = "in-place-reread"
    doc = "view of an in-place pool argument read after the kernel call"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        out = []
        for fn in _iter_functions(mod.tree):
            out.extend(self._check_function(mod, fn))
        return out

    def _check_function(self, mod: ModuleInfo, fn) -> List[Finding]:
        out = []
        loads: Dict[str, List[ast.Name]] = {}
        stores: Dict[str, List[int]] = {}
        binds: List[Tuple[str, ast.AST, int]] = []   # (name, value, line)
        for node in ast.walk(fn):
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    loads.setdefault(node.id, []).append(node)
                else:
                    stores.setdefault(node.id, []).append(node.lineno)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                binds.append((node.targets[0].id, node.value,
                              getattr(node, "end_lineno", node.lineno)))
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _callee_program_name(mod, node)
            updated = INPLACE_ARGS.get(name or "")
            if not updated:
                continue
            end = getattr(node, "end_lineno", node.lineno)
            for idx in updated:
                if idx >= len(node.args):
                    continue
                key = ast.unparse(node.args[idx])
                for var, value, bline in binds:
                    if bline >= node.lineno or var == key or \
                            not _view_of(value, key):
                        continue
                    # alive until the first rebind after the call
                    rebinds = [ln for ln in stores.get(var, ())
                               if ln > end]
                    horizon = min(rebinds) if rebinds else float("inf")
                    bad = [n.lineno for n in loads.get(var, ())
                           if end < n.lineno < horizon]
                    if bad:
                        out.append(self.finding(
                            mod, min(bad),
                            f"[in-place-reread] `{var}` (line {bline}) "
                            f"shares storage with `{key}`, which "
                            f"{name}() at line {node.lineno} updates in "
                            f"place: it holds the new rows now — clone "
                            f"before the call to keep the old ones"))
        return out


# ---------------------------------------------------------------------------
# APM006 — revalidate before enqueue
# ---------------------------------------------------------------------------

# the versioned placement state the optimistic planners snapshot
_VERSION_ATTRS = frozenset({"topology_version"})

# store/server entry points whose under-lock call constitutes a
# placement-dependent program ENQUEUE
_ENQUEUE_CALLS = frozenset({
    "_pull", "_push", "gather", "stage_gather", "scatter_add",
    "set_rows", "replica_create", "sync_replicas", "relocate_rows",
})


class RevalidateBeforeEnqueueRule(Rule):
    """APM006: a function that snapshots `topology_version` OUTSIDE the
    server lock (optimistic planning) and later enqueues a
    placement-dependent program UNDER the lock must re-read the version
    inside that locked section (`if srv.topology_version != tv: plan =
    None`). Skipping the re-check dispatches a plan computed against a
    topology that may have moved — the staged-pull/plan-cache
    correctness rule, applied at every enqueue site."""

    id = "APM006"
    name = "revalidate-before-enqueue"
    doc = "optimistic topology snapshot without an under-lock re-check"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        out = []
        for fn in _iter_functions(mod.tree):
            out.extend(self._check_function(mod, fn))
        return out

    def _check_function(self, mod: ModuleInfo, fn) -> List[Finding]:
        version_reads = []   # (line, under_lock)
        lock_blocks = []     # ast.With nodes guarding _lock
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and \
                    node.attr in _VERSION_ATTRS and \
                    isinstance(node.ctx, ast.Load):
                version_reads.append(
                    (node.lineno,
                     _enclosing_with(mod, node, _LOCK_ATTRS)))
            elif isinstance(node, ast.With) and \
                    any(_with_item_is(i, _LOCK_ATTRS)
                        for i in node.items):
                lock_blocks.append(node)
        outside = [ln for ln, locked in version_reads if not locked]
        if not outside:
            return []
        first_read = min(outside)
        out = []
        for wb in lock_blocks:
            if wb.lineno < first_read:
                continue
            enqueues = [n for n in ast.walk(wb)
                        if isinstance(n, ast.Call)
                        and terminal_name(n.func) in _ENQUEUE_CALLS]
            if not enqueues:
                continue
            revalidated = any(
                isinstance(n, ast.Attribute)
                and n.attr in _VERSION_ATTRS
                and isinstance(n.ctx, ast.Load)
                for n in ast.walk(wb))
            if not revalidated:
                out.append(self.finding(
                    mod, enqueues[0].lineno,
                    f"[revalidate-before-enqueue] enqueue under the "
                    f"lock after an out-of-lock topology_version "
                    f"snapshot (line {first_read}) without re-reading "
                    f"it under the lock — revalidate or drop the "
                    f"optimistic plan (the staged-pull discipline)"))
        return out


# ---------------------------------------------------------------------------
# APM007 — metric-catalog drift
# ---------------------------------------------------------------------------

_METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_<>{}]+)+$")


class _RegistrationScanner(ast.NodeVisitor):
    """Collect metric registrations from one module: literal names,
    dynamic prefixes (f-strings), CounterGroup expansions, and
    one-level registering helpers (`def _hist(name): ...
    registry.histogram(name, ...)` / `mk = lambda n:
    registry.counter(f"plan_cache.{n}")`)."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.literals: List[Tuple[str, int]] = []   # (name, line)
        self.prefixes: List[Tuple[str, int]] = []   # (prefix, line)
        # helper name -> "" (identity: literal arg IS the name) or the
        # f-string's literal prefix (name = prefix + arg)
        self.helpers: Dict[str, str] = {}
        # module-level literal string tuples (incl. class attributes),
        # for `for name in FIELDS:` expansion
        self.str_tuples: Dict[str, Tuple[str, ...]] = {}
        self._collect_tuples()
        self._collect_helpers()

    # -- literal tuple assignments ------------------------------------------

    def _collect_tuples(self):
        for node in ast.walk(self.mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, (ast.Tuple, ast.List)):
                continue
            elts = node.value.elts
            if not elts or not all(isinstance(e, ast.Constant)
                                   and isinstance(e.value, str)
                                   for e in elts):
                continue
            vals = tuple(e.value for e in elts)
            for t in node.targets:
                n = terminal_name(t)
                if n:
                    self.str_tuples[n] = vals

    # -- registering helpers -------------------------------------------------

    @staticmethod
    def _fstring_split(js: ast.JoinedStr) -> Optional[Tuple[str, str]]:
        """(prefix, param) for a single-placeholder f-string like
        f"plan_cache.{n}"; None for anything more complex."""
        prefix = ""
        param = None
        for part in js.values:
            if isinstance(part, ast.Constant):
                if param is not None and part.value:
                    return None  # trailing literal: too complex
                prefix += str(part.value)
            elif isinstance(part, ast.FormattedValue):
                if param is not None or \
                        not isinstance(part.value, ast.Name):
                    return None
                param = part.value.id
        return (prefix, param) if param is not None else None

    def _collect_helpers(self):
        for node in ast.walk(self.mod.tree):
            fn_name, params, body_calls = None, None, None
            if isinstance(node, ast.FunctionDef):
                fn_name = node.name
                params = [a.arg for a in node.args.args]
                body_calls = node
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Lambda):
                fn_name = terminal_name(node.targets[0])
                params = [a.arg for a in node.value.args.args]
                body_calls = node.value
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.IfExp):
                # `mk = (lambda n: reg...) if use_reg else (lambda n: ...)`
                for half in (node.value.body, node.value.orelse):
                    if isinstance(half, ast.Lambda):
                        self._maybe_helper(
                            terminal_name(node.targets[0]),
                            [a.arg for a in half.args.args], half)
                continue
            if fn_name is None or body_calls is None:
                continue
            self._maybe_helper(fn_name, params, body_calls)

    def _maybe_helper(self, fn_name, params, scope):
        if not fn_name or not params:
            return
        for call in ast.walk(scope):
            if not isinstance(call, ast.Call):
                continue
            if not (isinstance(call.func, ast.Attribute)
                    and call.func.attr in _REGISTRY_FACTORIES):
                continue
            if not call.args:
                continue
            arg = call.args[0]
            if isinstance(arg, ast.Name) and arg.id == params[0]:
                self.helpers.setdefault(fn_name, "")
            elif isinstance(arg, ast.JoinedStr):
                split = self._fstring_split(arg)
                if split is not None and split[1] == params[0]:
                    self.helpers.setdefault(fn_name, split[0])

    # -- call sites ----------------------------------------------------------

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        fn = node.func
        if isinstance(fn, ast.Attribute) and \
                fn.attr in _REGISTRY_FACTORIES and node.args:
            self._record(node.args[0], node)
            return
        tname = terminal_name(fn)
        if tname == "CounterGroup" and len(node.args) >= 3:
            prefix_node, keys_node = node.args[1], node.args[2]
            if isinstance(prefix_node, ast.Constant):
                prefix = str(prefix_node.value)
                keys = None
                if isinstance(keys_node, (ast.Tuple, ast.List)) and \
                        all(isinstance(e, ast.Constant)
                            for e in keys_node.elts):
                    keys = [e.value for e in keys_node.elts]
                elif isinstance(keys_node, ast.Name):
                    keys = self.str_tuples.get(keys_node.id)
                if keys:
                    for k in keys:
                        self.literals.append(
                            (f"{prefix}.{k}", node.lineno))
                else:
                    self.prefixes.append((prefix + ".", node.lineno))
            return
        if tname in self.helpers and node.args:
            prefix = self.helpers[tname]
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str):
                self.literals.append((prefix + arg.value, node.lineno))
            else:
                self._record_dynamic(prefix, arg, node)

    def _record(self, arg: ast.AST, node: ast.Call):
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            self.literals.append((arg.value, node.lineno))
        elif isinstance(arg, ast.JoinedStr):
            prefix = ""
            for part in arg.values:
                if isinstance(part, ast.Constant):
                    prefix += str(part.value)
                else:
                    break
            if prefix:
                self.prefixes.append((prefix, node.lineno))
        elif isinstance(arg, ast.Name):
            # loop variable over a literal tuple in this module:
            # `for name in SyncStats.FIELDS: reg.gauge(f"sync.{name}")`
            # is handled by the f-string branch; a bare Name arg is a
            # helper param (handled in _collect_helpers) or opaque
            pass

    def _record_dynamic(self, prefix: str, arg: ast.AST, node: ast.Call):
        if prefix:
            self.prefixes.append((prefix, node.lineno))


class MetricCatalogRule(Rule):
    """APM007: the metric namespace must agree across three surfaces —
    the registration call sites (`registry.counter("kv.pull_s")`, ...),
    the docs/OBSERVABILITY.md "Metric catalog" table, and the
    `metrics_snapshot()` schema section list. v1->v9 schema churn had
    no mechanical check; this rule is it. Literal registrations must
    appear in the catalog (and their section in the schema block);
    literal catalog rows of registry kinds (counter/gauge/histogram)
    must be registered somewhere (exactly, or under a dynamic
    registration prefix like `fault.injections.`). Rows whose kind is
    derived/merged/snapshot describe computed snapshot surfaces, not
    registry names, and rows with `…` are explicitly non-exhaustive —
    both are exempt from the code-presence direction."""

    id = "APM007"
    name = "metric-catalog-drift"
    doc = "metric names out of sync between code and " \
          "docs/OBSERVABILITY.md"

    # doc rows of these kinds are not registry registrations
    _EXEMPT_KINDS = ("derived", "merged", "snapshot")

    def check_project(self, ctx: ProjectContext) -> List[Finding]:
        doc = ctx.docs.get("observability")
        if doc is None:
            return []
        doc_path, doc_text = doc
        literals: List[Tuple[str, str, int]] = []  # (name, path, line)
        prefixes: List[str] = []
        for mod in ctx.modules:
            if mod.relpath.endswith("obs/metrics.py"):
                continue  # the registry itself, not a call site
            if "/lint/" in mod.relpath:
                continue  # the linter registers nothing
            sc = _RegistrationScanner(mod)
            sc.visit(mod.tree)
            literals.extend((n, mod.relpath, ln) for n, ln in sc.literals)
            prefixes.extend(p for p, _ in sc.prefixes)
        cat_literals, cat_patterns, exempt, row_lines = \
            self._parse_catalog(doc_text)
        sections = self._parse_schema_sections(doc_text)
        out: List[Finding] = []
        # code -> doc
        for name, path, line in sorted(set(literals)):
            sec = name.split(".", 1)[0]
            if sections and sec not in sections:
                out.append(self.finding(
                    path, line,
                    f"[metric-catalog-drift] metric `{name}`'s section "
                    f"`{sec}` is not in the metrics_snapshot() schema "
                    f"block of docs/OBSERVABILITY.md"))
            if name in cat_literals or name in exempt:
                continue
            if any(name.startswith(p) for p in cat_patterns):
                continue
            out.append(self.finding(
                path, line,
                f"[metric-catalog-drift] metric `{name}` is registered "
                f"here but missing from the docs/OBSERVABILITY.md "
                f"catalog table — add a row (name, kind, unit, "
                f"meaning)"))
        # doc -> code
        code_names = {n for n, _, _ in literals}
        for name in sorted(cat_literals - exempt):
            if name in code_names:
                continue
            if any(name.startswith(p) for p in prefixes):
                continue
            out.append(self.finding(
                doc_path, row_lines.get(name, 1),
                f"[metric-catalog-drift] catalog row `{name}` has no "
                f"registration in the code — stale doc (delete the "
                f"row) or a renamed metric (fix the name)"))
        return out

    # -- doc parsing ---------------------------------------------------------

    def _parse_catalog(self, text: str):
        """(literal names, pattern prefixes, exempt names, name->line)
        from the `## Metric catalog` table. A backticked token expands
        on `/` and `,`; fragments without a dot re-prefix with the
        row's section; tokens containing `<`/`{`/`…`/`*` become
        prefix patterns; rows whose kind is derived/merged/snapshot or
        whose name cell carries `…` are exempt from doc->code."""
        lines = text.splitlines()
        in_catalog = False
        literals: set = set()
        patterns: set = set()
        exempt: set = set()
        row_lines: Dict[str, int] = {}
        for i, line in enumerate(lines, start=1):
            if line.startswith("## "):
                in_catalog = line.strip() == "## Metric catalog"
                continue
            if not in_catalog or not line.startswith("|"):
                continue
            cells = [c.strip() for c in line.strip("|").split("|")]
            if len(cells) < 2 or set(cells[0]) <= {"-", " "}:
                continue
            name_cell, kind_cell = cells[0], cells[1]
            row_exempt = any(k in kind_cell.lower()
                             for k in self._EXEMPT_KINDS) or \
                "…" in name_cell or "..." in name_cell
            tokens = re.findall(r"`([^`]+)`", name_cell)
            # tokens like "(+ per-stream `.<stream>`)" are suffix
            # patterns for the preceding name: note the base as a prefix
            section = None
            for tok in tokens:
                tok = tok.strip()
                if tok.startswith("."):
                    if section:
                        patterns.add(section + ".")
                    continue
                for frag in re.split(r"[/,]", tok):
                    frag = frag.strip()
                    if not frag or frag in ("…", "..."):
                        continue
                    if "." not in frag and section:
                        frag = f"{section}.{frag}"
                    if any(c in frag for c in "<{*…"):
                        prefix = re.split(r"[<{*…]", frag)[0]
                        if prefix:
                            patterns.add(prefix)
                        continue
                    if not _METRIC_NAME_RE.match(frag):
                        continue
                    section = frag.split(".", 1)[0]
                    literals.add(frag)
                    row_lines.setdefault(frag, i)
                    if row_exempt:
                        exempt.add(frag)
        return literals, patterns, exempt, row_lines

    @staticmethod
    def _parse_schema_sections(text: str) -> set:
        """Section names from the metrics_snapshot() schema block
        (`"kv": {...}` entries in the first fenced block after the
        heading)."""
        m = re.search(r"##\s*`Server\.metrics_snapshot\(\)`.*?```(.*?)```",
                      text, re.S)
        if m is None:
            return set()
        return set(re.findall(r'"([a-z_]+)":\s*\{', m.group(1)))


# ---------------------------------------------------------------------------
# APM008 — device-API confinement
# ---------------------------------------------------------------------------

# torch.cuda's stream, event, graph and device-setter APIs: ordering work
# on the card, capturing it, choosing the card
_CUDA_APIS = frozenset({
    "Stream", "ExternalStream", "StreamContext", "stream", "current_stream",
    "default_stream", "set_stream", "Event", "synchronize",
    "CUDAGraph", "graph", "graphs", "make_graphed_callables",
    "graph_pool_handle", "set_device", "device",
})
# loading a built library: ctypes and PyTorch's extension loaders
_CTYPES_LOADERS = frozenset({"CDLL", "cdll", "PyDLL", "LoadLibrary"})
_TORCH_LOADERS = frozenset({"load_library", "load", "load_inline"})

# The places allowed to touch them: the device port and its CUDA seam
# (device/), the kernel wrappers that build, load and launch the kernels
# (ops/kernels.py), the IPC slabs of the collective exchange
# (parallel/exchange.py), and the kernel-variant wrappers of tools/*,
# which build, bind and time edited kernel sources as ops/kernels.py does
# its own. Everything else reaches the card through them, so the device
# plane stays one seam.
DEVICE_PLANE_ALLOWLIST = (
    "adapm_tpu_torch/device/",
    "adapm_tpu_torch/ops/kernels.py",
    "adapm_tpu_torch/parallel/exchange.py",
    "adapm_tpu_torch/tools/",
)


def _dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class DeviceApiConfinementRule(Rule):
    """APM008: torch.cuda's streams, events, graphs and device setters,
    and the loading of a built library (`ctypes.CDLL`, `torch.ops.
    load_library`, `torch.utils.cpp_extension.load`), only under
    DEVICE_PLANE_ALLOWLIST. A use anywhere else re-opens the tree-wide-
    edit problem the device port closed: route it through
    device/cuda.py or a kernel wrapper. Intentional exceptions carry
    justified suppressions, never a widened allowlist
    (docs/INVARIANTS.md#apm008)."""

    id = "APM008"
    name = "device-api-confinement"
    doc = "torch.cuda stream/graph/device API or library loading " \
          "outside the device plane"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        if any(mod.relpath.startswith(p)
               for p in DEVICE_PLANE_ALLOWLIST):
            return []
        out = []
        for node in ast.walk(mod.tree):
            what = None
            if isinstance(node, ast.Attribute) and \
                    node.attr in _CUDA_APIS and \
                    (_dotted(node.value) or "").endswith("torch.cuda"):
                what = f"torch.cuda.{node.attr}"
            elif isinstance(node, ast.Call):
                name = _dotted(node.func) or ""
                head, _, tail = name.rpartition(".")
                if (tail in _CTYPES_LOADERS and "ctypes" in head.split(".")) \
                        or (tail in _TORCH_LOADERS and
                            (head.endswith("torch.ops")
                             or head.endswith("cpp_extension"))):
                    what = name
            elif isinstance(node, ast.ImportFrom):
                names = {a.name for a in node.names}
                mod_name = node.module or ""
                banned = names & (_CUDA_APIS if mod_name == "torch.cuda"
                                  else _CTYPES_LOADERS if mod_name == "ctypes"
                                  else frozenset())
                if banned:
                    what = f"from {mod_name} import {sorted(banned)}"
            if what is None:
                continue
            out.append(self.finding(
                mod, node.lineno,
                f"[device-api-confinement] {what} outside the device "
                f"plane — order, capture and choose the card through "
                f"device/cuda.py, and launch through ops/kernels.py, so "
                f"the device plane stays one seam "
                f"(docs/INVARIANTS.md#apm008)"))
        return out


# ---------------------------------------------------------------------------


def default_rules() -> List[Rule]:
    """The shipping rule set, in ID order (analyzer entry point)."""
    return [
        GateCoverageRule(),
        NoBlockingUnderLockRule(),
        SkipWrapperRule(),
        RawThreadBanRule(),
        InPlaceRereadRule(),
        RevalidateBeforeEnqueueRule(),
        MetricCatalogRule(),
        DeviceApiConfinementRule(),
    ]
