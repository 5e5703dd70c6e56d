"""The port's lint plane: the AST invariant analyzer (the twin of the
JAX package's `lint/analyzer.py`, retargeted to `adapm_tpu_torch/`).

The port's correctness rests on a handful of concurrency disciplines
that the JAX package wrote down and the port keeps: the dispatch gate
around every kernel launch that reads or writes a pool, the
lock-narrowing rule (the server lock brackets enqueue, never a wait),
the skip-wrapper contract of optional planes, the topology
revalidate-under-lock pattern, and the device-API seam. This module
checks them mechanically over the port's own ASTs; docs/INVARIANTS.md
is the catalog of the rules, and `rules.py` says where the port's
rules differ from the JAX package's (APM001, APM005, APM008).

Shape:

  - A **Rule** owns an ID (``APM001``..), a short name, and a
    ``check_module`` hook (per-file AST walk) and/or a
    ``check_project`` hook (whole-tree facts, e.g. the metric-catalog
    drift rule needs every registration site AND the docs). Rules are
    registered in ``rules.py`` and looked up through
    ``default_rules()``.
  - The **Analyzer** parses every file once, builds shared project
    facts (import aliases), runs the rules, applies suppressions, and
    emits a deterministic report.
  - A **suppression** is an in-source escape hatch::

        with self._lock:
            s.block()  # apm-lint: disable=APM002 a racing op would
                       # replace the buffer being blocked on

    It must name the rule AND carry a non-empty justification, covers
    findings on its own line, the rest of its contiguous comment
    block, and the first code line after the block (justifications
    routinely wrap), and FAILS the run when unused (``APM000``) — a
    suppression that outlives its violation is stale documentation,
    deleted, not kept. The meta-rule APM000 also covers malformed
    suppressions and unparseable files.
  - Reports: ``Report.to_json()`` is byte-deterministic for a given
    tree (sorted findings, repo-relative posix paths, no timestamps),
    ``Report.to_text()`` is the human ``path:line: APM00N [name]
    message`` form.

Run it as ``python -m adapm_tpu_torch.lint`` (zero unsuppressed
findings, zero unused suppressions) or programmatically::

    from adapm_tpu_torch.lint import Analyzer
    rep = Analyzer(root).run()
    assert not rep.findings, rep.to_text()

Pure stdlib (ast/re/json): the linter imports in any environment the
package sources exist in, device stack present or not.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location (path is repo-relative,
    posix separators — part of the deterministic-report contract)."""

    path: str
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclasses.dataclass
class Suppression:
    """One ``# apm-lint: disable=APM00N <justification>`` comment."""

    path: str
    line: int            # line the comment sits on (1-based)
    rules: Tuple[str, ...]
    justification: str
    used: bool = False


# the suppression-comment shape: "apm-lint: disable=" + one or more
# comma-separated rule ids + the (required) justification text
_SUPPRESS_RE = re.compile(
    r"#\s*apm-lint:\s*disable=([A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)"
    r"[ \t]*(.*)$")


class ModuleInfo:
    """One parsed source file plus the per-file facts rules share:
    the AST (with parent back-links), source lines, and the set of
    names bound by imports (used to tell a module-attribute call
    ``kernels.drop_set(...)`` from a method call ``self.port.gather(...)``
    — only the former can be a kernel wrapper)."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._apm_parent = node  # type: ignore[attr-defined]
        self.imported_names = self._collect_imports()

    def _collect_imports(self) -> set:
        names = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    names.add(a.asname or a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    names.add(a.asname or a.name)
        return names

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return getattr(node, "_apm_parent", None)

    def ancestors(self, node: ast.AST):
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)


class ProjectContext:
    """Whole-tree facts shared by the rules: every parsed module and the
    doc sources project rules read (docs/OBSERVABILITY.md for the
    catalog-drift rule)."""

    def __init__(self, modules: Sequence[ModuleInfo],
                 docs: Optional[Dict[str, Tuple[str, str]]] = None):
        self.modules = list(modules)
        # docs: logical name -> (relpath, text)
        self.docs = dict(docs or {})


def terminal_name(node: ast.AST) -> Optional[str]:
    """The rightmost identifier of a Name/Attribute chain (``x`` of
    ``a.b.x``), or None for anything else."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


class Rule:
    """Base class. Subclasses set ``id``/``name``/``doc`` and override
    one (or both) of the hooks."""

    id = "APM000"
    name = "meta"
    doc = ""

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        return []

    def check_project(self, ctx: ProjectContext) -> List[Finding]:
        return []

    def finding(self, mod_or_path, line: int, message: str) -> Finding:
        path = mod_or_path.relpath if isinstance(mod_or_path, ModuleInfo) \
            else mod_or_path
        return Finding(path=path, line=line, rule=self.id, message=message)


@dataclasses.dataclass
class Report:
    """Analyzer output: post-suppression findings (sorted), the
    suppressions that fired, and file/rule accounting."""

    findings: List[Finding]
    suppressions_used: List[Suppression]
    files_scanned: int
    rules: List[str]

    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> str:
        """Deterministic (same tree -> byte-identical) JSON report —
        sorted findings, sorted keys, no timestamps."""
        payload = {
            "version": 1,
            "files_scanned": self.files_scanned,
            "rules": sorted(self.rules),
            "findings": [dataclasses.asdict(f)
                         for f in sorted(self.findings)],
            "suppressions_used": [
                {"path": s.path, "line": s.line,
                 "rules": sorted(s.rules),
                 "justification": s.justification}
                for s in sorted(self.suppressions_used,
                                key=lambda s: (s.path, s.line))],
        }
        return json.dumps(payload, indent=2, sort_keys=True) + "\n"

    def to_text(self) -> str:
        if not self.findings:
            return (f"adapm-lint: clean ({self.files_scanned} files, "
                    f"{len(self.rules)} rules, "
                    f"{len(self.suppressions_used)} suppressions used)\n")
        out = [f.format() for f in sorted(self.findings)]
        out.append(f"adapm-lint: {len(self.findings)} finding(s) over "
                   f"{self.files_scanned} files")
        return "\n".join(out) + "\n"


class Analyzer:
    """Parse -> facts -> rules -> suppressions -> report (module
    docstring). ``root`` anchors the repo-relative paths in findings;
    ``paths`` defaults to every ``.py`` under ``<root>/adapm_tpu_torch``;
    ``docs`` maps logical doc names
    to file paths (default: ``observability`` ->
    ``<root>/docs/OBSERVABILITY.md`` when present)."""

    def __init__(self, root: str, rules: Optional[Sequence[Rule]] = None,
                 paths: Optional[Sequence[str]] = None,
                 docs: Optional[Dict[str, str]] = None):
        self.root = os.path.abspath(root)
        if rules is None:
            from .rules import default_rules
            rules = default_rules()
        self.rules = list(rules)
        self._paths = list(paths) if paths is not None else None
        if docs is None:
            obs = os.path.join(self.root, "docs", "OBSERVABILITY.md")
            docs = {"observability": obs} if os.path.exists(obs) else {}
        self._doc_paths = docs

    # -- inputs --------------------------------------------------------------

    def _default_paths(self) -> List[str]:
        pkg = os.path.join(self.root, "adapm_tpu_torch")
        out = []
        for dirpath, dirnames, filenames in os.walk(pkg):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
        return out

    def _relpath(self, path: str) -> str:
        rel = os.path.relpath(os.path.abspath(path), self.root)
        return rel.replace(os.sep, "/")

    # -- suppressions --------------------------------------------------------

    def _collect_suppressions(self, mod: ModuleInfo,
                              meta: List[Finding]) -> List[Suppression]:
        # real COMMENT tokens only (tokenize): a suppression-shaped
        # string literal — a doc example, this very regex — must not
        # create a suppression
        sups = []
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(mod.source).readline))
        except tokenize.TokenError:
            return sups
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            i = tok.start[0]
            m = _SUPPRESS_RE.search(tok.string)
            if m is None:
                continue
            rules = tuple(r.strip() for r in m.group(1).split(","))
            just = m.group(2).strip()
            if not just:
                meta.append(Finding(
                    path=mod.relpath, line=i, rule="APM000",
                    message="suppression without justification: "
                            "'# apm-lint: disable=<RULE> <why>' — the "
                            "reason is the point (docs/INVARIANTS.md "
                            "suppression policy)"))
                continue
            sups.append(Suppression(mod.relpath, i, rules, just))
        return sups

    @staticmethod
    def _suppressed_lines(mod: ModuleInfo, s: Suppression) -> List[int]:
        """Lines a suppression covers: its own line (trailing-comment
        style), the rest of its contiguous comment block, and the first
        code line after the block (comment-above-the-statement style —
        justifications routinely wrap over several comment lines)."""
        lines = [s.line]
        i = s.line  # 1-based; mod.lines[i] is the NEXT line
        while i < len(mod.lines):
            stripped = mod.lines[i].strip()
            lines.append(i + 1)
            if stripped and not stripped.startswith("#"):
                break  # first code line: covered, stop
            i += 1
        return lines

    def _apply_suppressions(self, modules: List[ModuleInfo],
                            findings: List[Finding],
                            sups: List[Suppression]) -> List[Finding]:
        by_rel = {m.relpath: m for m in modules}
        by_loc: Dict[Tuple[str, int], List[Suppression]] = {}
        for s in sups:
            for ln in self._suppressed_lines(by_rel[s.path], s):
                by_loc.setdefault((s.path, ln), []).append(s)
        kept = []
        for f in findings:
            hit = None
            for s in by_loc.get((f.path, f.line), ()):
                if f.rule in s.rules:
                    hit = s
                    break
            if hit is not None:
                hit.used = True
            else:
                kept.append(f)
        return kept

    # -- run -----------------------------------------------------------------

    def run(self) -> Report:
        paths = self._paths if self._paths is not None \
            else self._default_paths()
        meta: List[Finding] = []
        modules: List[ModuleInfo] = []
        for p in paths:
            rel = self._relpath(p)
            try:
                with open(p, "r", encoding="utf-8") as fh:
                    src = fh.read()
                modules.append(ModuleInfo(p, rel, src))
            except (OSError, SyntaxError, ValueError) as e:
                meta.append(Finding(
                    path=rel, line=getattr(e, "lineno", 1) or 1,
                    rule="APM000",
                    message=f"unparseable source: "
                            f"{type(e).__name__}: {e}"))
        docs = {}
        for name, p in self._doc_paths.items():
            with open(p, "r", encoding="utf-8") as fh:
                docs[name] = (self._relpath(p), fh.read())
        ctx = ProjectContext(modules, docs=docs)

        findings: List[Finding] = []
        for rule in self.rules:
            for mod in modules:
                findings.extend(rule.check_module(mod, ctx))
            findings.extend(rule.check_project(ctx))

        sups: List[Suppression] = []
        for mod in modules:
            sups.extend(self._collect_suppressions(mod, meta))
        findings = self._apply_suppressions(modules, findings, sups)
        for s in sups:
            if not s.used:
                meta.append(Finding(
                    path=s.path, line=s.line, rule="APM000",
                    message=f"unused suppression for "
                            f"{','.join(s.rules)}: the violation it "
                            f"justified is gone — delete the comment "
                            f"(stale suppressions fail the run by design)"))
        return Report(
            findings=sorted(findings + meta),
            suppressions_used=[s for s in sups if s.used],
            files_scanned=len(modules),
            rules=[r.id for r in self.rules])
