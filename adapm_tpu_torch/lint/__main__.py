"""The port's lint gate: `python -m adapm_tpu_torch.lint`.

Runs the AST invariant analyzer (analyzer.py, rules.py) over every
`.py` under `adapm_tpu_torch/` and fails on

  - any unsuppressed finding (APM001..APM008 — a violated concurrency
    or device-plane discipline), or
  - any unused or malformed suppression (APM000 — a stale or
    unjustified escape hatch).

Pure AST, no device stack, well under a second. `--json` prints the
deterministic JSON report instead of the text one. There is no
baseline: the port's tree lints clean.

Exit status: 0 clean, 1 otherwise.
"""
import os
import sys

from .analyzer import Analyzer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rep = Analyzer(ROOT).run()
    if "--json" in argv:
        sys.stdout.write(rep.to_json())
    elif rep.findings:
        sys.stdout.write(rep.to_text())
        print(f"[lint] FAIL: {len(rep.findings)} finding(s) over "
              f"{rep.files_scanned} files — fix the violation or add a "
              f"justified `# apm-lint: disable=` (docs/INVARIANTS.md)")
    else:
        print(f"[lint] OK: {rep.files_scanned} files, {len(rep.rules)} "
              f"rules, {len(rep.suppressions_used)} justified "
              f"suppression(s) used")
    return 0 if rep.ok() else 1


if __name__ == "__main__":
    sys.exit(main())
