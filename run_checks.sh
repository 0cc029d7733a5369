#!/usr/bin/env bash
# Static checks + tests, the analogue of the reference's run_checks.sh
# (reference run_checks.sh:30-33: ruff format, ruff lint, pyright, pytest).
#
# The build image has no third-party linters, so the lint/format gate is
# the from-scratch checker in scripts/lint.py (pyflakes-grade: unused
# imports, redefinitions, ==None/==True, bare except, mutable defaults,
# line length, whitespace hygiene). CI environments with real ruff +
# pyright additionally run them via .github/workflows/checks.yml.
#
# Usage:
#   ./run_checks.sh          # static checks + full CPU test suite
#   ./run_checks.sh --fast   # static checks only (seconds, no JAX)
#
# The GPU check is separate: `python chip_smoke.py` on a machine with a GPU.
set -u
cd "$(dirname "$0")"
status=0

step() {
    echo "=== $1 ==="
    shift
    "$@" || status=1
}

step "lint (scripts/lint.py)" python scripts/lint.py
step "syntax (compileall)" python -m compileall -q \
    planetmapper_tpu tests scripts bench.py chip_smoke.py __graft_entry__.py
step "api docs drift" python scripts/generate_api_docs.py --check

if [[ "${1:-}" != "--fast" ]]; then
    step "tests" env JAX_PLATFORMS=cpu bash tests/run_tests.sh
fi

if [[ $status -eq 0 ]]; then
    echo "All checks passed."
else
    echo "CHECKS FAILED" >&2
fi
exit $status
