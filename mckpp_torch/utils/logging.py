"""Logging in the reference's ``routine: message`` format
(mckpp_log_messages.F90:25-88): prints to stdout, warnings/errors to
stderr, with call-path context strings."""

from __future__ import annotations

import sys


def mckpp_print(routine: str, message: str = ""):
    print(f"{routine}: {message}")


def mckpp_print_warning(routine: str, message: str):
    print(f"WARNING {routine}: {message}", file=sys.stderr)


def mckpp_print_error(routine: str, message: str):
    print(f"ERROR {routine}: {message}", file=sys.stderr)


def update_context(context: str, routine: str) -> str:
    """Build an "A -> B" call-path string."""
    return f"{context} -> {routine}" if context else routine


class McKppAbort(RuntimeError):
    """The reference aborts with STOP (mckpp_abort_mod.F90); here an
    exception so hosts/tests can trap it."""
