"""File-system helpers shared by the kernel and encoder builds."""

from __future__ import annotations

import os
import secrets


def tmp_name(out: str) -> str:
    """A temporary file name beside ``out`` that no other process or
    thread making the same file uses (pid plus a random suffix), so
    concurrent builds (the ranks of a distributed run) never write one
    file; each moves its own finished file into place with
    ``os.replace``."""
    return f"{out}.tmp{os.getpid()}.{secrets.token_hex(4)}"
