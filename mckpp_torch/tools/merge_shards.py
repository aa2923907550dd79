"""Merge per-process shard output files into single-writer files.

Usage:  python -m mckpp_torch.tools.merge_shards OUTDIR [--dest DIR]

Finds every ``<stream>[_<split>]_p<rank>.nc`` group written by
``mckpp_torch.cli --distributed --output-mode shard`` (the XIOS
multiple_file analog) in OUTDIR and writes the merged ``(time, z, y, x)``
file of each group: the values the single-writer mode would have written.
The counterpart of ``tools/merge_shards.py``.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import sys

from ..io import ncio
from ..io.diagnostics import merge_shard_files

SHARD_RE = re.compile(r"^(?P<base>.+)_p(?P<rank>\d+)\.nc$")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merge mckpp_torch shard output files")
    ap.add_argument("outdir")
    ap.add_argument("--dest", default=None,
                    help="directory for merged files (default: OUTDIR)")
    args = ap.parse_args(argv)
    dest = args.dest or args.outdir
    os.makedirs(dest, exist_ok=True)
    groups = collections.defaultdict(list)
    for name in sorted(os.listdir(args.outdir)):
        m = SHARD_RE.match(name)
        if m:
            groups[m.group("base")].append(os.path.join(args.outdir, name))
    if not groups:
        print(f"no shard files (*_pN.nc) found in {args.outdir}")
        return 1
    writes0 = dict(ncio.WRITES)
    for base, paths in sorted(groups.items()):
        out = os.path.join(dest, f"{base}.nc")
        merge_shard_files(paths, out)
        print(f"merged {len(paths)} shards -> {out}")
    print(f"NetCDF files written: "
          f"{ncio.WRITES['native'] - writes0['native']} native, "
          f"{ncio.WRITES['scipy'] - writes0['scipy']} scipy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
