"""Write the input set of one BASELINE.json benchmark configuration (the
port's counterpart of ``tools/make_benchmark_configs.py``, written through
the port's NetCDF writer: see ``mckpp_torch.io.benchmark_inputs``).

Usage: python -m mckpp_torch.tools.make_benchmark_configs CONFIG OUTDIR
       [--toy]

CONFIG is one of single_column, regional_64x64, terramaris, global_1deg,
ensemble10_dd; ``--toy`` shrinks the horizontal grid (by 8) for quick
runs.  Run the result with ``python -m mckpp_torch.cli --namelist
OUTDIR/3D_ocn.nml --data-dir OUTDIR --output-dir OUTDIR/out``.
"""

from __future__ import annotations

import argparse
import sys

from ..io.benchmark_inputs import CONFIGS, generate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", choices=CONFIGS)
    ap.add_argument("outdir")
    ap.add_argument("--toy", action="store_true")
    a = ap.parse_args(argv)
    grid = generate(a.config, a.outdir, a.toy)
    print(f"wrote {a.config} inputs to {a.outdir}: {grid['nx']} x "
          f"{grid['ny']} x {grid['nz']}, land share "
          f"{grid['land_share']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
