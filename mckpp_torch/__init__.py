"""mckpp_torch: the multi-column KPP ocean mixed-layer model in PyTorch,
with hand-written CUDA kernels for the fused ocean pass and step.

It imports torch and numpy only.  Its modules mirror ``mckpp_tpu``'s
layout; ``mckpp_tpu`` stays the reference that the tests hold it to.
"""

from .config import (KppConfig, DomainConfig, TimeConfig, PhysicsFlags,
                     ForcingConfig, BoundaryConfig, InitConfig, OutputConfig)
from .grid import VerticalGrid, make_vertical_grid, vertical_grid_from_arrays
from .state import State, ColumnParams, Forcing
from .models.column_model import KppModel

__version__ = "0.1.0"
