"""numpy <-> port state conversion.

A mapping of field name -> numpy array (the field names, shapes and dtypes
of :mod:`mckpp_torch.state`) becomes a dataclass on a given device and
float dtype, and back.  Integer fields (``kmix``, ``old``, ``new``,
``jerlov``, ``nmodeadv``, ``modeadv``) stay int32 and boolean masks
(``l_ocean``, ``run_physics``) stay bool; every floating field takes
``dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .state import ColumnParams, Forcing, State


def _tensor(a, dtype, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, dtype=torch.bool, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int32), device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def _from_numpy(cls, fields: Mapping[str, np.ndarray], dtype, device):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(fields)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{n: _tensor(fields[n], dtype, device) for n in names})


def state_from_numpy(fields, dtype=torch.float64, device="cpu") -> State:
    return _from_numpy(State, fields, dtype, device)


def params_from_numpy(fields, dtype=torch.float64,
                      device="cpu") -> ColumnParams:
    return _from_numpy(ColumnParams, fields, dtype, device)


def forcing_from_numpy(fields, dtype=torch.float64, device="cpu") -> Forcing:
    return _from_numpy(Forcing, fields, dtype, device)


def to_numpy(obj) -> dict:
    """Dataclass of tensors -> {field name: numpy array} on the host."""
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)}
