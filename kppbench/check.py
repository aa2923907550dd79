"""How ``correct`` is decided: what the window's CLI run wrote (its
diagnostic files and its restarts) against the plain reference
(``reference/``) on a sample of columns drawn from the seed.

The reference cannot follow all of the window's steps in the time of a
run (a plain step of a sample of columns takes some 0.1-0.2 s on a host
core, the program's step of the whole grid tens of ms), so it follows
two stretches of one simulated day each, in two processes at once:

* ``first``: the first day, from the initial state the reference works
  out again from the input files (the start: land mask, grid, profiles,
  the initial mixing pass, the first SST read);
* ``last``: the last day, from the program's own restart written at its
  start (``c = N - day``), to the final restart at step N.

Each stream record whose window lies inside a stretch is compared, as
are the state of the final restart (T, S, U, V, hmix, kmix), the land
fill of every record read and the set of records and restarts written.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
import re
import zipfile

import numpy as np

FILL_VALUE = np.float32(1.0e20)
SAMPLE_OCEAN = 88
SAMPLE_LAND = 8
DURATION_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ts|h|d)\s*$")


def steps_of(spec: str, dto: float) -> int:
    """An iodef duration ("1d", "1h", "3ts") in ocean steps."""
    m = DURATION_RE.match(spec)
    if not m:
        raise ValueError(f"duration {spec!r}")
    n = float(m.group(1))
    return int(round(n if m.group(2) == "ts" else
                     n * {"h": 3600.0, "d": 86400.0}[m.group(2)] / dto))


def read_lsm(path: str) -> np.ndarray:
    """The land-sea mask of a run's ``lsm.nc`` (1.0 on land)."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as nc:
        return np.array(nc.variables["lsm"][:], np.float64)


def model_levels(path: str) -> np.ndarray:
    """The model's level depths zm (nz + 1 of them: the file's levels and
    the fictitious bottom at -dmax), as ``grid.vertical_grid_from_arrays``
    makes them from ``vgrid.nc``."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as nc:
        z = np.array(nc.variables["z"][:], np.float64)
        h = np.array(nc.variables["h"][:], np.float64)
    return np.append(z, z[-1] - h[-1])


def sample(lsm: np.ndarray, seed: int):
    """(ocean, land) flat column indices drawn from the seed."""
    from .inputs import rng_of
    flat = np.asarray(lsm).reshape(-1)
    ocean, land = np.flatnonzero(flat != 1.0), np.flatnonzero(flat == 1.0)
    rng = rng_of(seed + 2)
    o = np.sort(rng.choice(ocean, min(SAMPLE_OCEAN, len(ocean)),
                           replace=False))
    l = np.sort(rng.choice(land, min(SAMPLE_LAND, len(land)),
                           replace=False)) if len(land) else land
    return o, l


def npz_columns(path: str, cols, prefixes=("st_", "pr_", "fr_", "meta_")):
    """The arrays of an uncompressed ``.npz`` restart, each memory-mapped
    and indexed by ``cols`` on its leading axis (scalars whole), so only
    the pages of those columns are read."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            key = info.filename[:-4]
            if not key.startswith(prefixes):
                continue
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {key} is compressed")
            f.seek(info.header_offset)
            head = f.read(30)
            start = (info.header_offset + 30
                     + int.from_bytes(head[26:28], "little")
                     + int.from_bytes(head[28:30], "little"))
            f.seek(start)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0) else
                           np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if not shape:
                out[key] = np.frombuffer(f.read(dtype.itemsize),
                                         dtype=dtype)[0]
                continue
            mm = np.memmap(path, dtype=dtype, mode="r", offset=f.tell(),
                           shape=shape, order="F" if fortran else "C")
            out[key] = np.asarray(mm[np.asarray(cols)])
            del mm
    return out


def stream_records(outdir: str, stream: str, fields, cols) -> dict:
    """{time (days, rounded to 1e-6): {field: values at ``cols``}} of
    every file of ``stream`` in ``outdir`` (split or not)."""
    pat = re.compile(re.escape(stream) + r"(_[0-9.]+)?\.nc$")
    from scipy.io import netcdf_file
    recs = {}
    for name in sorted(os.listdir(outdir)):
        if not pat.match(name):
            continue
        with netcdf_file(os.path.join(outdir, name), "r", mmap=True) as nc:
            times = np.array(nc.variables["time"][:], np.float64)
            for f in fields:
                data = nc.variables[f].data
                for i, t in enumerate(times):
                    # (z, y, x) or (y, x) -> (cols[, z])
                    flat = data[i].reshape(data.shape[1], -1).T \
                        if data.ndim == 4 else data[i].reshape(-1)
                    recs.setdefault(round(float(t), 6), {})[f] = np.array(
                        flat[np.asarray(cols)])
                    del flat
                del data
    return recs


def segment(args: dict) -> dict:
    """One reference stretch (run in a worker process): from the
    reference's own initial state (``args["start"]`` "files") or from a
    restart's arrays of the sampled columns, steps ``nt0 + 1`` to
    ``nt1``."""
    import torch
    torch.set_num_threads(1)
    from .reference import column
    dtype = getattr(torch, args["dtype"])
    col = column.load_columns(args["config"], args["data_dir"], args["cols"],
                              dtype=dtype, wscale=args["wscale"])
    if args["start"] == "files":
        st, prm, frc = column.initial_state(args["config"], args["data_dir"],
                                            col, args["cols"])
    else:
        st, prm, frc = column.from_checkpoint(args["start"], col)
    st, frc, recs, work = column.run(col, st, prm, frc, args["nt0"],
                                     args["nt1"], args["streams"])
    f = lambda a: a.double().numpy()
    return {"state": {"T": f(st.x[..., 0]),
                      "S": f(st.x[..., 1] + prm.sref[:, None]),
                      "U": f(st.u[..., 0]), "V": f(st.u[..., 1]),
                      "hmix": f(st.hmix), "kmix": f(st.kmix)},
            "records": recs, "work": work}


def run_segments(jobs: list, workers: int = 2) -> list:
    """The stretches ``jobs`` (arguments of :func:`segment`) in worker
    processes, each with one thread; waits for every one."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(workers, len(jobs)), mp_context=ctx) as ex:
        futs = [ex.submit(segment, j) for j in jobs]
        return [f.result() for f in futs]


def stream_specs(traffic: dict, dto: float) -> list:
    """(name, freq steps, ((out, src, op), ...)) of the mix's streams."""
    return [(s["name"], steps_of(s["output_freq"], dto),
             tuple((f["name"], f["ref"], f["op"]) for f in s["fields"]))
            for s in traffic["streams"]]


def _gap(got, ref) -> float:
    """max |got - ref| as a share of max |ref|, or as it is where the
    reference is zero throughout (a missing or non-finite value counts
    as infinite)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return float("inf")
    d = np.abs(got - ref)
    if not np.all(np.isfinite(d)):
        return float("inf")
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    return float(d.max() / scale) if scale > 0 else float(d.max())


def compare(specs, program: dict, ref_first: dict, ref_last: dict,
            end_state: dict, n_ocean: int) -> dict:
    """The numbers compared: for each stream field, ``<out>.first`` and
    ``<out>.last`` (the widest gap of every record of the stretch), the
    final restart's ``T.end`` .. ``kmix.end``.  ``program`` is
    {stream: {time: {out: values at the sampled columns}}}, the ocean
    columns first (``n_ocean`` of them)."""
    checks = {}
    oc = slice(0, n_ocean)
    for name, freq, ents in specs:
        got = program[name]
        for seg, ref in (("first", ref_first), ("last", ref_last)):
            recs = ref["records"].get(name, {})
            for out, _src, _op in ents:
                gaps = [_gap(got[t][out][oc] if t in got else np.nan,
                             r[out][oc]) for t, r in recs.items()]
                checks[f"{out}.{seg}"] = max(gaps) if gaps else None
    st = ref_last["state"]
    for key, fields in (("T", ("T",)), ("S", ("S",)), ("UV", ("U", "V")),
                        ("hmix", ("hmix",))):
        checks[f"{key}.end"] = max(_gap(end_state[f][oc], st[f][oc])
                                   for f in fields)
    checks["kmix.end"] = float(np.max(np.abs(
        end_state["kmix"][oc].astype(np.int64) - st["kmix"][oc])))
    return {k: v for k, v in checks.items() if v is not None}


def limit_of(check: str, specs, limits: dict):
    """The limit of a check: ``<src>.<op>`` for a stream field's, the
    check's own name for the others (None: not compared)."""
    if check in limits:
        return limits[check]
    out = check.rsplit(".", 1)[0]
    for _name, _freq, ents in specs:
        for o, src, op in ents:
            if o == out:
                return limits[f"{src}.{op}"]
    raise KeyError(f"no limit for {check}")
