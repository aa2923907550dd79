"""Multi-step chaining: run the k ocean steps of an event-free span, with
their diagnostic accumulation, as one unit (counterpart of
``mckpp_tpu/models/chain.py``, where the unit is one jitted call).

Between flux updates, ancillary refreshes, output emits and restarts the
step is pure state -> state and the per-step diagnostic sampling is a
reduction on the device, so a span is:

* k-1 "pre" steps (diagnostics-lazy unless a reducing stream samples a
  wide field);
* one final step, full when the span's end needs materialized wide fields
  (an emit sampling wide fields, or a restart);
* after every step, the reducing streams' accumulators update with the
  ``torch.add``/``minimum``/``maximum`` that ``DiagnosticsManager.step``
  applies, in the same order, so emitted windows are value-identical;
* the final state's instant-sampled fields are extracted with it.

On CUDA (``graphs=True``) each distinct span key (k, first, with_pre,
with_final, reducing spec, instant sources: the statics of the JAX jit)
is captured once in a ``torch.cuda.CUDAGraph`` and replayed.  Capture
needs every input at a fixed address, so the state, parameters, forcing
and accumulators are copied into static buffers allocated outside any
capture, and the graph ends by copying its outputs into static buffers
too; nothing a graph allocates outlives its replay, so all graphs share
one memory pool.  Before its capture a key runs once eagerly on the
static buffers (the kernels' lazy set-up, such as the aref row extents
copied to the host, happens there, outside the capture).  A capture or
replay error raises.  The caller gets copies of the output buffers,
which the next replay overwrites.  On the CPU the same body runs
eagerly.

Accumulator windows open at the op identity (0 / +inf / -inf) instead of
the per-step manager's "first sample assigns": x+0 == x and
min(+inf, x) == x, so the values agree; the one representational
difference is a -0.0 first sample becoming +0.0 under "average".  The
prognostic trajectory is bitwise the per-step loop's: the same step
function with the same with_diags schedule.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch

from ..io.diagnostics import DiagnosticsManager, WIDE_FIELDS, extract_fields
from ..ops import cuda_kernels as ck
from ..state import tree_map
from ..utils.timer import NO_TIMERS

_OPS = {"average": torch.add, "minimum": torch.minimum,
        "maximum": torch.maximum}
_IDENTITY = {"average": 0.0, "minimum": math.inf, "maximum": -math.inf}


def reducing_spec(diag: DiagnosticsManager) -> Tuple[Tuple[str, str, str, str], ...]:
    """(stream, out, src, op) for every reducing entry."""
    spec = []
    for s in diag.streams:
        for out, src, op in s.resolved_entries():
            if op != "instant":
                spec.append((s.name, out, src, op))
    return tuple(spec)


def has_wide_reducing(diag: DiagnosticsManager) -> bool:
    """True when some reducing entry samples a WIDE field — every step
    must then materialize diagnostics."""
    return any(src in WIDE_FIELDS for _, _, src, _ in reducing_spec(diag))


def inst_srcs_at(diag: DiagnosticsManager, nt: int) -> Tuple[str, ...]:
    """Union of instant-entry source fields of streams emitting at nt."""
    srcs = set()
    for s in diag.streams:
        if nt % s.freq == 0:
            for _, src, op in s.resolved_entries():
                if op == "instant":
                    srcs.add(src)
    return tuple(sorted(srcs))


def emit_due(diag: DiagnosticsManager, nt: int) -> bool:
    return any(nt % s.freq == 0 for s in diag.streams)


def plan_segments(num_steps: int, *, ndtocn: int, end_pred,
                  start_pred=None, max_k: int = 32):
    """Greedy segmentation of [1, num_steps] into chains.

    ``end_pred(nt)``: the step must be a chain's final step (emit,
    restart, needs-full boundary, profile stop).  ``start_pred(nt)``: the
    step must start a chain (ancillary refresh, profile start,
    steady-state marker; the flux cadence is implied by ndtocn).  Returns
    a list of (start, k) with start+k-1 the final step.
    """
    def must_start(nt):
        return ((nt - 1) % ndtocn == 0
                or (start_pred is not None and start_pred(nt)))

    def must_end(nt):
        return end_pred(nt) or nt == num_steps

    segments = []
    nt = 1
    while nt <= num_steps:
        k = 1
        while (k < max_k and nt + k <= num_steps
               and not must_start(nt + k) and not must_end(nt + k - 1)):
            k += 1
        segments.append((nt, k))
        nt += k
    return segments


def _nbytes(tree) -> int:
    """The bytes of every tensor in a (state, {stream: {out: tensor}},
    {src: tensor}) triple."""
    st, acc, inst = tree
    return (sum(getattr(st, n).nbytes for n in st.__dataclass_fields__)
            + sum(a.nbytes for d in acc.values() for a in d.values())
            + sum(a.nbytes for a in inst.values()))


class _Buffers:
    """The static inputs and outputs of the captured graphs, allocated
    outside any capture.  ``held`` maps a buffer to the tensor whose
    values it holds, so an input that is already in place is not copied
    again (tensors are never written in place in the port)."""

    def __init__(self, st, prm, frc, accums):
        self.st = tree_map(torch.empty_like, st)
        self.prm = tree_map(torch.empty_like, prm)
        self.frc = tree_map(torch.empty_like, frc)
        self.acc = {sn: {o: torch.empty_like(a) for o, a in d.items()}
                    for sn, d in accums.items()}
        self.inst: Dict[str, torch.Tensor] = {}
        self.held: Dict[int, torch.Tensor] = {}

    def _put(self, dst, src):
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"chain input {tuple(src.shape)}/{src.dtype} "
                             f"does not fit its graph buffer "
                             f"{tuple(dst.shape)}/{dst.dtype}")
        if self.held.get(id(dst)) is src:
            return 0
        dst.copy_(src)
        self.held[id(dst)] = src
        return dst.nbytes

    def _pairs(self, st, prm, frc, accums):
        for bufs, vals in ((self.st, st), (self.prm, prm), (self.frc, frc)):
            for name in vals.__dataclass_fields__:
                yield getattr(bufs, name), getattr(vals, name)
        for sn, d in accums.items():
            for o, a in d.items():
                yield self.acc[sn][o], a

    def load(self, st, prm, frc, accums) -> int:
        """Copy the inputs that are not in place yet; returns the bytes
        copied."""
        return sum(self._put(dst, src)
                   for dst, src in self._pairs(st, prm, frc, accums))

    def ensure_inst(self, fields):
        for src, a in fields.items():
            if src not in self.inst:
                self.inst[src] = torch.empty_like(a)

    def store(self, st, accums, inst):
        """Copy a body's outputs into the buffers (inside the capture)."""
        for name in st.__dataclass_fields__:
            getattr(self.st, name).copy_(getattr(st, name))
        for sn, d in accums.items():
            for o, a in d.items():
                self.acc[sn][o].copy_(a)
        for src, a in inst.items():
            self.inst[src].copy_(a)

    def hand_out(self, prm, frc, inst_srcs):
        """Copies of the output buffers; the buffers then hold the copies'
        values (and still hold prm and frc)."""
        st = tree_map(torch.clone, self.st)
        acc = {sn: {o: a.clone() for o, a in d.items()}
               for sn, d in self.acc.items()}
        inst = {src: self.inst[src].clone() for src in inst_srcs}
        self.held = {}
        for dst, src in self._pairs(st, prm, frc, acc):
            self.held[id(dst)] = src
        return st, acc, inst


class ChainedStepper:
    """Runs spans of steps and hands their diagnostics to the manager.

    ``step_fn(st, prm, frc, first_step, with_diags)`` is the model's
    ``_step``.  ``graphs``: capture each span key in a CUDA graph and
    replay it (the model on CUDA with the whole-step kernel, whose step
    never waits on the host); otherwise run the body eagerly.
    ``uncounted``: a context manager factory around each capture's eager
    warm-up, whose steps the replays run again (the model's
    ``uncounted``, so that its pass counter counts each step once).
    """

    def __init__(self, step_fn, diag: DiagnosticsManager, *,
                 graphs: bool = False, timers=None, uncounted=None):
        self.diag = diag
        self.timers = NO_TIMERS if timers is None else timers
        self.red_spec = reducing_spec(diag)
        self.wide_reducing = has_wide_reducing(diag)
        self._step_fn = step_fn
        self._uncounted = uncounted or contextlib.nullcontext
        self.graphs = graphs
        self._templates: Optional[Dict[str, Dict[str, tuple]]] = None
        self._buf: Optional[_Buffers] = None
        self._graphs: dict = {}          # key -> (CUDAGraph, launches)
        self._pool = None
        self.captures = 0
        self.replays = 0

    # ---- the span body ---------------------------------------------------
    def _body(self, st, prm, frc, accums, k, first, with_pre, with_final,
              inst_srcs):
        red_spec = self.red_spec
        srcs = sorted({src for _, _, src, _ in red_spec})

        def one(st, accums, first_, wd):
            new_st = self._step_fn(st, prm, frc, first_, with_diags=wd)
            fields = extract_fields(new_st, prm, frc, srcs)
            out = {sn: dict(d) for sn, d in accums.items()}
            for sname, outname, src, op in red_spec:
                out[sname][outname] = _OPS[op](out[sname][outname],
                                               fields[src])
            return new_st, out

        n_pre = k - 1
        if first and n_pre > 0:
            st, accums = one(st, accums, True, with_pre)
            n_pre -= 1
        for _ in range(n_pre):
            st, accums = one(st, accums, False, with_pre)
        st, accums = one(st, accums, first and k == 1, with_final)
        inst = extract_fields(st, prm, frc, inst_srcs)
        return st, accums, inst

    # ---- accumulator windows ---------------------------------------------
    def begin(self, st, prm, frc):
        """The accumulator carry: live windows pass through; fresh windows
        start at the op identity."""
        if self._templates is None:
            srcs = sorted({src for _, _, src, _ in self.red_spec})
            fields = extract_fields(st, prm, frc, srcs)
            self._templates = {}
            for sname, outname, src, op in self.red_spec:
                f = fields[src]
                self._templates.setdefault(sname, {})[outname] = \
                    (f.shape, f.dtype, f.device, op)
        accums = {}
        for sname, outs in self._templates.items():
            live = self.diag._accum.get(sname)
            accums[sname] = live if live is not None else {
                out: torch.full(shape, _IDENTITY[op], dtype=dt, device=dev)
                for out, (shape, dt, dev, op) in outs.items()}
        return accums

    def exec(self, nt_start: int, k: int, st, prm, frc,
             final_full: Optional[bool] = None):
        """Steps [nt_start, nt_start+k-1] as one unit.  Returns (st,
        accums, inst_fields); follow with :meth:`commit`.
        ``final_full`` overrides the final step's with_diags (default:
        diag.needs_full(nt_end))."""
        nt_end = nt_start + k - 1
        if final_full is None:
            final_full = self.diag.needs_full(nt_end)
        key = (k, nt_start == 1, self.wide_reducing, bool(final_full),
               inst_srcs_at(self.diag, nt_end))
        accums = self.begin(st, prm, frc)
        if not self.graphs:
            return self._body(st, prm, frc, accums, *key)
        return self._replay(key, st, prm, frc, accums)

    # ---- CUDA graphs ---------------------------------------------------------
    def _replay(self, key, st, prm, frc, accums):
        if self._buf is None:
            self._buf = _Buffers(st, prm, frc, accums)
        buf, timers = self._buf, self.timers
        with timers.span("chain.load"):
            timers.count("chain.load_bytes", buf.load(st, prm, frc, accums))
        entry = self._graphs.get(key)
        if entry is None:
            with timers.span("chain.capture"):
                buf.ensure_inst(extract_fields(buf.st, buf.prm, buf.frc,
                                               key[4]))
                entry = self._capture(key, buf)
        graph, launches = entry
        with timers.span("chain.replay"):
            graph.replay()
        # a replay launches every kernel its capture recorded, once
        for name, n in launches.items():
            ck.LAUNCHES[name] += n
        self.replays += 1
        with timers.span("chain.hand_out"):
            out = buf.hand_out(prm, frc, key[4])
        timers.count("chain.hand_out_bytes", _nbytes(out))
        return out

    def _capture(self, key, buf):
        # the eager warm-up: the kernels' lazy set-up happens here
        with self._uncounted():
            self._body(buf.st, buf.prm, buf.frc, buf.acc, *key)
        torch.cuda.synchronize()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = dict(ck.LAUNCHES)
        # thread_local: the writer and prefetch threads may copy between
        # host and device meanwhile
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            buf.store(*self._body(buf.st, buf.prm, buf.frc, buf.acc, *key))
        # the wrappers counted the launches they recorded; the capture
        # itself launched nothing, so the counts go to the replays
        launches = {n: ck.LAUNCHES[n] - before[n] for n in before}
        ck.LAUNCHES.update(before)
        self.captures += 1
        self._graphs[key] = (graph, launches)
        return self._graphs[key]

    def run(self, nt_start: int, k: int, st, prm, frc,
            final_full: Optional[bool] = None):
        """exec + commit in one call."""
        st, accums, inst_fields = self.exec(nt_start, k, st, prm, frc,
                                            final_full)
        self.commit(nt_start + k - 1, k, accums, inst_fields)
        return st

    def commit(self, nt_end: int, k: int, accums, inst_fields):
        """Store the updated windows and emit the streams due at nt_end —
        the chained counterpart of DiagnosticsManager.step's bookkeeping."""
        diag = self.diag
        for s in diag.streams:
            if any(e[2] != "instant" for e in s.resolved_entries()):
                diag._accum[s.name] = accums[s.name]
                diag._count[s.name] += k
            if nt_end % s.freq == 0:
                instant = {out: inst_fields[src]
                           for out, src, op in s.resolved_entries()
                           if op == "instant"}
                diag._emit(s, nt_end, instant)
