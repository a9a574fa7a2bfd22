"""The loops on the device: a planet's or a batch's iterations captured as
CUDA graphs and replayed, one device read per chunk of iterations (the port's
counterpart of the JAX package's ``lax.while_loop``,
helios_tpu/rce/radiative.py:331-358, helios_tpu/rce/loop.py:214-251).

A loop body (:func:`helios_tpu_torch.rce.radiative._one_radiation_iteration`,
:func:`helios_tpu_torch.rce.loop._one_convection_iteration`) keeps its
counters on the device (``it``, ``local_limit``, ``aborted``; the convection
loop's ``keep_running`` and ``steps``) and branches only on the host's copy
of the counter, which the loop passes in.  The branches it takes at a
counter form that counter's key (``rad_key``, ``conv_key``).  A loop state
with host counters, as the callers see it, becomes a device state at entry
and returns with host counters read back.

One class, :class:`Runner`, runs a body in chunks of ``Settings.chunk``
iterations with one read of the flags after each, on a state it holds in
static buffers (a planet's, a batch's with the planet axis, or a sliced
model's, each slice's on its device).  An iteration writes its results
only where ``keep_running`` was set at its start, so the iterations after
the planet (or a member of a batch) stops change nothing, as an iteration
of ``lax.while_loop`` past its condition does not run.

- A model whole on one device, one planet's or a batch's: on the card each
  key's body runs eagerly the first time (which builds and loads the
  kernels), is captured as a CUDA graph into one memory pool after the
  chunk's read has shown that the planet (a member) ran that iteration,
  and is replayed from then on; on the CPU the same body runs eagerly,
  since the caller asked for the CPU.  The host's copy of the counter
  chooses each replay's key; while the planet runs it equals the device
  counter, and a batch's running members share it.
- A sliced model (spectral slices, the planet x spectral mesh, whose
  planet groups run one after another) runs :data:`PER_ITERATION`: a
  chunk of one, unbounded adjustments, nothing captured.  So does any run
  inside ``loops(PER_ITERATION)``, the reference that the graphs are held
  against.

The convective adjustment inside a graph runs ``rounds`` correction rounds
(``convect.convective_adjustment``) and flags a chunk in which a running
planet (a member) was still unstable after them; that chunk runs again
from a snapshot of its start, eagerly and with unbounded rounds (a
*redo*).

Kernel launch counts (``<wrapper>.launches``) count every launch: an eager
iteration's wrappers count their own, a replay adds the launches its graph
holds (recorded by kernel name at capture, which launches nothing).  The
runner's :class:`Stats` count the graphs, replays, reads, redos and adjustment
rounds, the adjustment kernel's launches, and the launches of iterations
that changed nothing (past the stop, or the first try of a redone chunk).
On-the-fly opacity mixing passes (``tracing.mixing``) are counted the same
way, live in an eager iteration and by a replay as many as its graph
holds, and their Random Overlap launches are the iterations' ``ro_mix``
launches.

The host's time is taken in ``tracing.span`` blocks (``helios.<phase>``) at
the boundaries of the run and of the loops: each adds its seconds to a
field of the loop's Stats (captures, eager iterations, replays, reads,
the adjustment's reads, the opacity mixing inside captures and eager
iterations), and while a profiler records it is a
``record_function`` range on the clock of the device's kernels.

Who owns a runner follows from its settings alone (:meth:`Loops.runner`).
A runner that holds iterations (``rounds`` bounded: a whole model outside
:data:`PER_ITERATION`, the runner that captures on the card) is kept
process-wide, one per loop kind, with its graphs, memory pool, static
buffers and its own copies of the tensors its body reads (the owners':
phys, model, thermo, species set).  A later loop whose key matches, the
kind, the settings, the owners' structure and Python scalars (the ``Phys``
value among them) and every tensor's shape, strides, dtype and device, of
the owners and of the state, takes it over: the solve's owner tensors are
copied into the runner's (:class:`_Owned`), its state into the static
buffers, and the graphs already captured replay.  A miss drops the kind's
kept runner, and every kept runner of other owners, graphs and buffers,
before a new one is made; :func:`clear_kept` drops them all.  Every other
runner is made for its :func:`run_loop` call and dropped when the call
returns.  Either way a runner counts into the Stats of the :func:`loops`
block it runs in.  A capture or replay error raises; nothing falls back to
the eager body.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import dataclasses
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from helios_tpu_torch import tracing
from helios_tpu_torch.ops.members import member_mask
from helios_tpu_torch.ops.slices import count

# iterations between two reads of the device: the iterations replayed
# after the stop cost at most CHUNK - 1 iterations of device time (PERF.md
# §5: 0.67 ms a flagship radiation iteration, 1.33 ms a convection one)
CHUNK = 16
# correction rounds of a convective adjustment inside a graph, and of the
# convection loop's first (PERF.md §5, chip_smoke.py paths a, f, h and m:
# after the first, at most 4 rounds in 1532 adjustments; the first took
# 20-30)
ROUNDS = 4
ENTRY_ROUNDS = 40

# the counters a loop keeps on the device, and their dtypes there
COUNTER_DTYPES = dict(it=torch.int64, local_limit=torch.float64,
                      aborted=torch.bool, keep_running=torch.bool,
                      steps=torch.int64)


@dataclasses.dataclass(frozen=True)
class Settings:
    """How the loops of a whole model run: ``chunk`` iterations between two
    reads of the device; ``rounds`` and ``entry_rounds`` the adjustment
    rounds of an iteration and of the convection loop's iteration 0.  With
    ``rounds`` None an adjustment runs while unstable, reading a flag per
    round, and nothing is captured (a capture cannot read); else on the
    card each iteration is a replayed CUDA graph."""
    chunk: int = CHUNK
    rounds: Optional[int] = ROUNDS
    entry_rounds: Optional[int] = ENTRY_ROUNDS


# a read after every iteration, unbounded adjustments, nothing captured
PER_ITERATION = Settings(chunk=1, rounds=None, entry_rounds=None)


@dataclasses.dataclass
class Stats:
    """What the runners of a loop kind did: graphs captured, replays,
    eager iterations, the runner's device reads (one per chunk and one at
    entry), redone chunks, iterations run and past the stop (predicated
    no-ops), host seconds spent capturing, running eager iterations,
    issuing replays and in every read of the loop (the runner's and the
    convection loop's entry check), the unbounded adjustments' blocking
    reads (one per correction round and one more) and their seconds,
    which an eager iteration's seconds include, the histogram of the
    adjustment rounds that the convection iterations needed (first tries,
    a batch's iteration once, at its member that needed the most; the last
    index: more than a graph holds, a redo), per kernel the
    launches of iterations that changed nothing (past the stop, first
    tries of redone chunks), and of on-the-fly opacity mixing
    (``tracing.mixing``) the host seconds of its passes inside captures
    and eager iterations, the passes run and the ``ro_mix`` launches of
    the iterations (the mixing's Random Overlap, one per absorber after
    the first); a premixed run's three read zero; the lookups of a
    kept runner (:func:`loops`): those that took one over and those that
    made one (neither for a runner made for one loop call); and the
    iterations' ``conv_adjust`` launches (the convective adjustment's
    kernel: one per bounded adjustment, one per read of an unbounded
    one; none on the CPU)."""
    graphs: int = 0
    replays: int = 0
    eager: int = 0
    reads: int = 0
    redos: int = 0
    iterations: int = 0
    past_stop: int = 0
    capture_s: float = 0.0
    eager_s: float = 0.0
    replay_s: float = 0.0
    read_s: float = 0.0
    adjust_reads: int = 0
    adjust_read_s: float = 0.0
    rounds: Optional[List[int]] = None
    idle_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    mix_s: float = 0.0
    mixes: int = 0
    mix_launches: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    adjust_launches: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------- #
# loop states: host counters <-> device counters
# --------------------------------------------------------------------------- #

def _parts(x):
    """The named parts of a NamedTuple or a dataclass, a list's or a plain
    tuple's items (named None); None for a leaf."""
    if hasattr(x, "_fields"):
        return list(zip(x._fields, x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
    if isinstance(x, (list, tuple)):
        return [(None, v) for v in x]
    return None


def _leaves(x) -> List[torch.Tensor]:
    """The tensors of a tree (a planet's or a batch's whole state, a loop's
    owners), in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for _, v in _parts(x) or () for t in _leaves(v)]


def _leaf_names(x, name: str = "") -> List[str]:
    """The field names of :func:`_leaves`' tensors, each its innermost
    field (which says where a batch's tensor carries the planet axis,
    ``members.state_axis``)."""
    if isinstance(x, torch.Tensor):
        return [name]
    return [n for f, v in _parts(x) or () for n in _leaf_names(v, f or name)]


def _rebuild(template, leaves):
    """``template``'s tree with its tensors replaced by ``leaves``."""
    return _replaced(template, iter(leaves))


def _replaced(x, leaves):
    # a function of the module, not a closure that calls itself: such a
    # closure is a reference cycle, which would hold ``leaves`` (a
    # result's tensors) until the cyclic collector runs
    if isinstance(x, torch.Tensor):
        return next(leaves)
    parts = _parts(x)
    if parts is None or not _leaves(x):
        return x
    new = [_replaced(v, leaves) for _, v in parts]
    if hasattr(x, "_fields"):
        return type(x)(*new)
    if isinstance(x, (list, tuple)):
        return type(x)(new)
    return dataclasses.replace(x, **{f: v for (f, _), v in zip(parts, new)})


def _signature(x):
    """What a loop body can observe of a tree other than its tensors'
    values: its structure, its Python scalars, and each tensor's shape,
    strides, dtype and device (hashable; the kept runners' key)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device)
    parts = _parts(x)
    if parts is None:
        return x
    return (type(x), tuple((f, _signature(v)) for f, v in parts))


def host_fields(state) -> List[str]:
    """The counters that a loop state with host counters keeps on the host
    (the radiation loop's ``keep_running`` is a device flag there)."""
    return [f for f in COUNTER_DTYPES if f in state._fields
            and not isinstance(getattr(state, f), torch.Tensor)]


def to_device(state):
    """A loop state with its host counters as tensors on the state's
    device (a batch's [P] arrays as [P] tensors)."""
    dev = state.T_lay.device
    return state._replace(**{
        f: torch.as_tensor(np.asarray(getattr(state, f)),
                           dtype=COUNTER_DTYPES[f], device=dev)
        for f in host_fields(state)})


def read_flags(state, extra=()) -> Dict[str, np.ndarray]:
    """The device counters of a loop state, and ``extra`` tensors (named
    ``extra<k>``), read to the host in one copy; each a 1-D array, [1] for
    a planet."""
    names = [f for f in COUNTER_DTYPES if f in state._fields]
    vals = [getattr(state, f) for f in names] + list(extra)
    flat = torch.cat([v.double().reshape(-1) for v in vals]).cpu().numpy()
    out, k = {}, 0
    for i, v in enumerate(vals):
        part = flat[k:k + v.numel()]
        k += v.numel()
        if i < len(names):
            dt = COUNTER_DTYPES[names[i]]
            out[names[i]] = part.astype(
                np.float64 if dt == torch.float64 else
                bool if dt == torch.bool else np.int64)
        else:
            out[f"extra{i - len(names)}"] = part
    return out


def to_host(state, flags, fields: List[str], batched: bool):
    """A device-counter state with ``fields`` set to their host values
    from ``flags`` (numbers for a planet, [P] arrays for a batch)."""
    return state._replace(**{f: flags[f] if batched else flags[f][0].item()
                             for f in fields})


# --------------------------------------------------------------------------- #
# kernel launch counts
# --------------------------------------------------------------------------- #

def _kernel_wrappers():
    from helios_tpu_torch.kernels import (adjust, integrate, ordered, ro,
                                          sweep, thomas)
    return (sweep.noniso_sweep, sweep.iso_sweep, thomas.thomas_solve,
            ro.ro_mix, ordered.ordered_sum, integrate.band_integrate,
            adjust.conv_adjust)


def _launches() -> Dict[str, int]:
    """Each wrapper's launch count, by the wrapper's name."""
    return {w.__name__: w.launches for w in _kernel_wrappers()}


def _set_launches(counts: Dict[str, int]) -> None:
    for w in _kernel_wrappers():
        w.launches = counts[w.__name__]


def _minus(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: n - b[k] for k, n in a.items()}


# --------------------------------------------------------------------------- #
# the loop runner
# --------------------------------------------------------------------------- #

class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    launches: Dict[str, int]    # by kernel name
    mixes: int                  # the opacity mixing passes it holds


class Runner:
    """A loop of one kind on one model, in chunks.  ``body(s, it, rounds)
    -> (new state, aux)`` is the loop's body at host counter ``it``;
    ``key(it)`` the branches it takes there; ``done_count`` the device
    counter that advances once per iteration run (``it`` or ``steps``).
    ``template`` (a device state) gives the static buffers their shapes
    and devices.  ``adjusts``: the body makes a convective adjustment of
    ``rounds`` rounds and returns (rounds needed, still unstable) as
    ``aux`` (None for unbounded rounds).  ``settings``: as resolved for
    the model (:data:`PER_ITERATION` for a sliced one); with ``rounds``
    bounded the runner holds its iterations, which the card captures."""

    def __init__(self, body: Callable, key: Callable, template,
                 done_count: str, adjusts: bool, settings: Settings,
                 stats: Stats):
        self.body, self.key, self.done_count = body, key, done_count
        self.settings = settings
        # iterations that a graph holds on the card (and runs eagerly on
        # the CPU)
        self.graphable = settings.rounds is not None
        self.bounded = adjusts and self.graphable
        self.capture = self.graphable and template.T_lay.is_cuda
        dev = template.T_lay.device
        self.static = _rebuild(template, [
            torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in _leaves(template)])
        self.names = _leaf_names(template)
        top = max(self.settings.rounds or 0, self.settings.entry_rounds or 0)
        self.overflow = torch.zeros((), dtype=torch.bool, device=dev)
        self.hist = torch.zeros(top + 2, dtype=torch.int64, device=dev)
        self.hist_seen = np.zeros(top + 2, np.int64)
        self.graphs: Dict[tuple, _Graph] = {}
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.stream = torch.cuda.Stream(dev) if self.capture else None
        self.take(stats)

    def take(self, stats: Stats) -> None:
        """Count into ``stats`` from now on (the Stats of the block that
        runs the runner, which may have been kept from an earlier one)."""
        self.stats = stats
        if self.bounded and stats.rounds is None:
            stats.rounds = [0] * self.hist.numel()

    # -- state in and out ------------------------------------------------- #

    def load(self, state):
        """Take a host-counter state into the static buffers (a planet's
        host counter by a fill, which reads nothing from host memory, a
        batch's [P] counters by a copy)."""
        self.fields = host_fields(state)
        for f in state._fields:
            if f in self.fields:
                value = getattr(state, f)
                dst = getattr(self.static, f)
                if np.ndim(value):
                    dst.copy_(torch.as_tensor(value))
                else:
                    dst.fill_(value)
                continue
            for dst, src in zip(_leaves(getattr(self.static, f)),
                                _leaves(getattr(state, f))):
                dst.copy_(src)

    def read(self):
        """The state's counters, the overflow flag and the rounds'
        histogram, one read."""
        self.stats.reads += 1
        with tracing.span("helios.read", self.stats, "read_s"):
            flags = read_flags(self.static, [self.overflow, self.hist])
        if self.bounded:
            hist = flags["extra1"].astype(np.int64)
            self.stats.rounds = [a + int(b) for a, b in zip(
                self.stats.rounds, hist - self.hist_seen)]
            self.hist_seen = hist
        return flags

    def result(self, flags):
        """The state as a host-counter state of its own tensors (the
        static buffers' cloned: the next replay does not overwrite
        them)."""
        out = _rebuild(self.static, [t.clone() for t in _leaves(self.static)])
        return to_host(out, flags, self.fields,
                       batched=out.T_lay.dim() > 1)

    # -- one iteration ---------------------------------------------------- #

    def _write(self, new, aux):
        """The new state where the planet (a member) ran at the
        iteration's start, the old one elsewhere, into the static buffers
        (``keep`` along each tensor's planet axis, on the tensor's device:
        a slice's may be another card); the adjustment's round count and
        flag, a batch's iteration counted once where a member ran."""
        keep = self.static.keep_running.clone()   # the writes overwrite it
        olds, news = _leaves(self.static), _leaves(new)
        # a result that shares a buffer of the state (T_store = T_lay) is
        # copied first: the writes below overwrite those buffers
        ptrs = {t.untyped_storage().data_ptr() for t in olds}
        news = [n if n is o or n.untyped_storage().data_ptr() not in ptrs
                else n.clone() for n, o in zip(news, olds)]
        for name, o, n in zip(self.names, olds, news):
            if n is not o:
                torch.where(member_mask(name, o, keep.to(o.device)), n, o,
                            out=o)
        if aux is not None:
            needed, unstable = aux
            self.overflow |= unstable
            slot = (needed + unstable).clamp(max=self.hist.numel() - 1)
            ran = keep.any() if keep.dim() else keep
            self.hist.index_add_(0, slot.reshape(1),
                                 ran.to(torch.int64).reshape(1))

    def graph_rounds(self, it: int) -> Optional[int]:
        """The adjustment rounds of iteration ``it`` as its graph runs it
        (None: unbounded, or no adjustment)."""
        if not self.bounded:
            return None
        return self.settings.entry_rounds if it == 0 else self.settings.rounds

    def _eager(self, it: int, rounds) -> Dict[str, int]:
        """Iteration ``it`` run eagerly; returns the launches it made (the
        wrappers counted them)."""
        before = _launches()
        with tracing.span("helios.iteration", self.stats, "eager_s"):
            new, aux = self.body(self.static, it, rounds)
            self._write(new, aux)
        self.stats.eager += 1
        made = _minus(_launches(), before)
        self.stats.mix_launches += made["ro_mix"]
        self.stats.adjust_launches += made["conv_adjust"]
        return made

    def _capture(self, it: int) -> _Graph:
        """Iteration ``it``'s body and write captured as a graph; a capture
        launches nothing, so the launch and mixing counts stay as they
        were (the mixing's host seconds count)."""
        before = _launches()
        mixes = self.stats.mixes
        with tracing.span("helios.capture", self.stats, "capture_s"):
            g = torch.cuda.CUDAGraph()
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                g.capture_begin(pool=self.pool)
                try:
                    new, aux = self.body(self.static, it,
                                         self.graph_rounds(it))
                    self._write(new, aux)
                finally:
                    g.capture_end()
            torch.cuda.current_stream().wait_stream(self.stream)
        held = _minus(_launches(), before)
        _set_launches(before)
        held_mixes = self.stats.mixes - mixes
        self.stats.mixes = mixes
        self.stats.graphs += 1
        return _Graph(g, held, held_mixes)

    def step(self, it: int) -> Dict[str, int]:
        """Iteration ``it`` (the host's counter): a replay of its key's
        graph, or without one the body run eagerly.  Returns the launches
        it made."""
        g = self.graphs.get(self.key(it)) if self.capture else None
        if g is None:
            return self._eager(it, self.graph_rounds(it))
        with tracing.span("helios.replay", self.stats, "replay_s"):
            g.graph.replay()
        for w in _kernel_wrappers():
            w.launches += g.launches[w.__name__]
        self.stats.replays += 1
        self.stats.mixes += g.mixes
        self.stats.mix_launches += g.launches["ro_mix"]
        self.stats.adjust_launches += g.launches["conv_adjust"]
        return g.launches

    # -- chunks ----------------------------------------------------------- #

    def _snapshot(self):
        return [t.clone() for t in _leaves(self.static)]

    def _restore(self, snap):
        for dst, src in zip(_leaves(self.static), snap):
            dst.copy_(src)

    def _idle(self, made: List[Dict[str, int]]) -> None:
        idle = self.stats.idle_launches
        for counts in made:
            for name, n in counts.items():
                idle[name] = idle.get(name, 0) + n

    def run(self, state, max_steps: Optional[int]):
        """Iterate from the host-counter ``state`` until the planet (every
        member of a batch) stops or ``max_steps`` iterations ran, in chunks
        of up to ``settings.chunk`` iterations and one read per chunk (and
        one at entry), with the state's card current (a graph replays on
        the current card's stream).  Returns the final host-counter
        state."""
        if self.capture:
            with torch.cuda.device(self.static.T_lay.device):
                return self._run(state, max_steps)
        return self._run(state, max_steps)

    def _run(self, state, max_steps: Optional[int]):
        self.load(state)
        flags = self.read()
        budget = max_steps
        while flags["keep_running"].any() and (budget is None
                                               or budget > 0):
            n = self.settings.chunk
            n = n if budget is None else min(n, budget)
            its = flags["it"][flags["keep_running"]]
            assert (its == its[0]).all(), its     # members share a counter
            it0 = int(its[0])
            done0 = flags[self.done_count]
            snap = None
            if self.bounded:
                self.overflow.zero_()
                snap = self._snapshot()
            made = [self.step(it0 + j) for j in range(n)]
            flags = self.read()
            tried = []
            if self.bounded and flags["extra0"][0]:
                # still unstable after the rounds: the chunk again from its
                # start, eagerly, with unbounded rounds
                self.stats.redos += 1
                self._restore(snap)
                tried = made
                made = [self._eager(it0 + j, None) for j in range(n)]
                flags = self.read()
            ran = int((flags[self.done_count] - done0).max())
            self.stats.iterations += ran
            self.stats.past_stop += n - ran
            self._idle(tried + made[ran:])
            # capture the keys that ran while the planet (a member) ran,
            # now that the read has shown it, if it runs on
            if self.capture and flags["keep_running"].any():
                for j in range(ran):
                    key = self.key(it0 + j)
                    if key not in self.graphs:
                        self.graphs[key] = self._capture(it0 + j)
            if budget is not None:
                budget -= n
        return self.result(flags)


# --------------------------------------------------------------------------- #
# who owns the runners
# --------------------------------------------------------------------------- #

def _compact(t: torch.Tensor) -> torch.Tensor:
    """``t`` with each broadcast (stride 0) dimension cut to one element:
    its distinct elements, which a copy can write."""
    return t.as_strided([1 if st == 0 else n
                         for n, st in zip(t.shape, t.stride())],
                        t.stride(), t.storage_offset())


def _version(t: torch.Tensor) -> Optional[int]:
    """``t``'s in-place write counter, None where it keeps none (an
    inference tensor)."""
    try:
        return t._version
    except RuntimeError:
        return None


class _Owned:
    """A kept runner's own copies of its owners' tensors, which its body
    reads: ``owners`` is the owners' tree on them, with the strides of
    the tensors first copied and their broadcast dimensions broadcast;
    ``load`` copies a later loop's owners (of the same signature ``sig``)
    into them, all but the tensors it copied last that no write has
    changed since."""

    def __init__(self, owners, sig):
        self.sig = sig
        leaves = _leaves(owners)
        self.dst = [_compact(t).clone() for t in leaves]
        self.owners = _rebuild(owners, [d.expand(t.shape) for d, t
                                        in zip(self.dst, leaves)])
        self.seen = [(weakref.ref(t), _version(t)) for t in leaves]

    def load(self, owners) -> None:
        for k, t in enumerate(_leaves(owners)):
            ref, version = self.seen[k]
            if ref() is t and version is not None and version == _version(t):
                continue
            self.dst[k].copy_(_compact(t))
            self.seen[k] = (weakref.ref(t), _version(t))


# the runners kept across blocks, one per loop kind: (key, runner, owned)
_KEPT: Dict[str, tuple] = {}


def clear_kept() -> None:
    """Drop the kept runners, their graphs, buffers and copies."""
    _KEPT.clear()


# graphs go before the CUDA context does
atexit.register(clear_kept)


class Loops:
    """The settings of the loops run inside one :func:`loops` block and
    their Stats, one per loop kind (``stats[kind]`` sums what the kind's
    runners did there)."""

    def __init__(self, settings: Settings):
        self.settings = settings
        self.stats: Dict[str, Stats] = {}

    def runner(self, kind: str, owners: tuple, bind: Callable, template,
               done_count: str, adjusts: bool) -> Runner:
        """The runner of loop ``kind`` on ``owners`` (phys, model, thermo,
        species set) with the state ``template``: one that holds
        iterations is the kept one of its key, taken over or made and
        kept; any other is made for this call alone.  ``bind(*owners) ->
        (body, key)`` (see :class:`Runner`) is called on the kept runner's
        copies of the owners, or on the owners."""
        stats = self.stats.setdefault(kind, Stats())
        settings = PER_ITERATION if count(owners[1]) else self.settings

        def make(on):
            body, key = bind(*on)
            return Runner(body, key, template, done_count, adjusts, settings,
                          stats)

        if settings.rounds is None:
            return make(owners)
        sig = _signature(owners)
        key = (kind, settings, done_count, adjusts, sig,
               _signature(template))
        if kind in _KEPT and _KEPT[kind][0] == key:
            stats.cache_hits += 1
            _, runner, owned = _KEPT[kind]
            owned.load(owners)
            runner.take(stats)
            return runner
        stats.cache_misses += 1
        # its graphs, and those of other owners, go before new ones
        for k in [k for k, (_, _, o) in _KEPT.items()
                  if k == kind or o.sig != sig]:
            del _KEPT[k]
        # the other kind's copies of these owners serve this runner too
        owned = (next(iter(_KEPT.values()))[2] if _KEPT
                 else _Owned(owners, sig))
        owned.load(owners)
        _KEPT[kind] = (key, make(owned.owners), owned)
        return _KEPT[kind][1]


_OPEN: contextvars.ContextVar = contextvars.ContextVar("loops", default=None)


@contextlib.contextmanager
def loops(settings: Optional[Settings] = None):
    """A block whose loops share their settings and Stats (:class:`Loops`,
    yielded).  Without ``settings`` an open block is joined, else one of
    the default settings opened."""
    outer = _OPEN.get()
    if settings is None and outer is not None:
        yield outer
        return
    scope = Loops(settings or Settings())
    token = _OPEN.set(scope)
    try:
        yield scope
    finally:
        _OPEN.reset(token)


def run_loop(kind: str, owners: tuple, bind: Callable, state,
             max_steps: Optional[int], done_count: str, adjusts: bool):
    """Run loop ``kind`` from the host-counter ``state`` on ``owners``
    (phys, model, thermo, species set), its body and key made by
    ``bind(*owners)`` (see :class:`Runner`, :meth:`Loops.runner`), in the
    open :func:`loops` block or in one of this call alone."""
    with loops() as scope:
        runner = scope.runner(kind, owners, bind, to_device(state),
                              done_count, adjusts)
        with tracing.running(runner.stats):
            return runner.run(state, max_steps)


def loop_stats(kind: str) -> Optional[Stats]:
    """The Stats of loop ``kind`` in the open :func:`loops` block; None
    outside a block."""
    scope = _OPEN.get()
    if scope is None:
        return None
    return scope.stats.setdefault(kind, Stats())
