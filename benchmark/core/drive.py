"""The one general driver of the traffic mixes: it makes a cell's inputs
(the opacity table, the start profile, one configuration per planet of the
mix) and calls the program's entry points on them.

A mix is data (traffic/<name>.json): its ``members`` (each a set of
configuration fields that override the configuration's, one planet each)
and its ``batch``, the planets per call: 1 solves each planet by
``helios_tpu_torch.pipeline.run``, more solve that many at once by
``helios_tpu_torch.parallel.ensemble.run_ensemble``.  Calls go in rounds:
every round solves every member once, in an order drawn from the seed, so
that every seed gives the same work in another order.

A configuration that names ``inputs`` brings inputs beyond the premixed
table: ``benchmark/inputs/<inputs>.py``'s ``make`` (``benchmark.inputs``
says its contract) is called once at set-up, its ``program`` keywords go
into every call of the entry points, and its ``reference`` arrays beside
the table's fields to the reference."""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from benchmark.frozen.table import make_table


@dataclass
class Call:
    """One call of the program: the members it solved, its host wall
    (s), the program's own walls and counts, and what it reported."""
    members: List[int]
    wall_s: float
    run_wall_s: float        # RunOutput.wall_seconds (the batch's)
    rad_s: float
    conv_s: float
    flux_solves: int         # loop iterations: the batch's, for a batch
    stats: Dict[str, dict]   # graphs.Stats per loop kind
    reports: List[dict] = field(default_factory=list)


def start_profile(p_lay, spec: dict) -> np.ndarray:
    """max(T_base (p/p_BOA)^slope, T_floor) on the layers."""
    return np.clip(spec["T_base"] * (p_lay / p_lay[0]) ** spec["slope"],
                   spec["T_floor"], None)


def write_tp_file(path: str, T) -> None:
    """T [L] in the "helios" TP format, the surface row equal to layer 0."""
    with open(path, "w") as f:
        f.write("start profile\nlayer T[K]\n")
        f.write(f"BOA {float(T[0])!r}\n")
        for i, t in enumerate(T):
            f.write(f"{i} {float(t)!r}\n")


def rounds(seed: int, n_members: int, batch: int):
    """The calls of each round, endlessly: a permutation of the members
    drawn from the seed, cut into calls of ``batch``."""
    rng = np.random.default_rng(seed)
    while True:
        order = [int(k) for k in rng.permutation(n_members)]
        yield [order[k:k + batch] for k in range(0, n_members, batch)]


class Program:
    """The program under test, fed a configuration file and a mix."""

    def __init__(self, cfg: dict, traffic: dict, device: str, tmpdir: str,
                 precision: str = None):
        from helios_tpu_torch.config import HeliosConfig
        from helios_tpu_torch.io.opacity import OpacityTable
        from benchmark.core.cell import inputs, reference

        self.device = device
        self.batch = int(traffic["batch"])
        self.members = traffic["members"]
        self.table_fields = make_table(cfg["table"])
        self.table = OpacityTable(**self.table_fields)
        ref = reference(cfg)
        helios = dict(cfg["helios"])
        if precision is not None:
            helios["precision"] = precision
        # the entry points' extra keywords, and the table argument of the
        # reference: the table's fields, with the inputs' arrays beside them
        self.program, self.reference_table = {}, self.table_fields
        make = inputs(cfg)
        if make is not None:
            extra = make(dict(cfg, helios=helios), self.table_fields, tmpdir,
                         device)
            self.program = dict(extra["program"])
            self.reference_table = dict(self.table_fields,
                                        **extra["reference"])
        p_lay, _ = ref.pressure_grid(ref.deployment(helios, {}))
        path = os.path.join(tmpdir, "start_tp.dat")
        write_tp_file(path, start_profile(p_lay, cfg["start_profile"]))
        self.cfgs = [HeliosConfig(**dict(
            helios, **member, name=f"member{k}",
            force_start_tp_from_file="yes", temp_format="helios",
            temp_path=path)).finalize()
            for k, member in enumerate(self.members)]

    def solve(self, members: List[int]) -> Call:
        """One call of the program on ``members``: whole solves, each
        (or the batch) in its own graphs.loops block."""
        from helios_tpu_torch import pipeline
        from helios_tpu_torch.parallel import ensemble
        from helios_tpu_torch.rce import graphs

        t0 = time.perf_counter()
        with graphs.loops() as lp:
            if len(members) == 1:
                outs = [pipeline.run(self.cfgs[members[0]], self.table,
                                     write_output=False, device=self.device,
                                     **self.program)]
                solves = outs[0].n_flux_solves
            else:
                outs = ensemble.run_ensemble(
                    [self.cfgs[k] for k in members],
                    tables=[self.table] * len(members), write_output=False,
                    device=self.device, **self.program)
                solves = (max(o.rad.it - o.rad_it0 for o in outs)
                          + max(o.conv.steps if o.conv is not None else 0
                                for o in outs))
            reports = [report(k, o) for k, o in zip(members, outs)]
            stats = {kind: st.as_dict() for kind, st in lp.stats.items()}
        wall = time.perf_counter() - t0
        o = outs[0]
        return Call(members=list(members), wall_s=wall,
                    run_wall_s=o.wall_seconds, rad_s=o.rad_seconds,
                    conv_s=o.conv_seconds, flux_solves=int(solves),
                    stats=stats, reports=reports)


def _flag(x) -> bool:
    return bool(np.asarray(x.detach().cpu() if hasattr(x, "detach") else x))


def report(member: int, out) -> dict:
    """What a run reports of one planet, on the host: its final
    temperatures, the layers it calls convective, its flux totals and TOA
    spectrum, and whether it converged."""
    r = out.result
    L = r.nlayer
    final = out.conv if out.conv is not None else out.rad
    converged = (not _flag(final.keep_running) and not _flag(out.rad.aborted)
                 and (out.conv is None or not _flag(out.conv.aborted)))
    T = np.asarray(r.T_lay, dtype=np.float64)
    return dict(member=member, T_lay=T,
                conv_layer=np.asarray(r.conv_layer).astype(bool),
                F_up_tot=np.asarray(r.F_up_tot, dtype=np.float64),
                F_down_tot=np.asarray(r.F_down_tot, dtype=np.float64),
                F_up_band_toa=np.asarray(r.F_up_band[L], dtype=np.float64),
                converged=converged, finite=bool(np.isfinite(T).all()))
