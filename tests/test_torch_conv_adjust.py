"""The convective adjustment's CUDA kernel (helios_tpu_torch.kernels.adjust,
csrc/conv_adjust.cu) and its route through rce.convect.

On the CPU: CPU tensors take the chain of PyTorch ops
(``convect.plain_adjustment``) and launch nothing; the wrapper refuses what
the kernel cannot take; on the kernel's route (meta tensors stand in for
CUDA ones, the launch stubbed) a bounded adjustment is one launch and an
unbounded one a launch per read of its host loop; the loops' Stats count
the kernel's launches.  On a card: the kernel bit for bit the chain on the
card, in fp64 and fp32, and a graphed convection loop bit for bit its
per-iteration twin.

This file imports no JAX, so on a machine with a card and no JAX it runs
without the suite's conftest:
    python -m pytest --noconftest tests/test_torch_conv_adjust.py -q
"""

import numpy as np
import pytest
import torch

from helios_tpu_torch import constants as pc
from helios_tpu_torch import pipeline, tracing
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.io.opacity import synthetic_premixed_table
from helios_tpu_torch.kernels import _launch, adjust
from helios_tpu_torch.parallel import ensemble
from helios_tpu_torch.rce import convect, graphs

F_INTERN = pc.SIGMA_SB * 500.0 ** 4


def column(seed, L=105, P=None, dtype=torch.float64, device="cpu",
           kappa_table=False, ghost_unstable=False):
    """A column (or P of them) of the adjustment's inputs: 105 layers over
    p 1e9..1e-1, blocks of layers steeper (unstable) and flatter (stable)
    than the adiabat, temperature inversions, narrow stable gaps; fluxes
    near the fudge factors' balance.  Returns (T_lay, the keyword
    arguments of convective_adjustment but T)."""
    rng = np.random.default_rng(seed)
    n = P or 1
    p_int = np.logspace(9, -1, L + 1)[:, None] * np.ones((1, n))
    p_lay = np.sqrt(p_int[:-1] * p_int[1:])
    if kappa_table:
        kl = rng.uniform(0.15, 0.3, (L, n))
        ki = rng.uniform(0.15, 0.3, (L + 1, n))
    else:
        kl, ki = np.full((L, n), 0.25), np.full((L + 1, n), 0.25)
    slope = np.empty((L, n))
    for q in range(n):
        i = 0
        while i < L:
            k = int(rng.integers(1, 12))
            slope[i:i + k, q] = rng.choice([-0.05, 0.05, 0.2, 0.3, 0.4],
                                           p=[0.1, 0.15, 0.15, 0.3, 0.3])
            i += k
    T = np.empty((L + 1, n))
    T[L - 1] = 300.0
    for i in range(L - 2, -1, -1):
        T[i] = T[i + 1] * (p_lay[i] / p_lay[i + 1]) ** slope[i]
    T[L] = T[0] * (1.3 if ghost_unstable else rng.uniform(0.98, 1.06, n))
    T *= 1 + rng.normal(0, 0.002, T.shape)
    F_down = rng.uniform(1e8, 2e8, (L + 1, n))
    arrays = dict(
        p_lay=p_lay, p_int=p_int, kappa_lay=kl, kappa_int=ki,
        c_p_lay=pc.R_UNIV / kl,
        meanmolmass_lay=2.3 * pc.AMU * (1 + rng.uniform(0, 0.01, (L, n))),
        F_add_heat_sum=rng.uniform(0, 1e3, (L, n)),
        F_smooth_sum=rng.uniform(-1e3, 1e3, (L, n)), F_down_tot=F_down,
        F_up_tot=F_down * rng.uniform(0.993, 1.007, (L + 1, n)) + F_INTERN)

    def t(a):
        x = torch.tensor(a, dtype=dtype, device=device)
        return (x if P else x[:, 0]).contiguous()

    return t(T), {k: t(v) for k, v in arrays.items()}


def adjust_call(fn, T, cols, *, rounds, members=None, iter_value=10,
                T_star=5000.0, dampara="automatic"):
    return fn(T, cols["p_lay"], cols["p_int"], cols["kappa_lay"],
              cols["kappa_int"], cols["c_p_lay"], cols["meanmolmass_lay"],
              iter_value=iter_value, T_star=T_star, input_dampara=dampara,
              F_intern=F_INTERN, F_add_heat_sum=cols["F_add_heat_sum"],
              F_smooth_sum=cols["F_smooth_sum"],
              F_down_tot=cols["F_down_tot"], F_up_tot=cols["F_up_tot"],
              members=members, rounds=rounds)


def assert_same(got, want, label):
    assert len(got) == len(want), label
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (label, k)
        assert torch.equal(a, b), (label, k, (a != b).sum().item())


# --------------------------------------------------------------------------- #
# the CPU's route
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("rounds", [4, None], ids=["bounded", "unbounded"])
@pytest.mark.parametrize("P", [None, 3], ids=["planet", "batch"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cpu_tensors_take_the_torch_chain(monkeypatch, dtype, P, rounds):
    """On the CPU convective_adjustment is the chain of PyTorch ops
    (plain_adjustment), and nothing reaches the kernel."""
    refuse = lambda *a, **k: pytest.fail("the kernel's route on the CPU")
    monkeypatch.setattr(adjust, "conv_adjust", refuse)
    monkeypatch.setattr(_launch, "launch", refuse)
    T, cols = column(1, L=24, P=P, dtype=dtype)
    members = None if P is None else torch.tensor([True, False, True])
    got = adjust_call(convect.convective_adjustment, T, cols, rounds=rounds,
                      members=members)
    want = adjust_call(convect.plain_adjustment, T, cols, rounds=rounds,
                       members=members)
    assert len(got) == (2 if rounds is None else 4)
    assert_same(got, want, "cpu route")
    assert not torch.equal(got[0], T)


# --------------------------------------------------------------------------- #
# the wrapper's checks, on the kernel's route
# --------------------------------------------------------------------------- #

NAMES = ("p_lay", "p_int", "kappa_lay", "kappa_int", "c_p_lay",
         "meanmolmass_lay", "F_add_heat_sum", "F_smooth_sum", "F_down_tot",
         "F_up_tot")


def wrapper_args(device="meta", P=None, dtype=torch.float64, L=6):
    T, cols = column(2, L=L, P=P, dtype=dtype)
    lead = T.shape[1:]
    args = [T.to(device)] + [cols[k].to(device) for k in NAMES]
    members = torch.ones(lead, dtype=torch.bool, device=device)
    kw = dict(rounds=4, stitching=False, T_star=5000.0,
              input_dampara="automatic", F_intern=F_INTERN)
    return args, members, kw


BAD = [
    ("cpu", lambda a, m: ([torch.zeros(x.shape, dtype=x.dtype) for x in a],
                          torch.ones(m.shape, dtype=torch.bool)),
     ValueError, "CUDA tensors"),
    ("half", lambda a, m: ([x.half() for x in a], m), TypeError,
     "unsupported dtype"),
    ("mixed_dtypes", lambda a, m: (a[:3] + [a[3].float()] + a[4:], m),
     TypeError, "one dtype"),
    ("layer_shape", lambda a, m: (a[:1] + [a[1][:-1]] + a[2:], m),
     ValueError, "shape"),
    ("interface_shape", lambda a, m: (a[:2] + [a[2][:-1]] + a[3:], m),
     ValueError, "shape"),
    ("not_contiguous", lambda a, m: (
        a[:5] + [torch.stack([a[5]] * 2, -1)[:, 0]] + a[6:], m),
     ValueError, "not contiguous"),
    ("members_dtype", lambda a, m: (a, m.double()), ValueError, "members"),
    ("members_shape", lambda a, m: (a, m[None]), ValueError, "members"),
    ("one_layer_too_few", lambda a, m: ([x[:1] for x in a], m), ValueError,
     "L >= 1"),
]


@pytest.mark.parametrize("spoil,exc,match", [b[1:] for b in BAD],
                         ids=[b[0] for b in BAD])
def test_wrapper_refuses_what_the_kernel_cannot_take(monkeypatch, spoil, exc,
                                                     match):
    monkeypatch.setattr(_launch, "launch",
                        lambda *a: pytest.fail("launched"))
    args, members, kw = wrapper_args()
    args, members = spoil(args, members)
    with pytest.raises(exc, match=match):
        adjust.conv_adjust(*args, members, **kw)


@pytest.mark.parametrize("rounds", [0, -1])
def test_wrapper_refuses_rounds_below_one(monkeypatch, rounds):
    monkeypatch.setattr(_launch, "launch",
                        lambda *a: pytest.fail("launched"))
    args, members, kw = wrapper_args()
    with pytest.raises(ValueError, match="rounds"):
        adjust.conv_adjust(*args, members, **dict(kw, rounds=rounds))


# --------------------------------------------------------------------------- #
# launches on the kernel's route
# --------------------------------------------------------------------------- #

CASES = [  # (iter_value, T_star, dampara) -> (stitching, mode, dampara)
    ((10, 5000.0, "automatic"), (0, adjust.DAMP_AUTOMATIC_STAR, 0.0)),
    ((6000, 5000.0, "automatic"), (1, adjust.DAMP_AUTOMATIC_STAR, 0.0)),
    ((10, 5.0, "automatic"), (0, adjust.DAMP_AUTOMATIC_NO_STAR, 0.0)),
    ((5001, 5000.0, "2.5"), (1, adjust.DAMP_USER, 2.5)),
]


@pytest.mark.parametrize("case,expected", CASES,
                         ids=["star", "stitching", "no_star", "user"])
@pytest.mark.parametrize("P", [None, 3], ids=["planet", "batch"])
def test_a_bounded_adjustment_is_one_launch(monkeypatch, P, case, expected):
    launched = []
    monkeypatch.setattr(_launch, "launch", lambda *a: launched.append(a))
    monkeypatch.setattr(adjust.conv_adjust, "launches", 0)
    T, cols = column(3, L=8, P=P)
    meta = {k: v.to("meta") for k, v in cols.items()}
    members = torch.ones(T.shape[1:], dtype=torch.bool, device="meta")
    iter_value, T_star, dampara = case
    out = adjust_call(convect.convective_adjustment, T.to("meta"), meta,
                      rounds=4, members=members, iter_value=iter_value,
                      T_star=T_star, dampara=dampara)
    assert adjust.conv_adjust.launches == 1 and len(launched) == 1
    name, tensors, ints, doubles = launched[0]
    assert name == "conv_adjust" and len(tensors) == 17
    stitching, mode, value = expected
    assert ints == (8, P or 1, 4, stitching, mode, 0)
    assert doubles == (F_INTERN, value)
    # the molar masses in units of AMU, the chain's quotient
    assert tensors[6] is not meta["meanmolmass_lay"]
    assert tensors[6].shape == meta["meanmolmass_lay"].shape
    # the outputs: T after the final correction, its marks, the rounds
    # needed and the overflow flag
    assert [t.dtype for t in out] == [torch.float64, torch.bool,
                                      torch.int64, torch.bool]
    assert out[0] is tensors[13] and out[1] is tensors[14]
    assert out[2].shape == () and out[3].shape == ()


@pytest.mark.parametrize("names,bits", [
    (("p_lay", "p_int"), 0b11),
    (("kappa_int", "F_smooth_sum", "F_up_tot"), 0b1010001000),
], ids=["pressures", "others"])
def test_shared_columns_are_read_as_they_are(monkeypatch, names, bits):
    """A batch's arrays that every member shares come as expanded views
    (strides (1, 0)): the route passes them on uncopied and the wrapper
    marks each with its bit in ``shared``."""
    launched = []
    monkeypatch.setattr(_launch, "launch", lambda *a: launched.append(a))
    T, cols = column(5, L=8, P=3)
    meta = {k: v.to("meta") for k, v in cols.items()}
    for k in names:
        meta[k] = meta[k][:, 0].contiguous()[:, None].expand(
            meta[k].shape)
    members = torch.ones(3, dtype=torch.bool, device="meta")
    adjust_call(convect.convective_adjustment, T.to("meta"), meta, rounds=4,
                members=members)
    (_, tensors, ints, _), = launched
    assert ints[-1] == bits
    for k in names:
        assert tensors[1 + NAMES.index(k)] is meta[k]


def test_other_strides_are_copied_on_the_route(monkeypatch):
    """An array the kernel cannot read as it is (here a member's column
    with stride 2) reaches it as a contiguous copy."""
    launched = []
    monkeypatch.setattr(_launch, "launch", lambda *a: launched.append(a))
    T, cols = column(6, L=8, P=3)
    meta = {k: v.to("meta") for k, v in cols.items()}
    wide = torch.empty((8, 6), dtype=torch.float64, device="meta")
    meta["c_p_lay"] = wide[:, ::2]
    adjust_call(convect.convective_adjustment, T.to("meta"), meta, rounds=4,
                members=torch.ones(3, dtype=torch.bool, device="meta"))
    (_, tensors, ints, _), = launched
    assert ints[-1] == 0
    assert tensors[5] is not meta["c_p_lay"] and tensors[5].is_contiguous()


class _Launches:
    """conv_adjust stubbed: each call returns the next of the scripted
    rounds as ``needed`` (on the CPU, where the loop reads it) and keeps
    what it returned, so that a test can follow each launch's input."""

    def __init__(self, needed):
        self.needed, self.calls, self.outs = list(needed), [], []

    def __call__(self, T, *args, rounds, **kw):
        self.calls.append((T, rounds))
        k = len(self.calls)
        self.outs.append(adjust.Adjusted(
            torch.empty_like(T), torch.empty_like(T),
            torch.empty(T.shape, dtype=torch.bool, device=T.device),
            torch.tensor(self.needed[k - 1]), torch.tensor(False)))
        return self.outs[-1]


@pytest.mark.parametrize("needed", [[0], [1, 0], [1, 1, 1, 0]],
                         ids=["stable", "one_round", "three_rounds"])
def test_an_unbounded_adjustment_is_one_launch_per_read(monkeypatch,
                                                        needed):
    """Without ``rounds`` each launch runs one round, its ``needed`` is
    the loop's read (one per round and one more, Stats.adjust_reads), the
    next launch starts from its T_round, and the last launch's final
    correction is the result."""
    stub = _Launches(needed)
    monkeypatch.setattr(adjust, "conv_adjust", stub)
    T, cols = column(4, L=8)
    meta = {k: v.to("meta") for k, v in cols.items()}
    stats = graphs.Stats()
    with tracing.running(stats):
        T_out, conv = adjust_call(convect.convective_adjustment,
                                  T.to("meta"), meta, rounds=None)
    n = len(needed)
    assert [r for _, r in stub.calls] == [1] * n
    assert stats.adjust_reads == n
    for (T_in, _), before in zip(stub.calls[1:], stub.outs):
        assert T_in is before.T_round
    assert T_out is stub.outs[-1].T_lay and conv is stub.outs[-1].conv_layer


def test_the_loops_count_the_kernels_launches(monkeypatch):
    """Stats.adjust_launches: one per bounded adjustment of an iteration
    (the graphed settings, eager on the CPU) and one per read of an
    unbounded one (PER_ITERATION), with the chain's calls counted as the
    launches they are on the card."""
    plain = convect.plain_adjustment

    def counted(*args, rounds=None, **kw):
        st = tracing.running_stats()
        reads = st.adjust_reads if st is not None else 0
        out = plain(*args, rounds=rounds, **kw)
        after = st.adjust_reads if st is not None else 0
        adjust.conv_adjust.launches += 1 if rounds else after - reads
        return out

    monkeypatch.setattr(convect, "plain_adjustment", counted)
    monkeypatch.setattr(adjust.conv_adjust, "launches", 0)
    cfg = HeliosConfig(
        planet="manual", g=2288.0, a=0.0153, R_planet=1.0, R_star=30.0,
        T_star=30.0, T_intern=700.0, scattering="yes", direct_beam="no",
        convection="yes", kappa_value=0.1, run_type="iterative", nlayer=12,
        p_boa=1e9, p_toa=1e3, adapt_interval=6, max_nr_iterations=40,
        physical_tstep=0.0).finalize()
    table = synthetic_premixed_table(nbin=8, ny=4, ntemp=8, npress=6, seed=1)
    table.kpoints *= 10.0
    graphs.clear_kept()
    try:
        for settings in (graphs.Settings(chunk=4), graphs.PER_ITERATION):
            with graphs.loops(settings) as lp:
                pipeline.run(cfg, table, write_output=False, device="cpu")
            conv = lp.stats["convection"]
            its = conv.iterations + conv.past_stop
            assert its > 0
            if settings.rounds is None:
                assert conv.adjust_launches == conv.adjust_reads > its
            else:
                assert conv.adjust_launches == its and conv.redos == 0
            assert lp.stats["radiation"].adjust_launches == 0
    finally:
        graphs.clear_kept()


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return "cuda"


CARD_CASES = {
    # name: (column keywords, call keywords)
    "planet_K1": (dict(seed=10), dict(rounds=1)),
    "planet_K4": (dict(seed=11), dict(rounds=4)),
    "planet_K40": (dict(seed=12), dict(rounds=40)),
    "batch3_one_not_running": (dict(seed=13, P=3),
                               dict(rounds=4, members=[True, False, True])),
    "ghost_in_zone": (dict(seed=14, ghost_unstable=True), dict(rounds=4)),
    "stitching": (dict(seed=15, P=2), dict(rounds=4, iter_value=6000)),
    "user_dampara": (dict(seed=16), dict(rounds=4, dampara="3.0")),
    "no_star": (dict(seed=17), dict(rounds=4, T_star=5.0)),
    "kappa_table": (dict(seed=18, kappa_table=True, P=2),
                    dict(rounds=4, iter_value=7000)),
}


def card_inputs(name, dtype, device):
    col_kw, call_kw = CARD_CASES[name]
    T, cols = column(dtype=dtype, device=device, **col_kw)
    call_kw = dict(call_kw)
    members = call_kw.pop("members", None)
    lead = T.shape[1:]
    call_kw["members"] = (torch.ones(lead, dtype=torch.bool, device=device)
                          if members is None else
                          torch.tensor(members, device=device))
    return T, cols, call_kw


@pytest.mark.parametrize("name", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_is_the_chain_bit_for_bit(cuda_device, dtype, name):
    """One launch against the chain on the card (its sums through
    ordered_sum): the adjusted T, the marks, the rounds needed and the
    overflow flag, bit for bit; and the host loop of one round per launch
    against the chain's unbounded loop, where that loop ends."""
    T, cols, kw = card_inputs(name, dtype, cuda_device)
    before = adjust.conv_adjust.launches
    got = adjust_call(convect.convective_adjustment, T, cols, **kw)
    assert adjust.conv_adjust.launches == before + 1
    want = adjust_call(convect.plain_adjustment, T, cols, **kw)
    assert_same(got, want, name)
    assert not torch.equal(got[0], T)
    ends = not bool(adjust_call(convect.plain_adjustment, T, cols,
                                **dict(kw, rounds=300))[3])
    if ends:
        got = adjust_call(convect.convective_adjustment, T, cols,
                          **dict(kw, rounds=None))
        want = adjust_call(convect.plain_adjustment, T, cols,
                           **dict(kw, rounds=None))
        assert_same(got, want, name + " unbounded")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_overflow_sets_needed_and_the_flag(cuda_device, dtype):
    """An adjustment that needs more rounds than it is given reports
    needed = K and the flag, as the chain does."""
    T, cols, kw = card_inputs("planet_K4", dtype, cuda_device)
    got = adjust_call(convect.convective_adjustment, T, cols,
                      **dict(kw, rounds=1))
    want = adjust_call(convect.plain_adjustment, T, cols,
                       **dict(kw, rounds=1))
    assert_same(got, want, "overflow")
    assert int(got[2]) == 1 and bool(got[3])


def _small_config(k=0, **kw):
    run = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
               R_star=30.0, T_star=30.0, T_intern=700.0, scattering="yes",
               direct_beam="no", convection="yes", kappa_value=0.1,
               run_type="iterative", nlayer=12, p_boa=1e9, p_toa=1e3,
               adapt_interval=6)
    return HeliosConfig(**dict(run, name=f"p{k}", **kw)).finalize()


def _small_table():
    t = synthetic_premixed_table(nbin=8, ny=4, ntemp=8, npress=6, seed=1)
    t.kpoints *= 10.0
    return t


@pytest.mark.parametrize("batch", [False, True], ids=["planet", "batch3"])
def test_graphed_convection_loop_is_per_iteration(cuda_device, batch):
    """The graphed loops (one launch per adjustment) bit for bit the
    per-iteration loop (one launch per round and one more), every member
    of a batch, and the graphed convection loop launches the kernel once
    per iteration it ran or replayed past the stop."""
    albedos = (0.0, 0.3, 0.6) if batch else (0.0,)
    cfgs = [_small_config(k, surf_albedo=a) for k, a in enumerate(albedos)]

    def solve(settings):
        with graphs.loops(settings) as lp:
            if batch:
                outs = ensemble.run_ensemble(
                    cfgs, tables=[_small_table()] * len(cfgs),
                    write_output=False, device=cuda_device)
            else:
                outs = [pipeline.run(cfgs[0], _small_table(),
                                     write_output=False,
                                     device=cuda_device)]
        return outs, lp.stats

    graphs.clear_kept()
    try:
        graphed, st = solve(None)
        per, _ = solve(graphs.PER_ITERATION)
    finally:
        graphs.clear_kept()
    conv = st["convection"]
    assert conv.replays > 0 and conv.iterations > 0
    assert conv.adjust_launches >= conv.iterations + conv.past_stop
    if conv.redos == 0:
        assert conv.adjust_launches == conv.iterations + conv.past_stop
    for k, (a, b) in enumerate(zip(graphed, per)):
        assert torch.equal(a.T_lay, b.T_lay), k
        assert (a.rad.it, a.conv.it) == (b.rad.it, b.conv.it), k
        assert torch.equal(a.totals.F_up_band, b.totals.F_up_band), k
