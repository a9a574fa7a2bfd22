"""The flux integration of helios_tpu_torch in one kernel
(``kernels.integrate.band_integrate``, ``csrc/band_integrate.cu``) and the
launch path every kernel wrapper shares (``kernels._launch``), on the CPU.

The kernel fuses the chain of PyTorch ops and fixed-order sums that the
port ran per flux solve: the Gauss sums, the halvings, the band products
and the two totals over the bins.  Here, with the same inputs made from a
seed with numpy:
  - the plain version agrees with the JAX package's integrate_flux_flat
    (rtol 1e-13 in fp64, 2e-6 in fp32: jnp.sum adds in another order);
  - its in-order variant (in_order_reference for every sum, what the card
    computes) is bit for bit the chain as it stood in forward._band_totals
    and fastpath.gauss_band_flat, and bit for bit a numpy transcription of
    the kernel's loops, for a planet, a batch and a sliced pair of calls
    with a carry and a padded bin, in fp64 and fp32;
  - the wrapper's CPU route is bit for bit that chain with torch.sum;
  - with the launch stubbed, every integration launches the kernel once
    (once per slice), with the tensors and ints in the order the C entry
    point declares them;
  - the launch path switches the card only for a tensor off the current
    one, and switches back.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from helios_tpu import forward as jf

from helios_tpu_torch import forward as tf
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.io.opacity import synthetic_premixed_table
from helios_tpu_torch.kernels import _build, _launch
from helios_tpu_torch.kernels.integrate import (band_integrate,
                                                band_integrate_reference)
from helios_tpu_torch.kernels.ordered import in_order_reference, ordered_sum
from helios_tpu_torch.ops import slices

import torch_port_helpers  # noqa: F401  (one torch thread)

L, NBIN, NY, P = 12, 65, 4, 3
DTYPES = {"f64": torch.float64, "f32": torch.float32}


def _inputs(dtype, members=None, nbin=NBIN, seed=0):
    """Fluxes [L+1, (P,) S], gauss_weight [ny], delta_lambda [(P,) nbin]:
    positive, of the scales of a run."""
    rng = np.random.default_rng(seed)
    lead = (L + 1,) if members is None else (L + 1, members)
    f = [rng.uniform(0.0, 1e5, lead + (nbin * NY,)) for _ in range(3)]
    w = rng.uniform(0.1, 0.7, NY)
    dl = rng.uniform(1e-6, 1e-4, (nbin,) if members is None
                     else (members, nbin))
    t = lambda x: torch.tensor(x, dtype=dtype)
    return [t(x) for x in f] + [t(w), t(dl)]


def _sum_in_order(x, dim):
    return in_order_reference(x, dim, scan=False)


def todays_chain(F_down, F_up, F_dir, w, dl, carry=None, total=torch.sum):
    """The chain the kernel replaces, as fastpath.gauss_band_flat and
    forward._band_totals ran it (``total``: the sums, torch.sum on the CPU,
    the fixed-order kernel on the card), F_net after the last slice."""
    ny = w.shape[0]
    cube = lambda x: x.reshape(x.shape[:-1] + (x.shape[-1] // ny, ny))
    gauss = lambda f: 0.5 * total(cube(f) * w, -1)
    F_down_band, F_up_band, F_dir_band = gauss(F_down), gauss(F_up), gauss(
        F_dir)
    up = F_up_band * dl
    down = (F_dir_band + F_down_band) * dl
    if carry is not None:
        up, down = (torch.cat([c.unsqueeze(-1), x], -1)
                    for c, x in zip(carry, (up, down)))
    up, down = total(up, -1), total(down, -1)
    return (F_down_band, F_up_band, F_dir_band, up, down, up - down)


def kernel_loops(F_down, F_up, F_dir, w, dl, carry=None):
    """The kernel's arithmetic as numpy loops in its order (each product,
    add and difference rounded on its own in the tensors' dtype)."""
    f = [x.numpy() for x in (F_down, F_up, F_dir)]
    w, dl = w.numpy(), dl.numpy()
    dt = f[0].dtype.type
    ny = len(w)
    nbin = f[0].shape[-1] // ny
    bands = []
    for x in f:
        s = np.zeros(x.shape[:-1] + (nbin,), dtype=dt)
        for y in range(ny):
            s = s + x[..., y::ny] * w[y]
        bands.append(dt(0.5) * s)
    d, u, r = bands
    up_b, down_b = u * dl, (r + d) * dl
    up = np.zeros(up_b.shape[:-1], dtype=dt)
    down = np.zeros_like(up)
    if carry is not None:
        up, down = up + carry[0].numpy(), down + carry[1].numpy()
    for b in range(nbin):
        up, down = up + up_b[..., b], down + down_b[..., b]
    return [torch.from_numpy(np.asarray(v)) for v in (d, u, r, up, down,
                                                       up - down)]


def _equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), (what, k)


def _sliced_inputs(dtype, members):
    """Two slices of the fluxes and delta_lambda, the bins padded to 66 by
    a copy of the last (delta_lambda 0 there), and the whole inputs."""
    F_down, F_up, F_dir, w, dl = _inputs(dtype, members, seed=3)
    pad_f = lambda x: torch.cat([x, x[..., -NY:]], -1)
    pad_dl = torch.cat([dl, torch.zeros_like(dl[..., -1:])], -1)
    fs = [pad_f(x) for x in (F_down, F_up, F_dir)]
    h = (NBIN + 1) // 2
    part = lambda k: ([x[..., k * h * NY:(k + 1) * h * NY].contiguous()
                       for x in fs]
                      + [w, pad_dl[..., k * h:(k + 1) * h].contiguous()])
    return (F_down, F_up, F_dir, w, dl), part(0), part(1)


# --------------------------------------------------------------------------- #
# the plain version against the JAX package
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("members", [None, P], ids=["planet", "batch"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_plain_version_matches_jax(name, members):
    dtype = DTYPES[name]
    F_down, F_up, F_dir, w, dl = _inputs(dtype, members)
    rtol = 1e-13 if dtype == torch.float64 else 2e-6
    port = band_integrate_reference(F_down, F_up, F_dir, w, dl)
    in_order = band_integrate_reference(F_down, F_up, F_dir, w, dl,
                                        in_order=True)
    fields = ("F_down_band", "F_up_band", "F_dir_band", "F_up_tot",
              "F_down_tot", "F_net")
    for p in range(members or 1):
        # member p: the planet axis after the layer axis ([P, nbin] rows)
        pick = (lambda x: x) if members is None else (lambda x: x[:, p])
        j = jf.integrate_flux_flat(
            None, SimpleNamespace(gauss_weight=w.numpy(),
                                  delta_lambda=(dl if members is None
                                                else dl[p]).numpy()),
            SimpleNamespace(F_down=pick(F_down).numpy(),
                            F_up=pick(F_up).numpy()), pick(F_dir).numpy())
        for f in fields:
            want = np.asarray(getattr(j, f))
            scale = np.abs(want).max()
            for res in (port, in_order):
                got = pick(getattr(res, f)).numpy()
                assert got.dtype == want.dtype, f
                np.testing.assert_allclose(got, want, rtol=rtol,
                                           atol=rtol * scale, err_msg=f)


# --------------------------------------------------------------------------- #
# the in-order reference: the card's chain, bit for bit
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("layout", ["planet", "batch", "batch_shared_dl"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_in_order_reference_is_the_chain_bitwise(name, layout):
    dtype = DTYPES[name]
    members = None if layout == "planet" else P
    F_down, F_up, F_dir, w, dl = _inputs(dtype, members, seed=1)
    if layout == "batch_shared_dl":         # stack_models' expanded view
        dl = dl[:1].expand(P, NBIN)
    got = band_integrate_reference(F_down, F_up, F_dir, w, dl,
                                   in_order=True)
    want = todays_chain(F_down, F_up, F_dir, w, dl, total=_sum_in_order)
    _equal(got, want, "chain")
    _equal(got, kernel_loops(F_down, F_up, F_dir, w, dl), "loops")


@pytest.mark.parametrize("members", [None, P], ids=["planet", "batch"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_in_order_reference_carries_a_sliced_total_bitwise(name, members):
    """Two slices, the second with a padded bin: the second call starts
    from the first's totals; the totals are bit for bit the chain's over
    the whole bin axis, the bands its bands."""
    whole, first, second = _sliced_inputs(DTYPES[name], members)
    a = band_integrate_reference(*first, in_order=True)
    b = band_integrate_reference(*second, carry=(a.F_up_tot, a.F_down_tot),
                                 in_order=True)
    want_b = todays_chain(*second, carry=(a.F_up_tot, a.F_down_tot),
                          total=_sum_in_order)
    _equal(b, want_b, "second slice")
    _equal(b, kernel_loops(*second, carry=(a.F_up_tot, a.F_down_tot)),
           "second slice, loops")
    full = todays_chain(*whole, total=_sum_in_order)
    _equal(b[3:], full[3:], "totals")
    bands = [torch.cat([x, y], -1)[..., :NBIN] for x, y in zip(a[:3], b[:3])]
    _equal(bands, full[:3], "bands")


# --------------------------------------------------------------------------- #
# the wrapper on the CPU
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ["planet", "batch", "carry"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_cpu_route_is_todays_chain(name, case):
    dtype = DTYPES[name]
    members = None if case == "planet" else P
    args = _inputs(dtype, members, seed=2)
    carry = None
    if case == "carry":
        carry = tuple(torch.tensor(np.random.default_rng(4).uniform(
            0.0, 1.0, (L + 1, P)), dtype=dtype) for _ in range(2))
    before = (band_integrate.launches, ordered_sum.launches)
    got = band_integrate(*args, carry)
    assert (band_integrate.launches, ordered_sum.launches) == before
    _equal(got, todays_chain(*args, carry), "cpu route")


# --------------------------------------------------------------------------- #
# the launches, stubbed: one per integration, in the entry point's order
# --------------------------------------------------------------------------- #

def c_parameter_names(name):
    """The parameter names of ``<name>_f64`` in ``csrc/<name>.cu``."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    block = text[text.index('extern "C" {'):]
    m = re.search(rf"\bint\s+{name}_f64\s*\((.*?)\)\s*\{{", block, re.DOTALL)
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


@pytest.fixture(scope="module")
def small_model():
    table = synthetic_premixed_table(nbin=12, ny=NY, ntemp=6, npress=5,
                                     seed=7)
    cfg = HeliosConfig(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                       R_star=1.0, T_star=4000.0, T_intern=100.0,
                       scattering="yes", direct_beam="no",
                       convection="no", run_type="iterative",
                       iso_input="no", nlayer=L).finalize()
    return tf.build_model(cfg, table, device="cpu")


@pytest.mark.parametrize("n_slices", [0, 2, 3])
@pytest.mark.parametrize("members", [None, P], ids=["planet", "batch"])
def test_one_launch_per_integration(monkeypatch, small_model, members,
                                    n_slices):
    phys, arrays = small_model
    meta = torch.device("meta")
    m = type(arrays)(*(x.to(meta) for x in arrays))
    if members:     # stack_models' view of a field every member shares
        m = m._replace(delta_lambda=m.delta_lambda.expand(members, -1))
    lead = (L + 1,) if members is None else (L + 1, members)
    S = phys.nbin * NY
    flux = tf.FluxState(*(torch.empty(lead + (S,), dtype=torch.float64,
                                      device=meta) for _ in range(2)),
                        None, None)
    F_dir = torch.empty(lead + (S,), dtype=torch.float64, device=meta)
    if n_slices:
        devs = [meta] * n_slices
        m = m._replace(**{f: slices.split(getattr(m, f), devs)
                          for f in slices.MODEL_SPECTRAL})
        flux = flux._replace(F_down=slices.split(flux.F_down, devs),
                             F_up=slices.split(flux.F_up, devs))
        F_dir = slices.split(F_dir, devs)
    launched = []
    monkeypatch.setattr(_launch, "launch", lambda name, tensors, ints:
                        launched.append((name, tensors, ints)))
    tf.integrate_flux_flat(phys, m, flux, F_dir)

    assert [k[0] for k in launched] == ["band_integrate"] * max(1, n_slices)
    names = c_parameter_names("band_integrate")
    B = phys.nbin // max(1, n_slices)
    for k, (_, tensors, ints) in enumerate(launched):
        assert len(tensors) + len(ints) + 1 == len(names)
        arg = dict(zip(names, list(tensors) + list(ints)))
        for f in ("f_down", "f_up", "f_dir"):
            assert tuple(arg[f].shape) == lead + (B * NY,), f
        assert tuple(arg["w"].shape) == (NY,)
        assert tuple(arg["bands"].shape) == (3,) + lead + (B,)
        assert tuple(arg["tots"].shape) == (3,) + lead
        assert (arg["R"], arg["B"], arg["Y"]) == (np.prod(lead), B, NY)
        # a batch reads the members' shared delta_lambda as its view (a
        # slice holds its own copy)
        assert tuple(arg["dl"].shape) == ((B,) if members is None
                                          else (members, B))
        assert (arg["P"], arg["dl_stride"]) == (
            (1, 0) if members is None else (members, B if n_slices else 0))
        assert arg["has_carry"] == int(k > 0)
        if k:
            assert tuple(arg["carry_up"].shape) == lead
            # the totals [3, ..] of the slice before
            tots = launched[k - 1][1][-1]
            assert arg["carry_up"]._base is tots
            assert arg["carry_down"]._base is tots
            assert arg["carry_up"].storage_offset() == 0
            assert arg["carry_down"].storage_offset() == tots.stride(0)


BAD_ARGUMENTS = [
    ("flux_shape", lambda a: a.__setitem__(1, a[1][:-1]), ValueError,
     "shape"),
    ("not_a_multiple_of_ny", lambda a: a.__setitem__(
        slice(0, 3), [x[..., :-1] for x in a[:3]]), ValueError,
     "multiple of ny"),
    ("dl_shape", lambda a: a.__setitem__(4, a[4][:-1]), ValueError,
     "delta_lambda"),
    ("dl_dtype", lambda a: a.__setitem__(4, a[4].float()), ValueError,
     "delta_lambda"),
    ("dl_strided", lambda a: a.__setitem__(
        4, torch.stack([a[4]] * 2, -1)[:, 0]), ValueError, "unit stride"),
    ("weight_dtype", lambda a: a.__setitem__(3, a[3].float()), TypeError,
     "dtype"),
    ("half", lambda a: a.__setitem__(slice(None),
                                     [x.half() for x in a]), TypeError,
     "unsupported dtype"),
]


@pytest.mark.parametrize("spoil,exc,match", [b[1:] for b in BAD_ARGUMENTS],
                         ids=[b[0] for b in BAD_ARGUMENTS])
def test_kernel_route_refuses_what_the_kernel_cannot_take(monkeypatch, spoil,
                                                          exc, match):
    """On the kernel's route (meta tensors stand in for CUDA ones) what the
    kernel cannot take raises; nothing reaches the launch."""
    monkeypatch.setattr(_launch, "launch", lambda *a: pytest.fail("launched"))
    args = [x.to("meta") for x in _inputs(torch.float64)]
    spoil(args)
    with pytest.raises(exc, match=match):
        band_integrate(*args)


# --------------------------------------------------------------------------- #
# the launch path's device switch, on a stub of the card
# --------------------------------------------------------------------------- #

class _StubCard:
    """torch.cuda's current device, device switch and current stream as
    the launch path uses them, on no card: records every switch and the
    device and stream of every launch."""

    def __init__(self, current):
        self.current, self.switches, self.launches = current, [], []
        card = self

        class device:
            def __init__(self, index):
                self.index = index

            def __enter__(self):
                self.prev, card.current = card.current, self.index
                card.switches.append(self.index)

            def __exit__(self, *exc):
                card.current = self.prev
                card.switches.append(self.prev)
                return False

        self.device = device

    def current_device(self):
        return self.current

    def current_stream(self, index):
        assert index == self.current, "a stream of another device"
        return SimpleNamespace(cuda_stream=1000 + index)

    def entry(self, *args):
        self.launches.append((self.current, args[-1]))
        return 0


class _StubTensor:
    """A float64 CUDA tensor on card ``index`` as the launch path sees it."""
    is_cuda = True
    dtype = torch.float64

    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index

    def data_ptr(self):
        return 4096 * (self.index + 1)


@pytest.mark.parametrize("current,on", [(0, 0), (0, 1), (1, 0), (2, 2)])
def test_launch_switches_device_only_off_the_current_one(monkeypatch,
                                                         current, on):
    card = _StubCard(current)
    for name in ("current_device", "current_stream", "device"):
        monkeypatch.setattr(torch.cuda, name, getattr(card, name))
    monkeypatch.setattr(_launch, "entry", lambda *key: card.entry)
    _launch.launch("stub", (_StubTensor(on), _StubTensor(on)), (7,))
    assert card.launches == [(on, 1000 + on)]
    assert card.switches == ([] if on == current else [on, current])
    assert card.current == current


def test_launch_names_a_failed_launch(monkeypatch):
    card = _StubCard(0)
    for name in ("current_device", "current_stream", "device"):
        monkeypatch.setattr(torch.cuda, name, getattr(card, name))
    monkeypatch.setattr(_launch, "entry", lambda *key: lambda *a: 9)
    lib = SimpleNamespace(
        helios_cuda_error_string=lambda rc: b"invalid configuration",
        helios_launch_error_detail=lambda: b"ny = 9000 is too many")
    monkeypatch.setattr(_launch, "_library", lambda *a: lib)
    with pytest.raises(RuntimeError, match=r"stub launch failed: invalid "
                       r"configuration \(ny = 9000 is too many\)"):
        _launch.launch("stub", (_StubTensor(0),), ())


def test_launch_refuses_other_devices_and_dtypes():
    with pytest.raises(ValueError, match="cuda or cpu"):
        _launch.launch("band_integrate",
                       (torch.empty(2, device="meta"),), ())
    with pytest.raises(TypeError, match="unsupported dtype"):
        _launch.entry("band_integrate", torch.float16, 9, 6)
