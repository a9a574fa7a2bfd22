"""The C interface of each CUDA kernel of the port against what its wrapper
passes.

A wrapper hands ``_launch.launch`` its tensors (inputs, outputs, scratch),
its ints and its doubles, and ``_launch`` types the entry points
``<name>_f64`` and ``<name>_f32`` of ``csrc/<name>.cu`` as that many
pointers, that many ints, that many doubles and the stream.  An entry
point that takes another list still builds and loads, and fails only on
the card: as a pointer that ctypes cuts, or an argument read from garbage.
Here, on the CPU, each wrapper runs on meta tensors with the launch
captured, and what it passes is held against the parameter list parsed
from the source: each pointer of its tensor's C type.
"""

import re

import pytest
import torch

from helios_tpu_torch.kernels import (_build, _launch, adjust, integrate,
                                      ordered, ro, sweep, thomas)


def _meta(dtype, *shape):
    return torch.empty(shape, dtype=dtype, device="meta")


# source name -> (wrapper, its arguments for a dtype)
L, S, N, C, NY = 3, 5, 8, 4, 6
CALLS = {
    "noniso_sweep": (sweep.noniso_sweep, lambda dt: (
        [_meta(dt, L, S)] * 8 + [_meta(dt, S)] * 4
        + [_meta(dt, L + 1, S), _meta(dt, L, S)], dict(n_passes=4))),
    "iso_sweep": (sweep.iso_sweep, lambda dt: (
        [_meta(dt, L, S)] * 4 + [_meta(dt, S)] * 4 + [_meta(dt, L + 1, S)],
        dict(n_passes=4))),
    "thomas": (thomas.thomas_solve, lambda dt: (
        [_meta(dt, N, S)] * 3, {})),
    "ro_mix": (ro.ro_mix, lambda dt: (
        [_meta(dt, C, NY)] * 2 + [_meta(dt, NY)] * 2, {})),
    "ordered_sum": (ordered.ordered_sum, lambda dt: (
        [_meta(dt, L, S, NY)], dict(dim=1))),
    "band_integrate": (integrate.band_integrate, lambda dt: (
        [_meta(dt, L + 1, C, S * NY)] * 3 + [_meta(dt, NY), _meta(dt, C, S),
                                            [_meta(dt, L + 1, C)] * 2],
        {})),
    "conv_adjust": (adjust.conv_adjust, lambda dt: (
        [_meta(dt, L + 1, C), _meta(dt, L, C), _meta(dt, L + 1, C),
         _meta(dt, L, C), _meta(dt, L + 1, C)] + [_meta(dt, L, C)] * 4
        + [_meta(dt, L + 1, C)] * 2
        + [torch.empty(C, dtype=torch.bool, device="meta")],
        dict(rounds=4, stitching=True, T_star=5000.0,
             input_dampara="automatic", F_intern=1.0))),
}
CTYPE = {torch.float64: "double", torch.float32: "float"}
# the C type of a pointer to each dtype's elements
POINTEE = {**CTYPE, torch.bool: "bool", torch.int64: "long long"}


def c_parameters(name, suffix):
    """The parameters of ``<name>_<suffix>`` in the ``extern "C"`` block of
    ``csrc/<name>.cu``, whitespace normalised."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    block = text[text.index('extern "C" {'):]
    m = re.search(rf"\bint\s+{name}_{suffix}\s*\((.*?)\)\s*\{{", block,
                  re.DOTALL)
    assert m, f"{name}.cu has no extern \"C\" entry point {name}_{suffix}"
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def test_every_source_has_a_case():
    assert sorted(CALLS) == _build.kernel_names()


@pytest.mark.parametrize("dtype", list(CTYPE), ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(CALLS))
def test_wrapper_matches_entry_point(monkeypatch, name, dtype):
    wrapper, make = CALLS[name]
    launched = []
    monkeypatch.setattr(
        _launch, "launch", lambda kernel, tensors, ints, doubles=():
        launched.append((kernel, [t.dtype for t in tensors], len(ints),
                         len(doubles))))
    monkeypatch.setattr(wrapper, "launches", 0)
    args, kw = make(dtype)
    wrapper(*args, **kw)
    assert len(launched) == 1 and launched[0][0] == name
    _, dtypes, n_ints, n_doubles = launched[0]
    n_tensors = len(dtypes)
    assert dtypes[0] == dtype

    params = c_parameters(name, _launch.SUFFIX[dtype])
    assert len(params) == n_tensors + n_ints + n_doubles + 1, (
        f"{name}_{_launch.SUFFIX[dtype]} takes {len(params)} parameters, "
        f"the wrapper passes {n_tensors} tensors, {n_ints} ints, "
        f"{n_doubles} doubles and the stream")
    for p, dt in zip(params[:n_tensors], dtypes):
        pointer = re.compile(rf"(const )?{POINTEE[dt]}\* ?\w+")
        assert pointer.fullmatch(p), f"{name}: {p!r} is not a {dt} pointer"
    for p in params[n_tensors:n_tensors + n_ints]:
        assert re.fullmatch(r"int \w+", p), f"{name}: {p!r} is not an int"
    for p in params[n_tensors + n_ints:-1]:
        assert re.fullmatch(r"double \w+", p), (
            f"{name}: {p!r} is not a double")
    assert re.fullmatch(r"void\* ?\w+", params[-1]), (
        f"{name}: the last parameter {params[-1]!r} is not the stream")
