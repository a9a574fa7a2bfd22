"""The traced call: torch.profiler over one whole call of the program,
reduced to the device's busy time, the time in each of the program's CUDA
kernels, and the idle gaps by what the host was running."""

from __future__ import annotations

import time

from benchmark.frozen import trace

# the wrappers' launch counters and the kernels' names in a trace
KERNELS = {"noniso_sweep": "noniso_sweep_kernel",
           "iso_sweep": "iso_sweep_kernel",
           "thomas_solve": "thomas_kernel",
           "ro_mix": "ro_mix_kernel",
           "ordered_sum": "ordered_sum_kernel",
           "band_integrate": "band_integrate_kernel"}
SPAN = "benchmark.call"


def launch_counts() -> dict:
    from helios_tpu_torch.kernels.integrate import band_integrate
    from helios_tpu_torch.kernels.ordered import ordered_sum
    from helios_tpu_torch.kernels.ro import ro_mix
    from helios_tpu_torch.kernels.sweep import iso_sweep, noniso_sweep
    from helios_tpu_torch.kernels.thomas import thomas_solve
    fns = dict(noniso_sweep=noniso_sweep, iso_sweep=iso_sweep,
               thomas_solve=thomas_solve, ro_mix=ro_mix,
               ordered_sum=ordered_sum, band_integrate=band_integrate)
    return {k: f.launches for k, f in fns.items()}


def display_name(name: str) -> str:
    """An operation's name without its return type and argument list, at
    most 160 characters."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    name = name[5:] if name.startswith("void ") else name
    return name[:160] or "(unnamed)"


def short_name(name: str) -> str:
    """A kernel's name without its template arguments as well."""
    return display_name(name).split("<")[0]


def _demangler():
    """name -> demangled name, cached (a trace repeats a few hundred
    names a million times)."""
    import torch
    cache = {}

    def demangle(name):
        if name not in cache:
            cache[name] = torch._C._demangle(name) if name else name
        return cache[name]
    return demangle


def _events(prof):
    """(device events, host events, the call's span) of a finished
    profile, as (start s, end s, name), read from the raw Kineto events:
    the profiler's own event tree over a whole solve's million events
    takes minutes to build."""
    from torch.autograd import DeviceType
    device, host, window = [], [], None
    demangle = _demangler()
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        name = demangle(e.name())
        span = (s, s + e.duration_ns() * 1e-9, name)
        if name == SPAN:
            if e.device_type() == DeviceType.CPU:
                window = span[:2]
        elif e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(span)
        else:
            host.append(span)
    return device, host, window


def traced_call(call, tries: int = 3) -> tuple:
    """(the call's result, the reduced trace) of ``call()`` under the
    profiler; the call again, up to ``tries`` times, while the trace lacks
    a kernel that the call launched (CUPTI can drop a kernel's events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(tries):
        before = launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(SPAN):
                result = call()
                torch.cuda.synchronize()
        t = time.perf_counter()
        launched = {KERNELS[k] for k, n in launch_counts().items()
                    if n > before[k]}
        device, host, window = _events(prof)
        names = {short_name(n) for _, _, n in device}
        if launched <= names:
            break
    reduce_s = time.perf_counter() - t
    start, end = window
    intervals = [(s, e) for s, e, _ in device]
    kernel_of = {v: k for k, v in KERNELS.items()}
    by_kernel, by_name = {}, {}
    for s, e, n in device:
        shown = display_name(n)
        by_name[shown] = by_name.get(shown, 0.0) + (e - s)
        k = kernel_of.get(short_name(n))
        if k is not None:
            sec, cnt = by_kernel.get(k, (0.0, 0))
            by_kernel[k] = (sec + (e - s), cnt + 1)
    idle = trace.label_gaps(trace.gaps(intervals, start, end), host)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:10]]
    return result, dict(
        window_s=end - start, busy_s=trace.busy(intervals),
        device_s=sum(e - s for s, e in intervals),
        kernels=by_kernel, missing=sorted(launched - names),
        attempts=attempt + 1, events=len(device) + len(host),
        reduce_s=reduce_s,
        breakdown=dict(device_ops=top(by_name), idle_gaps=top(idle)))
