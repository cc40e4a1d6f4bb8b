"""vrp_delta_roofline (fused kernel: `csrc/vrp_delta.cu`): the least time a
launch can take (`_kernel_bound`, from each launch's own inputs) over the
time the kernel ran, as a share. Launches and kernels are those of the
traced window; the kernel is found in the trace by name."""

from gjbench.metrics import _kernel_bound

KERNEL = "vrp_delta"


def probe(tracer):
    """Keep the inputs of every launch inside the window (references, no
    copy and no device work), and work out each one's bound when the
    window has closed."""
    from greyjack_tpu_torch.models.vrp import delta_kernel

    call = delta_kernel._call_kernel
    kept = []

    def observed(inputs, utils, kd, n_islands):
        if tracer.live:
            kept.append((inputs[0], inputs[1], utils["n_stops"],
                         bool(utils["time_windowed"]), kd, n_islands))
        return call(inputs, utils, kd, n_islands)

    # the kernel wrapper counts its launches on its module-level name
    observed.launches = getattr(call, "launches", 0)
    tracer.patch.set(delta_kernel, "_call_kernel", observed)

    def finish():
        if kept:
            tracer.counters["vrp_delta.bound_us"] = [
                1e6 * _kernel_bound.bound(*k)[2] for k in kept]
        kept.clear()

    tracer.finishers.append(finish)


def read(trace):
    bounds = trace["counters"].get("vrp_delta.bound_us")
    times = [e - s for name, s, e, _ in trace["device_ops"] if KERNEL in name]
    if not bounds or not times:
        return None
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(times) / len(times))
