"""What several per-layer readers compute, each for its own cells: a
kernel's roofline share, the rollout's MFU, the device's idle share."""

from benchmark.costs.costs import peak_flops


def roofline_pct(record, kernel):
    """The sum of the kernel's launches' bounds (benchmark/costs, from the
    inputs each launch was given, in the accounting replay) over the device
    time of the kernels named for it in the traced window, in %; None where
    the kernel did not run."""
    tr, acc = record.get("trace"), record.get("accounting")
    if not tr or not acc:
        return None
    t = tr["kernel_s"][kernel]
    bound, _, launches = acc["kernels"][kernel]
    if t <= 0 or not launches or not tr["kernel_launches"][kernel]:
        return None
    return 100.0 * bound / t


def mfu_pct(record):
    """The model's operations over the traced window (the dense products as
    PyTorch runs them, counted by FlopCounterMode, plus the attention
    kernels' edge and fused-stack work from their cost functions;
    benchmark/trace.py) over its seconds, over the peak of the
    configuration's dtype (f32 67, bf16 989 TFLOP/s, H100 SXM data sheet),
    in %."""
    acc = record.get("accounting")
    if not acc or not acc["flops"]:
        return None
    return 100.0 * acc["flops"] / record["window_s"] / peak_flops(record["dtype"])


def idle_pct(record):
    """100 minus the union of the device operations' intervals (the
    profiler's device trace) over the traced window's seconds."""
    tr = record.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / record["window_s"])
