"""Tracing and cost introspection.

Port of ``gbnns_tpu/eval/trace.py``: a device trace of a block
(``torch.profiler``, written as a Chrome trace), the operation count of a
call (``torch.utils.flop_counter.FlopCounterMode`` in place of XLA's cost
model) and the device memory a call takes.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Callable

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(out_dir: str):
    """Trace the enclosed block on the CPU and, where there is one, the
    card, and write ``out_dir/trace.json`` (open it in Perfetto or
    chrome://tracing). Every thread is traced, those started before the
    block too (a service's dispatcher). Yields the
    ``torch.profiler.profile``, whose ``key_averages()`` sums the time by
    operation and kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=acts,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))


def cost_analysis(fn: Callable, *args, static_argnames=(),
                  **kwargs) -> dict[str, Any]:
    """Floating-point operations of one call ``fn(*args, **kwargs)``,
    counted by PyTorch's flop counter (matrix products and convolutions;
    elementwise work counts 0). Keys as the JAX package's: ``flops``,
    ``bytes`` (NaN: not counted), ``summary`` and ``all`` (by operator).
    ``static_argnames`` is the JAX keyword; nothing is compiled here."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    by_op = {str(op): int(v) for op, v in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"all": {"flops": flops, **by_op}, "summary": {"flops": flops},
            "flops": flops, "bytes": float("nan")}


def _nbytes(x) -> int:
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def memory_analysis(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """Bytes of one call: ``temp_size_in_bytes`` is the peak of device
    memory allocated during it above what was allocated before (None on
    the CPU); arguments and outputs are their tensors' bytes; there is no
    generated code to size (None)."""
    temp = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        temp = torch.cuda.max_memory_allocated() - before
    else:
        out = fn(*args, **kwargs)
    return {"temp_size_in_bytes": temp,
            "argument_size_in_bytes": _nbytes(args) + _nbytes(kwargs),
            "output_size_in_bytes": _nbytes(out),
            "generated_code_size_in_bytes": None}


def dump_report(path: str, report: dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)
