"""Hand-written Hopper (sm_90a) kernels of the port, one package each.

Each package keeps the reference layout: ``kernel.py`` (the wrapper that
launches the CUDA kernel built from ``csrc/``), ``ref.py`` (the plain PyTorch
version of the same function).  What runs is decided by the tensors alone,
replacing the reference's ``resolve_interpret``:

* every tensor on the CPU  -> the plain version (the CPU tests);
* every tensor on ``meta`` -> the plain version (shapes only: the dryrun
  traces a step and runs nothing);
* every tensor on a CUDA card -> the kernel, or an exception.

There is no switch that puts the plain version on a CUDA tensor.

Every wrapper's ``__call__`` is a :func:`kernel_call`: while a cost
accounting is active (``repro_torch.analysis.dispatch_costs``), the call is
recorded once, by name, with its operand and result bytes and its launches,
and the ops inside it (the plain version's on the CPU or ``meta``) are not
counted; a launch through ctypes never reaches the dispatcher, so without
the marker the card's kernels would be invisible to the accounting.  With no
accounting active the marker does nothing, and it never changes the path.

Packages:
  flash_attention — causal / sliding-window attention over a whole sequence,
                    GQA/MQA read in place and MLA's fused latent as V; every
                    prefill and full forward of the attention models
                    (replaces ``repro/kernels/flash_attention/kernel.py``)
  paged_attention — paged-KV decode attention for the serving engine
                    (replaces ``repro/kernels/paged_attention/kernel.py``)
  ssd             — the Mamba-2 SSD chunked scan of a prefill (replaces
                    ``repro/kernels/ssd/kernel.py``)
  rglru           — the RG-LRU linear recurrence of a prefill (replaces
                    ``repro/kernels/rglru/kernel.py``)
  vb_scatter      — virtual-batch reassembly: one launch routes the rows of
                    every payload tensor by a permutation (scatter) or its
                    transpose (gather, the autograd backward) (replaces
                    ``repro/kernels/vb_scatter/kernel.py``)
  act_compress    — per-row absmax int8/fp8 quantize and dequantize of the
                    compressed traversal wire (replaces
                    ``repro/kernels/act_compress/kernel.py``)
"""
from __future__ import annotations

import functools

import torch

_ACCOUNTANT = None          # the active cost accounting, or None


def use_kernel(*tensors) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel), False
    when they all lie on the CPU, or all on ``meta`` (run the plain
    version).  ``None`` entries
    are ignored; any other mix of devices raises, and so does a ``DTensor``:
    a kernel reads ``data_ptr()``, so it takes a rank's local tensors
    (``to_local()``), never a distributed one."""
    if any(type(t).__name__ == "DTensor" for t in tensors):
        raise TypeError("a kernel takes local tensors: pass DTensor."
                        "to_local(), as core.tl_step's row permuter does")
    devs = {t.device for t in tensors if t is not None}
    kinds = {d.type for d in devs}
    if kinds == {"cpu"} or kinds == {"meta"}:
        return False
    if kinds == {"cuda"} and len(devs) == 1:
        return True
    raise ValueError(
        f"kernel inputs lie on {sorted(str(d) for d in devs)}: all must lie "
        "on one CUDA device (kernel), or all on the CPU or all on meta "
        "(plain version)")


def set_accountant(acc):
    """Install ``acc`` (an object with ``enter()``, ``leave()`` and
    ``record(name, args, out, launches)``) as the active cost accounting,
    or remove it with None; returns the one it replaces."""
    global _ACCOUNTANT
    prev, _ACCOUNTANT = _ACCOUNTANT, acc
    return prev


def kernel_call(call):
    """Mark a wrapper's ``__call__`` as one kernel call for the cost
    accounting (module docstring).  The name is the wrapper's ``name``."""
    @functools.wraps(call)
    def marked(self, *args, **kwargs):
        acc = _ACCOUNTANT
        if acc is None:
            return call(self, *args, **kwargs)
        before = self.launches
        acc.enter()
        try:
            out = call(self, *args, **kwargs)
        finally:
            acc.leave()
        acc.record(self.name, (args, kwargs), out, self.launches - before)
        return out
    return marked


def refuse_grad(name: str, *tensors) -> None:
    """Raise when a forward-only kernel is about to launch on inputs that
    autograd tracks: its output would come back with no ``grad_fn``, and a
    loss through it would silently get no gradient for them.  Called by
    the wrappers of K3-K6 just before a CUDA launch (on the CPU the plain
    version runs and is differentiable)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a forward-only CUDA kernel and an input requires "
            "grad: its output would be detached.  Call it under "
            "torch.no_grad(), or train through the models' differentiable "
            "path (attention: attend_dense / attend_blockwise)")


__all__ = ["kernel_call", "refuse_grad", "set_accountant",
           "use_kernel"]
