"""Serving engine of the port: continuous batching over a paged KV cache.

Layers (bottom-up), as in ``repro/serve``:
  allocator — host-side free-list :class:`PageAllocator` (trash page 0)
  runner    — paged model execution: prefill into pages (``flash_attention_bh``
              on the card), decode through the ``paged_decode`` CUDA kernel
              (or its plain version)
  prng      — JAX's threefry2x32 bits, ``uniform`` and ``gumbel`` in torch
  sampling  — per-request RNG streams (batch-composition independent)
  faults    — seeded decode-step fault injection (hang/crash) + recovery
              reporting for the supervised serving path
  engine    — :class:`ServeEngine`: admission / overload control (SLO
              deadlines, shedding, head-of-line bypass, priority preemption)
              / batched decode / KV preemption+restore / fault supervision /
              eviction / compaction
"""
from repro_torch.serve.allocator import OutOfPages, PageAllocator, TRASH_PAGE
from repro_torch.serve.engine import Request, RequestResult, ServeEngine
from repro_torch.serve.faults import (CRASH, HANG, ServeDrill, ServeFault,
                                      ServeFaultInjector, ServeFaultSpec,
                                      ServeRecoveryReport, parse_chaos)
from repro_torch.serve.runner import check_servable, init_pages
from repro_torch.serve.sampling import request_key, sample_tokens

__all__ = ["OutOfPages", "PageAllocator", "TRASH_PAGE", "Request",
           "RequestResult", "ServeEngine", "check_servable", "init_pages",
           "request_key", "sample_tokens", "CRASH", "HANG", "ServeDrill",
           "ServeFault", "ServeFaultInjector", "ServeFaultSpec",
           "ServeRecoveryReport", "parse_chaos"]
