"""Serving engine of the port: continuous batching over a paged KV cache.

Layers (bottom-up), as in ``repro/serve``:
  allocator — host-side free-list :class:`PageAllocator` (trash page 0)
  runner    — paged model execution: prefill into pages, decode through the
              ``paged_decode`` CUDA kernel (or its plain version)
  sampling  — greedy next-token choice
  engine    — :class:`ServeEngine`: admission / batched decode / eviction
"""
from repro_torch.serve.allocator import OutOfPages, PageAllocator, TRASH_PAGE
from repro_torch.serve.engine import Request, RequestResult, ServeEngine
from repro_torch.serve.runner import check_servable, init_pages
from repro_torch.serve.sampling import sample_tokens

__all__ = ["OutOfPages", "PageAllocator", "TRASH_PAGE", "Request",
           "RequestResult", "ServeEngine", "check_servable", "init_pages",
           "sample_tokens"]
