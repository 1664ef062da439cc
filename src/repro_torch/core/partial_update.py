"""Port of ``repro/core/partial_update.py``: the same codec on trees of
tensors, with numpy where the reference uses numpy (the index selection
and the payload), so both packages ship the same indices and values.

Paper §5.1: partial parameter update transfer.

When redistributing the model, transmit only the parameters whose change
exceeds a threshold (or the top-k fraction by |Δ|), plus their indices —
the paper's answer to O(model) redistribution cost as models grow.  The
receiving node patches its cached copy.  Lossy only in what it *delays*:
untransmitted deltas accumulate orchestrator-side and ship once they cross
the threshold, so drift is bounded by ``threshold`` per weight.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten


@dataclass
class PartialUpdateCodec:
    """Orchestrator-side encoder with per-leaf residual accumulation."""

    threshold: float = 0.0        # absolute |Δ| threshold
    top_frac: Optional[float] = None   # or: ship the top fraction by |Δ|
    _residual: Optional[object] = None  # un-shipped deltas
    bytes_full: int = 0
    bytes_sent: int = 0

    def encode(self, old_params, new_params):
        """Returns a payload {leaf_idx: (flat_indices, values)}."""
        leaves_old, treedef = tree_flatten(old_params)
        leaves_new = tree_leaves(new_params)
        if self._residual is None:
            self._residual = [torch.zeros_like(l) for l in leaves_old]
        payload = {}
        for i, (lo, ln) in enumerate(zip(leaves_old, leaves_new)):
            delta = (ln - lo) + self._residual[i]
            flat = delta.reshape(-1)
            self.bytes_full += int(flat.nbytes)
            if self.top_frac is not None:
                k = max(1, int(flat.numel() * self.top_frac))
                # stable, as jnp.argsort: ties keep the lower index first
                idx = torch.argsort(-flat.abs(), stable=True)[:k]
                mask = torch.zeros_like(flat, dtype=torch.bool)
                mask[idx] = True
            else:
                mask = flat.abs() > self.threshold
            mask = mask.cpu().numpy()
            flat = flat.cpu().numpy()
            idx = np.nonzero(mask)[0]
            vals = flat[idx]
            payload[i] = (idx.astype(np.int32), vals)
            # the reference charges the int64 indices np.nonzero returns
            self.bytes_sent += int(idx.nbytes + vals.nbytes)
            # what we did not ship stays in the residual
            self._residual[i] = torch.as_tensor(
                flat * ~mask, device=lo.device).reshape(lo.shape)
        return payload, treedef

    @staticmethod
    def apply(cached_params, payload_treedef) -> object:
        """Node-side: patch a cached param copy with a partial update."""
        payload, treedef = payload_treedef
        leaves = list(tree_leaves(cached_params))
        for i, (idx, vals) in payload.items():
            leaf = leaves[i]
            flat = np.array(leaf.cpu().numpy(), copy=True).ravel()
            flat[idx] = flat[idx] + vals
            leaves[i] = torch.as_tensor(flat.reshape(leaf.shape),
                                        device=leaf.device)
        return tree_unflatten(treedef, leaves)

    @property
    def compression_ratio(self) -> float:
        return self.bytes_full / max(self.bytes_sent, 1)
