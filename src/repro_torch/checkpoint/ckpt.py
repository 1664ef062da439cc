"""Tree checkpointing in the reference's format: npz payload + json meta,
atomic, step-indexed.

Port of ``repro/checkpoint/ckpt.py``.  Layout: ``<dir>/step_<N:08d>/
arrays.npz`` (arrays ``a0, a1, ...``) + ``meta.json`` (``step``, ``names``,
``dtypes``, per-array SHA-256 ``checksums``, ``extra``).  A checkpoint
written by either package loads in the other:

* the names are those ``jax.tree_util.keystr`` gives the same tree (dict
  keys in sorted order as ``['key']``, sequence entries as ``[i]``),
  computed here without JAX; save the reference's layout
  (``bridge.params_to_jax`` / ``opt_state_to_jax``) and they match;
* dtypes numpy lacks (bfloat16, float8) are saved as their raw bytes,
  ``uint8`` with a trailing itemsize axis, under the dtype's name, as the
  reference saves them; loading gives them back as CPU tensors;
* leaves may be numpy arrays or tensors on any device.

Durability and integrity as in the reference: payload and meta fsync'd
before the atomic rename publishes the step; every array's SHA-256 is
checked on restore; :func:`latest_step` skips a corrupt or truncated step
with a warning; :func:`gc_checkpoints` keeps the newest valid steps and
never a protected one.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import warnings
from typing import Any, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten

# dtypes numpy cannot hold: saved as raw bytes under these names
_RAW = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
        "float8_e5m2": torch.float8_e5m2}


def _names(tree, prefix: str = ""):
    """``jax.tree_util.keystr`` of every leaf path, in JAX's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _names(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _names(v, f"{prefix}[{i}]")]
    return [prefix]


def _to_savable(leaf):
    """``(array, dtype name)``: a raw ``uint8`` view (trailing itemsize
    axis) for the dtypes numpy lacks, else the array itself."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in _RAW:
            return (t.reshape(-1).view(torch.uint8).numpy()
                    .reshape(tuple(t.shape) + (t.element_size(),)), name)
        return t.numpy(), name
    arr = np.asarray(leaf)
    if arr.dtype.name in _RAW or arr.dtype.kind == "V":
        return (np.ascontiguousarray(arr).view(np.uint8)
                .reshape(arr.shape + (arr.dtype.itemsize,)), arr.dtype.name)
    return arr, arr.dtype.name


def _from_savable(arr: np.ndarray, dtype_name: str):
    if arr.dtype == np.uint8 and dtype_name != "uint8":
        raw = torch.from_numpy(np.ascontiguousarray(arr))
        return raw.view(_RAW[dtype_name]).reshape(arr.shape[:-1])
    return arr


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    # directory fsync flushes the entry metadata (the rename itself);
    # not all filesystems allow it — degrade silently rather than fail a save
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    extra: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    names, leaves = _names(tree), tree_flatten(tree)[0]
    tmp = tempfile.mkdtemp(dir=ckpt_dir)
    try:
        savable = [_to_savable(l) for l in leaves]
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **{f"a{i}": a for i, (a, _) in enumerate(savable)})
        meta = {"step": step, "names": names,
                "dtypes": [d for _, d in savable],
                "checksums": [_sha256(a) for a, _ in savable],
                "extra": extra or {}}
        meta_path = os.path.join(tmp, "meta.json")
        with open(meta_path, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        # durability before visibility: payload + meta bytes must be on disk
        # before the atomic rename publishes the step name
        _fsync_file(npz_path)
        _fsync_dir(tmp)
        final = _step_path(ckpt_dir, step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(ckpt_dir)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return _step_path(ckpt_dir, step)


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_"):
            try:
                out.append(int(d.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return sorted(out)


def verify_checkpoint(path: str) -> bool:
    """True iff ``path`` holds a complete, uncorrupted checkpoint.

    Checks: meta.json parses with the expected keys, arrays.npz exists and
    loads, every named array is present, and (when the meta carries them —
    pre-checksum checkpoints stay loadable) each array's SHA-256 matches.
    """
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        names = meta["names"]
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = [data[f"a{i}"] for i in range(len(names))]
        sums = meta.get("checksums")
        if sums is not None:
            if len(sums) != len(arrays):
                return False
            for want, arr in zip(sums, arrays):
                if _sha256(arr) != want:
                    return False
        return True
    except Exception:
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest *valid* step: corrupt/truncated step dirs are skipped with a
    warning (a crash mid-write or a damaged disk must degrade the rollback
    depth, not kill the restore)."""
    for step in reversed(_all_steps(ckpt_dir)):
        path = _step_path(ckpt_dir, step)
        if verify_checkpoint(path):
            return step
        warnings.warn(f"skipping corrupt/truncated checkpoint {path}; "
                      "falling back to the previous step")
    return None


def gc_checkpoints(ckpt_dir: str, keep: int,
                   protect: Iterable[int] = ()) -> list:
    """Retain the ``keep`` newest **valid** steps; returns deleted steps.

    Corrupt/truncated step dirs never count against the retention window
    (keeping a damaged step while collecting the newest restorable one
    would destroy the rollback anchor) and are themselves collected.  Steps
    in ``protect`` (e.g. the one a live resume replays from) are never
    collected, even when older than the retention window."""
    if keep < 1:
        raise ValueError("keep must be >= 1")
    steps = _all_steps(ckpt_dir)
    valid = [s for s in steps if verify_checkpoint(_step_path(ckpt_dir, s))]
    keep_set = set(valid[-keep:]) | set(int(s) for s in protect)
    doomed = [s for s in steps if s not in keep_set]
    for s in doomed:
        shutil.rmtree(_step_path(ckpt_dir, s), ignore_errors=True)
    return doomed


def load_checkpoint(ckpt_dir: str, tree_like, step: Optional[int] = None
                    ) -> Tuple[Any, dict]:
    """Restore into the structure of ``tree_like`` (names must match):
    numpy leaves, CPU tensors for the raw-byte dtypes.

    ``step=None`` resolves to the newest valid step (corrupt dirs skipped,
    see :func:`latest_step`).  An *explicitly requested* step that fails
    verification raises: the caller named a specific rollback point.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no (valid) checkpoints under {ckpt_dir}")
    path = _step_path(ckpt_dir, step)
    if not verify_checkpoint(path):
        raise ValueError(
            f"checkpoint {path} is corrupt or truncated (missing payload or "
            "SHA-256 mismatch); pass step=None to fall back to the newest "
            "valid step")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if _names(tree_like) != meta["names"]:
        raise ValueError("checkpoint tree structure mismatch")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [_from_savable(data[f"a{i}"], meta["dtypes"][i])
                  for i in range(len(meta["names"]))]
    return tree_unflatten(tree_flatten(tree_like)[1], leaves), meta
