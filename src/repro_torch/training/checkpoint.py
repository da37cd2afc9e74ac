"""Fault-tolerant checkpointing (the port of the reference's
``training/checkpoint.py``, in its on-disk format): npz snapshots with atomic
rename, an async background writer, and elastic restore (arrays are saved as
full logical values; the restoring run puts each leaf where it wants it).

Layout:
  <dir>/step_<N>/arrays.npz      flattened tree leaves (key = path string)
  <dir>/step_<N>/meta.json       step, keys, extra state (data stream)
  <dir>/LATEST                   text file with the newest complete step dir

A leaf's key is the string ``jax.tree_util.keystr`` gives its path
(``['params']['blocks'][0]['A']``: ``repro_torch.tree``), so a checkpoint
written by either package restores in the other.

Crash safety: writes go to ``step_<N>.tmp`` and are renamed only when fsynced
and complete, so a killed writer never corrupts LATEST.  Old steps are
garbage-collected keeping ``keep`` newest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T


def _host_copies(tree) -> dict:
    """``{path: numpy array}``: every leaf copied to the host now (a CPU
    tensor is copied too, so later in-place updates cannot reach it)."""
    out = {}
    for key, leaf in T.flatten_with_paths(tree):
        if torch.is_tensor(leaf):
            out[key] = leaf.detach().to("cpu", copy=True).numpy()
        else:
            out[key] = np.array(leaf)
    return out


def _write(ckpt_dir: str, step: int, host: dict, extra: Optional[dict],
           keep: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(ckpt_dir, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    meta = {"step": int(step), "keys": sorted(host.keys()),
            "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):                  # same step re-saved
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    _update_latest(ckpt_dir, final)
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Synchronous checkpoint write. Returns the final step directory."""
    return _write(ckpt_dir, step, _host_copies(tree), extra, keep)


def _update_latest(ckpt_dir: str, final: str) -> None:
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step_dir(ckpt_dir: str) -> Optional[str]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    full = os.path.join(ckpt_dir, name)
    return full if os.path.isdir(full) else None


def restore(ckpt_dir: str, like: Any, devices: Any = None):
    """Restore the newest checkpoint into the structure of ``like``.

    ``like``'s leaves give shape and dtype (tensors: also the device; a
    leaf on the ``meta`` device or without one restores to the CPU).
    ``devices`` (a tree of ``like``'s structure, or None) puts each leaf on
    the device given instead: the npz holds full logical arrays, so where a
    leaf goes does not depend on where it was saved.  Returns (tree as
    plain dicts and lists, step, extra) or None."""
    d = latest_step_dir(ckpt_dir)
    if d is None:
        return None
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    flat = T.flatten_with_paths(like)
    devs = (T.leaves(devices) if devices is not None
            else [None] * len(flat))
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for (key, leaf), dev in zip(flat, devs, strict=True):
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: ckpt shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            if dev is None:
                dev = getattr(leaf, "device", "cpu")
                if torch.device(dev).type == "meta":
                    dev = "cpu"
            out.append(torch.from_numpy(np.array(arr)).to(
                device=dev, dtype=leaf.dtype))
    return T.unflatten(like, out), meta["step"], meta.get("extra", {})


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one snapshot in flight).

    ``save`` blocks only while it copies the leaves to the host — before it
    returns, so the caller may update its tensors in place at once — and
    hands the file I/O to a daemon thread.  A second save while one is in
    flight waits: backpressure instead of unbounded host memory growth.
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        host = _host_copies(tree)

        def _bg():
            try:
                _write(self.ckpt_dir, step, host, extra, self.keep)
            except Exception as e:   # surfaced at the next save() / wait()
                self._err = e

        self._thread = threading.Thread(target=_bg, daemon=True)
        self._thread.start()
