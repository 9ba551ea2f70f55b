"""Async atomic checkpoints of a training state (``repro.checkpoint.manager``
with the same behaviour, in the port's own on-disk format).

Layout: ``<dir>/step_<k>/`` holds one ``.npy`` per leaf plus
``manifest.json`` (per leaf: key, file, shape, dtype; the step). A
checkpoint is committed by the atomic rename of ``step_<k>.tmp`` to
``step_<k>``, so readers never see a partial one. The
device-to-host copy happens on the caller's thread; the file writes run on
a background thread and overlap the next steps. numpy has no bfloat16, so
a bf16 leaf is stored as its 16-bit pattern and its dtype is recorded.
Leaves that are Python numbers (the optimizer's count, the step) are
stored as 0-d arrays and restored as numbers; numpy leaves are restored as
numpy arrays. The host copy is a copy for a CPU tensor too: the next step
updates the state in place while the background thread writes it. An
optional JSON blob (``save(..., extra=)``, read back by ``load_extra``)
is committed inside the same rename as the leaves.

A state sharded over a mesh is saved whole, in the one-rank layout
(``save_sharded``: gathered by every rank, written by one), and cut again
at restore (``restore_sharded``): the checkpoint holds no layout, so it
restores onto any mesh, or onto none.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map_path

Tree = Any
_SEP = "/"


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor leaf of a restore target."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _fname(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` that nothing later writes into (``.cpu()``
    of a CPU tensor, or ``np.asarray`` of an array, would share its
    storage), and the dtype to record."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    if isinstance(leaf, np.ndarray):
        return np.array(leaf, copy=True), "numpy"
    return np.asarray(leaf), "py_" + type(leaf).__name__


def _from_host(arr: np.ndarray, dtype: str, target, device):
    if dtype.startswith("py_"):
        return type(target)(arr.item())
    if dtype == "numpy":
        if tuple(arr.shape) != tuple(np.shape(target)):
            raise ValueError(f"checkpoint shape {arr.shape} != target "
                             f"{np.shape(target)}")
        return arr
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    want = target.dtype
    if tuple(t.shape) != tuple(target.shape):
        raise ValueError(f"checkpoint shape {tuple(t.shape)} != target "
                         f"{tuple(target.shape)}")
    return t.to(device=device, dtype=want)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Tree, wait: bool = False,
             extra: Optional[Dict] = None):
        """Snapshot to host, then write and commit (on a background thread
        unless wait=True). ``extra``: a JSON-serializable blob committed in
        the same atomic rename as the leaves (the serving engine keeps its
        scheduler state there, so scheduler and cache are never torn)."""
        self.wait()                       # one save in flight at a time
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        host = [(_key(path), *_to_host(leaf))
                for path, leaf in tree_leaves(state)]

        def work():
            try:
                self._write(step, host, extra)
            except BaseException as e:    # surfaced on next save()/wait()
                self._error = e

        if self.async_save and not wait:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def _write(self, step: int, host: List[Tuple[str, np.ndarray, str]],
               extra: Optional[Dict] = None):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        if extra is not None:
            manifest["extra"] = extra
        for key, arr, dtype in host:
            np.save(os.path.join(tmp, _fname(key)), arr)
            manifest["leaves"].append({"key": key, "file": _fname(key),
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)             # commit point
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_sharded(self, step: int, state: Tree, gather, writer: bool,
                     wait: bool = False, extra: Optional[Dict] = None):
        """Collective: ``gather(state)`` (every rank calls it) gives the
        whole state in the one-rank layout, which the ``writer`` rank
        saves, with ``extra`` as ``save`` takes it."""
        whole = gather(state)
        if writer:
            self.save(step, whole, wait=wait, extra=extra)

    def sync(self, group=None):
        """Every rank of ``group`` (a torch process group; None: the
        default group) waits until the writer's save has committed (call
        on every rank of it before reading the directory)."""
        import torch.distributed as dist
        self.wait()
        dist.barrier(group=group)

    def restore_sharded(self, target: Tree, shard, step: Optional[int] = None,
                        device=None) -> Tuple[Tree, int]:
        """The whole state (``restore``'s ``target``: the one-rank layout),
        cut to this rank's shard by ``shard``. Call ``sync`` first."""
        whole, step = self.restore(target, step, device)
        return shard(whole), step

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_extra(self, step: Optional[int] = None) -> Optional[Dict]:
        """The ``extra`` blob committed with ``save(..., extra=)``, or
        None."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f).get("extra")

    def restore(self, target: Tree, step: Optional[int] = None,
                device=None) -> Tuple[Tree, int]:
        """target: a tree of tensors or ``TensorSpec``s (and numbers) giving
        the structure, shapes and dtypes. Tensors are placed on ``device``
        (default: each tensor target's own device, else the CPU). Returns
        (state, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
        loaded = {}
        for path, leaf in tree_leaves(target):
            key = _key(path)
            if key not in by_key:
                raise KeyError(f"checkpoint {d} missing leaf {key!r}")
            rec = by_key[key]
            arr = np.load(os.path.join(d, rec["file"]))
            dev = device if device is not None else getattr(
                leaf, "device", "cpu")
            try:
                loaded[path] = _from_host(arr, rec["dtype"], leaf, dev)
            except ValueError as e:
                raise ValueError(f"leaf {key}: {e}") from None
        return (tree_map_path(lambda path, _: loaded[path], target),
                manifest["step"])
