"""Fault-tolerant checkpoint manager (one ``.npy`` per leaf, manifest-driven)
— the port of ``repro.ckpt.manager`` over the port's parameter and AdamW
trees (nests of dicts and lists of tensors, flattened by
:mod:`repro_torch.tree`).

Its guarantees are the JAX package's:

- **atomic**: a checkpoint is written into ``step_N.tmp/`` and renamed to
  ``step_N/`` only after the manifest (with a crc32 per leaf) is fsynced —
  a crash mid-write never corrupts the latest checkpoint;
- **async**: ``save(..., blocking=False)`` copies every tensor to host
  memory before it returns (the train step updates parameters and moments
  in place) and writes the files on a background thread while training
  goes on;
- **keep-k** retention, and a newest-first restore that walks back past a
  checkpoint that fails its checksums (a torn write);
- ``restore(target, device=)`` puts each leaf back on the device and in
  the dtype of ``target``'s leaf (or on ``device``), so a checkpoint written
  on the card restores on the CPU and back;
- **elastic**: a checkpoint stores every leaf unsharded — a DTensor leaf is
  gathered (``full_tensor``, a collective every rank joins) and one rank,
  the ``writer``, writes — and ``restore`` places each leaf on the target's
  mesh and placements (a DTensor target leaf's, or ``shardings=``), so a
  checkpoint written at one world size loads at another
  (:func:`restore_to_sharding`).

bfloat16 has no numpy dtype: such a leaf is stored as its raw 16 bits
(``int16``) and the manifest records the tensor's dtype.  Python scalars in
the tree (the optimizer's step count) are stored as 0-d arrays and restored
as the target's type.

The embedded :class:`~repro_torch.plan.MemoryPlan` (``save(..., plan=...)``
/ :meth:`CheckpointManager.restore_plan`) persists through
:meth:`MemoryPlan.save` / :meth:`MemoryPlan.load`: verified before it lands,
verified again (and checked against the restoring chain) on the way out.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..distributed.sharding import distribute, full_value
from ..tree import leaves_with_paths, map_with_paths

_PLAN_FILE = "memory.plan"
_MANIFEST = "manifest.json"


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf as numpy, and the dtype to restore it in."""
    if isinstance(leaf, torch.Tensor):
        t = full_value(leaf.detach()).to("cpu", copy=True)
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), dtype
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype == "bfloat16":
        return t.view(torch.bfloat16)
    return t


class CheckpointManager:
    """Step checkpoints under ``directory`` (``step_00000012/``), the newest
    ``keep`` of them retained.  ``last_save`` describes the newest write:
    its step, bytes, the seconds spent copying to host memory
    (``snapshot_s``) and writing (``write_s``), and the host-clock
    (``time.perf_counter``) start and end of the write.  In a run over
    several processes every rank makes a manager on the same directory and
    calls :meth:`save` (its DTensor leaves are gathered collectively), and
    only the ``writer`` copies them to host memory and writes
    (``last_save["bytes"]`` is 0 on the others)."""

    def __init__(self, directory: str, keep: int = 3, writer: bool = True):
        self.dir = directory
        self.keep = keep
        self.writer = writer
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_save: Dict[str, Any] = {}

    # -- write --------------------------------------------------------------

    def save(self, step: int, state: Any, blocking: bool = True,
             plan: Any = None) -> None:
        """Write one checkpoint of ``state`` (a tree of tensors and
        scalars).  ``plan`` (an optional :class:`~repro_torch.plan.
        MemoryPlan`) is embedded in the step directory under the same
        atomic rename.  With ``blocking=False`` the host copy is taken now
        and the files are written on a thread; the next :meth:`save` or
        :meth:`wait` joins it and raises what it raised."""
        self.wait()  # one async save in flight at a time
        t0 = time.perf_counter()
        if not self.writer:
            # join the gathers of the DTensor leaves; only the writer
            # copies them to host memory
            for _, leaf in leaves_with_paths(state):
                if isinstance(leaf, torch.Tensor):
                    full_value(leaf.detach())
            self.last_save = {"step": step, "blocking": blocking, "bytes": 0,
                              "snapshot_s": time.perf_counter() - t0}
            return
        leaves = [(key,) + _to_host(leaf)
                  for key, leaf in leaves_with_paths(state)]
        info = {"step": step, "blocking": blocking,
                "bytes": sum(arr.nbytes for _, arr, _ in leaves),
                "snapshot_s": time.perf_counter() - t0}
        self.last_save = info
        if blocking:
            self._write(step, leaves, plan, info)
        else:
            self._thread = threading.Thread(
                target=self._write_guard, args=(step, leaves, plan, info),
                daemon=True, name=f"ckpt-step-{step}")
            self._thread.start()

    def _write_guard(self, step, leaves, plan, info) -> None:
        try:
            self._write(step, leaves, plan, info)
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def _write(self, step: int, leaves, plan, info: Dict[str, Any]) -> None:
        info["t_write_start"] = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for key, arr, dtype in leaves:
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype,
                "crc32": _crc32(arr),
            }
        if plan is not None:
            # MemoryPlan.save verifies the schedule before anything lands
            plan.save(os.path.join(tmp, _PLAN_FILE))
            manifest["plan"] = _PLAN_FILE
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        info["t_write_end"] = time.perf_counter()
        info["write_s"] = info["t_write_end"] - info["t_write_start"]

    def wait(self) -> None:
        """Join the write in flight, if any, and raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _verify_and_load(self, step: int
                         ) -> Optional[Dict[str, Tuple[np.ndarray, str]]]:
        """Every leaf of ``step`` with its dtype, or ``None`` when a file is
        missing or unreadable or a checksum fails (a torn write)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(path, _MANIFEST)) as f:
                manifest = json.load(f)
            leaves = {}
            for key, meta in manifest["leaves"].items():
                arr = np.load(os.path.join(path, meta["file"]))
                if _crc32(arr) != meta["crc32"]:
                    return None
                leaves[key] = (arr, meta["dtype"])
            return leaves
        except (OSError, ValueError, KeyError):
            return None

    def restore(self, target: Any, step: Optional[int] = None,
                device: Any = None, shardings: Any = None) -> Tuple[int, Any]:
        """Restore into the structure of ``target`` (a tree like the saved
        one: tensors, on any device including ``meta``, and scalars).
        Walks back through the retained checkpoints, newest first, until one
        passes its checksums; returns ``(step, state)``.  Each tensor comes
        back in its target leaf's dtype, on ``device`` if given, else on the
        target leaf's device; each scalar as its target's type.  A leaf
        whose sharding — ``shardings``' leaf at the same path (a
        :class:`~repro_torch.distributed.sharding.MeshSharding`), else the
        target leaf's own if it is a DTensor — is known comes back as a
        DTensor on that mesh and placements, each rank keeping its shards
        (every rank reads the files)."""
        from torch.distributed.tensor import DTensor

        from ..distributed.sharding import MeshSharding

        where_of = {}
        if shardings is not None:
            where_of = {k: v for k, v in leaves_with_paths(shardings)
                        if isinstance(v, MeshSharding)}
        candidates = ([step] if step is not None
                      else list(reversed(self.all_steps())))
        for s in candidates:
            leaves = self._verify_and_load(s)
            if leaves is None:
                continue

            def put(key: str, leaf: Any) -> Any:
                if key not in leaves:
                    raise KeyError(f"checkpoint step {s} missing leaf {key}")
                arr, dtype = leaves[key]
                if not isinstance(leaf, torch.Tensor):
                    return type(leaf)(arr.item())
                sharding = where_of.get(key)
                if sharding is None and isinstance(leaf, DTensor):
                    sharding = MeshSharding(leaf.device_mesh,
                                            tuple(leaf.placements))
                t = _from_host(arr, dtype)
                if sharding is None:
                    where = device if device is not None else leaf.device
                    return t.to(where, leaf.dtype).requires_grad_(
                        leaf.requires_grad)
                where = (device if device is not None
                         else sharding.mesh.device_type)
                if str(where) == "cuda":
                    where = torch.device("cuda", torch.cuda.current_device())
                return distribute(
                    t.to(where, leaf.dtype).requires_grad_(leaf.requires_grad),
                    sharding.mesh, sharding.placements)

            return s, map_with_paths(put, target)
        raise FileNotFoundError(
            f"no valid checkpoint found in {self.dir} (tried {candidates})")

    def restore_plan(self, step: Optional[int] = None, chain: Any = None):
        """The :class:`~repro_torch.plan.MemoryPlan` embedded at ``step``
        (default: the newest step that has one), or ``None`` if no retained
        checkpoint carries a plan.  The plan is statically re-verified on
        load and, with ``chain`` given, held to the chain's content hash
        (:class:`~repro_torch.plan.StalePlanError` otherwise) — so a resumed
        run cannot silently train under a stale or corrupted schedule."""
        from ..plan.plan import MemoryPlan

        candidates = ([step] if step is not None
                      else list(reversed(self.all_steps())))
        for s in candidates:
            path = os.path.join(self.dir, f"step_{s:08d}", _PLAN_FILE)
            if os.path.exists(path):
                return MemoryPlan.load(path, chain)
        return None


def restore_to_sharding(manager: CheckpointManager, target: Any,
                        shardings: Any, step: Optional[int] = None
                        ) -> Tuple[int, Any]:
    """:meth:`CheckpointManager.restore` onto the current mesh: each leaf of
    ``target`` placed by ``shardings``' leaf at its path (a
    :class:`~repro_torch.distributed.sharding.MeshSharding`, or ``None``
    for a leaf left whole)."""
    return manager.restore(target, step=step, shardings=shardings)
