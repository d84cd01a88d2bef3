"""Checkpoints with an async save, atomic publish, retention and layout
versions, in the reference's on-disk layout (port of
``repro.checkpoint.checkpointer``)::

    <dir>/step_<N>/  arrays.npz     flat {key path: array}
                     manifest.json  step, time, extra (the data cursor),
                                    n_arrays, layout_version, bf16 keys
    <dir>/LATEST     the published step

A key path joins a leaf's dict keys with ``/`` (``params/layers/attn/wq``),
as the reference's ``tree_flatten_with_path``; the trainer saves
``convert.train_state_to_reference`` of its state, so the two packages
read each other's checkpoints.

- *Async save*: ``save(block=False)`` copies every leaf into host memory
  and returns: a CUDA leaf into pinned memory with ``non_blocking=True``
  (the copies queue behind the step that made the state, and a CUDA event
  marks their end), a CPU leaf by a plain copy, since the next step
  updates the optimizer rows in place.  The host buffers are kept, one a
  key, and reused by the next save of the same shape and type (the save
  first joins the writer that reads them), so only the first save pays
  for the allocation.  A writer thread waits on the event, then writes
  and publishes.  ``block="transfer"`` returns once
  the copies have landed; ``block=True`` also waits for the write.
  :meth:`wait` joins the writer and re-raises its error.
- *Save policy*: ``save_every_steps`` and ``save_every_seconds`` (an
  injectable ``clock``), whichever fires first: :meth:`should_save`,
  :meth:`maybe_save`.
- *Atomic publish*: the write goes to ``step_N.tmp``, which is fsynced and
  renamed, then ``LATEST`` is replaced.  The constructor sweeps stale
  ``.tmp`` directories, which :meth:`list_steps` and :meth:`latest_step`
  never see.  The ``keep`` newest steps are retained.
- *bf16 leaves*: numpy has no bfloat16 without ``ml_dtypes``, so they are
  stored as their uint16 bit patterns, their keys listed in the manifest,
  and restored bit for bit.
- *Layout versions*: the manifest's ``layout_version``; a checkpoint of an
  older layout is migrated on restore (:func:`migrate_layout`), a newer
  one refused.
- *Restore* loads onto a template's structure, shapes and types, on a
  given device, at the same data-parallel width: resharding onto another
  dp needs the grad-sync resize hooks (``GRAD_SYNC_RESIZE``, ROADMAP queue
  1, item 7), which are not ported yet.

The reference's telemetry spans around the stage, the d2h wait and the
write wait for the port's ``obs`` (ROADMAP queue 1, item 7); the save's
times and bytes are kept in :attr:`Checkpointer.saves` meanwhile.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

# The on-disk state layout, the reference's:
#   1: flat optimizer {master, mu, nu}; the monitor's policy state at the
#      top level of the monitor dict ('monitor/latched' for exact)
#   2: compressed runs carry 'opt/ef'; the monitor's policy state lives
#      under 'm/' ('monitor/m/latched', 'monitor/m/win')
LAYOUT_VERSION = 2

RESIZE_HINT = ("restoring onto another data-parallel width needs the grad-sync resize hooks "
               "(GRAD_SYNC_RESIZE, migrate_state: ROADMAP queue 1, item 7), not ported yet")


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{``a/b/c``: leaf} of nested dicts (the reference's key paths)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        out.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat: Dict[str, Any]) -> dict:
    out: dict = {}
    for key, leaf in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def _np_dtype(dtype: torch.dtype):
    return np.uint16 if dtype == torch.bfloat16 else torch.empty((), dtype=dtype).numpy().dtype


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


# ---------------------------------------------------------------------------
# Layout migrations: version N -> N+1 passes over the flat array dict
# ---------------------------------------------------------------------------


def _migrate_v1_to_v2(flat: dict, specs: dict) -> dict:
    """Layout 1 checkpoints: the monitor's policy state moves under ``m/``
    and compressed runs gain a zero ``opt/ef`` residual (what a run that
    never compensated anything holds)."""
    out = dict(flat)
    for key, (shape, dtype) in specs.items():
        if key in out:
            continue
        parts = key.split("/")
        if "m" in parts:
            i = parts.index("m")
            old = "/".join(parts[:i] + parts[i + 1:])
            if old in out:
                out[key] = out.pop(old)
                continue
        if parts[-1] == "ef" and "opt" in parts:
            out[key] = np.zeros(shape, _np_dtype(dtype))
    return out


_MIGRATIONS: Dict[int, Callable] = {1: _migrate_v1_to_v2}


def _specs(template) -> dict:
    """{key path: (shape, torch dtype)} of a template's leaves."""
    out = {}
    for key, leaf in flatten_with_paths(template).items():
        leaf = torch.as_tensor(leaf)
        out[key] = (tuple(leaf.shape), leaf.dtype)
    return out


def migrate_layout(flat: dict, template, from_version: int,
                   to_version: int = LAYOUT_VERSION) -> dict:
    """Run the migration passes ``from_version -> to_version`` over a
    checkpoint's flat arrays, then check that every template leaf is
    there.  A checkpoint newer than this code is refused."""
    if from_version > to_version:
        raise ValueError(f"checkpoint layout v{from_version} is newer than this code's "
                         f"v{to_version}; upgrade the code, not the checkpoint")
    specs = _specs(template)
    for v in range(from_version, to_version):
        if v not in _MIGRATIONS:
            raise ValueError(f"no layout migration registered for v{v} -> v{v + 1}")
        flat = _MIGRATIONS[v](flat, specs)
    missing = sorted(k for k in specs if k not in flat)
    if missing:
        raise ValueError(
            f"checkpoint (layout v{from_version}) is missing {len(missing)} leaves the restore "
            f"template expects even after migration to v{to_version}: {missing[:8]}"
            f"{'...' if len(missing) > 8 else ''}")
    return flat


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, *,
                 save_every_steps: Optional[int] = None,
                 save_every_seconds: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.dir = directory
        self.keep = keep
        self.save_every_steps = save_every_steps
        self.save_every_seconds = save_every_seconds
        self._clock = clock
        os.makedirs(directory, exist_ok=True)
        self._clean_stale_tmp()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the time policy counts from construction: at most this long
        # between snapshots, not a save at step 1
        self._last_save_at = self._clock()
        # one record a save: step, bytes, wait_s (joining the previous
        # writer), hold_s (the staging after it), write_s (the writer's,
        # once it is done)
        self.saves: list[dict] = []
        # {key path: host buffer} of the last save, reused by the next
        self._staging: Dict[str, torch.Tensor] = {}

    def _stage(self, tree) -> tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
        """Host copies of every leaf (pinned, non-blocking for CUDA ones)
        in the kept buffers, and the event after the last device copy
        (None without one)."""
        staged, cuda = {}, False
        for key, leaf in flatten_with_paths(tree).items():
            leaf = torch.as_tensor(leaf).detach()
            host = self._staging.get(key)
            if (host is None or host.shape != leaf.shape or host.dtype != leaf.dtype
                    or host.is_pinned() != leaf.is_cuda):
                host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=leaf.is_cuda)
            host.copy_(leaf, non_blocking=leaf.is_cuda)
            cuda = cuda or leaf.is_cuda
            staged[key] = host
        self._staging = staged
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return staged, event

    def _clean_stale_tmp(self) -> None:
        """Sweep the ``step_N.tmp`` directories (and a ``LATEST.tmp``) that
        a crash in the middle of a write left behind."""
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(path, ignore_errors=True)
            elif name == "LATEST.tmp":
                os.unlink(path)

    # ------------------------------------------------------------------ save
    def should_save(self, step: int) -> bool:
        """The step or the time policy, whichever fires first."""
        if self.save_every_steps and step % self.save_every_steps == 0:
            return True
        if self.save_every_seconds is not None:
            return self._clock() - self._last_save_at >= self.save_every_seconds
        return False

    def maybe_save(self, step: int, state: Any, extra: Optional[dict] = None, *,
                   block=False) -> bool:
        """:meth:`save` when the policy says so; returns whether it did."""
        if not self.should_save(step):
            return False
        self.save(step, state, extra, block=block)
        return True

    def save(self, step: int, state: Any, extra: Optional[dict] = None, *, block=False) -> None:
        """Snapshot ``state`` (nested dicts of tensors, arrays or numbers):
        stage host copies of its leaves, hand them to a writer thread and
        return (``block=False``), once the copies have landed
        (``"transfer"``), or once the write is published (``True``)."""
        tw0 = time.perf_counter()
        self.wait()
        t0 = time.perf_counter()
        staged, event = self._stage(state)
        record = {"step": int(step), "wait_s": t0 - tw0,
                  "bytes": sum(t.numel() * t.element_size() for t in staged.values())}
        self.saves.append(record)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "extra": extra or {},
            "n_arrays": len(staged),
            "layout_version": LAYOUT_VERSION,
            "bf16": sorted(k for k, t in staged.items() if t.dtype == torch.bfloat16),
        }
        transferred = threading.Event()

        def write():
            try:
                tw = time.perf_counter()
                if event is not None:
                    event.synchronize()
                flat = {k: _to_numpy(t) for k, t in staged.items()}
                transferred.set()
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                    np.savez(f, **flat)
                    f.flush()
                    os.fsync(f.fileno())
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                latest_tmp = os.path.join(self.dir, "LATEST.tmp")
                with open(latest_tmp, "w") as f:
                    f.write(str(step))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
                self._gc()
                record["write_s"] = time.perf_counter() - tw
            except BaseException as e:  # surfaced by the next wait()
                self._error = e
                transferred.set()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        self._last_save_at = self._clock()
        if block == "transfer":
            transferred.wait()
            self._raise_pending()
        elif block:
            self.wait()
        record["hold_s"] = time.perf_counter() - t0

    def wait(self) -> None:
        """Join the save in flight, if any, and re-raise a writer error, so
        that a torn snapshot never passes for a restore point."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            step = int(f.read().strip())
        if os.path.exists(os.path.join(self.dir, f"step_{step}")):
            return step
        # LATEST names a step the gc already took: the newest on disk
        steps = self.list_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step}", "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, template: Any, device="cpu", *, dp: Optional[int] = None):
        """Load step ``step`` into ``template``'s structure (nested dicts of
        tensors): every leaf a tensor of the template leaf's shape and type
        on ``device``, bf16 leaves bit for bit.  An older layout is
        migrated first.  ``dp``, when given, must be the one the manifest's
        ``extra`` records (a checkpoint of another width raises, as a leaf
        of another shape does)."""
        device = resolve_device(device)
        d = os.path.join(self.dir, f"step_{step}")
        manifest = self.manifest(step) if os.path.exists(os.path.join(d, "manifest.json")) else {}
        saved_dp = manifest.get("extra", {}).get("dp")
        if dp is not None and saved_dp is not None and saved_dp != dp:
            raise ValueError(f"checkpoint step {step} was saved at dp={saved_dp}, this run has "
                             f"dp={dp}: {RESIZE_HINT}")
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        version = manifest.get("layout_version", 1)
        if version != LAYOUT_VERSION:
            flat = migrate_layout(flat, template, version)
        bf16 = set(manifest.get("bf16", ()))
        out = {}
        for key, (shape, dtype) in _specs(template).items():
            if key not in flat:
                raise ValueError(f"checkpoint step {step} has no leaf {key!r}")
            arr = flat[key]
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: {tuple(arr.shape)} saved, "
                                 f"{shape} expected (if the data-parallel width differs: "
                                 f"{RESIZE_HINT})")
            arr = np.require(arr, requirements="C")  # keeps 0-d leaves 0-d
            if key in bf16 or (arr.dtype.itemsize == 2 and arr.dtype.kind in "Vu"
                               and dtype == torch.bfloat16):
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out[key] = t.to(device=device, dtype=dtype)
        return _unflatten(out)
