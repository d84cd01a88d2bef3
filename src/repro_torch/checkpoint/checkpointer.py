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
  given device, at the same data-parallel width.  Onto another width the
  elastic trainer restores (``ElasticTrainer.init_or_restore``, the train
  CLI's ``--elastic-policy``): the params, the step and the data cursor,
  and the optimizer restarted from the restored params; a plain restore
  of another width is refused (:data:`RESIZE_HINT`), and a restore onto
  another ``--tp`` by both.
- *Worlds* (one process a rank, ``world=(rank, dp)``): a save writes the
  same ``arrays.npz`` as a stacked-rows trainer's, so either trainer
  restores the other's checkpoint.  Each rank stages only what it writes
  (rank 0 everything it holds, the others their rows of the ``[dp, ...]``
  leaves) into its kept pinned buffers, and each rank's writer thread
  writes its own rows into the one file at their offsets: no rank gathers
  another's rows.  The archive is written by :class:`_NpzLayout` (zip64,
  stored entries), whose offsets every rank derives from the same leaf
  shapes; rank 0 writes the headers and, once every rank has left its
  rows' CRC-32s in a marker file, the checksums, the central directory
  and the publish.  A world restore reads a rank's rows out of the file
  through ``np.memmap`` (:meth:`Checkpointer.restore_rank`).  An elastic
  world's membership changes with each resize: :meth:`Checkpointer.bind_world`
  gives a process its part of the next save or restore.
- *Sharded states* (a ``gspmd`` world, whose leaves are blocks of global
  leaves): :meth:`Checkpointer.save_streamed` writes the global leaves
  one at a time as the ranks gather them, into the archive a one-process
  trainer writes, so the writer holds one leaf at a time; a rank's
  restore reads its blocks out of the file through ``np.memmap``
  (:meth:`Checkpointer.restore_blocks`).

The reference's telemetry spans around the stage, the d2h wait and the
write wait for the port's ``obs`` (ROADMAP queue 1, item 7c); the save's
times and bytes are kept in :attr:`Checkpointer.saves` meanwhile.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import struct
import threading
import time
import zipfile
import zlib
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

RESIZE_HINT = ("a plain restore keeps the saved width's optimizer rows; onto another "
               "data-parallel width the elastic trainer restores the params, step and data "
               "cursor and restarts the optimizer from them (--elastic-policy, "
               "ElasticTrainer.init_or_restore: ROADMAP queue 1, item 7b); a restore keeps "
               "the saved --tp (its blocks and rows are cut by it): another --tp is refused")


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


# ---------------------------------------------------------------------------
# The npz archive of a world's save, written by every rank in place
# ---------------------------------------------------------------------------


def _gf2_times(mat: list, vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC-32 of ``a + b`` from ``crc32(a)``, ``crc32(b)`` and
    ``len(b)`` (zlib's ``crc32_combine``: ``crc1`` advanced over ``len2``
    zero bytes by squaring the one-zero-bit operator)."""
    if len2 <= 0:
        return crc1
    odd = [0xEDB88320] + [1 << n for n in range(31)]  # one zero bit
    even = [_gf2_times(odd, odd[n]) for n in range(32)]  # two
    odd = [_gf2_times(even, even[n]) for n in range(32)]  # four
    while True:
        even = [_gf2_times(odd, odd[n]) for n in range(32)]
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = [_gf2_times(even, even[n]) for n in range(32)]
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


_LOCAL = struct.Struct("<IHHHHHIIIHH")  # a zip local file header
_CENTRAL = struct.Struct("<IHHHHHHIIIHHHHHII")  # a central directory entry
_DATE = 0x21  # 1980-01-01, the zip epoch


class _NpzLayout:
    """The byte layout of an ``arrays.npz`` (a zip64 archive of stored
    ``.npy`` entries, what ``np.savez`` writes) for leaves of known keys,
    shapes and types, so that several processes can write one file in
    place: entry ``k`` holds its local header, then the ``.npy`` header,
    then the array's bytes (row r of a ``[dp, ...]`` leaf at
    :meth:`row_offset`), entries back to back; the central directory
    follows the last."""

    def __init__(self, specs: dict):
        """``specs``: {key: (shape, numpy dtype)} in the archive's order."""
        self.entries = []  # (key, name, header offset, npy header, data offset, nbytes)
        off = 0
        for key, (shape, dtype) in specs.items():
            name = (key + ".npy").encode()
            buf = io.BytesIO()
            np.lib.format.write_array_header_1_0(buf, {
                "descr": np.lib.format.dtype_to_descr(np.dtype(dtype)), "fortran_order": False,
                "shape": tuple(shape)})
            npy = buf.getvalue()
            nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            data = off + _LOCAL.size + len(name) + 20
            self.entries.append((key, name, off, npy, data, nbytes))
            off = data + len(npy) + nbytes
        self.end = off
        self.index = {e[0]: e for e in self.entries}

    def row_offset(self, key: str, rank: int, row_bytes: int) -> int:
        _, _, _, npy, data, _ = self.index[key]
        return data + len(npy) + rank * row_bytes

    def write_headers(self, f) -> None:
        """Every entry's local header (its CRC left 0) and ``.npy`` header."""
        for _, name, off, npy, _, nbytes in self.entries:
            size = len(npy) + nbytes
            f.seek(off)
            f.write(_LOCAL.pack(0x04034B50, 45, 0, 0, 0, _DATE, 0, 0xFFFFFFFF, 0xFFFFFFFF,
                                len(name), 20) + name + struct.pack("<HHQQ", 1, 16, size, size))
            f.write(npy)

    def npy_crc(self, key: str) -> int:
        return zlib.crc32(self.index[key][3])

    def finish(self, f, crcs: dict) -> None:
        """Write each entry's CRC-32 (``crcs``: {key: crc of its ``.npy``
        bytes}) into its local header, then the central directory and the
        zip64 end records."""
        central = []
        for key, name, off, npy, _, nbytes in self.entries:
            size = len(npy) + nbytes
            f.seek(off + 14)
            f.write(struct.pack("<I", crcs[key]))
            central.append(_CENTRAL.pack(
                0x02014B50, 45, 45, 0, 0, 0, _DATE, crcs[key], 0xFFFFFFFF, 0xFFFFFFFF,
                len(name), 28, 0, 0, 0, 0, 0xFFFFFFFF) + name
                + struct.pack("<HHQQQ", 1, 24, size, size, off))
        cd = b"".join(central)
        n = len(self.entries)
        f.seek(self.end)
        f.write(cd)
        f.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0, n, n, len(cd),
                            self.end))
        f.write(struct.pack("<IIQI", 0x07064B50, 0, self.end + len(cd), 1))
        f.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, min(n, 0xFFFF), min(n, 0xFFFF),
                            0xFFFFFFFF, 0xFFFFFFFF, 0))


def npz_members(path: str) -> dict:
    """{key: (shape, numpy dtype, data offset)} of an ``.npz`` of stored
    entries (``np.savez``'s, or a world save's), for ``np.memmap``."""
    out = {}
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for info in z.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed; a row read needs "
                                 "stored entries")
            f.seek(info.header_offset)
            head = _LOCAL.unpack(f.read(_LOCAL.size))
            f.seek(info.header_offset + _LOCAL.size + head[9] + head[10])
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            if fortran:
                raise ValueError(f"{path}: {info.filename} is in Fortran order")
            out[info.filename[:-len(".npy")]] = (shape, dtype, f.tell())
    return out


def _in_parts(key: str, parts) -> bool:
    return key.split("/", 1)[0] in parts


WAIT_S = 1800.0  # how long a world's writer waits for the other ranks' part of a save


def _wait_for(path: str, what: str, timeout: float = WAIT_S) -> None:
    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"checkpoint: {what} did not appear within {timeout} s ({path})")
        time.sleep(0.005)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, *,
                 save_every_steps: Optional[int] = None,
                 save_every_seconds: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 world: Optional[tuple[int, int]] = None):
        self.dir = directory
        self.keep = keep
        self.save_every_steps = save_every_steps
        self.save_every_seconds = save_every_seconds
        self._clock = clock
        # (rank, dp) of a world: every rank saves and restores its own part
        self.rank, self.dp = world if world is not None else (0, 1)
        self.world = world is not None
        os.makedirs(directory, exist_ok=True)
        if self.rank == 0:
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
        # one record a restore: step, bytes (copied out of the file)
        self.restores: list[dict] = []
        # {key path: host buffer} of the last save, reused by the next
        self._staging: Dict[str, torch.Tensor] = {}

    def bind_world(self, world: Optional[tuple[int, int]]) -> None:
        """Take part in the next saves and restores as row ``rank`` of a
        world of ``dp`` rows (``world=(rank, dp)``), or as the one writer
        (None).  A save in flight keeps the part it started with."""
        self.rank, self.dp = world if world is not None else (0, 1)
        self.world = world is not None

    def _stage(self, tree, keep: Callable[[str], bool] = lambda key: True
               ) -> tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
        """Host copies of every leaf whose key ``keep`` accepts (pinned,
        non-blocking for CUDA ones) in the kept buffers, and the event after
        the last device copy (None without one)."""
        staged, cuda = {}, False
        for key, leaf in flatten_with_paths(tree).items():
            if not keep(key):
                continue
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

    def save(self, step: int, state: Any, extra: Optional[dict] = None, *, block=False,
             rows: tuple = ()) -> None:
        """Snapshot ``state`` (nested dicts of tensors, arrays or numbers):
        stage host copies of its leaves, hand them to a writer thread and
        return (``block=False``), once the copies have landed
        (``"transfer"``), or once the write is published (``True``).  In a
        world every rank calls it with its own state, whose top-level parts
        ``rows`` hold its rows of the saved ``[dp, ...]`` leaves (the other
        parts are the same on every rank and rank 0 writes them)."""
        if self.world:
            return self._save_world(step, state, extra, block, rows)
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
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")

        def write():
            try:
                tw = time.perf_counter()
                if event is not None:
                    event.synchronize()
                flat = {k: _to_numpy(t) for k, t in staged.items()}
                transferred.set()
                os.makedirs(tmp, exist_ok=True)
                with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                    np.savez(f, **flat)
                    f.flush()
                    os.fsync(f.fileno())
                self._publish(tmp, final, step, manifest)
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

    def _save_world(self, step: int, state: Any, extra, block, rows: tuple) -> None:
        """A world's :meth:`save`: every rank writes its staged part of
        ``arrays.npz`` in place (:class:`_NpzLayout`); rank 0 also writes
        the headers, the checksums, the manifest and the publish."""
        tw0 = time.perf_counter()
        self.wait()
        t0 = time.perf_counter()
        flat = {k: torch.as_tensor(v) for k, v in flatten_with_paths(state).items()}
        specs = {k: (((self.dp,) if _in_parts(k, rows) else ()) + tuple(v.shape),
                     _np_dtype(v.dtype)) for k, v in flat.items()}
        layout = _NpzLayout(specs)
        mine = {k for k in flat if self.rank == 0 or _in_parts(k, rows)}
        staged, event = self._stage(state, keep=lambda k: k in mine)
        record = {"step": int(step), "wait_s": t0 - tw0,
                  "bytes": sum(t.numel() * t.element_size() for t in staged.values())}
        self.saves.append(record)
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        created = os.path.join(tmp, "created")
        transferred = threading.Event()
        rank, dp = self.rank, self.dp

        def write():
            try:
                tw = time.perf_counter()
                if event is not None:
                    event.synchronize()
                transferred.set()
                path = os.path.join(tmp, "arrays.npz")
                if rank == 0:
                    if os.path.exists(tmp):
                        shutil.rmtree(tmp)
                    os.makedirs(tmp)
                    with open(path, "wb") as f:
                        f.truncate(layout.end)
                        layout.write_headers(f)
                    open(created, "w").close()
                else:
                    _wait_for(created, f"rank 0's archive of step {step}")
                crcs = {}
                with open(path, "r+b") as f:
                    for key, host in staged.items():
                        data = _to_numpy(host).reshape(-1).view(np.uint8)
                        row = _in_parts(key, rows)
                        f.seek(layout.row_offset(key, rank if row else 0, data.nbytes))
                        f.write(data)
                        crcs[key] = zlib.crc32(data)
                    f.flush()
                    os.fsync(f.fileno())
                marker = os.path.join(tmp, f"rank{rank}.json")
                with open(marker + ".part", "w") as f:
                    json.dump({k: [v, int(staged[k].numel() * staged[k].element_size())]
                               for k, v in crcs.items()}, f)
                os.replace(marker + ".part", marker)
                if rank != 0:
                    _wait_for(final, f"rank 0's publish of step {step}")
                    record["write_s"] = time.perf_counter() - tw
                    return
                parts = []
                for r in range(dp):
                    _wait_for(os.path.join(tmp, f"rank{r}.json"), f"rank {r}'s part of step {step}")
                    with open(os.path.join(tmp, f"rank{r}.json")) as f:
                        parts.append(json.load(f))
                full = {}
                for key in specs:
                    crc = layout.npy_crc(key)
                    for part in (parts if _in_parts(key, rows) else parts[:1]):
                        c, n = part[key]
                        crc = crc32_combine(crc, c, n)
                    full[key] = crc
                with open(path, "r+b") as f:
                    layout.finish(f, full)
                    f.flush()
                    os.fsync(f.fileno())
                manifest = {"step": int(step), "time": time.time(), "extra": extra or {},
                            "n_arrays": len(specs), "layout_version": LAYOUT_VERSION,
                            "bf16": sorted(k for k, v in flat.items()
                                           if v.dtype == torch.bfloat16)}
                for r in range(dp):
                    os.unlink(os.path.join(tmp, f"rank{r}.json"))
                os.unlink(created)
                self._publish(tmp, final, step, manifest)
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

    def save_streamed(self, step: int, specs: dict, leaves, extra: Optional[dict] = None) -> None:
        """A blocking save that holds one leaf on the host at a time (a
        sharded state whose leaves are gathered one by one): ``specs`` is
        {key: (shape, torch dtype)} of every leaf, in the archive's order,
        and ``leaves`` yields (key, tensor) for each, in any order; each is
        copied to the host, written at its offset in ``arrays.npz``
        (:class:`_NpzLayout`) and let go before the next is taken.  The
        file, manifest and publish are :meth:`save`'s; the record also
        has ``peak_bytes``, the largest leaf held."""
        tw0 = time.perf_counter()
        self.wait()
        t0 = time.perf_counter()
        layout = _NpzLayout({k: (shape, _np_dtype(dt)) for k, (shape, dt) in specs.items()})
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        crcs, nbytes, peak = {}, 0, 0
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            f.truncate(layout.end)
            layout.write_headers(f)
            for key, leaf in leaves:
                shape, dtype = specs[key]
                host = leaf.detach().to("cpu", memory_format=torch.contiguous_format)
                if tuple(host.shape) != tuple(shape) or host.dtype != dtype:
                    raise ValueError(f"checkpoint leaf {key}: {tuple(host.shape)} {host.dtype} "
                                     f"given, {tuple(shape)} {dtype} expected")
                data = _to_numpy(host).reshape(-1).view(np.uint8)
                f.seek(layout.row_offset(key, 0, 0))
                f.write(data)
                crcs[key] = zlib.crc32(data, layout.npy_crc(key))
                nbytes += data.nbytes
                peak = max(peak, data.nbytes)
                del host, data
            missing = sorted(set(specs) - set(crcs))
            if missing:
                raise ValueError(f"checkpoint step {step}: no leaf given for {missing[:8]}")
            layout.finish(f, crcs)
            f.flush()
            os.fsync(f.fileno())
        manifest = {"step": int(step), "time": time.time(), "extra": extra or {},
                    "n_arrays": len(specs), "layout_version": LAYOUT_VERSION,
                    "bf16": sorted(k for k, (_, dt) in specs.items() if dt == torch.bfloat16)}
        self._publish(tmp, final, step, manifest)
        self._last_save_at = self._clock()
        took = time.perf_counter() - t0
        self.saves.append({"step": int(step), "wait_s": t0 - tw0, "bytes": nbytes,
                           "peak_bytes": peak, "hold_s": took, "write_s": took})

    def _publish(self, tmp: str, final: str, step: int, manifest: dict) -> None:
        """Write the manifest into ``tmp``, rename it to ``final`` and
        point ``LATEST`` at ``step``; then drop the steps past ``keep``."""
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

    def _checked_manifest(self, step: int, dp: Optional[int]) -> dict:
        d = os.path.join(self.dir, f"step_{step}")
        manifest = self.manifest(step) if os.path.exists(os.path.join(d, "manifest.json")) else {}
        saved_dp = manifest.get("extra", {}).get("dp")
        if dp is not None and saved_dp is not None and saved_dp != dp:
            raise ValueError(f"checkpoint step {step} was saved at dp={saved_dp}, this run has "
                             f"dp={dp}: {RESIZE_HINT}")
        return manifest

    def restore(self, step: int, template: Any, device="cpu", *, dp: Optional[int] = None):
        """Load step ``step`` into ``template``'s structure (nested dicts of
        tensors): every leaf a tensor of the template leaf's shape and type
        on ``device``, bf16 leaves bit for bit.  An older layout is
        migrated first.  ``dp``, when given, must be the one the manifest's
        ``extra`` records (a checkpoint of another width raises, as a leaf
        of another shape does)."""
        device = resolve_device(device)
        manifest = self._checked_manifest(step, dp)
        with np.load(os.path.join(self.dir, f"step_{step}", "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        version = manifest.get("layout_version", 1)
        if version != LAYOUT_VERSION:
            flat = migrate_layout(flat, template, version)
        bf16 = set(manifest.get("bf16", ()))
        out = {}
        for key, (shape, dtype) in _specs(template).items():
            out[key] = _leaf(step, key, flat, shape, dtype, bf16, device)
        return _unflatten(out)

    def restore_rank(self, step: int, template: Any, rows: tuple, device="cpu", *,
                     dp: Optional[int] = None):
        """A world rank's :meth:`restore` (``world=(rank, dp)``): ``template``
        is the rank's own state, whose top-level parts ``rows`` hold its
        rows of the saved ``[dp, ...]`` leaves; each such leaf is read as
        row ``rank`` of the file's through ``np.memmap``, so a rank reads
        its rows and not the others'.  The checkpoint must have this
        world's dp (``dp``, when the world's rows are more than its data
        ranks: a rank a ``(data, model)`` coordinate)."""
        full = {k: (((self.dp,) if _in_parts(k, rows) else ()) + shape, dtype)
                for k, (shape, dtype) in _specs(template).items()}
        return self._read_mapped(step, full, {k: self.rank for k in full if _in_parts(k, rows)},
                                 device, self.dp if dp is None else dp)

    def restore_blocks(self, step: int, template: Any, blocks: dict, device="cpu", *,
                       dp: Optional[int] = None):
        """:meth:`restore` of a rank that holds blocks of the saved leaves:
        a leaf whose key ``blocks`` names is read as ``leaf[blocks[key]]``
        (a numpy index, e.g. ``sharding.local_index``'s slices) through
        ``np.memmap``, so only the block is copied out of the file; the
        other leaves whole.  ``template`` has the saved (global) shapes."""
        return self._read_mapped(step, _specs(template), blocks, device, dp)

    def _read_mapped(self, step: int, specs: dict, index: dict, device, dp: Optional[int]):
        """The leaves of ``specs`` ({key: (saved shape, dtype)}) read out of
        step ``step``'s archive through ``np.memmap``, leaf ``k`` cut to
        ``[index[k]]`` where given; records the bytes copied out in
        :attr:`restores`."""
        device = resolve_device(device)
        manifest = self._checked_manifest(step, dp)
        path = os.path.join(self.dir, f"step_{step}", "arrays.npz")
        flat = {k: np.memmap(path, dtype=dt, mode="r", offset=off, shape=shape)
                if int(np.prod(shape)) else np.zeros(shape, dt)
                for k, (shape, dt, off) in npz_members(path).items()}
        version = manifest.get("layout_version", 1)
        if version != LAYOUT_VERSION:
            flat = migrate_layout(flat, _unflatten({
                k: torch.empty(shape, dtype=dtype, device="meta")
                for k, (shape, dtype) in specs.items()}), version)
        bf16 = set(manifest.get("bf16", ()))
        out = {}
        for key, (shape, dtype) in specs.items():
            out[key] = _leaf(step, key, flat, shape, dtype, bf16, device, index.get(key))
        self.restores.append({"step": int(step), "bytes": sum(
            t.numel() * t.element_size() for t in out.values())})
        return _unflatten(out)

def _leaf(step: int, key: str, flat: dict, shape: tuple, dtype, bf16: set, device,
          index=None) -> torch.Tensor:
    """The restored tensor of ``key`` from a checkpoint's ``flat`` arrays:
    of ``shape`` and ``dtype`` (its part ``[index]`` when given: a row, a
    block), bf16 leaves from their bit patterns."""
    if key not in flat:
        raise ValueError(f"checkpoint step {step} has no leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != shape:
        raise ValueError(f"shape mismatch for {key}: {tuple(arr.shape)} saved, "
                         f"{shape} expected (if the data-parallel width differs: "
                         f"{RESIZE_HINT})")
    if index is not None:
        arr = arr[index]
    arr = np.require(np.asarray(arr), requirements="C")  # keeps 0-d leaves 0-d
    if isinstance(arr, np.memmap) or not arr.flags.writeable:
        arr = np.array(arr)
    if key in bf16 or (arr.dtype.itemsize == 2 and arr.dtype.kind in "Vu"
                       and dtype == torch.bfloat16):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)
