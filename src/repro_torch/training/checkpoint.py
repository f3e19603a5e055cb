"""Fault-tolerant checkpointing: msgpack pytrees, atomic rename,
per-leaf CRC32 integrity, async writer thread, latest-pointer restart.

Layout:
  <dir>/step_000042.ckpt      (zlib-compressed msgpack, tagged ``ZLB0``)
  <dir>/latest                (text file: "step_000042.ckpt")

The port's copy of ``repro.training.checkpoint``, byte-compatible with
it: the same msgpack map ``{"leaves": {key: {dtype, shape, crc, data}},
"extra": {...}}``, the same leaf keys (dict keys in sorted order, list
indices as numbers, joined by ``/``), the same ``ZLB0``-tagged zlib blob
the reference writes when ``zstandard`` is missing.  Neither ``msgpack``
nor ``zstandard`` is imported: the port carries its own codec for the
msgpack subset these files use (:func:`packb` / :func:`unpackb`), and a
zstd-compressed checkpoint raises :class:`ZstdError`.  Leaves may be
torch tensors or numpy arrays; restored leaves are numpy arrays.
"""
from __future__ import annotations

import os
import queue
import struct
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


# -- msgpack subset -----------------------------------------------------------

class CodecError(ValueError):
    """Bytes or an object outside the msgpack subset this codec speaks:
    maps, arrays, str and bin (every width), ints up to 64 bits,
    float64, nil and bool."""


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        if obj >= 0:
            if obj < 0x80:
                out.append(struct.pack(">B", obj))
            elif obj <= 0xff:
                out.append(struct.pack(">BB", 0xcc, obj))
            elif obj <= 0xffff:
                out.append(struct.pack(">BH", 0xcd, obj))
            elif obj <= 0xffffffff:
                out.append(struct.pack(">BI", 0xce, obj))
            elif obj <= 0xffffffffffffffff:
                out.append(struct.pack(">BQ", 0xcf, obj))
            else:
                raise CodecError(f"int {obj} does not fit 64 bits")
        elif obj >= -32:
            out.append(struct.pack(">b", obj))
        elif obj >= -0x80:
            out.append(struct.pack(">Bb", 0xd0, obj))
        elif obj >= -0x8000:
            out.append(struct.pack(">Bh", 0xd1, obj))
        elif obj >= -0x80000000:
            out.append(struct.pack(">Bi", 0xd2, obj))
        elif obj >= -0x8000000000000000:
            out.append(struct.pack(">Bq", 0xd3, obj))
        else:
            raise CodecError(f"int {obj} does not fit 64 bits")
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(struct.pack(">B", 0xa0 | n))
        elif n <= 0xff:
            out.append(struct.pack(">BB", 0xd9, n))
        elif n <= 0xffff:
            out.append(struct.pack(">BH", 0xda, n))
        else:
            out.append(struct.pack(">BI", 0xdb, n))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        if n <= 0xff:
            out.append(struct.pack(">BB", 0xc4, n))
        elif n <= 0xffff:
            out.append(struct.pack(">BH", 0xc5, n))
        else:
            out.append(struct.pack(">BI", 0xc6, n))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(struct.pack(">B", 0x90 | n))
        elif n <= 0xffff:
            out.append(struct.pack(">BH", 0xdc, n))
        else:
            out.append(struct.pack(">BI", 0xdd, n))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(struct.pack(">B", 0x80 | n))
        elif n <= 0xffff:
            out.append(struct.pack(">BH", 0xde, n))
        else:
            out.append(struct.pack(">BI", 0xdf, n))
        for key, val in obj.items():
            _pack(key, out)
            _pack(val, out)
    else:
        raise CodecError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# fixed-width heads: type byte -> (struct format, kind)
_FIXED = {0xcc: (">B", "int"), 0xcd: (">H", "int"), 0xce: (">I", "int"),
          0xcf: (">Q", "int"), 0xd0: (">b", "int"), 0xd1: (">h", "int"),
          0xd2: (">i", "int"), 0xd3: (">q", "int"), 0xcb: (">d", "float"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"),
          0xde: (">H", "map"), 0xdf: (">I", "map")}


def _unpack(data: bytes, o: int):
    if o >= len(data):
        raise CodecError("truncated msgpack data")
    b = data[o]
    o += 1
    if b <= 0x7f:
        return b, o
    if b >= 0xe0:
        return b - 0x100, o
    if 0xa0 <= b <= 0xbf:
        kind, n = "str", b & 0x1f
    elif 0x90 <= b <= 0x9f:
        kind, n = "array", b & 0x0f
    elif 0x80 <= b <= 0x8f:
        kind, n = "map", b & 0x0f
    elif b == 0xc0:
        return None, o
    elif b == 0xc2:
        return False, o
    elif b == 0xc3:
        return True, o
    elif b in _FIXED:
        fmt, kind = _FIXED[b]
        size = struct.calcsize(fmt)
        if o + size > len(data):
            raise CodecError("truncated msgpack data")
        (n,) = struct.unpack_from(fmt, data, o)
        o += size
        if kind in ("int", "float"):
            return n, o
    else:
        raise CodecError(f"msgpack type byte 0x{b:02x} is outside the "
                         "subset")
    if kind in ("str", "bin"):
        if o + n > len(data):
            raise CodecError("truncated msgpack data")
        raw = data[o:o + n]
        if kind == "str":
            try:
                return raw.decode("utf-8"), o + n
            except UnicodeDecodeError as e:
                raise CodecError(str(e)) from None
        return raw, o + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, o = _unpack(data, o)
            items.append(item)
        return items, o
    out = {}
    for _ in range(n):
        key, o = _unpack(data, o)
        if not isinstance(key, str):
            raise CodecError(f"map key {key!r} is not a str")
        out[key], o = _unpack(data, o)
    return out, o


def unpackb(data: bytes):
    """``msgpack.unpackb(data, raw=False)`` for the subset."""
    data = bytes(data)
    obj, o = _unpack(data, 0)
    if o != len(data):
        raise CodecError(f"{len(data) - o} extra bytes after the object")
    return obj


# -- compression --------------------------------------------------------------

class ZstdError(IOError):
    """A blob this build cannot decompress."""


def _compress(data: bytes) -> bytes:
    return b"ZLB0" + zlib.compress(data, level=6)


def _decompress(blob: bytes) -> bytes:
    if not blob.startswith(b"ZLB0"):
        raise ZstdError("zstd-compressed checkpoint but zstandard is not "
                        "installed")
    return zlib.decompress(blob[4:])


# -- trees --------------------------------------------------------------------

def _leaves_with_keys(tree, path=()):
    """(key, leaf) pairs in ``jax.tree_util`` order: dict keys sorted,
    list/tuple items by index; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_keys(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype; a router "
                            "checkpoint holds none")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in _leaves_with_keys(tree)}


def _map_leaves(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return None if tree is None else fn("/".join(path), tree)


def serialize(tree, extra: Optional[Dict[str, Any]] = None) -> bytes:
    payload = {"leaves": {}, "extra": extra or {}}
    for k, arr in _flatten(tree).items():
        buf = arr.tobytes()
        payload["leaves"][k] = {
            "dtype": str(arr.dtype), "shape": list(arr.shape),
            "crc": zlib.crc32(buf), "data": buf,
        }
    return _compress(packb(payload))


def deserialize(blob: bytes, like_tree) -> Tuple[Any, Dict[str, Any]]:
    """Rebuild ``like_tree``'s structure from a checkpoint blob; the
    leaves come back as (read-only) numpy arrays."""
    payload = unpackb(_decompress(blob))
    leaves_by_key = {}
    for k, rec in payload["leaves"].items():
        buf = rec["data"]
        if zlib.crc32(buf) != rec["crc"]:
            raise IOError(f"checkpoint leaf {k!r} failed CRC check")
        leaves_by_key[k] = np.frombuffer(
            buf, dtype=np.dtype(rec["dtype"])).reshape(rec["shape"])
    like = dict(_leaves_with_keys(like_tree))
    if set(like) != set(leaves_by_key):
        missing = set(like) ^ set(leaves_by_key)
        raise IOError(f"checkpoint tree mismatch: {sorted(missing)[:5]}")
    for key, leaf in like.items():
        arr = leaves_by_key[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise IOError(f"shape mismatch at {key}: {arr.shape} vs "
                          f"{tuple(leaf.shape)}")
    tree = _map_leaves(like_tree, lambda key, _: leaves_by_key[key])
    return tree, payload["extra"]


class CheckpointManager:
    """Async, atomic checkpointing with restart support.  Owns a writer
    thread: call :meth:`close` when done."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- writing ----------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None,
             sync: bool = False):
        # device->host copies happen on the caller thread (so later
        # in-place updates of the live tensors cannot reach the file);
        # compression+IO happen on the writer thread
        host_tree = _map_leaves(tree, lambda _, x: _host(x).copy())
        self._q.put((step, host_tree, extra))
        if sync:
            self.wait()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree, extra = item
            try:
                self._write(step, tree, extra)
            except BaseException as e:       # surfaced on wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, tree, extra):
        name = f"step_{step:09d}.ckpt"
        blob = serialize(tree, {"step": step, **(extra or {})})
        tmp = os.path.join(self.dir, f".tmp.{name}")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(self.dir, name))   # atomic
        ptr_tmp = os.path.join(self.dir, ".tmp.latest")
        with open(ptr_tmp, "w") as f:
            f.write(name)
        os.rename(ptr_tmp, os.path.join(self.dir, "latest"))
        self._gc()

    def _gc(self):
        ckpts = sorted(p for p in os.listdir(self.dir)
                       if p.startswith("step_"))
        for old in ckpts[:-self.keep]:
            os.unlink(os.path.join(self.dir, old))

    def wait(self):
        self._q.join()
        if self._err:
            err, self._err = self._err, None
            raise err

    def close(self):
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join(timeout=5)

    # -- restart ----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "latest")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        return int(name.split("_")[1].split(".")[0])

    def restore(self, like_tree) -> Optional[Tuple[Any, Dict]]:
        """Restore the newest intact checkpoint (falls back through older
        ones if the newest is corrupt -- crash-during-write tolerance)."""
        ckpts = sorted((p for p in os.listdir(self.dir)
                        if p.startswith("step_")), reverse=True)
        for name in ckpts:
            try:
                with open(os.path.join(self.dir, name), "rb") as f:
                    return deserialize(f.read(), like_tree)
            except (IOError, ValueError, zlib.error):
                continue
        return None


# -- full learner round-trips (online trainer warm-start / resume) --------

def save_learner(directory: str, step: int, agent, keep: int = 3):
    """Checkpoint the FULL learner state (Q + target + optimizer +
    replay-buffer contents + centering EMA + RNG) so an online trainer
    can resume mid-stream bit-exactly.  Synchronous: when this returns
    the checkpoint is durable."""
    tree, extra = agent.full_state()
    mgr = CheckpointManager(directory, keep=keep)
    try:
        mgr.save(step, tree, extra, sync=True)
    finally:
        mgr.close()


def restore_learner(directory: str, agent) -> Optional[int]:
    """Restore ``agent`` from ``directory``; returns the checkpoint step
    or None if nothing intact was found.

    Accepts two artifact flavors: a FULL learner checkpoint
    (``save_learner``) restores everything for exact mid-stream resume;
    a params-only ``state_dict`` artifact (the offline trainers'
    format) warm-starts just the networks + optimizer -- the replay
    buffer and RNG stay fresh."""
    if not os.path.isdir(directory):
        return None
    mgr = CheckpointManager(directory)
    try:
        full_like, _ = agent.full_state()
        out = mgr.restore(full_like)
        if out is not None:
            tree, extra = out
            agent.load_full_state(tree, extra)
            return int(extra.get("step", 0))
        out = mgr.restore(agent.state_dict())
        if out is not None:
            tree, extra = out
            agent.load_state_dict(tree)
            return int(extra.get("step", 0))
        return None
    finally:
        mgr.close()
