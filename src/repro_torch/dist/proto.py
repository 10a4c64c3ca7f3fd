"""Wire protocol of the elastic multi-process fit (repro_torch.dist).

The port's own copy of ``repro.dist.proto`` (numpy and the standard
library only): the same frames, byte for byte, for the same message.

One frame = one message. The layout is deliberately boring:

    +--------+----------+------------+---------------------------+
    | b"DPMM" | crc32    | length     | npz payload (length bytes)|
    | 4 bytes | <I (LE)  | <Q (LE)    |                           |
    +--------+----------+------------+---------------------------+

The payload is a standard ``np.savez`` archive holding a ``__msg__``
uint8 leaf (UTF-8 JSON: ``{"kind": ..., "meta": {...}}``) plus any
number of ``a_<name>`` array leaves. Arrays travel as raw npy bytes —
lossless, which is what lets the coordinator ship ModelState / plans and
fold worker partials **bitwise**.

Failure handling is typed and total: a bad magic, a truncated header or
payload, an oversized length field, a CRC mismatch, or an unparseable
archive all raise :class:`ProtocolError` from ``recv_msg`` — never
garbage data, and never a hang (EOF surfaces immediately; callers that
need bounded waits set a socket timeout, which surfaces here as
``socket.timeout``/``OSError``). The CRC is checked before the payload
is parsed, so a bit-flipped frame is rejected without interpreting it.

``pack_tree`` / ``unpack_tree`` flatten a fixed-structure tree of
dataclasses, tuples and lists (e.g. a ``SplitMergePlan``) to numbered
array leaves in field order and back; the receiver supplies a structural
template, so the wire carries no pickled code. Leaves keep their dtypes
(integer index arrays stay integer), and a leaf whose shape or dtype is
not the template's is refused.
"""
from __future__ import annotations

import dataclasses
import io
import json
import socket
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"DPMM"
_HEADER = struct.Struct("<4sIQ")          # magic, crc32, payload length
# Frames hold O(k_max * d) model state or O(blocks * k_c * d) partials —
# megabytes at most. The cap exists so a corrupted length field fails
# loudly instead of attempting a multi-GiB allocation.
MAX_FRAME_BYTES = 1 << 31


class ProtocolError(RuntimeError):
    """A frame failed validation (bad magic / truncation / EOF / CRC
    mismatch / unparseable payload). The connection is unusable after
    this — framing is lost — so callers treat it as peer loss."""


def no_delay(sock) -> None:
    """Send each frame at once (``TCP_NODELAY``): the request/reply
    pattern of WORK and RESULT otherwise waits on delayed ACKs."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def _recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise :class:`ProtocolError` on EOF /
    short stream (a killed peer closes mid-frame; that must never hang
    or return a partial buffer)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ProtocolError(
                f"connection closed mid-frame: wanted {n} bytes, "
                f"got {got}")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_msg(sock, kind: str, meta: Optional[dict] = None,
             arrays: Optional[Dict[str, np.ndarray]] = None,
             lock=None) -> None:
    """Frame and send one message. ``lock`` (if given) serializes the
    ``sendall`` — the worker's heartbeat thread and main loop share one
    socket, and interleaved frames would corrupt the stream."""
    buf = io.BytesIO()
    msg = json.dumps({"kind": kind, "meta": meta or {}}).encode("utf-8")
    named = {f"a_{k}": np.asarray(v) for k, v in (arrays or {}).items()}
    np.savez(buf, __msg__=np.frombuffer(msg, np.uint8), **named)
    payload = buf.getvalue()
    if len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"refusing to send {len(payload)}-byte frame "
            f"(cap {MAX_FRAME_BYTES})")
    frame = _HEADER.pack(MAGIC, zlib.crc32(payload), len(payload)) + payload
    if lock is not None:
        with lock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)


def recv_msg(sock) -> Tuple[str, dict, Dict[str, np.ndarray]]:
    """Receive one frame; returns ``(kind, meta, arrays)``. Raises
    :class:`ProtocolError` on any validation failure (see module doc)."""
    magic, crc, length = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if magic != MAGIC:
        raise ProtocolError(
            f"bad frame magic {magic!r} (want {MAGIC!r}) — stream is "
            "desynchronized or the peer is not a repro.dist endpoint")
    if length > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame length {length} exceeds cap {MAX_FRAME_BYTES} — "
            "corrupted header")
    payload = _recv_exact(sock, length)
    got_crc = zlib.crc32(payload)
    if got_crc != crc:
        raise ProtocolError(
            f"frame CRC mismatch: header says {crc:#010x}, payload "
            f"hashes to {got_crc:#010x} — bit flip or truncation in "
            "transit")
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            msg = json.loads(bytes(np.asarray(z["__msg__"])).decode("utf-8"))
            arrays = {k[2:]: np.asarray(z[k]) for k in z.files
                      if k.startswith("a_")}
    except ProtocolError:
        raise
    except Exception as e:                      # zipfile/json/KeyError zoo
        raise ProtocolError(
            f"unparseable frame payload ({type(e).__name__}: {e})") from e
    kind = msg.get("kind")
    if not isinstance(kind, str):
        raise ProtocolError(f"frame __msg__ has no string 'kind': {msg!r}")
    return kind, msg.get("meta", {}), arrays


# ---------------------------------------------------------------------------
# Trees of dataclasses <-> numbered array leaves (structure from the receiver)
# ---------------------------------------------------------------------------
def _leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in canonical order: dataclass fields in
    declaration order, tuple and list items in order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a host array: a tensor is copied off its device."""
    cpu = getattr(leaf, "cpu", None)
    return np.asarray(cpu() if callable(cpu) else leaf)


def pack_tree(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    """Flatten ``tree`` into ``{prefix}{i}`` host arrays in canonical leaf
    order."""
    return {f"{prefix}{i}": _host(leaf)
            for i, leaf in enumerate(_leaves(tree))}


def unpack_tree(template: Any, arrays: Dict[str, np.ndarray],
                prefix: str) -> Any:
    """Rebuild a tree shaped like ``template`` from ``pack_tree`` leaves
    (numpy arrays). Raises :class:`ProtocolError` if a leaf is missing or
    its shape or dtype is not the template's — a structurally wrong
    message must not reach a kernel."""
    count = [0]

    def build(node):
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return type(node)(**{f.name: build(getattr(node, f.name))
                                 for f in dataclasses.fields(node)})
        if isinstance(node, (tuple, list)):
            return type(node)(build(item) for item in node)
        name = f"{prefix}{count[0]}"
        count[0] += 1
        if name not in arrays:
            raise ProtocolError(f"message is missing tree leaf {name!r} "
                                f"for prefix {prefix!r}")
        got, want = arrays[name], _host(node)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ProtocolError(
                f"tree leaf {name!r} is {got.dtype}{list(got.shape)}, the "
                f"template's {want.dtype}{list(want.shape)}")
        return got
    return build(template)
