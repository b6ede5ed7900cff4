"""Length-prefixed wire protocol for the cluster data plane (DESIGN.md §12).

A *message* is a batch of frames::

    [4s magic "RJW1"][u64 n_frames][u64 len_0 ... u64 len_{n-1}]
    [frame_0][frame_1]...[frame_{n-1}]

Frame 0 is always pickled metadata (a dict).  Frames 1.. are ndarray
payloads in the ``raw``-codec layout from :mod:`repro_torch.core.serialization`
(packed header + contiguous buffer), byte for byte the JAX package's
frames.  On send, the array's own buffer is handed to ``sendall`` as a
memoryview — no intermediate serialized copy (non-contiguous inputs are
copied contiguous first, the codec's copy-on-encode rule).  On receive,
each frame lands in one freshly allocated buffer and is reconstructed
zero-copy with ``np.frombuffer``.

The device boundary lives here too.  A ``torch.Tensor`` (or a
:class:`~repro_torch.core.executors.CardResult`, the host bytes of a
tensor that lived on a card) is a frame of its own kind::

    [4s "RJT1"][u8 n][n bytes "dtype|device", NUL-padded to 8-byte
    alignment][raw-codec header of the host bytes][host bytes]

— host bytes only (bf16 as an int16 bit view, as on the process plane),
with the dtype and the device type the tensor lived on.  It decodes to a
CPU tensor, or for a card tensor to a ``CardResult`` over the host
bytes: a receiver that has no card context (a node agent) never makes
one, and a card tensor is rebuilt on the card only where it is read.
Tensors are framed at every size, never pickled: a pickled CUDA tensor
would initialise CUDA in whichever process unpickled it.

All length fields are unsigned 64-bit, so single frames and messages
beyond 4 GiB are representable (dask's comm core made the same choice
after real workloads hit the u32 ceiling).

Structure packing (``pack_payload`` / ``unpack_payload``) turns a nested
args/kwargs structure into (picklable metadata, frame list) using four
markers:

* ``Frame(i)``     — the value is ndarray frame *i* of the message;
* ``Ref(key)``     — the value is already cached in the receiving node's
                     object plane under ``(data_id, version)``;
* ``Put(key, v)``  — cache ``v`` (a structure possibly containing
                     ``Frame`` markers) under ``key``, then use it — the
                     send-once half of the send-once/reuse-many property.
                     Keying happens at the *datum* level: a tuple-valued
                     datum is one ``Put`` whose inner arrays ride frames,
                     so structured results get the same caching as plain
                     ndarrays;
* ``Fetch(key,…)`` — the value is node-resident on a *peer* (DESIGN.md
                     §15): the receiver pulls it straight from the
                     producing agent's data plane instead of the
                     scheduler shipping bytes it does not hold.

``RemoteRef`` is the result-side descriptor: a ``done`` reply whose datum
stays resident on the producing node carries ``RemoteRef(token, nbytes)``
instead of frames — the scheduler records a
:class:`~repro_torch.core.futures.RemoteValue` placeholder and only metadata
crossed its link.
"""
from __future__ import annotations

import os
import pickle
import struct
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.executors import (
    _TORCH_DTYPES,
    CardResult,
    _header_proxy,
    _host_tensor,
)
from ..core.serialization import _pack_header, _unpack_header, as_c_contiguous
from . import chaos
from ..core.config import parse_bool

MAGIC = b"RJW1"
_HEAD = struct.Struct("<4sQ")        # magic, n_frames
_U64 = struct.Struct("<Q")
_CRC = struct.Struct("<I")           # per-frame CRC32 trailer

# RJAX_WIRE_CHECKSUM: append a CRC32 trailer to every out-of-band frame
# (frames 1..; frame 0's pickle already fails loudly on corruption) and
# verify on receive — a flipped bit surfaces as ChecksumError, a
# retryable transfer error, never silent data corruption.  Read at
# import (agents inherit the scheduler's environment); both ends of a
# link MUST agree, which the single-env LocalCluster guarantees.
WIRE_CHECKSUM = parse_bool(os.environ.get("RJAX_WIRE_CHECKSUM"))


def refresh_checksum() -> bool:
    """Re-read ``RJAX_WIRE_CHECKSUM`` (tests toggle it mid-process)."""
    global WIRE_CHECKSUM
    WIRE_CHECKSUM = parse_bool(os.environ.get("RJAX_WIRE_CHECKSUM"))
    return WIRE_CHECKSUM

# frames are for raw-codec-eligible ndarrays; anything smaller than this
# is cheaper pickled inline in the metadata frame (keyed data is framed
# regardless — it gets cached and reused on the far side)
WIRE_MIN_FRAME_BYTES = 1024

# result datums whose frame-eligible bytes stay below this ride the `done`
# reply inline (one pickle, no token, no alias round-trip, no potential
# peer fetch); at or above it they stay node-resident and the reply
# carries only a RemoteRef descriptor (DESIGN.md §15)
DEFAULT_INLINE_MAX = 8192


def inline_max_from_env(explicit=None) -> int:
    """Resolve the ``RJAX_INLINE_MAX`` knob (0 = inline nothing, always
    defer/frame — the pre-§15 result encoding)."""
    if explicit is not None:
        return max(0, int(explicit))
    return max(0, int(os.environ.get("RJAX_INLINE_MAX", DEFAULT_INLINE_MAX)))

# messages whose total size (header + metadata + all frames) is at or
# below this are copied into ONE contiguous buffer and written with a
# single sendall — with TCP_NODELAY on, each sendall is its own packet,
# so a small task message with a handful of little Ref/Put frames would
# otherwise cost one packet per part (DESIGN.md §14).  Large frames keep
# the zero-copy path: their buffers go to sendall directly.
WIRE_COALESCE_MAX = int(os.environ.get("RJAX_WIRE_COALESCE", 65536))


class ConnectionClosed(ConnectionError):
    """The peer went away.  ``mid_message`` distinguishes a clean close
    between messages from a cut mid-frame (both are fatal for the
    connection; the executor surfaces either as a retryable
    ``WorkerCrashedError``)."""

    def __init__(self, message: str = "connection closed", mid_message: bool = False):
        super().__init__(message)
        self.mid_message = mid_message


class ChecksumError(ConnectionClosed):
    """A frame's CRC32 trailer did not match its payload (wire
    corruption).  A :class:`ConnectionClosed` subclass: the stream can no
    longer be trusted, so the connection is torn down and the transfer
    retried through the normal recovery paths (``WorkerCrashedError`` /
    ``PeerFetchError``) — corruption is loud, never silent."""

    def __init__(self, message: str = "frame checksum mismatch"):
        super().__init__(message, mid_message=True)


def frame_crc(parts) -> int:
    """CRC32 over one frame's buffer parts (send side streams the same
    bytes the receiver will hash as one contiguous buffer)."""
    import zlib
    crc = 0
    for p in parts:
        crc = zlib.crc32(p, crc)
    return crc & 0xFFFFFFFF


def _chaos_bitflip(frames: List[List]) -> List[List]:
    """The ``bitflip`` chaos seam: corrupt one byte of the first
    out-of-band frame in a COPY (the parts are memoryviews over live
    arrays — the sender's data must stay intact)."""
    inj = chaos.INJECTOR
    if inj is None or not frames:
        return frames
    if inj.roll("bitflip", "wire") is None:
        return frames
    blob = bytearray(b"".join(bytes(p) for p in frames[0]))
    if blob:
        blob[len(blob) // 2] ^= 0x01
    out = list(frames)
    out[0] = [bytes(blob)]
    return out


# ------------------------------------------------------------------ raw I/O
def recv_exactly(sock, n: int, mid_message: bool = True) -> memoryview:
    """Read exactly ``n`` bytes, tolerating arbitrarily short reads."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:])
        except (ConnectionResetError, BrokenPipeError, OSError) as err:
            raise ConnectionClosed(str(err) or "connection reset",
                                   mid_message=mid_message or got > 0) from err
        if k == 0:
            raise ConnectionClosed("peer closed the connection",
                                   mid_message=mid_message or got > 0)
        got += k
    return view


def send_msg(sock, meta: dict, frames: Sequence[Sequence] = ()) -> None:
    """Send one message.  Each entry of ``frames`` is a list of buffer
    parts (bytes/memoryview) forming one frame.

    Small messages (≤ ``WIRE_COALESCE_MAX`` total) are coalesced into one
    buffer and one ``sendall`` — one syscall, one packet — which is the
    common shape for pipelined task requests whose inputs are all ``Ref``
    markers or small ``Put`` frames.  Past the threshold, the header and
    metadata still go out in one write but each large frame part is handed
    to ``sendall`` straight from the array's own buffer — no intermediate
    serialized copy."""
    meta_blob = pickle.dumps(meta, protocol=5)
    if WIRE_CHECKSUM or chaos.INJECTOR is not None:
        frames = list(frames)
        # the trailer hashes the true payload BEFORE the bitflip seam
        # corrupts it — corruption happens "on the wire", after checksum
        trailers = [_CRC.pack(frame_crc(f)) for f in frames] \
            if WIRE_CHECKSUM else None
        frames = _chaos_bitflip(frames)
        if trailers is not None:
            frames = [list(f) + [t] for f, t in zip(frames, trailers)]
    lengths = [len(meta_blob)] + [sum(len(p) for p in f) for f in frames]
    header = _HEAD.pack(MAGIC, len(lengths)) + b"".join(_U64.pack(n) for n in lengths)
    total = len(header) + sum(lengths)
    try:
        if total <= WIRE_COALESCE_MAX:
            buf = bytearray(header)
            buf += meta_blob
            for f in frames:
                for part in f:
                    buf += part
            sock.sendall(buf)
            return
        sock.sendall(header + meta_blob)
        for f in frames:
            for part in f:
                sock.sendall(part)
    except (ConnectionResetError, BrokenPipeError, OSError) as err:
        raise ConnectionClosed(str(err) or "send failed", mid_message=True) from err


def recv_msg(sock) -> Tuple[dict, List[memoryview]]:
    """Receive one message: ``(metadata, [frame, ...])``.  Frames come back
    as memoryviews over freshly-owned buffers (safe to keep)."""
    head = recv_exactly(sock, _HEAD.size, mid_message=False)
    magic, n_frames = _HEAD.unpack(head)
    if magic != MAGIC:
        raise ConnectionClosed(f"bad magic {bytes(magic)!r} on wire", mid_message=True)
    lens_buf = recv_exactly(sock, 8 * n_frames)
    lengths = struct.unpack(f"<{n_frames}Q", lens_buf)
    meta = pickle.loads(recv_exactly(sock, lengths[0]))
    frames = [recv_exactly(sock, n) for n in lengths[1:]]
    if WIRE_CHECKSUM:
        frames = [verify_frame(f) for f in frames]
    return meta, frames


def verify_frame(frame: memoryview) -> memoryview:
    """Strip and verify a frame's CRC32 trailer (checksummed wire)."""
    if len(frame) < _CRC.size:
        raise ChecksumError("frame shorter than its CRC32 trailer")
    payload, trailer = frame[:-_CRC.size], frame[-_CRC.size:]
    if frame_crc((payload,)) != _CRC.unpack(trailer)[0]:
        raise ChecksumError()
    return payload


# ------------------------------------------------------------ ndarray frames
def array_frame(arr: np.ndarray) -> List:
    """An ndarray as raw-codec frame parts: ``[packed header, buffer]``.
    Copy-on-encode for non-contiguous inputs (sliced/Fortran/0-d views);
    contiguous arrays ship their own buffer."""
    arr = as_c_contiguous(arr)
    return [_pack_header(arr), memoryview(arr).cast("B")]


def frame_to_array(frame) -> np.ndarray:
    """Zero-copy reconstruction (the RMVL deserialize-side property).
    Accepts a received contiguous buffer, or an unsent part-list straight
    from :func:`array_frame` (loopback/testing)."""
    if isinstance(frame, (list, tuple)):
        frame = memoryview(b"".join(bytes(p) for p in frame))
    dtype, shape, off = _unpack_header(frame)
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    arr = np.frombuffer(frame, dtype=dtype, offset=off, count=count).reshape(shape)
    arr.flags.writeable = False
    return arr


# ------------------------------------------------------------- tensor frames
TENSOR_MAGIC = b"RJT1"
_TAG_LEN = struct.Struct("<B")
# what rides a tensor frame: a tensor, or the host bytes of a card tensor
TENSOR_LEAVES = (torch.Tensor, CardResult)
# every value that rides a frame of its own
WIRE_LEAVES = (np.ndarray,) + TENSOR_LEAVES


def _tensor_name(dtype: torch.dtype) -> str:
    name = str(dtype).split(".")[1]
    if name not in _TORCH_DTYPES:
        raise TypeError(f"a {dtype} tensor cannot cross the wire (no tensor frame "
                        f"for it): {sorted(_TORCH_DTYPES)}")
    return name


def tensor_nbytes(value) -> int:
    """The host bytes of a tensor or :class:`CardResult`."""
    if isinstance(value, CardResult):
        return value.nbytes
    return value.numel() * value.element_size()


def tensor_frame(value) -> List:
    """A tensor (or a :class:`CardResult`) as frame parts: ``[tag, packed
    header, host bytes]``.  A card tensor is copied to the host once; a
    CPU tensor or a ``CardResult`` ships its own buffer."""
    if isinstance(value, CardResult):
        host, device = value.host, value.device
    else:
        host, device = value, value.device.type
    name = _tensor_name(host.dtype)
    src = _host_tensor(host)
    if src.device.type != "cpu":
        src = src.cpu()
    tag = f"{name}|{device}".encode("ascii")
    pad = -(len(TENSOR_MAGIC) + _TAG_LEN.size + len(tag)) % 8
    head = TENSOR_MAGIC + _TAG_LEN.pack(len(tag) + pad) + tag + b"\0" * pad
    arr = src.numpy()
    return [head, _pack_header(_header_proxy(src)),
            memoryview(arr.reshape(-1)).cast("B")]


def frame_to_value(frame) -> Any:
    """Decode one array or tensor frame: an ndarray (zero-copy, as
    :func:`frame_to_array`), a CPU tensor over the frame's buffer, or a
    :class:`CardResult` over it for a tensor that lived on a card."""
    if isinstance(frame, (list, tuple)):
        frame = memoryview(bytearray(b"".join(bytes(p) for p in frame)))
    if bytes(frame[:4]) != TENSOR_MAGIC:
        return frame_to_array(frame)
    (tl,) = _TAG_LEN.unpack_from(frame, 4)
    off = len(TENSOR_MAGIC) + _TAG_LEN.size
    name, _, device = bytes(frame[off:off + tl]).rstrip(b"\0").decode("ascii").partition("|")
    body = frame[off + tl:]
    dtype, shape, hoff = _unpack_header(body)
    want = _TORCH_DTYPES[name]
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if count == 0:
        host = torch.empty(shape, dtype=want)
    else:
        # through NumPy: the array holds the frame buffer's export
        host = torch.from_numpy(np.frombuffer(body, dtype=dtype, offset=hoff,
                                              count=count).reshape(shape))
        if host.dtype is not want:
            host = host.view(want)
    return host if device == "cpu" else CardResult(host, device)


def frame_eligible(arr, min_bytes: int = 0) -> bool:
    if isinstance(arr, TENSOR_LEAVES):
        return tensor_nbytes(arr) >= min_bytes
    if arr.dtype.hasobject or arr.nbytes < min_bytes:
        return False
    try:
        _pack_header(arr)
        return True
    except TypeError:  # dtype outside the raw-codec table
        return False


def value_frame(value) -> List:
    """The frame parts of one array or tensor leaf."""
    if isinstance(value, TENSOR_LEAVES):
        return tensor_frame(value)
    return array_frame(value)


def _sum_array_bytes(value: Any, pred: Callable[[Any], bool]) -> int:
    """Sum the bytes of the arrays and tensors inside a datum value that
    satisfy ``pred`` — the one structure walker behind both byte ledgers
    below (a container type added here is counted consistently
    everywhere)."""
    total = 0
    stack = [value]
    while stack:
        o = stack.pop()
        if isinstance(o, TENSOR_LEAVES):
            if pred(o):
                total += tensor_nbytes(o)
        elif isinstance(o, np.ndarray):
            if pred(o):
                total += int(o.nbytes)
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
    return total


def datum_frame_bytes(value: Any) -> int:
    """Total frame-eligible array and tensor bytes inside one datum value
    — the size that decides inline-vs-node-resident result encoding."""
    return _sum_array_bytes(value, frame_eligible)


# -------------------------------------------------------- structure markers
class Frame:
    """Placeholder: the value is array or tensor frame ``i`` of this
    message."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __getstate__(self):
        return self.i

    def __setstate__(self, state):
        self.i = state


class Ref:
    """Placeholder: the value is plane-resident under ``key`` on the
    receiving node (the reuse-many half)."""

    __slots__ = ("key",)

    def __init__(self, key: Tuple[int, int]):
        self.key = key

    def __getstate__(self):
        return self.key

    def __setstate__(self, state):
        self.key = state


class Put:
    """Placeholder: cache ``value`` under ``key`` on the receiving node,
    then use it (``value`` may itself be a ``Frame``)."""

    __slots__ = ("key", "value")

    def __init__(self, key: Tuple[int, int], value: Any):
        self.key = key
        self.value = value

    def __getstate__(self):
        return (self.key, self.value)

    def __setstate__(self, state):
        self.key, self.value = state


class Fetch:
    """Placeholder: the value lives on peer ``node`` (reachable at
    ``addr``, a ``host:port`` data-plane address) under ``key`` — or still
    under result ``token`` if the producer has not yet processed its
    ``alias``.  The receiver pulls it peer-to-peer (DESIGN.md §15)."""

    __slots__ = ("key", "token", "node", "addr", "nbytes")

    def __init__(self, key: Tuple[int, int], token: Optional[int],
                 node: int, addr: str, nbytes: int):
        self.key = key
        self.token = token
        self.node = node
        self.addr = addr
        self.nbytes = nbytes

    def __getstate__(self):
        return (self.key, self.token, self.node, self.addr, self.nbytes)

    def __setstate__(self, state):
        self.key, self.token, self.node, self.addr, self.nbytes = state


class RemoteRef:
    """Result-side descriptor: the datum stays resident on the producing
    node under result ``token``; only (token, nbytes) cross the
    scheduler's link."""

    __slots__ = ("token", "nbytes")

    def __init__(self, token: int, nbytes: int):
        self.token = token
        self.nbytes = nbytes

    def __getstate__(self):
        return (self.token, self.nbytes)

    def __setstate__(self, state):
        self.token, self.nbytes = state


_MARKERS = (Frame, Ref, Put, Fetch, RemoteRef)


def struct_nbytes(value: Any) -> int:
    """Sum of array and tensor bytes inside a datum value (ledger
    accounting)."""
    return _sum_array_bytes(value, lambda _arr: True)


def pack_payload(
    obj: Any,
    input_keys: Optional[Dict[int, Tuple[int, int]]] = None,
    resident: Optional[set] = None,
    peer_sources: Optional[Dict[Tuple[int, int], Tuple[int, str, int]]] = None,
) -> Tuple[Any, List, Dict[str, Any]]:
    """Encode a nested structure for the wire.

    Keying is at the *datum* level (``id(value)`` in ``input_keys`` —
    ndarray, tensor, tuple, list or dict values straight from the object
    store):
    a keyed datum becomes ``Ref`` when ``key`` is in ``resident`` (the
    receiver already holds it), ``Fetch`` when the datum is a
    :class:`~repro_torch.core.futures.RemoteValue` resident on a peer node
    (the receiver pulls it peer-to-peer, DESIGN.md §15), and ``Put``
    otherwise — the ``Put`` payload is the datum's structure with its
    raw-eligible ndarrays and every tensor as out-of-band frames.
    Unkeyed large arrays and every unkeyed tensor ride anonymous frames;
    everything else stays inline for frame 0's pickle.  Returns ``(structure, frames, info)`` where ``info`` reports
    the ``Put`` keys/bytes, the ``Fetch`` keys/bytes (the peer data-plane
    ledger) and the ``Ref`` count (dedup wins).

    ``peer_sources`` maps keys of *scheduler-resident* datums that some
    agent already holds to ``(node, addr, nbytes)``: instead of shipping
    a second ``Put`` of the same bytes over the scheduler link, the
    receiver is directed to pull them from that agent by key
    (a ``Fetch`` with no token — the broadcast-residue fix, DESIGN.md
    §16).
    """
    from ..core.futures import RemoteValue
    input_keys = input_keys or {}
    resident = resident if resident is not None else set()
    peer_sources = peer_sources or {}
    frames: List = []
    info = {"put_keys": [], "put_bytes": 0, "put_sizes": {}, "refs": 0,
            "fetch_keys": [], "fetch_bytes": 0}
    put_in_msg: set = set()   # intra-message dedup: same datum twice = one Put

    def frame_of(arr) -> Frame:
        frames.append(value_frame(arr))
        return Frame(len(frames) - 1)

    def enc_value(o: Any) -> Any:
        """A keyed datum's payload: inner arrays and tensors ride frames,
        no keying (store values never nest other datums)."""
        if isinstance(o, TENSOR_LEAVES):
            return frame_of(o)
        if isinstance(o, np.ndarray):
            if frame_eligible(o) and o.nbytes >= WIRE_MIN_FRAME_BYTES:
                return frame_of(o)
            return o
        if isinstance(o, (list, tuple)):
            mapped = [enc_value(x) for x in o]
            if isinstance(o, tuple):
                return type(o)(*mapped) if hasattr(o, "_fields") else tuple(mapped)
            return mapped
        if isinstance(o, dict):
            return {k: enc_value(v) for k, v in o.items()}
        return o

    def walk(o: Any) -> Any:
        if isinstance(o, RemoteValue):
            key = input_keys.get(id(o))
            if key is None:
                key = o.key
            if key is None:
                raise TypeError(
                    f"{o!r} outside the object store cannot cross the wire")
            if key in resident or key in put_in_msg:
                info["refs"] += 1
                return Ref(key)
            put_in_msg.add(key)
            info["fetch_keys"].append(key)
            info["fetch_bytes"] += int(o.nbytes)
            return Fetch(key, o.token, o.node, o.addr, int(o.nbytes))
        if isinstance(o, (np.ndarray, list, tuple, dict) + TENSOR_LEAVES):
            key = input_keys.get(id(o))
            if key is not None:
                if key in resident or key in put_in_msg:
                    info["refs"] += 1
                    return Ref(key)
                src = peer_sources.get(key)
                if src is not None:
                    node, addr, nbytes = src
                    put_in_msg.add(key)
                    info["fetch_keys"].append(key)
                    info["fetch_bytes"] += int(nbytes)
                    return Fetch(key, None, node, addr, int(nbytes))
                put_in_msg.add(key)
                nb = struct_nbytes(o)
                info["put_keys"].append(key)
                info["put_bytes"] += nb
                info["put_sizes"][key] = nb
                return Put(key, enc_value(o))
            if isinstance(o, TENSOR_LEAVES):
                return frame_of(o)
            if isinstance(o, np.ndarray):
                if frame_eligible(o) and o.nbytes >= WIRE_MIN_FRAME_BYTES:
                    return frame_of(o)
                return o
            if isinstance(o, (list, tuple)):
                mapped = [walk(x) for x in o]
                if isinstance(o, tuple):
                    return type(o)(*mapped) if hasattr(o, "_fields") \
                        else tuple(mapped)
                return mapped
            return {k: walk(v) for k, v in o.items()}
        return o

    return walk(obj), frames, info


def unpack_payload(
    structure: Any,
    frames: Sequence[memoryview],
    lookup: Optional[Callable[[Tuple[int, int]], Any]] = None,
    store: Optional[Callable[[Tuple[int, int], Any], None]] = None,
) -> Any:
    """Decode a ``pack_payload`` structure.  ``lookup(key)`` resolves
    ``Ref`` markers from the local plane; ``store(key, value)`` caches
    ``Put`` payloads into it."""

    def walk(o: Any) -> Any:
        if isinstance(o, Frame):
            return frame_to_value(frames[o.i])
        if isinstance(o, (Ref, Fetch)):
            # a Fetch was resolved (or registered as pending) when the
            # reader pre-stored this message; by now the plane either has
            # the value or blocks the lookup until the peer pull lands
            if lookup is None:
                raise ValueError(f"{type(o).__name__} marker but no plane "
                                 "lookup provided")
            return lookup(o.key)
        if isinstance(o, Put):
            if lookup is not None:
                # already cached (e.g. the receiver pre-stored Puts on its
                # reader thread): reuse THAT object so identity-keyed
                # downstream dedup sees one value per datum.  Missing may
                # surface as KeyError or None (dict.get-style lookups);
                # cached Put values are never None.
                try:
                    cached = lookup(o.key)
                except KeyError:
                    cached = None
                if cached is not None:
                    return cached
            v = walk(o.value)
            if store is not None:
                store(o.key, v)
            return v
        if isinstance(o, (list, tuple)):
            mapped = [walk(x) for x in o]
            if isinstance(o, tuple):
                return type(o)(*mapped) if hasattr(o, "_fields") else tuple(mapped)
            return mapped
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items()}
        return o

    return walk(structure)
