"""The port's cluster wire against the JAX package's.

``repro.cluster.protocol``, ``repro.cluster.chaos`` and ``repro.core.fault``
load no JAX, so this file imports them beside their copies in
``repro_torch``: for NumPy arrays from a seed, the port's frames and whole
messages are byte-identical to the reference's and each side decodes the
other's; tensors of every dtype the port moves cross the port's wire as
tensor frames (host bytes, their dtype and device) and are never pickled;
chaos specs parse to the same injector and draw the same decisions; and
the failure detector reaches the same verdicts on the same beat sequences.
No cluster is started here.
"""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cluster import chaos as jchaos  # noqa: E402
from repro.cluster import protocol as jprotocol  # noqa: E402
from repro.core import fault as jfault  # noqa: E402
from repro_torch.cluster import chaos, protocol  # noqa: E402
from repro_torch.core import executors, fault  # noqa: E402


class ByteSocket:
    """A socket that records what is sent and serves it back on reads."""

    def __init__(self, data: bytes = b""):
        self.out = io.BytesIO()
        self.data = bytearray(data)

    def sendall(self, data) -> None:
        self.out.write(bytes(data))

    def recv_into(self, view) -> int:
        n = min(len(view), len(self.data))
        view[:n] = self.data[:n]
        del self.data[:n]
        return n


def _arrays(seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((37, 29))
    return [base, base.astype(np.float32), (base * 1e3).astype(np.int64),
            (base * 100).astype(np.int32), base > 0, base.astype(np.float16),
            (base * 50).astype(np.uint8), base[::3, 1::2],   # non-contiguous
            np.asarray(base[0, 0]), np.asfortranarray(base)]  # 0-d, Fortran


def _wire(mod, meta, arrays):
    sock = ByteSocket()
    mod.send_msg(sock, meta, [mod.array_frame(a) for a in arrays])
    return sock.out.getvalue()


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_frames_and_messages_are_byte_identical(monkeypatch, seed, checksum):
    monkeypatch.setattr(protocol, "WIRE_CHECKSUM", checksum)
    monkeypatch.setattr(jprotocol, "WIRE_CHECKSUM", checksum)
    arrays = _arrays(seed)
    for a in arrays:
        assert b"".join(bytes(p) for p in protocol.array_frame(a)) == \
            b"".join(bytes(p) for p in jprotocol.array_frame(a))
    meta = {"op": "task", "mid": seed, "slot": 1, "token": 7, "n_out": 2}
    ours, theirs = _wire(protocol, meta, arrays), _wire(jprotocol, meta, arrays)
    assert ours == theirs
    # each side's message decodes on the other
    for reader, blob in ((jprotocol, ours), (protocol, theirs)):
        got_meta, frames = reader.recv_msg(ByteSocket(blob))
        assert got_meta == meta
        for a, f in zip(arrays, frames):
            got = reader.frame_to_array(f)
            assert got.dtype == a.dtype and got.shape == a.shape
            assert got.tobytes() == np.ascontiguousarray(a).tobytes()
    # and the port's general decoder reads the reference's array frames
    _, frames = protocol.recv_msg(ByteSocket(theirs))
    assert all(protocol.frame_to_value(f).tobytes() == np.ascontiguousarray(a).tobytes()
               for a, f in zip(arrays, frames))


def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    base = torch.randn(33, 17, generator=g) * 100
    out = [base, base.double(), base.to(torch.bfloat16), base.to(torch.int32),
           base.to(torch.int64), base > 0, base.t(), torch.empty(0, 5),
           torch.tensor(3.5), base.to(torch.bfloat16)[:1, :3]]
    return out


def _tbytes(t):
    return t.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_tensors_cross_as_tensor_frames_with_dtype_and_device(seed):
    tensors = _tensors(seed)
    sock = ByteSocket()
    protocol.send_msg(sock, {"op": "data"}, [protocol.tensor_frame(t) for t in tensors])
    _, frames = protocol.recv_msg(ByteSocket(sock.out.getvalue()))
    for t, f in zip(tensors, frames):
        assert bytes(f[:4]) == protocol.TENSOR_MAGIC
        got = protocol.frame_to_value(f)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == t.dtype and got.shape == t.shape
        assert _tbytes(got) == _tbytes(t)
    # the reference reads the message (frames are opaque bytes) but its
    # array decoder refuses a tensor frame rather than misreading it
    _, jframes = jprotocol.recv_msg(ByteSocket(sock.out.getvalue()))
    with pytest.raises(ValueError, match="magic"):
        jprotocol.frame_to_array(jframes[0])


def test_a_card_tensor_crosses_as_host_bytes_and_is_rebuilt_where_read():
    """A card result crosses as host bytes and decodes to a
    ``CardResult`` (the ``meta`` device stands in for the card on the
    CPU): nothing is uploaded until it is materialized, where it lands on
    the device it lived on, once."""
    x = torch.arange(4096, dtype=torch.float32).to(torch.bfloat16)
    card = executors.CardResult(x, "meta")
    got = protocol.frame_to_value(protocol.tensor_frame(card))
    assert isinstance(got, executors.CardResult) and got.device == "meta"
    assert got.host.device.type == "cpu" and torch.equal(got.host, x)
    assert got.nbytes == x.numel() * 2 == protocol.struct_nbytes({"a": [got]})
    up = got.materialize()
    assert up.device.type == "meta" and up.dtype == torch.bfloat16 and got.materialize() is up


def _leaves(obj):
    """Tensors and card results anywhere in a packed structure."""
    if isinstance(obj, protocol.TENSOR_LEAVES):
        return [obj]
    if isinstance(obj, protocol.Put):
        return _leaves(obj.value)
    if isinstance(obj, (list, tuple)):
        return [x for o in obj for x in _leaves(o)]
    if isinstance(obj, dict):
        return [x for o in obj.values() for x in _leaves(o)]
    return []


def test_tensors_are_framed_at_every_size_never_pickled():
    key = (5, 1)
    small = torch.ones(3, dtype=torch.bfloat16)
    keyed = (torch.arange(4096.0), torch.zeros(2, dtype=torch.int64))
    card = executors.CardResult(torch.ones(2), "meta")
    structure, frames, info = protocol.pack_payload(
        ((keyed, small, card, np.ones(2)), {}), {id(keyed): key}, set())
    assert not _leaves(structure), "a tensor rode the pickled structure"
    assert info["put_keys"] == [key] and info["put_bytes"] == 4096 * 4 + 16
    assert len(frames) == 4   # two keyed leaves, the small tensor, the card result
    plane = {}
    args, _ = protocol.unpack_payload(structure, frames, lookup=plane.get,
                                      store=plane.__setitem__)
    (got_keyed, got_small, got_card, arr) = args
    assert torch.equal(got_keyed[0], keyed[0]) and torch.equal(got_keyed[1], keyed[1])
    assert got_small.dtype == torch.bfloat16 and torch.equal(got_small, small)
    assert isinstance(got_card, executors.CardResult) and got_card.device == "meta"
    assert plane[key] is got_keyed
    # the datum is resident now: the next message references it
    structure, frames, info = protocol.pack_payload(((keyed,), {}), {id(keyed): key}, {key})
    assert frames == [] and info["refs"] == 1


def test_a_tensor_without_a_frame_dtype_is_refused():
    with pytest.raises(TypeError, match="cannot cross the wire"):
        protocol.tensor_frame(torch.zeros(2, dtype=torch.complex64))


@pytest.mark.parametrize("spec", ["1234:delay=0.02@0.3,hang=5@0.1,fetch-slow=0.2",
                                  "7:drop@0.5,stall=0.01,freeze@0.2",
                                  "99:partition=0.3@0.4,bitflip@1.0"])
def test_chaos_specs_parse_and_draw_as_the_reference(spec):
    ours, theirs = chaos.ChaosInjector.parse(spec), jchaos.ChaosInjector.parse(spec)
    assert ours.seed == theirs.seed and ours.faults == theirs.faults
    for fault_name in ours.faults:
        for scope in ("agent0-hb", "wire", "peer-127.0.0.1:9"):
            assert [ours.roll(fault_name, scope) for _ in range(50)] == \
                [theirs.roll(fault_name, scope) for _ in range(50)]


@pytest.mark.parametrize("bad", ["nope", "1:", "1:warp=2", "1:delay@2.0", "x:delay"])
def test_bad_chaos_specs_are_refused_as_the_reference(bad):
    with pytest.raises(jchaos.ChaosSpecError):
        jchaos.ChaosInjector.parse(bad)
    with pytest.raises(chaos.ChaosSpecError):
        chaos.ChaosInjector.parse(bad)


def _verdicts(mod, beats, cfg_kw, heartbeat_s, probes):
    now = [0.0]
    det = mod.FailureDetector(mod.LivenessConfig(**cfg_kw), heartbeat_s,
                              clock=lambda: now[0])
    det.note_install(0)
    det.note_install(1)
    out = []
    events = sorted([(t, "beat", n) for t, n in beats] + [(t, "probe", None) for t in probes])
    for t, kind, node in events:
        now[0] = t
        if kind == "beat":
            det.note_beat(node)
        else:
            out.append((det.assess(0), det.assess(1)))
    return out, det.snapshot()


@pytest.mark.parametrize("cfg_kw,heartbeat_s", [({}, 1.0), ({"suspicion_s": 0.6}, 0.2),
                                                ({"suspicion_s": 2.0, "dead_factor": 3.0}, 0.5),
                                                ({"enabled": False}, 0.2)])
def test_failure_detector_verdicts_equal_the_reference(cfg_kw, heartbeat_s):
    rng = np.random.default_rng(3)
    # node 0 beats steadily; node 1 beats, then falls silent at t = 4
    beats = [(float(t), 0) for t in np.arange(0.1, 30, heartbeat_s)]
    beats += [(float(t), 1) for t in np.arange(0.1, 4, heartbeat_s)]
    probes = sorted(float(p) for p in rng.uniform(0, 30, 60))
    ours = _verdicts(fault, beats, cfg_kw, heartbeat_s, probes)
    theirs = _verdicts(jfault, beats, cfg_kw, heartbeat_s, probes)
    assert ours == theirs
    states = {v[1] for v in ours[0]}
    if cfg_kw.get("enabled", True):
        assert fault.DEAD in states and {v[0] for v in ours[0]} == {fault.ALIVE}


def test_a_small_card_result_unpickles_as_host_bytes():
    """A worker's card tensor below the segment threshold crosses its pipe
    as host bytes and unpickles as a ``CardResult``, never as a device
    tensor: a node agent reading the reply makes no CUDA context.  Pickled
    on to a worker, a ``CardResult`` is rebuilt on its device there."""
    import pickle
    x = torch.arange(12, dtype=torch.float32).to(torch.bfloat16)
    got = pickle.loads(pickle.dumps(executors._CardBytes(x, "meta")))
    assert type(got) is executors.CardResult and got.device == "meta"
    assert got.host.device.type == "cpu" and torch.equal(got.host, x)
    assert not executors._shm_eligible(got)   # small: pickled, not planed
    rebuilt = pickle.loads(pickle.dumps(got))
    assert rebuilt.device.type == "meta" and rebuilt.dtype == torch.bfloat16
