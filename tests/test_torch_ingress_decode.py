"""The port's columnar-door decode against the JAX package's: frame split
on both tiers at every cut offset and on poisoned buffers, the payload
table parse, and the per-frame reference decoder's round trip, rejects
and messages — each identical to the JAX function's on the same bytes.
Then the accumulate-then-drain door over a CPU engine: a stream
dribbled at every byte offset acks like the clean run, a CRC-poisoned
frame keeps the good prefix, an oversized frame faults the connection,
and the decode tiers are what was asked for (a failed native build
raises; nothing falls back). Tolerance: exact."""

import struct

import numpy as np
import pytest

from fluidframework_tpu.server import columnar_ingress as jci
from fluidframework_tpu_torch.server import columnar_ingress as tci
from fluidframework_tpu_torch.server import native_ingress
from fluidframework_tpu_torch.server.columnar_ingress import (
    ColumnarAlfred, ColumnarClient, SCAN_BAD_CRC, SCAN_TOO_LARGE,
    encode_json, encode_op_batch, reference_decode_op_frame, split_frames,
)
from fluidframework_tpu_torch.server.serving import StringServingEngine
from fluidframework_tpu_torch.testing.door_storm import records

TIERS = [False, True]
TIER_IDS = ["numpy", "native"]
TIMEOUT = 30.0


def _ops(rows, kinds, a0s, a1s, tidxs, cseqs, refs):
    return records(rows, kinds, a0s, a1s, tidxs, cseqs, refs)


def _stream():
    """Control, plain batch, rich batch, a zero-op frame, and a second
    control frame."""
    frames = [
        encode_json({"t": "join", "docs": ["d0", "d1"]}),
        encode_op_batch(["hello ", "world"],
                        _ops([0, 1, 0], [0, 0, 1], [0, 0, 2], [0, 0, 4],
                             [0, 1, 0], [1, 1, 2], [0, 0, 0])),
        encode_op_batch(["x"],
                        _ops([1, 0], [2, 0], [0, 6], [3, 6], [0, 0],
                             [2, 3], [0, 0]),
                        props=[{"bold": True}]),
        encode_op_batch([], _ops([], [], [], [], [], [], [])),
        encode_json({"t": "bye"}),
    ]
    return frames, b"".join(frames)


def test_encoders_match_jax():
    frames, _ = _stream()
    rec = _ops([0, 1], [0, 2], [0, 1], [0, 3], [0, 0], [1, 2], [0, 5])
    assert encode_op_batch(["a", "β"], rec, props=[{"k": [1]}]) == \
        jci.encode_op_batch(["a", "β"], rec, props=[{"k": [1]}])
    assert encode_op_batch(["a"], rec) == jci.encode_op_batch(["a"], rec)
    assert encode_json({"t": "bye"}) == jci.encode_json({"t": "bye"})
    assert tci._OP_DTYPE == jci._OP_DTYPE


# ------------------------------------------------------- splitter fuzz

@pytest.mark.parametrize("native", TIERS, ids=TIER_IDS)
def test_split_frames_every_cut_offset(native):
    """Feed the stream cut at EVERY byte offset (two drain calls): the
    union of both calls' frames equals the whole-buffer split, the torn
    tail never yields a frame, and every call equals the JAX
    splitter's."""
    frames, blob = _stream()
    whole, consumed, status = split_frames(blob, native=native)
    assert status == 0 and consumed == len(blob)
    assert len(whole) == len(frames)
    assert (whole, consumed, status) == jci.split_frames(blob, native=False)
    for cut in range(len(blob) + 1):
        a, ca, sa = split_frames(blob[:cut], native=native)
        assert (a, ca, sa) == jci.split_frames(blob[:cut], native=False)
        assert sa == 0
        assert a == whole[:len(a)]
        rest = blob[ca:cut] + blob[cut:]
        b, cb, sb = split_frames(rest, native=native)
        assert (b, cb, sb) == jci.split_frames(rest, native=False)
        assert sb == 0 and ca + cb == len(blob)
        shifted = [(t, off + ca, ln) for t, off, ln in b]
        assert a + shifted == whole


@pytest.mark.parametrize("native", TIERS, ids=TIER_IDS)
def test_split_frames_poisoned(native):
    frames, blob = _stream()
    # corrupt one payload byte of frame 2: frames 0-1 come back, the scan
    # stops AT the bad frame and leaves it out of `consumed`
    bad = bytearray(blob)
    f2_off = len(frames[0]) + len(frames[1])
    bad[f2_off + 5] ^= 0xFF
    got, consumed, status = split_frames(bytes(bad), native=native)
    assert status == SCAN_BAD_CRC
    assert len(got) == 2 and consumed == f2_off
    assert (got, consumed, status) == \
        jci.split_frames(bytes(bad), native=False)
    # oversized length field: SCAN_TOO_LARGE, same prefix rule
    big = blob[:f2_off] + struct.pack("<BI", ord("B"), 1 << 30)
    got, consumed, status = split_frames(big, native=native)
    assert status == SCAN_TOO_LARGE
    assert len(got) == 2 and consumed == f2_off
    assert (got, consumed, status) == jci.split_frames(big, native=False)


def test_split_frames_tiers_agree():
    _, blob = _stream()
    cases = [blob, blob[:17], blob[:5], b"", b"\x00" * 8]
    bad = bytearray(blob)
    bad[9] ^= 1
    cases.append(bytes(bad))
    for buf in cases:
        assert split_frames(buf, native=False) == \
            split_frames(buf, native=True) == \
            jci.split_frames(buf, native=False)


def test_native_gather_equals_record_view():
    """The native record gather equals a numpy view of the same records,
    run by run, on seeded records at seeded offsets."""
    rng = np.random.default_rng(17)
    recs = np.zeros(300, tci._OP_DTYPE)
    for name in recs.dtype.names:
        info = np.iinfo(recs.dtype[name])
        recs[name] = rng.integers(0, min(info.max, 1 << 31), 300)
    blob = bytearray(rng.integers(0, 256, 7, dtype=np.uint8).tobytes())
    runs = []
    for lo, hi in ((0, 100), (100, 101), (101, 300)):
        runs.append((len(blob), hi - lo))
        blob += recs[lo:hi].tobytes() + b"\x55" * 3
    got = native_ingress.gather(bytes(blob), runs)
    for name in native_ingress.PLANES:
        assert got[name].dtype == np.int32
        assert np.array_equal(got[name], recs[name].astype(np.int32)), name


# --------------------------------------------------- per-frame oracle

@pytest.mark.parametrize("rich", [False, True])
def test_parse_op_tables_matches_jax(rich):
    texts = ["alpha", "β-utf8 ✓", ""]
    props = [{"color": "red"}, {"nested": {"a": [1, 2]}}] if rich else None
    frame = encode_op_batch(texts, _ops([3, 7], [0, 1], [1, 2], [0, 9],
                                        [1, 2], [10, 11], [5, 6]),
                            props=props)
    payload = frame[5:-4]
    got = tci.parse_op_tables(payload, rich)
    assert got == jci.parse_op_tables(payload, rich)
    assert got == (texts, props or [], len(payload) - 32)
    assert tci.parse_op_tables(memoryview(payload), rich) == got


def test_reference_decoder_round_trip():
    texts = ["alpha", "β-utf8 ✓", ""]
    props = [{"color": "red"}, {"nested": {"a": [1, 2]}}]
    ops = _ops([3, 7], [0, 2], [1, 2], [0, 9], [1, 1], [10, 11], [5, 6])
    frame = encode_op_batch(texts, ops, props=props)
    payload = frame[5:-4]
    t, p, got = reference_decode_op_frame(payload, rich=True)
    jt, jp, jgot = jci.reference_decode_op_frame(payload, rich=True)
    assert t == texts == jt and p == props == jp
    assert got.tobytes() == ops.tobytes() == jgot.tobytes()


def _raised(fn, *args):
    try:
        fn(*args)
    except (ValueError, IndexError, struct.error) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("mutate,msg", [
    (lambda pl: pl[:len(pl) - 7], "record section"),
    (lambda pl: pl[:2], None),          # truncated table → struct/IndexError
    (lambda pl: b"\x05" + pl[1:], None),  # table overruns payload
])
def test_reference_decoder_rejects(mutate, msg):
    ops = _ops([0], [0], [0], [0], [0], [1], [0])
    frame = encode_op_batch(["t"], ops)
    payload = mutate(frame[5:-4])
    got = _raised(reference_decode_op_frame, payload, False)
    assert got is not None
    assert got == _raised(jci.reference_decode_op_frame, payload, False)
    if msg:
        assert msg in got[1]


@pytest.mark.parametrize("rich", [False, True])
def test_reference_decoder_validation_messages(rich):
    props = [{"k": 1}] if rich else None
    # tidx beyond the table
    frame = encode_op_batch(["only"], _ops([0], [0], [0], [0], [7], [1],
                                           [0]), props=props)
    got = _raised(reference_decode_op_frame, frame[5:-4], rich)
    assert got == _raised(jci.reference_decode_op_frame, frame[5:-4], rich)
    assert got[0] is ValueError and "text-table range" in got[1]
    # kind beyond what the frame type carries
    frame = encode_op_batch(["t"], _ops([0], [3 if rich else 2], [0], [0],
                                        [0], [1], [0]), props=props)
    got = _raised(reference_decode_op_frame, frame[5:-4], rich)
    assert got == _raised(jci.reference_decode_op_frame, frame[5:-4], rich)
    assert got[0] is ValueError and "op kind out of range" in got[1]


# ------------------------------------------------- end-to-end dribble

def _mk(decode="native", window_ms=1.0):
    eng = StringServingEngine(n_docs=8, capacity=256, batch_window=10 ** 9,
                              sequencer="native", device="cpu")
    srv = ColumnarAlfred(eng, window_min_rows=4, window_ms=window_ms,
                         decode=decode).start_in_thread()
    return eng, srv


def _drive(srv, blob, n_acks, cuts, client_id=None, bases=None):
    """Send ``blob`` sliced at ``cuts`` with a pause between slices (so
    drain passes land mid-stream), then collect ``n_acks`` acks. Returns
    the cut-invariant ack pattern ``(row, cseq - bases[row], acked?)``,
    after checking each row's seqs follow its cseqs (per-doc FIFO)."""
    import time
    from collections import defaultdict
    cl = ColumnarClient("127.0.0.1", srv.port, timeout=TIMEOUT)
    cl.join(["d0", "d1"], client_id=client_id)
    pos = 0
    for cut in [*cuts, len(blob)]:
        if cut > pos:
            cl.sock.sendall(blob[pos:cut])
            pos = cut
            time.sleep(0.004)
    got = []
    while len(got) < n_acks:
        resp = cl.recv_json()
        assert resp["t"] == "acks", resp
        for (cseq, seq), row in zip(resp["acks"], resp["rows"]):
            got.append((row, cseq, seq))
    cl.close()
    per_row = defaultdict(list)
    for r, c, s in got:
        if s > 0:
            per_row[r].append((c, s))
    for r, pairs in per_row.items():
        pairs.sort()
        seqs = [s for _, s in pairs]
        assert seqs == sorted(seqs), f"row {r} acked out of FIFO: {pairs}"
    bases = bases or {}
    return sorted((r, c - bases.get(r, 0), s > 0) for r, c, s in got)


@pytest.mark.parametrize("decode", ["numpy", "native"])
def test_dribbled_stream_acks_match_clean_run(decode):
    """Cut the SAME op stream at every byte offset (one cut a run): the
    ack pattern, per-row FIFO and ingested-op count match the clean run.
    Each run resumes one client identity with cseqs continuing per row;
    the ops are net-zero (insert then remove)."""
    eng, srv = _mk(decode=decode)
    try:
        cid = 777

        def mkblob(run):
            b0, b1_ = 2 * run, 3 * run   # row 0 sends 2 ops a run, row 1: 3
            fb = encode_op_batch(
                ["aa", "bb"],
                _ops([0, 1], [0, 0], [0, 0], [0, 0], [0, 1],
                     [b0 + 1, b1_ + 1], [0, 0]))
            fr = encode_op_batch(
                [], _ops([1], [2], [0], [2], [0], [b1_ + 2], [0]),
                props=[{"mark": "x"}])
            f2 = encode_op_batch(
                [], _ops([0, 1], [1, 1], [0, 0], [2, 2], [0, 0],
                         [b0 + 2, b1_ + 3], [0, 0]))
            return fb + fr + f2, {0: b0, 1: b1_}

        n_acks = 5
        blob, bases = mkblob(0)
        before = srv.ops_ingested
        want = _drive(srv, blob, n_acks=n_acks, cuts=[], client_id=cid,
                      bases=bases)
        want_ops = srv.ops_ingested - before
        assert want_ops == n_acks
        for cut in range(1, len(blob)):
            blob, bases = mkblob(cut)
            before = srv.ops_ingested
            got = _drive(srv, blob, n_acks=n_acks, cuts=[cut],
                         client_id=cid, bases=bases)
            assert got == want, f"cut={cut}"
            assert srv.ops_ingested - before == want_ops, f"cut={cut}"
        assert srv.drain_stats()["tier"] == decode
        assert eng.read_text("d0") == eng.read_text("d1") == ""
    finally:
        srv.stop()


def test_mid_stream_corruption_keeps_prefix():
    """Good frames ahead of a CRC-poisoned one in the same drain still
    sequence; the client gets the diagnostic, its connection dies, and
    the server keeps serving."""
    eng, srv = _mk()
    try:
        good = encode_op_batch(["ok"],
                               _ops([0], [0], [0], [0], [0], [1], [0]))
        bad = bytearray(encode_op_batch(
            ["zz"], _ops([1], [0], [0], [0], [0], [2], [0])))
        bad[7] ^= 0x55
        cl = ColumnarClient("127.0.0.1", srv.port, timeout=TIMEOUT)
        cl.join(["d0", "d1"])
        cl.sock.sendall(good + bytes(bad))
        resp = cl.recv_json()
        assert resp["t"] == "error" and "crc" in resp["message"].lower()
        assert cl.sock.recv(1) == b""
        cl.sock.close()
        # a fresh client gets service; the poisoned client's good prefix
        # was windowed before it, so once its ack is back both are in
        cl2 = ColumnarClient("127.0.0.1", srv.port, timeout=TIMEOUT)
        cl2.join(["d0"])
        cl2.send_ops(["y"], _ops([0], [0], [0], [0], [0], [1], [0]))
        assert cl2.recv_json()["t"] == "acks"
        cl2.close()
        assert srv.ops_ingested == 2
        assert sorted(eng.read_text("d0")) == sorted("yok")
    finally:
        srv.stop()


def test_oversized_frame_faults_connection():
    eng, srv = _mk()
    try:
        cl = ColumnarClient("127.0.0.1", srv.port, timeout=TIMEOUT)
        cl.join(["d0"])
        cl.sock.sendall(struct.pack("<BI", ord("B"), 1 << 30))
        resp = cl.recv_json()
        assert resp["t"] == "error" and "too large" in resp["message"]
        assert cl.sock.recv(1) == b""
        cl.sock.close()
    finally:
        srv.stop()


def test_numpy_tier_end_to_end():
    """The numpy tier serves the whole socket path when asked for by
    name."""
    eng, srv = _mk(decode="numpy")
    try:
        assert srv.drain_stats()["tier"] == "numpy"
        cl = ColumnarClient("127.0.0.1", srv.port, timeout=TIMEOUT)
        cl.join(["d0"])
        cl.send_ops(["hi"], _ops([0], [0], [0], [0], [0], [1], [0]))
        assert cl.recv_json()["acks"][0][1] > 0
        st = srv.drain_stats()
        assert st["passes"] >= 1 and st["drained_bytes"] > 0
        cl.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("decode", [None, "native"],
                         ids=["default", "native"])
def test_native_decode_never_falls_back(decode, monkeypatch):
    """The default decode is the native tier. A failed build or load
    raises from the door's constructor and from ``split_frames``; only
    ``decode="numpy"`` reaches the numpy tier, and no other name (the
    reference's ``"auto"`` included) is taken."""
    eng = StringServingEngine(n_docs=2, capacity=64, sequencer="native",
                              device="cpu")
    kw = {} if decode is None else {"decode": decode}
    assert ColumnarAlfred(eng, **kw).drain_stats()["tier"] == "native"
    for name in ("fast", "auto"):
        with pytest.raises(ValueError, match="decode"):
            ColumnarAlfred(eng, decode=name)

    def broken(target):
        raise RuntimeError(f"g++ failed building {target}")

    monkeypatch.setattr(native_ingress, "_lib", None)
    monkeypatch.setattr(native_ingress, "ensure_built", broken)
    with pytest.raises(RuntimeError, match="libingress"):
        ColumnarAlfred(eng, **kw)
    with pytest.raises(RuntimeError, match="libingress"):
        split_frames(b"")
    assert ColumnarAlfred(eng, decode="numpy").drain_stats()["tier"] == \
        "numpy"

    class NoSymbols:
        def __init__(self, path):
            pass

    monkeypatch.setattr(native_ingress, "ensure_built", lambda t: t)
    monkeypatch.setattr(native_ingress.ctypes, "CDLL", NoSymbols)
    with pytest.raises(RuntimeError, match="cannot load"):
        native_ingress.load()
