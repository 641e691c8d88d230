"""Minimal pure-python ROS1 bag (V2.0) reader for DVS event data.

Replaces the reference's ROS ``rosbag``/``dvs_msgs`` dependency
(``src/utils/rosbag_loading.cpp:11-116``): extracts ``dvs_msgs/EventArray``
events (and optionally ``sensor_msgs/CameraInfo``) from a bag within a time
interval, sorted by timestamp.

Supports uncompressed and bz2-compressed chunks (lz4 if the ``lz4`` module
is importable). No external dependencies.

A copy of ``emba_tpu/rosbag.py`` (numpy only), so that the port imports
nothing of the JAX package; the two write the same bytes.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass

import numpy as np

_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07


def _read_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        k, _, v = field.partition(b"=")
        fields[k.decode()] = v
    return fields


def _iter_records(data: bytes):
    off = 0
    n = len(data)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", data, off)
        off += 4
        header = _read_header(data[off : off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", data, off)
        off += 4
        payload = data[off : off + dlen]
        off += dlen
        yield header, payload


@dataclass
class CameraInfo:
    width: int
    height: int
    distortion_model: str
    D: np.ndarray
    K: np.ndarray
    R: np.ndarray
    P: np.ndarray


def _parse_camera_info(data: bytes) -> CameraInfo:
    off = 0
    # std_msgs/Header: seq, stamp(2x uint32), frame_id string
    off += 4 + 8
    (slen,) = struct.unpack_from("<I", data, off)
    off += 4 + slen
    height, width = struct.unpack_from("<II", data, off)
    off += 8
    (slen,) = struct.unpack_from("<I", data, off)
    off += 4
    model = data[off : off + slen].decode()
    off += slen
    (dn,) = struct.unpack_from("<I", data, off)
    off += 4
    D = np.frombuffer(data, "<f8", dn, off).copy()
    off += 8 * dn
    K = np.frombuffer(data, "<f8", 9, off).copy()
    off += 72
    R = np.frombuffer(data, "<f8", 9, off).copy()
    off += 72
    P = np.frombuffer(data, "<f8", 12, off).copy()
    return CameraInfo(width, height, model, D, K, R, P)


def _parse_event_array(data: bytes):
    """dvs_msgs/EventArray -> (t (N,) f64 seconds, x, y, pol) arrays."""
    off = 0
    off += 4 + 8  # header seq + stamp
    (slen,) = struct.unpack_from("<I", data, off)
    off += 4 + slen
    off += 8  # height, width
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    # each event: x uint16, y uint16, ts (sec uint32, nsec uint32), pol uint8
    rec = np.frombuffer(data, dtype=np.dtype(
        [("x", "<u2"), ("y", "<u2"), ("sec", "<u4"), ("nsec", "<u4"), ("pol", "u1")]
    ), count=n, offset=off)
    t = rec["sec"].astype(np.float64) + rec["nsec"].astype(np.float64) * 1e-9
    return t, rec["x"].astype(np.int32), rec["y"].astype(np.int32), rec[
        "pol"
    ].astype(np.int8)


def parse_rosbag(
    path: str,
    events_topic: str,
    camera_info_topic: str | None = None,
    tmin: float = -np.inf,
    tmax: float = np.inf,
):
    """Read events (and optionally the first CameraInfo) from a ROS1 bag.

    Returns ((t, x, y, pol) sorted by t within [tmin, tmax], CameraInfo|None).
    Mirrors the reference's filtering semantics
    (``rosbag_loading.cpp:44-51``: keep tmin + 1e-6 < t <= tmax).
    """
    conn_topics: dict[int, str] = {}
    conn_types: dict[int, str] = {}
    ev_chunks = []
    cam_info = None

    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a ROS1 V2.0 bag: {magic!r}")
        raw = f.read()

    for header, payload in _iter_records(raw):
        op = header.get("op", b"\x00")[0]
        if op == _OP_CONNECTION:
            cid = struct.unpack("<I", header["conn"])[0]
            topic = header["topic"].decode()
            sub = _read_header(payload)
            conn_topics[cid] = topic
            conn_types[cid] = sub.get("type", b"").decode()
        elif op == _OP_CHUNK:
            compression = header.get("compression", b"none").decode()
            if compression == "none":
                chunk = payload
            elif compression == "bz2":
                chunk = bz2.decompress(payload)
            elif compression == "lz4":
                try:
                    import lz4.frame  # type: ignore

                    chunk = lz4.frame.decompress(payload)
                except ImportError as e:
                    raise RuntimeError(
                        "bag uses lz4 compression; lz4 module unavailable"
                    ) from e
            else:
                raise ValueError(f"unknown chunk compression {compression!r}")
            for h2, p2 in _iter_records(chunk):
                op2 = h2.get("op", b"\x00")[0]
                if op2 == _OP_CONNECTION:
                    cid = struct.unpack("<I", h2["conn"])[0]
                    topic = h2["topic"].decode()
                    conn_topics[cid] = topic
                    sub = _read_header(p2)
                    conn_types[cid] = sub.get("type", b"").decode()
                elif op2 == _OP_MSG:
                    cid = struct.unpack("<I", h2["conn"])[0]
                    topic = conn_topics.get(cid, "")
                    if topic == events_topic:
                        ev_chunks.append(_parse_event_array(p2))
                    elif (
                        camera_info_topic
                        and topic == camera_info_topic
                        and cam_info is None
                    ):
                        cam_info = _parse_camera_info(p2)

    if ev_chunks:
        t = np.concatenate([c[0] for c in ev_chunks])
        x = np.concatenate([c[1] for c in ev_chunks])
        y = np.concatenate([c[2] for c in ev_chunks])
        pol = np.concatenate([c[3] for c in ev_chunks])
    else:
        t = np.zeros(0)
        x = y = np.zeros(0, np.int32)
        pol = np.zeros(0, np.int8)

    m = (t > tmin + 1e-6) & (t <= tmax)
    t, x, y, pol = t[m], x[m], y[m], pol[m]
    order = np.argsort(t, kind="stable")
    return (t[order], x[order], y[order], pol[order]), cam_info


def _field(k: str, v: bytes) -> bytes:
    b = k.encode() + b"=" + v
    return struct.pack("<I", len(b)) + b


def _record(header_fields: dict, payload: bytes) -> bytes:
    hdr = b"".join(_field(k, v) for k, v in header_fields.items())
    return (
        struct.pack("<I", len(hdr)) + hdr
        + struct.pack("<I", len(payload)) + payload
    )


def _timeval(ts: float) -> bytes:
    sec = int(ts)
    nsec = int(round((ts - sec) * 1e9))
    if nsec >= 1_000_000_000:
        sec, nsec = sec + 1, nsec - 1_000_000_000
    return struct.pack("<II", sec, nsec)


def _conn_record(cid: int, topic: str, msg_type: str, md5: str) -> bytes:
    return _record(
        {
            "op": b"\x07",
            "conn": struct.pack("<I", cid),
            "topic": topic.encode(),
        },
        b"".join(
            [
                _field("topic", topic.encode()),
                _field("type", msg_type.encode()),
                _field("md5sum", md5.encode()),
                _field("message_definition", b""),
                _field("callerid", b"/emba_tpu_writer"),
            ]
        ),
    )


def _camera_info_body(cam: "CameraInfo", stamp: float) -> bytes:
    """Serialize a sensor_msgs/CameraInfo message body."""
    model = cam.distortion_model.encode()
    D = np.asarray(cam.D, "<f8")
    return (
        struct.pack("<I", 0) + _timeval(stamp) + struct.pack("<I", 0)  # header
        + struct.pack("<II", cam.height, cam.width)
        + struct.pack("<I", len(model)) + model
        + struct.pack("<I", len(D)) + D.tobytes()
        + np.asarray(cam.K, "<f8").tobytes()
        + np.asarray(cam.R, "<f8").tobytes()
        + np.asarray(cam.P, "<f8").tobytes()
        + struct.pack("<II", 0, 0)  # binning
        + struct.pack("<IIII", 0, 0, 0, 0) + b"\x00"  # roi
    )


def write_rosbag(path: str, events_topic: str, t, x, y, pol, chunk_events=50000,
                 width=None, height=None, compression: str = "none",
                 camera_info: "CameraInfo | None" = None,
                 camera_info_topic: str = "/dvs/camera_info",
                 extra_topic: str | None = None,
                 write_index: bool = True):
    """Write a ROS1 V2.0 bag with dvs_msgs/EventArray messages in the
    STANDARD indexed layout (mirrors what ``rosbag record`` / reindex emit,
    per the public bag-format spec; the reference consumes such bags via
    ``src/utils/rosbag_loading.cpp:11-116``):

    * bag header record (op 0x03) with a real ``index_pos`` and the 4096-byte
      space padding,
    * chunk records (op 0x05; ``compression`` in none|bz2|lz4) whose payload
      embeds the connection records of the connections used in that chunk,
    * per-connection INDEX records (op 0x04, ver 1) after each chunk,
    * an index section at ``index_pos``: all connection records (op 0x07)
      followed by per-chunk CHUNK_INFO records (op 0x06, ver 1).

    ``camera_info`` adds a second connection carrying one
    sensor_msgs/CameraInfo message; ``extra_topic`` adds a third connection
    with unknown-type messages (readers must skip them). ``write_index=False``
    emits the truncated "active" layout (index_pos=0, no index section) that
    crashed recorders leave behind. For round-trip tests and interop with
    the reference."""
    t = np.asarray(t, np.float64)
    x = np.asarray(x)
    y = np.asarray(y)
    pol = np.asarray(pol)
    width = int(width if width is not None else (x.max() + 1 if len(x) else 1))
    height = int(height if height is not None else (y.max() + 1 if len(y) else 1))

    conns = [(0, events_topic, "dvs_msgs/EventArray",
              "5e8beee5a6c107e504c2e78903c224b8")]
    if camera_info is not None:
        conns.append((1, camera_info_topic, "sensor_msgs/CameraInfo",
                      "c9a58c1b0b154e0e6da7578cb991d214"))
    if extra_topic is not None:
        conns.append((2, extra_topic, "std_msgs/String",
                      "992ce8a1687cec8c8bd883ec73ca41d1"))

    def compress(b: bytes) -> bytes:
        if compression == "none":
            return b
        if compression == "bz2":
            return bz2.compress(b)
        if compression == "lz4":
            import lz4.frame  # type: ignore

            return lz4.frame.compress(b)
        raise ValueError(f"unknown compression {compression!r}")

    # build chunks: each with its connection records + message records
    chunk_blobs = []  # (uncompressed_payload, [(cid, [times])], t_lo, t_hi)
    for ci, lo in enumerate(range(0, max(len(t), 1), chunk_events)):
        hi = min(lo + chunk_events, len(t))
        n = hi - lo
        rec = np.zeros(
            n,
            dtype=np.dtype(
                [("x", "<u2"), ("y", "<u2"), ("sec", "<u4"), ("nsec", "<u4"),
                 ("pol", "u1")]
            ),
        )
        rec["x"], rec["y"] = x[lo:hi], y[lo:hi]
        sec = t[lo:hi].astype(np.int64)
        rec["sec"] = sec
        rec["nsec"] = np.round((t[lo:hi] - sec) * 1e9).astype(np.int64)
        rec["pol"] = np.asarray(pol[lo:hi] > 0, np.uint8)
        t_lo = float(t[lo]) if n else 0.0
        body = (
            struct.pack("<I", ci)  # header.seq
            + _timeval(t_lo)  # header.stamp
            + struct.pack("<I", 0)  # frame_id ""
            + struct.pack("<II", height, width)
            + struct.pack("<I", n)
            + rec.tobytes()
        )
        parts = [_conn_record(*conns[0])]
        counts = [(0, [t_lo])]
        if ci == 0 and camera_info is not None:
            parts.append(_conn_record(*conns[1]))
            cam_body = _camera_info_body(camera_info, t_lo)
            parts.append(_record(
                {"op": b"\x02", "conn": struct.pack("<I", 1),
                 "time": _timeval(t_lo)},
                cam_body,
            ))
            counts.append((1, [t_lo]))
        if extra_topic is not None:
            parts.append(_conn_record(*conns[2]))
            s = f"noise {ci}".encode()
            parts.append(_record(
                {"op": b"\x02", "conn": struct.pack("<I", 2),
                 "time": _timeval(t_lo)},
                struct.pack("<I", len(s)) + s,
            ))
            counts.append((2, [t_lo]))
        parts.append(_record(
            {"op": b"\x02", "conn": struct.pack("<I", 0),
             "time": _timeval(t_lo)},
            body,
        ))
        t_hi = float(t[hi - 1]) if n else 0.0
        chunk_blobs.append((b"".join(parts), counts, t_lo, t_hi))

    # lay out the file to compute index_pos and chunk positions
    magic = b"#ROSBAG V2.0\n"
    # bag header: payload space-padded so the whole record is 4096+13 bytes
    def bag_header(index_pos: int) -> bytes:
        hdr_fields = {
            "op": b"\x03",
            "index_pos": struct.pack("<Q", index_pos),
            "conn_count": struct.pack("<I", len(conns)),
            "chunk_count": struct.pack("<I", len(chunk_blobs)),
        }
        hdr = b"".join(_field(k, v) for k, v in hdr_fields.items())
        pad = 4096 - len(hdr)
        return (
            struct.pack("<I", len(hdr)) + hdr
            + struct.pack("<I", pad) + b" " * pad
        )

    pieces = []
    chunk_positions = []
    pos = len(magic) + len(bag_header(0))
    for payload, counts, t_lo, t_hi in chunk_blobs:
        comp = compress(payload)
        chunk_rec = _record(
            {
                "op": b"\x05",
                "compression": compression.encode(),
                "size": struct.pack("<I", len(payload)),
            },
            comp,
        )
        chunk_positions.append(pos)
        pieces.append(chunk_rec)
        pos += len(chunk_rec)
        if write_index:
            for cid, times in counts:
                idx_payload = b"".join(
                    _timeval(ts) + struct.pack("<I", 0) for ts in times
                )
                idx = _record(
                    {
                        "op": b"\x04",
                        "ver": struct.pack("<I", 1),
                        "conn": struct.pack("<I", cid),
                        "count": struct.pack("<I", len(times)),
                    },
                    idx_payload,
                )
                pieces.append(idx)
                pos += len(idx)

    index_pos = pos if write_index else 0
    if write_index:
        for c in conns:
            pieces.append(_conn_record(*c))
        for (payload, counts, t_lo, t_hi), cpos in zip(
            chunk_blobs, chunk_positions
        ):
            info_payload = b"".join(
                struct.pack("<I", cid) + struct.pack("<I", len(times))
                for cid, times in counts
            )
            pieces.append(_record(
                {
                    "op": b"\x06",
                    "ver": struct.pack("<I", 1),
                    "chunk_pos": struct.pack("<Q", cpos),
                    "start_time": _timeval(t_lo),
                    "end_time": _timeval(t_hi),
                    "count": struct.pack("<I", len(counts)),
                },
                info_payload,
            ))

    with open(path, "wb") as f:
        f.write(magic)
        f.write(bag_header(index_pos))
        for p in pieces:
            f.write(p)
