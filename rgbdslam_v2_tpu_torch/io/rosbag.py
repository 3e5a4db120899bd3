"""ROS bag (format 2.0) reader and writer in numpy and the standard library.

Port of ``rgbdslam_v2_tpu/io/rosbag.py``, the same codec record for record:
the reference's primary offline input is rosbag playback (``processBagfile``
buffers synchronized RGB/depth/camera-info/odometry messages and releases
them through the pipeline, src/openni_listener.cpp:218-340), and
``saveBagfile`` records the optimized result (/tf trajectory + clouds) back
into a bag (src/graph_mgr_io.cpp:102-150). No ROS dependency:

- record-level reader for bag format 2.0 with none/bz2 chunk compression,
  over a read-only ``mmap``;
- message decoders for sensor_msgs/Image, sensor_msgs/CameraInfo,
  sensor_msgs/PointCloud2, tf/tfMessage (and tf2_msgs/TFMessage),
  nav_msgs/Odometry;
- ``pair_rgbd_messages`` / ``read_rgbd_frames``: approximate-time RGB/depth
  pairing in bag order through ``io/tum.associate`` (the
  message_filters::ApproximateTime feed of the reference's fake subscribers,
  openni_listener.cpp:342-382);
- a conformant writer (connections, chunks, index data, chunk info) whose
  bytes equal the JAX package's for the same messages.

Decoded messages hold zero-copy views into the mapping; every array a
message decodes to is a copy, so no array (nor a tensor made from one with
``torch.from_numpy``) outlives the mapping it came from. Torch enters only
``write_rgbd_bag``, for ``core/se3.rot_to_quat``.

Format reference: http://wiki.ros.org/Bags/Format/2.0 (public spec).
"""
from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONNECTION = 0x07

# Standard md5sums of the fixed message definitions (ROS-published constants).
MD5 = {
    "sensor_msgs/Image": "060021388200f6f0f447d0fcd9c64743",
    "sensor_msgs/CameraInfo": "c9a58c1b0b154e0e6da7578cb991d214",
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
    "tf/tfMessage": "94810edda583a504dfda3829e70d7eec",
    "tf2_msgs/TFMessage": "94810edda583a504dfda3829e70d7eec",
    "nav_msgs/Odometry": "cd5e73d190d741a2f92e81eda573aca7",
}

_u32 = struct.Struct("<I")
_u64 = struct.Struct("<Q")


# ---------------------------------------------------------------------------
# low-level record encoding
# ---------------------------------------------------------------------------
def _encode_header(fields: Dict[str, bytes]) -> bytes:
    out = []
    for name, value in fields.items():
        item = name.encode() + b"=" + value
        out.append(_u32.pack(len(item)) + item)
    return b"".join(out)


def _decode_header(buf) -> Dict[str, bytes]:
    buf = bytes(buf)  # headers are small; accept memoryview slices
    fields, off = {}, 0
    while off < len(buf):
        (n,) = _u32.unpack_from(buf, off)
        off += 4
        item = buf[off : off + n]
        off += n
        k, _, v = item.partition(b"=")
        fields[k.decode()] = v
    return fields


def _time_bytes(t: float) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    return struct.pack("<II", secs, nsecs)


def _time_from(b: bytes) -> float:
    secs, nsecs = struct.unpack_from("<II", b)
    return secs + nsecs * 1e-9


def _record(header_fields: Dict[str, bytes], data: bytes) -> bytes:
    hdr = _encode_header(header_fields)
    return _u32.pack(len(hdr)) + hdr + _u32.pack(len(data)) + data


def _read_record(buf, off: int) -> Tuple[Dict[str, bytes], "memoryview", int]:
    """Parse one record. `buf` may be bytes, mmap, or memoryview; the data
    payload is returned as a zero-copy memoryview so large bags stream
    through the OS page cache instead of being materialized in RAM."""
    (hlen,) = _u32.unpack_from(buf, off)
    off += 4
    header = _decode_header(bytes(buf[off : off + hlen]))
    off += hlen
    (dlen,) = _u32.unpack_from(buf, off)
    off += 4
    data = memoryview(buf)[off : off + dlen]
    return header, data, off + dlen


# ---------------------------------------------------------------------------
# message (de)serialization — the subset the reference's pipeline consumes
# ---------------------------------------------------------------------------
class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf, self.off = buf, 0

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self):
        (v,) = _u32.unpack_from(self.buf, self.off)
        self.off += 4
        return v

    def f64(self, n=1):
        v = struct.unpack_from(f"<{n}d", self.buf, self.off)
        self.off += 8 * n
        return v if n > 1 else v[0]

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off : self.off + n]
        self.off += n
        return bytes(s).decode(errors="replace")  # buf may be a memoryview

    def raw(self, n) -> bytes:
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b

    def header(self) -> Tuple[float, str]:
        self.u32()  # seq
        stamp = _time_from(self.raw(8))
        frame_id = self.string()
        return stamp, frame_id


def _ser_string(s: str) -> bytes:
    b = s.encode()
    return _u32.pack(len(b)) + b


def _ser_header(stamp: float, frame_id: str, seq: int = 0) -> bytes:
    return _u32.pack(seq) + _time_bytes(stamp) + _ser_string(frame_id)


@dataclass
class ImageMsg:
    stamp: float
    frame_id: str
    height: int
    width: int
    encoding: str
    step: int
    data: bytes

    def as_array(self) -> np.ndarray:
        """Decode to rgb uint8 HxWx3 or depth float32 HxW (meters), a copy
        that does not view the bag."""
        enc = self.encoding
        h, w = self.height, self.width
        if enc in ("rgb8", "bgr8"):
            a = np.frombuffer(self.data, np.uint8).reshape(h, self.step)[
                :, : w * 3
            ].reshape(h, w, 3)
            return a[..., ::-1].copy() if enc == "bgr8" else a.copy()
        if enc == "mono8" or enc == "8UC1":
            return np.frombuffer(self.data, np.uint8).reshape(h, self.step)[:, :w].copy()
        if enc in ("16UC1", "mono16"):
            a = np.frombuffer(self.data, np.uint16).reshape(h, self.step // 2)[:, :w]
            return a.astype(np.float32) * 1e-3  # ROS convention: mm -> m
        if enc == "32FC1":
            a = np.frombuffer(self.data, np.float32).reshape(h, self.step // 4)[:, :w]
            return a.copy()
        raise ValueError(f"unsupported image encoding {enc!r}")

    @staticmethod
    def decode(raw: bytes) -> "ImageMsg":
        c = _Cursor(raw)
        stamp, frame_id = c.header()
        height, width = c.u32(), c.u32()
        encoding = c.string()
        c.u8()  # is_bigendian
        step = c.u32()
        data = c.raw(c.u32())
        return ImageMsg(stamp, frame_id, height, width, encoding, step, data)

    @staticmethod
    def encode(stamp: float, frame_id: str, arr: np.ndarray) -> bytes:
        arr = np.ascontiguousarray(arr)
        if arr.ndim == 3:
            enc, step, data = "rgb8", arr.shape[1] * 3, arr.astype(np.uint8).tobytes()
        elif arr.dtype == np.uint16:
            enc, step, data = "16UC1", arr.shape[1] * 2, arr.tobytes()
        elif arr.dtype == np.uint8:
            enc, step, data = "mono8", arr.shape[1], arr.tobytes()
        else:
            enc, step = "32FC1", arr.shape[1] * 4
            data = arr.astype(np.float32).tobytes()
        return (
            _ser_header(stamp, frame_id)
            + _u32.pack(arr.shape[0])
            + _u32.pack(arr.shape[1])
            + _ser_string(enc)
            + b"\x00"
            + _u32.pack(step)
            + _u32.pack(len(data))
            + data
        )


@dataclass
class CameraInfoMsg:
    stamp: float
    height: int
    width: int
    K: np.ndarray  # 3x3

    @staticmethod
    def decode(raw: bytes) -> "CameraInfoMsg":
        c = _Cursor(raw)
        stamp, _ = c.header()
        height, width = c.u32(), c.u32()
        c.string()  # distortion_model
        nd = c.u32()  # variable-length D
        if nd:
            c.f64(nd)
        K = np.array(c.f64(9)).reshape(3, 3)
        return CameraInfoMsg(stamp, height, width, K)


# sensor_msgs/PointField datatype codes -> numpy dtypes
_PF_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
              5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


@dataclass
class PointCloud2Msg:
    """sensor_msgs/PointCloud2 — the reference's cloud-input transport
    (pcdCallback, openni_listener.cpp:536; param topic_points)."""

    stamp: float
    frame_id: str
    height: int
    width: int
    fields: list  # [(name, offset, datatype, count)]
    point_step: int
    data: bytes

    def as_cloud(self):
        """Decode to (points, colors): organized clouds return
        (H, W, 3) f32 xyz + (H, W, 3) u8 rgb (or None); flat clouds
        return (N, 3) shapes."""
        n = self.height * self.width
        arr = np.frombuffer(self.data, np.uint8, count=n * self.point_step)
        arr = arr.reshape(n, self.point_step)
        offs = {name: (off, dt) for name, off, dt, _cnt in self.fields}

        def col(name, dtype):
            off, _ = offs[name]
            w = np.dtype(dtype).itemsize
            return arr[:, off:off + w].copy().view(dtype)[:, 0]

        pts = np.stack([col("x", np.float32), col("y", np.float32),
                        col("z", np.float32)], axis=-1)
        cols = None
        key = "rgb" if "rgb" in offs else ("rgba" if "rgba" in offs else None)
        if key is not None:
            # PCL packs rgb into a float32's bits; rgba is a real uint32
            packed = col(key, np.uint32)
            cols = np.stack([(packed >> 16) & 255, (packed >> 8) & 255,
                             packed & 255], axis=-1).astype(np.uint8)
        if self.height > 1:
            pts = pts.reshape(self.height, self.width, 3)
            if cols is not None:
                cols = cols.reshape(self.height, self.width, 3)
        return pts, cols

    @staticmethod
    def decode(raw: bytes) -> "PointCloud2Msg":
        c = _Cursor(raw)
        stamp, frame_id = c.header()
        height, width = c.u32(), c.u32()
        fields = []
        for _ in range(c.u32()):
            name = c.string()
            off, dt, cnt = c.u32(), c.u8(), c.u32()
            fields.append((name, off, dt, cnt))
        c.u8()  # is_bigendian
        point_step = c.u32()
        c.u32()  # row_step
        data = bytes(c.raw(c.u32()))
        # trailing is_dense u8 ignored
        return PointCloud2Msg(stamp, frame_id, height, width, fields,
                              point_step, data)

    @staticmethod
    def encode(stamp: float, frame_id: str, points: np.ndarray,
               colors: np.ndarray | None = None) -> bytes:
        """Serialize an (optionally organized (H,W,3)) xyz[+rgb] cloud."""
        pts = np.asarray(points, np.float32)
        organized = pts.ndim == 3
        h, w = (pts.shape[0], pts.shape[1]) if organized else (1, len(pts))
        pts = pts.reshape(-1, 3)
        has_rgb = colors is not None
        point_step = 16 if has_rgb else 12
        body = np.zeros((len(pts), point_step), np.uint8)
        body[:, 0:12] = pts.astype(np.float32).view(np.uint8).reshape(-1, 12)
        fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1)]
        if has_rgb:
            c3 = np.asarray(colors, np.uint32).reshape(-1, 3)
            packed = ((c3[:, 0] << 16) | (c3[:, 1] << 8) | c3[:, 2]).astype(
                np.uint32)
            body[:, 12:16] = packed.view(np.uint8).reshape(-1, 4)
            fields.append(("rgb", 12, 7, 1))  # PCL: float32-typed bits
        out = [_ser_header(stamp, frame_id), _u32.pack(h), _u32.pack(w),
               _u32.pack(len(fields))]
        for name, off, dt, cnt in fields:
            out += [_ser_string(name), _u32.pack(off), bytes([dt]),
                    _u32.pack(cnt)]
        data = body.tobytes()
        out += [b"\x00", _u32.pack(point_step), _u32.pack(point_step * w),
                _u32.pack(len(data)), data, b"\x01"]
        return b"".join(out)


@dataclass
class TransformStamped:
    stamp: float
    frame_id: str
    child_frame_id: str
    translation: np.ndarray  # (3,)
    quaternion: np.ndarray  # (4,) x y z w


def decode_tf(raw: bytes) -> List[TransformStamped]:
    c = _Cursor(raw)
    out = []
    for _ in range(c.u32()):
        stamp, frame_id = c.header()
        child = c.string()
        t = np.array(c.f64(3))
        q = np.array(c.f64(4))
        out.append(TransformStamped(stamp, frame_id, child, t, q))
    return out


def encode_tf(transforms: Sequence[TransformStamped]) -> bytes:
    parts = [_u32.pack(len(transforms))]
    for tr in transforms:
        parts.append(_ser_header(tr.stamp, tr.frame_id))
        parts.append(_ser_string(tr.child_frame_id))
        parts.append(struct.pack("<3d", *tr.translation))
        parts.append(struct.pack("<4d", *tr.quaternion))
    return b"".join(parts)


@dataclass
class OdometryMsg:
    stamp: float
    frame_id: str
    child_frame_id: str
    position: np.ndarray  # (3,)
    quaternion: np.ndarray  # (4,) x y z w

    @staticmethod
    def decode(raw: bytes) -> "OdometryMsg":
        c = _Cursor(raw)
        stamp, frame_id = c.header()
        child = c.string()
        pos = np.array(c.f64(3))
        quat = np.array(c.f64(4))
        return OdometryMsg(stamp, frame_id, child, pos, quat)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------
@dataclass
class Connection:
    cid: int
    topic: str
    datatype: str


class BagReader:
    """Iterates (topic, datatype, time, raw_message_bytes) in bag order.

    Reads the chunked stream directly (index records are skipped), so
    partially-written or reindexed bags work too.
    """

    def __init__(self, path):
        import mmap

        self.path = Path(path)
        self._file = open(self.path, "rb")
        try:
            self._blob = mmap.mmap(
                self._file.fileno(), 0, access=mmap.ACCESS_READ
            )
        except (ValueError, OSError):  # empty file / exotic fs: fall back
            self._blob = self._file.read()
        if self._blob[: len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not a ROS bag 2.0 file")
        self.connections: Dict[int, Connection] = {}

    def close(self):
        """Release the file handle and (when no decoded message still views
        it) the mmap. Decoded messages hold zero-copy views into the mapping;
        CPython refuses to unmap while such views live (BufferError), so the
        mapping is then released when the last view drops — the fd, the
        scarce resource when iterating many bags, is always freed here."""
        import mmap

        if isinstance(self._blob, mmap.mmap):
            try:
                self._blob.close()
            except BufferError:
                pass  # live message views; unmapped at their GC
        self._blob = b""
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _add_connection(self, header, data):
        cid = _u32.unpack(header["conn"])[0]
        cf = _decode_header(data)
        topic = cf.get("topic", header.get("topic", b"")).decode()
        datatype = cf.get("type", b"").decode()
        self.connections[cid] = Connection(cid, topic, datatype)

    def records(self) -> Iterator[Tuple[str, str, float, bytes]]:
        buf, off = self._blob, len(MAGIC)
        while off < len(buf):
            header, data, off = _read_record(buf, off)
            op = header.get("op", b"\x00")[0]
            if op == OP_CONNECTION:
                self._add_connection(header, data)
            elif op == OP_CHUNK:
                compression = header.get("compression", b"none").decode()
                if compression == "none":
                    chunk = data
                elif compression == "bz2":
                    chunk = bz2.decompress(data)
                else:
                    raise ValueError(
                        f"unsupported chunk compression {compression!r} "
                        "(supported: none, bz2)"
                    )
                coff = 0
                while coff < len(chunk):
                    ch, cd, coff = _read_record(chunk, coff)
                    cop = ch.get("op", b"\x00")[0]
                    if cop == OP_CONNECTION:
                        self._add_connection(ch, cd)
                    elif cop == OP_MSG:
                        cid = _u32.unpack(ch["conn"])[0]
                        t = _time_from(ch["time"])
                        conn = self.connections.get(cid)
                        if conn is not None:
                            yield conn.topic, conn.datatype, t, cd
            elif op == OP_MSG:  # unchunked (rosbag always chunks, but allow)
                cid = _u32.unpack(header["conn"])[0]
                t = _time_from(header["time"])
                conn = self.connections.get(cid)
                if conn is not None:
                    yield conn.topic, conn.datatype, t, data


def pair_rgbd_messages(
    path,
    rgb_topic: str = "/camera/rgb/image_color",
    depth_topic: str = "/camera/depth/image",
    max_difference: float = 0.02,
    drop_async: bool = False,
) -> List[Tuple[ImageMsg, ImageMsg]]:
    """The bag's (rgb, depth) image messages, paired, in rgb order.

    Pairing uses the same greedy closest-pair timestamp association as the
    TUM benchmark tooling (io/tum.associate), metric parity with the
    reference's message_filters::ApproximateTime feed
    (openni_listener.cpp:218-340, fake subscribers :342-382). Unmatched
    frames are dropped, like the sync policy drops them; with drop_async,
    so are pairs more than 1/30 s apart (asyncFrameDrop, misc.cpp:432-448).
    The messages' data stay views into the bag's mapping (released when the
    last of them is dropped): decode them with ``as_array``."""
    from .tum import associate

    def norm(t):  # the reference accepts topics with/without leading slash
        return t.lstrip("/")

    rgb_topic, depth_topic = norm(rgb_topic), norm(depth_topic)
    rgb_msgs: List[ImageMsg] = []
    depth_msgs: List[ImageMsg] = []
    with BagReader(path) as reader:
        for topic, _datatype, _t, raw in reader.records():
            nt = norm(topic)
            if nt == rgb_topic:
                rgb_msgs.append(ImageMsg.decode(raw))
            elif nt == depth_topic:
                depth_msgs.append(ImageMsg.decode(raw))
    pairs = associate(
        [m.stamp for m in rgb_msgs],
        [m.stamp for m in depth_msgs],
        max_difference=max_difference,
    )
    return [
        (rgb_msgs[ir], depth_msgs[idp]) for ir, idp in pairs
        if not (drop_async and abs(rgb_msgs[ir].stamp - depth_msgs[idp].stamp) > 1.0 / 30)
    ]


def read_rgbd_frames(
    path,
    rgb_topic: str = "/camera/rgb/image_color",
    depth_topic: str = "/camera/depth/image",
    max_difference: float = 0.02,
    drop_async: bool = False,
) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """Yield (stamp, rgb u8 HxWx3, depth f32 HxW meters) pairs, paired as
    ``pair_rgbd_messages`` pairs them. Decoding to arrays is deferred to
    yield time so playback can prefetch frame by frame."""
    for r, d in pair_rgbd_messages(path, rgb_topic, depth_topic, max_difference,
                                   drop_async):
        yield r.stamp, r.as_array(), d.as_array()


def read_cloud_frames(
    path, cloud_topic: str,
) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """Yield (stamp, points, colors) from a PointCloud2 topic — the
    reference's cloud-input feed (param topic_points; pcdCallback,
    openni_listener.cpp:536). Decoding is deferred to yield time."""
    topic = cloud_topic.lstrip("/")
    msgs: List[PointCloud2Msg] = []
    with BagReader(path) as reader:
        for t, _datatype, _ts, raw in reader.records():
            if t.lstrip("/") == topic:
                msgs.append(PointCloud2Msg.decode(raw))
    for m in msgs:
        pts, cols = m.as_cloud()
        yield m.stamp, pts, cols


def read_tf_trajectory(
    path, child_frame: Optional[str] = None, tf_topic: str = "/tf"
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract a (stamps, [N,7] t+quat(xyzw)) trajectory from /tf messages
    (the reference pulls ground truth from bag tf, openni_listener.cpp:64-90,
    948-1014)."""
    stamps, rows = [], []
    tf_topic = tf_topic.lstrip("/")
    with BagReader(path) as reader:
        for topic, datatype, _t, raw in reader.records():
            if topic.lstrip("/") != tf_topic:
                continue
            for tr in decode_tf(raw):
                if child_frame is None or tr.child_frame_id.lstrip("/") == child_frame.lstrip("/"):
                    stamps.append(tr.stamp)
                    rows.append(np.concatenate([tr.translation, tr.quaternion]))
    return np.array(stamps), np.array(rows).reshape(-1, 7)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------
class BagWriter:
    """Conformant bag 2.0 writer: one chunk per ``flush_every`` messages,
    connection records duplicated into chunks, index data + chunk info so
    stock rosbag tooling can read the output."""

    def __init__(self, path, flush_every: int = 64):
        self.path = Path(path)
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        # placeholder bag header record, rewritten on close (rosbag pads the
        # record to 4096 bytes so it can be rewritten in place)
        self._baghdr_pos = self._f.tell()
        self._write_baghdr(0, 0, 0)
        self.flush_every = flush_every
        self._conns: Dict[Tuple[str, str], int] = {}
        self._conn_records: List[bytes] = []
        self._pending: List[Tuple[int, float, bytes]] = []
        self._chunk_infos: List[Tuple[int, float, float, Dict[int, int]]] = []
        self._closed = False

    def _write_baghdr(self, index_pos: int, conn_count: int, chunk_count: int):
        hdr = _encode_header(
            {
                "op": bytes([OP_BAGHDR]),
                "index_pos": _u64.pack(index_pos),
                "conn_count": _u32.pack(conn_count),
                "chunk_count": _u32.pack(chunk_count),
            }
        )
        pad = 4096 - len(hdr)
        rec = _u32.pack(len(hdr)) + hdr + _u32.pack(pad) + b" " * pad
        self._f.write(rec)

    def _conn_id(self, topic: str, datatype: str) -> int:
        key = (topic, datatype)
        if key not in self._conns:
            cid = len(self._conns)
            self._conns[key] = cid
            conn_header = _encode_header(
                {
                    "topic": topic.encode(),
                    "type": datatype.encode(),
                    "md5sum": MD5.get(datatype, "*").encode(),
                    "message_definition": b"",
                }
            )
            self._conn_records.append(
                _record(
                    {
                        "op": bytes([OP_CONNECTION]),
                        "conn": _u32.pack(cid),
                        "topic": topic.encode(),
                    },
                    conn_header,
                )
            )
        return self._conns[key]

    def write(self, topic: str, datatype: str, stamp: float, raw: bytes):
        if self._closed:
            raise RuntimeError("bag already closed")
        cid = self._conn_id(topic, datatype)
        self._pending.append((cid, stamp, raw))
        if len(self._pending) >= self.flush_every:
            self._flush_chunk()

    def write_image(self, topic: str, stamp: float, arr, frame_id="/camera"):
        self.write(topic, "sensor_msgs/Image", stamp,
                   ImageMsg.encode(stamp, frame_id, np.asarray(arr)))

    def write_tf(self, transforms: Sequence[TransformStamped],
                 topic: str = "/tf"):
        self.write(topic, "tf/tfMessage", transforms[0].stamp,
                   encode_tf(transforms))

    def _flush_chunk(self):
        if not self._pending:
            return
        parts: List[bytes] = list(self._conn_records)
        offsets: Dict[int, List[Tuple[float, int]]] = {}
        pos = sum(len(p) for p in parts)
        for cid, stamp, raw in self._pending:
            rec = _record(
                {"op": bytes([OP_MSG]), "conn": _u32.pack(cid),
                 "time": _time_bytes(stamp)},
                raw,
            )
            offsets.setdefault(cid, []).append((stamp, pos))
            parts.append(rec)
            pos += len(rec)
        chunk = b"".join(parts)
        t0 = min(s for _, s, _ in self._pending)
        t1 = max(s for _, s, _ in self._pending)
        chunk_pos = self._f.tell()
        self._f.write(
            _record(
                {
                    "op": bytes([OP_CHUNK]),
                    "compression": b"none",
                    "size": _u32.pack(len(chunk)),
                },
                chunk,
            )
        )
        # index data records (one per connection in this chunk)
        for cid, entries in offsets.items():
            data = b"".join(_time_bytes(s) + _u32.pack(o) for s, o in entries)
            self._f.write(
                _record(
                    {
                        "op": bytes([OP_INDEX]),
                        "ver": _u32.pack(1),
                        "conn": _u32.pack(cid),
                        "count": _u32.pack(len(entries)),
                    },
                    data,
                )
            )
        self._chunk_infos.append(
            (chunk_pos, t0, t1, {c: len(e) for c, e in offsets.items()})
        )
        self._pending.clear()

    def close(self):
        if self._closed:
            return
        self._flush_chunk()
        index_pos = self._f.tell()
        for rec in self._conn_records:
            self._f.write(rec)
        for chunk_pos, t0, t1, counts in self._chunk_infos:
            data = b"".join(
                _u32.pack(c) + _u32.pack(n) for c, n in counts.items()
            )
            self._f.write(
                _record(
                    {
                        "op": bytes([OP_CHUNKINFO]),
                        "ver": _u32.pack(1),
                        "chunk_pos": _u64.pack(chunk_pos),
                        "start_time": _time_bytes(t0),
                        "end_time": _time_bytes(t1),
                        "count": _u32.pack(len(counts)),
                    },
                    data,
                )
            )
        self._f.seek(self._baghdr_pos)
        self._write_baghdr(index_pos, len(self._conns), len(self._chunk_infos))
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_rgbd_bag(
    path,
    stamps: Sequence[float],
    rgbs,
    depths,
    rgb_topic: str = "/camera/rgb/image_color",
    depth_topic: str = "/camera/depth/image",
    gt_poses=None,
    gt_child_frame: str = "/kinect",
    gt_frame: str = "/world",
):
    """Record an RGB-D sequence (optionally with ground-truth /tf) as a bag —
    the synthetic-data analog of the TUM benchmark bags the reference
    consumes, and the fixture generator for playback tests."""
    import torch

    from ..core.se3 import rot_to_quat

    with BagWriter(path) as bag:
        for i, t in enumerate(stamps):
            t = float(t)
            if gt_poses is not None:
                q = rot_to_quat(torch.from_numpy(np.array(gt_poses[i][:3, :3]))).numpy()
                bag.write_tf(
                    [
                        TransformStamped(
                            t, gt_frame, gt_child_frame,
                            np.asarray(gt_poses[i][:3, 3]), q,
                        )
                    ]
                )
            bag.write_image(rgb_topic, t, np.asarray(rgbs[i]))
            d = np.asarray(depths[i])
            if d.dtype == np.uint16:
                # TUM PNG quantization (1/5000 m) -> 32FC1 meters; writing
                # the raw u16 would be decoded as 16UC1 MILLIMETERS by every
                # ROS consumer (5x scale error)
                d = d.astype(np.float32) / 5000.0
            else:
                d = d.astype(np.float32)
            bag.write_image(depth_topic, t, d)
    return Path(path)
