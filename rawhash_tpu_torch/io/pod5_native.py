"""Native POD5 container decode/encode — no `pod5`/`lib_pod5` dependency.

POD5 is a container of embedded Apache-Arrow IPC ("Feather V2") tables
(nanoporetech pod5-file-format).  Layout:

    signature(8) = 8B 'P' 'O' 'D' 0D 0A 1A 0A
    section marker (16 random bytes, unique per file)
    [ embedded Arrow file, padded to 8 bytes, section marker ] * N
    footer (FlatBuffer), footer length (int64 LE), section marker, signature(8)

The footer FlatBuffer (footer.fbs) is
    table EmbeddedFile { offset:int64; length:int64; format:short; content_type:short; }
    table Footer { file_identifier:string; software:string; pod5_version:string;
                   contents:[EmbeddedFile]; }
We parse it with a small hand-rolled FlatBuffer walk (no generated code), and
fall back to splitting the byte stream on the section marker if the footer is
unreadable.  Embedded tables are classified by their Arrow *schema* (reads
table has `calibration_offset`, signal table has `samples`), never by the
footer's content-type enum, so enum drift across pod5 versions is harmless.

Signal is stored chunked (rows of <= SIGNAL_CHUNK samples) in the signal
table, either uncompressed (`list<int16>`) or VBZ-compressed
(`large_binary`).  VBZ = zstd( svb16( zigzag(delta16(x)) ) ):
  * delta16: d_i = x_i - x_{i-1} in wrap-around uint16 arithmetic (x_{-1}=0)
  * zigzag on the signed 16-bit delta: (d<<1) ^ (d>>15)  -> uint16
  * svb16: per-value 1-bit key (ceil(n/8) key bytes, LSB-first), then 1 or 2
    little-endian data bytes per value
  * zstd frame on the key+data stream

The mapping engine consumes this through io/sigfile.read_pod5 with the exact
reference pA conversion pa = (raw + calibration_offset) * calibration_scale in
float32 and the (30, 200) pA drop filter (reference: src/rsig.c:416-431).
"""

from __future__ import annotations

import struct
import uuid
from typing import Iterator

import numpy as np

SIGNATURE = b"\x8BPOD\r\n\x1A\n"
SIGNAL_CHUNK = 102_400  # samples per signal-table row (pod5 default)

# footer.fbs enums (Format / ContentType).  Only used when *writing*; the
# reader classifies tables by schema.
FORMAT_FEATHER_V2 = 1
CONTENT_READS_TABLE = 1
CONTENT_SIGNAL_TABLE = 2
CONTENT_RUN_INFO_TABLE = 3


# ---------------------------------------------------------------------------
# svb16 codec (StreamVByte for 16-bit values: 1-bit keys, 1-2 byte payload)
# ---------------------------------------------------------------------------

def svb16_encode(vals: np.ndarray) -> bytes:
    """uint16 values -> svb16 stream (key section + data section)."""
    vals = np.ascontiguousarray(vals, dtype=np.uint16)
    n = int(vals.shape[0])
    if n == 0:
        return b""
    keys = (vals > 0xFF).astype(np.uint8)
    key_bytes = np.packbits(keys, bitorder="little")
    lens = keys.astype(np.int64) + 1
    offs = np.cumsum(lens) - lens
    data = np.zeros(int(lens.sum()), dtype=np.uint8)
    data[offs] = (vals & 0xFF).astype(np.uint8)
    two = np.nonzero(keys)[0]
    data[offs[two] + 1] = (vals[two] >> 8).astype(np.uint8)
    return key_bytes.tobytes() + data.tobytes()


def svb16_decode(buf: bytes, count: int) -> np.ndarray:
    """svb16 stream -> uint16 values (vectorized)."""
    if count == 0:
        return np.zeros(0, dtype=np.uint16)
    n_key = (count + 7) // 8
    keys = np.unpackbits(
        np.frombuffer(buf[:n_key], dtype=np.uint8), bitorder="little"
    )[:count]
    data = np.frombuffer(buf[n_key:], dtype=np.uint8)
    lens = keys.astype(np.int64) + 1
    offs = np.cumsum(lens) - lens
    if int(lens.sum()) > data.shape[0]:
        raise ValueError("svb16 stream truncated")
    out = data[offs].astype(np.uint16)
    two = np.nonzero(keys)[0]
    out[two] |= data[offs[two] + 1].astype(np.uint16) << 8
    return out


def _zigzag16_encode(d: np.ndarray) -> np.ndarray:
    """int16 deltas -> uint16 zigzag codes."""
    u = d.view(np.uint16) if d.dtype == np.int16 else d.astype(np.int16).view(np.uint16)
    sign = (u >> 15).astype(np.uint16)  # 0 or 1
    return ((u << np.uint16(1)) ^ (np.uint16(0) - sign)).astype(np.uint16)


def _zigzag16_decode(z: np.ndarray) -> np.ndarray:
    """uint16 zigzag codes -> int16 deltas."""
    z = z.astype(np.uint16)
    return ((z >> np.uint16(1)) ^ (np.uint16(0) - (z & np.uint16(1)))).view(np.int16)


def vbz_encode_signal(sig: np.ndarray, zstd_level: int = 1) -> bytes:
    """int16 samples -> VBZ blob (zstd(svb16(zigzag(delta16))))."""
    import zstandard

    sig = np.ascontiguousarray(sig, dtype=np.int16)
    u = sig.view(np.uint16)
    prev = np.concatenate([np.zeros(1, dtype=np.uint16), u[:-1]])
    deltas = (u - prev).astype(np.uint16)  # wrap-around uint16 delta
    stream = svb16_encode(_zigzag16_encode(deltas.view(np.int16)))
    return zstandard.ZstdCompressor(level=zstd_level).compress(stream)


def vbz_decode_signal(blob: bytes, count: int) -> np.ndarray:
    """VBZ blob + sample count -> int16 samples."""
    import zstandard

    stream = zstandard.ZstdDecompressor().decompress(
        blob, max_output_size=max(16, 2 * count + (count + 7) // 8)
    )
    deltas = _zigzag16_decode(svb16_decode(stream, count))
    x = np.cumsum(deltas.astype(np.int64)) & 0xFFFF
    return x.astype(np.uint16).view(np.int16)


# ---------------------------------------------------------------------------
# FlatBuffer footer: minimal hand-rolled parse + build (schema in docstring)
# ---------------------------------------------------------------------------

def _fb_table_field_pos(buf: bytes, table_pos: int, field: int) -> int:
    """Absolute position of field `field` in the table, or 0 if absent."""
    vtable_pos = table_pos - struct.unpack_from("<i", buf, table_pos)[0]
    vtable_size = struct.unpack_from("<H", buf, vtable_pos)[0]
    slot = 4 + 2 * field
    if slot >= vtable_size:
        return 0
    off = struct.unpack_from("<H", buf, vtable_pos + slot)[0]
    return table_pos + off if off else 0


def parse_footer(buf: bytes) -> list[tuple[int, int, int, int]]:
    """Footer flatbuffer -> [(offset, length, format, content_type)]."""
    root = struct.unpack_from("<I", buf, 0)[0]
    vec_field = _fb_table_field_pos(buf, root, 3)  # Footer.contents
    if not vec_field:
        return []
    vec = vec_field + struct.unpack_from("<I", buf, vec_field)[0]
    n = struct.unpack_from("<I", buf, vec)[0]
    out = []
    for i in range(n):
        elem_ref = vec + 4 + 4 * i
        t = elem_ref + struct.unpack_from("<I", buf, elem_ref)[0]
        vals = []
        for field, fmt, default in ((0, "<q", 0), (1, "<q", 0), (2, "<h", 0), (3, "<h", 0)):
            pos = _fb_table_field_pos(buf, t, field)
            vals.append(struct.unpack_from(fmt, buf, pos)[0] if pos else default)
        out.append(tuple(vals))
    return out


def build_footer(
    contents: list[tuple[int, int, int, int]],
    file_identifier: str,
    software: str = "rawhash-tpu",
    version: str = "0.3.10",
) -> bytes:
    import flatbuffers

    b = flatbuffers.Builder(1024)
    s_ver = b.CreateString(version)
    s_sw = b.CreateString(software)
    s_fid = b.CreateString(file_identifier)
    elems = []
    for offset, length, fmt, ctype in contents:
        b.StartObject(4)
        b.PrependInt64Slot(0, offset, 0)
        b.PrependInt64Slot(1, length, 0)
        b.PrependInt16Slot(2, fmt, 0)
        b.PrependInt16Slot(3, ctype, 0)
        elems.append(b.EndObject())
    b.StartVector(4, len(elems), 4)
    for e in reversed(elems):
        b.PrependUOffsetTRelative(e)
    vec = b.EndVector()
    b.StartObject(4)
    b.PrependUOffsetTRelativeSlot(0, s_fid, 0)
    b.PrependUOffsetTRelativeSlot(1, s_sw, 0)
    b.PrependUOffsetTRelativeSlot(2, s_ver, 0)
    b.PrependUOffsetTRelativeSlot(3, vec, 0)
    b.Finish(b.EndObject())
    return bytes(b.Output())


# ---------------------------------------------------------------------------
# Container read
# ---------------------------------------------------------------------------

def _trim_arrow(chunk: bytes) -> bytes | None:
    """Strip alignment padding: an Arrow IPC file starts with ARROW1\\0\\0 and
    ends with ...footer, int32 footer-length, 'ARROW1'."""
    if not chunk.startswith(b"ARROW1\x00\x00"):
        return None
    end = chunk.rfind(b"ARROW1")
    if end <= 0:
        return None
    return chunk[: end + 6]


def _embedded_tables(data: bytes) -> list:
    """All embedded Arrow tables in a POD5 byte image (footer-directed, with
    a section-marker split fallback)."""
    import pyarrow as pa
    import pyarrow.ipc as ipc

    if data[:8] != SIGNATURE or data[-8:] != SIGNATURE:
        raise ValueError("not a POD5 file (bad signature)")
    chunks: list[bytes] = []
    try:
        flen = struct.unpack_from("<q", data, len(data) - 32)[0]
        footer = data[len(data) - 32 - flen : len(data) - 32]
        for offset, length, _fmt, _ct in parse_footer(footer):
            chunks.append(data[offset : offset + length])
    except Exception:
        chunks = []
    if not chunks:  # fallback: split on the per-file section marker
        marker = data[8:24]
        chunks = data.split(marker)
    tables = []
    for c in chunks:
        trimmed = _trim_arrow(c)
        if trimmed is None:
            continue
        tables.append(ipc.open_file(pa.BufferReader(trimmed)).read_all())
    return tables


def _classify(tables: list):
    """Schema-based classification: reads table carries calibration columns,
    signal table carries the `samples` column."""
    reads_tbl = signal_tbl = None
    for t in tables:
        names = set(t.schema.names)
        if {"read_id", "signal", "calibration_offset", "calibration_scale"} <= names:
            reads_tbl = t
        elif {"read_id", "signal", "samples"} <= names:
            signal_tbl = t
    if reads_tbl is None or signal_tbl is None:
        raise ValueError("POD5: reads/signal table not found")
    return reads_tbl, signal_tbl


def read_pod5_raw(path: str) -> Iterator[dict]:
    """Yield {read_id, signal(int16), calibration_offset, calibration_scale}
    per read, reassembling chunked rows from the signal table."""
    import pyarrow as pa

    with open(path, "rb") as f:
        data = f.read()
    reads_tbl, signal_tbl = _classify(_embedded_tables(data))

    samples = signal_tbl.column("samples").to_numpy(zero_copy_only=False)
    sig_col = signal_tbl.column("signal")
    sig_type = sig_col.type
    compressed = pa.types.is_binary(sig_type) or pa.types.is_large_binary(sig_type)
    sig_rows = sig_col.to_pylist() if compressed else None
    if not compressed:
        flat = sig_col.combine_chunks()
        if isinstance(flat, pa.ChunkedArray):
            flat = flat.chunk(0)

    def _signal_row(j: int) -> np.ndarray:
        if compressed:
            return vbz_decode_signal(sig_rows[j], int(samples[j]))
        return np.asarray(flat[j].values, dtype=np.int16)

    rid_col = reads_tbl.column("read_id")
    row_lists = reads_tbl.column("signal").to_pylist()
    offs = reads_tbl.column("calibration_offset").to_numpy(zero_copy_only=False)
    scales = reads_tbl.column("calibration_scale").to_numpy(zero_copy_only=False)
    for i in range(reads_tbl.num_rows):
        rid_raw = rid_col[i].as_py()
        rid = str(uuid.UUID(bytes=rid_raw)) if isinstance(rid_raw, bytes) else str(rid_raw)
        parts = [_signal_row(int(j)) for j in row_lists[i]]
        sig = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int16)
        yield {
            "read_id": rid,
            "signal": sig,
            "calibration_offset": float(offs[i]),
            "calibration_scale": float(scales[i]),
        }


# ---------------------------------------------------------------------------
# Container write (test fixture / converter)
# ---------------------------------------------------------------------------

def _arrow_file_bytes(table) -> bytes:
    import pyarrow as pa
    import pyarrow.ipc as ipc

    sink = pa.BufferOutputStream()
    with ipc.new_file(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def write_pod5(
    path: str,
    reads: list,
    calibration_offset: float = 10.0,
    calibration_scale: float = 0.1755,
    compress: bool = True,
    chunk: int = SIGNAL_CHUNK,
) -> None:
    """Write reads = [(read_id, raw int16 signal)] as a POD5 container with
    spec-shaped reads + signal tables and a FlatBuffer footer.  read_id may be
    a UUID string or arbitrary name (hashed to a stable UUID)."""
    import pyarrow as pa

    rid_bytes, sig_row_ids, cal_off, cal_scale = [], [], [], []
    srow_rid, srow_sig, srow_samples = [], [], []
    for name, raw in reads:
        raw = np.ascontiguousarray(raw, dtype=np.int16)
        try:
            rid = uuid.UUID(str(name))
        except ValueError:
            rid = uuid.uuid5(uuid.NAMESPACE_OID, str(name))
        rid_bytes.append(rid.bytes)
        rows = []
        for s in range(0, max(1, raw.shape[0]), chunk):
            part = raw[s : s + chunk]
            rows.append(len(srow_rid))
            srow_rid.append(rid.bytes)
            srow_samples.append(part.shape[0])
            srow_sig.append(vbz_encode_signal(part) if compress else part)
        sig_row_ids.append(rows)
        cal_off.append(np.float32(calibration_offset))
        cal_scale.append(np.float32(calibration_scale))

    reads_tbl = pa.table(
        {
            "read_id": pa.array(rid_bytes, type=pa.binary(16)),
            "signal": pa.array(sig_row_ids, type=pa.list_(pa.uint64())),
            "read_number": pa.array(range(len(reads)), type=pa.uint32()),
            "calibration_offset": pa.array(cal_off, type=pa.float32()),
            "calibration_scale": pa.array(cal_scale, type=pa.float32()),
        }
    )
    if compress:
        sig_arr = pa.array(srow_sig, type=pa.large_binary())
    else:
        sig_arr = pa.array([s.tolist() for s in srow_sig], type=pa.list_(pa.int16()))
    signal_tbl = pa.table(
        {
            "read_id": pa.array(srow_rid, type=pa.binary(16)),
            "signal": sig_arr,
            "samples": pa.array(srow_samples, type=pa.uint32()),
        }
    )

    file_id = str(uuid.uuid5(uuid.NAMESPACE_OID, path))
    marker = uuid.UUID(file_id).bytes
    out = bytearray()
    out += SIGNATURE
    out += marker
    contents = []
    for tbl, ctype in ((reads_tbl, CONTENT_READS_TABLE), (signal_tbl, CONTENT_SIGNAL_TABLE)):
        blob = _arrow_file_bytes(tbl)
        contents.append((len(out), len(blob), FORMAT_FEATHER_V2, ctype))
        out += blob
        out += b"\x00" * (-len(blob) % 8)
        out += marker
    footer = build_footer(contents, file_id)
    out += footer
    out += struct.pack("<q", len(footer))
    out += marker
    out += SIGNATURE
    with open(path, "wb") as f:
        f.write(bytes(out))
