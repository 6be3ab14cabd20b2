"""Columnar binary wire codec: the network store's frame format.

Counterpart of ``hyperopt_tpu/wire.py``, byte for byte: the same payload
encodes to the same frame in both packages, so a server of one and a
client of the other understand each other.  A JSON-shaped payload packs
into a versioned little-endian frame:

    offset 0   magic        b"HTW1"              (4 bytes)
    offset 4   version      u16 LE               (currently 1)
    offset 6   reserved     u16 LE               (0)
    offset 8   header_len   u32 LE
    offset 12  header       UTF-8 JSON skeleton  (header_len bytes)
    ...        segments     raw ndarray bytes, concatenated in order

The header is the payload with its bulk numeric content hoisted out into
the segments:

* Lists of dicts (trial docs) are grouped by structure signature, the
  ordered tuple of (leaf path, leaf kind) of a depth-first walk.  Per
  group, float leaves become one ``<f8`` segment column and int leaves
  one ``<i8`` column; strings, bools, ``None`` and empty containers stay
  as JSON columns in the header.  First-seen path order is kept, so
  decoded dicts have the key order of the originals.
* Decoding gives plain Python values equal, bit for bit, to what
  ``json.loads(json.dumps(payload))`` gives: the f64 segments carry NaN,
  +-Inf and every float bit pattern exactly.

Negotiation: requests carry ``Content-Type: application/x-hyperopt-frame``
and servers sniff the magic bytes; a reply is framed iff its request was.
:func:`set_mode` picks the client mode (``"auto"`` by default): ``auto``
falls back to JSON for a peer on the first framed request that peer
refuses (counting ``wire.json_fallbacks``), ``binary`` never does, and
``json`` neither sends frames nor (on a server) accepts them.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = [
    "MAGIC", "VERSION", "CONTENT_TYPE", "FRAMED_VERBS", "CODEC_FIXTURES",
    "WireError", "mode", "set_mode", "is_frame", "encode", "decode",
]

MAGIC = b"HTW1"
VERSION = 1
CONTENT_TYPE = "application/x-hyperopt-frame"
_HDR = struct.Struct("<4sHHI")

# Verbs whose request/reply bodies ride the binary frame when the wire
# mode allows it.  Every framed verb has a request and a reply in
# CODEC_FIXTURES below.
_FRAMED_VERBS = frozenset({
    "insert_docs",       # bulk doc upload (client -> server)
    "docs",              # full history fetch (server -> client)
    "fetch_since",       # delta history fetch (server -> client)
    "wal_ship",          # primary -> replica WAL record batches
    "snapshot_install",  # primary -> replica full-state install
})
FRAMED_VERBS = _FRAMED_VERBS


class WireError(ValueError):
    """Malformed or unsupported binary frame."""


_MODES = ("auto", "json", "binary")
_MODE = "auto"


def mode() -> str:
    """The wire mode: ``"auto"``, ``"json"`` or ``"binary"``."""
    return _MODE


def set_mode(name: str) -> str:
    """Set the wire mode: ``"auto"``, ``"json"`` or ``"binary"``.
    Returns the previous mode."""
    global _MODE
    key = str(name).strip().lower()
    if key not in _MODES:
        raise ValueError(f"wire mode must be one of {_MODES}, got {name!r}")
    prev, _MODE = _MODE, key
    return prev


def is_frame(raw: bytes) -> bool:
    return isinstance(raw, (bytes, bytearray)) and raw[:4] == MAGIC


# -- columnar packing ---------------------------------------------------------
#
# Header skeleton markers (reserved keys, escaped via __lit__ when a user
# dict happens to contain one):
#   {"__seg__": i}                     scalar column hoisted to segment i
#   {"__recs__": [...], "__n__": n}    columnarized list-of-dicts
#   {"__lit__": {...}}                 verbatim dict that contained a marker

_MARKERS = ("__seg__", "__recs__", "__lit__")

# Leaf kinds: "f" -> <f8 segment, "i" -> <i8 segment, "o" -> JSON column.
_I64_MIN, _I64_MAX = -(2 ** 63), 2 ** 63 - 1


def _flatten(doc: dict, out: List[Tuple[tuple, str, Any]]) -> None:
    """Depth-first leaf walk.  Path elements: str = dict key, int = list
    index (JSON dict keys are always str, so this is unambiguous).
    Raises TypeError on non-JSON values — the caller then falls back to
    leaving that list uncolumnarized."""
    def walk(x, path):
        if isinstance(x, dict):
            if x:
                for k, v in x.items():
                    if not isinstance(k, str):
                        raise TypeError("non-str dict key")
                    walk(v, path + (k,))
            else:
                out.append((path, "o", {}))
        elif isinstance(x, list):
            if x:
                for i, v in enumerate(x):
                    walk(v, path + (i,))
            else:
                out.append((path, "o", []))
        elif type(x) is bool or x is None or isinstance(x, str):
            out.append((path, "o", x))
        elif isinstance(x, float):
            out.append((path, "f", x))
        elif isinstance(x, int):
            if _I64_MIN <= x <= _I64_MAX:
                out.append((path, "i", x))
            else:
                out.append((path, "o", x))
        else:
            raise TypeError(f"non-JSON leaf {type(x).__name__}")
    walk(doc, ())


def _set_path(root: dict, path: tuple, val: Any) -> None:
    """Materialize ``val`` at ``path``; containers are created on demand
    (next element str -> dict, int -> list).  List indices arrive in
    increasing order per parent, so list growth is append-only."""
    cur = root
    for i, el in enumerate(path[:-1]):
        nxt_el = path[i + 1]
        fresh = {} if isinstance(nxt_el, str) else []
        if isinstance(el, str):
            if el not in cur:
                cur[el] = fresh
            cur = cur[el]
        else:
            if el == len(cur):
                cur.append(fresh)
            cur = cur[el]
    last = path[-1]
    if isinstance(last, str):
        cur[last] = val
    else:
        if last == len(cur):
            cur.append(val)
        else:
            cur[last] = val


def _pack_records(recs: List[dict], segs: List[np.ndarray]):
    """Columnarize a list of dicts, grouped by structure signature."""
    flat = []
    for r in recs:
        leaves: List[Tuple[tuple, str, Any]] = []
        _flatten(r, leaves)
        flat.append(leaves)
    groups: Dict[tuple, dict] = {}
    for j, leaves in enumerate(flat):
        sig = tuple((path, kind) for path, kind, _ in leaves)
        g = groups.get(sig)
        if g is None:
            g = groups[sig] = {"rows": [], "cols": [[] for _ in sig]}
        g["rows"].append(j)
        cols = g["cols"]
        for c, (_, _, val) in enumerate(leaves):
            cols[c].append(val)
    out_groups = []
    for sig, g in groups.items():
        enc_cols = []
        for (path, kind), col in zip(sig, g["cols"]):
            const = _const_of(col, kind)
            if const is not None:
                enc_cols.append({"__const__": const[0]})
            elif kind == "f":
                segs.append(np.asarray(col, dtype="<f8"))
                enc_cols.append({"__seg__": len(segs) - 1})
            elif kind == "i":
                segs.append(np.asarray(col, dtype="<i8"))
                enc_cols.append({"__seg__": len(segs) - 1})
            else:
                enc_cols.append(col)
        rows = g["rows"]
        if rows == list(range(rows[0], rows[0] + len(rows))):
            rows = {"__range__": [rows[0], len(rows)]}
        out_groups.append({
            "sig": [[list(path), kind] for path, kind in sig],
            "rows": rows,
            "cols": enc_cols,
        })
    return {"__recs__": out_groups, "__n__": len(recs)}


def _const_of(col: list, kind: str):
    """(value,) when every entry of the column is the same value (float
    equality is by f64 bit pattern so NaN columns collapse too); else
    None.  The constant lands in the JSON header — exact for floats
    because Python's json repr round-trips every f64."""
    first = col[0]
    if kind == "f":
        b0 = struct.pack("<d", first)
        same = all(struct.pack("<d", v) == b0 for v in col)
    else:
        t0 = type(first)
        same = all(type(v) is t0 and v == first for v in col)
    return (first,) if same else None


def _pack(x: Any, segs: List[np.ndarray]) -> Any:
    if isinstance(x, dict):
        if any(m in x for m in _MARKERS):
            return {"__lit__": {k: _pack(v, segs) for k, v in x.items()}}
        return {k: _pack(v, segs) for k, v in x.items()}
    if isinstance(x, list):
        if len(x) >= 2 and all(type(e) is dict for e in x):
            try:
                return _pack_records(x, segs)
            except TypeError:
                pass  # non-JSON leaves: leave as a plain JSON list
        return [_pack(v, segs) for v in x]
    return x


def _unpack_records(node: dict, segs: List[np.ndarray]) -> List[dict]:
    n = node["__n__"]
    out: List[Any] = [None] * n
    for g in node["__recs__"]:
        sig = [(tuple(path), kind) for path, kind in g["sig"]]
        rows = g["rows"]
        if isinstance(rows, dict):
            start, cnt = rows["__range__"]
            rows = list(range(start, start + cnt))
        cols = []
        for (path, kind), col in zip(sig, g["cols"]):
            if isinstance(col, dict) and "__const__" in col:
                v = col["__const__"]
                if kind == "f":
                    cols.append([float(v)] * len(rows))
                elif kind == "i":
                    cols.append([int(v)] * len(rows))
                else:
                    # fresh container per row: empty-dict/list leaves must
                    # not alias across decoded docs
                    cols.append([v.copy() if isinstance(v, (dict, list))
                                 else v for _ in rows])
            elif kind == "f":
                cols.append([float(v) for v in segs[col["__seg__"]]])
            elif kind == "i":
                cols.append([int(v) for v in segs[col["__seg__"]]])
            else:
                cols.append(col)
        for idx, j in enumerate(rows):
            doc: dict = {}
            for (path, kind), col in zip(sig, cols):
                if path:
                    _set_path(doc, path, col[idx])
                # path == () only for the empty dict leaf: doc stays {}
            out[j] = doc
    return out


def _unpack(x: Any, segs: List[np.ndarray]) -> Any:
    if isinstance(x, dict):
        if "__lit__" in x:
            return {k: _unpack(v, segs) for k, v in x["__lit__"].items()}
        if "__recs__" in x:
            return _unpack_records(x, segs)
        if "__seg__" in x:
            return segs[x["__seg__"]].tolist()
        return {k: _unpack(v, segs) for k, v in x.items()}
    if isinstance(x, list):
        return [_unpack(v, segs) for v in x]
    return x


# -- frame assembly -----------------------------------------------------------

_DTYPES = {"<f8": np.dtype("<f8"), "<i8": np.dtype("<i8")}


def encode(payload: Any) -> bytes:
    """Pack a JSON-shaped payload into one binary frame."""
    segs: List[np.ndarray] = []
    body = _pack(payload, segs)
    header = {
        "body": body,
        "segs": [[arr.dtype.str, int(arr.size)] for arr in segs],
    }
    hraw = json.dumps(header, separators=(",", ":")).encode()
    parts = [_HDR.pack(MAGIC, VERSION, 0, len(hraw)), hraw]
    parts.extend(arr.tobytes() for arr in segs)
    return b"".join(parts)


def decode(raw: bytes) -> Any:
    """Reverse of :func:`encode`; raises :class:`WireError` on damage."""
    if len(raw) < _HDR.size:
        raise WireError("frame shorter than fixed header")
    magic, ver, _, hlen = _HDR.unpack_from(raw, 0)
    if magic != MAGIC:
        raise WireError("bad magic")
    if ver != VERSION:
        raise WireError(f"unsupported frame version {ver}")
    off = _HDR.size
    if len(raw) < off + hlen:
        raise WireError("truncated header")
    try:
        header = json.loads(raw[off:off + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"corrupt header: {e}") from None
    off += hlen
    segs: List[np.ndarray] = []
    for dtype_str, size in header.get("segs", []):
        dt = _DTYPES.get(dtype_str)
        if dt is None:
            raise WireError(f"unsupported segment dtype {dtype_str!r}")
        nbytes = int(size) * dt.itemsize
        if len(raw) < off + nbytes:
            raise WireError("truncated segment")
        segs.append(np.frombuffer(raw, dtype=dt, count=int(size),
                                  offset=off))
        off += nbytes
    return _unpack(header["body"], segs)


# -- shared codec fixtures ----------------------------------------------------
#
# One canonical request/reply body per framed verb, the same as the JAX
# package's; each round-trips through encode/decode in both directions.

_DOC = {
    "tid": 7, "exp_key": "default", "state": 2, "owner": None,
    "spec": None,
    "result": {"loss": 0.125, "status": "ok"},
    "misc": {"tid": 7, "cmd": ["domain_attachment", "FMinIter_Domain"],
             "idxs": {"x": [7]}, "vals": {"x": [0.5]}},
    "book_time": 1700000000.0, "refresh_time": 1700000001.0,
}

CODEC_FIXTURES = {
    "insert_docs": {
        "req": {"verb": "insert_docs", "exp_key": "default",
                "docs": [_DOC, dict(_DOC, tid=8)]},
        "reply": {"tids": [7, 8]},
    },
    "docs": {
        "req": {"verb": "docs", "exp_key": "default"},
        "reply": {"docs": [_DOC, dict(_DOC, tid=8)]},
    },
    "fetch_since": {
        "req": {"verb": "fetch_since", "exp_key": "default",
                "cursor": [0, 12]},
        "reply": {"docs": [_DOC], "cursor": [0, 14], "full": False},
    },
    "wal_ship": {
        "req": {"verb": "wal_ship", "from_seq": 3,
                "records": [{"seq": 4, "t": 1700000000.0, "tenant": "t0",
                             "verb": "insert_docs",
                             "req": {"docs": [_DOC]}}]},
        "reply": {"applied": 1, "seq": 4},
    },
    "snapshot_install": {
        "req": {"verb": "snapshot_install", "seq": 9,
                "snapshot": {"seq": 9, "stores": [
                    {"tenant": "t0", "exp_key": "default",
                     "state": {"docs": [_DOC], "claims": {},
                               "allocated": [7]}}]}},
        "reply": {"ok": True, "seq": 9},
    },
}
