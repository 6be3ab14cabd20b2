"""The PyTorch port's wire codec against hyperopt_tpu's.

The frames must be byte-identical: the same payload encodes to the same
bytes in both packages (every ``CODEC_FIXTURES`` entry and seeded random
batches of trial docs with NaN, +-Inf, float32 subnormals and the 2**24
+- 1 lattice edge), and each package decodes the other's frames to equal
values.  Mirrors ``tests/test_wire.py::TestCodec``, ``TestFloatParity``
and ``TestSafeLoads`` on the port, and pins the wire mode's setter.
"""

import json
import math
import os
import pickle
import struct

import numpy as np
import pytest

from hyperopt_tpu import wire as jwire
from hyperopt_tpu.parallel.netstore import safe_loads as jax_safe_loads
from hyperopt_tpu_torch import base, wire
from hyperopt_tpu_torch.base import JOB_STATE_DONE, STATUS_OK
from hyperopt_tpu_torch.parallel.netstore import safe_loads


def _mk_docs(tids, exp_key, xs):
    docs = []
    for tid, x in zip(tids, xs):
        d = base.new_trial_doc(tid, exp_key, None)
        d["misc"]["idxs"] = {"x": [tid]}
        d["misc"]["vals"] = {"x": [float(x)]}
        docs.append(d)
    return docs


def _complete(doc, loss):
    doc["state"] = JOB_STATE_DONE
    doc["result"] = {"status": STATUS_OK, "loss": float(loss)}
    return doc


def _bits(x):
    """``x`` with every float replaced by its f64 bit pattern, so that
    equality is bit equality (NaN included) and types count."""
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_bits(v) for v in x]
    if isinstance(x, float):
        return ("f", struct.pack("<d", x))
    return (type(x).__name__, x)


_EDGE_FLOATS = [
    float("nan"), float("inf"), float("-inf"),
    0.0, -0.0, 1.0, -1.0,
    float(np.float32(2.0 ** -149)), float(np.float32(2.0 ** -126)),
    1e-45, 5e-324,
    float(2 ** 24 - 1), float(2 ** 24), float(2 ** 24 + 1),
    -float(2 ** 24 + 1),
    0.1, 0.30000000000000004, 1.0 / 3.0,
]


def _random_docs(seed, n):
    """Trial docs of mixed structure: conditional parameters (two
    signatures), f32 draws, the edge floats spliced in, ints past the
    f32 lattice, None/str/bool leaves and empty containers."""
    rng = np.random.default_rng(seed)
    docs = []
    for tid in range(n):
        x = float(np.float32(rng.standard_normal()))
        if rng.random() < 0.3:
            x = _EDGE_FLOATS[int(rng.integers(len(_EDGE_FLOATS)))]
        loss = float(rng.choice([x * x, float("nan"), float("inf"),
                                 float(np.float32(rng.random()))]))
        d = base.new_trial_doc(tid, "e", None)
        d["misc"]["vals"] = {"x": [x]}
        d["misc"]["idxs"] = {"x": [tid]}
        if rng.random() < 0.5:
            d["misc"]["vals"]["lr"] = [float(np.exp(rng.normal()))]
            d["misc"]["idxs"]["lr"] = [tid]
        else:
            d["misc"]["vals"]["lr"] = []
            d["misc"]["idxs"]["lr"] = []
        d["state"] = int(rng.integers(0, 4))
        d["owner"] = None if rng.random() < 0.5 else f"w{tid % 3}"
        d["result"] = {"status": STATUS_OK, "loss": loss,
                       "big": int(2 ** 24 + int(rng.integers(-2, 3))),
                       "ok": bool(rng.random() < 0.5), "extra": {}}
        d["book_time"] = 1.7e9 + float(rng.random())
        docs.append(d)
    return docs


# ---------------------------------------------------------------------------
# byte identity with the JAX package, and decoding across packages
# ---------------------------------------------------------------------------


class TestAgainstJax:
    def test_catalogs_are_the_jax_package_s(self):
        assert wire.FRAMED_VERBS == jwire.FRAMED_VERBS
        assert (wire.MAGIC, wire.VERSION, wire.CONTENT_TYPE) \
            == (jwire.MAGIC, jwire.VERSION, jwire.CONTENT_TYPE)
        assert json.dumps(wire.CODEC_FIXTURES, sort_keys=True) \
            == json.dumps(jwire.CODEC_FIXTURES, sort_keys=True)

    @pytest.mark.parametrize("verb", sorted(jwire.CODEC_FIXTURES))
    def test_fixtures_encode_to_the_same_bytes(self, verb):
        for direction in ("req", "reply"):
            payload = jwire.CODEC_FIXTURES[verb][direction]
            assert wire.encode(payload) == jwire.encode(payload), \
                (verb, direction)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_random_doc_batches_encode_to_the_same_bytes(self, seed):
        docs = _random_docs(seed, 40 + 7 * seed)
        for payload in ({"docs": docs}, {"docs": docs[:1]}, docs,
                        {"verb": "insert_docs", "exp_key": "e",
                         "docs": docs, "idem": "k"}):
            assert wire.encode(payload) == jwire.encode(payload)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_each_package_decodes_the_other_s_frames(self, seed):
        docs = _random_docs(100 + seed, 33)
        payload = {"docs": docs, "cursor": [0, 7], "full": False}
        want = _bits(json.loads(json.dumps(payload)))
        assert _bits(wire.decode(jwire.encode(payload))) == want
        assert _bits(jwire.decode(wire.encode(payload))) == want

    def test_safe_loads_agrees_with_jax(self):
        for p in ({"a": [1, 2.5, "s"]}, {1, 2}, bytearray(b"xy"),
                  np.arange(4, dtype=np.float32), np.int64(-3)):
            blob = pickle.dumps(p)
            got, want = safe_loads(blob), jax_safe_loads(blob)
            if isinstance(p, np.ndarray):
                assert got.tobytes() == want.tobytes()
            else:
                assert got == want
        for p in (_EvilPayload(), getattr):
            blob = pickle.dumps(p)
            for fn in (safe_loads, jax_safe_loads):
                with pytest.raises(pickle.UnpicklingError):
                    fn(blob)


class TestMode:
    def test_setter_spellings(self):
        prev = wire.set_mode("json")
        try:
            assert prev == "auto" and wire.mode() == "json"
            assert wire.set_mode(" Binary ") == "json"
            assert wire.mode() == "binary"
        finally:
            wire.set_mode(prev)
        assert wire.mode() == "auto"

    @pytest.mark.parametrize("bad", ["", "frames", "msgpack", "jsonx"])
    def test_other_spellings_raise(self, bad):
        with pytest.raises(ValueError, match="wire mode"):
            wire.set_mode(bad)
        assert wire.mode() == "auto"


# ---------------------------------------------------------------------------
# mirrors of tests/test_wire.py on the port
# ---------------------------------------------------------------------------


class TestCodec:
    def test_every_framed_verb_has_a_fixture(self):
        assert set(wire.CODEC_FIXTURES) == set(wire.FRAMED_VERBS)
        for verb, fx in wire.CODEC_FIXTURES.items():
            assert "req" in fx and "reply" in fx, verb

    def test_fixtures_round_trip_both_directions(self):
        for verb, fx in wire.CODEC_FIXTURES.items():
            for direction in ("req", "reply"):
                payload = fx[direction]
                buf = wire.encode(payload)
                assert wire.is_frame(buf), (verb, direction)
                assert wire.decode(buf) == json.loads(
                    json.dumps(payload)), (verb, direction)

    def test_columnar_pack_preserves_key_order_and_identity(self):
        docs = _mk_docs([0, 1, 2, 3], "e", [0.1, 0.2, 0.3, 0.4])
        docs[2] = _complete(docs[2], 1.5)
        out = wire.decode(wire.encode({"docs": docs}))
        assert out == {"docs": docs}
        assert list(out["docs"][0]) == list(docs[0])

    def test_marker_keys_in_user_payloads_are_escaped(self):
        evil = [{"__seg__": 0, "x": 1.0}, {"__recs__": [1], "x": 2.0},
                {"__lit__": {"a": 1}, "x": 3.0},
                {"__const__": 5, "__range__": [0, 2], "x": 4.0}]
        assert wire.decode(wire.encode({"docs": evil})) == {"docs": evil}

    def test_const_container_columns_do_not_alias(self):
        docs = [{"tid": i, "vals": {}, "row": []} for i in range(4)]
        out = wire.decode(wire.encode(docs))
        out[0]["vals"]["k"] = 1
        out[0]["row"].append(9)
        assert out[1]["vals"] == {} and out[1]["row"] == []

    def test_non_json_payload_raises_not_corrupts(self):
        with pytest.raises(TypeError):
            wire.encode({"x": object()})

    def test_bad_frames_raise_wire_error(self):
        good = wire.encode({"a": 1})
        for bad in (b"", b"HTW", b"XXXX" + good[4:], good[:-1],
                    good[:4] + b"\xff\xff" + good[6:]):
            with pytest.raises(wire.WireError):
                wire.decode(bad)

    def test_is_frame_rejects_json_bodies(self):
        assert not wire.is_frame(b'{"verb": "docs"}')
        assert not wire.is_frame(b"")


class TestFloatParity:
    @pytest.mark.parametrize("v", _EDGE_FLOATS,
                             ids=[repr(v) for v in _EDGE_FLOATS])
    def test_json_line_and_frame_land_identical_bits(self, v):
        doc = {"result": {"loss": v, "status": STATUS_OK},
               "misc": {"vals": {"x": [v]}}}
        record = {"verb": "write_result", "doc": doc}
        via_json = json.loads(json.dumps(record))
        via_frame = wire.decode(wire.encode(record))
        for out in (via_json, via_frame):
            got = out["doc"]["result"]["loss"]
            assert struct.pack("<d", got) == struct.pack("<d", v)
            gv = out["doc"]["misc"]["vals"]["x"][0]
            assert (struct.pack("<f", np.float32(gv))
                    == struct.pack("<f", np.float32(v)))

    def test_random_f32_batch_survives_columnar_segments(self):
        rng = np.random.default_rng(19)
        xs = rng.standard_normal(64).astype(np.float32)
        docs = [_complete(_mk_docs([i], "e", [float(x)])[0], float(x) ** 2)
                for i, x in enumerate(xs)]
        out = wire.decode(wire.encode({"docs": docs}))
        got = np.asarray([d["misc"]["vals"]["x"][0] for d in out["docs"]],
                         dtype=np.float32)
        assert got.tobytes() == xs.tobytes()

    def test_nan_survives_columnar_collapse(self):
        docs = [{"tid": i, "loss": float("nan")} for i in range(3)]
        out = wire.decode(wire.encode(docs))
        assert all(math.isnan(d["loss"]) for d in out)


class _EvilPayload:
    """A classic pickle gadget: unpickling calls the reduce target."""

    def __reduce__(self):
        return (os.system, ("echo pwned",))


class TestSafeLoads:
    def test_malicious_reduce_payload_is_refused(self):
        blob = pickle.dumps(_EvilPayload())
        with pytest.raises(pickle.UnpicklingError, match="forbidden global"):
            safe_loads(blob)

    def test_even_harmless_stdlib_callables_are_refused(self):
        with pytest.raises(pickle.UnpicklingError):
            safe_loads(pickle.dumps(getattr))

    def test_benign_attachment_shapes_round_trip(self):
        payloads = [
            {"a": [1, 2.5, "s", None, True], "b": (3, 4)},
            {1, 2, 3}, frozenset([4]), bytearray(b"xy"), range(5),
            complex(1, 2),
            np.arange(6, dtype=np.float32).reshape(2, 3),
            np.float64(0.25), np.int64(-7),
        ]
        for p in payloads:
            got = safe_loads(pickle.dumps(p))
            if isinstance(p, np.ndarray):
                assert got.dtype == p.dtype and got.tobytes() == p.tobytes()
            else:
                assert got == p
