"""The PyTorch port's service building blocks against hyperopt_tpu's.

``service/cluster.py``: ``key_hash`` equals JAX's on 10,000 keys, and
``HashRing`` and ``ShardMap`` place the same keys on the same shards as
JAX at the default vnodes and at another count, through adds and
removes, pins and promotions.  ``service/tenancy.py``: the
``TenantTable`` cases of ``tests/test_service.py::TestTenancy``.
"""

import hmac
import json
from unittest import mock

import numpy as np
import pytest

from hyperopt_tpu.service import cluster as jcluster
from hyperopt_tpu_torch.service import (
    DEFAULT_VNODES,
    HashRing,
    ShardMap,
    Tenant,
    TenantTable,
    TokenBucket,
    key_hash,
)


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    tenants = [None, "", "acme", "bob", "t/x", "ünï"]
    return [(tenants[int(rng.integers(len(tenants)))],
             f"exp-{int(rng.integers(1 << 40)):x}-{i}") for i in range(n)]


def test_key_hash_equals_jax_on_10000_keys():
    keys = _keys(10_000)
    got = [key_hash(t, k) for t, k in keys]
    assert got == [jcluster.key_hash(t, k) for t, k in keys]
    assert key_hash("ab", "c") != key_hash("a", "bc")
    assert DEFAULT_VNODES == jcluster.DEFAULT_VNODES


@pytest.mark.parametrize("vnodes", [None, 7])
def test_ring_places_keys_as_jax_through_adds_and_removes(vnodes):
    keys = _keys(2_000, seed=1)
    ring = HashRing(["s0", "s1", "s2"], virtual_nodes=vnodes)
    jring = jcluster.HashRing(["s0", "s1", "s2"], virtual_nodes=vnodes)
    assert ring.virtual_nodes == jring.virtual_nodes \
        == (DEFAULT_VNODES if vnodes is None else vnodes)
    steps = [("add", "s3"), ("add", "s4"), ("remove", "s1"),
             ("add", "s1"), ("remove", "s0"), ("remove", "s4")]
    for op, sid in [(None, None)] + steps:
        if op is not None:
            getattr(ring, op)(sid)
            getattr(jring, op)(sid)
        assert ring.shard_ids == jring.shard_ids
        assert [ring.owner(t, k) for t, k in keys] \
            == [jring.owner(t, k) for t, k in keys], (op, sid)


def test_ring_moves_few_keys_on_add():
    keys = _keys(2_000, seed=2)
    ring = HashRing([f"s{i}" for i in range(8)])
    before = [ring.owner(t, k) for t, k in keys]
    ring.add("s8")
    after = [ring.owner(t, k) for t, k in keys]
    moved = [a for a, b in zip(after, before) if a != b]
    assert set(moved) == {"s8"}
    assert len(moved) < len(keys) / 4


@pytest.mark.parametrize("vnodes", [None, 13])
def test_shard_map_places_and_serializes_as_jax(vnodes):
    keys = _keys(1_000, seed=3)
    shards = {f"s{i}": {"primary": f"http://h{i}:1/",
                        "replica": f"http://r{i}:2" if i % 2 else None}
              for i in range(3)}
    smap = ShardMap(shards, virtual_nodes=vnodes)
    jmap = jcluster.ShardMap(shards, virtual_nodes=vnodes)

    def same():
        assert json.dumps(smap.to_dict()) == json.dumps(jmap.to_dict())
        assert [smap.owner(t, k) for t, k in keys] \
            == [jmap.owner(t, k) for t, k in keys]

    same()
    for m in (smap, jmap):
        m.add_shard("s3", {"primary": "http://h3:1", "replica": None})
        m.pin("acme", keys[0][1], "s0")
        m.promote("s1")
    same()
    for m in (smap, jmap):
        m.remove_shard("s2")
        m.set_primary("s0", "http://moved:9/", replica="http://r:9")
    same()
    for m in (smap, jmap):
        m.clear_pins()
    same()
    back = ShardMap.from_dict(jmap.to_dict())
    assert back.to_dict() == smap.to_dict()
    assert [back.owner(t, k) for t, k in keys] \
        == [smap.owner(t, k) for t, k in keys]


def test_shard_map_refusals():
    smap = ShardMap({"s0": {"primary": "http://a"}})
    with pytest.raises(ValueError):
        smap.remove_shard("s0")
    with pytest.raises(ValueError):
        smap.promote("s0")
    with pytest.raises(ValueError):
        smap.pin(None, "e", "nope")
    with pytest.raises(ValueError):
        ShardMap({})
    with pytest.raises(ValueError):
        HashRing().owner(None, "e")


# ---------------------------------------------------------------------------
# tenancy: mirrors of tests/test_service.py::TestTenancy's table cases
# ---------------------------------------------------------------------------


def test_token_bucket():
    b = TokenBucket(rate=10.0, burst=2.0)
    assert b.take(2, now=0.0)
    assert not b.take(1, now=0.0)
    assert b.take(1, now=0.2)


def test_resolve_is_timing_safe_full_scan():
    tt = TenantTable([Tenant("a", "tok-a"), Tenant("b", "tok-b"),
                      Tenant("c", "tok-c")])
    with mock.patch("hmac.compare_digest",
                    wraps=hmac.compare_digest) as spy:
        assert tt.resolve("tok-a").name == "a"
        assert spy.call_count == 3
        spy.reset_mock()
        assert tt.resolve("nope") is None
        assert spy.call_count == 3


def test_bad_tenant_rejected():
    with pytest.raises(ValueError):
        Tenant("a/b", "tok")
    with pytest.raises(ValueError):
        Tenant("a", "")
    with pytest.raises(ValueError):
        TenantTable([Tenant("a", "x"), Tenant("a", "y")])


def test_admission_scale_and_table_file(tmp_path):
    t = Tenant("acme", "tok", trials_per_s=4.0)
    assert t.admit_trials(4) and not t.admit_trials(1)
    t.set_admission_scale(0.5)
    assert t.bucket.rate == 2.0 and t.bucket.burst == 2.0
    t.set_admission_scale(1.0)
    assert t.bucket.rate == 4.0
    assert "tok" not in repr(t)
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps([
        {"name": "acme", "token": "s1", "max_claims": 2},
        {"name": "bob", "token": "s2", "trials_per_s": 5, "burst": 3}]))
    tt = TenantTable.from_file(str(path))
    assert len(tt) == 2 and tt.resolve("s1").max_claims == 2
    assert tt.resolve("s2").bucket.burst == 3.0
