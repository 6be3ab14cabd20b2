"""Device-runtime telemetry: device memory held by resident histories and
lane stacks, and kernel-cache occupancy.

Counterpart of ``hyperopt_tpu/obs/device.py``.  :func:`collect` walks, on
demand (nothing on the hot path is instrumented):

* the solo resident rings of ``history._STORE``: ``device.hbm.
  resident_bytes`` / ``resident_rings``, ``cap × row_bytes(p)`` per ring
  (the accounting of ``history.upload_bytes``);
* the lane stacks: the cohorts' batched rings (``history._BATCHED``,
  ``B × cap × row_bytes(p)`` each) and the buffers of the device-mode
  segments that running ``fleet.fmin_fleet`` calls step (their handles
  in ``fleet._LANE_STACKS``): ``device.hbm.lane_stack_bytes`` /
  ``lane_stacks``;
* ``device.kernel_cache.entries``: distinct kernel-cache keys seen by
  ``metrics.kernel_cache_stats``.
"""

from __future__ import annotations

import sys

from . import metrics as _metrics

__all__ = ["collect", "report"]


def _ring_bytes():
    """(n_rings, total_bytes, n_stacks, stack_bytes) under history._LOCK."""
    from .. import history as _hist

    rings = ring_b = stacks = stack_b = 0
    with _hist._LOCK:
        for states in list(_hist._STORE.values()):
            for res in list(states.values()):
                rings += 1
                ring_b += int(res.cap) * _hist._row_bytes(
                    int(res.bufs[0].shape[-1]))
    for st in list(_hist._BATCHED):
        stacks += 1
        stack_b += int(st.b) * int(st.cap) * _hist._row_bytes(int(st.p))
    # A process that never imported the fleet runs no fmin_fleet, and the
    # report must not import it just to say so.
    fleet = sys.modules.get("hyperopt_tpu_torch.fleet")
    if fleet is not None:
        for h in list(fleet._LANE_STACKS):
            stacks += 1
            stack_b += int(h.nbytes)
    return rings, ring_b, stacks, stack_b


def report() -> dict:
    """Point-in-time device-runtime report (no gauges touched)."""
    rings, ring_b, stacks, stack_b = _ring_bytes()
    kc = _metrics.kernel_cache_stats()
    return {
        "resident_rings": rings,
        "resident_bytes": ring_b,
        "lane_stacks": stacks,
        "lane_stack_bytes": stack_b,
        "kernel_cache": {
            "entries": len(kc.get("by_key", {})),
            "requests": kc.get("requests", 0),
            "misses": kc.get("misses", 0),
        },
    }


def collect(reg=None) -> dict:
    """Compute :func:`report` and publish it as gauges on ``reg``
    (default: the process registry)."""
    reg = reg if reg is not None else _metrics.registry()
    rep = report()
    reg.gauge("device.hbm.resident_bytes").set(rep["resident_bytes"])
    reg.gauge("device.hbm.resident_rings").set(rep["resident_rings"])
    reg.gauge("device.hbm.lane_stack_bytes").set(rep["lane_stack_bytes"])
    reg.gauge("device.hbm.lane_stacks").set(rep["lane_stacks"])
    reg.gauge("device.kernel_cache.entries").set(
        rep["kernel_cache"]["entries"])
    return rep
