"""Self-contained postmortem bundles: freeze telemetry to a directory.

Counterpart of ``hyperopt_tpu/obs/bundle.py``, with the same on-disk form,
so the JAX package's readers load the port's bundles:

* ``MANIFEST.json``: schema version, dump reason, process identity, the
  trace id, event counts (emitted / dropped / captured), the sections;
* ``loop_events.jsonl``: the event ring with its meta clock-anchor header,
  as a Tracer dumps it;
* ``metrics.json`` (registry snapshot with mergeable histogram states),
  ``device.json`` (``obs/device.py``), ``costs.json`` (the cost ledger)
  and ``env.json``: the process's configuration variables (names starting
  with one of :data:`_ENV_PREFIXES`), token-bearing values redacted
  before they reach disk;
* provider sections registered with :func:`register_provider` (device
  mode's ``device_telemetry``).

:func:`read_bundle` loads a directory back into the payload dict.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

from . import context as _context
from . import costs as _costs
from . import device as _device
from . import metrics as _metrics
from .events import EVENTS

__all__ = [
    "BUNDLE_SCHEMA",
    "collect_payload",
    "read_bundle",
    "register_provider",
    "unregister_provider",
    "write_bundle",
    "write_payload",
]

BUNDLE_SCHEMA = 1

#: Section name -> zero-arg callable returning a JSON-able payload.
_PROVIDERS: dict = {}
_PROVIDERS_LOCK = threading.Lock()

#: Env keys snapshotted into env.json (config provenance).
_ENV_PREFIXES = ("HYPEROPT_", "TORCH_", "PYTORCH_", "CUDA_")
#: Key substrings whose values never reach disk.
_REDACT_MARKERS = ("TOKEN", "SECRET", "PASSWORD", "CREDENTIAL", "APIKEY",
                   "API_KEY", "AUTH")


def register_provider(name: str, fn) -> None:
    """Register a bundle section source (state the module globals cannot
    see).  Last registration per name wins."""
    with _PROVIDERS_LOCK:
        _PROVIDERS[name] = fn


def unregister_provider(name: str) -> None:
    with _PROVIDERS_LOCK:
        _PROVIDERS.pop(name, None)


def _redacted_env() -> dict:
    out = {}
    for k in sorted(os.environ):
        if not k.startswith(_ENV_PREFIXES):
            continue
        ku = k.upper()
        if any(m in ku for m in _REDACT_MARKERS):
            out[k] = "<redacted>"
        else:
            out[k] = os.environ[k]
    return out


def state_hash(data: bytes) -> str:
    """Short stable content hash for store-state cross-checks."""
    return hashlib.sha256(data).hexdigest()[:16]


def collect_payload(reason: str, extra: dict | None = None) -> dict:
    """Gather every section in memory (:func:`write_bundle`'s input)."""
    meta = EVENTS.meta()
    events = EVENTS.snapshot()
    with _PROVIDERS_LOCK:
        providers = dict(_PROVIDERS)
    payload = {
        "manifest": {
            "schema": BUNDLE_SCHEMA,
            "reason": reason,
            "pid": meta.get("pid"),
            "host": meta.get("host"),
            "trace_id": meta.get("trace_id"),
            "n_events": len(events),
            "n_emitted": EVENTS.n_emitted,
            "n_dropped": EVENTS.n_dropped,
            "sections": [],
            "extra": extra or {},
        },
        "events": [{"type": "meta", **meta,
                    "n_dropped": EVENTS.n_dropped}] + events,
        "metrics": _metrics.registry().snapshot(states=True),
        "env": _redacted_env(),
    }
    for name, fn in (("device", _device.report),
                     ("costs", _costs.ledger_report)):
        try:
            payload[name] = fn()
        except Exception as e:   # a sick section must not sink the dump
            payload[name] = {"error": f"{type(e).__name__}: {e}"}
    if not payload["manifest"]["trace_id"] and _context._armed:
        cur = _context.current()
        if cur and cur.get("trace_id"):
            payload["manifest"]["trace_id"] = cur["trace_id"]
    for name, fn in sorted(providers.items()):
        try:
            payload[name] = fn()
        except Exception as e:   # a sick provider must not sink the dump
            payload[name] = {"error": f"{type(e).__name__}: {e}"}
    payload["manifest"]["sections"] = sorted(
        k for k in payload if k != "manifest")
    return payload


def write_payload(out_dir: str, payload: dict) -> str:
    """Write a payload dict as a bundle directory."""
    os.makedirs(out_dir, exist_ok=True)
    events = payload.get("events") or []
    with open(os.path.join(out_dir, "loop_events.jsonl"), "w") as fh:
        for rec in events:
            fh.write(json.dumps(rec) + "\n")
    for name, doc in payload.items():
        if name == "events":
            continue
        fname = "MANIFEST.json" if name == "manifest" else f"{name}.json"
        with open(os.path.join(out_dir, fname), "w") as fh:
            json.dump(doc, fh, indent=1, default=str)
            fh.write("\n")
    return out_dir


def write_bundle(out_dir: str, reason: str,
                 extra: dict | None = None) -> str:
    """Freeze the current telemetry into ``out_dir``; returns it."""
    return write_payload(out_dir, collect_payload(reason, extra=extra))


def read_bundle(bundle_dir: str) -> dict:
    """Load a bundle directory back into its payload dict."""
    payload = {}
    ev_path = os.path.join(bundle_dir, "loop_events.jsonl")
    if os.path.exists(ev_path):
        events = []
        with open(ev_path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    events.append(json.loads(line))
        payload["events"] = events
    for fname in sorted(os.listdir(bundle_dir)):
        if not fname.endswith(".json"):
            continue
        name = ("manifest" if fname == "MANIFEST.json"
                else fname[:-len(".json")])
        try:
            with open(os.path.join(bundle_dir, fname)) as fh:
                payload[name] = json.load(fh)
        except ValueError:
            payload[name] = None
    if "manifest" not in payload:
        raise FileNotFoundError(
            f"{bundle_dir}: no MANIFEST.json — not a flight bundle")
    return payload
