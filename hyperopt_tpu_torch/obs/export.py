"""Wire-correct OpenMetrics text exposition of the metrics registry.

Counterpart of ``hyperopt_tpu/obs/export.py`` (host code).
``render_openmetrics()`` turns a registry snapshot — or a metrics payload
with a fleet-merged view — into the OpenMetrics 1.0 text format for any
Prometheus-compatible scraper.  Names keep the JAX package's
``hyperopt_tpu_`` prefix, so dashboards read both packages alike.

Encoding rules:

* dotted registry names sanitize to Prometheus names
  (``netstore.verb.suggest.s`` → ``hyperopt_tpu_netstore_verb_suggest_s``);
* counters gain the mandated ``_total`` suffix; gauges export verbatim;
* the registry allows one dotted name to live in several typed tables
  at once (``tpe._obs_ms``: counter + histogram; ``pipeline.occupancy``:
  gauge + histogram) — OpenMetrics families cannot, so the histogram
  keeps the bare family name and a colliding counter exports as
  ``<name>_cumulative`` / a colliding gauge as ``<name>_current``
  (renames are computed over local and fleet views together so both
  scopes land in one family);
* histograms export as native histogram families —
  ``<name>_bucket{le="..."}`` with **cumulative** counts (registry
  states are per-bucket; the cumulative sum happens here), a ``+Inf``
  bucket, ``_count`` and ``_sum``;
* every sample carries a ``scope`` label: ``scope="local"`` for this
  process's registry, ``scope="fleet"`` for the exactly-merged
  fleet view (one family, two labeled series — the fleet-merged
  per-verb latency distributions are real histogram series a scraper
  can quantile over);
* the exposition ends with the mandatory ``# EOF`` line.

``parse_openmetrics()`` is the strict round-trip parser the test suite
uses: it enforces name grammar, TYPE-before-sample ordering,
type-appropriate suffixes, bucket monotonicity, ``+Inf``/``_count``
agreement, and the ``# EOF`` terminator — close to what a conformant
scraper would reject.
"""

from __future__ import annotations

import math
import re

__all__ = ["CONTENT_TYPE", "render_openmetrics", "parse_openmetrics",
           "sanitize_name", "wants_openmetrics", "histogram_groups",
           "histogram_quantile"]

#: Content type a negotiated ``GET /metrics`` reply carries.
CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

#: Accept-header substrings that select the text exposition over JSON.
ACCEPT_TOKENS = ("openmetrics-text", "text/plain")

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)(?:\s+(\S+))?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

_SUFFIXES = {"counter": ("_total",),
             "gauge": ("",),
             "histogram": ("_bucket", "_count", "_sum")}


def wants_openmetrics(accept: str) -> bool:
    """Content negotiation: does this ``Accept`` header pick the text
    exposition over the default JSON payload?"""
    accept = (accept or "").lower()
    return any(tok in accept for tok in ACCEPT_TOKENS)


def sanitize_name(name: str, prefix: str = "hyperopt_tpu") -> str:
    out = _SANITIZE_RE.sub("_", name)
    if prefix:
        out = f"{prefix}_{out}"
    if not _NAME_RE.match(out):
        out = "_" + out
    return out


def _fmt(v) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _esc(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(d: dict) -> str:
    if not d:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(d.items()))
    return "{" + inner + "}"


class _Family:
    def __init__(self, name, ftype):
        self.name, self.ftype = name, ftype
        self.lines = []

    def sample(self, suffix, labels, value):
        self.lines.append(
            f"{self.name}{suffix}{_labels(labels)} {_fmt(value)}")


def _scalar_renames(payload, prefix):
    """Sanitized names claimed by more than one typed table anywhere in
    the payload (local snapshot or fleet-merged view) — the registry's
    shared-name idiom (``_obs_ms`` counter+histogram,
    ``pipeline.occupancy`` gauge+histogram).  The histogram keeps the
    bare family name; returns the (counter, gauge) name sets that must
    rename at export."""
    snaps = [payload]
    merged = (payload.get("fleet") or {}).get("merged")
    if merged:
        snaps.append(merged)
    hists, counters, gauges = set(), set(), set()
    for snap in snaps:
        for name, h in (snap.get("histograms") or {}).items():
            if h.get("state"):
                hists.add(sanitize_name(name, prefix))
        for name in (snap.get("counters") or {}):
            counters.add(sanitize_name(name, prefix))
        for name in (snap.get("gauges") or {}):
            gauges.add(sanitize_name(name, prefix))
    return counters & (hists | gauges), gauges & (hists | counters)


def _scoped(families, snap, scope, prefix,
            renames=(frozenset(), frozenset())):
    """Fold one snapshot-shaped dict into the family table."""
    counter_renames, gauge_renames = renames
    for name, v in sorted(snap.get("counters", {}).items()):
        sname = sanitize_name(name, prefix)
        if sname in counter_renames:
            sname += "_cumulative"
        fam = _family(families, sname, "counter")
        fam.sample("_total", {"scope": scope}, v)
    for name, v in sorted(snap.get("gauges", {}).items()):
        sname = sanitize_name(name, prefix)
        if sname in gauge_renames:
            sname += "_current"
        fam = _family(families, sname, "gauge")
        fam.sample("", {"scope": scope}, v)
    for name, h in sorted(snap.get("histograms", {}).items()):
        st = h.get("state")
        if not st:
            continue
        fam = _family(families, sanitize_name(name, prefix), "histogram")
        cum = 0
        for i, c in enumerate(st["counts"]):
            cum += c
            le = (st["bounds"][i] if i < len(st["bounds"])
                  else float("inf"))
            fam.sample("_bucket", {"scope": scope, "le": _fmt(le)}, cum)
        fam.sample("_count", {"scope": scope}, st["count"])
        fam.sample("_sum", {"scope": scope}, st["sum"])
    kc = snap.get("kernel_cache")
    if kc:
        for key in ("requests", "misses"):
            fam = _family(families,
                          sanitize_name(f"kernel_cache.{key}", prefix),
                          "counter")
            fam.sample("_total", {"scope": scope}, kc.get(key, 0))


def _family(families, name, ftype):
    fam = families.get(name)
    if fam is None:
        fam = families[name] = _Family(name, ftype)
    elif fam.ftype != ftype:
        raise ValueError(f"family {name}: {fam.ftype} vs {ftype}")
    return fam


def render_openmetrics(payload: dict, prefix: str = "hyperopt_tpu") -> str:
    """Encode a ``metrics_payload()`` dict (or bare ``snapshot()``) as
    OpenMetrics text.  The local registry exports as ``scope="local"``;
    when a ``fleet.merged`` view is present it exports as
    ``scope="fleet"`` samples of the same families."""
    families: dict = {}
    renames = _scalar_renames(payload, prefix)
    _scoped(families, payload, "local", prefix, renames)
    merged = (payload.get("fleet") or {}).get("merged")
    if merged:
        _scoped(families, merged, "fleet", prefix, renames)
    out = []
    for name in sorted(families):
        fam = families[name]
        out.append(f"# TYPE {name} {fam.ftype}")
        out.extend(fam.lines)
    out.append("# EOF")
    return "\n".join(out) + "\n"


# -- strict parser (round-trip validation) ----------------------------------

def _parse_value(tok: str) -> float:
    if tok == "+Inf":
        return float("inf")
    if tok == "-Inf":
        return float("-inf")
    return float(tok)


def parse_openmetrics(text: str) -> dict:
    """Strictly parse an OpenMetrics exposition.

    Returns ``{family: {"type": t, "samples": [(suffix, labels, value)]}}``
    and raises ``ValueError`` on any grammar or semantic violation:
    missing ``# EOF``, samples before their TYPE, wrong suffix for the
    declared type, non-monotone histogram buckets, a ``+Inf`` bucket
    that disagrees with ``_count``, or duplicate sample keys.
    """
    lines = text.splitlines()
    if not lines or lines[-1] != "# EOF":
        raise ValueError("exposition must end with '# EOF'")
    families: dict = {}
    seen_samples = set()
    for ln, line in enumerate(lines[:-1], 1):
        if not line:
            raise ValueError(f"line {ln}: blank line inside exposition")
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("TYPE", "HELP", "UNIT"):
                raise ValueError(f"line {ln}: bad metadata line {line!r}")
            if parts[1] != "TYPE":
                continue
            name, ftype = parts[2], (parts[3] if len(parts) > 3 else "")
            if not _NAME_RE.match(name):
                raise ValueError(f"line {ln}: bad family name {name!r}")
            if ftype not in _SUFFIXES:
                raise ValueError(f"line {ln}: unknown type {ftype!r}")
            if name in families:
                raise ValueError(f"line {ln}: duplicate TYPE for {name}")
            families[name] = {"type": ftype, "samples": []}
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: unparsable sample {line!r}")
        sname, rawlabels, rawval = m.group(1), m.group(2) or "", m.group(3)
        labels = dict(_LABEL_RE.findall(rawlabels[1:-1])) if rawlabels \
            else {}
        fam_name, suffix = None, None
        for name, fam in families.items():
            for suf in _SUFFIXES[fam["type"]]:
                if sname == name + suf and (
                        fam_name is None or len(name) > len(fam_name)):
                    fam_name, suffix = name, suf
        if fam_name is None:
            raise ValueError(
                f"line {ln}: sample {sname!r} has no preceding TYPE "
                "(or wrong suffix for its family type)")
        key = (sname, tuple(sorted(labels.items())))
        if key in seen_samples:
            raise ValueError(f"line {ln}: duplicate sample {key}")
        seen_samples.add(key)
        families[fam_name]["samples"].append(
            (suffix, labels, _parse_value(rawval)))
    _validate_histograms(families)
    return families


def histogram_groups(fam: dict) -> dict:
    """Group a parsed histogram family's samples by non-``le`` labels:
    ``{labelset: {"buckets": [(le, cum)], "count": n, "sum": s}}``."""
    groups: dict = {}
    for suffix, labels, value in fam["samples"]:
        gkey = tuple(sorted((k, v) for k, v in labels.items()
                            if k != "le"))
        g = groups.setdefault(gkey, {"buckets": [], "count": None,
                                     "sum": None})
        if suffix == "_bucket":
            if "le" not in labels:
                raise ValueError("bucket sample missing le")
            g["buckets"].append((_parse_value(labels["le"]), value))
        elif suffix == "_count":
            g["count"] = value
        elif suffix == "_sum":
            g["sum"] = value
    return groups


def _validate_histograms(families: dict) -> None:
    for name, fam in families.items():
        if fam["type"] != "histogram":
            continue
        groups = histogram_groups(fam)
        for gkey, g in groups.items():
            if not g["buckets"]:
                raise ValueError(f"{name}{dict(gkey)}: no buckets")
            if g["count"] is None or g["sum"] is None:
                raise ValueError(f"{name}{dict(gkey)}: missing _count/_sum")
            les = [le for le, _ in g["buckets"]]
            if les != sorted(les) or len(set(les)) != len(les):
                raise ValueError(f"{name}{dict(gkey)}: le not ascending")
            counts = [c for _, c in g["buckets"]]
            if any(b < a for a, b in zip(counts, counts[1:])):
                raise ValueError(f"{name}{dict(gkey)}: buckets not "
                                 "cumulative")
            if not math.isinf(les[-1]):
                raise ValueError(f"{name}{dict(gkey)}: missing +Inf bucket")
            if counts[-1] != g["count"]:
                raise ValueError(
                    f"{name}{dict(gkey)}: +Inf bucket {counts[-1]} != "
                    f"_count {g['count']}")


def histogram_quantile(fam_group, q: float):
    """Quantile from parsed cumulative buckets — what a scraper's
    ``histogram_quantile()`` would compute (bucket-upper-bound rule,
    matching ``metrics._quantile_locked``)."""
    buckets = sorted(fam_group["buckets"])
    total = fam_group["count"]
    if not total:
        return None
    target = q * total
    for le, cum in buckets:
        if cum >= target and cum > 0:
            return le
    return buckets[-1][0]
