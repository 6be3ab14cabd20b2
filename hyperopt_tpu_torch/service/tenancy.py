"""Multi-tenant authentication and quotas for the network store.

Counterpart of ``hyperopt_tpu/service/tenancy.py``.  A per-tenant token
table in place of the store server's single shared secret: every verb authenticates as *some tenant*, and the dispatch layer
namespaces each tenant's ``exp_key`` space into its own store subtree —
tenant A can never address tenant B's trials no matter what ``exp_key``
it sends, because the store key is derived from the *authenticated*
identity, not from anything in the request body.

Token lookup is timing-safe: :meth:`TenantTable.resolve` runs
``hmac.compare_digest`` against **every** registered token on every
attempt (no early exit on match), so neither a token's bytes nor *which*
tenant matched leaks through response timing.

Quotas (both optional, per tenant):

* ``max_claims`` — concurrent RUNNING trials the tenant may hold across
  all of its experiments.  Enforced at ``reserve``: an over-quota tenant
  is told the queue is empty (``doc: None``) so stock workers back off
  via their normal poll loop; ``netstore.tenant.<t>.quota.claims_rejected``
  counts the refusals.
* ``trials_per_s`` — token-bucket admission rate on trial creation
  (``insert_docs`` / server-side ``suggest`` with insert).  A refused
  admission raises :class:`~hyperopt_tpu_torch.exceptions.QuotaExceeded`
  (HTTP-visible, typed client-side, deliberately not transient).
"""

from __future__ import annotations

import hmac
import json
import time
from typing import Optional

__all__ = ["Tenant", "TenantTable", "TokenBucket"]


class TokenBucket:
    """Classic token bucket on ``time.monotonic``.

    ``burst`` defaults to one second's worth of rate (min 1), so a
    tenant may briefly exceed its steady-state rate by one refill window
    — the usual smoothing so a batched enqueue isn't punished for
    arriving as a batch.
    """

    def __init__(self, rate: float, burst: float | None = None):
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(1.0, self.rate)
        self.tokens = self.burst
        self._t = time.monotonic()

    def take(self, n: float = 1.0, now: float | None = None) -> bool:
        """Consume ``n`` tokens; False (and no consumption) if short."""
        now = time.monotonic() if now is None else now
        self.tokens = min(self.burst,
                          self.tokens + max(0.0, now - self._t) * self.rate)
        self._t = now
        if self.tokens + 1e-9 >= n:
            self.tokens -= n
            return True
        return False


class Tenant:
    """One tenant: identity token + quotas.

    Mutable quota state (the admission bucket) lives here; the server's
    dispatch lock serializes access, so no extra locking is needed.
    """

    def __init__(self, name: str, token: str,
                 max_claims: int | None = None,
                 trials_per_s: float | None = None,
                 burst: float | None = None):
        if not name or "/" in name or name != name.strip():
            raise ValueError(f"bad tenant name {name!r} (non-empty, no '/')")
        if not token:
            raise ValueError(f"tenant {name!r} needs a non-empty token")
        self.name = name
        self.token = token
        self.max_claims = None if max_claims is None else int(max_claims)
        self.trials_per_s = (None if trials_per_s is None
                             else float(trials_per_s))
        self.bucket = (None if self.trials_per_s is None
                       else TokenBucket(self.trials_per_s, burst=burst))

    def admit_trials(self, n: int) -> bool:
        """Charge ``n`` trial admissions against the rate quota."""
        if self.bucket is None:
            return True
        return self.bucket.take(float(n))

    def set_admission_scale(self, factor: float) -> None:
        """Tighten (or restore) the admission rate to ``factor`` × the
        configured ``trials_per_s``.

        This is the autoscaler's graceful-degradation knob: when the
        fleet cannot grow, admission is squeezed fleet-wide instead of
        letting queues build unboundedly.  Idempotent and lossless —
        the configured rate is never overwritten, so ``factor=1.0``
        restores exactly the original quota.  Accumulated tokens are
        clamped to the new burst so a tightened tenant cannot spend a
        pre-tightening surplus.  Tenants with no rate quota configured
        stay unlimited (there is nothing to scale).
        """
        if self.trials_per_s is None:
            return
        factor = max(0.0, float(factor))
        rate = self.trials_per_s * factor
        if self.bucket is None or factor <= 0.0:
            self.bucket = TokenBucket(max(rate, 1e-9))
            return
        self.bucket.rate = rate
        self.bucket.burst = max(1.0, rate)
        self.bucket.tokens = min(self.bucket.tokens, self.bucket.burst)

    def __repr__(self):  # never echo the token
        return (f"Tenant({self.name!r}, max_claims={self.max_claims}, "
                f"trials_per_s={self.trials_per_s})")


class TenantTable:
    """The set of tenants a server authenticates against."""

    def __init__(self, tenants):
        self.tenants = list(tenants)
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {sorted(names)}")

    def __len__(self):
        return len(self.tenants)

    def __iter__(self):
        return iter(self.tenants)

    def resolve(self, token: str) -> Optional[Tenant]:
        """Timing-safe token -> tenant lookup.

        Compares against every tenant (constant work per attempt —
        neither the matching prefix length nor the matching *position*
        in the table is observable from latency) and returns the match.
        """
        got = (token or "").encode()
        found = None
        for t in self.tenants:
            if hmac.compare_digest(got, t.token.encode()):
                found = t          # keep scanning: no early exit
        return found

    @classmethod
    def from_file(cls, path: str) -> "TenantTable":
        """Load a JSON tenant table::

            [{"name": "acme", "token": "s3cret",
              "max_claims": 64, "trials_per_s": 50}, ...]
        """
        with open(path) as f:
            rows = json.load(f)
        if not isinstance(rows, list):
            raise ValueError(f"{path}: tenant table must be a JSON list")
        return cls(Tenant(name=r["name"], token=r["token"],
                          max_claims=r.get("max_claims"),
                          trials_per_s=r.get("trials_per_s"),
                          burst=r.get("burst"))
                   for r in rows)
