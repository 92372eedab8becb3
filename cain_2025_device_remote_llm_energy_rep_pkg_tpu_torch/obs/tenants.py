"""Tenant-scoped usage accounting: bounded-cardinality metrics, an
in-process aggregate table, and a crash-safe append-only usage ledger.

The paper's unit of account is Joules per fetched response; this module
answers the follow-up question — **whose** response. Every request carries a tenant id (``x_tenant`` on the wire,
``GenerationRequest.tenant`` in-process, ``"default"`` when absent) and
every terminal outcome lands here exactly once, from the scheduler's
single completion funnel:

- **metric families** ``llm_tenant_*`` for the ``/metrics`` scrape —
  counters only, so the existing :func:`..obs.metrics.merge_expositions`
  federation sums them exactly into ``llm_fleet_tenant_*`` with zero
  merge-code changes, and the time-series ring samples them into
  windowed per-tenant rollups for free (its family filter is the
  ``llm_`` prefix);
- **a bounded tenant table**: Prometheus label cardinality is the
  caller's contract, and tenant ids arrive from the open internet — the
  first :data:`TENANT_TABLE_MAX` distinct tenants get their own label,
  later ones fold into ``tenant="_other"`` (their Joules still conserve;
  only the attribution granularity degrades);
- **an append-only JSONL usage ledger** (``--usage-ledger-dir``): one
  record per terminal request with a monotonic ``seq``, fsync-free
  ``flush()`` per append (crash loses at most the OS buffer), a periodic
  aggregate snapshot, and seq resumption across restarts so a billing
  replay never double-bills.

Everything here is telemetry: the kill switch (``TPU_LLM_OBS=0`` /
``obs.metrics.disable()``) turns :func:`account_request` into a single
boolean check and return, and no caller may fail a request on a ledger
error.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from .metrics import REGISTRY, enabled

DEFAULT_TENANT = "default"
OTHER_TENANT = "_other"
# Bounded label cardinality: tenant ids come from the wire (the open
# internet under a real deployment), so the scrape must not grow one
# label child per attacker-chosen string. Env-overridable for tests.
TENANT_TABLE_MAX = int(os.environ.get("TPU_LLM_TENANT_MAX", "32"))

TENANT_TOKENS_C = REGISTRY.counter(
    "llm_tenant_tokens_total",
    "Tokens served per tenant, by direction (in: prompt tokens "
    "processed; out: generated tokens returned)",
    labels=("tenant", "direction"),
)
TENANT_JOULES_C = REGISTRY.counter(
    "llm_tenant_joules_total",
    "Modelled Joules attributed to this tenant's completed requests "
    "(slice-level attribution on the continuous path, window/solo "
    "attribution elsewhere — nominal coefficients)",
    labels=("tenant",),
)
TENANT_WASTED_J_C = REGISTRY.counter(
    "llm_tenant_wasted_joules_total",
    "Modelled Joules burned on this tenant's behalf that no response "
    "benefits from, by the wasted-energy ledger's causes (retry / "
    "recompute / swap / escalation / draft / migration)",
    labels=("tenant", "cause"),
)
TENANT_REQUESTS_C = REGISTRY.counter(
    "llm_tenant_requests_total",
    "Terminal request outcomes per tenant (ok: streamed to completion; "
    "cancelled: client went away; deadline: x_deadline_ms expired; "
    "rejected: admission refused; error: engine/backend failure)",
    labels=("tenant", "outcome"),
)

_CAUSES = ("retry", "recompute", "swap", "escalation", "draft", "migration")
_OUTCOMES = ("ok", "cancelled", "deadline", "rejected", "error")


class TenantTable:
    """First-come bounded tenant→label map plus in-process aggregates.

    The aggregates duplicate what the counters record, keyed by the
    RESOLVED label (so ``_other`` aggregates everything past the bound)
    — they exist so ``/debug/tenants`` can serve a JSON snapshot without
    parsing our own exposition, and so the periodic ledger snapshot has
    a single source of truth."""

    def __init__(self, max_tenants: int = TENANT_TABLE_MAX) -> None:
        self.max_tenants = max_tenants
        self._lock = threading.Lock()
        self._labels: Dict[str, str] = {}
        self.accounts: Dict[str, Dict[str, Any]] = {}

    def resolve(self, tenant: Optional[str]) -> str:
        """Map a wire tenant id onto its scrape label: itself while the
        table has room, ``_other`` after (``_other`` itself and the
        default tenant always resolve — the bound is on DISTINCT ids)."""
        t = tenant or DEFAULT_TENANT
        label = self._labels.get(t)
        if label is not None:
            return label
        with self._lock:
            label = self._labels.get(t)
            if label is None:
                if t in (DEFAULT_TENANT, OTHER_TENANT) or len(
                    self._labels
                ) < self.max_tenants:
                    label = t
                else:
                    label = OTHER_TENANT
                self._labels[t] = label
            return label

    def _account(self, label: str) -> Dict[str, Any]:
        acct = self.accounts.get(label)
        if acct is None:
            acct = self.accounts.setdefault(
                label,
                {
                    "requests": {},
                    "tokens_in": 0,
                    "tokens_out": 0,
                    "joules": 0.0,
                    "wasted_J": {},
                },
            )
        return acct

    def record(
        self,
        label: str,
        outcome: str,
        tokens_in: int,
        tokens_out: int,
        joules: float,
        wasted: Optional[Dict[str, float]],
    ) -> None:
        with self._lock:
            acct = self._account(label)
            acct["requests"][outcome] = acct["requests"].get(outcome, 0) + 1
            acct["tokens_in"] += tokens_in
            acct["tokens_out"] += tokens_out
            acct["joules"] += joules
            if wasted:
                wj = acct["wasted_J"]
                for cause, j in wasted.items():
                    if j:
                        wj[cause] = wj.get(cause, 0.0) + j

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able per-tenant aggregates (rounded for the wire)."""
        with self._lock:
            out: Dict[str, Any] = {}
            for label in sorted(self.accounts):
                acct = self.accounts[label]
                out[label] = {
                    "requests": dict(acct["requests"]),
                    "tokens_in": acct["tokens_in"],
                    "tokens_out": acct["tokens_out"],
                    "joules": round(acct["joules"], 6),
                    "wasted_J": {
                        c: round(j, 6) for c, j in acct["wasted_J"].items()
                    },
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._labels.clear()
            self.accounts.clear()


class UsageLedger:
    """Append-only JSONL usage ledger with monotonic sequence numbers.

    One ``usage_ledger.jsonl`` under ``dir_path``; each line is a
    self-contained record ``{"seq", "ts", "tenant", "outcome",
    "tokens_in", "tokens_out", "joules", "wasted_J", "model",
    "trace"}``. On open, the tail of an existing file is scanned for
    the highest ``seq`` so a restarted process RESUMES the sequence —
    a billing replay deduplicates on ``seq`` and never double-bills.
    ``write_snapshot()`` dumps the aggregate table to
    ``usage_snapshot.json`` (atomic rename) so a consumer can catch up
    without replaying the whole ledger."""

    LEDGER_NAME = "usage_ledger.jsonl"
    SNAPSHOT_NAME = "usage_snapshot.json"

    def __init__(self, dir_path: str) -> None:
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self.path = os.path.join(dir_path, self.LEDGER_NAME)
        self._lock = threading.Lock()
        self.seq = self._resume_seq()
        self._repair_tail()
        self._fh = open(self.path, "a", encoding="utf-8")

    def _repair_tail(self) -> None:
        """A crash can tear the final line mid-write. Terminate it so
        the next append starts a fresh line — otherwise one torn record
        would also corrupt the first post-restart append."""
        try:
            with open(self.path, "rb+") as fh:
                fh.seek(0, os.SEEK_END)
                if fh.tell() == 0:
                    return
                fh.seek(-1, os.SEEK_END)
                if fh.read(1) != b"\n":
                    fh.write(b"\n")
        except OSError:
            pass

    def _resume_seq(self) -> int:
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                last = 0
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        last = max(last, int(json.loads(line).get("seq", 0)))
                    except (ValueError, TypeError):
                        continue  # torn tail write from a crash
                return last
        except OSError:
            return 0

    def append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if self._fh.closed:
                return
            self.seq += 1
            record = {"seq": self.seq, "ts": round(time.time(), 3), **record}
            self._fh.write(json.dumps(record, sort_keys=True) + "\n")
            self._fh.flush()

    def write_snapshot(self, table: "TenantTable") -> None:
        snap = {
            "seq": self.seq,
            "ts": round(time.time(), 3),
            "tenants": table.snapshot(),
        }
        tmp = os.path.join(self.dir, self.SNAPSHOT_NAME + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(snap, fh, sort_keys=True)
        os.replace(tmp, os.path.join(self.dir, self.SNAPSHOT_NAME))

    def close(self, table: Optional["TenantTable"] = None) -> None:
        with self._lock:
            if self._fh.closed:
                return
            self._fh.flush()
            self._fh.close()
        if table is not None:
            try:
                self.write_snapshot(table)
            except OSError:
                pass


def read_ledger(dir_path: str) -> list:
    """Replay a ledger directory's JSONL records (torn lines skipped) —
    the smoke/tests' re-readability check and a billing replayer's
    skeleton."""
    path = os.path.join(dir_path, UsageLedger.LEDGER_NAME)
    records = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return records


# THE process-wide table; a ledger is attached by the server that owns
# the process lifetime (install_ledger) and detached on shutdown.
TABLE = TenantTable()
_LEDGER: Optional[UsageLedger] = None


def install_ledger(ledger: Optional[UsageLedger]) -> Optional[UsageLedger]:
    global _LEDGER
    prev, _LEDGER = _LEDGER, ledger
    return prev


def current_ledger() -> Optional[UsageLedger]:
    return _LEDGER


def account_request(
    tenant: Optional[str],
    outcome: str,
    tokens_in: int = 0,
    tokens_out: int = 0,
    joules: float = 0.0,
    wasted: Optional[Dict[str, float]] = None,
    model: Optional[str] = None,
    trace: Optional[str] = None,
) -> None:
    """Record ONE terminal request outcome against its tenant — counters,
    aggregate table, and (when installed) the ledger. Zero-alloc no-op
    under the kill switch; never raises."""
    if not enabled():
        return
    label = TABLE.resolve(tenant)
    TENANT_REQUESTS_C.labels(tenant=label, outcome=outcome).inc()
    if tokens_in:
        TENANT_TOKENS_C.labels(tenant=label, direction="in").inc(tokens_in)
    if tokens_out:
        TENANT_TOKENS_C.labels(tenant=label, direction="out").inc(tokens_out)
    if joules:
        TENANT_JOULES_C.labels(tenant=label).inc(joules)
    if wasted:
        for cause, j in wasted.items():
            if j:
                TENANT_WASTED_J_C.labels(tenant=label, cause=cause).inc(j)
    TABLE.record(label, outcome, tokens_in, tokens_out, joules, wasted)
    ledger = _LEDGER
    if ledger is not None:
        try:
            ledger.append(
                {
                    "tenant": label,
                    "outcome": outcome,
                    "tokens_in": tokens_in,
                    "tokens_out": tokens_out,
                    "joules": round(joules, 6),
                    "wasted_J": {
                        c: round(j, 6) for c, j in (wasted or {}).items() if j
                    },
                    **({"model": model} if model else {}),
                    **({"trace": trace} if trace else {}),
                }
            )
        except OSError:
            pass


def snapshot() -> Dict[str, Any]:
    """The ``/debug/tenants`` payload body: per-tenant aggregates plus
    the table bound and ledger position."""
    ledger = _LEDGER
    return {
        "tenants": TABLE.snapshot(),
        "table_max": TABLE.max_tenants,
        "ledger": (
            {"dir": ledger.dir, "seq": ledger.seq} if ledger is not None else None
        ),
    }


def reset_tenants() -> None:
    """Test/bench isolation: drop the aggregate table (metric children
    are dropped by ``REGISTRY.reset()`` as usual)."""
    TABLE.reset()
