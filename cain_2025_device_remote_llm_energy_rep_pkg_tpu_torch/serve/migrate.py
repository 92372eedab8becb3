"""Live row-migration bundle codec.

Counterpart of the JAX package's ``serve/migrate.py``, with its
``BUNDLE_VERSION`` and its keys. A *migrate bundle* is the
JSON-serializable form of one preempted row: everything the preemption
path already captures (``engine/stepped.py``'s ``PreemptedRow``: KV pages
as ``PagePool.swap_out`` blobs, side-cache columns or a contiguous cache
slab, last tokens, generator state, offsets, remaining budget, sampler
flags), so that a row primed on one server can be seated on another
through the ``resume_begin`` / ``_seat_row`` machinery. The same bundle
rides ``POST /api/migrate`` over the wire (tensor leaves base64-framed).

Two kinds, discriminated by ``bundle["kind"]``:

- ``"real"``: a ``PreemptedRow`` walked slot by slot. Tensor leaves
  (generator state, presence, swap blobs, cache slabs) encode as
  ``{"dtype", "shape", "b64"}`` with the raw little-endian words (a
  ``bfloat16`` leaf as its 2-byte words, so neither side needs
  ``ml_dtypes``); int8 slabs are ``{"q","s"}`` dicts of those.
  ``bundle["nbytes"]`` totals the payload bytes, the figure the
  wasted-energy ledger charges (:func:`charge_transfer`, at the seating
  server) and the
  ``llm_migrate_bytes_total`` counters move by.
- ``"fake"``: the hermetic twin (``engine/fake.py`` preempts rows as
  plain dicts). Only control state crosses: the destination backend
  regenerates the deterministic result stream and the cursor and
  streamed watermarks carry over.

A bundle the JAX package exported reads the same way: its ``bfloat16``
leaves are the same 2-byte words, its ``rng`` is a JAX PRNG key
(``uint32``) where the port's is a ``torch.Generator`` state
(``uint8``). A greedy row never draws from its generator and seats with
none; a sampled row's JAX key cannot continue its stream in torch, so
its import raises :class:`MigrateRefused`. Layout differences (the JAX
package's unstacked paged rows, a stacked pool's lane padding) are
settled at seat time by the session (``SteppedDecodeSession``).

Refusals (``MigrateRefused``) at export happen while the row is still
resumable on the source: rows holding shared prefix pages without their
payload (the pages have other live readers on the source pool; the
port's ``preempt`` copies a sharer's shared run into its blob, so its
rows export with every page their own) and speculating rows (the draft
cache's layout belongs to the source engine's draft config). The caller
falls back to local decode; the ticket is never dropped.

Ledger discipline: the SOURCE settles the swap gauges through
``resume_discard(pr)`` after a confirmed transfer, so an imported row
arrives with ``host_bytes == 0`` and ``discharged=True``.
"""

from __future__ import annotations

import base64
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..obs.energy import charge_wasted
from ..obs.metrics import MIGRATE_ROWS_C
from .protocol import request_from_wire, request_to_wire

BUNDLE_VERSION = 1

# PreemptedRow slots that are plain JSON scalars/lists — copied verbatim
# on export and restored verbatim on import (in slot order).
_PR_PLAIN = (
    "ids", "generated", "prompt_len", "offsets", "remaining",
    "use_top_p", "use_rp", "streamed", "policy", "paged", "stacked",
    "n_own_pages",
)


class MigrateRefused(RuntimeError):
    """This row cannot leave its replica (or cannot continue on this
    one); resume it locally instead."""


# -- tensor leaf codec ---------------------------------------------------------
#
# Leaves are tensors (host copies) or {"q","s"} dicts of them (int8
# caches). Encoded leaves are dicts carrying a "b64" key — slab dicts
# never do, so decode dispatches on that marker.


def _encode_leaf(x: Any, acc: list) -> Any:
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _encode_leaf(v, acc) for k, v in x.items()}
    t = torch.as_tensor(x).detach().to("cpu").contiguous()
    name = str(t.dtype).removeprefix("torch.")
    # numpy has no bfloat16: its words travel as int16, bit for bit
    words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    acc[0] += t.numel() * t.element_size()
    return {
        "dtype": name,
        "shape": list(t.shape),
        "b64": base64.b64encode(words.numpy().tobytes()).decode("ascii"),
    }


def _decode_array(x: Dict[str, Any]) -> np.ndarray:
    """An encoded leaf's words as numpy (a ``bfloat16`` leaf as int16)."""
    dtype = np.int16 if x["dtype"] == "bfloat16" else np.dtype(x["dtype"])
    buf = base64.b64decode(x["b64"])
    return np.frombuffer(buf, dtype=dtype).reshape(tuple(x["shape"])).copy()


def _decode_leaf(x: Any) -> Any:
    if x is None:
        return None
    if isinstance(x, dict) and "b64" not in x:
        return {k: _decode_leaf(v) for k, v in x.items()}
    t = torch.from_numpy(_decode_array(x))
    return t.view(torch.bfloat16) if x["dtype"] == "bfloat16" else t


def _encode_pair(pair: Any, acc: list) -> Any:
    """(k_slab, v_slab) tuples — side_blob / cache_blob."""
    if pair is None:
        return None
    k, v = pair
    return [_encode_leaf(k, acc), _encode_leaf(v, acc)]


def _decode_pair(pair: Any) -> Any:
    if pair is None:
        return None
    return (_decode_leaf(pair[0]), _decode_leaf(pair[1]))


# -- export --------------------------------------------------------------------


def export_bundle(
    pr: Any, reason: str = "disagg", streamed: "Optional[int]" = None
) -> Dict[str, Any]:
    """Serialize one preempted row (a real ``PreemptedRow`` or the fake
    backend's pr dict) into a JSON-able bundle. ``streamed`` overrides
    the exported stream watermark: a disaggregated prime passes 0 so the
    decode server re-emits every generated token (the client saw none);
    drain evacuation passes nothing, keeping the live cursor so the
    spliced stream continues exactly where the source stopped. Raises
    :class:`MigrateRefused` while the row is still locally resumable."""
    if isinstance(pr, dict):
        return _export_fake(pr, reason, streamed)
    return _export_real(pr, reason, streamed)


def _export_fake(
    pr: Dict[str, Any], reason: str, streamed: "Optional[int]"
) -> Dict[str, Any]:
    row = pr["row"]
    return {
        "version": BUNDLE_VERSION,
        "kind": "fake",
        "reason": reason,
        "model": pr["request"].model,
        "request": request_to_wire(pr["request"]),
        "cursor": len(pr["generated"]),
        "streamed": int(row["streamed"] if streamed is None else streamed),
        "prompt_len": int(pr["prompt_len"]),
        "policy": pr["policy"],
        "nbytes": int(pr.get("host_bytes", 0)),
    }


def _export_real(pr: Any, reason: str, streamed: "Optional[int]") -> Dict[str, Any]:
    shared = getattr(pr, "shared_pages", None)
    blob = getattr(pr, "blob", None)
    if shared and (blob is None or blob.n_pages != len(shared) + pr.n_own_pages):
        # shared prefix pages have other live readers on the source
        # pool; a captured page list without their payload only means
        # anything against the source's prefix store
        raise MigrateRefused(
            "row shares %d prefix pages with the source replica" % len(shared)
        )
    if getattr(pr, "draft_blob", None) is not None:
        raise MigrateRefused(
            "row carries speculative draft state bound to the source "
            "engine's draft config"
        )
    acc = [0]
    t0 = float(pr.t0 or 0.0)
    t1 = float(pr.t1 or t0)
    bundle: Dict[str, Any] = {
        "version": BUNDLE_VERSION,
        "kind": "real",
        "reason": reason,
        "model": pr.request.model,
        "request": request_to_wire(pr.request),
        # the generator's state (None: a row that never samples)
        "rng": _encode_leaf(pr.gen_state, acc),
        "presence": _encode_leaf(pr.presence, acc),
        "side_blob": _encode_pair(pr.side_blob, acc),
        "cache_blob": _encode_pair(pr.cache_blob, acc),
        # wall-clock offsets don't transfer between hosts; ship the
        # prefill duration and rebase against the receiver's clock
        "prefill_s": max(0.0, t1 - t0),
    }
    for name in _PR_PLAIN:
        bundle[name] = getattr(pr, name)
    if streamed is not None:
        bundle["streamed"] = int(streamed)
    if blob is not None:
        # a sharer's blob holds its shared run too: all its own there
        bundle["n_own_pages"] = int(blob.n_pages)
        bundle["blob"] = {
            "k_chunks": _encode_leaf(blob.k_chunks, acc),
            "v_chunks": _encode_leaf(blob.v_chunks, acc),
            "n_pages": int(blob.n_pages),
            "page_size": int(blob.page_size),
            "quantized": bool(blob.quantized),
            "nbytes": int(blob.nbytes),
        }
    else:
        bundle["blob"] = None
    bundle["nbytes"] = acc[0]
    return bundle


# -- import --------------------------------------------------------------------


def import_bundle(bundle: Dict[str, Any], backend: Any = None) -> Any:
    """Rebuild the preempted-row object a destination session's
    ``can_resume`` / ``resume_begin`` accepts. Real bundles need no
    backend (the ``PreemptedRow`` stands alone until seating); fake
    bundles need the destination ``FakeBackend`` to regenerate the
    deterministic result stream. The returned row always carries
    ``host_bytes=0`` / ``discharged=True`` (the source settled the swap
    ledger, see the module docstring)."""
    if int(bundle.get("version", 0)) != BUNDLE_VERSION:
        raise ValueError("unsupported migrate bundle version %r" % bundle.get("version"))
    if bundle.get("kind") == "fake":
        return _import_fake(bundle, backend)
    return _import_real(bundle)


def _import_fake(bundle: Dict[str, Any], backend: Any) -> Dict[str, Any]:
    if backend is None or not hasattr(backend, "_result"):
        raise ValueError("fake migrate bundle requires a fake backend")
    request = request_from_wire(dict(bundle["request"]))
    result = backend._result(request)
    cursor = min(int(bundle["cursor"]), result.generated_tokens)
    row = {
        "request": request,
        "result": result,
        "cursor": cursor,
        "streamed": min(int(bundle["streamed"]), cursor),
        "spec_rounds": 0,
        "spec_accepted": 0,
        "spec_drafted": 0,
        "spec_rejected": 0,
        "draft_wasted_J": 0.0,
        "hit_tokens": 0,
        "shared_pages": 0,
        # attribution restarts at the destination — the real import's
        # PreemptedRow does the same through its zeroed defaults, so the
        # destination session's conservation ledger stays local
        "attr_wall": 0.0,
        "attr_J": 0.0,
        "attr_slices": 0,
        "attr_wasted_J": 0.0,
    }
    return {
        "request": request,
        "row": row,
        "policy": bundle.get("policy", "swap"),
        "generated": result.tokens[:cursor],
        "prompt_len": int(bundle["prompt_len"]),
        "host_bytes": 0,
        "discharged": True,
    }


def _import_rng(leaf: Any, request) -> Optional[torch.Tensor]:
    """The row's generator state: a ``torch.Generator`` state (uint8)
    as the port exports it. A JAX PRNG key cannot seed a torch stream: a
    greedy row (temperature 0, which never samples) seats without one, a
    sampled row is refused."""
    if leaf is None:
        return None
    if leaf["dtype"] == "uint8":
        return torch.from_numpy(_decode_array(leaf))
    if request.temperature > 0.0:
        raise MigrateRefused(
            "a sampled row's JAX PRNG key (dtype %s) cannot continue its "
            "stream in torch: resume it on a JAX replica" % leaf["dtype"]
        )
    return None


def _import_real(bundle: Dict[str, Any]) -> Any:
    from ..engine.paged_kv import PageSwapBlob
    from ..engine.stepped import PreemptedRow

    request = request_from_wire(dict(bundle["request"]))
    pr = PreemptedRow(
        request, list(bundle["ids"]), list(bundle["generated"]), int(bundle["prompt_len"])
    )
    for name in _PR_PLAIN:
        if name in ("ids", "generated", "prompt_len"):
            continue
        setattr(pr, name, bundle[name])
    pr.gen_state = _import_rng(bundle["rng"], request)
    pr.presence = _decode_leaf(bundle["presence"])
    pr.side_blob = _decode_pair(bundle["side_blob"])
    pr.cache_blob = _decode_pair(bundle["cache_blob"])
    pr.draft_blob = None
    pr.draft_offset = 0
    pr.shared_pages = []
    blob = bundle.get("blob")
    if blob is not None:
        pr.blob = PageSwapBlob(
            k_chunks=_decode_leaf(blob["k_chunks"]),
            v_chunks=_decode_leaf(blob["v_chunks"]),
            n_pages=int(blob["n_pages"]),
            page_size=int(blob["page_size"]),
            quantized=bool(blob["quantized"]),
            nbytes=int(blob["nbytes"]),
        )
    else:
        pr.blob = None
    now = time.monotonic()
    pr.t1 = now
    pr.t0 = now - float(bundle.get("prefill_s", 0.0))
    pr.host_bytes = 0
    pr.discharged = True
    return pr


def bundle_nbytes(bundle: Dict[str, Any]) -> int:
    """Serialized payload bytes — what the transfer moved and what the
    ledger charges (2× per migration: once out, once in)."""
    return int(bundle.get("nbytes", 0))


def charge_transfer(bundle: Dict[str, Any], reason: str) -> float:
    """Account one transfer of ``bundle`` between servers, as the JAX
    package's router does for each seat it attempts: the
    ``llm_migrate_rows_total{reason=}`` counter, and the wasted-energy
    ledger's ``cause="migration"`` at 2× the payload bytes (once out,
    once in). Returns the Joules charged (0.0 with telemetry off). The
    scheduler's ``submit_migrate`` charges each bundle it seats."""
    MIGRATE_ROWS_C.labels(reason=reason).inc()
    return charge_wasted("migration", nbytes=2.0 * bundle_nbytes(bundle))
