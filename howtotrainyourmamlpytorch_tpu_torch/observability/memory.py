"""Per-device memory watermarks: live/peak bytes in use, limit, headroom
(JAX package ``observability/memory.py``).

``MemoryWatermarks`` reads the CUDA caching allocator's own counters into a
telemetry-provider snapshot — the ``memory`` block of ``/metrics`` and of
every hub snapshot — plus an optional one-shot low-headroom event per
device, so a process that is *about* to run out of device memory says so in
``events.jsonl`` while it can still speak. The tenant pager
(``serving/tenancy.py``) reads the same snapshot as its eviction signal.

Per card: bytes in use are ``torch.cuda.memory_allocated``, the peak
``torch.cuda.max_memory_allocated``, the limit the card's
``total_memory``, and ``headroom_frac`` is ``1 - in_use / limit``, unrounded:
on an 80 GB card a 4-digit round would hide 8 MB, more than a tenant master.
Reserved bytes (``memory_reserved``, ``mem_get_info``) are not read: the
caching allocator keeps a freed block reserved, so a watermark over
reserved bytes would never recover after a tenant's eviction, and a
headroom-floor sweeper would evict every tenant in turn.

Without a card every path yields an explicit ``{"available": false,
"reason": ...}`` row rather than a guessed number, and nothing here raises:
memory telemetry must never be able to kill the process it watches.
"""

import time
from typing import Any, Callable, Dict, List

import torch


def _device_rows(indices) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    for d in indices:
        row: Dict[str, Any] = {"device": int(d), "kind": "?"}
        try:
            row["kind"] = torch.cuda.get_device_name(d)
            in_use = int(torch.cuda.memory_allocated(d))
            peak = int(torch.cuda.max_memory_allocated(d))
            limit = int(torch.cuda.get_device_properties(d).total_memory)
        except Exception as exc:  # noqa: BLE001 — never raise into the watched process
            row.update({"available": False, "reason": f"{type(exc).__name__}: {exc}"})
            rows.append(row)
            continue
        row.update(
            {
                "available": True,
                "bytes_in_use": in_use,
                "peak_bytes_in_use": peak,
                "bytes_limit": limit,
                "headroom_frac": (limit - in_use) / limit if limit else None,
            }
        )
        rows.append(row)
    return rows


def device_memory_stats() -> List[Dict[str, Any]]:
    """One row per visible CUDA card; never raises (no card yields a single
    unavailable row)."""
    try:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception as exc:  # noqa: BLE001
        return [{"device": -1, "kind": "?", "available": False, "reason": f"{type(exc).__name__}: {exc}"}]
    if count == 0:
        return [
            {
                "device": -1,
                "kind": "cpu",
                "available": False,
                "reason": "no CUDA device: the caching allocator's counters exist only on a card",
            }
        ]
    return _device_rows(range(count))


class MemoryWatermarks:
    """TelemetryHub provider + low-headroom event latch.

    ``snapshot()`` (the provider) returns the per-device rows plus the
    fleet-level aggregates readers key on (max peak, min headroom).
    ``maybe_warn(event_log)`` appends one ``hbm_headroom_low`` event per
    device the first time its headroom drops below ``warn_headroom_frac`` —
    latched, so a process hovering at the threshold doesn't flood
    events.jsonl. ``stats_fn`` is injectable for tests."""

    def __init__(
        self,
        warn_headroom_frac: float = 0.05,
        stats_fn: Callable[[], List[Dict[str, Any]]] = device_memory_stats,
    ):
        self.warn_headroom_frac = float(warn_headroom_frac)
        self._stats_fn = stats_fn
        self._warned: set = set()

    def snapshot(self) -> Dict[str, Any]:
        rows = self._stats_fn()
        live = [r for r in rows if r.get("available")]
        peaks = [r["peak_bytes_in_use"] for r in live if r.get("peak_bytes_in_use")]
        headrooms = [r["headroom_frac"] for r in live if r.get("headroom_frac") is not None]
        return {
            "devices": rows,
            "available_devices": len(live),
            "peak_bytes_in_use_max": max(peaks) if peaks else None,
            "headroom_frac_min": min(headrooms) if headrooms else None,
        }

    def maybe_warn(self, event_log=None) -> List[Dict[str, Any]]:
        """Check headroom against the threshold; returns (and appends to
        ``event_log`` when given) the newly-fired events. Never raises."""
        fired: List[Dict[str, Any]] = []
        try:
            for row in self._stats_fn():
                headroom = row.get("headroom_frac")
                dev = row.get("device")
                if headroom is None or dev in self._warned or headroom >= self.warn_headroom_frac:
                    continue
                self._warned.add(dev)
                event = {
                    "ts": time.time(),
                    "event": "hbm_headroom_low",
                    "device": dev,
                    "kind": row.get("kind"),
                    "headroom_frac": headroom,
                    "bytes_in_use": row.get("bytes_in_use"),
                    "bytes_limit": row.get("bytes_limit"),
                    "threshold": self.warn_headroom_frac,
                }
                fired.append(event)
                if event_log is not None:
                    event_log.append(event)
        except Exception:  # noqa: BLE001 — never raise into the watched process
            pass
        return fired
