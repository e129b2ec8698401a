"""FleetObserver — scrape member servers, merge their vars op-correctly.

One process (an operator box, or any member doubling as observer) scrapes
``/vars?series=json``, ``/serving?format=json`` and ``/watch?format=json``
from every fleet member and keeps the latest documents. Merged ``cluster_*``
vars are exposed in the local registry with the same op-correct semantics
the shard plane proved in-process (:mod:`brpc_tpu_torch.fleet.merge`): Adder
counters sum exactly, windowed latency means weight by member qps,
percentiles take the conservative max. Live-ness is crash-tolerant: a
member whose scrape fails is marked stale and simply drops out of the
merge until it answers again — the observer never dies with the member.

Membership comes from static ``list://`` seeds today; any
:class:`~brpc_tpu_torch.policy.naming.NamingService` instance plugs into the same
slot (``get_servers()`` is re-consulted every scrape round), which is the
hook the future autoscaler rides.

The scrape loop is budget-gated twice (enforced by the ``budget-gated-scrape``
lint rule): the interval re-reads the reloadable ``fleet_scrape_interval_s``
flag every round, and each round first asks the shared metrics Collector
for a grant so N observers can never stampede a fleet past
``collector_max_samples_per_second``.

Fault point ``fleet.scrape.fail`` (ctx key ``member``) injects scrape
failures per member for chaos tests.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.fleet.merge import (
    OP_WAVG_QPS,
    MergedVar,
    merge_values,
    qps_weight_name,
)
from brpc_tpu_torch.metrics.collector import global_collector
from brpc_tpu_torch.metrics.series import ensure_series_installed
from brpc_tpu_torch.metrics.watch import ensure_watch_hooked

fleet_scrape_interval_s = _flags.define(
    "fleet_scrape_interval_s", 2.0,
    "seconds between fleet observer scrape rounds (reloadable: the loop "
    "re-reads the flag every round)", validator=lambda v: v > 0)
fleet_stale_after_s = _flags.define(
    "fleet_stale_after_s", 10.0,
    "a member whose last good scrape is older than this is reported "
    "stale in /fleet even if no scrape has failed since (reloadable)",
    validator=lambda v: v > 0)

_fault.register(
    "fleet.scrape.fail",
    "fail a fleet observer scrape of one member (ctx: member=host:port)")

# derived families a scrape must never re-ingest: an observer scraping an
# observer (or itself) would otherwise feed its own aggregates back into
# the merge and double-count the fleet
SKIP_SCRAPED_PREFIXES = ("cluster_", "g_slo_")


def _default_fetch(addr: str, path: str) -> dict:
    """Scrape one JSON endpoint over the normal HTTP lane."""
    from brpc_tpu_torch.policy.http_protocol import http_fetch
    resp = http_fetch(addr, "GET", path, timeout=3.0)
    if resp.status != 200:
        raise ConnectionError(f"{addr}{path} -> HTTP {resp.status}")
    return json.loads(bytes(resp.body).decode())


class FleetMember:
    """Latest scraped state of one fleet member."""

    def __init__(self, addr: str):
        self.addr = addr
        # {name: (op, ptype, value)} from /vars?series=json "vars"
        self.vars: Dict[str, tuple] = {}
        self.series: Dict[str, dict] = {}
        self.serving: dict = {}
        self.watch: List[dict] = []
        self.scrapes_ok = 0
        self.scrapes_failed = 0
        self.consecutive_failures = 0
        self.last_ok_mono = 0.0
        self.last_error = ""

    def live(self) -> bool:
        """Deterministic liveness: at least one good scrape and the most
        recent attempt succeeded. Wall-clock staleness is reported
        separately (age vs fleet_stale_after_s) so tests without a running
        scrape thread stay time-independent."""
        return self.scrapes_ok > 0 and self.consecutive_failures == 0

    def age_s(self) -> float:
        if self.last_ok_mono == 0.0:
            return float("inf")
        return time.monotonic() - self.last_ok_mono

    def stale(self) -> bool:
        return (not self.live()
                or self.age_s() > float(_flags.get("fleet_stale_after_s")))

    def to_dict(self) -> dict:
        age = self.age_s()
        return {
            "addr": self.addr,
            "live": self.live(),
            "stale": self.stale(),
            "age_s": round(age, 3) if age != float("inf") else None,
            "scrapes_ok": self.scrapes_ok,
            "scrapes_failed": self.scrapes_failed,
            "consecutive_failures": self.consecutive_failures,
            "last_error": self.last_error,
            "vars": len(self.vars),
            "firing": [r["name"] for r in self.watch
                       if r.get("state") == "firing"],
        }


class FleetObserver:
    """Scrape + merge loop over a fleet member set."""

    def __init__(self, seeds, fetch: Optional[Callable[[str, str], dict]] = None):
        """``seeds``: 'list://h1:p1,h2:p2', plain 'h1:p1,h2:p2', a list of
        addr strings, or a NamingService instance (re-consulted every
        scrape round — the naming hook)."""
        self._naming = None
        self._static: List[str] = []
        if hasattr(seeds, "get_servers"):
            self._naming = seeds
        else:
            if isinstance(seeds, str):
                text = seeds[len("list://"):] if seeds.startswith("list://") \
                    else seeds
                items = [s for s in text.split(",") if s.strip()]
            else:
                items = list(seeds)
            self._static = [str(s).strip().split()[0] for s in items]
        self._lock = threading.Lock()
        self._members: Dict[str, FleetMember] = {}
        self._cluster_vars: Dict[str, MergedVar] = {}
        self._count_vars: List[MergedVar] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fetch = fetch or _default_fetch
        self._expose_counts()

    # -------------------------------------------------------------- members
    def member_addrs(self) -> List[str]:
        if self._naming is not None:
            try:
                return [str(n.ep) for n in self._naming.get_servers()]
            except Exception:
                with self._lock:
                    return sorted(self._members)
        return list(self._static)

    def members(self) -> List[FleetMember]:
        with self._lock:
            return [self._members[a] for a in sorted(self._members)]

    def live_members(self) -> List[FleetMember]:
        return [m for m in self.members() if m.live()]

    # --------------------------------------------------------------- scrape
    def scrape_once(self) -> int:
        """One scrape round over the current member set; returns the number
        of members that answered. Never raises."""
        ok = 0
        for addr in self.member_addrs():
            with self._lock:
                member = self._members.get(addr)
                if member is None:
                    member = self._members[addr] = FleetMember(addr)
            if self._scrape_member(member):
                ok += 1
        self._refresh_cluster_vars()
        return ok

    def _scrape_member(self, member: FleetMember) -> bool:
        try:
            if _fault.hit("fleet.scrape.fail",
                          member=member.addr) is not None:
                raise ConnectionError("injected: fleet.scrape.fail")
            vars_doc = self._fetch(member.addr, "/vars?series=json")
            serving_doc = self._fetch(member.addr, "/serving?format=json")
            watch_doc = self._fetch(member.addr, "/watch?format=json")
        except Exception as e:
            with self._lock:
                member.scrapes_failed += 1
                member.consecutive_failures += 1
                member.last_error = f"{type(e).__name__}: {e}"
            return False
        snap = {}
        for name, rec in (vars_doc.get("vars") or {}).items():
            if str(name).startswith(SKIP_SCRAPED_PREFIXES):
                continue
            if (isinstance(rec, list) and len(rec) == 3
                    and isinstance(rec[2], (int, float))
                    and not isinstance(rec[2], bool)):
                snap[str(name)] = (str(rec[0]), str(rec[1]), rec[2])
        series = {str(k): v for k, v in (vars_doc.get("series") or {}).items()
                  if not str(k).startswith(SKIP_SCRAPED_PREFIXES)}
        with self._lock:
            member.vars = snap
            member.series = series
            member.serving = serving_doc
            member.watch = list(watch_doc.get("rules") or [])
            member.scrapes_ok += 1
            member.consecutive_failures = 0
            member.last_ok_mono = time.monotonic()
            member.last_error = ""
        return True

    # ---------------------------------------------------------------- merge
    def _refresh_cluster_vars(self) -> None:
        with self._lock:
            names = set()
            for m in self._members.values():
                if m.live():
                    names.update(m.vars)
            missing = [(n, self._op_of(n)) for n in names
                       if f"cluster_{n}" not in self._cluster_vars]
        for name, (op, ptype) in missing:
            cname = f"cluster_{name}"
            var = MergedVar(
                self._cluster_reader(name), ptype,
                help_text=f"{op} of {name} over live fleet members "
                          f"(fleet scrape merge)")
            var.expose(cname)
            with self._lock:
                self._cluster_vars[cname] = var

    def _op_of(self, name: str):
        for m in self._members.values():
            rec = m.vars.get(name)
            if rec is not None:
                return (rec[0], rec[1])
        return ("avg", "gauge")

    def _cluster_reader(self, name: str):
        def read():
            with self._lock:
                recs = [m.vars[name] for m in self._members.values()
                        if m.live() and name in m.vars]
                if not recs:
                    return 0
                op = recs[0][0]
                values = [rec[2] for rec in recs]
                weights = None
                if op == OP_WAVG_QPS:
                    wname = qps_weight_name(name)
                    weights = [m.vars.get(wname, (0, 0, 0))[2]
                               for m in self._members.values()
                               if m.live() and name in m.vars]
            return merge_values(op, values, weights)
        return read

    def cluster_value(self, name: str):
        """Merged value of one scraped var (without going through /vars)."""
        return self._cluster_reader(name)()

    def merged_series(self, name: str) -> Optional[dict]:
        """Element-wise merge of one var's scraped second-tier series over
        live members, honoring the var's merge op (the SLO engine's feed)."""
        with self._lock:
            docs = []
            weights = []
            op = None
            wname = None
            for m in self._members.values():
                if not m.live():
                    continue
                doc = m.series.get(name)
                if not doc:
                    continue
                rec = m.vars.get(name)
                docs.append(doc)
                if rec is not None and op is None:
                    op = rec[0]
                if op == OP_WAVG_QPS and wname is None:
                    wname = qps_weight_name(name)
                weights.append(
                    m.vars.get(wname, (0, 0, 1))[2] if wname else 1.0)
        if not docs:
            return None
        op = op or "avg"
        length = min(len(d.get("second") or []) for d in docs)
        if length == 0:
            return None
        merged = []
        for i in range(length):
            column = [float(d["second"][len(d["second"]) - length + i])
                      for d in docs]
            merged.append(merge_values(op, column, weights))
        count = max(int(d.get("count", 0)) for d in docs)
        return {"second": merged, "count": count, "op": op}

    # --------------------------------------------------------------- views
    def serving_shard_union(self) -> Dict[str, str]:
        """Union of member serving shard maps, keyed '<addr>/<seq>'."""
        out: Dict[str, str] = {}
        with self._lock:
            for m in self._members.values():
                for engine in (m.serving.get("engines") or []):
                    shard_map = (engine.get("kv") or {}).get("shard_map") or {}
                    for seq, shard in shard_map.items():
                        out[f"{m.addr}/{seq}"] = str(shard)
        return out

    def firing_rules(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for m in self.members():
            names = [r["name"] for r in m.watch if r.get("state") == "firing"]
            if names:
                out[m.addr] = names
        return out

    def fleet_trace(self, trace_id: str) -> dict:
        """Pull one trace's retained spans from every live member and
        stitch them into a single tree via merge_trace_docs."""
        from brpc_tpu_torch.trace.span import merge_trace_docs
        docs = []
        for m in self.live_members():
            try:
                doc = self._fetch(m.addr, f"/rpcz/{trace_id}?format=json")
            except Exception:
                continue
            if doc.get("spans"):
                docs.append(doc)
        return merge_trace_docs(docs)

    def to_dict(self) -> dict:
        members = [m.to_dict() for m in self.members()]
        with self._lock:
            cluster = sorted(self._cluster_vars)
        return {
            "members": members,
            "live": sum(1 for m in members if m["live"]),
            "cluster_vars": len(cluster),
            "interval_s": float(_flags.get("fleet_scrape_interval_s")),
            "serving_shards": self.serving_shard_union(),
            "firing": self.firing_rules(),
        }

    # ------------------------------------------------------------ lifecycle
    def _expose_counts(self) -> None:
        total = MergedVar(
            lambda: len(self.members()), "gauge",
            "fleet members known to this observer")
        live = MergedVar(
            lambda: len(self.live_members()), "gauge",
            "fleet members whose latest scrape succeeded")
        self._count_vars = [total.expose("cluster_fleet_members"),
                            live.expose("cluster_fleet_members_live")]

    def start(self) -> "FleetObserver":
        """Start the background scrape loop (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        ensure_series_installed()
        ensure_watch_hooked()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-observer", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            # budget gate: one grant per scrape round from the shared
            # Collector bucket, so observers can't stampede the fleet
            if global_collector().ask_to_be_sampled():
                try:
                    self.scrape_once()
                except Exception:
                    pass
            self._stop.wait(
                max(0.2, float(_flags.get("fleet_scrape_interval_s"))))

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None

    def hide_all(self) -> None:
        """Withdraw every exposed cluster_* var (test hygiene)."""
        for var in self._count_vars:
            var.hide()
        with self._lock:
            cluster = list(self._cluster_vars.values())
            self._cluster_vars.clear()
        for var in cluster:
            var.hide()


_global_observer: Optional[FleetObserver] = None
_observer_lock = threading.Lock()


def global_observer() -> Optional[FleetObserver]:
    return _global_observer


def set_global_observer(obs: Optional[FleetObserver]) -> Optional[FleetObserver]:
    """Install (or clear, with None) the process-wide observer the /fleet
    and /slo builtins report on. Returns the previous one."""
    global _global_observer
    with _observer_lock:
        prev, _global_observer = _global_observer, obs
    return prev
