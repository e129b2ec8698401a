"""The tpulint rule set — one AST pass per framework invariant.

Every rule documents WHY the invariant exists (which part of the
framework's correctness story it protects) so a suppression comment has
something concrete to argue against. Scopes are path-suffix based (see core.in_scope) so the
rules fire identically whether the lint root is the repo or the package.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from brpc_tpu_torch.analysis.core import (
    Finding,
    Package,
    attr_chain,
    const_str,
    has_marker,
    in_scope,
    iter_functions,
    register_rule,
)

# --------------------------------------------------------------------------
# Rule 1: no-blocking-in-poller
# --------------------------------------------------------------------------
# The EventDispatcher loops and the InputMessenger cut loop are the brpc
# "never block the event loop" discipline (PAPER.md: one blocked poller
# stalls every socket it owns). Scope: these modules wholesale, plus any
# function marked @poller_context (the native packed-batch poller, the
# tunnel's inline on_data/ACK path).

POLLER_MODULES = {"rpc/event_dispatcher.py", "rpc/input_messenger.py"}

_TIMED_KWARGS = {"timeout", "block", "blocking"}


def _has_timeout(call: ast.Call) -> bool:
    if call.args:
        return True  # positional timeout (cond.wait(left), acquire(True, 5))
    return any(kw.arg in _TIMED_KWARGS for kw in call.keywords)


def _blocking_call(call: ast.Call) -> Optional[str]:
    """Message when this call can block a poller thread, else None."""
    name = attr_chain(call.func)
    if name is None:
        return None
    last = name.split(".")[-1]
    if "sleep" in last:
        return f"{name}() sleeps on a poller thread"
    if last == "acquire" and not _has_timeout(call):
        return (f"untimed {name}() on a poller thread — pass a timeout or "
                f"restructure to a try-lock")
    if last == "wait" and not _has_timeout(call):
        return f"untimed {name}() parks a poller thread indefinitely"
    if last == "accept":
        return f"{name}() blocks on a poller thread"
    if name == "select.select":
        return "select.select() blocks on a poller thread"
    if last in ("get", "put") and not _has_timeout(call):
        recv = attr_chain(call.func.value) if isinstance(call.func,
                                                         ast.Attribute) else None
        if recv is not None and "queue" in recv.lower():
            return f"blocking queue op {name}() on a poller thread"
    return None


@register_rule(
    "no-blocking-in-poller",
    "no sleeps/untimed waits/blocking socket-queue ops on dispatcher, "
    "cut-loop, or @poller_context code")
def rule_no_blocking_in_poller(pkg: Package) -> List[Finding]:
    out: List[Finding] = []

    def scan(body_nodes, rel):
        for node in body_nodes:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    msg = _blocking_call(sub)
                    if msg is not None:
                        out.append(Finding("no-blocking-in-poller", rel,
                                           sub.lineno, msg))

    for sf in pkg.files:
        if in_scope(sf.rel, POLLER_MODULES):
            scan(sf.tree.body, sf.rel)
        else:
            for func, _cls in iter_functions(sf.tree):
                if has_marker(func, "poller_context"):
                    scan(func.body, sf.rel)
    return out


# --------------------------------------------------------------------------
# Rule 2: acquire-release pairing
# --------------------------------------------------------------------------
# The zero-copy receive/send paths hand out owned resources —
# window credits (PeerWindow.acquire) and block borrows (BlockPool
# .add_export) — that MUST return exactly once even when the code between
# acquire and release raises (a leaked credit wedges the peer's window
# forever; a leaked export blocks pool unmap). A function that acquires
# must either release inside a try/finally-or-except, or register a
# release hook (a ``release=`` callback owns the resource from then on).

PAIR_SCOPE = {"tpu/transport.py", "butil/iobuf.py"}
PAIRS: Dict[str, Set[str]] = {
    "acquire": {"release"},
    "add_export": {"drop_export"},
}


@register_rule(
    "acquire-release",
    "block/credit acquires in transport + iobuf must reach a release on "
    "all paths (try/finally, except, or a release= hook)")
def rule_acquire_release(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        if not in_scope(sf.rel, PAIR_SCOPE):
            continue
        for func, _cls in iter_functions(sf.tree):
            acquires: List[Tuple[str, ast.Call]] = []
            protected_releases: Set[str] = set()
            has_release_hook = False
            cleanup_zones: List = []
            for node in ast.walk(func):
                if isinstance(node, ast.Try):
                    cleanup_zones.extend(node.finalbody)
                    for handler in node.handlers:
                        cleanup_zones.extend(handler.body)
            for zone in cleanup_zones:
                for sub in ast.walk(zone):
                    if isinstance(sub, ast.Call):
                        name = attr_chain(sub.func)
                        if name is not None:
                            protected_releases.add(name.split(".")[-1])
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                name = attr_chain(node.func)
                if name is None:
                    continue
                last = name.split(".")[-1]
                if last in PAIRS and not name.startswith("self."):
                    # self.add_export() inside BlockPool is the definition's
                    # own bookkeeping, not a borrow by a client
                    acquires.append((name, node))
                if last in PAIRS and name.startswith("self."):
                    acquires.append((name, node))
                if any(kw.arg == "release" for kw in node.keywords):
                    has_release_hook = True
            for name, call in acquires:
                last = name.split(".")[-1]
                if func.name == last:
                    continue  # a wrapper forwarding ownership to its caller
                releases = PAIRS[last]
                if releases & protected_releases:
                    continue
                if has_release_hook:
                    continue
                out.append(Finding(
                    "acquire-release", sf.rel, call.lineno,
                    f"{name}(...) has no matching "
                    f"{'/'.join(sorted(releases))} on the exception path — "
                    f"wrap the span in try/finally (or except+re-raise), or "
                    f"register a release= hook"))
    return out


# --------------------------------------------------------------------------
# Rule 3: monotonic-clock discipline
# --------------------------------------------------------------------------
# Phase timelines are additive duration marks: one time.time()
# stamp in a duration pair lets NTP skew mint negative or inflated
# latencies silently. Everything on the trace/transport/dispatch paths
# measures with time.monotonic()/monotonic_ns(); wall clock is allowed
# only where explicitly suppressed (display timestamps).

MONO_MODULES = {"tpu/transport.py", "rpc/input_messenger.py",
                "rpc/event_dispatcher.py", "rpc/native_transport.py",
                "rpc/server_processing.py"}
MONO_PREFIXES = ("trace/",)


@register_rule(
    "monotonic-clock",
    "no time.time() in trace/, transport, or the dispatch paths that "
    "stamp phase marks")
def rule_monotonic_clock(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        if not in_scope(sf.rel, MONO_MODULES, MONO_PREFIXES):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                name = attr_chain(node.func)
                if name in ("time.time", "_time.time"):
                    out.append(Finding(
                        "monotonic-clock", sf.rel, node.lineno,
                        "time.time() on a timed path — durations must use "
                        "the monotonic clock (wall clock is display-only "
                        "and needs an explicit suppression)"))
    return out


# --------------------------------------------------------------------------
# Rule 4: lock-order acyclicity
# --------------------------------------------------------------------------
# Build the static lock-nesting graph over rpc/ + tpu/: an edge A->B for
# every ``with A: ... with B:`` lexical nesting, plus one level of
# propagation through same-class method calls made while A is held. A
# cycle is a potential deadlock between two threads taking the locks in
# opposite orders. Lock-like names: self/module attributes containing
# "lock" or "cond".

LOCK_SCOPE_PREFIXES = ("rpc/", "tpu/")


def _lock_name(expr, cls: Optional[str], rel: str) -> Optional[str]:
    name = attr_chain(expr)
    if name is None:
        return None
    base = name.split(".")[-1]
    if "lock" not in base.lower() and "cond" not in base.lower():
        return None
    if name.startswith("self."):
        return f"{cls or '?'}.{base}"
    if "." not in name:
        return f"{rel}:{name}"
    return None  # foreign receiver (win._cond): ambiguous, skip


@register_rule(
    "lock-order",
    "the static lock-nesting graph across rpc/ + tpu/ must be acyclic")
def rule_lock_order(pkg: Package) -> List[Finding]:
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    # (class, method) -> locks acquired anywhere in that method's body
    method_locks: Dict[Tuple[str, str], Set[str]] = {}
    deferred: List[Tuple[str, str, str, str, int]] = []  # held, cls, meth, rel, line

    def visit(nodes, held: List[str], cls, rel):
        for child in nodes:
            if isinstance(child, ast.With):
                acquired = []
                for item in child.items:
                    ln = _lock_name(item.context_expr, cls, rel)
                    if ln is not None:
                        for h in held:
                            edges.setdefault((h, ln), (rel, child.lineno))
                        acquired.append(ln)
                visit(child.body, held + acquired, cls, rel)
                continue
            if isinstance(child, ast.Call) and held:
                name = attr_chain(child.func)
                if name is not None and name.startswith("self.") \
                        and name.count(".") == 1 and cls is not None:
                    for h in held:
                        deferred.append((h, cls, name.split(".")[1],
                                         rel, child.lineno))
            visit(list(ast.iter_child_nodes(child)), held, cls, rel)

    for sf in pkg.files:
        if not in_scope(sf.rel, prefixes=LOCK_SCOPE_PREFIXES):
            continue
        for func, cls in iter_functions(sf.tree):
            if cls is not None:
                locks = method_locks.setdefault((cls, func.name), set())
                for node in ast.walk(func):
                    if isinstance(node, ast.With):
                        for item in node.items:
                            ln = _lock_name(item.context_expr, cls, sf.rel)
                            if ln is not None:
                                locks.add(ln)
            visit(func.body, [], cls, sf.rel)

    for held, cls, meth, rel, line in deferred:
        for ln in method_locks.get((cls, meth), ()):
            if ln != held:
                edges.setdefault((held, ln), (rel, line))

    # cycle detection (iterative DFS with colors)
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    out: List[Finding] = []
    color: Dict[str, int] = {}
    stack_path: List[str] = []
    reported: Set[frozenset] = set()

    def dfs(n: str):
        color[n] = 1
        stack_path.append(n)
        for m in adj.get(n, ()):
            if color.get(m, 0) == 0:
                dfs(m)
            elif color.get(m) == 1:
                cyc = stack_path[stack_path.index(m):] + [m]
                key = frozenset(cyc)
                if key not in reported:
                    reported.add(key)
                    rel, line = edges[(n, m)]
                    out.append(Finding(
                        "lock-order", rel, line,
                        "lock-order cycle: " + " -> ".join(cyc) +
                        " (two threads taking these in opposite order "
                        "deadlock)"))
        stack_path.pop()
        color[n] = 2

    for n in list(adj):
        if color.get(n, 0) == 0:
            dfs(n)
    return out


# --------------------------------------------------------------------------
# Rule 5: version-guard integrity
# --------------------------------------------------------------------------
# The reference pins its version-fragile JAX APIs (shard_map's import
# path, check_vma, lax.pvary) to a few shim modules. The port's version
# floor is torch's, and its one version-fragile surface is the
# multi-process mesh API (``torch.distributed.device_mesh`` /
# ``init_device_mesh``, moved between releases, and the private
# ``torch.distributed._tensor`` it came from): only the shim module that
# builds rank meshes (tpu/launch.py) may touch it, so a torch that moves
# it again breaks one file. The port has no JAX shim at all: a JAX name
# anywhere in the tree (an import of jax/jaxlib or of the reference
# package, shard_map, check_vma=/vma=, lax.pvary/pcast) is a finding.

SHIM_MODULES = {"tpu/launch.py"}
_FRAGILE_TORCH_MODULES = ("torch.distributed.device_mesh",
                          "torch.distributed._tensor",
                          "torch.distributed.tensor")
_JAX_ROOTS = {"jax", "jaxlib", "brpc_tpu"}


def _jax_module(mod: str) -> bool:
    return mod.split(".")[0] in _JAX_ROOTS


def _fragile_torch_module(mod: str) -> bool:
    return any(mod == m or mod.startswith(m + ".")
               for m in _FRAGILE_TORCH_MODULES)


@register_rule(
    "version-guard",
    "version-fragile torch APIs (torch.distributed.device_mesh, "
    "init_device_mesh) only inside the shim module tpu/launch.py, and no "
    "JAX name (jax/jaxlib/brpc_tpu imports, shard_map, check_vma/vma "
    "kwargs, lax.pvary/pcast) anywhere in the port")
def rule_version_guard(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        shim = in_scope(sf.rel, SHIM_MODULES)
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                if isinstance(node, ast.Import):
                    mods = [alias.name for alias in node.names]
                else:
                    mods = [node.module or ""]
                    if node.module == "torch.distributed":
                        mods += [f"torch.distributed.{a.name}"
                                 for a in node.names]
                for mod in mods:
                    if _jax_module(mod):
                        out.append(Finding(
                            "version-guard", sf.rel, node.lineno,
                            f"import of {mod!r} — the port imports no JAX "
                            f"name and nothing of the reference package"))
                    elif _fragile_torch_module(mod) and not shim:
                        out.append(Finding(
                            "version-guard", sf.rel, node.lineno,
                            f"direct {mod} import — the device-mesh API "
                            f"moves between torch releases; route through "
                            f"the tpu/launch.py shim"))
                if isinstance(node, ast.ImportFrom) and any(
                        a.name == "shard_map" for a in node.names):
                    out.append(Finding(
                        "version-guard", sf.rel, node.lineno,
                        "shard_map import — a JAX name; the port's mesh "
                        "programs run over tpu/mesh.py and tpu/launch.py"))
            elif isinstance(node, ast.Call):
                fname = attr_chain(node.func) or ""
                if fname.split(".")[-1] == "init_device_mesh" and not shim:
                    out.append(Finding(
                        "version-guard", sf.rel, node.lineno,
                        "init_device_mesh() outside the tpu/launch.py "
                        "shim — build rank meshes through launch.py"))
                if fname.split(".")[0] in ("jax", "jnp", "lax") and \
                        fname.split(".")[-1] not in ("pvary", "pcast"):
                    out.append(Finding(
                        "version-guard", sf.rel, node.lineno,
                        f"{fname}() is a JAX call — the port has no JAX"))
                for kw in node.keywords:
                    if kw.arg == "check_vma":
                        out.append(Finding(
                            "version-guard", sf.rel, node.lineno,
                            "check_vma= is a JAX shard_map keyword — the "
                            "port has no JAX"))
                    elif kw.arg == "vma" and fname.endswith("ShapeDtypeStruct"):
                        out.append(Finding(
                            "version-guard", sf.rel, node.lineno,
                            "ShapeDtypeStruct(vma=...) is a JAX name — the "
                            "port has no JAX"))
            elif isinstance(node, ast.Attribute):
                if node.attr in ("pvary", "pcast"):
                    recv = attr_chain(node.value)
                    if recv is not None and recv.split(".")[-1] == "lax":
                        out.append(Finding(
                            "version-guard", sf.rel, node.lineno,
                            f"lax.{node.attr} is a JAX name — the port has "
                            f"no JAX"))
    return out


# --------------------------------------------------------------------------
# Rule 6: metric/flag hygiene
# --------------------------------------------------------------------------
# The /vars surface is the operational contract: a g_* var that is
# never exposed is invisible; a name exposed twice raises at import in one
# order and silently shadows in another; a flags.get("name") with no
# define() anywhere raises FlagError at first read — in production, on the
# hot path. All three are whole-package properties no single-file review
# can check.

_METRIC_CTORS = {"Adder", "Maxer", "Miner", "PassiveStatus", "Status",
                 "LatencyRecorder", "_PassiveStatus"}


def _call_last_name(node: ast.Call) -> Optional[str]:
    """Last name component of a call target, robust to chains rooted in
    another call (``_PassiveStatus(...).expose`` -> "expose")."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _registered_name(call: ast.Call) -> Optional[str]:
    """Constant exposure name carried by a metric construction chain:
    Adder("g_x"), X(...).expose("g_x"), X(...).expose_as("g_x")."""
    node = call
    while isinstance(node, ast.Call):
        last = _call_last_name(node)
        if last in ("expose", "expose_as", "Adder") and node.args:
            s = const_str(node.args[0])
            if s is not None:
                return s
        func = node.func
        node = func.value if isinstance(func, ast.Attribute) else None
    return None


def _is_metric_ctor_chain(call: ast.Call) -> bool:
    node = call
    while isinstance(node, ast.Call):
        if _call_last_name(node) in _METRIC_CTORS:
            return True
        func = node.func
        node = func.value if isinstance(func, ast.Attribute) else None
    return False


@register_rule(
    "metric-flag-hygiene",
    "every g_* metric registered exactly once under its own name; every "
    "flags.get() literal has a define() somewhere in the package")
def rule_metric_flag_hygiene(pkg: Package) -> List[Finding]:
    defines: Set[str] = set()
    exposures: Dict[str, List[Tuple[str, int]]] = {}
    reads: List[Tuple[str, str, int]] = []
    assigns: List[Tuple[str, ast.Call, str, int]] = []

    for sf in pkg.files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                last = _call_last_name(node)
                if last is None:
                    continue
                if last == "define" and node.args:
                    s = const_str(node.args[0])
                    if s is not None:
                        defines.add(s)
                elif last in ("expose", "expose_as") and node.args:
                    s = const_str(node.args[0])
                    if s is not None:
                        exposures.setdefault(s, []).append(
                            (sf.rel, node.lineno))
                elif last == "Adder" and node.args:
                    s = const_str(node.args[0])
                    if s is not None:
                        exposures.setdefault(s, []).append(
                            (sf.rel, node.lineno))
                elif last == "get" and isinstance(node.func, ast.Attribute):
                    recv = attr_chain(node.func.value)
                    if recv in ("flags", "_flags") and node.args:
                        s = const_str(node.args[0])
                        if s is not None:
                            reads.append((s, sf.rel, node.lineno))
            elif isinstance(node, ast.Assign):
                if (len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id.startswith("g_")
                        and isinstance(node.value, ast.Call)):
                    assigns.append((node.targets[0].id, node.value,
                                    sf.rel, node.lineno))

    out: List[Finding] = []
    for name, locs in sorted(exposures.items()):
        if len(locs) > 1:
            first = locs[0]
            for rel, line in locs[1:]:
                out.append(Finding(
                    "metric-flag-hygiene", rel, line,
                    f"metric {name!r} exposed more than once (first at "
                    f"{first[0]}:{first[1]}) — duplicate exposure raises "
                    f"or shadows depending on import order"))
    for var, call, rel, line in assigns:
        if not _is_metric_ctor_chain(call):
            continue
        reg = _registered_name(call)
        if reg is None:
            out.append(Finding(
                "metric-flag-hygiene", rel, line,
                f"{var} is a metric that is never exposed — name it "
                f"({var} = Adder({var!r})) or drop the g_ prefix"))
        elif reg != var:
            out.append(Finding(
                "metric-flag-hygiene", rel, line,
                f"{var} registered under mismatched name {reg!r} — /vars "
                f"consumers grep the variable name"))
    for name, rel, line in reads:
        if name not in defines:
            out.append(Finding(
                "metric-flag-hygiene", rel, line,
                f"flags.get({name!r}) has no define() anywhere in the "
                f"package — first read raises FlagError at runtime"))
    return out


# --------------------------------------------------------------------------
# Rule 7: named-thread
# --------------------------------------------------------------------------
# The profiler attributes samples and /status counts vitals by thread; an
# anonymous "Thread-12" in a flamegraph or a stack dump is unactionable.
# Every threading.Thread() the framework creates must carry a name= (role
# registration is runtime — the name is the static half of the contract).

def _is_thread_ctor(call: ast.Call, bare_thread_imported: bool) -> bool:
    name = attr_chain(call.func)
    if name is None:
        return False
    if name in ("threading.Thread", "_threading.Thread"):
        return True
    return name == "Thread" and bare_thread_imported


@register_rule(
    "named-thread",
    "every threading.Thread(...) construction must pass name= — anonymous "
    "threads are unattributable in profiles and stack dumps")
def rule_named_thread(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        bare = False
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "threading":
                if any(a.name == "Thread" for a in node.names):
                    bare = True
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if not _is_thread_ctor(node, bare):
                continue
            if any(kw.arg is None for kw in node.keywords):
                continue  # **kwargs — can't prove name is absent
            if any(kw.arg == "name" for kw in node.keywords):
                continue
            out.append(Finding(
                "named-thread", sf.rel, node.lineno,
                "threading.Thread(...) without name= — anonymous threads "
                "show up as Thread-N in /threads and profiler output; "
                "name it after its role"))
    return out


# --------------------------------------------------------------------------
# Rule 8: bounded-spin
# --------------------------------------------------------------------------
# The wakeup discipline: a busy-wait loop — one whose body never
# parks (no sleep/wait/select/poll/acquire/join/recv/accept/get call) —
# burns the core, and under the GIL it holds off the very thread it is
# waiting on. Every such loop must either be bounded by a spin budget
# (reference an identifier containing "spin" or "budget", i.e. route
# through fiber.wakeup.AdaptiveSpin) or demonstrably make progress on its
# own condition (assign/mutate a name its test reads, or exit via
# break/return/raise).

_PARK_TOKENS = ("sleep", "wait", "select", "poll", "acquire", "join",
                "recv", "accept", "park", "get", "read")


def _while_identifiers(node: ast.While) -> Set[str]:
    names: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            names.add(sub.id.lower())
        elif isinstance(sub, ast.Attribute):
            names.add(sub.attr.lower())
    return names


def _test_refs(test) -> Set[str]:
    """Names + attribute chains the loop condition reads."""
    refs: Set[str] = set()
    for sub in ast.walk(test):
        if isinstance(sub, ast.Name):
            refs.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            chain = attr_chain(sub)
            if chain is not None:
                refs.add(chain)
    return refs


def _target_refs(target) -> Set[str]:
    refs: Set[str] = set()
    for sub in ast.walk(target):
        if isinstance(sub, ast.Name):
            refs.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            chain = attr_chain(sub)
            if chain is not None:
                refs.add(chain)
        elif isinstance(sub, ast.Subscript):
            chain = attr_chain(sub.value)
            if chain is not None:
                refs.add(chain)
    return refs


@register_rule(
    "bounded-spin",
    "busy-wait loops (no park/sleep/select call in the body) must be "
    "bounded by a spin budget or make progress on their own condition")
def rule_bounded_spin(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.While):
                continue
            parks = False
            exits = False
            progress: Set[str] = set()
            test_refs = _test_refs(node.test)
            for sub in ast.walk(node.test):
                # a consuming I/O call in the condition itself
                # (`while os.read(fd, n):` pipe drains) is not a busy-wait
                if isinstance(sub, ast.Call):
                    name = attr_chain(sub.func)
                    if name is not None and any(
                            t in name.split(".")[-1].lower()
                            for t in _PARK_TOKENS):
                        parks = True
            for child in node.body:
                for sub in ast.walk(child):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        break  # nested defs don't run in the loop body
                    if isinstance(sub, (ast.Break, ast.Return, ast.Raise)):
                        exits = True
                    elif isinstance(sub, ast.Call):
                        name = attr_chain(sub.func)
                        if name is not None:
                            last = name.split(".")[-1].lower()
                            if any(t in last for t in _PARK_TOKENS):
                                parks = True
                            if isinstance(sub.func, ast.Attribute):
                                # a mutating call on a tested receiver
                                # (`while q: q.popleft()`) is progress
                                recv = attr_chain(sub.func.value)
                                if recv is not None:
                                    progress.add(recv)
                    elif isinstance(sub, (ast.Assign, ast.AugAssign,
                                          ast.AnnAssign)):
                        targets = (sub.targets
                                   if isinstance(sub, ast.Assign)
                                   else [sub.target])
                        for t in targets:
                            progress |= _target_refs(t)
                    elif isinstance(sub, ast.NamedExpr):
                        progress |= _target_refs(sub.target)
                    elif isinstance(sub, ast.For):
                        progress |= _target_refs(sub.target)
            if parks or exits or (progress & test_refs):
                continue
            idents = _while_identifiers(node)
            if any("spin" in i or "budget" in i for i in idents):
                continue
            out.append(Finding(
                "bounded-spin", sf.rel, node.lineno,
                "busy-wait loop: the body neither parks "
                "(sleep/wait/select/...), exits, nor advances the loop "
                "condition — bound it with a fiber.wakeup.AdaptiveSpin "
                "budget or park between probes"))
    return out


# --------------------------------------------------------------------------
# Rule 9: cross-process-ownership
# --------------------------------------------------------------------------
# The shard plane's handle-passing contract (docs/sharded-dispatch.md):
# what crosses a worker process boundary is named shm handles, block
# indices, and byte lengths — never live ownership objects. Pickling an
# IOBuf/Block/pool/socket "works" (the bytes copy across) but silently
# forks ownership: two processes each believe they hold the buffer or the
# credit, and release hooks fire twice or never. Scope: brpc_tpu_torch/shard/
# wholesale — the only package that talks across the boundary.

_XPO_SCOPE_PREFIXES = ("shard/",)
_XPO_BANNED_IMPORTS = {"pickle", "cPickle", "dill", "marshal"}
_XPO_BANNED_MP = {"Queue", "SimpleQueue", "JoinableQueue", "Pipe",
                  "Manager", "Pool"}
_XPO_OWNED_CTORS = {"IOBuf", "BlockPool", "PeerWindow",
                    "TpuTransportSocket", "socket"}
_XPO_OWNED_ATTRS = {"read_buf", "ctrl", "vsock"}
_XPO_SEND_CALLS = {"push", "send", "send_bytes", "put", "put_nowait",
                   "dumps"}


@register_rule(
    "cross-process-ownership",
    "code under brpc_tpu_torch/shard/ may not pickle or queue live ownership "
    "objects (IOBuf, pools, sockets) across the process boundary — only "
    "named shm handles, block indices, and byte lengths cross")
def rule_cross_process_ownership(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        if not in_scope(sf.rel, prefixes=_XPO_SCOPE_PREFIXES):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[0] in _XPO_BANNED_IMPORTS:
                        out.append(Finding(
                            "cross-process-ownership", sf.rel, node.lineno,
                            f"import {a.name} in shard/ — serialized "
                            f"objects fork ownership across the process "
                            f"boundary; ship named handles and indices "
                            f"instead"))
            elif isinstance(node, ast.ImportFrom):
                mod = (node.module or "").split(".")[0]
                if mod in _XPO_BANNED_IMPORTS:
                    out.append(Finding(
                        "cross-process-ownership", sf.rel, node.lineno,
                        f"from {node.module} import ... in shard/ — "
                        f"serialized objects fork ownership across the "
                        f"process boundary; ship named handles instead"))
                elif mod == "multiprocessing":
                    for a in node.names:
                        if a.name in _XPO_BANNED_MP:
                            out.append(Finding(
                                "cross-process-ownership", sf.rel,
                                node.lineno,
                                f"multiprocessing.{a.name} pickles its "
                                f"payload under the hood — shard rings "
                                f"carry flat bytes only (shared_memory "
                                f"and resource_tracker are the allowed "
                                f"multiprocessing imports)"))
            elif isinstance(node, ast.Call):
                name = attr_chain(node.func) or ""
                last = name.split(".")[-1]
                if last in _XPO_BANNED_MP and (
                        name.startswith("multiprocessing.")
                        or name.startswith("mp.")):
                    out.append(Finding(
                        "cross-process-ownership", sf.rel, node.lineno,
                        f"{name}() pickles its payload under the hood — "
                        f"shard rings carry flat bytes only"))
        # per-function taint pass: a name bound from an ownership ctor or
        # an owned attribute must not be handed to a cross-boundary send
        for func, _cls in iter_functions(sf.tree):
            tainted: Set[str] = set()
            for node in ast.walk(func):
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    v = node.value
                    src = None
                    if isinstance(v, ast.Call):
                        src = (attr_chain(v.func) or "").split(".")[-1]
                    elif isinstance(v, ast.Attribute):
                        src = v.attr
                    if src in _XPO_OWNED_CTORS or src in _XPO_OWNED_ATTRS:
                        tainted.add(node.targets[0].id)
            if not tainted:
                continue
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                name = attr_chain(node.func) or ""
                if name.split(".")[-1] not in _XPO_SEND_CALLS:
                    continue
                for arg in node.args:
                    if isinstance(arg, ast.Name) and arg.id in tainted:
                        out.append(Finding(
                            "cross-process-ownership", sf.rel, node.lineno,
                            f"'{arg.id}' holds a live ownership object "
                            f"(IOBuf/pool/socket) passed to {name}() — "
                            f"only named handles, block indices, and "
                            f"byte lengths may cross the process "
                            f"boundary"))
    return out


# --------------------------------------------------------------------------
# Rule 10: metric-churn
# --------------------------------------------------------------------------
# Metric construction is deliberately expensive relative to metric updates:
# a Reducer allocates TLS agent machinery, expose() takes the registry lock,
# Window/PerSecond register a Sampler with the daemon — and every
# exposed var also grows a series ring swept once per second. Constructing
# (or exposing) one inside a request-path function churns allocations per
# RPC and can grow the registry without bound. Vars must be module-level or
# cached per method (rpc/server.py's MethodEntry lazy-expose pattern, which
# is guarded by a flag and runs once — server.py is deliberately outside
# this rule's scope).

_CHURN_MODULES = {
    "rpc/server_processing.py", "rpc/input_messenger.py",
    "rpc/event_dispatcher.py", "rpc/run_to_completion.py",
    "rpc/native_transport.py", "tpu/transport.py",
    "batch/runtime.py", "batch/queue.py", "shard/worker.py",
}

_CHURN_CTORS = {"Adder", "Maxer", "Miner", "LatencyRecorder", "IntRecorder",
                "Window", "PerSecond", "WindowedPercentile", "MultiDimension",
                "Status", "PassiveStatus"}


# --------------------------------------------------------------------------
# Rule 11: no-per-token-host-sync
# --------------------------------------------------------------------------
# The serving engine's throughput contract: each decode step issues ONE
# fused device program for the whole batch and host-materializes its
# tokens exactly once, at the step boundary (model.decode_step's single
# device-to-host copy). A host sync inside a per-token/per-sequence loop
# — ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
# ``torch.cuda.synchronize()``, ``np.asarray()`` on a tensor — serializes
# the device queue per token and turns the step's O(1) syncs into
# O(batch x new_tokens). Scope: serving/ wholesale; the sync primitives
# are fine at function scope (once per call), the rule fires only when
# one sits lexically inside a for/while loop. ``np.asarray`` is read as a
# sync wherever it appears in such a loop: the AST cannot tell a tensor
# argument from a host array, so a host-only use carries a suppression
# that says so.

_SYNC_SCOPE_PREFIXES = ("serving/",)
_SYNC_ATTR_CALLS = {"item", "cpu", "tolist", "numpy"}
_SYNC_NP_RECEIVERS = {"np", "numpy", "onp"}


def _host_sync_call(call: ast.Call) -> Optional[str]:
    """Message when this call forces a device->host sync, else None."""
    name = attr_chain(call.func)
    if name is None:
        # a chain rooted in a call or subscript: t[i].item(), f(x).cpu()
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in \
                _SYNC_ATTR_CALLS and not call.args and not call.keywords:
            name = f"<expr>.{func.attr}"
        else:
            return None
    last = name.split(".")[-1]
    if last in _SYNC_ATTR_CALLS and "." in name and not call.args \
            and not call.keywords:
        return (f"{name}() forces a device->host sync; hoist it out of "
                f"the loop and materialize the whole batch once")
    if name.endswith("cuda.synchronize"):
        return (f"{name}() drains the device queue per iteration; sync "
                f"once per step instead")
    if last == "asarray" and "." in name \
            and name.split(".")[0] in _SYNC_NP_RECEIVERS:
        return (f"{name}() on a tensor blocks until the result is on the "
                f"host; batch the transfer outside the loop")
    return None


@register_rule(
    "no-per-token-host-sync",
    "serving/ code must not force device->host syncs "
    "(.item()/.cpu()/.tolist()/.numpy()/torch.cuda.synchronize()/"
    "np.asarray) inside per-token or per-sequence loops — one "
    "materialization per step")
def rule_no_per_token_host_sync(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        if not in_scope(sf.rel, prefixes=_SYNC_SCOPE_PREFIXES):
            continue
        seen: Set[Tuple[int, int]] = set()  # nested loops: report once
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            for child in node.body + node.orelse:
                for sub in ast.walk(child):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        # nested defs don't run per iteration of THIS
                        # loop; if they sync in their own loops the walk
                        # visits those separately
                        break
                    if isinstance(sub, ast.Call):
                        msg = _host_sync_call(sub)
                        key = (sub.lineno, sub.col_offset)
                        if msg is not None and key not in seen:
                            seen.add(key)
                            out.append(Finding(
                                "no-per-token-host-sync", sf.rel,
                                sub.lineno, msg))
    return out


# --------------------------------------------------------------------------
# Rule 12: no-per-op-step-dispatch
# --------------------------------------------------------------------------
# The sharded serving plane's dispatch contract: per-step device work
# collapses into ONE fused launch, and bulk device copies ride the device
# lane's coalescing queue (DeviceStore.copy(transient=True) /
# copy_coalesced), which the dispatcher thread fuses into batched copy
# launches. Issuing a SYNCHRONOUS device dispatch per item of a loop —
# store.copy() without transient=True, a stub .Copy() RPC per element, a
# host-to-device ``.to(device)`` / ``.cuda()`` per element — is the
# per-op pattern the coalesced path exists to kill. Scope: serving/ and
# the tpu/ device lane + streams. Transient copies are exempt: they ENTER
# the coalescing queue, which is the point. ``.to()`` with only a dtype
# (``torch.float32``, ``dtype=``) is a cast, not a transfer.

_STEP_DISPATCH_SCOPE_PREFIXES = ("serving/", "tpu/device_lane.py",
                                 "tpu/device_stream.py")
_DTYPE_NAMES = {"float32", "float16", "bfloat16", "float64", "int8",
                "uint8", "int16", "int32", "int64", "bool", "float", "half",
                "double", "long", "int"}


def _is_dtype_expr(node) -> bool:
    name = attr_chain(node)
    if name is None:
        return False
    last = name.split(".")[-1]
    return last in _DTYPE_NAMES or "dtype" in last.lower()


def _device_transfer(call: ast.Call) -> bool:
    """``x.to(device)`` / ``x.to(device=...)``: a host<->device move, as
    opposed to ``x.to(torch.float32)``, a cast on the tensor's device."""
    if any(kw.arg == "device" for kw in call.keywords):
        return True
    return bool(call.args) and not _is_dtype_expr(call.args[0])


def _per_op_dispatch_call(call: ast.Call) -> Optional[str]:
    """Message when this call issues one synchronous device dispatch per
    loop iteration, else None."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    name = attr_chain(func) or f"<expr>.{func.attr}"
    parts = name.split(".")
    last = parts[-1]
    if last == "copy" and len(parts) > 1 and "store" in parts[-2].lower():
        for kw in call.keywords:
            if kw.arg == "transient" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is True:
                return None  # rides the coalescing queue — the async path
        return (f"{name}() dispatches one device program per iteration "
                f"(~ms each isolated); use transient=True or "
                f"copy_coalesced to ride the fused dispatch queue")
    if last == "Copy" and len(parts) > 1:
        return (f"{name}() issues one Copy RPC -> one device dispatch per "
                f"iteration; batch with nbytes=-k (coalesced rider) or "
                f"re-issue from the response callback chain")
    if last == "cuda" and not call.keywords and len(parts) > 1 \
            and parts[-2] != "torch":
        return (f"{name}() stages one host->device transfer per "
                f"iteration; stack the batch and transfer once")
    if last == "to" and _device_transfer(call):
        return (f"{name}(device) stages one host<->device transfer per "
                f"iteration; stack the batch and transfer once")
    return None


@register_rule(
    "no-per-op-step-dispatch",
    "serving/ and device-lane code must not issue a synchronous device "
    "dispatch (store.copy without transient=True, stub.Copy, "
    ".to(device), .cuda()) per iteration of a loop — per-step work is ONE "
    "fused launch")
def rule_no_per_op_step_dispatch(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        if not in_scope(sf.rel, prefixes=_STEP_DISPATCH_SCOPE_PREFIXES):
            continue
        seen: Set[Tuple[int, int]] = set()
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            for child in node.body + node.orelse:
                for sub in ast.walk(child):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        # nested defs don't dispatch per iteration of
                        # THIS loop; their own loops are walked separately
                        break
                    if isinstance(sub, ast.Call):
                        msg = _per_op_dispatch_call(sub)
                        key = (sub.lineno, sub.col_offset)
                        if msg is not None and key not in seen:
                            seen.add(key)
                            out.append(Finding(
                                "no-per-op-step-dispatch", sf.rel,
                                sub.lineno, msg))
    return out


# --------------------------------------------------------------------------
# Rule 13: cow-before-write
# --------------------------------------------------------------------------
# The prefix cache's sharing contract (docs/serving.md): KV blocks can be
# referenced by several sequences and by the radix tree at once, so any
# function that commits writes into the K/V pool arrays (the
# update_pools(...) swap is the commit point for every scatter) must
# first prove exclusivity — an assert_writable/ensure_writable/cow_* call
# or an explicit refcount == 1 check in the same function. A write behind
# a shared block silently corrupts every other chain reading it; the
# runtime guard (kv.assert_writable under BRPC_TPU_CHECK) catches it in
# tests, this rule catches it at lint time for paths tests never arm.

_COW_SCOPE_PREFIXES = ("serving/",)


def _cow_write_sites(func: ast.AST) -> List[ast.Call]:
    sites: List[ast.Call] = []
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            name = attr_chain(node.func)
            if name is not None and name.split(".")[-1] == "update_pools":
                sites.append(node)
    return sites


def _cow_guarded(func: ast.AST) -> bool:
    """True when the function proves block exclusivity before writing:
    a cow-split/writable-guard call, or a refcount == 1 comparison."""
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            name = attr_chain(node.func)
            if name is not None:
                last = name.split(".")[-1]
                if "cow" in last or "writable" in last:
                    return True
        elif isinstance(node, ast.Compare):
            if any(isinstance(op, ast.Eq) for op in node.ops) \
                    and any(isinstance(c, ast.Constant) and c.value == 1
                            for c in node.comparators) \
                    and "ref" in ast.dump(node).lower():
                return True
    return False


@register_rule(
    "cow-before-write",
    "serving/ functions that write into the KV pool arrays (the "
    "update_pools commit) must cow-split or assert refcount==1 first — "
    "shared prefix blocks are never mutated in place")
def rule_cow_before_write(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        if not in_scope(sf.rel, prefixes=_COW_SCOPE_PREFIXES):
            continue
        for func, cls in iter_functions(sf.tree):
            if "cow" in func.name or "writable" in func.name:
                continue  # the split/guard implementations themselves
            sites = _cow_write_sites(func)
            if not sites or _cow_guarded(func):
                continue
            where = f"{cls}.{func.name}" if cls else func.name
            for call in sites:
                out.append(Finding(
                    "cow-before-write", sf.rel, call.lineno,
                    f"{where}() commits a KV pool write (update_pools) "
                    f"with no cow-split or refcount==1 guard in scope — "
                    f"a shared prefix block would be mutated in place; "
                    f"call kv.assert_writable/ensure_writable (or "
                    f"cow_block) before the scatter"))
    return out


@register_rule(
    "metric-churn",
    "no metric construction (Adder/LatencyRecorder/Window/...) or expose() "
    "inside request-path functions (dispatch/transport/batch modules) — "
    "vars must be module-level or cached per method")
def rule_metric_churn(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        if not in_scope(sf.rel, exact=_CHURN_MODULES):
            continue
        for func, cls in iter_functions(sf.tree):
            where = f"{cls}.{func.name}" if cls else func.name
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                last = _call_last_name(node)
                if last in _CHURN_CTORS:
                    out.append(Finding(
                        "metric-churn", sf.rel, node.lineno,
                        f"{last}(...) constructed inside request-path "
                        f"function {where}() — metric construction "
                        f"allocates TLS agents/samplers per call; hoist "
                        f"to module level or cache per method"))
                elif last in ("expose", "expose_as"):
                    out.append(Finding(
                        "metric-churn", sf.rel, node.lineno,
                        f".{last}(...) inside request-path function "
                        f"{where}() — exposing takes the registry lock "
                        f"and grows /vars (and its series rings) per "
                        f"call; expose once at module scope"))
    return out


# --------------------------------------------------------------------------
# Rule 15: quiesce-before-migrate
# --------------------------------------------------------------------------
# The migration plane's ownership contract (docs/serving.md): a block
# chain may only leave a shard through export_chain(), and export is only
# sound over a sequence that has been quiesced — audited and marked
# read-only — in the same control flow. Exporting a chain that another
# step could still extend/cow races the record stream against the
# scheduler: the destination adopts a stale table while the source keeps
# writing. The runtime guard (export_chain asserts the quiesce mark)
# catches it under BRPC_TPU_CHECK; this rule catches it at lint time for
# paths tests never arm.

_MIGRATE_SCOPE_PREFIXES = ("serving/",)


def _export_sites(func: ast.AST) -> List[ast.Call]:
    sites: List[ast.Call] = []
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            name = attr_chain(node.func)
            if name is not None and name.split(".")[-1] == "export_chain":
                sites.append(node)
    return sites


def _quiesce_guarded(func: ast.AST) -> bool:
    """True when the function proves the sequence is quiesced before
    exporting: any quiesce_* call in the same function body."""
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            name = attr_chain(node.func)
            if name is not None and "quiesce" in name.split(".")[-1]:
                return True
    return False


@register_rule(
    "quiesce-before-migrate",
    "serving/ functions that export a KV block chain (export_chain) must "
    "quiesce the sequence in the same function first — migrating a chain "
    "the scheduler can still write races the record stream")
def rule_quiesce_before_migrate(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        if not in_scope(sf.rel, prefixes=_MIGRATE_SCOPE_PREFIXES):
            continue
        for func, cls in iter_functions(sf.tree):
            if "quiesce" in func.name or "export" in func.name:
                continue  # the quiesce/export implementations themselves
            sites = _export_sites(func)
            if not sites or _quiesce_guarded(func):
                continue
            where = f"{cls}.{func.name}" if cls else func.name
            for call in sites:
                out.append(Finding(
                    "quiesce-before-migrate", sf.rel, call.lineno,
                    f"{where}() exports a KV block chain (export_chain) "
                    f"with no quiesce call in scope — the scheduler can "
                    f"still extend/cow the sequence while its blocks "
                    f"stream out; call kv.quiesce_sequence first and "
                    f"unquiesce on failure"))
    return out


# --------------------------------------------------------------------------
# Rule 16: draft-no-device-sync
# --------------------------------------------------------------------------
# Speculative decoding's throughput story rests on the draft lane being
# FREE on the device timeline: prompt-lookup drafting runs as pure host
# Python over the committed token history, so a step is still exactly one
# fused launch (the verify) and one host sync, and the engine's launch and
# sync audit keeps holding with k drafts exactly as it did with none. A
# torch import or a device call (``.cuda()``, ``.to()``, ``.item()``,
# ``.cpu()``, ``.numpy()``, ``torch.*``) creeping into the drafter would
# silently turn every step into 1+N launches or syncs — the rule pins the
# whole module host-side at lint time, where the runtime audit only sees
# paths tests exercise.

_DRAFT_SCOPE = {"serving/speculative.py"}
_DRAFT_IMPORT_ROOTS = {"torch", "triton", "jax"}
_DRAFT_DEVICE_CALLS = {"cuda", "to", "item", "cpu", "numpy", "synchronize",
                       "pin_memory"}


@register_rule(
    "draft-no-device-sync",
    "the speculative draft lane (serving/speculative.py) must stay "
    "host-side: no torch import, no device call (.cuda/.to/.item/.cpu/"
    ".numpy/torch.*) — drafting rides the step's single verify launch")
def rule_draft_no_device_sync(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        if not in_scope(sf.rel, _DRAFT_SCOPE):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    root = alias.name.split(".")[0]
                    if root in _DRAFT_IMPORT_ROOTS:
                        out.append(Finding(
                            "draft-no-device-sync", sf.rel, node.lineno,
                            f"draft-lane module imports {alias.name!r} — "
                            f"drafting must stay host-side (zero device "
                            f"work before the one fused verify launch)"))
            elif isinstance(node, ast.ImportFrom):
                root = (node.module or "").split(".")[0]
                if root in _DRAFT_IMPORT_ROOTS:
                    out.append(Finding(
                        "draft-no-device-sync", sf.rel, node.lineno,
                        f"draft-lane module imports from "
                        f"{node.module!r} — drafting must stay "
                        f"host-side"))
            elif isinstance(node, ast.Call):
                func = node.func
                name = attr_chain(func)
                if name is None and isinstance(func, ast.Attribute):
                    name = f"<expr>.{func.attr}"
                if name is None:
                    continue
                parts = name.split(".")
                if parts[0] == "torch" or (
                        len(parts) > 1 and parts[-1] in _DRAFT_DEVICE_CALLS):
                    out.append(Finding(
                        "draft-no-device-sync", sf.rel, node.lineno,
                        f"{name}() dispatches device work or forces a "
                        f"host sync inside the draft lane — the step "
                        f"contract is ONE launch (the fused verify) and "
                        f"ONE sync; draft from the committed host-side "
                        f"history instead"))
    return out


# --------------------------------------------------------------------------
# Rule 17: shed-before-queue
# --------------------------------------------------------------------------
# The QoS overload contract (docs/serving.md §Multi-tenant QoS): every
# sequence that lands on the engine's waiting queue has already passed
# the admission predicate — deadline still live, tenant under its queue
# cap, the limiter ceiling not exceeded. A new code path that appends to
# a waiting lane without consulting the check silently reopens the
# unbounded-queue failure mode the closed loop exists to prevent: the
# governor only sheds what it can see, and an unchecked append is load
# the ceiling never metered. The runtime re-check inside
# TenantScheduler.enqueue guards the paths tests exercise; this rule
# pins the invariant at lint time for paths they don't.

_QOS_SCOPE_PREFIXES = ("serving/",)
_QOS_QUEUE_ATTRS = {"waiting", "_waiting"}
_QOS_ADMIT_GUARDS = ("can_admit", "admission_check")


def _queue_append_sites(func: ast.AST) -> List[ast.Call]:
    sites: List[ast.Call] = []
    for node in ast.walk(func):
        if not isinstance(node, ast.Call):
            continue
        name = attr_chain(node.func)
        if name is None:
            continue
        parts = name.split(".")
        if (len(parts) >= 2 and parts[-1] == "append"
                and parts[-2] in _QOS_QUEUE_ATTRS):
            sites.append(node)
    return sites


def _admission_guarded(func: ast.AST) -> bool:
    """True when the function consults the admission predicate anywhere
    in its body: a call whose final attribute names the KV watermark
    check (can_admit) or the QoS check (admission_check)."""
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            name = attr_chain(node.func)
            if name is None:
                continue
            last = name.split(".")[-1]
            if any(g in last for g in _QOS_ADMIT_GUARDS):
                return True
    return False


@register_rule(
    "shed-before-queue",
    "serving/ functions appending to a waiting queue must consult the "
    "admission check (deadline + tenant cap + limiter ceiling) in the "
    "same function — no append may bypass QoS shedding")
def rule_shed_before_queue(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        if not in_scope(sf.rel, prefixes=_QOS_SCOPE_PREFIXES):
            continue
        for func, cls in iter_functions(sf.tree):
            sites = _queue_append_sites(func)
            if not sites or _admission_guarded(func):
                continue
            where = f"{cls}.{func.name}" if cls else func.name
            for call in sites:
                out.append(Finding(
                    "shed-before-queue", sf.rel, call.lineno,
                    f"{where}() appends to a waiting queue with no "
                    f"admission check in scope — queue growth the "
                    f"limiter ceiling never metered reopens unbounded "
                    f"queueing under overload; consult "
                    f"can_admit/admission_check before the append"))
    return out


# --------------------------------------------------------------------------
# Rule 18: budget-gated-scrape
# --------------------------------------------------------------------------
# The fleet plane's politeness contract (docs/observability.md §Fleet
# observer): a periodic scrape loop in fleet/ multiplies by the number of
# members AND the number of observers, so it must stay retunable at
# runtime (re-read a reloadable interval flag every round — a hardcoded
# sleep can only be changed by a restart mid-incident) and it must draw
# each round from the shared metrics Collector budget
# (collector_max_samples_per_second), so N observers can never stampede a
# fleet the way unbudgeted pollers famously do. The rule fires on any
# sleep/wait loop in fleet/ missing either leg.

_FLEET_SCOPE_PREFIXES = ("fleet/",)


def _sleep_loops(func: ast.AST) -> List[ast.While]:
    """While-loops that park the thread: any sleep()/wait() call reachable
    from the loop node (the loop test counts — `stop.wait(...)` as the
    condition is the canonical shape)."""
    loops: List[ast.While] = []
    for node in ast.walk(func):
        if not isinstance(node, ast.While):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = attr_chain(sub.func)
                if name is not None and \
                        name.split(".")[-1] in ("sleep", "wait"):
                    loops.append(node)
                    break
    return loops


def _interval_flag_read(func: ast.AST) -> bool:
    """A flags.get(...) / _flags.get(...) call anywhere in the function."""
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            name = attr_chain(node.func)
            if name is None:
                continue
            parts = name.split(".")
            if parts[-1] == "get" and any("flags" in p for p in parts[:-1]):
                return True
    return False


def _budget_consulted(func: ast.AST) -> bool:
    """An ask_to_be_sampled(...) call anywhere in the function. Matched
    on the final attribute directly (not attr_chain) so the canonical
    ``global_collector().ask_to_be_sampled()`` — a chain rooted in a
    call — still counts."""
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) \
                    and fn.attr == "ask_to_be_sampled":
                return True
            if isinstance(fn, ast.Name) and fn.id == "ask_to_be_sampled":
                return True
    return False


@register_rule(
    "budget-gated-scrape",
    "periodic (sleep/wait) loops in fleet/ must re-read a reloadable "
    "interval flag and draw from the shared Collector budget "
    "(ask_to_be_sampled) in the same function — unbudgeted fixed-rate "
    "scrapers stampede fleets")
def rule_budget_gated_scrape(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for sf in pkg.files:
        if not in_scope(sf.rel, prefixes=_FLEET_SCOPE_PREFIXES):
            continue
        for func, cls in iter_functions(sf.tree):
            loops = _sleep_loops(func)
            if not loops:
                continue
            missing = []
            if not _interval_flag_read(func):
                missing.append("a reloadable interval flag read "
                               "(flags.get)")
            if not _budget_consulted(func):
                missing.append("a Collector budget draw "
                               "(ask_to_be_sampled)")
            if not missing:
                continue
            where = f"{cls}.{func.name}" if cls else func.name
            for loop in loops:
                out.append(Finding(
                    "budget-gated-scrape", sf.rel, loop.lineno,
                    f"{where}() runs a periodic loop without "
                    f"{' or '.join(missing)} — fleet scrape loops "
                    f"multiply by members × observers and must stay "
                    f"retunable and under "
                    f"collector_max_samples_per_second"))
    return out
