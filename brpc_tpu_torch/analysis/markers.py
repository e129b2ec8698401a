"""Source markers the static analyzer keys on.

Kept in their own module with zero imports so hot-path modules (transport,
native poller) can decorate functions without pulling the analysis
machinery — or anything else — into their import graph.
"""


def poller_context(fn):
    """Mark ``fn`` as running on an event-dispatcher / poller thread.

    Purely declarative: the function is returned unchanged (no wrapper, no
    call overhead). ``tpulint``'s *no-blocking-in-poller* rule extends its
    module allowlist with every function carrying this decorator, so code
    that migrates onto a poller thread inherits the no-blocking discipline
    without the rule having to learn new module names.
    """
    fn.__tpulint_poller_context__ = True
    return fn
