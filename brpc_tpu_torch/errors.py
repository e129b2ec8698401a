"""RPC error codes (counterpart of the reference's errno_pb + berror).

The one table of the port: the same names and numbers as the JAX
package's ``rpc/errors.py``, so the RPC front, the serving engine and the
device data plane report the codes the reference reports.
``brpc_tpu_torch.rpc.errors`` re-exports this module.
"""

OK = 0

# client-side
ENOSERVICE = 1001      # service not found on server
ENOMETHOD = 1002       # method not found in service
EREQUEST = 1003        # bad request (parse/serialize failure)
ERPCTIMEDOUT = 1008    # RPC deadline exceeded
EFAILEDSOCKET = 1009   # the connection was broken during the RPC
EHOSTDOWN = 1010       # peer marked down by health checker / circuit breaker
ELOGOFF = 1011         # server is stopping, rejecting new requests
ELIMIT = 1012          # concurrency limiter rejected the request
EBACKUPREQUEST = 1017  # internal: backup-request timer fired
ETOOMANYFAILS = 1014   # ParallelChannel: sub-call failures exceeded fail_limit
ECANCELED = 1015       # call canceled by caller
EPCHANFINISH = 1018    # internal: ParallelChannel finished early (not an error)
EINTERNAL = 2001       # server internal error
ERESPONSE = 2002       # bad response (parse failure / checksum mismatch)
EAUTH = 2003           # authentication failed
EOVERCROWDED = 2004    # server too busy (write queue overflow)
ESTREAMCLOSED = 2005   # stream closed by peer
EREJECT = 2007         # cluster-recover policy shed this request


class SelectError(Exception):
    """Server-selection failure carrying the error code to report (raised
    by Channel._select_socket, routed by Controller._issue_rpc)."""

    def __init__(self, code: int, text: str = ""):
        super().__init__(text)
        self.code = code

_TEXT = {
    OK: "OK",
    ENOSERVICE: "service not found",
    ENOMETHOD: "method not found",
    EREQUEST: "bad request",
    ERPCTIMEDOUT: "rpc timed out",
    EFAILEDSOCKET: "socket failed during rpc",
    EHOSTDOWN: "peer is down",
    ELOGOFF: "server is logging off",
    ELIMIT: "concurrency limit reached",
    EBACKUPREQUEST: "backup request triggered",
    ETOOMANYFAILS: "too many sub-call failures",
    ECANCELED: "rpc canceled",
    EPCHANFINISH: "parallel channel finished early",
    EINTERNAL: "server internal error",
    ERESPONSE: "bad response",
    EAUTH: "authentication failed",
    EOVERCROWDED: "server overcrowded",
    EREJECT: "request shed during cluster recovery",
    ESTREAMCLOSED: "stream closed",
}


def error_text(code: int) -> str:
    return _TEXT.get(code, f"error {code}")


# retryable by default (reference DefaultRetryPolicy: connection-level
# failures retry, application/timeout errors don't)
DEFAULT_RETRYABLE = frozenset({EFAILEDSOCKET, EHOSTDOWN, ELOGOFF, EBACKUPREQUEST})
