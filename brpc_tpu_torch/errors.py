"""RPC error codes the serving engine reports.

The port's own copy of the codes in ``brpc_tpu/rpc/errors.py``, with the
same numbers, so a later RPC front maps them onto the wire unchanged.
"""

OK = 0

EREQUEST = 1003        # bad request (parse/serialize failure)
ERPCTIMEDOUT = 1008    # RPC deadline exceeded
EFAILEDSOCKET = 1009   # the connection was broken during the RPC
ELOGOFF = 1011         # server is stopping, rejecting new requests
EINTERNAL = 2001       # server internal error
EOVERCROWDED = 2004    # server too busy

_TEXT = {
    OK: "OK",
    EREQUEST: "bad request",
    ERPCTIMEDOUT: "rpc timed out",
    EFAILEDSOCKET: "socket failed during rpc",
    ELOGOFF: "server is logging off",
    EINTERNAL: "server internal error",
    EOVERCROWDED: "server overcrowded",
}


def error_text(code: int) -> str:
    return _TEXT.get(code, f"error {code}")
