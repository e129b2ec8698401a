"""Ring record codecs + the minimal RpcMeta scanner the router needs.

Everything that crosses a shard ring is flat bytes: struct-packed integer
handles (endpoint ids, epochs, block indices, byte lengths) plus raw wire
frames. There is deliberately no pickle anywhere in this package — the
``cross-process-ownership`` tpulint rule pins that invariant.

The scanner is a top-level protobuf varint walk over an RpcMeta blob: the
parent must route by correlation id BEFORE parsing (parsing is exactly
the CPU the workers exist to absorb), so it reads just the four facts
routing needs — request-ness, cid, attempt_version, stream-ness — from
the ~30-byte meta without materializing a message object. The port's
message runtime (``proto/_message.py``) writes the same bytes protobuf
does, so the walk reads either package's frames. Field numbers from
``rpc_meta.proto`` (``proto/rpc_meta_pb2.py``'s tables): request=1,
correlation_id=3, attempt_version=4, stream_settings=8.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

# parent -> worker
R_ATTACH = 1         # !II ep_id epoch + json {pool, bs, bc, remote}
R_DETACH = 2         # !I  ep_id
R_MSG = 3            # !I  ep_id + raw TRPC frame bytes
R_LEASE_GRANT = 4    # !IIH ep_id epoch n + !{n}I block indices
R_LEASE_RECLAIM = 5  # !II ep_id want
R_QUIT = 6           # (empty)

# worker -> parent
W_READY = 32         # !I pid
W_RESP = 33          # !IQ ep_id cid + whole response packet bytes
W_RESP_SEGS = 34     # !IIQH ep_id epoch cid nsegs + (!II idx len)*n
W_LEASE_RETURN = 35  # !IIH ep_id epoch n + !{n}I block indices
W_LEASE_REQUEST = 36 # !II ep_id want
W_STATS = 37         # utf-8 json
W_PROF = 38          # utf-8 folded stack lines
W_RESP_SHM = 39      # !IQQ ep_id cid total + utf-8 spill segment name
W_VARS = 40          # utf-8 json windowed var snapshot (shard/fleet.py)

_II = struct.Struct("!II")
_I = struct.Struct("!I")
_IIH = struct.Struct("!IIH")
_IQ = struct.Struct("!IQ")
_IIQH = struct.Struct("!IIQH")


def encode_msg(ep_id: int, frame: bytes) -> bytes:
    return _I.pack(ep_id) + frame


def decode_msg(b: bytes) -> Tuple[int, bytes]:
    return _I.unpack_from(b)[0], b[_I.size:]


def encode_indices(ep_id: int, epoch: int, indices) -> bytes:
    indices = list(indices)
    return (_IIH.pack(ep_id, epoch, len(indices))
            + struct.pack(f"!{len(indices)}I", *indices))


def decode_indices(b: bytes) -> Tuple[int, int, List[int]]:
    ep_id, epoch, n = _IIH.unpack_from(b)
    return ep_id, epoch, list(struct.unpack_from(f"!{n}I", b, _IIH.size))


def encode_want(ep_id: int, want: int) -> bytes:
    return _II.pack(ep_id, want)


def decode_want(b: bytes) -> Tuple[int, int]:
    return _II.unpack(b[:_II.size])


def encode_resp(ep_id: int, cid: int, packet: bytes) -> bytes:
    return _IQ.pack(ep_id, cid) + packet


def decode_resp(b: bytes) -> Tuple[int, int, bytes]:
    ep_id, cid = _IQ.unpack_from(b)
    return ep_id, cid, b[_IQ.size:]


def encode_resp_segs(ep_id: int, epoch: int, cid: int, segs) -> bytes:
    segs = list(segs)
    out = _IIQH.pack(ep_id, epoch, cid, len(segs))
    return out + b"".join(_II.pack(i, ln) for i, ln in segs)


def decode_resp_segs(b: bytes) -> Tuple[int, int, int, List[Tuple[int, int]]]:
    ep_id, epoch, cid, n = _IIQH.unpack_from(b)
    off = _IIQH.size
    segs = [_II.unpack_from(b, off + k * _II.size) for k in range(n)]
    return ep_id, epoch, cid, segs


# ----------------------------------------------------------------- scanner
def _uvarint(b: bytes, i: int) -> Tuple[int, int]:
    val = 0
    shift = 0
    while True:
        byte = b[i]
        i += 1
        val |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return val, i
        shift += 7
        if shift > 63:
            raise ValueError("varint overflow")


def scan_request_meta(mb) -> Optional[Tuple[bool, int, int, bool]]:
    """(has_request, correlation_id, attempt_version, has_stream) from a
    serialized RpcMeta, or None when the blob does not walk cleanly (the
    in-process parser then owns it — the shard lane only skims)."""
    i, n = 0, len(mb)
    has_req = False
    cid = 0
    attempt = 0
    has_stream = False
    try:
        while i < n:
            key, i = _uvarint(mb, i)
            field, wt = key >> 3, key & 7
            if wt == 0:
                v, i = _uvarint(mb, i)
                if field == 3:
                    cid = v
                elif field == 4:
                    attempt = v
            elif wt == 2:
                ln, i = _uvarint(mb, i)
                if field == 1:
                    has_req = True
                elif field == 8:
                    has_stream = True
                i += ln
            elif wt == 5:
                i += 4
            elif wt == 1:
                i += 8
            else:
                return None
        if i != n:
            return None
    except (IndexError, ValueError):
        return None
    return has_req, cid, attempt, has_stream


def response_cid(header_and_meta: bytes, meta_size: int) -> int:
    """correlation_id scanned out of a response packet's own meta (the
    worker packs responses, so it holds header+meta contiguously)."""
    info = scan_request_meta(header_and_meta[12:12 + meta_size])
    return info[1] if info else 0
