"""Length-prefixed raw-f32 wire format for the serve HTTP transport (the
port's copy of the JAX package's ``serve/wire.py``: the same frames, byte
for byte, the same limits and the same ``WireError`` messages).

The JSON transport (serve/http.py) ships planes as nested lists of
floats — ~12 bytes of ASCII per f32 plus parse cost on both sides.
This module is the negotiated binary alternative: a fixed little-endian
framing around raw ``float32`` payloads, so a 1024^2 plane is 4 MiB on
the wire and decodes with two ``np.frombuffer`` views instead of a JSON
parse.

Frame layout (all integers little-endian uint32)::

    magic   b"IAF2"       (4 bytes — "Image Analogies F32", version 2
                            framing: v1 was the JSON list transport)
    count   u32           number of arrays
    per array:
      ndim  u32
      dims  u32 * ndim
      data  f32 * prod(dims)   (C-contiguous)

Strictness: decode validates the magic, every length, and that the
buffer is consumed EXACTLY — a truncated or padded body is a protocol
error, not a best-effort parse (the serve journal's spill-file hygiene
taught that lesson).  Caps mirror the JSON path's implicit limits:
``MAX_ARRAYS`` and ``MAX_ELEMS`` bound a hostile frame before any
allocation happens.
"""

from __future__ import annotations

import json
import struct
from typing import List, Sequence

import numpy as np

MAGIC = b"IAF2"
# Content type both sides negotiate on (request Content-Type, response
# Accept).  JSON stays the default; this is opt-in per request.
CONTENT_TYPE = "application/x-ia-f32"

# A frame carries at most this many arrays (requests ship 3 planes,
# responses 1) and this many f32 elements per array (a 16k^2 plane —
# far beyond anything the engine accepts, near enough to bound a
# hostile count before the multiply in the allocator).
MAX_ARRAYS = 16
MAX_ELEMS = 1 << 28

_U32 = struct.Struct("<I")


class WireError(ValueError):
    """Malformed binary frame (maps to HTTP 400 in serve/http.py)."""


def encode_planes(arrays: Sequence[np.ndarray]) -> bytes:
    """Serialize float32 arrays into one IAF2 frame."""
    if len(arrays) > MAX_ARRAYS:
        raise WireError(f"too many arrays ({len(arrays)} > {MAX_ARRAYS})")
    parts = [MAGIC, _U32.pack(len(arrays))]
    for arr in arrays:
        a = np.ascontiguousarray(arr, dtype=np.float32)
        parts.append(_U32.pack(a.ndim))
        for d in a.shape:
            parts.append(_U32.pack(d))
        parts.append(a.tobytes())
    return b"".join(parts)


def decode_planes(data: bytes) -> List[np.ndarray]:
    """Parse one IAF2 frame back into float32 arrays (exact-consume)."""
    buf = memoryview(data)
    if len(buf) < 8 or bytes(buf[:4]) != MAGIC:
        raise WireError("bad magic (not an IAF2 frame)")
    off = 4

    def u32() -> int:
        nonlocal off
        if off + 4 > len(buf):
            raise WireError("truncated frame (header)")
        (v,) = _U32.unpack_from(buf, off)
        off += 4
        return v

    count = u32()
    if count > MAX_ARRAYS:
        raise WireError(f"too many arrays ({count} > {MAX_ARRAYS})")
    out: List[np.ndarray] = []
    for _ in range(count):
        ndim = u32()
        if ndim > 8:
            raise WireError(f"ndim {ndim} exceeds 8")
        dims = [u32() for _ in range(ndim)]
        n = 1
        for d in dims:
            if d > MAX_ELEMS:
                raise WireError(f"dimension {d} exceeds {MAX_ELEMS}")
            n *= d
        if n > MAX_ELEMS:
            raise WireError(f"array of {n} elements exceeds {MAX_ELEMS}")
        nbytes = n * 4
        if off + nbytes > len(buf):
            raise WireError("truncated frame (payload)")
        arr = np.frombuffer(buf, dtype="<f4", count=n,
                            offset=off).reshape(dims)
        off += nbytes
        # np.array (not ascontiguousarray — that aliases the read-only
        # buffer view): handlers treat request planes as ordinary
        # writable host arrays
        out.append(np.array(arr, dtype=np.float32))
    if off != len(buf):
        raise WireError(f"{len(buf) - off} trailing bytes after frame")
    return out


# --- trace-context frame -----------------------------------------------------
#
# Negotiated alongside IAF2 on the fleet's router->worker hops
# (serve/transport.py WorkerHandle.forward): a tiny side frame carrying
# the request's trace context (obs/trace.py TRACE_KEYS) so the hop that
# re-encodes planes also re-encodes the context — the codec
# roundtrip is the process-boundary rehearsal.  Same strictness rules
# as the plane frame: exact consume, validated lengths, string-only
# payload, hard cap before any allocation.

CONTEXT_MAGIC = b"IAT1"
MAX_CONTEXT = 4096


def encode_context(ctx: dict) -> bytes:
    """Serialize a str->str trace-context dict into one IAT1 frame."""
    for k, v in ctx.items():
        if not isinstance(k, str) or not isinstance(v, str):
            raise WireError("trace context must be str->str")
    blob = json.dumps(ctx, sort_keys=True).encode()
    if len(blob) > MAX_CONTEXT:
        raise WireError(f"trace context {len(blob)}B exceeds {MAX_CONTEXT}")
    return CONTEXT_MAGIC + _U32.pack(len(blob)) + blob


def decode_context(data: bytes) -> dict:
    """Parse one IAT1 frame back into a str->str dict (exact-consume)."""
    if len(data) < 8 or data[:4] != CONTEXT_MAGIC:
        raise WireError("bad magic (not an IAT1 context frame)")
    (n,) = _U32.unpack_from(data, 4)
    if n > MAX_CONTEXT:
        raise WireError(f"trace context {n}B exceeds {MAX_CONTEXT}")
    if len(data) != 8 + n:
        raise WireError("truncated/padded IAT1 frame")
    try:
        ctx = json.loads(data[8:8 + n].decode())
    except (UnicodeDecodeError, ValueError) as exc:
        raise WireError(f"undecodable trace context: {exc}")
    if not isinstance(ctx, dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in ctx.items()):
        raise WireError("trace context must be a str->str object")
    return ctx
