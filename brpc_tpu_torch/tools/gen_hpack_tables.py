#!/usr/bin/env python
"""Generate brpc_tpu_torch/native/hpack_tables.h from
brpc_tpu_torch/policy/hpack.py.

The HPACK static table (RFC 7541 Appendix A) and Huffman code table
(Appendix B) are public spec data; the port's policy module is its
single source of truth for them. This script re-emits the same data as
C arrays so the engine's decoder and encoder cannot drift from the
Python ones. Re-run after touching hpack.py (the output is committed;
dataplane.cpp #includes it, and the engine rebuilds under the header's
new digest).

    python -m brpc_tpu_torch.tools.gen_hpack_tables
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.policy.hpack import (HUFFMAN_CODES,  # noqa: E402
                                         STATIC_TABLE)

OUT = os.path.join(ROOT, "brpc_tpu_torch", "native", "hpack_tables.h")


def main():
    lines = [
        "// Generated by brpc_tpu_torch/tools/gen_hpack_tables.py from",
        "// brpc_tpu_torch/policy/hpack.py (RFC 7541 Appendix A/B data).",
        "// Do not edit by hand; re-run the generator.",
        "#pragma once",
        "#include <cstdint>",
        "",
        "struct HpackStaticEntry { const char* name; const char* value; };",
        f"static const HpackStaticEntry kHpackStatic[{len(STATIC_TABLE)}]"
        " = {",
    ]
    for name, value in STATIC_TABLE:
        lines.append(f'    {{"{name}", "{value}"}},')
    lines.append("};")
    lines.append("")
    lines.append("struct HuffCode { uint32_t code; uint8_t bits; };")
    lines.append(f"static const HuffCode kHuffCodes[{len(HUFFMAN_CODES)}]"
                 " = {")
    for code, bits in HUFFMAN_CODES:
        lines.append(f"    {{0x{code:x}u, {bits}}},")
    lines.append("};")
    lines.append("")
    with open(OUT, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {OUT}: {len(STATIC_TABLE)} static entries, "
          f"{len(HUFFMAN_CODES)} huffman codes")


if __name__ == "__main__":
    main()
