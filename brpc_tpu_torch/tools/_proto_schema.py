"""The schema list the descriptor generators share, and its two writers.

A generator holds one :class:`ProtoFile`: its file name, package, proto3
messages (each a list of :class:`ProtoField`) and services. From it
:func:`file_proto` writes the ``FileDescriptorProto`` bytes protobuf's
``SerializeToString`` gives for the same file built from
``descriptor_pb2`` primitives (fields in number order, ``json_name`` set
to the field's own name where the schema asks for it), over the wire
helpers of :mod:`brpc_tpu_torch.proto._message`; :func:`module_source`
writes the port's form of the ``*_pb2`` module: ``Message`` classes with
``FIELDS`` tables and a ``FileDescriptor``. Neither needs protobuf.
"""

from __future__ import annotations

import os
import textwrap
from typing import List, NamedTuple, Optional, Sequence, Tuple

from brpc_tpu_torch.proto._message import (_LABEL_OPTIONAL, _LABEL_REPEATED,
                                           _TYPE_CODES, MESSAGE, _put_bytes,
                                           _put_number, _put_text)


class ProtoField(NamedTuple):
    name: str
    number: int
    kind: str                       # a kind of proto/_message.py
    repeated: bool = False
    message: Optional[str] = None   # a message field's type, in this file


class ProtoFile(NamedTuple):
    name: str                       # FileDescriptorProto.name
    package: str
    messages: Sequence[Tuple[str, Sequence[ProtoField]]]
    # service name -> [(method, input message, output message)]
    services: Sequence[Tuple[str, Sequence[Tuple[str, str, str]]]] = ()
    json_names: bool = True


def _type_name(schema: ProtoFile, message: str) -> str:
    return f".{schema.package}.{message}"


def file_proto(schema: ProtoFile) -> bytes:
    """The ``FileDescriptorProto`` of ``schema``, serialized."""
    # FileDescriptorProto name 1, package 2, message_type 4, service 6,
    # syntax 12; DescriptorProto name 1, field 2; FieldDescriptorProto
    # name 1, number 3, label 4, type 5, type_name 6, json_name 10
    out = bytearray()
    _put_text(out, 1, schema.name)
    _put_text(out, 2, schema.package)
    for mname, fields in schema.messages:
        msg = bytearray()
        _put_text(msg, 1, mname)
        for f in fields:
            fb = bytearray()
            _put_text(fb, 1, f.name)
            _put_number(fb, 3, f.number)
            _put_number(fb, 4, _LABEL_REPEATED if f.repeated
                        else _LABEL_OPTIONAL)
            _put_number(fb, 5, _TYPE_CODES[f.kind])
            if f.kind == MESSAGE:
                _put_text(fb, 6, _type_name(schema, f.message))
            if schema.json_names:
                _put_text(fb, 10, f.name)
            _put_bytes(msg, 2, fb)
        _put_bytes(out, 4, msg)
    for sname, methods in schema.services:
        # ServiceDescriptorProto name 1, method 2; MethodDescriptorProto
        # name 1, input_type 2, output_type 3
        sb = bytearray()
        _put_text(sb, 1, sname)
        for meth, inp, outp in methods:
            mb = bytearray()
            _put_text(mb, 1, meth)
            _put_text(mb, 2, _type_name(schema, inp))
            _put_text(mb, 3, _type_name(schema, outp))
            _put_bytes(sb, 2, mb)
        _put_bytes(out, 6, sb)
    _put_text(out, 12, "proto3")
    return bytes(out)


def file_set(*files: bytes) -> bytes:
    """A ``FileDescriptorSet`` (``file`` is field 1) of serialized files."""
    out = bytearray()
    for f in files:
        _put_bytes(out, 1, f)
    return bytes(out)


def _field_line(f: ProtoField) -> str:
    args = [str(f.number), f'"{f.name}"', f.kind.upper()]
    if f.repeated:
        args.append("repeated=True")
    if f.kind == MESSAGE:
        args.append(f"message_class={f.message}")
    return f"        Field({', '.join(args)}),"


def module_source(schema: ProtoFile, doc: str, generator: str) -> str:
    """The port's ``*_pb2`` module for ``schema``. Its file descriptor
    takes the base name of the schema's file (the port's modules are
    named for their ``.proto`` alone) and writes no json names, as the
    port's runtime writes every file."""
    kinds = sorted({f.kind.upper() for _, fields in schema.messages
                    for f in fields})
    names = ", ".join(kinds + ["Field", "FileDescriptor", "Message"])
    classes = ", ".join(m for m, _ in schema.messages)
    lines: List[str] = [
        f'"""{doc}',
        "",
        f"Generated by {generator} from its",
        "schema; do not edit by hand.",
        '"""',
        "",
        "from brpc_tpu_torch.proto._message import (",
        *textwrap.wrap(names + ")", 75, initial_indent="    ",
                       subsequent_indent="    "),
    ]
    for mname, fields in schema.messages:
        lines += ["", "", f"class {mname}(Message):"]
        if not fields:
            lines.append("    FIELDS = ()")
            continue
        lines.append("    FIELDS = (")
        lines += [_field_line(f) for f in fields]
        lines.append("    )")
    lines += ["", "", "DESCRIPTOR = FileDescriptor(",
              f'    "{os.path.basename(schema.name)}", "{schema.package}",',
              *textwrap.wrap(f"[{classes}]" + ("," if schema.services
                                               else ")"), 75,
                             initial_indent="    ",
                             subsequent_indent="     ")]
    if schema.services:
        lines.append("    services={")
        for sname, methods in schema.services:
            lines.append(f'        "{sname}": [')
            lines += [f'            ("{meth}", {inp}, {outp}),'
                      for meth, inp, outp in methods]
            lines.append("        ],")
        lines.append("    })")
    return "\n".join(lines) + "\n"


def write(path: str, text) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb" if isinstance(text, bytes) else "w") as f:
        f.write(text)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")
