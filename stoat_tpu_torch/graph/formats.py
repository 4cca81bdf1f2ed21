"""Graph-format detection by content (the reference's VPKG dispatch).

The reference auto-detects ``.pg``/``.hg``/``.gbz`` by magic number via
libvgio's VPKG registry (the reference's src/io/register_io.cpp:20-26),
so a misnamed file still loads.  ``sniff_graph_format`` mirrors that:
first bytes decide, the file extension is only the fallback.

Magic numbers (verified over the reference's entire fixture zoo):
  - bdsg::HashGraph    b"(MO8"          (SerializableHandleGraph magic)
  - bdsg::PackedGraph  b"\\xb7\\x9e\\xf7]"
  - gbwtgraph::GBZ     b"GBZ "          (simple-sds header tag)
  - GFA                ASCII text, first record char in "HS#LPWJE"
  - gzip (.gfa.gz)     b"\\x1f\\x8b"
"""

from __future__ import annotations

import gzip

__all__ = ["sniff_graph_format", "load_graph"]

_MAGICS = (
    (b"(MO8", "hg"),
    (b"\xb7\x9e\xf7]", "pg"),
    (b"GBZ ", "gbz"),
)

_GFA_RECORD_CHARS = set(b"HS#LPWJE")


def sniff_graph_format(path: str) -> str:
    """Return "hg" | "pg" | "gbz" | "gfa" | "gfa.gz" | "unknown"."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(4)
    except OSError:
        return "unknown"
    for magic, fmt in _MAGICS:
        if head.startswith(magic):
            return fmt
    if head.startswith(b"\x1f\x8b"):
        try:
            with gzip.open(path, "rb") as fh:
                inner = fh.read(2)
        except OSError:
            return "unknown"
        if inner[:1] in (bytes([c]) for c in _GFA_RECORD_CHARS):
            return "gfa.gz"
        return "unknown"
    if head[:1] in (bytes([c]) for c in _GFA_RECORD_CHARS):
        return "gfa"
    # extension fallback (VPKG also falls back to trying loaders in turn)
    for ext, fmt in ((".hg", "hg"), (".pg", "pg"), (".gbz", "gbz"),
                     (".gfa.gz", "gfa.gz"), (".gfa", "gfa")):
        if path.endswith(ext):
            return fmt
    return "unknown"


def load_graph(path: str, ref_names=None):
    """Magic-dispatched graph loading (any supported format)."""
    fmt = sniff_graph_format(path)
    if fmt == "hg":
        from stoat_tpu_torch.graph.hashgraph import load_hg
        return load_hg(path, ref_names)
    if fmt == "pg":
        from stoat_tpu_torch.graph.packedgraph import load_pg
        return load_pg(path, ref_names)
    if fmt == "gbz":
        from stoat_tpu_torch.graph.gbz import load_gbz
        return load_gbz(path, ref_names)
    if fmt in ("gfa", "gfa.gz"):
        from stoat_tpu_torch.graph.gfa import load_gfa
        return load_gfa(path, ref_names)
    raise RuntimeError(
        f"Unsupported graph format: {path}. stoat-tpu reads GFA, bdsg "
        "HashGraph (.hg), PackedGraph (.pg), and GBZ (.gbz) — detected "
        "by content like the reference's VPKG (register_io.cpp:20-26).")
