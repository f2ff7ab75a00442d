"""Darknet-compatible configuration readers.

Implements the same ingestion surface as the reference framework's
``read_cfg`` / ``option_list`` / ``read_data_cfg`` machinery
(reference: src_yolo2/parser.c:702-735, src_yolo2/option_list.c:7-123,
src_yolo2/utils.c ``strip``/``fgetl``), re-designed as plain Python data
structures that feed the cfg -> JAX module-graph compiler.

Semantics preserved from the reference:
  * ALL whitespace characters are stripped from every line (not just
    leading/trailing) before parsing.
  * Lines beginning with '#', ';' or empty lines are skipped.
  * '[section]' opens a new section; 'key=value' pairs attach to the
    current section. Only the first '=' splits.
  * Typed lookups fall back to defaults; unused keys can be reported
    (the analog of ``option_unused``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable


_WHITESPACE = str.maketrans("", "", " \t\n\r")


def _strip_all(line: str) -> str:
    """Remove every whitespace char, mirroring utils.c ``strip``."""
    return line.translate(_WHITESPACE)


@dataclasses.dataclass
class Section:
    """One '[type]' block of a darknet cfg file."""

    type: str                      # e.g. "[convolutional]" (brackets kept)
    options: dict[str, str] = dataclasses.field(default_factory=dict)
    used: set[str] = dataclasses.field(default_factory=set)

    # --- typed lookups (option_list.c:52-123 semantics) ---------------
    def find(self, key: str) -> str | None:
        if key in self.options:
            self.used.add(key)
            return self.options[key]
        return None

    def find_str(self, key: str, default: str | None = None) -> str | None:
        v = self.find(key)
        return v if v is not None else default

    def find_int(self, key: str, default: int) -> int:
        v = self.find(key)
        return int(v) if v is not None else default

    def find_float(self, key: str, default: float) -> float:
        v = self.find(key)
        return float(v) if v is not None else default

    def find_int_list(self, key: str) -> list[int] | None:
        v = self.find(key)
        if v is None:
            return None
        return [int(tok) for tok in v.split(",") if tok != ""]

    def find_float_list(self, key: str) -> list[float] | None:
        v = self.find(key)
        if v is None:
            return None
        return [float(tok) for tok in v.split(",") if tok != ""]

    def unused_keys(self) -> list[str]:
        return [k for k in self.options if k not in self.used]


def parse_cfg_text(text: str) -> list[Section]:
    """Parse cfg file contents into an ordered list of sections."""
    sections: list[Section] = []
    current: Section | None = None
    for raw in text.splitlines():
        line = _strip_all(raw)
        if not line or line[0] in "#;":
            continue
        if line[0] == "[":
            current = Section(type=line)
            sections.append(current)
            continue
        if current is None:
            raise ValueError(f"cfg option before any section: {raw!r}")
        if "=" not in line:
            raise ValueError(f"cfg line not key=value: {raw!r}")
        key, _, value = line.partition("=")
        current.options[key] = value
    return sections


def read_cfg(path: str) -> list[Section]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_cfg_text(f.read())


def read_data_cfg(path: str) -> dict[str, str]:
    """Read a '.data' key=value file (option_list.c:7-35 semantics)."""
    out: dict[str, str] = {}
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for raw in f:
            line = _strip_all(raw)
            if not line or line[0] in "#;":
                continue
            if "=" not in line:
                continue
            key, _, value = line.partition("=")
            out[key] = value
    return out


def read_names(path: str) -> list[str]:
    """Read a class-names file: one name per line, trailing ws stripped."""
    names: list[str] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if line:
                names.append(line)
    return names


def read_map(path: str) -> list[int]:
    """Read a class-map file: one int per line (utils.c ``read_map``)."""
    out: list[int] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if line:
                out.append(int(line))
    return out


def is_network_section(s: Section) -> bool:
    return s.type in ("[net]", "[network]")


def iter_unused(sections: Iterable[Section]) -> list[tuple[str, str]]:
    """All (section, key) pairs never looked up — analog of option_unused."""
    out = []
    for s in sections:
        for k in s.unused_keys():
            out.append((s.type, k))
    return out


__all__ = [
    "Section",
    "parse_cfg_text",
    "read_cfg",
    "read_data_cfg",
    "read_names",
    "read_map",
    "is_network_section",
    "iter_unused",
]
