"""The case of a configuration file, read by the reference alone.

A configuration file of the benchmark holds its case as {section: {key:
value}} with the values as strings, as a tlab case file writes them.  The
reference reads them here, case-insensitively, with the defaults of a tlab
case file where a key is absent; it shares no code with the program.
"""
from __future__ import annotations


class Case:
    """Typed access to the {section: {key: value}} of a configuration."""

    def __init__(self, ini: dict):
        self.data = {s.lower(): {k.lower(): str(v) for k, v in keys.items()}
                     for s, keys in ini.items()}

    def get(self, section: str, key: str, default: str = "") -> str:
        return self.data.get(section.lower(), {}).get(key.lower(), default)

    def float(self, section: str, key: str, default: float) -> float:
        v = self.get(section, key, "")
        return float(v) if v != "" else float(default)

    def int(self, section: str, key: str, default: int) -> int:
        v = self.get(section, key, "")
        return int(v) if v != "" else int(default)

    def bool(self, section: str, key: str, default: bool) -> bool:
        v = self.get(section, key, "").lower()
        if v == "":
            return default
        return v in ("yes", "true", "1", "on")

    def floats(self, section: str, key: str, default=()) -> tuple:
        v = self.get(section, key, "")
        if v == "":
            return tuple(default)
        return tuple(float(x) for x in v.split(",") if x.strip())

