"""A configuration's CLI flags as the reference reads them: the flags the
reference implements, with the CLI's defaults. A flag it does not implement
is refused, so a configuration that needs more brings its reference."""
from __future__ import annotations

from dataclasses import dataclass

# flag -> (field, type)
_FLAGS = {
    "--levels": ("levels", int),
    "--mono-depth": ("mono_depth", float),
    "--num-points": ("num_points", int),
    "--gn-iters": ("iters", int),
    "--track-levels": ("track_levels", str),
}


@dataclass(frozen=True)
class Settings:
    levels: int = 5
    mono_depth: float = 1.0
    num_points: int = 2048
    iters: int = 10
    track_levels: tuple[int, ...] = ()


def from_flags(flags: list[str]) -> Settings:
    values: dict = {}
    i = 0
    while i < len(flags):
        if flags[i] not in _FLAGS:
            raise ValueError(f"the reference does not implement the flag {flags[i]!r}")
        field, kind = _FLAGS[flags[i]]
        values[field] = kind(flags[i + 1])
        i += 2
    levels = values.get("levels", Settings.levels)
    track = values.pop("track_levels", None)
    values["track_levels"] = (tuple(int(s) for s in track.split(",")) if track
                              else tuple(range(levels - 2, -1, -1)))
    return Settings(**values)
