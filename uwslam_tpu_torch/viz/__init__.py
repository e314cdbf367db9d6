"""Host-side views of a session: PLY maps, trajectory overlays, a JSONL
event stream, a live HTTP view and debug panels."""
from .export import EventStream, trajectory_svg, write_ply, write_trajectory_html
from .server import VizServer

__all__ = [
    "EventStream",
    "VizServer",
    "trajectory_svg",
    "write_ply",
    "write_trajectory_html",
]
