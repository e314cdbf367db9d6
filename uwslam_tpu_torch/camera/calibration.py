"""Calibration loading: the OpenCV FileStorage XML of uw-slam and JSON.

Counterpart of `uwslam_tpu.camera.calibration`. The XML schema is uw-slam's
(calibration/calibrationTUM.xml, calibrationEUROC.xml, parsed by
cv::FileStorage at src/CameraModel.cpp:36-58):
  in_width/in_height, out_width/out_height,
  calibration_values = [fx fy cx cy],
  rectification      = [k1 k2 p1 p2]   (k1 = k2 = 0 means no distortion)
with the normalized-intrinsics rule (cx < 1 and cy < 1: values are
fractions of the image size, src/CameraModel.cpp:61-68).
"""
from __future__ import annotations

import json
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass

from .model import PinholeCamera


@dataclass(frozen=True)
class Calibration:
    raw: PinholeCamera          # intrinsics of the raw (distorted) input image
    out_width: int
    out_height: int

    @property
    def needs_rectification(self) -> bool:
        return self.raw.has_distortion


def _parse_matrix_data(elem: ET.Element) -> list[float]:
    data = elem.find("data")
    text = data.text if data is not None else elem.text
    return [float(x) for x in re.split(r"\s+", text.strip()) if x]


def load_opencv_xml(path: str) -> Calibration:
    """Parse uw-slam's OpenCV FileStorage calibration XML."""
    root = ET.parse(path).getroot()

    def get_int(tag: str) -> int:
        node = root.find(tag)
        if node is None:
            raise ValueError(f"calibration XML missing <{tag}>: {path}")
        return int(node.text.strip())

    in_w, in_h = get_int("in_width"), get_int("in_height")
    out_w, out_h = get_int("out_width"), get_int("out_height")
    fx, fy, cx, cy = _parse_matrix_data(root.find("calibration_values"))[:4]
    rect_node = root.find("rectification")
    rect = _parse_matrix_data(rect_node) if rect_node is not None else [0, 0, 0, 0]
    if cx < 1.0 and cy < 1.0:       # normalized intrinsics
        fx *= in_w
        fy *= in_h
        cx = cx * in_w - 0.5
        cy = cy * in_h - 0.5
    k1, k2, p1, p2 = (rect + [0, 0, 0, 0])[:4]
    if k1 == 0.0 and k2 == 0.0:     # [0 0 0 1] or all zeros: no distortion
        k1 = k2 = p1 = p2 = 0.0
    raw = PinholeCamera(fx=fx, fy=fy, cx=cx, cy=cy, width=in_w, height=in_h,
                        k1=k1, k2=k2, p1=p1, p2=p2)
    return Calibration(raw=raw, out_width=out_w, out_height=out_h)


def load_json(path: str) -> Calibration:
    """JSON calibration: fx fy cx cy width height [k1 k2 p1 p2]
    [out_width out_height]."""
    with open(path) as f:
        d = json.load(f)
    raw = PinholeCamera(
        fx=d["fx"], fy=d["fy"], cx=d["cx"], cy=d["cy"],
        width=d["width"], height=d["height"],
        k1=d.get("k1", 0.0), k2=d.get("k2", 0.0),
        p1=d.get("p1", 0.0), p2=d.get("p2", 0.0),
    )
    return Calibration(
        raw=raw,
        out_width=d.get("out_width", d["width"]),
        out_height=d.get("out_height", d["height"]),
    )


def load(path: str) -> Calibration:
    if path.endswith(".xml"):
        return load_opencv_xml(path)
    if path.endswith(".json"):
        return load_json(path)
    raise ValueError(f"unsupported calibration format: {path}")
