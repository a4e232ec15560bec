"""Debug observability: descriptor images, loop markers, stage clouds.

File-based equivalent of the reference's rviz debug surface:
 - descriptor images published as sensor_msgs/Image
   (subMapOptmizationNode.cpp:2364-2393) -> PGM/PNG dumps per keyframe,
 - loop-constraint MarkerArrays (visualizeLoopClosure*, :3045-3258) ->
   a polyline PLY + JSON edge list,
 - per-stage debug cloud publishers (pubTest1/2/..., :312-320) -> PCD dumps
   (io.kitti.write_pcd).

No ROS here: artifacts land in a `debug_dir` and are inspectable with any
viewer; tests assert they round-trip.
"""

from __future__ import annotations

import json
import os

import numpy as np


def write_pgm(path: str, img: np.ndarray):
    """Grayscale PGM (descriptors are (R, S) float grids, scaled 0..255)."""
    a = np.asarray(img, np.float64)
    lo, hi = float(a.min()), float(a.max())
    scaled = np.zeros_like(a) if hi <= lo else (a - lo) / (hi - lo) * 255.0
    u8 = scaled.astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{u8.shape[1]} {u8.shape[0]}\n255\n".encode())
        f.write(u8.tobytes())


def read_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P5"
        w, h = map(int, f.readline().split())
        maxv = int(f.readline())
        assert maxv == 255
        return np.frombuffer(f.read(w * h), np.uint8).reshape(h, w)


class DebugDumper:
    """Collects per-keyframe/per-loop artifacts under debug_dir."""

    def __init__(self, debug_dir: str):
        self.dir = debug_dir
        os.makedirs(debug_dir, exist_ok=True)
        self.loop_edges: list[dict] = []

    # -- descriptor images (pubSC/pubISC/... equivalents) --
    def dump_descriptor(self, kf_index: int, name: str, grid: np.ndarray):
        write_pgm(
            os.path.join(self.dir, f"kf{kf_index:05d}_{name}.pgm"),
            np.asarray(grid),
        )

    # -- loop constraint markers --
    def add_loop_edge(self, kf_i: int, kf_j: int, p_i: np.ndarray,
                      p_j: np.ndarray, fitness: float):
        self.loop_edges.append({
            "kf_i": int(kf_i), "kf_j": int(kf_j),
            "p_i": [float(x) for x in p_i], "p_j": [float(x) for x in p_j],
            "fitness": float(fitness),
        })

    def flush_loop_markers(self):
        """JSON edge list + a PLY polyline set (edges as line segments)."""
        with open(os.path.join(self.dir, "loop_edges.json"), "w") as f:
            json.dump(self.loop_edges, f, indent=1)
        n = len(self.loop_edges)
        with open(os.path.join(self.dir, "loop_markers.ply"), "w") as f:
            f.write(
                "ply\nformat ascii 1.0\n"
                f"element vertex {2 * n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element edge {n}\n"
                "property int vertex1\nproperty int vertex2\nend_header\n"
            )
            for e in self.loop_edges:
                f.write(" ".join(str(v) for v in e["p_i"]) + "\n")
                f.write(" ".join(str(v) for v in e["p_j"]) + "\n")
            for k in range(n):
                f.write(f"{2 * k} {2 * k + 1}\n")

    # -- per-stage debug clouds --
    def dump_cloud(self, tag: str, points: np.ndarray,
                   labels: np.ndarray | None = None):
        from ..io import kitti

        kitti.write_pcd(
            os.path.join(self.dir, f"{tag}.pcd"), np.asarray(points), labels)
