"""Interactive 3D result visualization: the ColorCompletionVisualizer of
`stinet_tpu/utils/visualization.py` (the reference's, with key callbacks
J/K/M/F for prediction, ground truth, mask and error heat map, P for a
screenshot, D to dump a .ply set). It is numpy code; open3d is optional,
and without it `visualize_result` writes the .ply files directly, so eval
artifacts are still produced. SemSegVisualizer waits for segmentation.
"""
import os

import numpy as np



def _open3d():
    """The open3d module, or None where it is not installed or does not
    load (it needs a display library)."""
    try:
        import open3d
    except (ImportError, OSError):
        return None
    return open3d


def _write_ply(path, vertices, colors, faces=None):
    """Minimal ASCII ply writer (no open3d dependency)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        cc = np.clip(colors * 255, 0, 255).astype(np.uint8)
        for v, c in zip(vertices, cc):
            f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        if faces is not None:
            for face in faces:
                f.write("3 " + " ".join(str(int(i)) for i in face) + "\n")


class ColorCompletionVisualizer:
    def __init__(self, data_loader, output_dir="visualizations/",
                 interactive=None):
        self.data_loader = data_loader
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._o3d = _open3d()
        has_open3d = self._o3d is not None
        self.interactive = (has_open3d if interactive is None
                            else interactive and has_open3d)

    def _positions(self, name, n):
        get_mesh = getattr(self.data_loader, "get_mesh", None)
        if get_mesh is not None and self._o3d is not None:
            try:
                mesh = get_mesh(name)
            except OSError:     # no original scan mesh next to the data
                return None, None
            return np.asarray(mesh.vertices)[:n], np.asarray(mesh.triangles)
        return None, None

    def visualize_result(self, name, prediction, ground_truth, mask):
        prediction = np.asarray(prediction)
        ground_truth = np.asarray(ground_truth)
        mask = np.asarray(mask).reshape(-1)
        n = len(prediction)
        pos, faces = self._positions(name, n)
        if pos is None:
            pos = np.zeros((n, 3), np.float32)
            faces = None

        error = np.abs(prediction - ground_truth).mean(-1, keepdims=True)
        heat = np.concatenate(
            [error, np.zeros_like(error), 1.0 - error], axis=-1)
        masked = ground_truth.copy()
        masked[mask > 0] = np.array([0.1, 0.9, 0.1])

        if self.interactive:
            self._show_interactive(name, pos, faces, prediction,
                                   ground_truth, masked, heat)
        else:
            for tag, colors in (("pred", prediction), ("gt", ground_truth),
                                ("mask", masked), ("error", heat)):
                _write_ply(os.path.join(self.output_dir,
                                        f"{name}_{tag}.ply"),
                           pos, colors, faces)

    def _show_interactive(self, name, pos, faces, pred, gt, masked, heat):
        o3d = self._o3d
        mesh = o3d.geometry.TriangleMesh()
        mesh.vertices = o3d.utility.Vector3dVector(pos)
        if faces is not None:
            mesh.triangles = o3d.utility.Vector3iVector(faces)
        mesh.vertex_colors = o3d.utility.Vector3dVector(pred)

        state = {"mesh": mesh}

        def set_colors(colors):
            def cb(vis):
                state["mesh"].vertex_colors = \
                    o3d.utility.Vector3dVector(colors)
                vis.update_geometry(state["mesh"])
                return False
            return cb

        def screenshot(vis):
            path = os.path.join(self.output_dir, f"{name}.png")
            vis.capture_screen_image(path)
            return False

        def dump(vis):
            for tag, colors in (("pred", pred), ("gt", gt),
                                ("mask", masked), ("error", heat)):
                _write_ply(os.path.join(self.output_dir,
                                        f"{name}_{tag}.ply"),
                           pos, colors, faces)
            return False

        key_callbacks = {
            ord("J"): set_colors(pred),
            ord("K"): set_colors(gt),
            ord("M"): set_colors(masked),
            ord("F"): set_colors(heat),
            ord("P"): screenshot,
            ord("D"): dump,
        }
        o3d.visualization.draw_geometries_with_key_callbacks(
            [mesh], key_callbacks)
