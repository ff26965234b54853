"""TensorBoard visualization helpers, a copy of
`stinet_tpu/utils/visualization_utils.py` (the reference's
visualization_utils.py): prediction image grids, label-map colourization,
and confusion-matrix heatmap figures. numpy only; matplotlib is imported
when a figure is asked for, and without it there is no figure."""
import numpy as np


def make_image_grid(images, nrow=8, pad=2, pad_value=0.0):
    """[N, H, W, C] in [0,1] -> one [H', W', C] grid image (torchvision
    make_grid analog, NHWC)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = int(np.ceil(n / ncol))
    grid = np.full(
        (nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
        pad_value, dtype=images.dtype)
    for i, img in enumerate(images):
        r, cidx = divmod(i, ncol)
        y0 = r * (h + pad) + pad
        x0 = cidx * (w + pad) + pad
        grid[y0:y0 + h, x0:x0 + w] = img
    return grid


def visualize_tensor(writer, tag, images, nrow=8):
    """Write an image grid scalar to the TB writer (NHWC, [0,1])."""
    grid = make_image_grid(np.clip(images, 0.0, 1.0), nrow=nrow)
    writer.add_image(tag, grid, dataformats="HWC")


def colorize_labels(labels, color_map):
    """[N] int labels -> [N, 3] float colors in [0,1] from a
    {label: (r,g,b)} map."""
    lut = np.zeros((max(color_map) + 1, 3), np.float32)
    for k, v in color_map.items():
        lut[k] = np.asarray(v, np.float32) / 255.0
    labels = np.clip(np.asarray(labels), 0, len(lut) - 1)
    return lut[labels]


def confusion_matrix_figure(conf, class_names):
    """Normalized confusion-matrix heatmap as a matplotlib figure
    (reference visualization_utils.py:10-32); returns None without
    matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    conf = np.asarray(conf, dtype=np.float64)
    norm = conf / np.maximum(conf.sum(axis=1, keepdims=True), 1e-12)
    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(norm, cmap="viridis")
    ax.set_xticks(range(len(class_names)))
    ax.set_yticks(range(len(class_names)))
    ax.set_xticklabels(class_names, rotation=90, fontsize=7)
    ax.set_yticklabels(class_names, fontsize=7)
    ax.set_xlabel("predicted")
    ax.set_ylabel("target")
    fig.colorbar(im)
    fig.tight_layout()
    return fig
