"""Standalone FID command line, the counterpart of
`stinet_tpu/metrics/fid_cli.py` (the reference's utils/metrics/
fid_score.py): folder-vs-folder FID over images, precomputed `.npz`
statistics files (compute_statistics_of_path:327-333), and the gzipped UV
dataset format (UVPathDataset:71-113) consumed through an inference model
(calculate_fid_given_path_and_model:364-377).

  python -m stinet_tpu_torch.metrics.fid_cli path/to/real path/to/fake \\
      [--inception-weights pt_inception.pth] [--batch-size 32] [-d cpu]

Either path may be a `.npz` file with `mu`/`sigma` arrays instead of an
image folder; `--save-stats out.npz` writes path1's statistics for reuse.
InceptionV3 runs on the card (`--device`, default cuda; `serving.
resolve_device` raises where there is none) with TF32 off; without
`--inception-weights` its features are random (with a warning). PIL is
imported only to read image folders.
"""
import argparse
import glob
import gzip
import os

import numpy as np


def load_images(folder, size=None):
    """[N, H, W, 3] float32 in [0, 1] of the folder's png and jpg files in
    name order (each resized to size x size when `size` is given)."""
    from PIL import Image
    files = sorted(sum((glob.glob(os.path.join(folder, e))
                        for e in ("*.png", "*.jpg", "*.jpeg")), []))
    imgs = []
    for f in files:
        img = Image.open(f).convert("RGB")
        if size:
            img = img.resize((size, size))
        imgs.append(np.asarray(img, dtype=np.float32) / 255.0)
    return np.stack(imgs) if imgs else np.zeros((0, 1, 1, 3), np.float32)


def _nearest_resize(img, out_hw):
    """Nearest-neighbour resize with pixel-centre alignment and ties
    rounded half up, floor(x + 0.5), as skimage's order-0 scaling of the
    reference's UV maps does (UVPathDataset._scale:95-113)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    rows = np.clip(np.floor((np.arange(oh) + 0.5) * h / oh), 0,
                   h - 1).astype(np.int64)
    cols = np.clip(np.floor((np.arange(ow) + 0.5) * w / ow), 0,
                   w - 1).astype(np.int64)
    return img[rows[:, None], cols[None, :]]


def load_uv_file(path, size):
    """One gzipped raw-float32 UV map as (H, W, 2), flipped vertically
    (UVPathDataset.__getitem__:81-93)."""
    h, w = size
    with gzip.open(path, "rb") as f:
        uv = np.frombuffer(f.read(), dtype=np.float32)
    if uv.size != h * w * 2:
        raise ValueError(
            f"{path}: {uv.size} floats, expected {h}x{w}x2 = {h * w * 2}")
    return np.flip(uv.reshape(h, w, 2), axis=0).copy()


def load_uv_dataset(folder, size, scale_size=None):
    """[N, H, W, 2] float32 stack of every *.gz UV map under `folder`, in
    name order, each nearest-resized to `scale_size` when given."""
    files = sorted(glob.glob(os.path.join(folder, "*.gz")))
    out = []
    for f in files:
        uv = load_uv_file(f, size)
        if scale_size is not None:
            ss = ((scale_size, scale_size) if isinstance(scale_size, int)
                  else tuple(scale_size))
            uv = _nearest_resize(uv, ss)
        out.append(uv)
    return (np.stack(out) if out
            else np.zeros((0,) + tuple(size) + (2,), np.float32))


def stats_of_path(path, fid, key, batch_size, resize=None):
    """(mu, sigma) of `path`: a .npz statistics file as stored, else the
    folder's images streamed through `fid`'s extractor under `key`."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    imgs = load_images(path, resize)
    if len(imgs) < 2:
        raise ValueError(f"need >= 2 images in {path}, found {len(imgs)}")
    for i in range(0, len(imgs), batch_size):
        fid.add_images(key, imgs[i:i + batch_size])
    return fid.get_statistics(key)


def fid_given_path_and_model(truth_path, inf_path, model_fn, inf_size, fid,
                             batch_size=32, scale_size=None, resize=None):
    """FID of ground-truth images (or .npz statistics) against a folder of
    gz UV maps pushed through `model_fn` (UV [B, H, W, 2] -> images
    [B, h, w, 3] in [0, 1])."""
    from stinet_tpu_torch.metrics.fid import calculate_frechet_distance
    m1, s1 = stats_of_path(truth_path, fid, "truth", batch_size, resize)
    uvs = load_uv_dataset(inf_path, inf_size, scale_size)
    if len(uvs) < 2:
        raise ValueError(f"need >= 2 .gz UV maps in {inf_path}, found "
                         f"{len(uvs)}")
    for i in range(0, len(uvs), batch_size):
        fid.add_images("inf", model_fn(uvs[i:i + batch_size]))
    m2, s2 = fid.get_statistics("inf")
    return float(calculate_frechet_distance(m1, s1, m2, s2))


def inception_features(device, weights=None):
    """(images [N, H, W, 3] in [0, 1] -> pool3 features on `device`, with
    TF32 off): InceptionV3 with the state-dict file `weights`, else random
    features drawn from seed 0."""
    import torch
    from stinet_tpu_torch.models.inception import (
        InceptionV3, inception_from_file)
    from stinet_tpu_torch.serving import full_f32_matmuls
    if weights:
        model = inception_from_file(weights)
    else:
        print("WARNING: no --inception-weights; using random features "
              "(relative comparison only)")
        model = InceptionV3(generator=torch.Generator().manual_seed(0))
    model = model.to(device)

    def features(images):
        x = torch.as_tensor(np.asarray(images, np.float32)).to(device)
        with full_f32_matmuls(), torch.no_grad():
            return model(x)
    return features


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path1")
    p.add_argument("path2")
    p.add_argument("--inception-weights", default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--resize", type=int, default=None)
    p.add_argument("--save-stats", default=None, metavar="OUT.npz",
                   help="also write path1's mu/sigma for later .npz reuse")
    p.add_argument("-d", "--device", default="cuda",
                   help="torch device of the feature extractor (default "
                        "cuda; cpu runs it on the host)")
    args = p.parse_args(argv)

    from stinet_tpu_torch.metrics.fid import (
        FIDScoreCumulative, calculate_frechet_distance)
    from stinet_tpu_torch.serving import resolve_device
    fid = FIDScoreCumulative(feature_fn=inception_features(
        resolve_device(args.device), args.inception_weights))
    m1, s1 = stats_of_path(args.path1, fid, "a", args.batch_size,
                           args.resize)
    if args.save_stats:
        np.savez(args.save_stats, mu=m1, sigma=s1)
    m2, s2 = stats_of_path(args.path2, fid, "b", args.batch_size,
                           args.resize)
    value = float(calculate_frechet_distance(m1, s1, m2, s2))
    # the full precision, as the reference prints it (fid_score.py:404):
    # random-feature values are tiny
    print("FID:", value)
    return value


if __name__ == "__main__":
    main()
