"""The port's FID command line (stinet_tpu_torch/metrics/fid_cli.py)
against the JAX package's (stinet_tpu/metrics/fid_cli.py) on the cases of
tests/test_fid_golden.py, on the same files: UV maps, images and `.npz`
statistics read equal, element for element, and the FIDs within 1e-12
relative (the same numpy and scipy on the same features)."""
import gzip

import numpy as np
import pytest
import torch

from stinet_tpu.metrics import fid_cli as jax_fid_cli
from stinet_tpu.metrics.fid import FIDScoreCumulative as JaxFID
from stinet_tpu_torch.metrics import fid_cli
from stinet_tpu_torch.metrics.fid import (
    FIDScoreCumulative, calculate_frechet_distance)


def _write_gz_uv(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(np.ascontiguousarray(arr, dtype=np.float32).tobytes())


def test_load_uv_file_reshape_and_flip(tmp_path):
    h, w = 4, 3
    raw = np.arange(h * w * 2, dtype=np.float32).reshape(h, w, 2)
    _write_gz_uv(tmp_path / "a.gz", raw)
    got = fid_cli.load_uv_file(str(tmp_path / "a.gz"), (h, w))
    np.testing.assert_array_equal(got, raw[::-1])
    np.testing.assert_array_equal(
        got, jax_fid_cli.load_uv_file(str(tmp_path / "a.gz"), (h, w)))
    with pytest.raises(ValueError, match="expected"):
        fid_cli.load_uv_file(str(tmp_path / "a.gz"), (h + 1, w))


@pytest.mark.parametrize("scale_size", [None, 4, (5, 3), 11])
def test_load_uv_dataset_matches_jax(tmp_path, scale_size):
    """Stacked and nearest-resized (pixel centres, ties rounded half up)
    as JAX's; a factor-2 downscale picks the odd pixels."""
    h, w = 8, 8
    rng = np.random.default_rng(0)
    frames = [rng.normal(size=(h, w, 2)).astype(np.float32)
              for _ in range(3)]
    for i, fr in enumerate(frames):
        _write_gz_uv(tmp_path / f"{i}.gz", fr)
    got = fid_cli.load_uv_dataset(str(tmp_path), (h, w), scale_size)
    want = jax_fid_cli.load_uv_dataset(str(tmp_path), (h, w), scale_size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if scale_size == 4:
        np.testing.assert_array_equal(got[0], frames[0][::-1][1::2, 1::2])
    empty = fid_cli.load_uv_dataset(str(tmp_path / "nope"), (h, w))
    assert empty.shape == (0, h, w, 2)


def test_stats_of_path_npz_short_circuit(tmp_path):
    mu, sigma = np.arange(4.0), np.eye(4) * 2.0
    np.savez(tmp_path / "stats.npz", mu=mu, sigma=sigma)
    fid = FIDScoreCumulative(feature_fn=None)  # would fail if used
    m, s = fid_cli.stats_of_path(str(tmp_path / "stats.npz"), fid, "k", 8)
    np.testing.assert_array_equal(m, mu)
    np.testing.assert_array_equal(s, sigma)


def _toy_dataset(root, h=8, w=8, n=6):
    """gz UV maps and the PNGs a toy renderer makes of them."""
    from PIL import Image
    rng = np.random.default_rng(3)
    gt_dir, uv_dir = root / "gt", root / "uv"
    gt_dir.mkdir()
    uv_dir.mkdir()
    for i in range(n):
        uv = rng.uniform(0, 1, size=(h, w, 2)).astype(np.float32)
        _write_gz_uv(uv_dir / f"{i}.gz", uv)
        rgb = np.concatenate([uv[::-1], uv[::-1, :, :1]], axis=-1)
        Image.fromarray((rgb * 255).astype(np.uint8)).save(
            gt_dir / f"{i}.png")
    return gt_dir, uv_dir


def _model_fn(uv_batch):  # [B, H, W, 2] -> [B, H, W, 3]
    return np.concatenate([uv_batch, uv_batch[..., :1]], axis=-1)


def _feature_fn(imgs):   # cheap 6-dim features: channel means + stds
    x = np.asarray(imgs, np.float64).reshape(len(imgs), -1, 3)
    return np.concatenate([x.mean(1), x.std(1)], axis=1)


def test_fid_given_path_and_model_matches_jax(tmp_path):
    """A gz UV folder through a toy renderer against the PNGs of the same
    renders: FID near 0 (uint8 quantization only), and JAX's value on the
    same files; the images read equal to JAX's, resized too."""
    gt_dir, uv_dir = _toy_dataset(tmp_path)
    got = fid_cli.fid_given_path_and_model(
        str(gt_dir), str(uv_dir), _model_fn, (8, 8),
        FIDScoreCumulative(feature_fn=_feature_fn), batch_size=4)
    want = jax_fid_cli.fid_given_path_and_model(
        str(gt_dir), str(uv_dir), _model_fn, (8, 8),
        JaxFID(feature_fn=_feature_fn), batch_size=4)
    assert 0 <= got < 1e-3
    assert got == pytest.approx(want, rel=1e-12, abs=1e-15)
    for size in (None, 5):
        np.testing.assert_array_equal(
            fid_cli.load_images(str(gt_dir), size),
            jax_fid_cli.load_images(str(gt_dir), size))
    with pytest.raises(ValueError, match=">= 2 .gz UV maps"):
        fid_cli.fid_given_path_and_model(
            str(gt_dir), str(gt_dir), _model_fn, (8, 8),
            FIDScoreCumulative(feature_fn=_feature_fn))


def test_inception_features_on_the_cpu(capsys):
    """Without weights: InceptionV3's pool3 features drawn from seed 0,
    with the warning, on [0, 1] NHWC images."""
    from stinet_tpu_torch.models.inception import InceptionV3
    imgs = np.random.default_rng(2).uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = fid_cli.inception_features(torch.device("cpu"))(imgs)
        with torch.no_grad():
            want = InceptionV3(generator=torch.Generator().manual_seed(0))(
                torch.from_numpy(imgs))
    finally:
        torch.set_num_threads(threads)
    assert "random features" in capsys.readouterr().out
    assert got.shape == (2, 2048)
    assert torch.equal(got, want)


def test_main_on_the_cpu_and_refusing_a_missing_card(tmp_path, capsys,
                                                     monkeypatch):
    """`main` with -d cpu on an image folder against a .npz file (the
    features: channel means and deviations in place of InceptionV3's),
    path1's statistics saved and read back: the printed FID is the
    distance of the two statistics. Without -d and without a card it
    raises."""
    gt_dir, _ = _toy_dataset(tmp_path, n=4)
    calls = []

    def features(device, weights=None):
        calls.append((device, weights))
        return _feature_fn

    monkeypatch.setattr(fid_cli, "inception_features", features)
    rng = np.random.default_rng(1)
    mu, a = rng.normal(size=6), rng.normal(size=(6, 4)) * 0.1
    np.savez(tmp_path / "b.npz", mu=mu, sigma=a @ a.T)
    value = fid_cli.main([str(gt_dir), str(tmp_path / "b.npz"),
                          "--save-stats", str(tmp_path / "a.npz"),
                          "--inception-weights", "w.pt", "-d", "cpu"])
    assert calls == [(torch.device("cpu"), "w.pt")]
    assert f"FID: {value}" in capsys.readouterr().out
    with np.load(tmp_path / "a.npz") as f:
        want = calculate_frechet_distance(f["mu"], f["sigma"], mu, a @ a.T)
    assert value == pytest.approx(float(want), rel=1e-12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fid_cli.main([str(tmp_path / "a.npz"), str(tmp_path / "b.npz")])
