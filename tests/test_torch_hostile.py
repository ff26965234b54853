"""The port's hostile scenes (stinet_tpu_torch/utils/hostile.py) against the
JAX package's: the sphere and terrain source meshes and the scenes their
QEM ladders give, leaf for leaf."""
import dataclasses

import numpy as np
import pytest

from stinet_tpu.utils import hostile as jax_hostile
from stinet_tpu_torch.utils import hostile as port_hostile
from stinet_tpu_torch.preprocessing import native


@pytest.mark.parametrize("kind", ["sphere", "terrain"])
def test_source_mesh_equals_jax(kind):
    fn = f"{kind}_mesh"
    for got, want in zip(getattr(port_hostile, fn)(3000, seed=1),
                         getattr(jax_hostile, fn)(3000, seed=1)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["sphere", "terrain"])
def test_hostile_scene_equals_jax(kind):
    native.reset_calls()
    got = port_hostile.hostile_scene(num_vertices=4096, kind=kind, seed=0)
    assert native.calls.get("qem_decimate", 0) == 3
    want = jax_hostile.hostile_scene(num_vertices=4096, kind=kind, seed=0)
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), f.name
            for l in w:
                assert sorted(g[l]) == sorted(w[l]), f.name
                for d in w[l]:
                    np.testing.assert_array_equal(g[l][d], w[l][d])
        elif isinstance(w, list) and w and isinstance(w[0], np.ndarray):
            assert len(g) == len(w), f.name
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w, f.name
    e = got.level_edges[0]
    assert np.bincount(e[1]).max() >= 9        # valence skew


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown hostile kind"):
        port_hostile.hostile_scene(num_vertices=512, kind="cube")
