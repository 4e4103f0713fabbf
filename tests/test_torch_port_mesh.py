"""The mesh-mode depth transform: PyTorch port vs the JAX package on the
CPU.

`geometry/mesh.depth_to_mesh`, the hard rasterizer of `ops/rasterize.py`
on the scenes of tests/test_rasterize.py and
tests/test_rasterize_bigfaces.py, `geometry/mesh_transform.
transform_depth_mesh` with a 25-degree rotation, and a facade edit with
configs/mesh_depth_transform.yaml's mode, each held to its JAX
counterpart on the same numpy inputs.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionhandles_tpu.geometry import mesh as jmesh
from diffusionhandles_tpu.geometry import mesh_transform as jmt
from diffusionhandles_tpu.ops import rasterize as jr
from diffusionhandles_tpu_torch.geometry import mesh as tmesh
from diffusionhandles_tpu_torch.geometry import mesh_transform as tmt
from diffusionhandles_tpu_torch.geometry import transform as ttransform
from diffusionhandles_tpu_torch.ops import rasterize as tr
from torch_port_rig import torch_on_one_thread  # noqa: F401
from torch_port_rig import EDIT, close, edit_args, make_rig, np_

MESH_CONFIG = (pathlib.Path(__file__).parents[1] / "configs"
               / "mesh_depth_transform.yaml")


def _intrinsics():
    f = 1.0 / np.tan(0.5 * 55.0 * np.pi / 180.0)
    return np.array([[f, 0, 0], [0, f, 0], [0, 0, 1]], np.float32)


def _scene(res):
    """A box foreground 0.8 in front of a sloped background: its depth
    edge stretches faces past the small pass's window."""
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    bg = (2.5 + 0.004 * yy).astype(np.float32)
    lo, hi = res * 20 // 64, res * 44 // 64
    fg = (yy >= lo) & (yy < hi) & (xx >= lo) & (xx < hi)
    depth = bg.copy()
    depth[fg] -= 0.8
    return depth, bg, fg.astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_depth_to_mesh_matches_jax(masked):
    """Faces and the color attribute exactly; the vertices within 2 fp32
    ulps of the largest coordinate (XLA's jnp.linspace rounds some
    image-plane coordinates an ulp away from torch.linspace's grid, which
    the port lifts)."""
    depth, _, fg = _scene(32)
    mask = fg > 0.5 if masked else None
    want = jmesh.depth_to_mesh(depth, _intrinsics(), mask=mask)
    got = tmesh.depth_to_mesh(depth, _intrinsics(), mask=mask, device="cpu")
    np.testing.assert_array_equal(np_(got.faces), want.faces)
    np.testing.assert_array_equal(np_(got.vert_attributes["color"]),
                                  want.vert_attributes["color"])
    scale = np.abs(want.verts).max()
    assert np.abs(np_(got.verts) - want.verts).max() <= 2.0 ** -22 * scale


def test_mesh_container_matches_jax():
    """bounds, normalized and the attribute length checks."""
    depth, _, fg = _scene(16)
    want = jmesh.depth_to_mesh(depth, _intrinsics(), mask=fg > 0.5)
    got = tmesh.depth_to_mesh(depth, _intrinsics(), mask=fg > 0.5,
                              device="cpu")
    for g, w in zip(got.bounds(), want.bounds()):
        np.testing.assert_allclose(np_(g), w, rtol=1e-6)
    np.testing.assert_allclose(np_(got.normalized().verts),
                               want.normalized().verts, atol=1e-6)
    got.add_face_attribute("id", torch.arange(len(got.faces)))
    for add, n in ((got.add_vert_attribute, len(got.verts)),
                   (got.add_face_attribute, len(got.faces))):
        with pytest.raises(ValueError, match="entries"):
            add("bad", torch.zeros(n + 1))


def _sliver():
    return (np.array([[1.0, 1.0, 2.0], [1.0, 62.0, 2.5], [62.0, 30.0, 3.0]],
                     np.float32), np.array([[0, 1, 2]]), 64, {})


def _mixed():
    """30 small random triangles behind or among 3 frame-spanning ones."""
    rng = np.random.RandomState(7)
    verts, faces = [], []
    for _ in range(30):
        cu, cv = rng.uniform(3, 44, 2)
        tri = np.array([[cu, cv], [cu, cv + rng.uniform(1, 5)],
                        [cu + rng.uniform(1, 5), cv]])
        z = rng.uniform(4, 6, 3)
        faces.append([len(verts), len(verts) + 1, len(verts) + 2])
        verts.extend([[tri[k, 0], tri[k, 1], z[k]] for k in range(3)])
    for tri in ([[1, 1, 1.0], [1, 46, 1.2], [46, 24, 1.4]],
                [[2, 2, 8.0], [2, 45, 8.0], [45, 23, 8.0]],
                [[5, 0, 3.0], [0, 47, 3.5], [47, 47, 3.2]]):
        faces.append([len(verts), len(verts) + 1, len(verts) + 2])
        verts.extend(tri)
    return np.array(verts, np.float32), np.array(faces), 48, {}


SCENES = {
    "single_triangle": lambda: (np.array(
        [[2.0, 2.0, 1.0], [2.0, 12.0, 2.0], [12.0, 2.0, 3.0]], np.float32),
        np.array([[0, 1, 2]]), 16, dict(foot=12)),
    "backface_culled": lambda: (np.array(
        [[2.0, 2.0, 1.0], [12.0, 2.0, 1.0], [2.0, 12.0, 1.0]], np.float32),
        np.array([[0, 1, 2]]), 16, dict(foot=12, cull_backfaces=True)),
    "backface_kept": lambda: (np.array(
        [[2.0, 2.0, 1.0], [12.0, 2.0, 1.0], [2.0, 12.0, 1.0]], np.float32),
        np.array([[0, 1, 2]]), 16, dict(foot=12, cull_backfaces=False)),
    "frame_spanning_sliver": _sliver,
    "small_and_big_mixed": _mixed,
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_rasterize_matches_jax(scene):
    """Face ids exactly (ties to the lower face, small and big passes
    merged), zbuf and barycentrics within 1e-5."""
    verts, faces, res, kw = SCENES[scene]()
    want = jr.rasterize(jnp.asarray(verts), jnp.asarray(faces, jnp.int32),
                        res, res, **kw)
    got = tr.rasterize(torch.from_numpy(verts), torch.from_numpy(faces),
                       res, res, **kw)
    fid = np.asarray(want.face_id)
    np.testing.assert_array_equal(np_(got.face_id), fid)
    cov = fid >= 0
    if scene == "backface_culled":
        assert not cov.any()
    else:
        assert cov.sum() > 30
    zg, zw = np_(got.zbuf), np.asarray(want.zbuf)
    np.testing.assert_array_equal(np.isinf(zg), np.isinf(zw))
    np.testing.assert_allclose(zg[cov], zw[cov], rtol=1e-5, atol=0)
    np.testing.assert_allclose(np_(got.bary), np.asarray(want.bary),
                               rtol=0, atol=1e-5)
    if scene == "small_and_big_mixed":
        assert len(tr.big_faces(torch.from_numpy(verts),
                                torch.from_numpy(faces))) == 3
        assert (fid == 30).any()


def test_rasterize_streams_the_small_pass(monkeypatch):
    """Offsets streamed in groups of one, and big faces in chunks of
    one, rasterize the same bits as one group."""
    verts, faces, res, _ = _mixed()
    one = tr.rasterize(torch.from_numpy(verts), torch.from_numpy(faces),
                       res, res)
    monkeypatch.setattr(tr, "GROUP_ELEMENTS", 1)
    many = tr.rasterize(torch.from_numpy(verts), torch.from_numpy(faces),
                        res, res)
    for a, b in zip(one, many):
        assert torch.equal(a, b)


@pytest.mark.parametrize("res,edit", [
    (32, dict(rot_angle=25.0, rot_axis=[0.0, 1.0, 0.0],
              translation=[0.02, 0.0, 0.0])),
    (64, dict(rot_angle=25.0, rot_axis=[0.0, 1.0, 0.0],
              translation=[0.02, 0.0, 0.0])),
    (64, dict(rot_angle=-25.0, rot_axis=[1.0, 0.0, 0.0],
              translation=[0.0, 0.0, 0.1], use_input_depth_normalization=True)),
    (32, "empty")])
def test_transform_depth_mesh_matches_jax(res, edit):
    """Disparity within 1e-5 of its scale, correspondences equal."""
    depth, bg, fg = _scene(res)
    if edit == "empty":
        fg, edit = fg * 0, {}
    args = (depth[None, None], bg[None, None], fg[None, None], _intrinsics())
    jd, jc = jmt.transform_depth_mesh(*args, **edit)
    td, tc = tmt.transform_depth_mesh(*args, device="cpu", **edit)
    assert isinstance(td, torch.Tensor) and td.shape == (1, 1, res, res)
    close(td, jd, "edited disparity", 1e-5)
    assert tc.dtype == np.int64
    np.testing.assert_array_equal(tc, jc)
    if edit:
        assert len(tc) > 50
        verts_px = tr.project_verts(
            tmt.merge_meshes(
                tmesh.depth_to_mesh(bg, _intrinsics(), device="cpu"),
                tmesh.depth_to_mesh(depth, _intrinsics(), mask=fg > 0.5,
                                    device="cpu")).verts,
            _intrinsics(), res, res)
        assert verts_px.shape[0] == res * res + int(fg.sum())
    # the dispatcher takes the same path
    d2, c2 = ttransform.transform_depth(*args, depth_transform_mode="mesh",
                                        device="cpu", **edit)
    assert torch.equal(d2, td) and np.array_equal(c2, tc)


def test_transform_depth_unknown_mode_raises():
    depth, bg, fg = _scene(16)
    with pytest.raises(ValueError, match="Unknown depth transform mode"):
        ttransform.transform_depth(depth, bg, fg, _intrinsics(),
                                   depth_transform_mode="splat",
                                   device="cpu")


@pytest.fixture(scope="module")
def rig():
    jh, th, s, rec = make_rig(MESH_CONFIG)
    assert th.conf.depth_transform_mode == "mesh"
    assert jh.conf.depth_transform_mode == "mesh"
    return jh, th, s, rec


def test_facade_mesh_edit_matches_jax(rig):
    jh, th, s, rec = rig
    j_img, j_disp = jh.transform_foreground(**edit_args(s, rec), **EDIT)
    t_img, t_disp = th.transform_foreground(**edit_args(s, rec), **EDIT)
    assert t_img.shape == (1, 3, th.img_res, th.img_res)
    close(t_disp, j_disp, "edited disparity", 1e-5)
    close(t_img, j_img, "edited image", 5e-3)
