"""The soft raster, the renderer and mesh IO: PyTorch port vs the JAX
package on the CPU.

`rasterize_k` on a scene of small faces, frame-spanning big faces and
duplicated faces (equal z at every pixel they share, so the tie order
shows), for K in {1, 4}, with and without blur and backface culling: the
face ids must be JAX's; the barycentrics, z and edge distances agree
within the tolerances below (XLA's CPU code rounds z = sum c_i z_i a few
ulps away from ATen's). The blends and the K-level interpolation on that
buffer; every output layer of `RasterRenderer` under each blend mode on
one mesh both packages take; and the OBJ, PLY and GLB files both write,
byte for byte, each read by the other package.
"""

import numpy as np
import pytest
import torch

from diffusionhandles_tpu.geometry import mesh as jmesh
from diffusionhandles_tpu.geometry import mesh_io as jio
from diffusionhandles_tpu.geometry import renderer as jrend
from diffusionhandles_tpu.ops import rasterize as jr
from diffusionhandles_tpu_torch.geometry import mesh as tmesh
from diffusionhandles_tpu_torch.geometry import mesh_io as tio
from diffusionhandles_tpu_torch.geometry import renderer as trend
from diffusionhandles_tpu_torch.ops import rasterize as tr

# z, and the blended channels built on it, within a few fp32 ulps of
# the largest magnitude; the clipped barycentrics and edge distances
# within 2**-20 of theirs
Z_RTOL = 2.0 ** -21
ATTR_RTOL = 2.0 ** -20
BLEND_ATOL = 1e-6
KRASTER_FIELDS = ("face_id", "bary", "zbuf", "dists")


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rtol, what):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=what)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=what)
    if finite.any():
        scale = max(np.abs(want[finite]).max(), 1e-6)
        err = np.abs(got[finite] - want[finite]).max()
        assert err <= rtol * scale, f"{what}: {err:.3e} vs {rtol * scale:.3e}"


def _scene():
    """30 random small triangles (both windings), two frame-spanning
    slivers, and three duplicated faces (a small one, a big one, and one
    at a sliver's z) in pixel space, 40x40."""
    rng = np.random.RandomState(3)
    res = 40
    verts, faces = [], []

    def tri(pts):
        faces.append([len(verts), len(verts) + 1, len(verts) + 2])
        verts.extend(pts)

    for i in range(30):
        cx, cy = rng.uniform(3, res - 3, 2)
        r = rng.uniform(1.5, 4.5)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 3))
        if i % 5:
            ang = ang[::-1]  # CCW on screen (y down): kept by the cull
        tri([[cx + r * np.cos(a), cy + r * np.sin(a), 2.0 + 0.05 * i]
             for a in ang])
    tri([[-2.0, 12.0, 1.5], [-2.0, 13.5, 1.5], [res + 2.0, 14.5, 1.5]])
    tri([[6.0, -2.0, 5.5], [5.0, res + 2.0, 5.5], [7.5, res + 2.0, 5.5]])
    for f in (3, 30, 31):
        tri([verts[i] for i in faces[f]])
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int64),
            res)


def _both(k, blur_px2, cull):
    verts, faces, res = _scene()
    ndc2 = (2.0 / (res - 1)) ** 2
    kw = dict(faces_per_pixel=k, blur_radius=blur_px2 * ndc2,
              cull_backfaces=cull)
    want = jr.rasterize_k(verts, faces.astype(np.int32), res, res, **kw)
    got = tr.rasterize_k(torch.from_numpy(verts), torch.from_numpy(faces),
                         res, res, **kw)
    return got, want, faces


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "no_cull"])
@pytest.mark.parametrize("blur_px2", [0.0, 2.0], ids=["sharp", "blur"])
@pytest.mark.parametrize("k", [1, 4])
def test_rasterize_k_matches_jax(k, blur_px2, cull):
    got, want, faces = _both(k, blur_px2, cull)
    fid = np_(want.face_id)
    np.testing.assert_array_equal(np_(got.face_id), fid)
    assert got.face_id.dtype == torch.int64
    # the scene exercises what it is for: fragments at every level K
    # asks for, the slivers through the big-face pass, and ties
    assert (fid[-1] >= 0).any()
    assert np.isin(fid, [30, 31, 33, 34]).any()
    first = np.isin(fid, [3, 30, 31])
    dup = np.isin(fid, [32, 33, 34])
    if k > 1:
        assert dup.any() and first.any()
    _close(got.zbuf, want.zbuf, Z_RTOL, "zbuf")
    _close(got.bary, want.bary, ATTR_RTOL, "bary")
    _close(got.dists, want.dists, ATTR_RTOL, "dists")


def test_rasterize_k_tie_order_and_hard_limit():
    """A duplicated face ranks right after its original wherever the
    original is above the last level (the lower face id first at equal
    z), and K = 1 without blur gives the hard raster's face ids."""
    got, _, _ = _both(4, 0.0, True)
    fid, z = np_(got.face_id), np_(got.zbuf)
    for orig, dup in ((3, 32), (30, 33), (31, 34)):
        at = fid[:-1] == orig
        assert at.any(), orig
        np.testing.assert_array_equal(fid[1:][at], dup)
        np.testing.assert_array_equal(z[1:][at], z[:-1][at])
    verts, faces, res = _scene()
    hard = tr.rasterize(torch.from_numpy(verts), torch.from_numpy(faces),
                        res, res)
    one = tr.rasterize_k(torch.from_numpy(verts), torch.from_numpy(faces),
                         res, res, faces_per_pixel=1)
    np.testing.assert_array_equal(np_(one.face_id[0]), np_(hard.face_id))


@pytest.mark.parametrize("blur_px2", [0.0, 2.0], ids=["sharp", "blur"])
def test_rasterize_k_chunking_keeps_the_buffer(blur_px2, monkeypatch):
    """Small groups and chunks (many window groups, one or two big faces a
    chunk, each on its own pixel box) give the same K-buffer, bit for
    bit: the order of the merges does not change a top K by (z, id)."""
    verts, faces, res = _scene()
    kw = dict(faces_per_pixel=4, blur_radius=blur_px2 * (2.0 / 39) ** 2,
              cull_backfaces=False)
    args = (torch.from_numpy(verts), torch.from_numpy(faces), res, res)
    want = tr.rasterize_k(*args, **kw)
    monkeypatch.setattr(tr, "GROUP_ELEMENTS", 2000)
    chunks = tr._big_face_chunks(args[0], args[1], torch.tensor([30, 31, 33,
                                                                 34]),
                                 res, res, 2 if blur_px2 else 0)
    assert len(chunks) > 1
    got = tr.rasterize_k(*args, **kw)
    for name in KRASTER_FIELDS:
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np_(getattr(want, name)), name)


@pytest.mark.parametrize("blur_px2", [0.0, 2.0], ids=["sharp", "blur"])
def test_blends_match_jax(blur_px2):
    """sigmoid_alpha_blend, softmax_blend_weights (which sum to 1 with the
    background weight) and interpolate_attribute_k on the K = 4 buffer;
    sigma and gamma at a pixel's NDC scale so every term is soft."""
    got, want, faces = _both(4, blur_px2, False)
    ndc2 = (2.0 / 39) ** 2
    _close(tr.sigmoid_alpha_blend(got, sigma=ndc2),
           jr.sigmoid_alpha_blend(want, sigma=ndc2), BLEND_ATOL, "sigmoid")
    kw = dict(sigma=ndc2, gamma=0.05, znear=1.0, zfar=10.0)
    tw = tr.softmax_blend_weights(got, **kw)
    jw = jr.softmax_blend_weights(want, **kw)
    for name, g, w in zip(("weights", "bg_weight", "alpha"), tw, jw):
        _close(g, w, BLEND_ATOL, name)
    total = np_(tw[0].sum(0) + tw[1])
    np.testing.assert_allclose(total, 1.0, rtol=0, atol=1e-6)
    attr = np.random.RandomState(0).rand(
        int(faces.max()) + 1, 5).astype(np.float32)
    _close(tr.interpolate_attribute_k(got, torch.from_numpy(faces),
                                      torch.from_numpy(attr)),
           jr.interpolate_attribute_k(want, faces.astype(np.int32), attr),
           ATTR_RTOL, "interpolate_attribute_k")


# ---------------------------------------------------------------------------
# The renderer
# ---------------------------------------------------------------------------

LAYERS = ["depth", "mask", "face_id", "world_position", "camera_position",
          "world_normal", "vertex_normal", "flat_vertex_color", "uv_texture",
          "global_volume_texture", "alpha"]


def _intrinsics():
    f = 1.0 / np.tan(0.5 * 55.0 * np.pi / 180.0)
    return np.array([[f, 0, 0], [0, f, 0.05], [0, 0, 1]], np.float32)


def _render_scene():
    """A 20x20 depth mesh with a raised box (its edge stretches faces
    past the window), uv = the image coordinates, a ramp texture, a
    volume and a tilted camera; the port's mesh and the same numpy mesh
    for JAX."""
    res = 20
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    depth = (2.0 + 0.02 * yy + 0.01 * xx).astype(np.float32)
    depth[6:14, 6:14] -= 0.6
    mesh = tmesh.depth_to_mesh(depth, _intrinsics(), device="cpu")
    mesh.add_vert_attribute("uv", mesh.vert_attributes["color"][:, :2])
    jm = jmesh.Mesh(verts=np_(mesh.verts), faces=np_(mesh.faces).astype(
        np.int32), vert_attributes={k: np_(v) for k, v in
                                    mesh.vert_attributes.items()})
    tex = np.random.RandomState(1).rand(8, 8, 3).astype(np.float32)
    vol = np.random.RandomState(2).rand(4, 5, 6, 2).astype(np.float32)
    lo, hi = jm.bounds()
    c, s = np.cos(0.1), np.sin(0.1)
    cam = dict(intrinsics=_intrinsics(),
               extrinsics_R=np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                     np.float32),
               extrinsics_t=np.array([0.05, -0.02, 0.3], np.float32))
    scene = dict(uv_textures=[tex], global_volume_texture=vol,
                 global_volume_texture_bounds=(lo - 1e-3, hi + 1e-3))
    return res, mesh, jm, cam, scene


@pytest.mark.parametrize("blend", ["hard", "sigmoid", "softmax"])
def test_renderer_layers_match_jax(blend):
    """Every output layer, each blend mode (K = 3 and a blur for the soft
    ones), against the JAX renderer on the same mesh: coverage, face ids
    and the nearest-texel volume lookups exactly, the rest within the
    tolerances above."""
    res, mesh, jm, cam, scene = _render_scene()
    ndc2 = (2.0 / (res - 1)) ** 2
    soft = blend != "hard"
    kw = dict(output_res=(res, res), cull_backfaces=True,
              faces_per_pixel=3 if soft else 1,
              blur_radius=0.5 * ndc2 if soft else 0.0, blend_type=blend,
              blend_sigma=ndc2, blend_gamma=0.05, blend_zfar=10.0,
              background_color=(0.2, 0.3, 0.4))
    got = trend.RasterRenderer(LAYERS, trend.RasterRendererArgs(**kw))
    got.update_scene({"meshes": [mesh], "cameras": [trend.Camera(**cam)],
                      **scene})
    want = jrend.RasterRenderer(LAYERS, jrend.RasterRendererArgs(**kw))
    want.update_scene({"meshes": [jm], "cameras": [jrend.Camera(**cam)],
                       **scene})
    g, w = got.render(), want.render()
    assert set(g) == set(w) == set(LAYERS)
    for name in LAYERS:
        assert isinstance(g[name], np.ndarray), name
        assert g[name].dtype == w[name].dtype, (name, g[name].dtype,
                                                w[name].dtype)
    for name in ("mask", "face_id"):
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    assert 0 < g["mask"].mean() < 1
    if blend == "hard":
        np.testing.assert_array_equal(g["global_volume_texture"],
                                      w["global_volume_texture"])
    _close(g["depth"], w["depth"], Z_RTOL, "depth")
    for name in ("world_position", "camera_position", "world_normal",
                 "vertex_normal", "flat_vertex_color", "uv_texture",
                 "global_volume_texture"):
        _close(g[name], w[name], ATTR_RTOL, name)
    _close(g["alpha"], w["alpha"], BLEND_ATOL, "alpha")


def test_renderer_rejects_what_jax_rejects():
    """An unknown layer or blend type, a scene with no mesh or camera,
    a render before the scene, and a texture layer without its texture."""
    res, mesh, _, cam, _ = _render_scene()
    r = trend.RasterRenderer(["depth"], trend.RasterRendererArgs(
        output_res=(res, res)))
    with pytest.raises(RuntimeError):
        r.render()
    for bad in ({"meshes": [], "cameras": [trend.Camera(**cam)]},
                {"meshes": [mesh], "cameras": []}):
        with pytest.raises(ValueError):
            r.update_scene(bad)
    r.update_scene({"meshes": [mesh], "cameras": [trend.Camera(**cam)]})
    for layers in (["bogus"], ["uv_texture"], ["global_volume_texture"]):
        r.set_output_layers(layers)
        with pytest.raises(ValueError):
            r.render()
    r.args.blend_type = "bogus"
    r.set_output_layers(["depth"])
    with pytest.raises(ValueError, match="blend"):
        r.render()


# ---------------------------------------------------------------------------
# Mesh IO
# ---------------------------------------------------------------------------

def _io_mesh(colored: bool):
    depth = np.full((6, 7), 2.0, np.float32) + np.arange(7) * 0.1
    mask = np.ones((6, 7), bool)
    mask[0, 0] = False
    tm = tmesh.depth_to_mesh(depth, _intrinsics(), mask=mask, device="cpu")
    if not colored:
        tm.vert_attributes.clear()
    jm = jmesh.Mesh(verts=np_(tm.verts), faces=np_(tm.faces).astype(
        np.int32), vert_attributes={k: np_(v) for k, v in
                                    tm.vert_attributes.items()})
    return tm, jm


@pytest.mark.parametrize("colored", [True, False], ids=["color", "plain"])
@pytest.mark.parametrize("fmt", ["obj", "ply", "glb"])
def test_mesh_files_byte_equal_and_cross_read(fmt, colored, tmp_path):
    """Both writers make the same bytes (an OBJ with UVs and per-face UV
    indices); each package reads the other's file back to the mesh."""
    tm, jm = _io_mesh(colored)
    kw = {}
    if fmt == "obj":
        uvs = np.random.RandomState(0).rand(5, 2).astype(np.float32)
        fuv = (np.arange(len(jm.faces) * 3) % 5).reshape(-1, 3)
        kw = dict(uvs=uvs, face_uv_indices=fuv)
    t_path, j_path = tmp_path / f"t.{fmt}", tmp_path / f"j.{fmt}"
    tio.save_mesh(t_path, tm, **kw)
    jio.save_mesh(j_path, jm, **kw)
    assert t_path.read_bytes() == j_path.read_bytes()

    t_read = tio.load_mesh(j_path, device="cpu")
    j_read = jio.load_mesh(t_path)
    assert t_read.faces.dtype == torch.int64
    np.testing.assert_array_equal(np_(t_read.faces), j_read.faces)
    np.testing.assert_array_equal(np_(t_read.verts), j_read.verts)
    assert set(t_read.vert_attributes) == set(j_read.vert_attributes)
    for k in j_read.vert_attributes:
        np.testing.assert_array_equal(np_(t_read.vert_attributes[k]),
                                      j_read.vert_attributes[k])
    if fmt == "obj":
        _, t_uv, t_fuv = tio.load_mesh_obj(j_path, device="cpu")
        _, j_uv, j_fuv = jio.load_mesh_obj(t_path)
        np.testing.assert_array_equal(np_(t_uv), j_uv)
        np.testing.assert_array_equal(np_(t_fuv), j_fuv)
    np.testing.assert_allclose(np_(t_read.verts), np_(tm.verts), rtol=1e-7)
    with pytest.raises(ValueError):
        tio.save_mesh(tmp_path / "m.stl", tm)
