"""Tests for DynamicScene, material lib, dispersion, samplers, realtime tracers."""
import jax.numpy as jnp
import numpy as np
import pytest

from cudatracerlib_tpu.math import dispersion
from cudatracerlib_tpu.sampling.samplers import (HALTON, SOBOL, STRATIFIED,
                                                 SequenceTable)
from cudatracerlib_tpu.scene import bsdf as B
from cudatracerlib_tpu.scene import lights as L
from cudatracerlib_tpu.scene import material_lib
from cudatracerlib_tpu.scene.dynamic import DynamicScene
from cudatracerlib_tpu.scene.sensors import Camera
from cudatracerlib_tpu.scene.shapes import box, quad


class TestDynamicScene:
    def test_create_update_render(self):
        from cudatracerlib_tpu.render.path_tracer import PTConfig, render

        ds = DynamicScene()
        floor = ds.create_mesh(quad([-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]))
        cube = ds.create_mesh(box([-0.4, -0.4, 0], [0.4, 0.4, 0.8]))
        ds.create_node(floor)
        n_cube = ds.create_node(cube)
        lamp = ds.create_mesh(quad([-0.5, -0.5, 3], [0.5, -0.5, 3], [0.5, 0.5, 3], [-0.5, 0.5, 3])[:, ::-1])
        n_lamp = ds.create_node(lamp)
        ds.make_node_emissive(n_lamp, [15.0, 15.0, 12.0])
        ds.set_camera(Camera.look_at([0, -5, 2], [0, 0, 0.5]))
        scene = ds.update()
        img = np.asarray(render(scene, 24, 24, 4, 0, PTConfig(max_depth=3)))
        assert np.isfinite(img).all() and img.mean() > 0.001

        # mutate: move the cube, re-update (incremental update cycle)
        m = np.eye(4)
        m[0, 3] = 1.0
        ds.set_node_transform(n_cube, m)
        scene2 = ds.update()
        img2 = np.asarray(render(scene2, 24, 24, 4, 0, PTConfig(max_depth=3)))
        assert np.abs(img2 - img).max() > 1e-4  # image changed

        # remove node
        ds.remove_node(n_cube)
        scene3 = ds.update()
        assert scene3.bvh.woop.shape[0] < scene2.bvh.woop.shape[0]

    def test_instancing_shares_mesh(self):
        ds = DynamicScene()
        cube = ds.create_mesh(box([0, 0, 0], [1, 1, 1]))
        for i in range(3):
            m = np.eye(4)
            m[0, 3] = 2.0 * i
            ds.create_node(cube, m)
        ds.create_light({"type": L.CONSTANT_ENV, "radiance": [1, 1, 1]})
        scene = ds.update()
        assert scene.bvh.tri_index.shape[0] >= 36  # 3 instances x 12 tris


class TestMaterialLib:
    def test_conductor_lookup(self):
        eta, k = material_lib.conductor("au")
        assert eta.shape == (3,) and k.shape == (3,)
        with pytest.raises(KeyError):
            material_lib.conductor("unobtainium")

    def test_ior_and_media(self):
        assert abs(material_lib.ior("glass") - 1.5046) < 1e-4
        ss, sa, eta = material_lib.medium("marble")
        assert ss.shape == (3,) and eta == 1.5


class TestEnvSampling:
    """Importance sampling of an environment map (lights._sample_env)."""

    @staticmethod
    def _env_light(h, w, seed):
        rng = np.random.default_rng(seed)
        env = rng.uniform(0.05, 1.0, (h, w, 3)).astype(np.float32)
        env[h // 3, w // 4] = 40.0  # a sun-like hot texel
        return L.build_lights([{"type": L.INFINITE, "radiance": [1, 1, 1]}],
                              [0, 0, 0], 1.0, env_map=env)

    @pytest.mark.parametrize("h,w", [(8, 16), (32, 64)])
    def test_pdf_matches_pdf_env_dir(self, h, w):
        """The sampled pdf is the density pdf_env_dir (MIS's counterpart)
        gives the sampled direction."""
        lights = self._env_light(h, w, seed=h)
        n = 4096
        u2 = jnp.asarray(np.random.default_rng(1).uniform(size=(n, 2)),
                         jnp.float32)
        lid = jnp.zeros(n, jnp.int32)
        d, pdf, rad = L._sample_env(lights, lid, u2)
        ref = np.asarray(L.pdf_env_dir(lights, lid, d))
        close = np.isclose(np.asarray(pdf), ref, rtol=1e-3)
        assert close.mean() >= 0.99, close.mean()
        assert np.isfinite(np.asarray(rad)).all()

    def test_hot_texel_frequency(self):
        """Texels are drawn in proportion to their weight env_w."""
        h, w = 8, 16
        lights = self._env_light(h, w, seed=3)
        n = 1 << 15
        u2 = jnp.asarray(np.random.default_rng(2).uniform(size=(n, 2)),
                         jnp.float32)
        d, _, _ = L._sample_env(lights, jnp.zeros(n, jnp.int32), u2)
        d = np.asarray(d)
        theta = np.arccos(np.clip(d[:, 2], -1, 1))
        phi = np.mod(np.arctan2(d[:, 1], d[:, 0]), 2 * np.pi)
        y = np.clip((theta / np.pi * h).astype(int), 0, h - 1)
        x = np.clip((phi / (2 * np.pi) * w).astype(int), 0, w - 1)
        env_w = np.asarray(lights.env_w)
        p_hot = env_w[h // 3, w // 4] / env_w.sum()
        got = np.mean((y == h // 3) & (x == w // 4))
        assert abs(got - p_hot) < 4 * np.sqrt(p_hot * (1 - p_hot) / n)


class TestDispersion:
    def test_cauchy_monotonic(self):
        n = np.asarray(dispersion.rgb_ior_cauchy("bk7"))
        # blue bends more than red
        assert n[2] > n[1] > n[0]
        assert abs(n[1] - 1.518) < 5e-3

    def test_sellmeier_close_to_cauchy(self):
        n_s = float(dispersion.sellmeier_ior(0.55, *dispersion.SELLMEIER_BK7))
        assert abs(n_s - 1.5185) < 2e-3


class TestSequences:
    @pytest.mark.parametrize("kind", [STRATIFIED, HALTON, SOBOL])
    def test_uniform_and_stratified(self, kind):
        tab = SequenceTable.build(kind, 256, 4)
        t = np.asarray(tab.table)
        assert t.shape == (256, 4)
        assert t.min() >= 0 and t.max() < 1
        # mean close to 0.5, better-than-random discrepancy for halton dim0
        np.testing.assert_allclose(t.mean(axis=0), 0.5, atol=0.06)

    def test_halton_low_discrepancy(self):
        tab = SequenceTable.build(HALTON, 1024, 2)
        t = np.asarray(tab.table)[:, 0]
        # star discrepancy proxy: max gap between sorted points ~ 1/n
        gaps = np.diff(np.sort(t))
        assert gaps.max() < 8.0 / 1024

    def test_rotation_decorrelates_pixels(self):
        tab = SequenceTable.build(HALTON, 64, 2)
        a = np.asarray(tab.sample(jnp.uint32(1), jnp.arange(64), 0))
        b = np.asarray(tab.sample(jnp.uint32(2), jnp.arange(64), 0))
        assert np.abs(a - b).max() > 0.01


class TestRealtime:
    def test_fast_and_game(self):
        from cudatracerlib_tpu.render.realtime import (GTConfig, render_fast,
                                                       render_game)
        from cudatracerlib_tpu.scene.shapes import cornell_box

        scene = cornell_box()
        img, depth = render_fast(scene, 32, 32)
        img, depth = np.asarray(img), np.asarray(depth)
        assert np.isfinite(img).all() and (depth > 0).mean() > 0.7

        psf = None
        means = []
        for f in range(3):
            frame, psf = render_game(scene, psf, 32, 32, f,
                                     GTConfig(radius=0.1, max_gather=8))
            means.append(float(np.asarray(frame).mean()))
        assert all(np.isfinite(m) for m in means)
        assert means[0] > 0.01


class TestMIPMap:
    """MIP pyramid + wrap/filter modes (reference Engine/MIPMap_device.h)."""

    def _checker_tex(self):
        import numpy as np
        from cudatracerlib_tpu.scene import textures as T
        img = np.zeros((64, 64, 3), np.float32)
        img[::2, ::2] = 1.0
        img[1::2, 1::2] = 1.0
        return T, T.Textures.build([{"type": T.IMAGE, "image_id": 0}], images=[img])

    def test_pyramid_levels_average(self):
        import numpy as np
        from cudatracerlib_tpu.scene import textures as T
        img = np.random.default_rng(0).uniform(0, 1, (T.ATLAS_RES, T.ATLAS_RES, 3)).astype(np.float32)
        pyr = T.build_pyramid(img)
        assert pyr.shape == (T.ATLAS_TOTAL, 3)
        # coarsest level equals global mean
        np.testing.assert_allclose(pyr[-1], img.mean((0, 1)), atol=1e-4)

    def test_wide_footprint_converges_to_mean(self):
        import numpy as np
        import jax.numpy as jnp
        T, tex = self._checker_tex()
        uv = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (256, 2)).astype(np.float32))
        tid = jnp.zeros(256, jnp.int32)
        v = T.eval_texture(tex, tid, uv, uv_width=jnp.full(256, 1.0))
        np.testing.assert_allclose(np.asarray(v), 0.5, atol=1e-3)

    def test_narrow_footprint_matches_bilinear(self):
        import numpy as np
        import jax.numpy as jnp
        T, tex = self._checker_tex()
        uv = jnp.asarray(np.random.default_rng(2).uniform(0.1, 0.9, (256, 2)).astype(np.float32))
        tid = jnp.zeros(256, jnp.int32)
        v0 = T.eval_texture(tex, tid, uv)
        v1 = T.eval_texture(tex, tid, uv, uv_width=jnp.full(256, 1e-5))
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v0), atol=1e-3)

    def test_wrap_modes(self):
        import numpy as np
        import jax.numpy as jnp
        from cudatracerlib_tpu.scene import textures as T
        # horizontal gradient image
        img = np.zeros((64, 64, 3), np.float32)
        img[:, :, :] = (np.arange(64) / 63.0)[None, :, None]
        recs = [
            {"type": T.IMAGE, "image_id": 0, "wrap_mode": T.WRAP_REPEAT},
            {"type": T.IMAGE, "image_id": 0, "wrap_mode": T.WRAP_CLAMP},
            {"type": T.IMAGE, "image_id": 0, "wrap_mode": T.WRAP_BLACK},
        ]
        tex = T.Textures.build(recs, images=[img])
        uv = jnp.asarray([[1.25, 0.5]], jnp.float32)
        rep = T.eval_texture(tex, jnp.asarray([0]), uv)
        cla = T.eval_texture(tex, jnp.asarray([1]), uv)
        blk = T.eval_texture(tex, jnp.asarray([2]), uv)
        np.testing.assert_allclose(np.asarray(rep)[0, 0], 0.25, atol=0.02)
        np.testing.assert_allclose(np.asarray(cla)[0, 0], 1.0, atol=0.02)
        np.testing.assert_allclose(np.asarray(blk)[0], 0.0, atol=1e-6)

    def test_filter_mode_bilinear_ignores_width(self):
        import numpy as np
        import jax.numpy as jnp
        from cudatracerlib_tpu.scene import textures as T
        img = np.zeros((64, 64, 3), np.float32)
        img[::2, ::2] = 1.0
        img[1::2, 1::2] = 1.0
        tex = T.Textures.build(
            [{"type": T.IMAGE, "image_id": 0, "filter_mode": T.FILTER_BILINEAR}],
            images=[img])
        uv = jnp.asarray(np.random.default_rng(3).uniform(0.1, 0.9, (128, 2)).astype(np.float32))
        tid = jnp.zeros(128, jnp.int32)
        v_plain = T.eval_texture(tex, tid, uv)
        v_wide = T.eval_texture(tex, tid, uv, uv_width=jnp.full(128, 1.0))
        np.testing.assert_allclose(np.asarray(v_wide), np.asarray(v_plain), atol=1e-6)

    def test_aniso_blurs_minor_axis_only(self):
        import numpy as np
        import jax.numpy as jnp
        from cudatracerlib_tpu.scene import textures as T
        # vertical stripes: varying along u only
        img = np.zeros((256, 256, 3), np.float32)
        img[:, 128:, :] = 1.0
        tex = T.Textures.build([{"type": T.IMAGE, "image_id": 0}], images=[img])
        uv = jnp.asarray([[0.25, 0.5], [0.75, 0.5]], jnp.float32)
        tid = jnp.zeros(2, jnp.int32)
        # footprint elongated along v (stripes constant along v): edge stays sharp
        d_along_v = T.eval_texture(tex, tid, uv,
                                   duv0=jnp.tile(jnp.asarray([[0.0, 0.3]]), (2, 1)),
                                   duv1=jnp.tile(jnp.asarray([[0.004, 0.0]]), (2, 1)))
        v = np.asarray(d_along_v)
        assert v[0, 0] < 0.1 and v[1, 0] > 0.9


class TestMaterialMaps:
    """Normal/height/alpha maps (reference Engine/Material.h:38-70)."""

    def _quad_scene(self, mat_extra=None, tex_records=None, images=None,
                    uvs=None):
        import numpy as np
        import jax.numpy as jnp
        from cudatracerlib_tpu.scene import shapes as sh
        from cudatracerlib_tpu.scene.scene import Materials, build_scene
        from cudatracerlib_tpu.scene.textures import Textures
        from cudatracerlib_tpu.scene.sensors import Camera
        from cudatracerlib_tpu.scene import lights as lt

        tris = sh.quad([-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0])
        if uvs is None:
            uvs = np.array([[[0, 0], [1, 0], [1, 1]],
                            [[0, 0], [1, 1], [0, 1]]], np.float32)
        mat = {"bsdf_type": 0}
        if mat_extra:
            mat.update(mat_extra)
        mats = Materials.build([mat])
        texs = Textures.build(tex_records or [{"type": 0}], images=images)
        cam = Camera.look_at([0, 0, 3.0], [0, 0, 0], up=[0, 1, 0], fov_deg=40)
        lights = [{"type": lt.POINT, "position": [0.5, 0.5, 2.5],
                   "intensity": [5.0, 5.0, 5.0]}]
        return build_scene(tris, None, uvs, np.zeros(2, np.int32), mats, texs,
                           lights, cam)

    def test_alpha_test_punches_holes(self):
        import numpy as np
        import jax.numpy as jnp
        from cudatracerlib_tpu.render.path_tracer import PTConfig, render
        from cudatracerlib_tpu.scene import textures as T

        # alpha texture: checkerboard luminance 1/0, ref 0.5
        scene = self._quad_scene(
            mat_extra={"alpha_mode": 1, "tex_alpha": 1, "alpha_ref": 0.5},
            tex_records=[{"type": T.CONSTANT},
                         {"type": T.CHECKERBOARD, "color_a": [1, 1, 1],
                          "color_b": [0, 0, 0], "uv_xform": [4, 4, 0, 0]}],
        )
        img = render(scene, 48, 48, 4, jnp.uint32(0), PTConfig(max_depth=2))
        img = np.asarray(img)
        assert np.isfinite(img).all()
        lum = img.mean(-1)
        lit = (lum > 1e-4).mean()
        # roughly half the quad is punched out (plus background misses)
        assert 0.15 < lit < 0.6, lit

    def test_normal_map_changes_shading(self):
        import numpy as np
        import jax.numpy as jnp
        from cudatracerlib_tpu.render.path_tracer import PTConfig, render
        from cudatracerlib_tpu.scene import textures as T

        base = self._quad_scene()
        img0 = np.asarray(render(base, 32, 32, 4, jnp.uint32(0),
                                 PTConfig(max_depth=2)))
        # constant tangent-space normal tilted towards +x: (0.5+0.35, 0.5, 0.85)
        tilted = self._quad_scene(
            mat_extra={"tex_normal": 1},
            tex_records=[{"type": T.CONSTANT},
                         {"type": T.CONSTANT, "color_a": [0.85, 0.5, 0.85]}],
        )
        img1 = np.asarray(render(tilted, 32, 32, 4, jnp.uint32(0),
                                 PTConfig(max_depth=2)))
        assert np.isfinite(img1).all()
        diff = np.abs(img1 - img0).mean()
        assert diff > 1e-3, diff

    def test_height_map_flat_is_noop(self):
        import numpy as np
        import jax.numpy as jnp
        from cudatracerlib_tpu.render.path_tracer import PTConfig, render
        from cudatracerlib_tpu.scene import textures as T

        base = self._quad_scene()
        img0 = np.asarray(render(base, 32, 32, 4, jnp.uint32(0),
                                 PTConfig(max_depth=2)))
        flat_h = self._quad_scene(
            mat_extra={"tex_height": 1},
            tex_records=[{"type": T.CONSTANT},
                         {"type": T.CONSTANT, "color_a": [0.5, 0.5, 0.5]}],
        )
        img1 = np.asarray(render(flat_h, 32, 32, 4, jnp.uint32(0),
                                 PTConfig(max_depth=2)))
        np.testing.assert_allclose(img1, img0, atol=1e-4)


class TestDebugViz:
    """Pixel debug visualizers (Kernel/PixelDebugVisualizers/)."""

    def test_scalar_colorize_and_normalize(self):
        import numpy as np
        import jax.numpy as jnp
        from cudatracerlib_tpu.image import debug_viz as dv
        buf = jnp.asarray(np.linspace(0, 10, 64, dtype=np.float32).reshape(8, 8))
        img = np.asarray(dv.visualize_scalar(buf))
        assert img.shape == (8, 8, 3)
        assert img.min() >= 0.0 and img.max() <= 1.0
        # min maps to blue-ish, max to red-ish
        assert img[0, 0, 2] > img[0, 0, 0]
        assert img[-1, -1, 0] > img[-1, -1, 2]

    def test_vec_visualizers(self):
        import numpy as np
        import jax.numpy as jnp
        from cudatracerlib_tpu.image import debug_viz as dv
        v2 = jnp.zeros((4, 4, 2))
        img2 = np.asarray(dv.visualize_vec2(v2))
        np.testing.assert_allclose(img2[..., :2], 0.5, atol=1e-6)
        v3 = jnp.ones((4, 4, 3))
        img3 = np.asarray(dv.visualize_vec3(v3))
        np.testing.assert_allclose(img3, 1.0, atol=1e-6)

    def test_vector_field_overlay_draws(self):
        import numpy as np
        import jax.numpy as jnp
        from cudatracerlib_tpu.image import debug_viz as dv
        from cudatracerlib_tpu.render.prim_tracer import render_aovs
        from cudatracerlib_tpu.scene.shapes import cornell_box
        scene = cornell_box()
        aovs = render_aovs(scene, 32, 32)
        # world positions from depth + camera: use normals as the field at
        # hit points reconstructed from the depth AOV along camera rays
        from cudatracerlib_tpu.scene import sensors
        h = w = 32
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        uv = jnp.asarray(np.stack([(xs + 0.5) / w, (ys + 0.5) / h], -1),
                         jnp.float32).reshape(-1, 2)
        o, d, _ = sensors.sample_ray(scene.camera, uv, jnp.zeros_like(uv))
        depth = np.asarray(aovs["depth"]).reshape(-1, 1)
        pts = (np.asarray(o) + np.asarray(d) * depth).reshape(h, w, 3)
        nrm = np.asarray(aovs["normal_geo"]) * 2.0 - 1.0
        base = np.zeros((h, w, 3), np.float32)
        out = dv.draw_vector_field(base, scene.camera, pts, nrm,
                                   valid=depth.reshape(h, w) > 0,
                                   stride=8, scale=0.3)
        assert out.sum() > 0.0  # something was drawn
        assert out.shape == (h, w, 3)
