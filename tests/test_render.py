"""End-to-end rendering tests: furnace, Cornell statistics, gradients
(the SURVEY.md §4 test pyramid the CUDA reference lacks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudatracerlib_tpu.render.path_tracer import PTConfig, render
from cudatracerlib_tpu.scene import bsdf as B
from cudatracerlib_tpu.scene.shapes import cornell_box, furnace_scene


@pytest.fixture(scope="module")
def cornell():
    return cornell_box()


class TestFurnace:
    def test_diffuse_furnace(self):
        """Convex diffuse sphere in unit env -> radiance == albedo exactly."""
        scene = furnace_scene(albedo=0.7, bsdf_type=B.DIFFUSE)
        img = np.asarray(render(scene, 48, 48, 32, 0, PTConfig(max_depth=6)))
        center = img[18:30, 18:30].mean()
        edge = img[0:4, 0:4].mean()
        assert abs(edge - 1.0) < 0.02, f"env miss radiance {edge}"
        assert abs(center - 0.7) < 0.03, f"diffuse furnace {center}"

    def test_white_furnace_unit_albedo(self):
        """Albedo 1 diffuse: everything must be exactly env radiance (energy)."""
        scene = furnace_scene(albedo=1.0, bsdf_type=B.DIFFUSE)
        img = np.asarray(render(scene, 32, 32, 32, 0, PTConfig(max_depth=16)))
        assert abs(img.mean() - 1.0) < 0.03, img.mean()

    @pytest.mark.parametrize(
        "bt,kw",
        [
            (B.ROUGHCONDUCTOR, dict(alpha_u=0.3, alpha_v=0.3)),
            (B.PLASTIC, {}),
            (B.ROUGHPLASTIC, dict(alpha_u=0.3, alpha_v=0.3)),
            (B.PHONG, {}),
            (B.WARD, dict(alpha_u=0.3, alpha_v=0.3)),
            (B.ROUGHDIELECTRIC, dict(alpha_u=0.1, alpha_v=0.1, dist_type=0)),
            (B.DIELECTRIC, {}),
            (B.ROUGHDIELECTRIC, dict(alpha_u=0.3, alpha_v=0.3)),
            (B.THINDIELECTRIC, {}),
            (B.CONDUCTOR, {}),
            (B.ROUGHDIFFUSE, dict(alpha_u=0.3)),
        ],
    )
    def test_energy_conservation(self, bt, kw):
        """No BSDF may gain energy in a unit furnace."""
        spec = 0.2 if bt in (B.PHONG, B.WARD) else 1.0  # kd + ks <= 1
        scene = furnace_scene(albedo=0.8, bsdf_type=bt, specular=spec, **kw)
        img = np.asarray(render(scene, 32, 32, 16, 0, PTConfig(max_depth=8)))
        assert np.isfinite(img).all()
        assert img.mean() < 1.1, f"type {bt} gains energy: {img.mean()}"
        # lossless transmissive/reflective types should stay near 1
        if bt in (B.DIELECTRIC, B.THINDIELECTRIC, B.ROUGHDIELECTRIC):
            assert img.mean() > 0.85, f"type {bt} loses too much: {img.mean()}"


class TestCornell:
    def test_colors_and_sanity(self, cornell):
        img = np.asarray(render(cornell, 96, 96, 8, 0, PTConfig(max_depth=6)))
        assert np.isfinite(img).all()
        assert img.mean() > 0.05
        left = img[30:70, 3:12].mean(axis=(0, 1))
        right = img[30:70, 84:93].mean(axis=(0, 1))
        assert left[0] > 2 * left[1], f"left wall not red: {left}"
        assert right[1] > 2 * right[0], f"right wall not green: {right}"

    def test_deterministic(self, cornell):
        a = np.asarray(render(cornell, 32, 32, 4, 7, PTConfig(max_depth=4)))
        b = np.asarray(render(cornell, 32, 32, 4, 7, PTConfig(max_depth=4)))
        np.testing.assert_array_equal(a, b)

    def test_seed_variation(self, cornell):
        a = np.asarray(render(cornell, 32, 32, 4, 0, PTConfig(max_depth=4)))
        b = np.asarray(render(cornell, 32, 32, 4, 1, PTConfig(max_depth=4)))
        assert np.abs(a - b).max() > 1e-4

    def test_nee_consistency(self, cornell):
        """NEE+MIS and BSDF-only sampling must converge to the same image."""
        cfg_a = PTConfig(max_depth=4, rr_start=99, direct=True)
        cfg_b = PTConfig(max_depth=4, rr_start=99, direct=False)
        img_a = np.zeros((48, 48, 3), np.float32)
        img_b = np.zeros((48, 48, 3), np.float32)
        n = 24
        for s in range(n):
            img_a += np.asarray(render(cornell, 48, 48, 8, s, cfg_a)) / n
            img_b += np.asarray(render(cornell, 48, 48, 8, s + 1000, cfg_b)) / n
        # compare downsampled means (BSDF-only is noisy)
        a = img_a.reshape(12, 4, 12, 4, 3).mean((1, 3))
        b = img_b.reshape(12, 4, 12, 4, 3).mean((1, 3))
        rel = np.abs(a - b).sum() / np.abs(a).sum()
        assert rel < 0.15, f"NEE vs BSDF-only disagree: rel={rel}"


class TestGradients:
    """The BASELINE pixel-gradient-allclose gate (BASELINE.json)."""

    def _fd_ad(self, scene, wrt, set_fn, h, idx):
        cfg = PTConfig(max_depth=4, rr_start=99)

        def loss(x):
            return jnp.mean(render(set_fn(scene, x), 32, 32, 8, 0, cfg))

        x0 = wrt
        g_ad = jax.grad(loss)(x0)
        e = jnp.zeros_like(x0)
        e = e.at[idx].set(h)
        fd = (loss(x0 + e) - loss(x0 - e)) / (2 * h)
        return float(fd), float(g_ad[idx])

    def test_albedo_gradient(self, cornell):
        fd, ad = self._fd_ad(
            cornell,
            cornell.textures.color_a,
            lambda s, x: s._replace(textures=s.textures._replace(color_a=x)),
            1e-3,
            (0, 0),
        )
        assert abs(fd - ad) < 0.05 * max(abs(fd), 1e-3) + 1e-4, (fd, ad)

    def test_light_radiance_gradient(self, cornell):
        fd, ad = self._fd_ad(
            cornell,
            cornell.lights.radiance,
            lambda s, x: s._replace(lights=s.lights._replace(radiance=x)),
            1e-2,
            (0, 0),
        )
        assert abs(fd - ad) < 0.05 * max(abs(fd), 1e-4) + 1e-5, (fd, ad)

    def test_roughness_gradient_finite(self):
        scene = furnace_scene(albedo=0.8, bsdf_type=B.ROUGHCONDUCTOR, alpha_u=0.3, alpha_v=0.3)
        cfg = PTConfig(max_depth=3, rr_start=99)

        def loss(a):
            s = scene._replace(
                materials=scene.materials._replace(alpha_u=a, alpha_v=a)
            )
            return jnp.mean(render(s, 24, 24, 8, 0, cfg))

        g = jax.grad(loss)(scene.materials.alpha_u)
        assert np.isfinite(np.asarray(g)).all()

    def test_camera_origin_gradient(self):
        """BASELINE camera-gradient gate (SceneTypes/Sensor.h:217 counterpart):
        FD-vs-AD of a camera dolly on a silhouette-free scene (one wall
        filling the frame + a point light): the gradient is the smooth
        shading/reprojection term, which detached-visibility AD must match.

        Caveat (documented): silhouette/edge terms of camera derivatives are
        NOT captured by detached-sampling AD; on scenes with visible edges
        FD and AD differ by the boundary integral."""
        from cudatracerlib_tpu.scene import lights as L
        from cudatracerlib_tpu.scene.scene import Materials, build_scene
        from cudatracerlib_tpu.scene.sensors import Camera
        from cudatracerlib_tpu.scene.shapes import quad
        from cudatracerlib_tpu.scene.textures import Textures

        wall = quad([-50, 5, -50], [50, 5, -50], [50, 5, 50], [-50, 5, 50])
        textures = Textures.build([{"type": 0, "color_a": [0.7, 0.6, 0.5]}])
        materials = Materials.build([{"bsdf_type": B.DIFFUSE, "tex_albedo": 0}])
        cam = Camera.look_at([0, 0, 0], [0, 5, 0], up=[0, 0, 1], fov_deg=40.0)
        scene = build_scene(
            wall, None, None, np.zeros(len(wall), np.int32), materials,
            textures,
            [{"type": L.POINT, "position": [0, 1.0, 0.5],
              "radiance": [30.0] * 3}],
            cam,
        )
        cfg = PTConfig(max_depth=2, rr_start=99)

        def loss(dy):
            # dolly the camera toward the wall: to_world translation column
            m = scene.camera.to_world.at[1, 3].add(dy)
            s = scene._replace(camera=scene.camera._replace(to_world=m))
            return jnp.mean(render(s, 24, 24, 8, 0, cfg))

        g = float(jax.grad(loss)(jnp.float32(0.0)))
        assert np.isfinite(g)
        h = 1e-2
        fd = float(loss(jnp.float32(h)) - loss(jnp.float32(-h))) / (2 * h)
        # moving toward the light+wall brightens the frame
        assert abs(fd - g) < 0.1 * max(abs(fd), 1e-4) + 1e-4, (fd, g)

    def test_camera_fov_gradient(self):
        """FOV gradient through sample_ray's tan_half_fov (zoom changes the
        solid angle each pixel integrates -> smooth image change on the
        silhouette-free wall scene)."""
        from cudatracerlib_tpu.scene import lights as L
        from cudatracerlib_tpu.scene.scene import Materials, build_scene
        from cudatracerlib_tpu.scene.sensors import Camera
        from cudatracerlib_tpu.scene.shapes import quad
        from cudatracerlib_tpu.scene.textures import Textures

        wall = quad([-50, 5, -50], [50, 5, -50], [50, 5, 50], [-50, 5, 50])
        textures = Textures.build([{"type": 0, "color_a": [0.7, 0.6, 0.5]}])
        materials = Materials.build([{"bsdf_type": B.DIFFUSE, "tex_albedo": 0}])
        cam = Camera.look_at([0, 0, 0], [0, 5, 0], up=[0, 0, 1], fov_deg=40.0)
        scene = build_scene(
            wall, None, None, np.zeros(len(wall), np.int32), materials,
            textures,
            [{"type": L.POINT, "position": [0, 1.0, 0.5],
              "radiance": [30.0] * 3}],
            cam,
        )
        cfg = PTConfig(max_depth=2, rr_start=99)

        def loss(s_fov):
            s = scene._replace(camera=scene.camera._replace(
                tan_half_fov=scene.camera.tan_half_fov * s_fov))
            return jnp.mean(render(s, 24, 24, 8, 0, cfg))

        g = float(jax.grad(loss)(jnp.float32(1.0)))
        assert np.isfinite(g)
        h = 1e-2
        fd = float(loss(jnp.float32(1 + h)) - loss(jnp.float32(1 - h))) / (2 * h)
        assert abs(fd - g) < 0.1 * max(abs(fd), 1e-4) + 1e-4, (fd, g)

    def test_remat_gradients_match(self, cornell):
        """config.remat must not change values or gradients — only memory."""
        cfg = PTConfig(max_depth=4, rr_start=99)
        cfg_r = cfg._replace(remat=True)

        def loss(x, c):
            s = cornell._replace(
                textures=cornell.textures._replace(color_a=x))
            return jnp.mean(render(s, 24, 24, 4, 0, c))

        x0 = cornell.textures.color_a
        v0, g0 = jax.value_and_grad(loss)(x0, cfg)
        v1, g1 = jax.value_and_grad(loss)(x0, cfg_r)
        assert abs(float(v0) - float(v1)) < 1e-6
        np.testing.assert_allclose(np.asarray(g0), np.asarray(g1),
                                   rtol=1e-4, atol=1e-7)


class TestProgressive:
    def test_fused_passes_match_average(self, cornell):
        from cudatracerlib_tpu.render.path_tracer import render_progressive

        cfg = PTConfig(max_depth=3, rr_start=99)
        fused = np.asarray(render_progressive(cornell, 24, 24, 2, 4, 0, cfg))
        manual = np.zeros_like(fused)
        for i in range(4):
            manual += np.asarray(render(cornell, 24, 24, 2, i, cfg)) / 4
        np.testing.assert_allclose(fused, manual, rtol=1e-4, atol=1e-5)

    def test_regularization_unbiased_on_diffuse(self, cornell):
        """Mollification only affects delta lobes; a diffuse scene must be
        bitwise unchanged."""
        cfg_a = PTConfig(max_depth=3, rr_start=99)
        cfg_b = PTConfig(max_depth=3, rr_start=99, regularization=0.1)
        a = np.asarray(render(cornell, 16, 16, 2, 0, cfg_a))
        b = np.asarray(render(cornell, 16, 16, 2, 0, cfg_b))
        np.testing.assert_allclose(a, b, atol=1e-6)


class TestFilterSplatting:
    def test_gaussian_accumulation_beats_post_blur(self):
        """Filter-importance splatting (Engine/Image.cu:22-44 weightSum +
        CanonicalFilter.cu) must beat the post-process blur estimator on MSE
        vs a converged reference at equal rays: the post-blur smears signal
        AND noise, the splatting estimator only shares samples inside the
        filter support."""
        import numpy as np

        from cudatracerlib_tpu.image.pipeline import GAUSSIAN, apply_filter
        from cudatracerlib_tpu.render.path_tracer import PTConfig, render
        from cudatracerlib_tpu.scene.shapes import cornell_box

        scene = cornell_box()
        W = H = 48
        # both estimators target the gaussian-filtered measurement, so the
        # reference is the CONVERGED splat-filtered image (comparing against
        # a converged box image would count the legitimate AA difference at
        # the bright light edge as "error" for the splat estimator only)
        cfg_splat = PTConfig(max_depth=3, rec_filter=GAUSSIAN, rec_radius=1.5)
        ref = np.zeros((H, W, 3), np.float32)
        for s in range(4):
            ref += np.asarray(render(scene, W, H, 32, 100 + s, cfg_splat))
        ref /= 4

        box = np.asarray(render(scene, W, H, 4, 7, PTConfig(max_depth=3)))
        # same filter, same 3x3 support for both estimators
        blurred = np.asarray(apply_filter(box, GAUSSIAN, radius=1.5, taps=3))
        splat = np.asarray(render(scene, W, H, 4, 7, cfg_splat))
        mse_blur = float(((blurred - ref) ** 2).mean())
        mse_splat = float(((splat - ref) ** 2).mean())
        assert mse_splat < mse_blur, (mse_splat, mse_blur)

    def test_box_filter_path_unchanged(self):
        """rec_filter=0 must hit the fast reshape-sum path bit-for-bit."""
        import numpy as np

        from cudatracerlib_tpu.render.path_tracer import PTConfig, render
        from cudatracerlib_tpu.scene.shapes import cornell_box

        scene = cornell_box()
        a = np.asarray(render(scene, 24, 24, 2, 3, PTConfig(max_depth=2)))
        b = np.asarray(render(scene, 24, 24, 2, 3,
                              PTConfig(max_depth=2, rec_filter=0)))
        assert np.array_equal(a, b)
