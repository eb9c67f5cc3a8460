"""Cross-engine consistency tests: wavefront, PPM, volumetric, grids, media.

The reference has no such suite (SURVEY.md §4); here every integrator is
checked against the megakernel path tracer on the same scene.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudatracerlib_tpu.accel import hashgrid as hg
from cudatracerlib_tpu.render.path_tracer import PTConfig, render
from cudatracerlib_tpu.render.ppm import PPMConfig, render_ppm_pass
from cudatracerlib_tpu.render.prim_tracer import render_aovs
from cudatracerlib_tpu.render.volpath import render_vol
from cudatracerlib_tpu.render.wavefront import render_wavefront
from cudatracerlib_tpu.scene import media as M
from cudatracerlib_tpu.scene import phase as ph
from cudatracerlib_tpu.scene.shapes import (cornell_box, cornell_box_deluxe,
                                             furnace_scene)


@pytest.fixture(scope="module")
def cornell():
    return cornell_box()


def block_mean(img, b=4):
    h, w, _ = img.shape
    return img.reshape(h // b, b, w // b, b, 3).mean((1, 3))


class TestWavefront:
    def test_matches_megakernel(self, cornell):
        cfg = PTConfig(max_depth=5, rr_start=99)
        W = H = 32
        img_m = np.zeros((H, W, 3))
        img_w = np.zeros((H, W, 3))
        n = 4
        for s in range(n):
            img_m += np.asarray(render(cornell, W, H, 16, s, cfg)) / n
            img_w += np.asarray(
                render_wavefront(cornell, W, H, 16, s + 500, cfg, capacity=4096)
            ) / n
        rel = np.abs(block_mean(img_m) - block_mean(img_w)).sum() / np.abs(
            block_mean(img_m)
        ).sum()
        assert np.isfinite(img_w).all()
        assert rel < 0.1, rel

    def test_matches_megakernel_deluxe(self):
        """Shading parity on the full feature set: nested coating BSDF,
        checkerboard + image textures, normal maps, rough conductor — both
        engines run the same surface_bounce, so they must converge to the
        same image."""
        scene = cornell_box_deluxe()
        cfg = PTConfig(max_depth=5, rr_start=99)
        W = H = 32
        img_m = np.zeros((H, W, 3))
        img_w = np.zeros((H, W, 3))
        n = 4
        for s in range(n):
            img_m += np.asarray(render(scene, W, H, 16, s, cfg)) / n
            img_w += np.asarray(
                render_wavefront(scene, W, H, 16, s + 500, cfg, capacity=4096)
            ) / n
        rel = np.abs(block_mean(img_m) - block_mean(img_w)).sum() / np.abs(
            block_mean(img_m)
        ).sum()
        assert np.isfinite(img_w).all()
        assert rel < 0.12, rel

    def test_ray_counter(self):
        """Counted rays must be <= the padded upper bound and > primary count."""
        from cudatracerlib_tpu.render.wavefront import render_wavefront_counted
        scene = cornell_box()
        cfg = PTConfig(max_depth=5, rr_start=99)
        img, n_rays = render_wavefront_counted(scene, 16, 16, 4, 0, cfg,
                                               capacity=1024)
        n_rays = float(n_rays)
        primary = 16 * 16 * 4
        assert primary < n_rays <= primary * 5 * 2, n_rays


class TestPPM:
    def test_matches_path_tracer(self, cornell):
        W = H = 32
        cfg = PPMConfig(n_photons=1 << 15, radius0=0.07, max_gather=160, grid_res=32)
        img_ppm = np.zeros((H, W, 3))
        n = 4
        for i in range(n):
            img_ppm += np.asarray(render_ppm_pass(cornell, W, H, 4, i, i, cfg)) / n
        img_pt = np.zeros((H, W, 3))
        for i in range(6):
            img_pt += np.asarray(render(cornell, W, H, 16, i, PTConfig(max_depth=6))) / 6
        rel = np.abs(block_mean(img_ppm) - block_mean(img_pt)).sum() / np.abs(
            block_mean(img_pt)
        ).sum()
        assert np.isfinite(img_ppm).all()
        assert rel < 0.12, rel


class TestVolumetric:
    def test_homogeneous_attenuation(self):
        """Empty-ish scene + absorbing slab: env seen through medium must be
        attenuated by exp(-sigma_t * L)."""
        scene = furnace_scene(albedo=0.7)
        med = M.Media.build([
            {"type": M.HOMOGENEOUS, "sigma_a": [0.5] * 3, "sigma_s": [0.0] * 3,
             "box_min": [-2, -3, -2], "box_max": [2, -1.5, 2]}
        ])
        img = np.asarray(render_vol(scene, med, 32, 32, 8, 0, PTConfig(max_depth=4)))
        assert np.isfinite(img).all()
        # background pixels: env (1.0) through 1.5 units of sigma_a=0.5
        edge = img[0:3, 0:3].mean()
        expected = np.exp(-0.5 * 1.5)
        assert abs(edge - expected) < 0.05, (edge, expected)

    def test_scattering_conserves_energy(self):
        """Pure scattering medium in a furnace: radiance must stay ~1."""
        scene = furnace_scene(albedo=1.0)
        med = M.Media.build([
            {"type": M.HOMOGENEOUS, "sigma_a": [0.0] * 3, "sigma_s": [0.4] * 3,
             "phase_type": ph.ISOTROPIC,
             "box_min": [-2, -2, -2], "box_max": [2, 2, 2]}
        ])
        img = np.asarray(render_vol(scene, med, 24, 24, 16, 0, PTConfig(max_depth=16)))
        assert np.isfinite(img).all()
        assert abs(img.mean() - 1.0) < 0.06, img.mean()

    def test_transmittance_gradient(self):
        scene = furnace_scene(albedo=0.7)
        med = M.Media.build([
            {"type": M.HOMOGENEOUS, "sigma_a": [0.3] * 3, "sigma_s": [0.1] * 3,
             "box_min": [-2, -3, -2], "box_max": [2, -1.5, 2]}
        ])
        cfg = PTConfig(max_depth=3, rr_start=99)

        def loss(sa):
            return jnp.mean(render_vol(scene, med._replace(sigma_a=sa), 16, 16, 4, 0, cfg))

        g = jax.grad(loss)(med.sigma_a)
        gnp = np.asarray(g)
        assert np.isfinite(gnp).all()
        # FD check: fixed-noise FD carries boundary-crossing noise (lanes whose
        # scatter decision flips under the perturbation), so compare against
        # the detached-estimator AD with a generous bound on sign + magnitude
        h = 1e-2
        e = jnp.zeros_like(med.sigma_a).at[0, 0].set(h)
        fd = (loss(med.sigma_a + e) - loss(med.sigma_a - e)) / (2 * h)
        assert fd < 0 and gnp[0, 0] < 0  # denser absorber -> darker
        assert abs(float(fd) - gnp[0, 0]) < 0.5 * abs(float(fd)), (float(fd), gnp[0, 0])

    def test_grid_native_resolution_attenuation(self):
        """A constant-valued grid at an arbitrary (non-cubic, non-32) native
        resolution must attenuate exactly like the equivalent homogeneous
        medium (SceneTypes/Volumes.h:116-184 DenseVolGrid semantics)."""
        scene = furnace_scene(albedo=0.7)
        dens = np.full((17, 9, 5), 0.8, np.float32)
        med = M.Media.build([
            {"type": M.GRID, "sigma_a": [0.625] * 3, "sigma_s": [0.0] * 3,
             "box_min": [-2, -3, -2], "box_max": [2, -1.5, 2],
             "density": dens}
        ])
        img = np.asarray(render_vol(scene, med, 32, 32, 8, 0, PTConfig(max_depth=4)))
        assert np.isfinite(img).all()
        edge = img[0:3, 0:3].mean()
        expected = np.exp(-0.625 * 0.8 * 1.5)
        assert abs(edge - expected) < 0.05, (edge, expected)

    def test_per_channel_sigma_grids(self):
        """Separate sigma_a / sigma_s grids, RGB sigma_a: red attenuates more
        than blue through the slab."""
        scene = furnace_scene(albedo=0.7)
        ga = np.zeros((8, 8, 8, 3), np.float32)
        ga[..., 0] = 1.0   # red: full absorption
        ga[..., 2] = 0.2   # blue: light absorption
        gs = np.zeros((8, 8, 8), np.float32)
        med = M.Media.build([
            {"type": M.GRID, "sigma_a": [0.8] * 3, "sigma_s": [0.3] * 3,
             "box_min": [-2, -3, -2], "box_max": [2, -1.5, 2],
             "sigma_a_grid": ga, "sigma_s_grid": gs}
        ])
        img = np.asarray(render_vol(scene, med, 32, 32, 8, 0, PTConfig(max_depth=4)))
        edge = img[0:3, 0:3].reshape(-1, 3).mean(0)
        exp_r = np.exp(-0.8 * 1.0 * 1.5)
        exp_b = np.exp(-0.8 * 0.2 * 1.5)
        assert abs(edge[0] - exp_r) < 0.05, (edge[0], exp_r)
        assert abs(edge[2] - exp_b) < 0.05, (edge[2], exp_b)

    def test_grid_transmittance_gradient_fd(self):
        """BASELINE config 4 gate: FD-vs-AD gradient of the rendered image
        w.r.t. the density GRID VOXELS of a heterogeneous medium."""
        scene = furnace_scene(albedo=0.7)
        rng = np.random.default_rng(3)
        dens = (0.5 + 0.5 * rng.random((6, 6, 6))).astype(np.float32)
        med = M.Media.build([
            {"type": M.GRID, "sigma_a": [0.4] * 3, "sigma_s": [0.0] * 3,
             "box_min": [-2, -3, -2], "box_max": [2, -1.5, 2],
             "density": dens}
        ])
        cfg = PTConfig(max_depth=3, rr_start=99)

        def loss(grid_data):
            return jnp.mean(render_vol(scene, med._replace(grid_data=grid_data),
                                       16, 16, 4, 0, cfg))

        g = np.asarray(jax.grad(loss)(med.grid_data))
        assert np.isfinite(g).all()
        # voxels the rays traverse must darken the image when densified
        assert g.min() < 0
        # directional FD along the gradient (single-voxel FD sits at the f32
        # noise floor of the renderer; the directional signal is |g| >> eps)
        gnorm = float(np.linalg.norm(g))
        e = jnp.asarray(g / gnorm)
        h = 5e-2
        fd = float(loss(med.grid_data + h * e) - loss(med.grid_data - h * e)) / (2 * h)
        # directional derivative along ghat is |g|
        assert fd > 0
        assert abs(fd - gnorm) < 0.5 * abs(fd), (fd, gnorm)

    def test_volume_emission(self):
        """Emissive medium (Lve) glows: brighter than the same non-emissive
        medium; emission scales ~linearly with Le."""
        scene = furnace_scene(albedo=0.7, env_radiance=0.05)
        base = {"type": M.HOMOGENEOUS, "sigma_a": [0.6] * 3,
                "sigma_s": [0.05] * 3,
                "box_min": [-2, -3, -2], "box_max": [2, -1.5, 2]}
        cfg = PTConfig(max_depth=4)
        img0 = np.asarray(render_vol(scene, M.Media.build([dict(base)]),
                                     24, 24, 32, 0, cfg)).mean()
        m1 = M.Media.build([dict(base, le=[1.0] * 3)])
        img1 = np.asarray(render_vol(scene, m1, 24, 24, 32, 0, cfg)).mean()
        m2 = M.Media.build([dict(base, le=[2.0] * 3)])
        img2 = np.asarray(render_vol(scene, m2, 24, 24, 32, 0, cfg)).mean()
        assert img1 > img0 + 0.01
        rel = abs((img2 - img0) - 2 * (img1 - img0)) / (img2 - img0)
        assert rel < 0.05, (img0, img1, img2)

    def test_sixteen_volume_aggregate(self):
        """MAX_VOLUMES >= 16 (KernelAggregateVolume parity): 10 thin absorber
        slabs attenuate like one slab of the same total absorber thickness
        (union distance sampling must handle gaps between boxes)."""
        assert M.MAX_VOLUMES >= 16
        scene = furnace_scene(albedo=0.7)
        slabs = []
        for i in range(10):
            y0 = -2.9 + i * 0.14
            slabs.append({"type": M.HOMOGENEOUS, "sigma_a": [0.5] * 3,
                          "sigma_s": [0.0] * 3,
                          "box_min": [-2, y0, -2], "box_max": [2, y0 + 0.1, 2]})
        stack = M.Media.build(slabs)
        single = M.Media.build([
            {"type": M.HOMOGENEOUS, "sigma_a": [0.5] * 3, "sigma_s": [0.0] * 3,
             "box_min": [-2, -2.9, -2], "box_max": [2, -1.9, 2]}
        ])
        cfg = PTConfig(max_depth=4)
        # average the whole top band (background, away from the sphere) so
        # MC noise is ~0.01, well inside the tolerance
        edge_stack = np.asarray(
            render_vol(scene, stack, 24, 24, 32, 0, cfg))[0:4, :].mean()
        edge_single = np.asarray(
            render_vol(scene, single, 24, 24, 32, 1, cfg))[0:4, :].mean()
        assert abs(edge_stack - edge_single) < 0.035, (edge_stack, edge_single)
        assert abs(edge_stack - np.exp(-0.5)) < 0.08, edge_stack


class TestPhase:
    def test_hg_normalization(self):
        """Integral of HG phase over the sphere == 1."""
        n = 200_000
        u = jax.random.uniform(jax.random.PRNGKey(0), (n, 2))
        from cudatracerlib_tpu.math import warp

        wi = warp.square_to_uniform_sphere(u)
        wo = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
        for g in (0.0, 0.5, -0.8):
            p = ph.eval_phase(ph.HG, jnp.full((n,), g), wo, wi)
            integral = float(jnp.mean(p) * 4 * np.pi)
            assert abs(integral - 1.0) < 0.02, (g, integral)

    def test_hg_sampling_consistency(self):
        n = 100_000
        u = jax.random.uniform(jax.random.PRNGKey(1), (n, 2))
        wo = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
        g = jnp.full((n,), 0.6)
        ps = ph.sample_phase(jnp.full((n,), ph.HG), g, wo, u)
        # weight must be ~1 (exact importance sampling)
        np.testing.assert_allclose(np.asarray(ps.weight), 1.0, atol=1e-3)
        # mean cosine == g
        mean_cos = float(jnp.mean(jnp.sum(-wo * ps.wi, axis=-1)))
        assert abs(mean_cos - 0.6) < 0.01, mean_cos


class TestHashGrid:
    def test_query_completeness(self):
        rng = np.random.default_rng(0)
        pts = jnp.asarray(rng.uniform(0, 1, (3000, 3)).astype(np.float32))
        r = 0.05
        grid = hg.build_grid(pts, [0, 0, 0], [1, 1, 1], res=20)
        centers = jnp.asarray(rng.uniform(0, 1, (150, 3)).astype(np.float32))
        idx, valid = hg.query_sphere(grid, centers, r, max_neighbors=64)
        idx, valid = np.asarray(idx), np.asarray(valid)
        P, C = np.asarray(pts), np.asarray(centers)
        for b in range(len(C)):
            d = np.linalg.norm(P - C[b], axis=1)
            truth = set(np.nonzero(d < r)[0])
            got = set(idx[b][valid[b]])
            assert truth <= got
            g = idx[b][valid[b]]
            assert len(g) == len(set(g))

    def test_valid_mask(self):
        pts = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (500, 3)).astype(np.float32))
        mask = jnp.arange(500) < 250
        grid = hg.build_grid(pts, [0, 0, 0], [1, 1, 1], res=8, valid=mask)
        idx, valid = hg.query_sphere(grid, pts[:50], 0.125, 64)
        returned = set(np.asarray(idx)[np.asarray(valid)])
        assert all(i < 250 for i in returned)


class TestAOVs:
    def test_aov_shapes_and_content(self, cornell):
        aovs = render_aovs(cornell, 32, 32)
        assert set(aovs) >= {
            "depth", "normal_geo", "normal_sh", "uv", "bary", "mat_id",
            "prim_id", "albedo", "emission", "direct",
        }
        depth = np.asarray(aovs["depth"])
        assert depth.shape == (32, 32)
        assert depth.max() > 1.0  # camera is ~3 units from the box
        assert np.asarray(aovs["albedo"]).max() > 0.5
        assert np.asarray(aovs["direct"]).max() > 0.0


class TestHashGridSubsampling:
    def test_weighted_sums_unbiased_under_truncation(self):
        """query_sphere_sampled: weighted sums over the K-subsampled candidate
        set must match the exact (untruncated) neighborhood sum."""
        rng = np.random.default_rng(5)
        N = 20000
        pts = jnp.asarray(rng.uniform(0, 1, (N, 3)).astype(np.float32))
        vals = jnp.asarray(rng.uniform(0.5, 1.5, (N,)).astype(np.float32))
        grid = hg.build_grid(pts, [0, 0, 0], [1, 1, 1], res=6)
        centers = jnp.asarray(rng.uniform(0.2, 0.8, (64, 3)).astype(np.float32))

        # exact neighborhood sum (cell size 1/6 covers r)
        r = 1.0 / 6.0
        d2 = np.sum((np.asarray(pts)[None] - np.asarray(centers)[:, None]) ** 2, -1)
        exact = np.where(d2 < r * r, np.asarray(vals)[None], 0.0).sum(1)

        # subsampled with small K (severe truncation: ~580 candidates/cell nbhd)
        idx, valid, w = hg.query_sphere_sampled(grid, centers, 128)
        got_d2 = np.sum((np.asarray(pts)[np.asarray(idx)] -
                         np.asarray(centers)[:, None]) ** 2, -1)
        use = np.asarray(valid) & (got_d2 < r * r)
        est = (np.where(use, np.asarray(vals)[np.asarray(idx)], 0.0).sum(1)
               * np.asarray(w))
        # systematic sampling: low variance, unbiased; check aggregate closely
        assert abs(est.mean() / exact.mean() - 1.0) < 0.05, (
            est.mean(), exact.mean())


class TestAdaptiveSampling:
    def test_adaptive_beats_uniform_at_equal_rays(self, cornell):
        """The variance block sampler must actually drive sample allocation:
        at the same total camera-ray budget, adaptive
        allocation should not lose to uniform on MSE vs a converged ref."""
        from cudatracerlib_tpu.render.adaptive import render_adaptive_host
        from cudatracerlib_tpu.render.path_tracer import render_progressive

        W = H = 32
        cfg = PTConfig(max_depth=4, rr_start=99)
        ref = np.asarray(render_progressive(cornell, W, H, 64, 8, 999, cfg))
        uni = np.asarray(render_progressive(cornell, W, H, 4, 6, 0, cfg))
        ada = np.asarray(render_adaptive_host(cornell, W, H, 4, 6, 0, cfg,
                                              warmup=2))
        assert np.isfinite(ada).all()
        mse_u = float(((uni - ref) ** 2).mean())
        mse_a = float(((ada - ref) ** 2).mean())
        # adaptive re-distributes rays toward noisy pixels; allow a little
        # slack for MC noise but require it is in the same ballpark or better
        assert mse_a < mse_u * 1.15, (mse_a, mse_u)

    def test_wavefront_adaptive_runs(self, cornell):
        from cudatracerlib_tpu.render.adaptive import render_wavefront_adaptive

        img = render_wavefront_adaptive(cornell, 32, 32, 4, 3, 0,
                                        PTConfig(max_depth=3, rr_start=99),
                                        capacity=2048)
        img = np.asarray(img)
        assert np.isfinite(img).all() and img.max() > 0.1


class TestNaNAccounting:
    """SURVEY §5: keep checkify/debug guards for NaN — the framework counts
    non-finite contributions per engine instead of silently laundering them
    (the nan_to_num at the film boundary stays, but this counter tells
    'rare fp edge' apart from 'broken MIS weight')."""

    def test_megakernel_counts_zero_on_clean_scenes(self):
        import numpy as np

        from cudatracerlib_tpu.render.path_tracer import (
            PTConfig, render_with_counters)
        from cudatracerlib_tpu.scene.shapes import cornell_box, glossy_scene

        for scene in (cornell_box(), glossy_scene()):
            img, c = render_with_counters(scene, 24, 24, 4, 0,
                                          PTConfig(max_depth=4))
            assert float(c["n_rays"]) > 0
            assert float(c["n_nonfinite"]) == 0.0, float(c["n_nonfinite"])
            assert np.isfinite(np.asarray(img)).all()

    def test_wavefront_counts_zero(self):
        import numpy as np

        from cudatracerlib_tpu.render.path_tracer import PTConfig
        from cudatracerlib_tpu.render.wavefront import (
            render_wavefront_with_counters)
        from cudatracerlib_tpu.scene.shapes import cornell_box

        img, c = render_wavefront_with_counters(
            cornell_box(), 24, 24, 2, 0, PTConfig(max_depth=3))
        assert float(c["n_rays"]) > 0
        assert float(c["n_nonfinite"]) == 0.0, float(c["n_nonfinite"])
        assert np.isfinite(np.asarray(img)).all()
