"""Parametric model tests: GMM EM recovery, sampling consistency, histograms.

Reference Kernel/ParametricModels/ has no tests; these validate the batched
translation against synthetic ground truth.
"""
import jax
import jax.numpy as jnp
import numpy as np

from cudatracerlib_tpu.models import (DiscretizedModel, GMM, ModelGrid,
                                      cell_of_position, discretized_init,
                                      discretized_pdf, discretized_sample,
                                      discretized_update, gmm_em_step,
                                      gmm_init, gmm_pdf, gmm_sample,
                                      make_model_grid)


class TestGMM:
    def test_em_recovers_bimodal(self):
        rng = np.random.default_rng(0)
        # two clear 2-D clusters in cell 0; cell 1 untouched
        n = 4000
        a = rng.normal([0.25, 0.25], 0.04, (n // 2, 2))
        b = rng.normal([0.75, 0.7], 0.06, (n // 2, 2))
        x = jnp.asarray(np.concatenate([a, b]).astype(np.float32))
        cid = jnp.zeros((n,), jnp.int32)
        w = jnp.ones((n,), jnp.float32)

        gmm = gmm_init(n_cells=2, n_components=4, dim=2)
        m0 = np.asarray(gmm.mean[1]).copy()
        step = jax.jit(lambda g: gmm_em_step(g, cid, x, w))
        for _ in range(30):
            gmm = step(gmm)

        # cell 1 unchanged
        np.testing.assert_allclose(np.asarray(gmm.mean[1]), m0, atol=1e-6)

        # cell 0: the dominant components sit near the true cluster centers
        wts = np.asarray(gmm.weight[0])
        mus = np.asarray(gmm.mean[0])
        top2 = mus[np.argsort(wts)[-2:]]
        d_a = np.linalg.norm(top2 - [0.25, 0.25], axis=1).min()
        d_b = np.linalg.norm(top2 - [0.75, 0.7], axis=1).min()
        assert d_a < 0.1, (top2, wts)
        assert d_b < 0.1, (top2, wts)

        # pdf integrates to ~1 over the unit square (grid quadrature)
        g = np.linspace(0.005, 0.995, 100)
        X, Y = np.meshgrid(g, g)
        pts = jnp.asarray(np.stack([X.ravel(), Y.ravel()], -1).astype(np.float32))
        p = np.asarray(gmm_pdf(gmm, jnp.zeros(len(pts), jnp.int32), pts))
        integral = p.mean()  # unit square
        assert 0.85 < integral < 1.1, integral

    def test_sampling_matches_pdf_moments(self):
        rng = np.random.default_rng(1)
        n = 6000
        x = jnp.asarray(
            rng.normal([0.4, 0.6], 0.05, (n, 2)).astype(np.float32))
        cid = jnp.zeros((n,), jnp.int32)
        gmm = gmm_init(1, 2, 2)
        step = jax.jit(lambda g: gmm_em_step(g, cid, x, jnp.ones((n,))))
        for _ in range(25):
            gmm = step(gmm)
        u = jnp.asarray(rng.uniform(size=(8000,)).astype(np.float32))
        z = jnp.asarray(rng.normal(size=(8000, 2)).astype(np.float32))
        s = np.asarray(gmm_sample(gmm, jnp.zeros(8000, jnp.int32), u, z))
        np.testing.assert_allclose(s.mean(0), [0.4, 0.6], atol=0.02)
        np.testing.assert_allclose(s.std(0), [0.05, 0.05], atol=0.02)


class TestDiscretized:
    def test_update_sample_pdf(self):
        rng = np.random.default_rng(2)
        m = discretized_init(2, 16, 0.0, 1.0)
        x = jnp.asarray(np.clip(rng.normal(0.3, 0.1, 5000), 0, 1).astype(np.float32))
        m = discretized_update(m, jnp.zeros(5000, jnp.int32), x,
                               jnp.ones(5000, jnp.float32))
        u = jnp.asarray(rng.uniform(size=4000).astype(np.float32))
        s, pdf = discretized_sample(m, jnp.zeros(4000, jnp.int32), u)
        s = np.asarray(s)
        assert abs(s.mean() - 0.3) < 0.02
        # pdf at the sampled points matches the histogram estimate
        p2 = np.asarray(discretized_pdf(m, jnp.zeros(4000, jnp.int32),
                                        jnp.asarray(s)))
        np.testing.assert_allclose(np.asarray(pdf), p2, rtol=1e-4)
        # untouched cell stays empty
        assert float(m.hist[1].sum()) == 0.0


class TestModelGrid:
    def test_cell_mapping(self):
        g = make_model_grid([0, 0, 0], [1, 1, 1], 4)
        p = jnp.asarray([[0.1, 0.1, 0.1], [0.9, 0.9, 0.9], [0.1, 0.9, 0.1]])
        c = np.asarray(cell_of_position(g, p))
        assert c[0] == 0
        assert c[1] == 3 * 16 + 3 * 4 + 3
        assert c[2] == 0 * 16 + 3 * 4 + 0
        assert (c >= 0).all() and (c < 64).all()


class TestHistogramDensity:
    def test_uniform_reads_one(self):
        from cudatracerlib_tpu.models.discretized import histogram_density

        rng = np.random.default_rng(3)
        s = jnp.asarray(rng.uniform(size=(40000, 2)).astype(np.float32))
        counts, density = histogram_density(s, 8)
        assert counts.shape == (8, 8)
        assert float(counts.sum()) == 40000
        d = np.asarray(density)
        assert abs(d.mean() - 1.0) < 1e-5
        assert d.std() < 0.1  # uniform input -> flat density
