"""The port's quality metrics (utils/metrics.py, torch) against the JAX
package's (jnp) on seeded clips, fp32 on the CPU: PSNR to 1e-5 dB, SSIM and
temporal consistency to 1e-6 (the sums run in another order)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.utils import metrics as jm
from video_enhancer_tpu_torch.utils import metrics as tm


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(3, 24, 28, 3), (20, 17, 3)])
def test_psnr_and_ssim_match_jax(shape):
    a, b = _pair(shape, seed=len(shape))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(tm.psnr(ta, tb)) - float(jm.psnr(jnp.asarray(a),
                                                      jnp.asarray(b)))) < 1e-5
    assert abs(float(tm.ssim(ta, tb)) - float(jm.ssim(jnp.asarray(a),
                                                      jnp.asarray(b)))) < 1e-6
    assert abs(float(tm.psnr(ta * 255, tb * 255, max_val=255.0))
               - float(jm.psnr(jnp.asarray(a * 255), jnp.asarray(b * 255),
                               max_val=255.0))) < 1e-5


def test_evaluate_pair_matches_jax():
    a, b = _pair((4, 16, 20, 3), seed=7)
    want = jm.evaluate_pair(jnp.asarray(a), jnp.asarray(b))
    got = tm.evaluate_pair(torch.from_numpy(a), torch.from_numpy(b))
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got["psnr"]), float(want["psnr"]),
                               atol=1e-5, rtol=0)
    for k in ("ssim", "temporal_consistency"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6,
                                   rtol=0)
    same = tm.evaluate_pair(torch.from_numpy(a), torch.from_numpy(a))
    assert float(same["psnr"]) == 120.0 and abs(float(same["ssim"]) - 1) < 1e-6
