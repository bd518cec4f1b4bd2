"""PyTorch port: window helpers against slam2d_tpu.grid.window (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu.grid import window as jwin
from slam2d_tpu_torch.grid import window as twin
from torch_parity import to_port

torch.set_num_threads(1)

CONFIGS = [
    (GridConfig(height=1024, width=1024, resolution=0.05),
     SensorConfig(max_range=12.0),
     MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13)),
    (GridConfig(height=512, width=512, resolution=0.1),
     SensorConfig(max_range=12.0), MatcherConfig(search_xy=0.3)),
    (GridConfig(height=256, width=256, resolution=0.1),
     SensorConfig(max_range=12.0), MatcherConfig(sigma_m=0.5)),
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_window_sizes_match_jax(i):
    g, s, m = CONFIGS[i]
    tg, ts, tm = to_port(g), to_port(s), to_port(m)
    assert twin.blur_halo_cells(tm, g.resolution) == jwin.blur_halo_cells(
        m, g.resolution
    )
    assert twin.scan_window_cells(tg, ts, tm) == jwin.scan_window_cells(g, s, m)
    for mm, tmm in ((None, None), (m, tm)):
        assert twin.update_window_cells(
            tg, ts, tmm
        ) == jwin.update_window_cells(g, s, mm)


# centers inside, near and beyond every border of a 96 x 80 array
CENTERS = [(40, 40), (3, 70), (95, 2), (-10, 200), (60, 79), (47, 12)]


@pytest.mark.parametrize("center", CENTERS)
def test_extract_and_write_match_jax(center):
    rng = np.random.default_rng(5)
    arr = rng.normal(size=(96, 80)).astype(np.float32)
    new = rng.normal(size=(32, 32)).astype(np.float32)
    c = jnp.asarray(center, jnp.int32)
    jw, (jr0, jc0) = jwin.extract_window(jnp.asarray(arr), c, 32)
    tw, (r0, c0) = twin.extract_window(torch.from_numpy(arr), center, 32)
    assert (r0, c0) == (int(jr0), int(jc0))
    assert (r0, c0) == twin.window_origin(center, 32, 96, 80)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tw.is_contiguous()

    ref = jwin.write_window(jnp.asarray(arr), jnp.asarray(new), (jr0, jc0))
    out = twin.write_window(
        torch.from_numpy(arr.copy()), torch.from_numpy(new), (r0, c0)
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    for margin in (0, 3, 6):
        ref = jwin.write_window_blur_exact(
            jnp.asarray(arr), jnp.asarray(new), (jr0, jc0), margin
        )
        base = torch.from_numpy(arr.copy())
        out = twin.write_window_blur_exact(
            base, torch.from_numpy(new), (r0, c0), margin
        )
        assert out is base  # written in place
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
