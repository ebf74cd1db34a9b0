"""The port's space-tree data movement against the JAX reference, bit for bit.

The same numpy inputs go to ``repro.cfd.spacetree`` and to
``repro_torch.cfd.spacetree``.  Halos carry random values, so every cell a
function writes or leaves alone is compared, corners included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import spacetree as ref
from repro_torch.cfd import spacetree as port

LAYOUTS = [(3, 5, 8), (4, 4, 4), (2, 4, 16), (1, 3, 4), (3, 1, 2)]


def _layouts(gx, gy, n):
    return ref.TreeLayout(gx=gx, gy=gy, n=n, h=0.1), port.TreeLayout(gx=gx, gy=gy, n=n, h=0.1)


def _blocked(gx, gy, n, seed=0):
    return np.random.default_rng(seed).standard_normal((gx * gy, n + 2, n + 2)).astype(np.float32)


@pytest.mark.parametrize("gx,gy,n", LAYOUTS)
def test_to_blocked_and_to_composite_match_reference(gx, gy, n):
    lr, lp = _layouts(gx, gy, n)
    comp = np.random.default_rng(1).standard_normal((gx * n, gy * n)).astype(np.float32)
    want_b = np.asarray(ref.to_blocked(lr, jnp.asarray(comp)))
    got_b = port.to_blocked(lp, torch.tensor(comp))
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    blocked = _blocked(gx, gy, n, 2)
    want_c = np.asarray(ref.to_composite(lr, jnp.asarray(blocked)))
    np.testing.assert_array_equal(port.to_composite(lp, torch.tensor(blocked)).numpy(), want_c)
    np.testing.assert_array_equal(port.to_composite(lp, got_b).numpy(), comp)


@pytest.mark.parametrize("gx,gy,n", LAYOUTS)
@pytest.mark.parametrize("fn", ["halo_exchange", "dirichlet_halos"])
def test_halo_functions_match_reference_and_leave_input_alone(gx, gy, n, fn):
    lr, lp = _layouts(gx, gy, n)
    blocked = _blocked(gx, gy, n, 3)
    want = np.asarray(getattr(ref, fn)(lr, jnp.asarray(blocked)))
    x = torch.tensor(blocked)
    got = getattr(port, fn)(lp, x)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(x.numpy(), blocked)


def test_exchange_then_dirichlet_matches_reference():
    lr, lp = _layouts(4, 8, 4)
    blocked = _blocked(4, 8, 4, 4)
    want = np.asarray(ref.dirichlet_halos(lr, ref.halo_exchange(lr, jnp.asarray(blocked))))
    got = port.dirichlet_halos(lp, port.halo_exchange(lp, torch.tensor(blocked)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gx,gy,n_ranks", [(4, 4, 4), (2, 4, 4), (3, 5, 2), (8, 2, 3)])
def test_topology_arrays_and_geometry_match_reference(gx, gy, n_ranks):
    lr, lp = _layouts(gx, gy, 8)
    assert (lp.G, lp.shape_composite, lp.shape_blocked) == (lr.G, lr.shape_composite, lr.shape_blocked)
    np.testing.assert_array_equal(lp.morton_order(), lr.morton_order())
    np.testing.assert_array_equal(lp.bounding_boxes(), lr.bounding_boxes())
    for got, want in zip(port.topology_arrays(lp, n_ranks), ref.topology_arrays(lr, n_ranks)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
