"""The port's stencil and pack kernels against the Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
the plain versions against the Pallas kernels in interpret mode, over the
sweeps of ``test_kernels.py`` plus the d-grid sizes of the Kármán path
(n = 16, 8, 4) and the smoother's ω = 0.8.  Inputs come from a numpy seed
and go to both packages.  The CUDA kernels themselves are held against the
plain versions on the card, by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pack.linear import pack_grids as pallas_pack_grids
from repro.kernels.stencil.jacobi import jacobi_sweep as pallas_jacobi_sweep
from repro.kernels.stencil.jacobi import residual as pallas_residual
from repro_torch.kernels import build
from repro_torch.kernels.pack.linear import pack_grids, pack_grids_plain
from repro_torch.kernels.stencil.jacobi import jacobi_sweep, jacobi_sweep_plain, residual, residual_plain


def _grids(G, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, (G, n + 2, n + 2), dtype=dtype, endpoint=True)
    return rng.standard_normal((G, n + 2, n + 2)).astype(dtype)


def _rhs(G, n, seed):
    return np.random.default_rng(seed).standard_normal((G, n, n)).astype(np.float32)


@pytest.mark.parametrize("G,n", [(4, 16), (2, 32), (8, 8), (16, 4)])
@pytest.mark.parametrize("omega", [1.0, 1.7, 0.8])
def test_jacobi_sweep_plain_matches_pallas(G, n, omega):
    p, f = _grids(G, n, 0), _rhs(G, n, 1)
    want = pallas_jacobi_sweep(jnp.asarray(p), jnp.asarray(f), h2=0.01, omega=omega, interpret=True)
    got = jacobi_sweep(torch.tensor(p), torch.tensor(f), 0.01, omega)
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, n, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("G,n", [(4, 16), (1, 32), (8, 8), (16, 4)])
def test_residual_plain_matches_pallas(G, n):
    p, f = _grids(G, n, 2), _rhs(G, n, 3)
    want = pallas_residual(jnp.asarray(p), jnp.asarray(f), h2=0.25, interpret=True)
    got = residual(torch.tensor(p), torch.tensor(f), 0.25)
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, n, n)
    # the Pallas kernel multiplies by 1/h², the plain version divides by h²
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_jacobi_converges_on_poisson():
    """Sanity: repeated sweeps reduce the residual on a 1-grid problem."""
    n = 32
    f = torch.zeros((1, n, n))
    p = torch.zeros((1, n + 2, n + 2))
    p[:, 0, :] = 1.0  # Dirichlet boundary in the halo
    r0 = float(residual(p, f, 1.0).abs().mean())
    for _ in range(50):
        p[:, 1:-1, 1:-1] = jacobi_sweep(p, f, 1.0)
    r1 = float(residual(p, f, 1.0).abs().mean())
    assert r1 < r0 * 0.2


@pytest.mark.parametrize("G,n", [(4, 16), (2, 8), (1, 32), (16, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int8])
def test_pack_grids_plain_matches_pallas(G, n, dtype):
    p = _grids(G, n, 4, dtype)
    want = np.asarray(pallas_pack_grids(jnp.asarray(p), interpret=True))
    got = pack_grids(torch.tensor(p)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "call,plain",
    [
        (lambda p, f: jacobi_sweep(p, f, 0.01, 0.8), lambda p, f: jacobi_sweep_plain(p, f, 0.01, 0.8)),
        (lambda p, f: residual(p, f, 0.01), lambda p, f: residual_plain(p, f, 0.01)),
        (lambda p, f: pack_grids(p), lambda p, f: pack_grids_plain(p)),
    ],
    ids=["jacobi_sweep", "residual", "pack_grids"],
)
def test_wrapper_takes_plain_version_on_cpu_without_counting(call, plain):
    p, f = torch.tensor(_grids(3, 8, 5)), torch.tensor(_rhs(3, 8, 6))
    before = (jacobi_sweep.launches, residual.launches, pack_grids.launches)
    assert torch.equal(call(p, f), plain(p, f))
    assert (jacobi_sweep.launches, residual.launches, pack_grids.launches) == before


@pytest.mark.parametrize("which", ["jacobi_sweep", "residual", "pack_grids"])
def test_wrapper_refuses_a_device_it_has_no_kernel_for(which):
    p = torch.empty((2, 10, 10), device="meta")
    f = torch.empty((2, 8, 8), device="meta")
    call = {"jacobi_sweep": lambda: jacobi_sweep(p, f, 0.01), "residual": lambda: residual(p, f, 0.01),
            "pack_grids": lambda: pack_grids(p)}[which]
    with pytest.raises(ValueError):
        call()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
