"""The port's CFD slice against the JAX reference, on the CPU at small sizes.

Inputs are made with numpy (or by the reference's scenario builders) and
handed to both packages through ``repro_torch.convert``.  Tolerances:
multigrid transfer, smoother and projection steps agree to f32 round-off
(``1e-5`` of the field's largest magnitude); ``solve_poisson`` to ``1e-4``
relative; snapshots, restarts and files crossing between the packages bit
for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import multigrid as ref_mg
from repro.cfd import scenarios as ref_sc
from repro.cfd.projection import make_step as ref_make_step
from repro.cfd.sim import Simulation as RefSimulation
from repro.core.checkpoint import CheckpointManager as RefCheckpointManager
from repro_torch.cfd import multigrid as mg
from repro_torch.cfd import scenarios as sc
from repro_torch.cfd.projection import SOLID, divergence, step
from repro_torch.cfd.sim import FIELDS, Simulation
from repro_torch.convert import fluid_config_from_dict, mg_config_from_dict, state_from_numpy, state_to_numpy
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.steering import BranchManager


def _close(got: torch.Tensor, want, rel: float = 1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rel, atol=rel * scale)


def _port_scenario(name, *args):
    """The reference's scenario, carried across: (ref cfg, ref state, port cfg, port state)."""
    rcfg, rstate = getattr(ref_sc, name)(*args)
    cfg = fluid_config_from_dict(dataclasses.asdict(rcfg))
    return rcfg, rstate, cfg, state_from_numpy({k: np.asarray(v) for k, v in rstate.items()}, "cpu")


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(8, 8), (16, 32), (4, 16)])
def test_restrict_and_prolong_match_reference(shape):
    x = _field(shape, 0)
    _close(mg.restrict(torch.tensor(x)), ref_mg.restrict(jnp.asarray(x)))
    _close(mg.prolong(torch.tensor(x)), ref_mg.prolong(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(64, 64), (32, 64), (8, 32), (4, 16)])
def test_smoother_and_residual_match_reference(shape):
    """The d-grid size follows the level (n = 16, 8, 4), as on the Kármán path."""
    p, rhs = _field(shape, 1), _field(shape, 2)
    h = 1.0 / shape[0]
    want = ref_mg._smooth(jnp.asarray(p), jnp.asarray(rhs), h, 5, 0.8, 16)
    _close(mg._smooth(torch.tensor(p), torch.tensor(rhs), h, 5, 0.8, 16), want)
    _close(mg._residual(torch.tensor(p), torch.tensor(rhs), h, 16), ref_mg._residual(jnp.asarray(p), jnp.asarray(rhs), h, 16))


@pytest.mark.parametrize("shape,cfg", [((64, 64), {}), ((32, 64), {"n_pre": 2, "n_post": 2})])
def test_solve_poisson_matches_reference(shape, cfg):
    rhs = _field(shape, 3)
    h = 1.0 / shape[0]
    rcfg = ref_mg.MGConfig(**cfg)
    want = np.asarray(ref_mg.solve_poisson(jnp.asarray(rhs), h, rcfg, cycles=4))
    got = mg.solve_poisson(torch.tensor(rhs), h, mg_config_from_dict(dataclasses.asdict(rcfg)), cycles=4)
    _close(got, want, rel=1e-4)
    # the residual of a converged solve is round-off, so compare it on a rough guess
    guess = _field(shape, 4)
    _close(mg.residual_norm(torch.tensor(guess), torch.tensor(rhs), h), ref_mg.residual_norm(jnp.asarray(guess), jnp.asarray(rhs), h), rel=1e-4)


def test_multigrid_converges():
    """V-cycles contract the residual on a manufactured Poisson problem."""
    n = 64
    h = 1.0 / n
    x = (torch.arange(n, dtype=torch.float32) + 0.5) * h
    X, Y = torch.meshgrid(x, x, indexing="ij")
    rhs = torch.sin(np.pi * X) * torch.sin(np.pi * Y)
    r0 = float(torch.sqrt(torch.mean(rhs**2)))
    r2 = float(mg.residual_norm(mg.solve_poisson(rhs, h, mg.MGConfig(), cycles=2), rhs, h))
    r6 = float(mg.residual_norm(mg.solve_poisson(rhs, h, mg.MGConfig(), cycles=6), rhs, h))
    assert r2 < 0.6 * r0 and r6 < 0.05 * r0 and r6 < 0.35 * r2, (r0, r2, r6)


@pytest.mark.parametrize("name,args", [("karman_vortex", (32, 64)), ("operation_theatre", (32, 32))])
def test_projection_steps_match_reference(name, args):
    rcfg, rstate, cfg, state = _port_scenario(name, *args)
    ref_step = ref_make_step(rcfg)
    for _ in range(5):
        rstate, state = ref_step(rstate), step(cfg, state)
    for f in ("u", "v", "p", "T"):
        _close(state[f], rstate[f])
    assert float(state["t"]) == float(rstate["t"])


def test_scenario_states_match_reference():
    for name, args in (("karman_vortex", (32, 64)), ("operation_theatre", (32, 32))):
        rcfg, rstate = getattr(ref_sc, name)(*args)
        cfg, state = getattr(sc, name)(*args, device="cpu")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert state.keys() == rstate.keys()
        for k, v in state_to_numpy(state).items():
            assert v.dtype == np.asarray(rstate[k]).dtype, k
            np.testing.assert_array_equal(v, np.asarray(rstate[k]), err_msg=k)


def test_step_leaves_its_input_state_alone():
    cfg, state = sc.karman_vortex(32, 64, device="cpu")
    before = {k: v.clone() for k, v in state.items()}
    step(cfg, state)
    for k, v in state.items():
        assert torch.equal(v, before[k]), k


def test_karman_projection_reduces_divergence_and_deflects_flow():
    cfg, state = sc.karman_vortex(32, 64, device="cpu")
    for _ in range(30):
        state = step(cfg, state)
    ct = state["cell_type"]
    fluid = ct == 0
    assert float(torch.where(fluid, divergence(state["u"], state["v"], cfg.h), 0.0).abs().mean()) < 0.5
    for f in ("u", "v", "p"):
        assert bool(torch.isfinite(state[f]).all()), f
    u = state["u"]
    assert bool((u[ct == SOLID] == 0).all())  # no-slip inside the obstacle
    cyl_rows = torch.nonzero((ct == SOLID).any(dim=1)).flatten()
    assert float(u[: int(cyl_rows.min())].max()) > cfg.u_in * 1.02


def test_thermal_scenario_heats_air():
    cfg, state = sc.operation_theatre(32, 32, device="cpu")
    T0 = float(state["T"].mean())
    for _ in range(20):
        state = step(cfg, state)
    assert bool(torch.isfinite(state["T"]).all())
    assert float(state["T"].max()) > T0 + 0.5  # lamps inject heat


def test_snapshot_restart_bit_identical(tmp_path):
    cfg, state = sc.karman_vortex(32, 64, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "run.th5"), common={"scenario": "karman"})
    sim = Simulation(cfg, state, mgr)
    sim.run(4)
    s0 = sim.snapshot()
    sim.run(3)
    direct = {f: sim.state[f].clone() for f in (*FIELDS, "t")}
    assert sim.restore(s0) == s0
    sim.run(3)
    for f, v in direct.items():
        assert torch.equal(sim.state[f], v), f
    mgr.close()


def test_trs_branching_karman(tmp_path):
    """Paper §4 scenario 1: roll back, add an obstacle, the branch diverges."""
    cfg, state = sc.karman_vortex(32, 64, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "root.th5"), common={"scenario": "karman"})
    sim = Simulation(cfg, state, mgr)
    sim.run(3)
    s1 = sim.snapshot()
    sim.run(3)
    sim.snapshot()
    parent_state = dict(sim.state)
    parent_u = sim.state["u"].clone()

    ct2 = sc.add_cylinder(sim.state["cell_type"].numpy(), cfg.nx, cfg.ny, cx=8, cy=40, d=6)
    branch = sim.branch(
        s1, str(tmp_path / "branch.th5"), overlay={"obstacle": "second-cylinder"},
        cell_type=torch.tensor(ct2),
    )
    assert float(branch.state["t"]) == pytest.approx(s1 * cfg.dt, rel=1e-4)
    branch.run(3)
    assert float((sim.state["u"] - branch.state["u"]).abs().max()) > 1e-3  # the steered branch diverged
    # the parent's state is untouched by the branch's loading and stepping
    assert torch.equal(sim.state["u"], parent_u)
    assert all(sim.state[k] is v for k, v in parent_state.items())
    bm = BranchManager(branch.manager)
    assert bm.effective_config()["obstacle"] == "second-cylinder"
    assert s1 in bm.available_steps()
    mgr.close()
    branch.manager.close()


def test_packed_cells_match_reference_layout():
    rcfg, rstate, cfg, state = _port_scenario("karman_vortex", 32, 64)
    rstate = ref_make_step(rcfg)(rstate)
    port = Simulation(cfg, state_from_numpy({k: np.asarray(v) for k, v in rstate.items()}, "cpu"), manager=None)
    ref = RefSimulation(rcfg, rstate, manager=None)
    np.testing.assert_array_equal(port._pack_cells(), ref._pack_cells())


def _assert_state_equal(port_state, ref_state):
    for f in (*FIELDS, "t"):
        got, want = port_state[f].numpy(), np.asarray(ref_state[f])
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_port_snapshot_restores_bit_identically_in_reference(tmp_path):
    rcfg, rstate, cfg, state = _port_scenario("karman_vortex", 32, 64)
    path = str(tmp_path / "port.th5")
    mgr = CheckpointManager(path, common={"scenario": "karman"})
    sim = Simulation(cfg, state, mgr)
    sim.run(2)
    sim.snapshot()
    sim.run(2)
    s = sim.snapshot()
    written = mgr.restore(s)[1]
    mgr.close()

    rmgr = RefCheckpointManager(path)
    ref = RefSimulation(rcfg, rstate, rmgr)
    assert ref.restore(s) == s
    _assert_state_equal(sim.state, ref.state)
    _, read = rmgr.restore(s)
    for k, v in written.items():
        np.testing.assert_array_equal(np.asarray(read[k]), np.asarray(v), err_msg=k)
    rmgr.close()


def test_reference_snapshot_restores_bit_identically_in_port(tmp_path):
    rcfg, rstate, cfg, state = _port_scenario("karman_vortex", 32, 64)
    path = str(tmp_path / "ref.th5")
    rmgr = RefCheckpointManager(path, common={"scenario": "karman"})
    ref = RefSimulation(rcfg, rstate, rmgr)
    ref.run(3)
    s = ref.snapshot()
    rmgr.close()

    mgr = CheckpointManager(path)
    sim = Simulation(cfg, state, mgr)
    assert sim.restore(s) == s
    _assert_state_equal(sim.state, ref.state)
    assert sim.step_index == s
    mgr.close()


def test_convert_round_trip():
    rcfg, rstate = ref_sc.operation_theatre(16, 16)
    cfg = fluid_config_from_dict(dataclasses.asdict(rcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    state_np = {k: np.asarray(v) for k, v in rstate.items()}
    back = state_to_numpy(state_from_numpy(state_np, "cpu"))
    for k, v in state_np.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
