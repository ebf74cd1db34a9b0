#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and hold its
CUDA kernels against their plain PyTorch versions.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``, one
process per source, in parallel) and runs these phases, each printing one
line ``<phase> <json>``:

1. ``device``: the card, torch and CUDA versions, build seconds, ptxas lines.
2. ``kernels``: each kernel against its plain version at G=1024 and G=65536
   d-grids of 16², at the smaller d-grids of the coarse multigrid levels and
   at G=37 (a partial last thread block) with n up to 32, within a few ulps;
   planted faults (f zeroed or shifted, the halo shifted) must fail the
   check.  Then CUDA-event times of back-to-back calls (``ms``, host launch cost
   included), the profiler's device time per call (``device_ms``), the byte
   bound at 3.35 TB/s and, for pack_grids, the one PyTorch copy that
   computes the same rows.
3. ``solve``: ``solve_poisson`` on a 4096² right-hand side.
4. ``main_path``: Kármán 256×1024 through ``Simulation``: 60 steps with
   snapshots, restore and re-run (bit-identical), a branch with a second
   cylinder, the first 3 steps held against a CPU run.
5. ``snapshot_at_size``: snapshot and restore of the 2048×8192 state.
6. ``thermal``: the operation theatre, 256², 20 steps.
7. ``profile``: device busy time, its share of the step (with and
   without the profiler's own overhead) and launches per Kármán step.

Then one JSON line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``.  Without a card, or when any phase
fails, it exits non-zero and prints no result.  Scratch files go to
``.chip_smoke/`` in the checkout and are removed at the end.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".chip_smoke"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# kernels against their plain versions: a few units in the last place of the
# terms each result sums (jacobi_sweep: |p| + h²|f|; residual: |f| + |∇²p|),
# pack_grids exact; the card against the CPU on the main path: relative
TOL = {"ulps": 4, "pack_grids": 0.0, "cpu_rel": 1e-4}


def emit(phase: str, payload) -> None:
    print(phase, json.dumps(payload), flush=True)


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean time the device spends in the kernels of one ``fn`` call, from the
    profiler: without the host's launch overhead that CUDA events include."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.end - e.time_range.start for e in events) / 1e3 / iters


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        from repro_torch.kernels import build
        from repro_torch.kernels.pack.linear import pack_grids, pack_grids_plain
        from repro_torch.kernels.stencil.jacobi import jacobi_sweep, jacobi_sweep_plain, residual, residual_plain

        self.build = build
        self.wrappers = {"jacobi_sweep": jacobi_sweep, "residual": residual, "pack_grids": pack_grids}
        self.plain = {"jacobi_sweep": jacobi_sweep_plain, "residual": residual_plain, "pack_grids": pack_grids_plain}
        self.kernel_rows: dict[str, dict] = {}
        self.main_launches: dict[str, int] = {}

    # -- helpers -------------------------------------------------------------------

    def reset_counts(self) -> None:
        for w in self.wrappers.values():
            w.launches = 0

    def counts(self) -> dict[str, int]:
        return {k: w.launches for k, w in self.wrappers.items()}

    def randn(self, shape, seed, dtype=None):
        g = self.torch.Generator(device="cuda").manual_seed(seed)
        return self.torch.randn(shape, generator=g, device="cuda", dtype=dtype or self.torch.float32)

    # -- phases --------------------------------------------------------------------

    def device(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
        t0 = time.perf_counter()
        built = self.build.build()
        build_s = time.perf_counter() - t0
        for name in built:  # load now, so no later timing pays for it
            self.build.load(name)
        emit("device", {
            "nvidia_smi": smi, "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s,
            "nvcc_s": {k: b.seconds for k, b in built.items()},
            "ptxas": [line for b in built.values() for line in b.ptxas],
        })

    def kernels(self):
        torch = self.torch
        jac, res, pack = (self.wrappers[k] for k in ("jacobi_sweep", "residual", "pack_grids"))
        jac_p, res_p, pack_p = (self.plain[k] for k in ("jacobi_sweep", "residual", "pack_grids"))
        eps = torch.finfo(torch.float32).eps
        # h² of the main path's finest level; f is scaled by 1/h² so that h²·f
        # is as large as p and ∇²p is as large as f: a kernel that drops f, or
        # reads it at the wrong cell, is off by the size of the result
        h2 = (1.0 / 256) ** 2
        out = {}
        errs = {"jacobi_sweep": 0.0, "residual": 0.0, "pack_grids": 0.0}
        failures = []

        def err(a, b) -> float:
            return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())

        # every d-grid size the Kármán path gives the kernels, n = 32, and
        # G = 37, whose cells do not fill the last thread block
        for G, n in ((1024, 16), (65536, 16), (256, 16), (4, 8), (4, 4), (37, 4), (37, 8), (37, 16), (37, 32)):
            key = f"G={G},n={n}"
            seed = 10 * G + n
            p = self.randn((G, n + 2, n + 2), seed)
            f = self.randn((G, n, n), seed + 1) / h2
            # the planted faults: the right kernel on the wrong f must fail the check
            faults = {"f_zeroed": torch.zeros_like(f), "f_shifted": torch.roll(f, 1, dims=2)}
            lap = f - res_p(p, f, h2)
            tol_j = TOL["ulps"] * eps * (float(p.abs().max()) + h2 * float(f.abs().max()))
            tol_r = TOL["ulps"] * eps * (float(f.abs().max()) + float(lap.abs().max()))
            row = {"tol_jacobi_sweep": tol_j, "tol_residual": tol_r, "faults_missed": []}
            e_j = 0.0
            for omega in (1.0, 0.8):
                want = jac_p(p, f, h2, omega)
                e_j = max(e_j, err(jac(p, f, h2, omega), want))
                for fault, wrong in faults.items():
                    if err(jac(p, wrong, h2, omega), want) <= tol_j:
                        row["faults_missed"].append(f"jacobi_sweep {fault} omega={omega}")
            want = res_p(p, f, h2)
            e_r = err(res(p, f, h2), want)
            for fault, wrong in faults.items():
                if err(res(p, wrong, h2), want) <= tol_r:
                    row["faults_missed"].append(f"residual {fault}")
            e_p = 0.0
            for dtype, q in (("float64", self.randn((G, n + 2, n + 2), seed + 2, torch.float64)),
                             ("float32", p), ("int32", (p * 1e6).to(torch.int32)),
                             ("int16", (p * 1000).to(torch.int16)), ("int8", (p * 20).to(torch.int8))):
                want = pack_p(q)
                e_p = max(e_p, err(pack(q), want))
                if err(pack(torch.roll(q, 1, dims=2)), want) <= TOL["pack_grids"]:
                    row["faults_missed"].append(f"pack_grids halo_shifted {dtype}")
            errs["jacobi_sweep"] = max(errs["jacobi_sweep"], e_j)
            errs["residual"] = max(errs["residual"], e_r)
            errs["pack_grids"] = max(errs["pack_grids"], e_p)
            row.update({"jacobi_sweep_err": e_j, "residual_err": e_r, "pack_grids_err": e_p})
            out[key] = row
            if e_j > tol_j or e_r > tol_r or e_p > TOL["pack_grids"] or row["faults_missed"]:
                failures.append(key)
            if n != 16 or G not in (1024, 65536):
                continue
            cells = G * n * n
            stencil_bytes = 4 * (G * (n + 2) ** 2 + 2 * cells)  # read p and f, write the result
            timing = {
                "jacobi_sweep": (lambda: jac(p, f, h2, 0.8), lambda: jac_p(p, f, h2, 0.8), None,
                                 bound(stencil_bytes, 9 * cells)),
                "residual": (lambda: res(p, f, h2), lambda: res_p(p, f, h2), None, bound(stencil_bytes, 7 * cells)),
                # pack needs only the n² interior of each grid read and written once
                "pack_grids": (lambda: pack(p), lambda: pack_p(p),
                               lambda: p[:, 1:-1, 1:-1].reshape(G, -1).contiguous(), bound(2 * 4 * cells, 0)),
            }
            for name, (kern, plain, lib, (b_ms, b_by)) in timing.items():
                t = {"ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                     "library_ms": cuda_ms(torch, lib) if lib else None, "bound_ms": b_ms, "bound_by": b_by,
                     "device_ms": device_ms(torch, kern), "plain_device_ms": device_ms(torch, plain),
                     "library_device_ms": device_ms(torch, lib) if lib else None}
                row[name] = t
                if G == 1024:  # the shape of the main path's finest level
                    self.kernel_rows[name] = {**t, "shape": key}
        out["tolerance"] = TOL
        emit("kernels", out)
        for name, e in errs.items():
            self.kernel_rows[name]["max_abs_err"] = e
        if failures:
            raise AssertionError(f"kernels disagree with their plain versions, or a planted fault passed, at {failures}")

    def solve(self):
        torch = self.torch
        from repro_torch.cfd.multigrid import MGConfig, residual_norm, solve_poisson, v_cycle

        n, cfg = 4096, MGConfig()
        h = 1.0 / n
        x = (torch.arange(n, device="cuda", dtype=torch.float32) + 0.5) * h
        X, Y = torch.meshgrid(x, x, indexing="ij")
        rhs = torch.sin(torch.pi * X) * torch.sin(torch.pi * Y)
        p = torch.zeros_like(rhs)
        norms = [float(torch.sqrt(torch.mean(rhs**2)))]
        self.reset_counts()
        seconds = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = v_cycle(p, rhs, h, cfg)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            norms.append(float(residual_norm(p, rhs, h, cfg)))
        launches = self.counts()
        p_solve = solve_poisson(rhs, h, cfg, cycles=6)
        # an upper estimate of the f32 round-off in evaluating the residual of p
        f32_floor = float(torch.finfo(torch.float32).eps * p.abs().max() * 4 / h**2)
        emit("solve", {"n": n, "G_fine": (n // 16) ** 2, "residual_norm_per_cycle": norms, "f32_floor": f32_floor,
                       "s_per_vcycle": sum(seconds[1:]) / 5, "first_vcycle_s": seconds[0],
                       "launches_6_cycles_with_norms": launches,
                       "solve_poisson_equals_cycles": bool(torch.equal(p_solve, p))})
        if not all(map(math.isfinite, norms)) or norms[-1] > 0.5 * norms[0]:
            raise AssertionError(f"V-cycles did not contract: {norms}")
        if not torch.equal(p_solve, p):
            raise AssertionError("solve_poisson differs from the same V-cycles run one by one")

    def main_path(self):
        torch = self.torch
        from repro_torch.cfd.projection import divergence, step
        from repro_torch.cfd.scenarios import add_cylinder, karman_vortex
        from repro_torch.cfd.sim import FIELDS, Simulation
        from repro_torch.core.checkpoint import CheckpointManager

        nx, ny = 256, 1024
        cfg, state = karman_vortex(nx, ny)
        mgr = CheckpointManager(str(WORK / "karman.th5"), common={"scenario": "karman"})
        sim = Simulation(cfg, state, mgr)
        step_s, snap_s, kept = 0.0, [], {}
        self.reset_counts()
        try:
            for block in range(3):  # snapshots at steps 0, 20, 40; 60 steps in all
                t0 = time.perf_counter()
                sim.snapshot()
                snap_s.append(time.perf_counter() - t0)
                for n_steps in ((3, 17) if block == 0 else (20,)):
                    t0 = time.perf_counter()
                    sim.run(n_steps)
                    step_s += time.perf_counter() - t0
                    kept[sim.step_index] = dict(sim.state)
            ms_per_step = step_s / 60 * 1e3
            snap_mb = sum(a.nbytes for a in mgr.restore(20)[1].values() if hasattr(a, "nbytes")) / 1e6
            # restart: roll back to step 20, redo 20 steps, compare with the direct run
            restored = sim.restore(20)
            sim.run(20)
            restart_diff = max(float((sim.state[f] - kept[40][f]).abs().max()) for f in (*FIELDS, "t"))
            # TRS branch: roll back to step 20, add a second cylinder, run and snapshot
            ct2 = add_cylinder(kept[40]["cell_type"].cpu().numpy(), nx, ny, cx=nx // 4, cy=ny // 2, d=nx / 8)
            br = sim.branch(20, str(WORK / "branch.th5"), overlay={"obstacle": "second-cylinder"},
                            cell_type=torch.tensor(ct2, device="cuda"))
            br.run(20)
            br.snapshot()
            branch_diff = float((br.state["u"] - kept[40]["u"]).abs().max())
            launches = self.counts()
            self.main_launches = launches
            fluid = kept[60]["cell_type"] == 0
            div = divergence(kept[60]["u"], kept[60]["v"], cfg.h)
            mean_div = float(div.abs()[fluid].mean())
            finite = all(bool(torch.isfinite(kept[60][f]).all()) for f in FIELDS)
            br.manager.close()
        finally:
            mgr.close()
        # hold the card against the CPU on the first 3 steps (plain versions there)
        cpu_cfg, cpu_state = karman_vortex(nx, ny, device="cpu")
        for _ in range(3):
            cpu_state = step(cpu_cfg, cpu_state)
        cpu_rel = {f: float((kept[3][f].cpu() - cpu_state[f]).abs().max()) / float(cpu_state[f].abs().max())
                   for f in ("u", "v", "p")}
        emit("main_path", {
            "nx": nx, "ny": ny, "G": sim.layout.G, "steps": 60, "ms_per_step": ms_per_step,
            "snapshot_s": snap_s, "snapshot_mb": snap_mb, "snapshot_mb_per_s": snap_mb / (sum(snap_s) / 3),
            "restart_max_abs_diff": restart_diff, "branch_max_abs_diff": branch_diff,
            "mean_abs_div_fluid": mean_div, "finite": finite, "launches": launches,
            "cpu_vs_card_rel_err_3_steps": cpu_rel, "cpu_tolerance_rel": TOL["cpu_rel"],
        })
        problems = []
        if restored != 20:
            problems.append(f"restore(20) restored step {restored}")
        if restart_diff != 0.0:
            problems.append(f"restart differs by {restart_diff}")
        if branch_diff <= 1e-3:
            problems.append("the branch did not diverge")
        if not finite:
            problems.append("non-finite fields")
        if any(v == 0 for v in launches.values()):
            problems.append(f"a kernel was not launched on the main path: {launches}")
        if any(v > TOL["cpu_rel"] for v in cpu_rel.values()):
            problems.append(f"card and CPU disagree: {cpu_rel}")
        if problems:
            raise AssertionError("; ".join(problems))

    def snapshot_at_size(self):
        torch = self.torch
        from repro_torch.cfd.scenarios import karman_vortex
        from repro_torch.cfd.sim import FIELDS, Simulation
        from repro_torch.core.checkpoint import CheckpointManager

        nx, ny = 2048, 8192
        cfg, state = karman_vortex(nx, ny)
        # a non-trivial state: random fields from a seed, on the card
        state = {**state, **{f: state[f] + self.randn((nx, ny), 100 + i) for i, f in enumerate(FIELDS)}}
        path = WORK / "big.th5"
        mgr = CheckpointManager(str(path))
        try:
            sim = Simulation(cfg, state, mgr)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = sim.snapshot()
            save_s = time.perf_counter() - t0
            sim.state = {**state, **{f: torch.zeros_like(state[f]) for f in FIELDS}}
            t0 = time.perf_counter()
            sim.restore(s)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            same = all(torch.equal(sim.state[f], state[f]) for f in FIELDS)
        finally:
            mgr.close()
        mb = path.stat().st_size / 1e6
        path.unlink()
        emit("snapshot_at_size", {"nx": nx, "ny": ny, "G": sim.layout.G, "file_mb": mb, "save_s": save_s,
                                  "save_mb_per_s": mb / save_s, "restore_s": restore_s,
                                  "restore_mb_per_s": mb / restore_s, "bit_identical": same})
        if not same:
            raise AssertionError("the restored state differs from the saved one")

    def thermal(self):
        torch = self.torch
        from repro_torch.cfd.projection import step
        from repro_torch.cfd.scenarios import operation_theatre

        cfg, state = operation_theatre(256, 256)
        T0 = float(state["T"].mean())
        for _ in range(20):
            state = step(cfg, state)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(state[f]).all()) for f in ("u", "v", "p", "T"))
        T_air_max = float(state["T"][state["cell_type"] == 0].max())
        emit("thermal", {"nx": 256, "ny": 256, "steps": 20, "T0": T0, "T_max": float(state["T"].max()),
                         "T_air_max": T_air_max, "finite": finite})
        if not finite or T_air_max <= T0 + 0.5:
            raise AssertionError("the operation theatre did not heat its air, or went non-finite")

    def profile(self):
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.cfd.projection import step
        from repro_torch.cfd.scenarios import karman_vortex

        cfg, state = karman_vortex(256, 1024)
        for _ in range(2):  # warm up allocator and libraries
            state = step(cfg, state)
        torch.cuda.synchronize()
        n = 3
        t0 = time.perf_counter()  # the same steps without the profiler's overhead
        for _ in range(n):
            state = step(cfg, state)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                state = step(cfg, state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.time_range.end - e.time_range.start for e in kernels)
        by_name: dict[str, list[float]] = {}
        for e in kernels:
            t = by_name.setdefault(e.name[:60], [0, 0.0])
            t[0] += 1
            t[1] += (e.time_range.end - e.time_range.start) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        emit("profile", {
            "steps": n, "wall_ms_per_step": wall / n * 1e3, "unprofiled_wall_ms_per_step": plain_wall / n * 1e3,
            "device_busy_ms_per_step": busy_us / 1e3 / n if kernels else None,
            "device_busy_share": busy_us / 1e6 / wall if kernels else None,
            "device_busy_share_of_unprofiled_step": busy_us / 1e6 / plain_wall if kernels else None,
            "device_launches_per_step": len(kernels) / n,
            "top_kernels_per_step": {k: {"launches": c / n, "ms": ms / n} for k, (c, ms) in top},
            "note": None if kernels else "the profiler showed no device time",
        })

    def kernels_line(self):
        meta = {
            "jacobi_sweep": ("src/repro_torch/kernels/csrc/stencil.cu", "src/repro/kernels/stencil/jacobi.py:51"),
            "residual": ("src/repro_torch/kernels/csrc/stencil.cu", "src/repro/kernels/stencil/jacobi.py:78"),
            "pack_grids": ("src/repro_torch/kernels/csrc/pack.cu", "src/repro/kernels/pack/linear.py:32"),
        }
        rows = []
        for name, (source, replaces) in meta.items():
            r = self.kernel_rows[name]
            rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                         "launches": self.main_launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                         "library_ms": r["library_ms"], "shape": r["shape"], "device_ms": r["device_ms"],
                         "plain_device_ms": r["plain_device_ms"], "library_device_ms": r["library_device_ms"]})
        print(json.dumps({"kernels": rows}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this check runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    smoke = Smoke(torch)
    phases = ["device", "kernels", "solve", "main_path", "snapshot_at_size", "thermal", "profile"]
    failed = []
    WORK.mkdir(exist_ok=True)
    try:
        for phase in phases:
            try:
                getattr(smoke, phase)()
            except Exception:  # report every phase, then fail the run
                failed.append(phase)
                print(f"{phase} FAILED\n{traceback.format_exc()}", flush=True)
                if phase == "device":
                    break
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    smoke.kernels_line()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
