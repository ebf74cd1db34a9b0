"""Time-Reversible Steering — branching runs from any snapshot (paper §4).

    "If restart from an intermediate snapshot is ordered, the I/O kernel
     creates a new branching file for subsequent write outs."

A *branch* is a fresh TH5 run file whose lineage records (parent file,
branch step, config overlay).  Snapshots at or before the branch step are
resolved through the parent chain; new snapshots land in the branch file.
Because TH5 commits are shadow-paged, every historic snapshot of every
lineage member stays readable — rollback is a metadata operation, which is
exactly why the paper's operation-theatre scenario costs ~1/3 of a rerun.

Copied from ``src/repro/core/steering.py``; only the import lines differ.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Mapping

from .checkpoint import CheckpointManager


@dataclass(frozen=True)
class LineageEntry:
    path: str
    branch_step: int | None  # step in the *parent* this file branched from
    overlay: dict[str, Any]


class BranchManager:
    """Resolves snapshot reads across a branch lineage and creates branches."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager

    # -- lineage -----------------------------------------------------------

    def lineage(self) -> list[LineageEntry]:
        """Root-first chain of files contributing snapshots to this run."""
        chain: list[LineageEntry] = []
        mgr_path = self.manager.path
        lin = self.manager.file.lineage
        chain.append(
            LineageEntry(mgr_path, lin.get("branch_step"), dict(lin.get("overlay", {})))
        )
        while lin.get("parent"):
            parent_path = lin["parent"]
            with CheckpointManager(parent_path, create=False) as parent:
                lin = parent.file.lineage
            chain.append(
                LineageEntry(parent_path, lin.get("branch_step"), dict(lin.get("overlay", {})))
            )
        return list(reversed(chain))

    def lineage_summary(self) -> list[tuple[str, int | None]]:
        """Root-first ``(path, branch_step)`` pairs — the JSON-able shape
        the service layer's steering responses carry."""
        return [(e.path, e.branch_step) for e in self.lineage()]

    def effective_config(self) -> dict[str, Any]:
        """Root /common attrs with every branch overlay applied in order —
        the 'altered boundary conditions' of the current branch."""
        chain = self.lineage()
        with CheckpointManager(chain[0].path, create=False) as root:
            cfg = root.common()
        for entry in chain:
            cfg.update(entry.overlay)
        return cfg

    # -- reads through the chain --------------------------------------------

    def _owners(self) -> dict[int, str]:
        """step → owning file.  A child sees parent steps only up to its
        branch point (visibility = min over the chain of branch steps); on a
        step collision the younger file wins (a branch may re-write its
        branch step after continuing)."""
        chain = self.lineage()  # root-first
        owners: dict[int, str] = {}
        limit: int | None = None
        for entry in reversed(chain):  # leaf → root
            with CheckpointManager(entry.path, create=False) as m:
                for s in m.steps():
                    if (limit is None or s <= limit) and s not in owners:
                        owners[s] = entry.path
            if entry.branch_step is not None:
                limit = entry.branch_step if limit is None else min(limit, entry.branch_step)
        return owners

    def restore(self, step: int, verify: bool = True) -> tuple[int, Any]:
        owners = self._owners()
        if step not in owners:
            raise KeyError(f"step {step} not found in lineage of {self.manager.path}")
        owner = owners[step]
        if owner == self.manager.path:
            return self.manager.restore(step, verify=verify)
        with CheckpointManager(owner, create=False) as m:
            return m.restore(step, verify=verify)

    def available_steps(self) -> list[int]:
        """All reachable snapshots (parent steps ≤ branch point + own steps)."""
        return sorted(self._owners())

    # -- branching -------------------------------------------------------------

    def branch(
        self,
        at_step: int,
        child_path: str,
        overlay: Mapping[str, Any] | None = None,
    ) -> "BranchManager":
        """Create a branching file rooted at ``at_step`` of this run.

        The child starts empty (no data copied — rollback is metadata-only);
        /common carries the effective config with ``overlay`` applied so the
        branch is self-describing about *what* was steered."""
        if at_step not in self.available_steps():
            raise KeyError(f"cannot branch at step {at_step}: no such snapshot")
        overlay = dict(overlay or {})
        cfg = self.effective_config()
        cfg.update(overlay)
        child = CheckpointManager(
            child_path,
            create=True,
            common=cfg,
            lineage={
                "parent": os.path.abspath(self.manager.path),
                "branch_step": int(at_step),
                "overlay": overlay,
            },
        )
        return BranchManager(child)
