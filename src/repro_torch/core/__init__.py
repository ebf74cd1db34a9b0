"""Host-side TH5 I/O modules, copied verbatim from ``src/repro/core/``.

Only the modules that ``CheckpointManager`` and ``BranchManager`` need are
copied; the on-disk format is therefore identical to the reference's.
Import the modules directly (``from repro_torch.core.checkpoint import
CheckpointManager``): this package re-exports nothing.
"""
