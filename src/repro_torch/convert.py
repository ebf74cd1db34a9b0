"""Carry state and configuration across to this package as plain data.

A state dict crosses as numpy arrays (``state_to_numpy`` /
``state_from_numpy``), a configuration as the dict that
``dataclasses.asdict`` makes of it (``fluid_config_from_dict``,
``mg_config_from_dict``).  The equivalence tests use these to hand the same
inputs to the JAX reference and to the port.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .cfd.multigrid import MGConfig
from .cfd.projection import FluidConfig


def state_from_numpy(state_np: Mapping[str, Any], device) -> dict:
    """{name: array} → {name: tensor on ``device``}, dtypes and shapes kept."""
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in state_np.items()}


def state_to_numpy(state: Mapping[str, torch.Tensor]) -> dict:
    """{name: tensor} → {name: numpy array on the host}."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def mg_config_from_dict(d: Mapping[str, Any]) -> MGConfig:
    return MGConfig(**d)


def fluid_config_from_dict(d: Mapping[str, Any]) -> FluidConfig:
    """From ``dataclasses.asdict`` of a fluid config (its ``mg`` a nested dict)."""
    return FluidConfig(**{**d, "mg": mg_config_from_dict(d["mg"])})
