"""Pytree (de)serialisation for checkpoints.

Snapshots must be self-describing (paper §3: HDF5 self-description), so the
tree *structure* is stored as a JSON skeleton in the step group's attributes
and every leaf becomes one dataset addressed by a stable path string.
Supported containers: dict / list / tuple / None; leaves: numpy/JAX arrays
and python or numpy scalars (stored as 0-d arrays to keep dtype fidelity).

Copied from ``src/repro/core/tree_ser.py``; only the import lines differ.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

_LEAF = "__leaf__"
_NONE = "__none__"
_TUPLE = "__tuple__"
_ESC = re.compile(r"[/.]")


def _esc(key: str) -> str:
    return _ESC.sub(lambda m: "%%%02x" % ord(m.group()), key)


def _unesc(key: str) -> str:
    return re.sub(r"%([0-9a-f]{2})", lambda m: chr(int(m.group(1), 16)), key)


def flatten_state(tree: Any, prefix: str = "") -> tuple[Any, dict[str, np.ndarray]]:
    """Returns (json_skeleton, {path: array}).  Deterministic path order."""
    leaves: dict[str, np.ndarray] = {}

    def rec(node: Any, path: str) -> Any:
        if node is None:
            return {_NONE: True}
        if isinstance(node, dict):
            return {"d": {k: rec(v, f"{path}.{_esc(str(k))}") for k, v in sorted(node.items(), key=lambda kv: str(kv[0]))}}
        if isinstance(node, (list, tuple)):
            kids = [rec(v, f"{path}.{i}") for i, v in enumerate(node)]
            return {"l": kids, _TUPLE: isinstance(node, tuple)}
        # leaf
        arr = np.asarray(node)
        if arr.dtype == object:
            raise TypeError(f"unsupported leaf at {path!r}: {type(node)}")
        key = path.lstrip(".") or "root"
        leaves[key] = arr
        return {_LEAF: key, "scalar": np.ndim(node) == 0 and not isinstance(node, np.ndarray)}

    skeleton = rec(tree, prefix)
    return skeleton, leaves


def unflatten_state(skeleton: Any, leaves: dict[str, np.ndarray]) -> Any:
    def rec(node: Any) -> Any:
        if _NONE in node:
            return None
        if _LEAF in node:
            arr = leaves[node[_LEAF]]
            if node.get("scalar"):
                return arr.reshape(()).item() if arr.dtype.kind in "iufb" else arr
            return arr
        if "d" in node:
            return {_unesc(k): rec(v) for k, v in node["d"].items()}
        if "l" in node:
            vals = [rec(v) for v in node["l"]]
            return tuple(vals) if node.get(_TUPLE) else vals
        raise ValueError(f"bad skeleton node: {node}")

    return rec(skeleton)


def leaf_paths(skeleton: Any) -> list[str]:
    out: list[str] = []

    def rec(node: Any) -> None:
        if _LEAF in node:
            out.append(node[_LEAF])
        elif "d" in node:
            for v in node["d"].values():
                rec(v)
        elif "l" in node:
            for v in node["l"]:
                rec(v)

    rec(skeleton)
    return out
