"""Checkpoint/restore of solution fields and study state.

The reference has no checkpointing (SURVEY §5: persistence is only the
experiments' CSV artifacts). For long multi-study sweeps, perphil-tpu
adds a minimal, dependency-free save/load for Functions and
result rows: a compressed ``.npz`` with mesh/space metadata validated on
load. Orbax-grade sharded checkpointing is unnecessary at these sizes
(fields are MBs, not TBs).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Union

import numpy as np

from perphil_tpu.forms.spaces import Function, FunctionSpace, MixedFunctionSpace
from perphil_tpu.mesh.structured import StructuredMesh


def _mesh_meta(mesh: StructuredMesh) -> Dict:
    return {
        "cells": list(mesh.cells),
        "element": mesh.element,
        "diagonal": mesh.diagonal,
        "extent": list(mesh.extent),
    }


def _npz_path(path: Union[str, Path]) -> Path:
    """np.savez appends '.npz' to bare names; normalize so save/load agree."""
    p = Path(path)
    return p if p.suffix == ".npz" else p.with_suffix(p.suffix + ".npz")


def save_function(path: Union[str, Path], f: Function) -> None:
    """Save a (possibly mixed-space) Function with its mesh metadata."""
    path = _npz_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    space = f.space
    if isinstance(space, MixedFunctionSpace):
        arrays = {f"field_{i}": np.asarray(d) for i, d in enumerate(f.data)}
        meta = {"kind": "mixed", "nfields": len(f.data), "mesh": _mesh_meta(space.mesh)}
    else:
        arrays = {"field_0": np.asarray(f.data)}
        meta = {
            "kind": "scalar",
            "nfields": 1,
            "value_shape": list(space.value_shape),
            "mesh": _mesh_meta(space.mesh),
        }
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_function(path: Union[str, Path]) -> Function:
    """Load a Function; reconstructs mesh and space from metadata."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        mesh = StructuredMesh(
            cells=tuple(meta["mesh"]["cells"]),
            element=meta["mesh"]["element"],
            diagonal=meta["mesh"]["diagonal"],
            extent=tuple(meta["mesh"]["extent"]),
        )
        if meta["kind"] == "mixed":
            V = FunctionSpace(mesh)
            W = MixedFunctionSpace(spaces=(V,) * meta["nfields"])
            fields = tuple(data[f"field_{i}"] for i in range(meta["nfields"]))
            return Function(W, fields)
        V = FunctionSpace(mesh, value_shape=tuple(meta.get("value_shape", [])))
        return Function(V, data["field_0"])


def save_rows(path: Union[str, Path], rows: List[Dict]) -> None:
    """Persist experiment rows (restart-safe sweep state)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rows, indent=1, default=str))


def load_rows(path: Union[str, Path]) -> List[Dict]:
    p = Path(path)
    if not p.exists():
        return []
    return json.loads(p.read_text())
