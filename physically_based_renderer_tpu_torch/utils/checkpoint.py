"""Checkpoint and resume of a scene's optimisable parts — the counterpart of
``physically_based_renderer_tpu/utils/checkpoint.py``.

A plain ``.npz`` with one named array a tensor: a nested dict of tensors is
flattened to ``"a/b"`` keys, and a None leaf is kept in a manifest, so a
file reads back by name whatever order the fields have. Arrays restore onto
the device and dtype of the tensors they replace.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

_MANIFEST = "__manifest__"


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def save_tensors(path: str, tree: dict) -> None:
    """Save a nested dict of tensors (and None leaves) to ``path`` (.npz)."""
    flat = _flatten(tree)
    arrays = {k: v.detach().cpu().numpy() for k, v in flat.items() if v is not None}
    manifest = json.dumps({"none": sorted(k for k, v in flat.items() if v is None)})
    np.savez(path, **{_MANIFEST: np.frombuffer(manifest.encode(), np.uint8)}, **arrays)


def load_tensors(path: str, like: dict) -> dict:
    """Restore a nested dict saved by :func:`save_tensors`, shaped as
    ``like``: each leaf the file names is read onto that leaf's device and
    dtype; a leaf the file does not name keeps ``like``'s value."""
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files if k != _MANIFEST}
        none = set(json.loads(bytes(data[_MANIFEST]).decode())["none"])

    def restore(tree: dict, prefix: str = "") -> dict:
        out = {}
        for k, v in tree.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = restore(v, key + "/")
            elif key in none:
                out[k] = None
            elif key in stored:
                arr = torch.as_tensor(stored[key])
                out[k] = arr if v is None else arr.to(device=v.device, dtype=v.dtype)
            else:
                out[k] = v
        return out

    return restore(like)


def _scene_params(scene) -> dict:
    mats = scene.materials
    lights = scene.lights
    return {
        "materials": {k: getattr(mats, k) for k in mats.tensor_fields()},
        "lights": {k: getattr(lights, k) for k in ("strength", "direction", "position", "spot_power")},
        "ambient": scene.ambient,
        "env_map": scene.env_map,
    }


def save_scene_params(path: str, scene) -> None:
    """Save the optimisable parts of a scene: the material bank, the lights,
    the ambient colour and the environment map."""
    save_tensors(path, _scene_params(scene))


def load_scene_params(path: str, scene):
    """``scene`` with the parts :func:`save_scene_params` wrote restored."""
    p = load_tensors(path, _scene_params(scene))
    return dataclasses.replace(
        scene,
        materials=dataclasses.replace(scene.materials, **p["materials"]),
        lights=dataclasses.replace(scene.lights, **p["lights"]),
        ambient=p["ambient"],
        env_map=p["env_map"],
    )
